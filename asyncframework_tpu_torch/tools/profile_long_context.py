"""Where the time goes in the port's long-context attention, on one GPU.

    python3 -m asyncframework_tpu_torch.tools.profile_long_context

Causal ``ring_attention`` and ``ulysses_attention`` (``block_kernel="cuda"``,
512-key Ulysses blocks) at Llama-2-7B's attention width (32 heads x 128)
over a 32,768-token bf16 sequence, on a 4-rank mesh of this one card --
the geometry of ``chip_smoke.py``'s long-context phase.  Each path runs
once to warm up, once timed, and once under ``torch.profiler``; one JSON
line per path gives the timed seconds, the profiled call's device-busy
share (summed kernel time over its wall time; one stream), the
chunk_attention kernel's device time and share, and the operators that
took the most device time (merges, masks and concatenations are ATen
operators; the kernel, launched through ctypes, is not).  Needs a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from asyncframework_tpu_torch.parallel import (
    make_mesh,
    ring_attention,
    ulysses_attention,
)

T, H, D, RANKS, BLOCK = 32_768, 32, 128, 4, 512


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_long_context: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k, v = (torch.randn(1, T, H, D, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    mesh = make_mesh(RANKS, axis_names=("sp",), devices=[dev] * RANKS)
    paths = {
        "ring": lambda: ring_attention(q, k, v, mesh, causal=True,
                                       block_kernel="cuda"),
        "ulysses": lambda: ulysses_attention(q, k, v, mesh, causal=True,
                                             block_kernel="cuda",
                                             pallas_block=BLOCK),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        attn_us = sum(e.time_range.elapsed_us() for e in kernels
                      if "chunk_attn" in e.name)
        ops = sorted(
            (e for e in prof.key_averages() if e.self_device_time_total > 0),
            key=lambda e: -e.self_device_time_total,
        )[:10]
        print(json.dumps({
            "card": card, "path": name, "T": T, "H": H, "D": D,
            "ranks": RANKS, "seconds": seconds, "wall_s_profiled": wall_s,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_ms": busy_us / 1e3,
            "chunk_attention_ms": attn_us / 1e3,
            "chunk_attention_share": attn_us / 1e6 / wall_s,
            "top_ops": [
                {"name": e.key[:60],
                 "self_device_ms": e.self_device_time_total / 1e3,
                 "count": e.count}
                for e in ops
            ],
        }), flush=True)


if __name__ == "__main__":
    main()

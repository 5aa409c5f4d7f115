"""Where the time goes on the port's main path, on one GPU.

    python3 -m asyncframework_tpu_torch.tools.profile_asgd \
        [--config epsilon|rcv1] [--updates N]

Generates the epsilon deployment on the card (400,000 x 2,000 f32, 8
workers, b = 0.1; 1,000 updates) or the rcv1 one (``tools/rcv1.py``:
697,641 x 47,236 padded ELL, b = 0.05; 1,200 updates, bench.py's recipe),
runs ``ASGD.run()`` once without the profiler and once under
``torch.profiler``, and prints one JSON line: updates/s of both runs,
the device-busy share of the profiled ``run()`` call (summed kernel time
over its wall time, warm-up and trajectory evaluation included -- one
stream, so kernels do not overlap), device kernel launches and worker
tasks per accepted update, and the kernels and host-side operators that
took the most time.  With ``--config rcv1`` it also names kernel S1's
launches (its wrappers' counts over the profiled run, and the fused
kernel's launches per task in the trace) and the share of device time in
sort and memset launches.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.tools import rcv1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("epsilon", "rcv1"), default="epsilon")
    ap.add_argument("--updates", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_asgd: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.config == "rcv1":
        updates = args.updates or rcv1.ASGD_UPDATES
        ds = rcv1.dataset(dev)
        cfg = rcv1.config(updates, rcv1.ASGD_GAMMA)
    else:
        updates = args.updates or 1000
        ds = ShardedDataset.generate_on_device(400_000, 2_000, 8, [dev],
                                               seed=7)
        cfg = SolverConfig(num_workers=8, num_iterations=updates,
                           gamma=100.0, batch_rate=0.1, bucket_ratio=0.7,
                           printer_freq=25, seed=42)
    plain = ASGD(ds, None, cfg, devices=[dev]).run()
    solver = ASGD(ds, None, cfg, devices=[dev])
    s1 = (sg.compacted_grad, sg.grad_sum, sg.ell_residual, sg.segment_sum)
    s1_before = [fn.launches for fn in s1]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        res = solver.run()
        wall_s = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = sorted(
        (e for e in prof.key_averages() if e.self_cpu_time_total > 0),
        key=lambda e: -e.self_cpu_time_total,
    )[:8]
    tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    extra = {}
    if args.config == "rcv1":
        sort_memset = [e for e in kernels
                       if any(w in e.name.lower()
                              for w in ("sort", "radix", "memset"))]
        fused = sum(1 for e in kernels if "sparse_task_kernel" in e.name)
        extra = {
            "s1_launches": {fn.__name__: fn.launches - b
                            for fn, b in zip(s1, s1_before)},
            "s1_fused_launches_per_task": fused / max(tasks, 1),
            "sort_memset_launches": len(sort_memset),
            "sort_memset_device_share": sum(
                e.time_range.elapsed_us() for e in sort_memset)
            / max(busy_us, 1e-9),
            "sort_memset_names": sorted({e.name[:60] for e in sort_memset}),
            "host_memset_calls": sum(e.count for e in prof.key_averages()
                                     if "memset" in e.key.lower()),
        }
    print(json.dumps({
        "card": card,
        "config": args.config,
        "updates": updates,
        "updates_per_sec": plain.updates_per_sec,
        "updates_per_sec_profiled": res.updates_per_sec,
        "wall_s_profiled": wall_s,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_launches_per_update": len(kernels) / max(res.accepted, 1),
        "tasks_run": tasks,
        "tasks_per_accepted_update": tasks / max(res.accepted, 1),
        "top_host_ops": [
            {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "count": e.count}
            for e in host
        ],
        "top_kernels": [
            {"name": name[:80], "device_ms": t / 1e3, "count": c}
            for name, (t, c) in top
        ],
        **extra,
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``asyncframework_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that fails raises, and the script then
exits non-zero without a result line):

1. device -- the card's name and power limit, the kernels' build time, and
   the TF32 switches (both off, so every f32 product is full f32);
2. kernel -- each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main path and the mnist8m configuration give
   it: error against the stated tolerance, bit-equality of two launches,
   and the median time of the kernel, the plain version and a library
   yardstick, beside the least time the card could take (its bound);
3. main path -- ASGD ``run()`` and ``run_sync()`` on the full-size epsilon
   deployment (400,000 x 2,000 f32, 8 workers, b = 0.1) generated on the
   card, with every kernel's launch count set to 0 just before and read
   just after; then the same solver on a small input, on the card and on
   the CPU (plain path), must agree;
4. the ``{"kernels": [...]}`` line, the card line again, and last the
   ``{"ok": true, "device": ...}`` line.

It needs the package beside it and one CUDA device, and builds the kernels
from ``asyncframework_tpu_torch/csrc`` at first use (nvcc).
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# an H100 SXM (NVIDIA data sheet, full power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # f32 FMA rate outside the tensor cores
L2_FLUSH_BYTES = 128 << 20
TIMED_LAUNCHES = 25
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than any enqueue

# f32: both sides sum 1e3-1e6 products in f32 in different orders;
# bf16: a one-ulp flip of a row coefficient's bf16 rounding (the f32 dot
# differs in its last bits) moves g by 2^-8 of that row's term
TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, torch, flush) -> float:
    """Median device time of one call of ``fn`` over TIMED_LAUNCHES calls,
    each timed alone with CUDA events after the L2 was flushed (the main
    path finds its shard cold: 8 shards of 400 MB do not fit a 50 MB L2).
    A sleep kernel queued ahead of each call keeps the device busy while
    the host enqueues it, so the interval holds device work only, not the
    wrapper's Python time."""
    fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_case(name, n, d, dtype, torch, mg, flush, gen, b,
                cap=None, loss="least_squares"):
    """One phase-2 shape: masked_grad against its plain version."""
    from asyncframework_tpu_torch.ops.steps import compact_mask

    dev = torch.device("cuda", 0)
    X = torch.randn(n, d, device=dev, generator=gen, dtype=dtype)
    X /= math.sqrt(max(d, 1))
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    sel = torch.rand(n, device=dev, generator=gen) < b
    if cap is None:
        weights, idx = sel.float(), None
        rows = n
    else:
        weights, idx = compact_mask(sel, cap)
        rows = int(torch.unique(idx).numel())  # distinct rows this draw reads
    m = n if idx is None else cap
    es = X.element_size()

    def kernel():
        return mg.masked_grad(X, y, w, weights, idx, loss)

    def plain():
        return mg.masked_grad_reference(X, y, w, weights, idx, loss)

    def library():
        Xs, ys = (X, y) if idx is None else (X[idx], y[idx])
        z = (Xs @ w.to(dtype)).float()
        r = (torch.sigmoid(z) if loss == "logistic" else z) - ys
        return (Xs.T @ (weights * r).to(dtype)).float()

    g1, g2 = kernel(), kernel()
    ref = plain()
    torch.cuda.synchronize()
    dt = str(dtype).replace("torch.", "")
    ref_inf = float(ref.abs().max()) if d and n else 0.0
    err = float((g1 - ref).abs().max()) if d and n else 0.0
    tol = TOL_REL[dt] * ref_inf
    ok = bool(torch.isfinite(g1).all()) and err <= tol
    bit_equal = bool(torch.equal(g1, g2))
    bytes_moved = (rows * d * es + rows * 4 + m * 4 + d * 8
                   + (m * 8 if idx is not None else 0))
    flop_s = 4.0 * rows * d / F32_FLOPS
    byte_s = bytes_moved / HBM_BYTES_PER_S
    rec = {
        "phase": "kernel", "kernel": "masked_grad", "case": name,
        "n": n, "d": d, "dtype": dt, "loss": loss,
        "form": "full" if idx is None else f"idx cap={cap}",
        "rows_read": rows,
        "max_abs_err": err,
        "max_rel_err": err / ref_inf if ref_inf else 0.0,
        "tol_abs": tol, "tol": f"{TOL_REL[dt]} * max|g_plain|",
        "within_tol": ok, "bit_equal": bit_equal,
        "ms": median_ms(kernel, torch, flush),
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    }
    emit(rec)
    if not ok or not bit_equal:
        raise RuntimeError(f"masked_grad disagrees with its plain version: {rec}")
    return rec


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "asyncframework_tpu_torch")):
        print("chip_smoke.py: asyncframework_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2

    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.ops import _build
    from asyncframework_tpu_torch.ops import masked_grad as mg
    from asyncframework_tpu_torch.solvers import ASGD, SolverConfig

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    # ---------------------------------------------------------- 1. device
    card = card_line()
    print(card, flush=True)
    build_s = _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "card": card,
        "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })
    for name in _build.sources():
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                emit({"phase": "ptxas", "kernel": name, "info": line.strip()})

    # ---------------------------------------------------------- 2. kernel
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("a_epsilon_full", 50_000, 2_000, f32, 0.7, None, "least_squares"),
        ("b_epsilon_idx", 50_000, 2_000, f32, 0.1, 5_408, "least_squares"),
        ("c_mnist8m_idx", 1_012_500, 784, bf16, 0.1, 103_064, "least_squares"),
        ("c_mnist8m_full", 1_012_500, 784, bf16, 0.1, None, "least_squares"),
        ("d_ragged_300x100", 300, 100, f32, 0.5, None, "least_squares"),
        ("d_ragged_17x8", 17, 8, f32, 0.5, None, "least_squares"),
        ("d_empty_0x8", 0, 8, f32, 0.5, None, "least_squares"),
        ("e_epsilon_logistic", 50_000, 2_000, f32, 0.7, None, "logistic"),
    ]
    recs = {}
    for name, n, d, dtype, b, cap, loss in cases:
        recs[name] = kernel_case(name, n, d, dtype, torch, mg, flush, gen, b,
                                 cap, loss)
        torch.cuda.empty_cache()
    del flush

    # ------------------------------------------------------- 3. main path
    ds = ShardedDataset.generate_on_device(
        400_000, 2_000, 8, [dev], seed=7, noise=0.01
    )
    cfg = dict(num_workers=8, gamma=100.0, taw=2**31 - 1, batch_rate=0.1,
               bucket_ratio=0.7, printer_freq=25, seed=42)
    mg.masked_grad.launches = 0
    solver = ASGD(ds, None, SolverConfig(num_iterations=1000, **cfg),
                  devices=[dev])
    res = solver.run()
    tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    sync_solver = ASGD(ds, None, SolverConfig(num_iterations=300, **cfg),
                       devices=[dev])
    res_sync = sync_solver.run_sync()
    tasks += sum(m.succeeded for m in sync_solver.scheduler.pool.all_metrics())
    launches = mg.masked_grad.launches
    for mode, r in (("run", res), ("run_sync", res_sync)):
        obj0, obj1 = r.trajectory[0][1], r.final_objective
        rec = {
            "phase": "main_path", "mode": mode, "n": ds.n, "d": ds.d,
            "workers": 8, "dtype": "float32", "card": card,
            "accepted": r.accepted, "dropped": r.dropped, "rounds": r.rounds,
            "max_staleness": r.max_staleness,
            "updates_per_sec": r.updates_per_sec, "elapsed_s": r.elapsed_s,
            "objective_at_w0": obj0, "final_objective": obj1,
            "finite": bool(np.isfinite(r.final_w).all()),
        }
        emit(rec)
        if not (rec["finite"] and obj1 < obj0 / 10):
            raise RuntimeError(f"{mode} did not converge: {rec}")
    if res.accepted != 1000 or res_sync.rounds != 300:
        raise RuntimeError("main path stopped short of its iteration budget")
    emit({"phase": "launches", "masked_grad": launches, "tasks_run": tasks})
    if launches < tasks or tasks == 0:
        raise RuntimeError("the main path did not run every task through "
                           "the masked_grad kernel")
    del ds, solver, sync_solver
    torch.cuda.empty_cache()

    # small input: the card (kernel) and the CPU (plain path) must agree
    rs = np.random.default_rng(0)
    Xs = rs.normal(size=(4_096, 64)).astype(np.float32)
    ys = (Xs @ rs.normal(size=64).astype(np.float32)).astype(np.float32)
    small = SolverConfig(num_workers=4, num_iterations=20, gamma=0.5,
                         batch_rate=1.0, printer_freq=5)
    w_gpu = ASGD(Xs, ys, small, devices=[dev]).run_sync().final_w
    w_cpu = ASGD(Xs, ys, small, devices=[torch.device("cpu")]).run_sync().final_w
    diff = float(np.abs(w_gpu - w_cpu).max())
    tol = 1e-4 * float(np.abs(w_cpu).max())
    emit({"phase": "small_agreement", "max_abs_diff": diff, "tol": tol,
          "shape": [4_096, 64], "rounds": 20})
    if not diff <= tol:
        raise RuntimeError("run_sync on the card disagrees with the CPU path")

    # ------------------------------------------------------- 4. results
    main = recs["b_epsilon_idx"]  # the main path's shape (b = 0.1)
    emit({"phase": "total", "seconds": time.monotonic() - t_start})
    print(card, flush=True)
    emit({"kernels": [{
        "name": "masked_grad", "route": "cuda",
        "source": "asyncframework_tpu_torch/csrc/masked_grad.cu",
        "replaces": "asyncframework_tpu/ops/pallas_kernels.py:58",
        "launches": launches, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The masked-gradient kernel's staged route on one GPU: edge inputs, a
per-block timeline, and the two routes under another L2 state.

    python3 -m asyncframework_tpu_torch.tools.probe_masked_grad \
        [--timeline] [--flush read|none] [--calls N] [--cases a,b]

Builds ``csrc/masked_grad.cu``, prints its ptxas lines, then one JSON line
per case.  ``chip_smoke.py`` phase 2 times both routes at its shapes after
a write flush of the L2; this tool does what it does not:

1. check (always) -- the staged route (pinned) against the plain version
   at ragged and duplicate-row inputs (tolerance ``1e-4 * max|g|`` f32,
   ``2e-2`` bf16), bit-equal across two launches, and its ASAGA forms on
   the same X;
2. ``--flush read|none`` -- at ``chip_smoke.py``'s phase-2 shapes of every
   form, the staged route and the tiled route (pinned) timed in turns,
   call by call, each after a sleep kernel queued ahead, medians over
   ``--calls`` calls of each; ``read`` sums a 128 MB buffer before each
   call (the L2 then holds clean lines), ``none`` leaves the L2 as the
   last call left it;
3. ``--timeline`` (instead of 1-2) -- builds a copy of the kernel with
   ``%globaltimer`` stamps at fixed points of each block (start, the
   producer's start, its first stage issued, the consumers' last stage,
   the grid barrier's two sides, the end) and prints, for three cases,
   their spread over the blocks (min, median, max in us from the first
   block's start), the chunks each block ran, and the event-timed call
   around it (write-flushed, as ``chip_smoke.py``).

Every line carries the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from asyncframework_tpu_torch.ops import _build
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops.steps import compact_mask

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SLEEP_CYCLES = 2_000_000
TOL_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# (name, n, d, dtype, form, b, cap): chip_smoke.py's phase-2 shapes
TIMED = [
    ("b_epsilon_idx", 50_000, 2_000, torch.float32, "masked", 0.1, 5_408),
    ("a_epsilon_full", 50_000, 2_000, torch.float32, "masked", 0.7, None),
    ("saga_epsilon", 50_000, 2_000, torch.float32, "saga", 0.1, None),
    ("xt_epsilon", 50_000, 2_000, torch.float32, "xt", 0.1, None),
    ("c_mnist8m_idx", 1_012_500, 784, torch.bfloat16, "masked", 0.1, 103_064),
    ("c_mnist8m_full", 1_012_500, 784, torch.bfloat16, "masked", 0.1, None),
    ("saga_mnist8m_shard", 1_012_500, 784, torch.bfloat16, "saga", 0.1, None),
    ("xt_mnist8m_shard", 1_012_500, 784, torch.bfloat16, "xt", 0.1, None),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def problem(n, d, dtype, form, b, cap, gen, dev):
    X = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    X /= math.sqrt(d)
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    alpha = torch.randn(n, device=dev, generator=gen)
    sel = torch.rand(n, device=dev, generator=gen) < b
    if form == "saga":
        mask = sel.float()
        return (lambda: mg.saga_grad(X, y, w, alpha, mask)[0],
                lambda: mg.saga_grad_reference(X, y, w, alpha, mask)[0],
                n * d * X.element_size())
    if form == "xt":
        c = sel.float() * torch.randn(n, device=dev, generator=gen)
        return (lambda: mg.xt_coeff(X, c), lambda: mg.xt_coeff_reference(X, c),
                n * d * X.element_size())
    if cap is None:
        weights, idx, rows = sel.float(), None, n
    else:
        weights, idx = compact_mask(sel, cap)
        rows = int(torch.unique(idx).numel())
    return (lambda: mg.masked_grad(X, y, w, weights, idx),
            lambda: mg.masked_grad_reference(X, y, w, weights, idx),
            rows * d * X.element_size())


def turns_ms(fns, flush, calls, how):
    """Median device ms of each of ``fns``, called in turns after a
    ``how`` ("read" or "none") flush of the L2."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(calls):
        for k, fn in enumerate(fns):
            if how == "read":
                flush.sum()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return [sorted(t)[len(t) // 2] for t in times]


# (anchor line in csrc/masked_grad.cu, stamp put after it)
STAMPS = [
    ("  __syncthreads();\n\n  if (warp == kConsumerWarps) {", "1"),
    ("      cp_async_arrive(bar);", "2"),
    ("      if (chunk < 0) break;", "3"),
    ("  cooperative_groups::this_grid().sync();", "5"),
    ("  if (b == 0 && tid == 0) *counter = 0;  // every claim came before "
     "the barrier", "6"),
]
STAMP_NAMES = ["start", "producer_start", "first_issued", "consumers_done",
               "grid_barrier_in", "grid_barrier_out", "end"]


def timeline_library():
    """The kernel built with per-block %globaltimer stamps (dbg_t[b][k],
    ns; dbg_t[b][7] counts its chunks), bound like the real one."""
    import ctypes
    import os
    import subprocess as sp

    src = open(os.path.join(_build.CSRC, "masked_grad.cu")).read()
    now = ("({unsigned long long t_; asm volatile(\"mov.u64 %0, "
           "%%globaltimer;\" : \"=l\"(t_)); t_;})")

    def put(text, anchor, stmt, before=False):
        if anchor not in text:
            raise SystemExit(f"timeline: anchor not in the source: {anchor!r}")
        return text.replace(anchor, stmt + anchor if before else anchor + stmt,
                            1)

    s = put(src, "namespace {\n",
            "__device__ unsigned long long dbg_t[1024][8];\n")
    s = put(s, "  if (tid == 0) {\n    for (int s = 0; s < stages; ++s) {",
            f"  if (tid == 0) {{ dbg_t[blockIdx.x][0] = {now}; "
            "dbg_t[blockIdx.x][7] = 0; }\n", before=True)
    for anchor, k in STAMPS:
        if k == "1":
            stmt = f"\n    if (lane == 0) dbg_t[blockIdx.x][1] = {now};"
        elif k == "2":
            stmt = f"\n      if (k == 0 && lane == 0) dbg_t[blockIdx.x][2] = {now};"
        elif k == "3":
            s = put(s, anchor, f"      if (tid == 0 && chunk < 0) "
                    f"dbg_t[blockIdx.x][3] = {now};\n", before=True)
            s = put(s, "      if (chunk != cur) {",
                    "\n        if (tid == 0 && chunk >= 0) dbg_t[blockIdx.x][7] += 1;")
            continue
        elif k == "5":
            s = put(s, anchor, f"  if (tid == 0) dbg_t[blockIdx.x][4] = {now};\n",
                    before=True)
            stmt = f"\n  if (tid == 0) dbg_t[blockIdx.x][5] = {now};"
        else:
            stmt = f"\n  if (tid == 0) dbg_t[blockIdx.x][6] = {now};"
        s = put(s, anchor, stmt)
    s = put(s, 'extern "C" {\n',
            "int masked_grad_timeline(unsigned long long* h) { return (int)"
            "cudaMemcpyFromSymbol(h, dbg_t, sizeof(dbg_t)); }\n")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "masked_grad_timeline")
    with open(path + ".cu", "w") as f:
        f.write(s)
    r = sp.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", path + ".so",
                path + ".cu"], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"timeline build failed:\n{r.stderr}")
    lib = ctypes.CDLL(path + ".so")
    return lib


def timeline(card, gen, dev, flush, calls=3):
    """Per-block stamps of the staged kernel at three cases."""
    import ctypes
    import statistics

    lib = timeline_library()
    real, mg._lib = mg._build.load, None
    mg._build.load = lambda name: lib
    try:
        mg._library()
    finally:
        mg._build.load = real
    buf = (ctypes.c_ulonglong * (1024 * 8))()
    for name, n, d, dtype, form, b, cap in TIMED:
        if name not in ("b_epsilon_idx", "a_epsilon_full", "c_mnist8m_full"):
            continue
        kernel, _, _ = problem(n, d, dtype, form, b, cap, gen, dev)
        for _ in range(calls):
            kernel()
            torch.cuda.synchronize()
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            kernel()
            end.record()
            end.synchronize()
            lib.masked_grad_timeline(buf)
            blocks = torch.cuda.get_device_properties(dev).multi_processor_count
            rows = [[buf[b_ * 8 + k] for k in range(8)] for b_ in range(blocks)]
            t0 = min(r[0] for r in rows)
            rec = {"phase": "timeline", "card": card, "case": name,
                   "event_us": start.elapsed_time(end) * 1e3}
            for k, label in enumerate(STAMP_NAMES):
                us = [(r[k] - t0) / 1e3 for r in rows]
                rec[label] = [min(us), statistics.median(us), max(us)]
            chunks = [r[7] for r in rows]
            rec["chunks_per_block"] = [min(chunks), statistics.median(chunks),
                                       max(chunks)]
            emit(rec)
        del kernel
        torch.cuda.empty_cache()
    mg._lib = None


def check(card, gen, dev):
    """The staged route against the plain version at edge inputs."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 784, 2_000):
            for m in (1, 7, 131, 1_000, 40_000):
                cases.append((dtype, d, m))
    for dtype, d, m in cases:
        n = 3_000
        X = torch.randn(n, d, device=dev, generator=gen).to(dtype)
        y = torch.randn(n, device=dev, generator=gen)
        w = torch.randn(d, device=dev, generator=gen)
        # duplicates, padding slots (row 0, weight 0) and rows outside [0, n)
        idx = torch.randint(-5, n + 5, (m,), device=dev, generator=gen)
        weights = (torch.rand(m, device=dev, generator=gen) < 0.7).float()
        before = mg.masked_grad.launches_staged
        with mg.pinned_route("staged"):  # small m is tiled by default
            got = mg.masked_grad(X, y, w, weights, idx, "logistic")
            again = mg.masked_grad(X, y, w, weights, idx, "logistic")
        staged = mg.masked_grad.launches_staged - before
        safe = idx.clamp(0, n - 1)
        inside = ((idx >= 0) & (idx < n)).float()
        ref = mg.masked_grad_reference(X, y, w, weights * inside, safe,
                                       "logistic")
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        rec = {"phase": "check", "card": card, "dtype": str(dtype), "d": d,
               "m": m, "staged_launches": staged, "max_abs_err": err,
               "tol_abs": TOL_REL[dtype] * scale,
               "bit_equal": bool(torch.equal(got, again))}
        rec["ok"] = (err <= rec["tol_abs"] and rec["bit_equal"] and staged == 2
                     and bool(torch.isfinite(got).all()))
        if m == 1_000:
            # the ASAGA forms over the full shard, on the same X
            alpha = torch.randn(n, device=dev, generator=gen)
            sel = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
            before = mg.masked_grad.launches_staged
            with mg.pinned_route("staged"):
                g_s, diff = mg.saga_grad(X, y, w, alpha, sel)
                g_x = mg.xt_coeff(X, sel * alpha)
            rec["saga_staged_launches"] = mg.masked_grad.launches_staged - before
            g_ref, diff_ref = mg.saga_grad_reference(X, y, w, alpha, sel)
            x_ref = mg.xt_coeff_reference(X, sel * alpha)
            torch.cuda.synchronize()
            rec["saga_rel_err"] = float((g_s - g_ref).abs().max()
                                        / g_ref.abs().max())
            rec["diff_rel_err"] = float((diff - diff_ref).abs().max()
                                        / diff_ref.abs().max())
            rec["xt_rel_err"] = float((g_x - x_ref).abs().max()
                                      / x_ref.abs().max())
            rec["ok"] = (rec["ok"] and rec["saga_staged_launches"] == 2
                         and rec["saga_rel_err"] <= TOL_REL[dtype]
                         and rec["diff_rel_err"] <= TOL_REL[torch.float32]
                         and rec["xt_rel_err"] <= TOL_REL[torch.float32])
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"staged route disagrees: {rec}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flush", choices=("read", "none"), default=None,
                    help="time both routes after this flush of the L2")
    ap.add_argument("--calls", type=int, default=25)
    ap.add_argument("--cases", default="",
                    help="comma-separated names of the timed cases (all)")
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_masked_grad: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    build_s = _build.build_all(["masked_grad"])
    emit({"phase": "build", "card": card, "build_s": build_s})
    for line in _build.ptxas_report("masked_grad").splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            emit({"phase": "ptxas", "info": line.strip()})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 << 18, device=dev)
    if args.timeline:
        timeline(card, gen, dev, flush)
        return
    check(card, gen, dev)
    if args.flush is None:
        return
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def routed(route, fn):
        def call():
            with mg.pinned_route(route):
                return fn()
        return call

    for name, n, d, dtype, form, b, cap in TIMED:
        if args.cases and name not in args.cases.split(","):
            continue
        kernel, plain, x_bytes = problem(n, d, dtype, form, b, cap, gen, dev)
        es = torch.tensor([], dtype=dtype).element_size()
        plan = mg.launch_plan(
            d, n if cap is None else cap, es, True, 0, sms,
            lambda smem: mg._staged_occupancy(mg._library(), int(es == 2), smem),
            "staged")

        staged, tiled = routed("staged", kernel), routed("tiled", kernel)
        a, t, ref = staged(), tiled(), plain()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        ms_staged, ms_tiled = turns_ms([staged, tiled], flush, args.calls,
                                       args.flush)
        bound_ms = x_bytes / HBM_BYTES_PER_S * 1e3
        emit({"phase": "time", "card": card, "case": name, "form": form,
              "flush": args.flush,
              "geometry": plan.geometry._asdict(), "blocks": plan.blocks,
              "staged_ms": ms_staged, "tiled_ms": ms_tiled,
              "x_bound_ms": bound_ms,
              "staged_share": bound_ms / ms_staged,
              "tiled_share": bound_ms / ms_tiled,
              "staged_rel_err": float((a - ref).abs().max()) / scale,
              "tiled_rel_err": float((t - ref).abs().max()) / scale})
        if not (a - ref).abs().max() <= TOL_REL[dtype] * scale:
            raise SystemExit(f"staged route disagrees at {name}")
        del kernel, plain
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

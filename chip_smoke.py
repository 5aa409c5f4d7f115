#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``asyncframework_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that fails raises, and the script then
exits non-zero without a result line):

1. device -- the card's name and power limit, the kernels' build time, and
   the TF32 switches (both off, so every f32 product is full f32);
2. kernel -- each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main paths give it: error against the stated
   tolerance, bit-equality of two launches, and the median time of the
   kernel, the plain version and a library yardstick, beside the least
   time the card could take (its bound).  masked_grad at the epsilon and
   mnist8m shapes, its two ASAGA forms (saga_grad, xt_coeff) at the epsilon
   and mnist8m shards, each with the route it took (staged or tiled) and
   the other route's time (pinned; on the staged route that is the earlier
   design) taken in turns with it, and chunk_attention at a ring block (f),
   a Ulysses block (g),
   small f32 shapes (h) and the tensor-core route's bf16 edges (i), each
   with the route it took, its bound at the bf16 tensor-core rate (bf16)
   or the f32 FMA rate (f32), and SDPA in f32 and bf16 beside it; and
   kernel S1 (sparse_grad's fused launch, ``compacted_grad``: residual,
   stable radix sort and segment sums in one cooperative launch, on the
   local or the global route, which it picks from the data and which each
   shape must take; the global route also timed in turns where the local
   one runs) at
   rcv1's compacted task (4,752 slots of an 87,205 x 80 shard, d =
   47,236), its full shard, the edges (no valid slot, d = 1, every update
   in one column, K = 8) and a Zipf(1.0)-skewed task (its largest column
   ~30,000 entries, summed in chunks of L = 4,096), each bit-equal to its
   plain version on CPU copies and across launches, within 1e-5 of
   index_add_ and of an f64 sum, timed in turns with the earlier
   three-launch chain (ell_residual, torch.sort, segment_sum) and the
   library chain (a gather-and-sum residual, then index_add_); the
   coefficient form (``grad_sum``, ASAGA's table delta) and the residual
   alone (the evaluation, full shard) beside it, and whether the fused
   launch is captured by a CUDA graph;
3. main path -- ASGD ``run()`` and ``run_sync()`` on the full-size epsilon
   deployment (400,000 x 2,000 f32, 8 workers, b = 0.1) generated on the
   card, with every kernel's launch count set to 0 just before and read
   just after (every task on masked_grad's staged route); then the same
   solver on a small input, on the card and on the CPU (plain path), must
   agree;
4. long_context -- ``ring_attention`` and ``ulysses_attention`` at
   Llama-2-7B's attention width (32 heads x 128) over a 32,768-token bf16
   sequence on a 4-rank mesh of this one card, through the chunk_attention
   kernel's tensor-core route: 256 query rows against exact f32
   attention, the two paths against each other, the launch counts per
   route, and each path's share in the kernel;
5. asaga -- ASAGA ``run()`` and ``run_sync()`` on the same epsilon
   deployment through the masked_grad kernel's history forms: the
   objective halves, ``alpha_bar`` is the history table's mean, and the
   launch counts (every task and commit on masked_grad's staged route);
6. fused, epsilon -- ``run_fused()`` (chunks of 16 rounds, each one
   CUDA-graph replay): ``fused_graph`` lines (a chunk captured and
   replayed, bit-equal to the same chunk run eagerly from the same state
   and generator states; ASGD and ASAGA), then ASGD (5,000 updates, gamma
   100) and ASAGA (2,000, gamma 0.5) at bench.py's recipe, each gated as
   phases 3 and 5 (and ``alpha_bar`` within the JAX package's fused band),
   each task one staged B1 launch; phase 2's ``b1_graph`` line records B1's
   cooperative launch under capture beside S1's ``s1_graph``;
7. sparse -- the rcv1 deployment (``tools/rcv1.py``: 697,641 x 47,236
   padded ELL, K = 80, generated on the card, 8 workers): its bytes, pad
   width and skew, then ASGD ``run()`` (bench.py's recipe, 1,200 updates)
   and ``run_sync()``, ASAGA ``run()`` and ``run_sync()``, then
   ``fused_graph`` and ``run_fused()`` of both, each held to the JAX
   package's gate and run through kernel S1 (its launches set to 0 just
   before each run and read just after: one fused launch a task, one
   coefficient-form launch an ASAGA table delta, no launch of the earlier
   chain's segment sum, 0 calls of its plain versions);
8. mnist8m -- 8,100,000 x 784 bf16 (12.7 GB) generated on the card, 8
   workers, b = 0.1, gamma 39.2: ``fused_graph``, ASGD ``run_fused()``
   (5,000 updates) and ``run()`` (1,000), each below 1/10 of the objective
   at w = 0, every task one staged B1 launch;
9. the ``{"kernels": [...]}`` line, the card line again, and last the
   ``{"ok": true, "device": ...}`` line.

Each run line (``fused``, ``engine_run``) carries updates/s, rounds/s,
elapsed (fenced), accepted, rounds, staleness, the objective at w = 0 and
at the end, the update count and time at bench.py's target (0.001 of the
objective at w = 0), graph replays and kernel launches per accepted update
(on the fused path: launches captured a round x rounds), the peak device
memory and the card.

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
BF16_TC_FLOPS = 989e12  # bf16 dense tensor-core rate
L2_FLUSH_BYTES = 128 << 20
TIMED_LAUNCHES = 25
TIMED_ATTENTION = 5  # calls of up to ~0.1 s each at the full-width blocks
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


# the kernels' names in csrc/, longest first (one may contain another)
KERNEL_FUNCTIONS = ("masked_grad_staged", "masked_grad_partial",
                    "reduce_partials", "chunk_attn_tc_kernel",
                    "chunk_attn_kernel", "ell_residual_kernel",
                    "segment_bounds_kernel", "segment_sum_kernel",
                    "sparse_task_kernel")


def ptxas_lines(report: str):
    """(kernel function, line) for each register and spill line of an
    ``nvcc -Xptxas -v`` report; the function is its source name, with
    "bf16" for a bfloat16 instance."""
    function = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            function = next((f for f in KERNEL_FUNCTIONS if f in mangled),
                            mangled)
            if "bfloat16" in mangled:
                function += " bf16"
            if function == "sparse_task_kernel":  # the Pos instance
                function += " wide" if "IyE" in mangled else " narrow"
        elif "registers" in line or "spill" in line:
            yield function, line.strip()


def turns_ms(fns, torch, flush, calls: int = TIMED_LAUNCHES):
    """Median device time of one call of each of ``fns`` over ``calls``
    calls each, taken in turns (so that all see the same card state), each
    call timed alone with CUDA events after the L2 was flushed (the main
    path finds its shard cold: 8 shards of 400 MB do not fit a 50 MB L2).
    A sleep kernel queued ahead of each call keeps the device busy while
    the host enqueues it, so the interval holds device work only, not the
    wrapper's Python time."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(calls):
        for k, fn in enumerate(fns):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return [sorted(t)[len(t) // 2] for t in times]


def median_ms(fn, torch, flush, calls: int = TIMED_LAUNCHES) -> float:
    """``fn``'s median device ms, timed as :func:`turns_ms` does."""
    return turns_ms([fn], torch, flush, calls)[0]


def routed(mg, fn):
    """``fn()``'s result and the route of its one masked_grad launch."""
    before = mg.masked_grad.launches_staged, mg.masked_grad.launches_tiled
    out = fn()
    staged = mg.masked_grad.launches_staged - before[0]
    tiled = mg.masked_grad.launches_tiled - before[1]
    if staged + tiled != 1:
        raise RuntimeError(f"expected one masked_grad launch, got "
                           f"{staged} staged and {tiled} tiled")
    return out, "staged" if staged else "tiled"


def time_routes(rec, kernel, route, other, torch, mg, flush):
    """The kernel's median ms on its route and, where the other route
    takes the shape too (``other``), that route's (pinned), the two timed
    in turns: on the staged route ``tiled_ms`` is the earlier design's
    time; on the tiled route ``staged_ms`` is what moving would give."""
    if not other:
        rec["ms"] = median_ms(kernel, torch, flush)
        return
    pinned = "tiled" if route == "staged" else "staged"

    def pinned_kernel():
        with mg.pinned_route(pinned):
            return kernel()

    rec["ms"], rec[f"{pinned}_ms"] = turns_ms([kernel, pinned_kernel], torch,
                                              flush)


# the route each phase-2 masked_grad case must take (chosen by shape and
# dtype in ops/masked_grad.py::launch_plan)
B1_ROUTES = {
    "a_epsilon_full": "staged", "b_epsilon_idx": "staged",
    "c_mnist8m_idx": "staged", "c_mnist8m_full": "staged",
    "d_ragged_300x100": "tiled", "d_ragged_17x8": "tiled",
    "d_empty_0x8": "tiled", "d_small_132x2000": "staged",
    "e_epsilon_logistic": "staged",
    "saga_epsilon": "staged", "xt_epsilon": "staged",
    "saga_mnist8m_shard": "staged", "xt_mnist8m_shard": "staged",
}


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

    (g1, route), g2 = routed(mg, kernel), kernel()
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
        "route": route, "rows_read": rows,
        "max_abs_err": err,
        "max_rel_err": err / ref_inf if ref_inf else 0.0,
        "tol_abs": tol, "tol": f"{TOL_REL[dt]} * max|g_plain|",
        "within_tol": ok, "bit_equal": bit_equal,
    }
    other = route == "staged" or (
        mg.staged_geometry(d, es) is not None
        and X.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    time_routes(rec, kernel, route, other, torch, mg, flush)
    rec.update({
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    })
    emit(rec)
    if not ok or not bit_equal:
        raise RuntimeError(f"masked_grad disagrees with its plain version: {rec}")
    if route != B1_ROUTES[name]:
        raise RuntimeError(f"{name} took the {route} route, not "
                           f"{B1_ROUTES[name]}")
    if name == "b_epsilon_idx":  # the fused loop captures this launch
        rec["graph"] = graph_case("b1_graph", kernel, g1, torch)
    return rec


def saga_case(name, n, d, dtype, torch, mg, flush, gen, b):
    """One ASAGA form of masked_grad against its plain version: saga_grad
    (``(g, diff)`` over the full shard) or xt_coeff (``X^T c``)."""
    dev = torch.device("cuda", 0)
    X = torch.randn(n, d, device=dev, generator=gen, dtype=dtype)
    X /= math.sqrt(d)
    y = torch.randn(n, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    alpha = torch.randn(n, device=dev, generator=gen)
    mask = (torch.rand(n, device=dev, generator=gen) < b).float()
    es = X.element_size()
    dt = str(dtype).replace("torch.", "")
    if name.startswith("saga"):
        def kernel():
            return mg.saga_grad(X, y, w, alpha, mask)

        def plain():
            return mg.saga_grad_reference(X, y, w, alpha, mask)

        def library():
            diff = (X @ w.to(dtype)).float() - y
            return (X.T @ (mask * (diff - alpha)).to(dtype)).float(), diff

        # X once; y, alpha, mask, w in; g and diff out
        bytes_moved = n * d * es + 3 * n * 4 + d * 4 + d * 4 + n * 4
        tol_rel = TOL_REL[dt]
    else:
        c = mask * (torch.randn(n, device=dev, generator=gen) - alpha)

        def kernel():
            return (mg.xt_coeff(X, c),)

        def plain():
            return (mg.xt_coeff_reference(X, c),)

        def library():
            return (X.float().T @ c,) if dtype != torch.float32 else (X.T @ c,)

        bytes_moved = n * d * es + n * 4 + d * 4
        tol_rel = TOL_REL["float32"]  # c is not rounded to bf16
    (got, route), again, ref = routed(mg, kernel), kernel(), plain()
    torch.cuda.synchronize()
    errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
    scales = [float(r.abs().max()) for r in ref]
    ok = all(bool(torch.isfinite(a).all()) for a in got) and all(
        e <= tol_rel * sc for e, sc in zip(errs, scales)
    )
    bit_equal = all(bool(torch.equal(a, b2)) for a, b2 in zip(got, again))
    flop_s = (4.0 if name.startswith("saga") else 2.0) * n * d / F32_FLOPS
    byte_s = bytes_moved / HBM_BYTES_PER_S
    rec = {
        "phase": "kernel", "kernel": "masked_grad",
        "form": "saga_grad" if name.startswith("saga") else "xt_coeff",
        "case": name, "n": n, "d": d, "dtype": dt, "route": route,
        "max_abs_err": errs[0], "max_rel_err": errs[0] / scales[0],
        "diff_max_abs_err": errs[1] if len(errs) > 1 else None,
        "tol": f"{tol_rel} * max|plain| per output",
        "within_tol": ok, "bit_equal": bit_equal,
    }
    other = route == "staged" or mg.staged_geometry(d, es) is not None
    time_routes(rec, kernel, route, other, torch, mg, flush)
    rec.update({
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    })
    emit(rec)
    if not ok or not bit_equal:
        raise RuntimeError(f"{rec['form']} disagrees with its plain version: {rec}")
    if route != B1_ROUTES[name]:
        raise RuntimeError(f"{name} took the {route} route, not "
                           f"{B1_ROUTES[name]}")
    return rec


# chunk_attention against its plain version: both sum D products and Tk
# exponentials in f32, in different orders (the kernel also rescales online)
ATT_TOL = {"o": 1e-4, "m": 1e-5, "l": 1e-5}


def needed_pairs(mask, tq, tk, torch) -> int:
    """(query, key) pairs the block kernel has to compute for ``mask``:
    those it attends, and every key of a row that attends none (that row's
    l counts them all and its o sums every v).  The kernel skips a tile
    that no row needs, so its bound counts these, not Tq * Tk."""
    if mask is None:
        return tq * tk
    per_row = mask.sum(dim=1)
    return int(torch.where(per_row > 0, per_row,
                           torch.full_like(per_row, tk)).sum())


def attention_case(name, B, tq, tk, H, D, dtype, mask_kind, torch, ca, flush,
                   gen):
    """One chunk_attention shape against its plain version, with
    scaled_dot_product_attention (same boolean mask) as a yardstick: in f32
    (the comparison) and in bf16 (another function: bf16 p; printed only as
    what the card's tensor cores reach here).  It computes o / l only, and
    the port never calls it.  bf16 inputs with D % 16 == 0 must take the
    kernel's tensor-core route; their bound is the function's operations
    at the bf16 tensor-core rate (or its bytes), beside the f32-FMA bound
    of the CUDA-core design and the three-pass design's own floor."""
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    q, k, v = (torch.randn(B, t, H, D, device=dev, generator=gen).to(dtype)
               for t in (tq, tk, tk))
    if mask_kind == "causal":
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
    elif mask_kind == "ulysses_mid":
        # the Ulysses path's mask for its middle K/V block: the rows before
        # the block attend none of it, the rows after attend all of it
        k_pos = (tq // tk // 2) * tk + torch.arange(tk, device=dev)
        mask = torch.arange(tq, device=dev)[:, None] >= k_pos[None, :]
    elif mask_kind == "random":
        mask = torch.rand(tq, tk, device=dev, generator=gen) > 0.3
        mask[tq // 2] = False  # one row with no unmasked key
    else:
        mask = None

    def kernel():
        return ca.chunk_attention(q, k, v, mask)

    def plain():
        return ca.chunk_attention_reference(q, k, v, mask)

    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask)

    qb, kb, vb = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))

    def library_bf16():
        return F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask)

    tc_before = ca.chunk_attention.launches_tc
    got, again = kernel(), kernel()
    tc_launches = ca.chunk_attention.launches_tc - tc_before
    ref = plain()
    torch.cuda.synchronize()
    tensor_core = dtype == torch.bfloat16 and D % 16 == 0
    rec = {"phase": "kernel", "kernel": "chunk_attention", "case": name,
           "B": B, "Tq": tq, "Tk": tk, "H": H, "D": D,
           "dtype": str(dtype).replace("torch.", ""), "mask": mask_kind,
           "route": "tensor_core" if tc_launches else "f32",
           "tc_launches": tc_launches}
    ok = tc_launches == (2 if tensor_core else 0)
    for key, a, r in zip("oml", got, ref):
        err = (a - r).abs()
        rel = float((err / r.abs().clamp(min=1.0)).max())
        rec[f"{key}_max_abs_err"] = float(err.max())
        rec[f"{key}_max_rel_err"] = rel
        rec[f"{key}_tol_rel"] = ATT_TOL[key]
        ok = ok and rel <= ATT_TOL[key] and bool(torch.isfinite(a).all())
    if mask_kind == "random":
        # the TPU kernel's padded-Tk count for a row with no unmasked key
        rec["masked_row_l_ok"] = bool((got[2][:, :, tq // 2]
                                       == -(-tk // 8) * 8).all())
        ok = ok and rec["masked_row_l_ok"]
    del ref
    bit_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del got, again
    torch.cuda.empty_cache()
    flops = 4.0 * B * H * D * needed_pairs(mask, tq, tk, torch)
    bytes_moved = (sum(x.numel() * x.element_size() for x in (q, k, v))
                   + (0 if mask is None else mask.numel())
                   + B * tq * H * D * 4 + 2 * B * H * tq * 4)
    fma_s, byte_s = flops / F32_FLOPS, bytes_moved / HBM_BYTES_PER_S
    # bf16 q k^T and p v on the tensor cores (989 TFLOP/s); f32 inputs keep
    # the CUDA-core design and its f32-FMA count
    flop_s = flops / BF16_TC_FLOPS if tensor_core else fma_s
    calls = TIMED_ATTENTION if flops > 1e10 else TIMED_LAUNCHES
    rec.update({
        "within_tol": ok, "bit_equal": bit_equal,
        "ms": median_ms(kernel, torch, flush, calls),
        "plain_ms": median_ms(plain, torch, flush, calls),
        "library_ms": median_ms(library, torch, flush, calls),
        "library": "scaled_dot_product_attention, f32, o/l only (yardstick)",
        "library_bf16_ms": median_ms(library_bf16, torch, flush, calls),
        "library_bf16": "scaled_dot_product_attention, bf16 (bf16 p: another "
                        "function; reference only)",
        "bound_ms": max(flop_s, byte_s) * 1e3,
        "bound_by": "operations" if flop_s >= byte_s else "bytes",
        "bound_f32_fma_ms": max(fma_s, byte_s) * 1e3,
        # the tensor-core route runs four passes (q k^T and three p v)
        # where the function needs two
        "design_floor_ms": (2 * max(flop_s, byte_s) * 1e3 if tensor_core
                            else None),
        "flop": flops,
    })
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["faster_than_sdpa_f32"] = rec["ms"] < rec["library_ms"]
    emit(rec)
    # a time under the least the card could take means a wrong bound
    ok = ok and rec["bound_share"] <= 1.0
    del q, k, v, qf, kf, vf, qb, kb, vb, mask
    torch.cuda.empty_cache()
    if not ok or not bit_equal:
        raise RuntimeError(f"chunk_attention disagrees with its plain version: {rec}")
    return rec


def exact_rows(q, k, v, rows, torch):
    """Causal attention of the query ``rows`` over the whole sequence, in
    plain f32 (the inputs widened exactly from bf16)."""
    D = q.shape[-1]
    qr = q[0, rows].float()                              # (R, H, D)
    s = torch.einsum("rhd,khd->hrk", qr, k[0].float()) / math.sqrt(D)
    k_pos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(k_pos[None, None, :] > rows[None, :, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hrk,khd->rhd", p, v[0].float())  # (R, H, D)


# the long-context geometry: Llama-2-7B's attention (32 heads x 128, every
# head in K and V) over a 32,768-token sequence, on a 4-rank mesh
LONG_T, LONG_H, LONG_D, LONG_RANKS = 32_768, 32, 128, 4
ULYSSES_BLOCK = 512
EXACT_ROWS = 256


def long_context_phase(torch, ca, card, recs):
    """Ring and Ulysses attention at Llama-2-7B's attention width over a
    32,768-token sequence on a 4-rank mesh of this one card.  Every fold
    must take the kernel's tensor-core route.  Each path's share in the
    kernel is priced at phase 2's medians of its fold shapes (``recs``):
    the ring's diagonal folds at (f) causal and its past folds at (f)
    unmasked, Ulysses' folds at (g)."""
    from asyncframework_tpu_torch.parallel import (
        make_mesh,
        ring_attention,
        ulysses_attention,
    )

    dev = torch.device("cuda", 0)
    B, T, H, D, P, BLK = 1, LONG_T, LONG_H, LONG_D, LONG_RANKS, ULYSSES_BLOCK
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k, v = (torch.randn(B, T, H, D, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    mesh = make_mesh(P, devices=[dev] * P)
    emit({"phase": "long_context_note",
          "note": f"the {P} ranks of the mesh share one card: the ring's "
                  "K/V rotation and Ulysses' all-to-all are same-device "
                  "no-ops, so no copy between cards is measured"})
    tl = T // P
    # the bound counts the pairs each fold's mask needs: the ring's P
    # diagonal blocks (masked) and P(P-1)/2 past blocks (unmasked); Ulysses'
    # T/BLK K/V blocks per rank, whose rows before the block attend none
    ar = torch.arange(tl, device=dev)
    ring_pairs = (P * needed_pairs(ar[:, None] >= ar[None, :], tl, tl, torch)
                  + P * (P - 1) // 2 * tl * tl)
    q_pos = torch.arange(T, device=dev)
    ulysses_pairs = P * sum(
        needed_pairs(q_pos[:, None] >= (i * BLK + torch.arange(BLK, device=dev)),
                     T, BLK, torch)
        for i in range(T // BLK)
    )
    ring_flop = 4.0 * B * H * D * ring_pairs
    ulysses_flop = 4.0 * B * (H // P) * D * ulysses_pairs
    ring_priced_ms = (P * recs["f_ring_block_causal"]["ms"]
                      + P * (P - 1) // 2 * recs["f_ring_block_nomask"]["ms"])
    ca.chunk_attention.launches = 0
    ca.chunk_attention.launches_tc = 0
    outs, paths = {}, {}
    for name, fn, flop, folds, fold_ms in (
        ("ring", lambda: ring_attention(q, k, v, mesh, causal=True,
                                        block_kernel="cuda"),
         ring_flop, P * (P + 1) // 2, ring_priced_ms / (P * (P + 1) // 2)),
        ("ulysses", lambda: ulysses_attention(q, k, v, mesh, causal=True,
                                              block_kernel="cuda",
                                              pallas_block=BLK),
         ulysses_flop, P * (T // BLK), recs["g_ulysses_block_causal"]["ms"]),
    ):
        before = ca.chunk_attention.launches
        before_tc = ca.chunk_attention.launches_tc
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        outs[name] = fn()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launched = ca.chunk_attention.launches - before
        launched_tc = ca.chunk_attention.launches_tc - before_tc
        bound_s = flop / BF16_TC_FLOPS
        paths[name] = {
            "phase": "long_context", "fn": name, "card": card,
            "B": B, "T": T, "H": H, "D": D, "ranks": P, "dtype": "bfloat16",
            "causal": True, "seconds": secs, "launches": launched,
            "launches_tc": launched_tc, "launches_f32": launched - launched_tc,
            "folds_expected": folds, "flop": flop,
            "tflops": flop / secs / 1e12,
            "bound_s": bound_s,
            "bound_share": bound_s / secs,
            "bound_f32_fma_s": flop / F32_FLOPS,
            # the kernel's share of the call, its folds priced at phase 2
            "kernel_priced_s": launched * fold_ms / 1e3,
            "kernel_share": launched * fold_ms / 1e3 / secs,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        }
        if launched < folds or launched_tc != launched:
            emit(paths[name])
            raise RuntimeError(f"{name} made {launched} chunk_attention "
                               f"launches ({launched_tc} on the tensor-core "
                               f"route), not all {folds} folds on that route")
    launches = ca.chunk_attention.launches
    launches_tc = ca.chunk_attention.launches_tc
    # 256 rows against exact f32 attention: the first and last row of each
    # rank's chunk, and the rest from a seeded draw
    edges = [p * tl + e for p in range(P) for e in (0, tl - 1)]
    pick = torch.randperm(T, device=dev, generator=gen).tolist()
    rows = sorted(edges + [r for r in pick if r not in edges]
                  [:EXACT_ROWS - len(edges)])
    rows_t = torch.tensor(rows, device=dev)
    exact = exact_rows(q, k, v, rows_t, torch)
    # each output is rounded to bf16 once (2^-9 relative), over f32 sums:
    # rtol 2^-8, with an absolute floor of 1e-4 * max|exact| for outputs
    # near 0; ring against Ulysses: two roundings, rtol 2^-7
    floor = 1e-4 * float(exact.abs().max())
    ok = True
    for name in ("ring", "ulysses"):
        got = outs[name][0, rows_t].float()
        err = (got - exact).abs()
        bad = int((err > 2 ** -8 * exact.abs() + floor).sum())
        paths[name].update({"rows_checked": len(rows),
                           "max_abs_err_vs_exact": float(err.max()),
                           "rows_tol": "2^-8 * |exact| + 1e-4 * max|exact|",
                           "outside_tol": bad,
                           "finite": bool(torch.isfinite(outs[name]).all())})
        emit(paths[name])
        ok = ok and bad == 0 and paths[name]["finite"]
    a, b = outs["ring"].float(), outs["ulysses"].float()
    cross = (a - b).abs()
    cross_bad = int((cross > 2 ** -7 * b.abs() + 1e-4 * float(b.abs().max())).sum())
    emit({"phase": "long_context_agreement", "max_abs_diff": float(cross.max()),
          "tol": "2^-7 * |ulysses| + 1e-4 * max|ulysses|",
          "outside_tol": cross_bad, "chunk_attention_launches": launches,
          "chunk_attention_launches_tc": launches_tc})
    if not ok or cross_bad:
        raise RuntimeError("long-context attention disagrees with exact "
                           "attention or across the two paths")
    del q, k, v, outs, exact, a, b, cross
    torch.cuda.empty_cache()
    return launches, paths


# kernel S1 (ops/sparse_grad.py) at the rcv1 shapes: (name, shard rows, K,
# live entries a row, d, Bernoulli rate or None for the full shard,
# compacted slots, the columns' law: "uniform", "one" (every update in one
# column) or "zipf" (Zipf(1.0) over column rank, ranks shuffled over the
# column ids: a synthetic stand-in for real rcv1's skew))
S1_CASES = [
    ("s_rcv1_task", 87_205, 80, 75, 47_236, 0.05, 4_752, "uniform"),
    ("s_rcv1_shard", 87_205, 80, 75, 47_236, None, None, "uniform"),
    ("s_no_valid", 87_205, 80, 75, 47_236, 0.0, 4_752, "uniform"),
    ("s_d1", 87_205, 80, 75, 1, 0.05, 4_752, "uniform"),
    ("s_one_column", 87_205, 80, 75, 47_236, 0.05, 4_752, "one"),
    ("s_k8", 87_205, 8, 8, 47_236, 0.05, 4_752, "uniform"),
    ("s_rcv1_skewed", 87_205, 80, 75, 47_236, 0.05, 4_752, "zipf"),
]
# the route kernel S1 must take at each shape (chosen on the card from the
# data: local where every top-digit bucket holds at most 4,096 live
# entries, else global)
S1_ROUTES = {
    "s_rcv1_task": "local", "s_rcv1_shard": "global", "s_no_valid": "local",
    "s_d1": "global", "s_one_column": "global", "s_k8": "local",
    "s_rcv1_skewed": "global",
}
# S1 against the same products summed in f64: f32 sums of a few to 4e5
# products.  Neither index_add_ (atomics in a changing order) nor the
# earlier chain (one serial chain a column) is a reference for a column
# longer than L: at d = 1 (325,000 entries in one column) each strays
# 1.0e-5 to 1.3e-5 of max|g| from the f64 sum, the chunked sum 2.4e-7.
S1_TOL = 1e-5


def s1_columns(rows, K, d, law, torch, gen):
    dev = torch.device("cuda", 0)
    if law == "one":
        return torch.full((rows, K), d // 2, device=dev, dtype=torch.int32)
    if law == "zipf":
        rank = torch.arange(1, d + 1, device=dev, dtype=torch.float32)
        draw = torch.multinomial(1.0 / rank, rows * K, replacement=True,
                                 generator=gen)
        ids = torch.randperm(d, device=dev, generator=gen)
        return ids[draw].reshape(rows, K).to(torch.int32)
    return torch.randint(0, d, (rows, K), device=dev, generator=gen,
                         dtype=torch.int32)


def s1_bound(nbytes, flop):
    byte_s, flop_s = nbytes / HBM_BYTES_PER_S, flop / F32_FLOPS
    return (max(byte_s, flop_s) * 1e3,
            "bytes" if byte_s >= flop_s else "operations")


def s1_route(fn, torch, sg):
    """The route S1's launch in ``fn()`` took ("local" or "global")."""
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    stamps = torch.zeros(blocks, sg.STAMPS, dtype=torch.int64, device="cuda")
    with sg.record_timeline(stamps):
        fn()
    return "local" if int(stamps[0, sg.ROUTE_STAMP]) else "global"


def s1_case(name, rows, K, nnz, d, rate, cap, law, torch, sg, flush, gen):
    """Kernel S1 at one shape.  The fused design (``compacted_grad``: one
    launch, on the route it picks) bit-equal to its plain version on CPU
    copies and across launches, timed in turns with the earlier chain
    (``ell_residual`` with keys, ``torch.sort``, ``segment_sum``), the
    library chain (a gather-and-sum residual, then ``index_add_``) and,
    where it took the local route, itself pinned to the global route; the
    earlier chain still bit-equal to its own plain version on CPU
    copies."""
    from asyncframework_tpu_torch.ops.steps import compact_mask

    dev = torch.device("cuda", 0)
    cols = s1_columns(rows, K, d, law, torch, gen)
    vals = torch.randn(rows, K, device=dev, generator=gen) / math.sqrt(nnz)
    cols[:, nnz:] = 0
    vals[:, nnz:] = 0.0
    y = torch.randn(rows, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    if rate is None:
        valid = idx = None
        m, rows_read = rows, rows
    else:
        sel = torch.rand(rows, device=dev, generator=gen) < rate
        valid, idx = compact_mask(sel, cap)
        m, rows_read = cap, int(torch.unique(idx).numel())
    cols_l = cols.long()
    flat_cols = (cols_l if idx is None else cols_l[idx]).reshape(-1)
    rows_sel = vals if idx is None else vals[idx] * valid[:, None]
    y_sel = y if idx is None else y[idx] * valid

    def fused():
        return sg.compacted_grad(cols, vals, y, w, idx, valid, d)

    def chain():
        r, keys = sg.ell_residual(cols, vals, y, w, idx, valid, with_keys=True)
        skeys, perm = sg.sort_keys(keys)
        return sg.segment_sum(skeys, perm, vals, r, d, idx, valid), r

    def library():
        r = (rows_sel * w[flat_cols].reshape(m, K)).sum(1) - y_sel
        contrib = (rows_sel * r[:, None]).reshape(-1)
        return torch.zeros(d, device=dev).index_add_(0, flat_cols, contrib), r

    def plain():
        return sg.compacted_grad_plain(cols, vals, y, w, idx, valid, d)

    def fused_global():
        with sg.pinned_plan(route="global"):
            return fused()

    before = sg.compacted_grad.launches
    (g, r), (g2, r2) = fused(), fused()
    launches = sg.compacted_grad.launches - before
    (g_chain, r_chain), (g_chain2, _) = chain(), chain()
    g_lib, _ = library()
    cpu = [None if t is None else t.cpu() for t in (cols, vals, y, w, idx,
                                                    valid)]
    g_cpu, r_cpu = sg.compacted_grad_plain(*cpu, d)
    r_keys, keys = sg.ell_residual(cols, vals, y, w, idx, valid, True)
    skeys, perm = sg.sort_keys(keys)
    live = int((skeys < d).sum())
    counts = torch.unique_consecutive(skeys[skeys < d], return_counts=True)[1]
    largest = int(counts.max()) if live else 0
    chain_cpu = sg.segment_sum_plain(skeys.cpu(), perm.cpu(), cpu[1],
                                     r_keys.cpu(), d, *cpu[4:])
    torch.cuda.synchronize()
    # the rounded products summed in f64 (atomics: the order matters not)
    g64 = torch.zeros(d, device=dev, dtype=torch.float64).index_add_(
        0, flat_cols, (rows_sel * r[:, None]).reshape(-1).double())
    scale = float(g_cpu.abs().max()) if d else 0.0
    lib_err = float((g - g_lib).abs().max()) if d else 0.0
    chain_err = float((g - g_chain).abs().max()) if d else 0.0
    f64_err = float((g.double() - g64).abs().max()) if d else 0.0
    chain_f64_err = float((g_chain.double() - g64).abs().max()) if d else 0.0
    plan = sg.launch_plan(m, K, d)
    route = s1_route(fused, torch, sg)
    g_global, r_global = fused_global()
    timed = [fused, chain, library] + ([fused_global] if route == "local"
                                       else [])
    times = turns_ms(timed, torch, flush)
    contrib = (rows_sel * r[:, None]).reshape(-1)
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.compacted_grad",
        "case": name, "law": law, "rows": rows, "K": K, "nnz_per_row": nnz,
        "d": d, "slots": m, "rows_read": rows_read, "entries": m * K,
        "live_entries": live, "largest_segment": largest,
        "plan": plan._asdict(), "route": route,
        "launches_per_call": launches / 2,
        "bit_equal_plain_cpu": bool(torch.equal(g.cpu(), g_cpu)
                                    and torch.equal(r.cpu(), r_cpu)),
        "bit_equal": bool(torch.equal(g, g2) and torch.equal(r, r2)),
        "residual_equal_chain": bool(torch.equal(r, r_chain)),
        "bit_equal_chain": bool(torch.equal(g, g_chain)),
        "chain_max_rel_err": chain_err / scale if scale else 0.0,
        "f64_max_rel_err": f64_err / scale if scale else 0.0,
        "chain_f64_max_rel_err": chain_f64_err / scale if scale else 0.0,
        "max_abs_err": float((g.cpu() - g_cpu).abs().max()) if d else 0.0,
        "library_max_rel_err": lib_err / scale if scale else 0.0,
        "tol": f"bit-equal to the plain version on the CPU; "
               f"{S1_TOL} * max|g| against the products summed in "
               f"f64; bit-equal to the earlier chain where no column is "
               f"longer than L (index_add_'s distance recorded, not held)",
        "ms": times[0], "chain_ms": times[1], "library_ms": times[2],
        "global_route_ms": times[3] if route == "local" else times[0],
        "global_route_bit_equal": bool(torch.equal(g, g_global)
                                       and torch.equal(r, r_global)),
        "library": "(vals[idx] * w[cols[idx]]).sum(1) - y[idx], then "
                   "index_add_ of the products (atomics)",
        "plain_ms": median_ms(plain, torch, flush),
        "index_add_ms": median_ms(
            lambda: torch.zeros(d, device=dev).index_add_(0, flat_cols,
                                                          contrib),
            torch, flush),
        "chain_bit_equal_plain_cpu": bool(torch.equal(g_chain.cpu(),
                                                      chain_cpu)),
        "chain_bit_equal": bool(torch.equal(g_chain, g_chain2)),
    }
    # rows of cols and vals once, y (and idx, valid) once, w once; r and g
    # out; a multiply-add an entry for r, a multiply and an add a live
    # entry for g
    nbytes = (rows_read * (K * 8 + 4) + (m * 12 if idx is not None else 0)
              + d * 8 + m * 4)
    rec["bound_ms"], rec["bound_by"] = s1_bound(nbytes, 2.0 * m * K + 2.0 * live)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    ok = (rec["bit_equal_plain_cpu"] and rec["bit_equal"] and launches == 2
          and route == S1_ROUTES[name] and rec["global_route_bit_equal"]
          and rec["residual_equal_chain"] and rec["chain_bit_equal_plain_cpu"]
          and rec["chain_bit_equal"]
          and f64_err <= S1_TOL * max(scale, 1e-30)
          and (largest > plan.chunk or rec["bit_equal_chain"])
          and bool(torch.isfinite(g).all()))
    if rate == 0.0:
        ok = ok and not r.any() and not g.any()
    if not ok:
        raise RuntimeError(f"sparse_grad disagrees with its plain version: "
                           f"{rec}")
    out = {"task": rec}
    if rate is None:  # the evaluation's launch: the residual alone
        out["residual"] = s1_residual_case(name, cols, vals, y, w, torch, sg,
                                           flush)
    if name == "s_rcv1_task":  # ASAGA's table delta: the coefficient form
        out["grad_sum"] = s1_grad_sum_case(name, cols[idx], rows_sel, r, d,
                                           torch, sg, flush)
        out["graph"] = graph_case("s1_graph", lambda: fused()[0], g, torch)
    return out


def s1_residual_case(name, cols, vals, y, w, torch, sg, flush):
    """``ell_residual`` over a full shard, without keys (the evaluation)."""
    n, K = cols.shape
    d = w.shape[0]
    cols_l = cols.long()
    r, r2 = sg.ell_residual(cols, vals, y, w), sg.ell_residual(cols, vals, y, w)
    r_ref = sg.ell_residual_plain(cols, vals, y, w)
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.ell_residual", "case": name,
        "rows": n, "K": K, "d": d, "with_keys": False,
        "bit_equal_plain": bool(torch.equal(r, r_ref)),
        "bit_equal": bool(torch.equal(r, r2)),
        "max_abs_err": float((r - r_ref).abs().max()),
        "tol": "bit-equal to the plain version (same order of additions)",
        "ms": median_ms(lambda: sg.ell_residual(cols, vals, y, w), torch,
                        flush),
        "plain_ms": median_ms(lambda: sg.ell_residual_plain(cols, vals, y, w),
                              torch, flush),
        "library_ms": median_ms(lambda: (vals * w[cols_l]).sum(1) - y, torch,
                                flush),
        "library": "(vals * w[cols]).sum(1) - y",
    }
    rec["bound_ms"], rec["bound_by"] = s1_bound(
        n * (K * 8 + 4) + d * 4 + n * 4, 2.0 * n * K)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    if not (rec["bit_equal_plain"] and rec["bit_equal"]):
        raise RuntimeError(f"ell_residual disagrees with its plain version: "
                           f"{rec}")
    return rec


def s1_grad_sum_case(name, c_sel, v_sel, coeff, d, torch, sg, flush):
    """``grad_sum`` over gathered rows (ASAGA's table delta)."""
    m, K = c_sel.shape
    flat = c_sel.long().reshape(-1)
    contrib = (v_sel * coeff[:, None]).reshape(-1)

    def fused():
        return sg.grad_sum(c_sel, v_sel, coeff, d)

    g, g2 = fused(), fused()
    g_cpu = sg.grad_sum_plain(c_sel.cpu(), v_sel.cpu(), coeff.cpu(), d)
    times = turns_ms([fused, lambda: torch.zeros(
        d, device=c_sel.device).index_add_(0, flat, contrib)], torch, flush)
    live = int((v_sel != 0).sum())
    rec = {
        "phase": "kernel", "kernel": "sparse_grad.grad_sum", "case": name,
        "slots": m, "K": K, "d": d, "live_entries": live,
        "bit_equal_plain_cpu": bool(torch.equal(g.cpu(), g_cpu)),
        "bit_equal": bool(torch.equal(g, g2)),
        "max_abs_err": float((g.cpu() - g_cpu).abs().max()),
        "tol": "bit-equal to the plain version on the CPU",
        "ms": times[0], "library_ms": times[1],
        "library": "index_add_ of the precomputed products (atomics)",
        "plain_ms": median_ms(lambda: sg.grad_sum_plain(c_sel, v_sel, coeff,
                                                        d), torch, flush),
    }
    # the gathered rows, coeff once; g out
    rec["bound_ms"], rec["bound_by"] = s1_bound(m * K * 8 + m * 4 + d * 4,
                                                2.0 * live)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    emit(rec)
    if not (rec["bit_equal_plain_cpu"] and rec["bit_equal"]):
        raise RuntimeError(f"grad_sum disagrees with its plain version: {rec}")
    return rec


def graph_case(phase, fn, ref, torch):
    """Whether ``fn()`` (one kernel launch, a cooperative launch on B1's
    staged route and on S1) is captured by a CUDA graph, and whether the
    replay gives ``ref``'s bits: a record only."""
    rec = {"phase": phase}
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # the capture stream's scratch, made outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        rec.update(captures=True, replay_bit_equal=bool(torch.equal(out, ref)))
    except Exception as e:  # a record of what CUDA refuses to capture
        torch.cuda.synchronize()
        rec.update(captures=False, error=f"{type(e).__name__}: {e}"[:300])
    emit(rec)
    return rec


def sparse_phase(torch, card):
    """The rcv1 deployment through kernel S1 (``tools/rcv1.py``)."""
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD
    from asyncframework_tpu_torch.tools import rcv1

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ds = rcv1.dataset(dev)
    torch.cuda.synchronize()
    emit({"phase": "sparse_data", "card": card,
          "generate_s": time.monotonic() - t0, **rcv1.describe(ds)})
    launches = {"compacted_grad": 0, "grad_sum": 0, "ell_residual": 0,
                "segment_sum": 0}
    records = rcv1.phase(ds, dev)
    for rec in records:
        emit({"phase": "sparse", "card": card, **rec})
        for key in launches:
            launches[key] += rec["launches"][key]
    # the fused loop on the same deployment: a chunk's replay against its
    # eager rounds, then ASGD and ASAGA run_fused() at the same recipes
    for solver_cls, iters, gamma in ((ASGD, rcv1.ASGD_UPDATES, rcv1.ASGD_GAMMA),
                                     (ASAGA, rcv1.SAGA_UPDATES,
                                      rcv1.SAGA_GAMMA)):
        fused_graph("rcv1", solver_cls(ds, None, rcv1.config(iters, gamma),
                                       devices=[dev]), card)
    fused = rcv1.fused_phase(ds, dev)
    for rec in fused:
        emit({"phase": "fused", "config": "rcv1", "card": card,
              **{k: v for k, v in rec.items() if k != "trajectory"}})
        # the task launches on the path: captured a round x rounds
        launches["compacted_grad"] += rec["launches_on_path"]["compacted_grad"]
        for key in ("grad_sum", "ell_residual", "segment_sum"):
            launches[key] += rec["launches"][key]
    del ds
    torch.cuda.empty_cache()
    failed = [f"{r['solver']}.{r['mode']}" for r in records + fused
              if not r["ok"]]
    if failed:
        raise RuntimeError(f"sparse phase gates failed: {failed}")
    return launches


# ASAGA step size: 0.5, the largest of {0.5, 0.2, 0.1, 0.05, 0.02} for which
# the JAX package's ASAGA.run_sync halves the objective, over the 1,500
# rounds run here, on a 16,000 x 2,000 draw of the same generator on the CPU
# (tests/test_torch_asaga.py::test_smoke_step_size_halves_in_jax)
SAGA_GAMMA = 0.5
SAGA_ROUNDS = 1_500
SAGA_UPDATES = 2_000


def asaga_phase(ds, torch, np, mg, card):
    """ASAGA run() and run_sync() on the full-size epsilon deployment."""
    from asyncframework_tpu_torch.solvers import ASAGA, SolverConfig

    dev = torch.device("cuda", 0)
    cfg = dict(num_workers=8, gamma=SAGA_GAMMA, taw=2**31 - 1,
               batch_rate=0.1, bucket_ratio=0.7, printer_freq=100, seed=42)
    mg.masked_grad.launches = 0
    mg.masked_grad.launches_staged = 0
    mg.masked_grad.launches_tiled = 0
    mg.saga_grad.launches = 0
    mg.xt_coeff.launches = 0
    solver = ASAGA(ds, None, SolverConfig(num_iterations=SAGA_UPDATES, **cfg),
                   devices=[dev])
    res = solver.run()
    tasks_async = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    sync_solver = ASAGA(ds, None, SolverConfig(num_iterations=SAGA_ROUNDS, **cfg),
                        devices=[dev])
    res_sync = sync_solver.run_sync()
    tasks_sync = sum(m.succeeded
                     for m in sync_solver.scheduler.pool.all_metrics())
    launches = {"masked_grad": mg.masked_grad.launches,
                "saga_grad": mg.saga_grad.launches,
                "xt_coeff": mg.xt_coeff.launches,
                "masked_grad_staged": mg.masked_grad.launches_staged,
                "masked_grad_tiled": mg.masked_grad.launches_tiled}
    for mode, r in (("run", res), ("run_sync", res_sync)):
        obj0, obj1 = r.trajectory[0][1], r.final_objective
        rec = {
            "phase": "asaga", "mode": mode, "n": ds.n, "d": ds.d,
            "workers": 8, "dtype": "float32", "gamma": SAGA_GAMMA,
            "card": card, "accepted": r.accepted, "dropped": r.dropped,
            "rounds": r.rounds, "max_staleness": r.max_staleness,
            "updates_per_sec": r.updates_per_sec, "elapsed_s": r.elapsed_s,
            "objective_at_w0": obj0, "final_objective": obj1,
            "finite": bool(np.isfinite(r.final_w).all()),
        }
        emit(rec)
        if not (rec["finite"] and obj1 < obj0 / 2):
            raise RuntimeError(f"ASAGA {mode} did not halve the objective: {rec}")
    if res.accepted != SAGA_UPDATES or res_sync.rounds != SAGA_ROUNDS:
        raise RuntimeError("ASAGA stopped short of its iteration budget")
    # alpha_bar against the history table's mean, (1/N) sum_s X_s^T alpha_s
    # (after the counts were read: these launches are checks, not the path)
    expected = torch.zeros(ds.d, device=dev)
    for wid, a in res.extras["alpha"].items():
        expected += mg.xt_coeff(ds.shard(wid).X, torch.tensor(a, device=dev))
    expected = (expected / ds.n).cpu().numpy()
    ab = res.extras["alpha_bar"]
    # the JAX test's rtol = 1e-3; the absolute floor is 1e-3 of the
    # largest entry (alpha_bar is ~1e-3 here, so an absolute 1e-4 floor
    # would check next to nothing)
    ab_err = float(np.abs(ab - expected).max())
    ab_ok = bool(np.all(np.abs(ab - expected)
                        <= 1e-3 * np.abs(expected) + 1e-3 * np.abs(expected).max()))
    emit({"phase": "asaga_invariant", "alpha_bar_max_abs_err": ab_err,
          "alpha_bar_max": float(np.abs(expected).max()),
          "tol": "1e-3 * |mean| + 1e-3 * max|mean|", "ok": ab_ok})
    # both forms take the staged route at this shard
    need = {"saga_grad": tasks_async + tasks_sync, "xt_coeff": res.accepted,
            "masked_grad": tasks_async + tasks_sync + res.accepted,
            "masked_grad_staged": tasks_async + tasks_sync + res.accepted}
    emit({"phase": "launches", "path": "asaga", **launches,
          "tasks_run": tasks_async + tasks_sync, "accepted_async": res.accepted})
    if not ab_ok:
        raise RuntimeError("ASAGA alpha_bar is not the history table's mean")
    if any(launches[key] < need[key] for key in need):
        raise RuntimeError(f"ASAGA did not run every task and commit through "
                           f"the masked_grad kernel: {launches} < {need}")
    return launches


# the fused loop at bench.py's recipes (bench.py:94-113, 419-431): 8
# workers, taw 2^31-1, bucket ratio 0.7, a snapshot every 25 updates, seed
# 42; ASAGA (not in bench.py) at phase 5's step size.  A chunk graph holds
# 16 rounds (solvers/base.py::run_fused_plan).
EPS_FUSED_UPDATES, EPS_SAGA_FUSED_UPDATES = 5_000, 2_000
MNIST8M_N, MNIST8M_D, MNIST8M_GAMMA = 8_100_000, 784, 39.2
MNIST8M_FUSED_UPDATES, MNIST8M_RUN_UPDATES = 5_000, 1_000
# alpha_bar against the history table's mean: the JAX package's fused band
# (tests/test_fused.py:139)
FUSED_SAGA_RTOL, FUSED_SAGA_ATOL = 2e-3, 2e-5


def bench_config(SolverConfig, iters, gamma, batch_rate=0.1):
    return SolverConfig(num_workers=8, num_iterations=iters, gamma=gamma,
                        taw=2**31 - 1, batch_rate=batch_rate, bucket_ratio=0.7,
                        printer_freq=25, coeff=0.0, seed=42,
                        calibration_iters=100)


def fused_graph(config, solver, card):
    """One 16-round chunk of ``solver``'s fused loop captured as a CUDA
    graph and replayed, bit-equal to the same chunk run eagerly from the
    same state and generator states (``tools/runs.py::graph_check``); the
    launches the warm-up and the capture counted, by route."""
    from asyncframework_tpu_torch.tools import runs

    rec = {"phase": "fused_graph", "config": config,
           "solver": type(solver).__name__, "card": card,
           **runs.graph_check(solver)}
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"{config} fused chunk: the replay is not the "
                           f"eager rounds: {rec}")
    return rec


def through(rec, *forms) -> bool:
    """Every accepted update of the run was one launch of each of
    ``forms`` (on the fused path: captured once a round, replayed)."""
    return all(rec["launches_on_path"][f] == rec["accepted"] > 0
               for f in forms)


def gated_run(config, solver_cls, mode, ds, cfg, torch, card, gates):
    """One run through ``tools/runs.py::run_one`` (every count set to 0
    just before it, read just after), its line, and its gates (``gates(rec,
    res)``: name -> passed); a gate that fails raises."""
    from asyncframework_tpu_torch.tools import runs

    res, rec = runs.run_one(solver_cls, mode, ds, cfg,
                            torch.device("cuda", 0))
    rec["gates"] = gates(rec, res)
    rec["ok"] = all(rec["gates"].values())
    line = {k: v for k, v in rec.items() if k != "trajectory"}
    emit({"phase": "fused" if mode == "run_fused" else f"engine_{mode}",
          "config": config, "card": card, **line})
    if not rec["ok"]:
        raise RuntimeError(f"{config} {solver_cls.__name__}.{mode} failed "
                           f"its gates: {rec['gates']}")
    return res, rec


def fused_epsilon_phase(ds, torch, np, mg, card):
    """``run_fused`` on the epsilon deployment: a chunk's replay against
    its eager rounds (ASGD and ASAGA), then ASGD (5,000 updates) and ASAGA
    (2,000), each gated: below 1/10 (ASGD) or 1/2 (ASAGA) of the objective
    at w = 0, every task one staged B1 launch, ASAGA's ``alpha_bar`` the
    history table's mean."""
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig

    dev = torch.device("cuda", 0)
    asgd_cfg = bench_config(SolverConfig, EPS_FUSED_UPDATES, 100.0)
    saga_cfg = bench_config(SolverConfig, EPS_SAGA_FUSED_UPDATES, SAGA_GAMMA)
    fused_graph("epsilon", ASGD(ds, None, asgd_cfg, devices=[dev]), card)
    fused_graph("epsilon", ASAGA(ds, None, saga_cfg, devices=[dev]), card)

    def asgd_gates(rec, res):
        return {"finite": rec["finite"],
                "below_0.1x": rec["final_objective"]
                < rec["objective_at_w0"] / 10,
                "through_b1_staged": through(rec, "masked_grad",
                                             "masked_grad_staged")}

    def saga_gates(rec, res):
        # (1/N) sum_s X_s^T alpha_s (after the counts were read)
        expected = torch.zeros(ds.d, device=dev)
        for wid, a in res.extras["alpha"].items():
            expected += mg.xt_coeff(ds.shard(wid).X,
                                    torch.tensor(a, device=dev))
        expected = (expected / ds.n).cpu().numpy()
        err = np.abs(res.extras["alpha_bar"] - expected)
        rec.update(alpha_bar_max_abs_err=float(err.max()),
                   alpha_bar_max=float(np.abs(expected).max()),
                   invariant_tol=f"{FUSED_SAGA_RTOL} * |mean| + "
                                 f"{FUSED_SAGA_ATOL}")
        return {"finite": rec["finite"],
                "below_0.5x": rec["final_objective"]
                < rec["objective_at_w0"] / 2,
                "alpha_bar_is_table_mean": bool(np.all(
                    err <= FUSED_SAGA_RTOL * np.abs(expected)
                    + FUSED_SAGA_ATOL)),
                "through_b1_staged": through(rec, "saga_grad",
                                             "masked_grad_staged")}

    _, asgd = gated_run("epsilon", ASGD, "run_fused", ds, asgd_cfg, torch,
                        card, asgd_gates)
    _, saga = gated_run("epsilon", ASAGA, "run_fused", ds, saga_cfg, torch,
                        card, saga_gates)
    return asgd, saga


def mnist8m_phase(torch, card):
    """The mnist8m deployment end to end (``bench.py:99-103``: 8,100,000 x
    784 bf16 generated on the card, seed 7, noise 0.01, 8 workers, gamma
    39.2, b = 0.1): a chunk's replay against its eager rounds, then ASGD
    ``run_fused()`` (5,000 updates) and ``run()`` (1,000), each below 1/10
    of the objective at w = 0 and every task one staged B1 launch."""
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
    from asyncframework_tpu_torch.utils.hbm import dataset_residency_bytes

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ds = ShardedDataset.generate_on_device(
        MNIST8M_N, MNIST8M_D, 8, [dev], seed=7, noise=0.01,
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "mnist8m_data", "card": card, "n": ds.n, "d": ds.d,
          "dtype": "bfloat16", "workers": 8,
          "bytes": sum(dataset_residency_bytes(ds).values()),
          "generate_s": time.monotonic() - t0})
    fused_cfg = bench_config(SolverConfig, MNIST8M_FUSED_UPDATES,
                             MNIST8M_GAMMA)
    run_cfg = bench_config(SolverConfig, MNIST8M_RUN_UPDATES, MNIST8M_GAMMA)
    fused_graph("mnist8m", ASGD(ds, None, fused_cfg, devices=[dev]), card)

    def gates(rec, res):
        return {"finite": rec["finite"],
                "below_0.1x": rec["final_objective"]
                < rec["objective_at_w0"] / 10,
                "budget": res.accepted == rec["budget"],
                "through_b1_staged": rec["launches_on_path"]["masked_grad"]
                >= rec["tasks_run"] > 0
                and rec["launches_on_path"]["masked_grad_staged"]
                == rec["launches_on_path"]["masked_grad"]}

    _, fused = gated_run("mnist8m", ASGD, "run_fused", ds, fused_cfg, torch,
                         card, gates)
    _, engine = gated_run("mnist8m", ASGD, "run", ds, run_cfg, torch, card,
                          gates)
    del ds
    torch.cuda.empty_cache()
    return fused, engine


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
    from asyncframework_tpu_torch.ops import chunk_attention as ca
    from asyncframework_tpu_torch.ops import masked_grad as mg
    from asyncframework_tpu_torch.ops import sparse_grad as sg
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
        for function, info in ptxas_lines(_build.ptxas_report(name)):
            emit({"phase": "ptxas", "kernel": name, "function": function,
                  "info": info})

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
        # just over the staged route's least bytes of X (1 MB of 512 KB)
        ("d_small_132x2000", 132, 2_000, f32, 1.0, None, "least_squares"),
        ("e_epsilon_logistic", 50_000, 2_000, f32, 0.7, None, "logistic"),
    ]
    recs = {}
    for name, n, d, dtype, b, cap, loss in cases:
        recs[name] = kernel_case(name, n, d, dtype, torch, mg, flush, gen, b,
                                 cap, loss)
        torch.cuda.empty_cache()
    # ASAGA's forms at the epsilon shard the ASAGA phase runs (b = 0.1)
    for name, dtype in (("saga_epsilon", f32), ("xt_epsilon", f32),
                        ("saga_mnist8m_shard", bf16), ("xt_mnist8m_shard", bf16)):
        n, d = (50_000, 2_000) if "epsilon" in name else (1_012_500, 784)
        recs[name] = saga_case(name, n, d, dtype, torch, mg, flush, gen, 0.1)
        torch.cuda.empty_cache()
    att_cases = [
        ("f_ring_block_causal", 1, 8_192, 8_192, 32, 128, bf16, "causal"),
        ("f_ring_block_nomask", 1, 8_192, 8_192, 32, 128, bf16, "none"),
        ("g_ulysses_block_causal", 1, 32_768, 512, 8, 128, bf16, "ulysses_mid"),
        ("h_ragged_24x18", 2, 24, 18, 3, 20, f32, "random"),
        ("h_tq1", 1, 1, 18, 3, 64, f32, "none"),
        ("h_d64_f32", 1, 300, 257, 4, 64, f32, "causal"),
        # the tensor-core route's edges: ragged Tq and Tk (TMA's zero fill
        # plus the mask), D = 64, a fully masked row, one query row
        ("i_bf16_ragged_300x257", 1, 300, 257, 4, 128, bf16, "causal"),
        ("i_bf16_d64", 2, 200, 130, 4, 64, bf16, "none"),
        ("i_bf16_random", 2, 100, 77, 3, 128, bf16, "random"),
        ("i_bf16_tq1", 1, 1, 18, 3, 128, bf16, "none"),
    ]
    for name, *shape in att_cases:
        recs[name] = attention_case(name, *shape, torch, ca, flush, gen)
    for name, *shape in S1_CASES:
        recs[name] = s1_case(name, *shape, torch, sg, flush, gen)
        torch.cuda.empty_cache()
    del flush

    # ------------------------------------------------------- 3. main path
    ds = ShardedDataset.generate_on_device(
        400_000, 2_000, 8, [dev], seed=7, noise=0.01
    )
    cfg = dict(num_workers=8, gamma=100.0, taw=2**31 - 1, batch_rate=0.1,
               bucket_ratio=0.7, printer_freq=25, seed=42)
    mg.masked_grad.launches = 0
    mg.masked_grad.launches_staged = 0
    mg.masked_grad.launches_tiled = 0
    solver = ASGD(ds, None, SolverConfig(num_iterations=1000, **cfg),
                  devices=[dev])
    res = solver.run()
    tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    sync_solver = ASGD(ds, None, SolverConfig(num_iterations=300, **cfg),
                       devices=[dev])
    res_sync = sync_solver.run_sync()
    tasks += sum(m.succeeded for m in sync_solver.scheduler.pool.all_metrics())
    launches = mg.masked_grad.launches
    staged = mg.masked_grad.launches_staged
    tiled = mg.masked_grad.launches_tiled
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
    emit({"phase": "launches", "masked_grad": launches,
          "masked_grad_staged": staged, "masked_grad_tiled": tiled,
          "tasks_run": tasks})
    if launches < tasks or tasks == 0:
        raise RuntimeError("the main path did not run every task through "
                           "the masked_grad kernel")
    if staged < tasks:
        raise RuntimeError(f"{tasks} ASGD tasks but {staged} launches on "
                           f"masked_grad's staged route")
    del solver, sync_solver
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

    # ---------------------------------------------------- 4. long context
    att_launches, _ = long_context_phase(torch, ca, card, recs)

    # ------------------------------------------------------------ 5. asaga
    saga_launches = asaga_phase(ds, torch, np, mg, card)

    # ---------------------------------------------------- 6. fused, epsilon
    eps_fused, saga_fused = fused_epsilon_phase(ds, torch, np, mg, card)
    del ds
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 7. sparse
    s1_launches = sparse_phase(torch, card)

    # ---------------------------------------------------------- 8. mnist8m
    mnist_fused, mnist_run = mnist8m_phase(torch, card)

    # ------------------------------------------------------- 9. results
    emit({"phase": "total", "seconds": time.monotonic() - t_start})
    print(card, flush=True)

    def entry(name, source, replaces, count, rec, bound_ms):
        return {
            "name": name, "route": "cuda",
            "source": f"asyncframework_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": count,
            "max_abs_err": rec.get("max_abs_err", rec.get("o_max_abs_err")),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }

    b1 = "asyncframework_tpu/ops/pallas_kernels.py:58"
    f_rec = recs["f_ring_block_causal"]  # the ring's diagonal block
    s_task = recs["s_rcv1_task"]
    s_eval = recs["s_rcv1_shard"]["residual"]
    xla = "(XLA, no pallas_call)"
    # launches: each path's count, set to 0 just before it and read just
    # after; on the fused paths the launches captured a round times the
    # rounds replayed (tools/runs.py)
    emit({"kernels": [
        # the main paths' shapes: ASGD's compacted epsilon shard (b = 0.1),
        # ASAGA's full epsilon shard, the ring block of the long-context path
        entry("masked_grad", "masked_grad.cu", b1, launches + sum(
            r["launches_on_path"]["masked_grad"]
            for r in (eps_fused, mnist_fused, mnist_run)),
              recs["b_epsilon_idx"], recs["b_epsilon_idx"]["bound_us"] / 1e3),
        entry("masked_grad.saga_grad", "masked_grad.cu", b1,
              saga_launches["saga_grad"]
              + saga_fused["launches_on_path"]["saga_grad"],
              recs["saga_epsilon"], recs["saga_epsilon"]["bound_us"] / 1e3),
        entry("masked_grad.xt_coeff", "masked_grad.cu", b1,
              saga_launches["xt_coeff"], recs["xt_epsilon"],
              recs["xt_epsilon"]["bound_us"] / 1e3),
        entry("chunk_attention", "chunk_attention.cu",
              "asyncframework_tpu/ops/pallas_kernels.py:155", att_launches,
              f_rec, f_rec["bound_ms"]),
        # rcv1: no Pallas kernel on this path (XLA).  The task (residual,
        # sort and segment sum in one launch) at the compacted task, its
        # coefficient form at ASAGA's table delta, the residual alone at
        # the evaluation's full shard
        entry("sparse_grad.compacted_grad", "sparse_grad.cu",
              f"asyncframework_tpu/ops/steps.py:519 {xla}",
              s1_launches["compacted_grad"], s_task["task"],
              s_task["task"]["bound_ms"]),
        entry("sparse_grad.grad_sum", "sparse_grad.cu",
              f"asyncframework_tpu/ops/gradients.py:138 {xla}",
              s1_launches["grad_sum"], s_task["grad_sum"],
              s_task["grad_sum"]["bound_ms"]),
        entry("sparse_grad.ell_residual", "sparse_grad.cu",
              f"asyncframework_tpu/ops/gradients.py:131 {xla}",
              s1_launches["ell_residual"], s_eval, s_eval["bound_ms"]),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

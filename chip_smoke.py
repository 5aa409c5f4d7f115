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
   shard, and chunk_attention at a ring block (f), a Ulysses block (g) and
   small ragged shapes (h);
3. main path -- ASGD ``run()`` and ``run_sync()`` on the full-size epsilon
   deployment (400,000 x 2,000 f32, 8 workers, b = 0.1) generated on the
   card, with every kernel's launch count set to 0 just before and read
   just after; then the same solver on a small input, on the card and on
   the CPU (plain path), must agree;
4. long_context -- ``ring_attention`` and ``ulysses_attention`` at
   Llama-2-7B's attention width (32 heads x 128) over a 32,768-token bf16
   sequence on a 4-rank mesh of this one card, through the chunk_attention
   kernel: 256 query rows against exact f32 attention, the two paths
   against each other, and the launch counts;
5. asaga -- ASAGA ``run()`` and ``run_sync()`` on the same epsilon
   deployment through the masked_grad kernel's history forms: the
   objective halves, ``alpha_bar`` is the history table's mean, and the
   launch counts;
6. the ``{"kernels": [...]}`` line, the card line again, and last the
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


def median_ms(fn, torch, flush, calls: int = TIMED_LAUNCHES) -> float:
    """Median device time of one call of ``fn`` over ``calls`` calls,
    each timed alone with CUDA events after the L2 was flushed (the main
    path finds its shard cold: 8 shards of 400 MB do not fit a 50 MB L2).
    A sleep kernel queued ahead of each call keeps the device busy while
    the host enqueues it, so the interval holds device work only, not the
    wrapper's Python time."""
    fn()
    times = []
    for _ in range(calls):
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
    got, again, ref = kernel(), kernel(), plain()
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
        "case": name, "n": n, "d": d, "dtype": dt,
        "max_abs_err": errs[0], "max_rel_err": errs[0] / scales[0],
        "diff_max_abs_err": errs[1] if len(errs) > 1 else None,
        "tol": f"{tol_rel} * max|plain| per output",
        "within_tol": ok, "bit_equal": bit_equal,
        "ms": median_ms(kernel, torch, flush),
        "plain_ms": median_ms(plain, torch, flush),
        "library_ms": median_ms(library, torch, flush),
        "bound_us": max(byte_s, flop_s) * 1e6,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    }
    emit(rec)
    if not ok or not bit_equal:
        raise RuntimeError(f"{rec['form']} disagrees with its plain version: {rec}")
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
    scaled_dot_product_attention (f32, same boolean mask) as a yardstick:
    it computes o / l only, and the port never calls it."""
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

    got, again = kernel(), kernel()
    ref = plain()
    torch.cuda.synchronize()
    rec = {"phase": "kernel", "kernel": "chunk_attention", "case": name,
           "B": B, "Tq": tq, "Tk": tk, "H": H, "D": D,
           "dtype": str(dtype).replace("torch.", ""), "mask": mask_kind}
    ok = True
    for key, a, r in zip("oml", got, ref):
        err = (a - r).abs()
        rel = float((err / r.abs().clamp(min=1.0)).max())
        rec[f"{key}_max_abs_err"] = float(err.max())
        rec[f"{key}_max_rel_err"] = rel
        rec[f"{key}_tol_rel"] = ATT_TOL[key]
        ok = ok and rel <= ATT_TOL[key] and bool(torch.isfinite(a).all())
    if mask_kind == "random":
        # the TPU kernel's padded-Tk count for a row with no unmasked key
        ok = ok and bool((got[2][:, :, tq // 2] == -(-tk // 8) * 8).all())
    del ref
    bit_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del got, again
    torch.cuda.empty_cache()
    flops = 4.0 * B * H * D * needed_pairs(mask, tq, tk, torch)
    bytes_moved = (sum(x.numel() * x.element_size() for x in (q, k, v))
                   + (0 if mask is None else mask.numel())
                   + B * tq * H * D * 4 + 2 * B * H * tq * 4)
    flop_s, byte_s = flops / F32_FLOPS, bytes_moved / HBM_BYTES_PER_S
    calls = TIMED_ATTENTION if flops > 1e10 else TIMED_LAUNCHES
    rec.update({
        "within_tol": ok, "bit_equal": bit_equal,
        "ms": median_ms(kernel, torch, flush, calls),
        "plain_ms": median_ms(plain, torch, flush, calls),
        "library_ms": median_ms(library, torch, flush, calls),
        "library": "scaled_dot_product_attention, f32, o/l only (yardstick)",
        "bound_ms": max(flop_s, byte_s) * 1e3,
        "bound_by": "operations" if flop_s >= byte_s else "bytes",
        "flop": flops,
    })
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    emit(rec)
    del q, k, v, qf, kf, vf, mask
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


def long_context_phase(torch, ca, card):
    """Ring and Ulysses attention at Llama-2-7B's attention width over a
    32,768-token sequence on a 4-rank mesh of this one card."""
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
    ca.chunk_attention.launches = 0
    outs, recs = {}, {}
    for name, fn, flop, folds in (
        ("ring", lambda: ring_attention(q, k, v, mesh, causal=True,
                                        block_kernel="cuda"),
         ring_flop, P * (P + 1) // 2),
        ("ulysses", lambda: ulysses_attention(q, k, v, mesh, causal=True,
                                              block_kernel="cuda",
                                              pallas_block=BLK),
         ulysses_flop, P * (T // BLK)),
    ):
        before = ca.chunk_attention.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        outs[name] = fn()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launched = ca.chunk_attention.launches - before
        recs[name] = {
            "phase": "long_context", "fn": name, "card": card,
            "B": B, "T": T, "H": H, "D": D, "ranks": P, "dtype": "bfloat16",
            "causal": True, "seconds": secs, "launches": launched,
            "folds_expected": folds, "flop": flop,
            "tflops": flop / secs / 1e12,
            "bound_s": flop / F32_FLOPS,
            "bound_share": flop / F32_FLOPS / secs,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        }
        if launched < folds:
            emit(recs[name])
            raise RuntimeError(f"{name} made {launched} chunk_attention "
                               f"launches, fewer than its {folds} folds")
    launches = ca.chunk_attention.launches
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
        recs[name].update({"rows_checked": len(rows),
                           "max_abs_err_vs_exact": float(err.max()),
                           "rows_tol": "2^-8 * |exact| + 1e-4 * max|exact|",
                           "outside_tol": bad,
                           "finite": bool(torch.isfinite(outs[name]).all())})
        emit(recs[name])
        ok = ok and bad == 0 and recs[name]["finite"]
    a, b = outs["ring"].float(), outs["ulysses"].float()
    cross = (a - b).abs()
    cross_bad = int((cross > 2 ** -7 * b.abs() + 1e-4 * float(b.abs().max())).sum())
    emit({"phase": "long_context_agreement", "max_abs_diff": float(cross.max()),
          "tol": "2^-7 * |ulysses| + 1e-4 * max|ulysses|",
          "outside_tol": cross_bad, "chunk_attention_launches": launches})
    if not ok or cross_bad:
        raise RuntimeError("long-context attention disagrees with exact "
                           "attention or across the two paths")
    del q, k, v, outs, exact, a, b, cross
    torch.cuda.empty_cache()
    return launches, recs


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
                "xt_coeff": mg.xt_coeff.launches}
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
    need = {"saga_grad": tasks_async + tasks_sync, "xt_coeff": res.accepted,
            "masked_grad": tasks_async + tasks_sync + res.accepted}
    emit({"phase": "launches", "path": "asaga", **launches,
          "tasks_run": tasks_async + tasks_sync, "accepted_async": res.accepted})
    if not ab_ok:
        raise RuntimeError("ASAGA alpha_bar is not the history table's mean")
    if any(launches[key] < need[key] for key in need):
        raise RuntimeError(f"ASAGA did not run every task and commit through "
                           f"the masked_grad kernel: {launches} < {need}")
    return launches


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
    ]
    for name, *shape in att_cases:
        recs[name] = attention_case(name, *shape, torch, ca, flush, gen)
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
    att_launches, _ = long_context_phase(torch, ca, card)

    # ------------------------------------------------------------ 5. asaga
    saga_launches = asaga_phase(ds, torch, np, mg, card)
    del ds
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 6. results
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
    emit({"kernels": [
        # the main paths' shapes: ASGD's compacted epsilon shard (b = 0.1),
        # ASAGA's full epsilon shard, the ring block of the long-context path
        entry("masked_grad", "masked_grad.cu", b1, launches,
              recs["b_epsilon_idx"], recs["b_epsilon_idx"]["bound_us"] / 1e3),
        entry("masked_grad.saga_grad", "masked_grad.cu", b1,
              saga_launches["saga_grad"], recs["saga_epsilon"],
              recs["saga_epsilon"]["bound_us"] / 1e3),
        entry("masked_grad.xt_coeff", "masked_grad.cu", b1,
              saga_launches["xt_coeff"], recs["xt_epsilon"],
              recs["xt_epsilon"]["bound_us"] / 1e3),
        entry("chunk_attention", "chunk_attention.cu",
              "asyncframework_tpu/ops/pallas_kernels.py:155", att_launches,
              f_rec, f_rec["bound_ms"]),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

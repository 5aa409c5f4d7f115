"""The dataset layer and the graph library on one GPU at published shapes:
arms, records and gates.

    python3 -m asyncframework_tpu_torch.tools.dataset_graph \\
        [--arms async_reduce,wordcount,pagerank,svdpp,dense]

:func:`phase` runs the arms below, one JSON line an arm, and raises if a
gate failed.  Every arm generates its data on the card from :data:`SEED`
(no corpus, graph or ratings file is in the repository) and frees it
before the next:

- ``async_reduce_epsilon``: the paper's driver loop on the dataset API at
  epsilon's shape (``bench.py:94-98``: 400,000 x 2,000 f32 in 8 partitions
  on the card, phase 3's generator).  Each round
  ``barrier(ctx, bucket_predicate(ctx, 8, 0.7))`` selects the cohort,
  ``map_partitions`` computes each task's B1 compacted masked gradient at
  b = 0.1 (one launch a task), and ``async_reduce`` streams the results
  into ``ctx``; the driver drains ``ctx`` between rounds and applies each
  result with ``ops/steps.py::make_asgd_apply`` when its staleness is at
  most :data:`EPS_TAW`, at phase 3's gamma (100) and budget (1,000
  accepted updates).  Gates: the objective below 1/10 of its value at
  w = 0, exactly one B1 launch a task, every accepted staleness <= tau;
- ``wordcount_text8``: text8's shape (17,005,207 tokens over a Zipf(1)
  vocabulary of 253,854), int64 keys and int32 ones in 8 blocks through
  ``from_array_pairs``, ``reduce_by_key("sum")`` on the device plane (the
  ``auto`` rule, as the blocks are on the card; its first call in the
  process and a warm one) and on the host plane.
  Gates: the device plane taken, both planes equal to numpy's
  ``bincount`` key for key, key ``k`` in partition ``k mod 8``, the counts
  totalling the token count;
- ``pagerank_livejournal``: soc-LiveJournal1's shape (4,847,571 vertices,
  68,993,773 directed edges) drawn by Graph500's R-MAT (a, b, c = 0.57,
  0.19, 0.19) at scale 23 and folded into the vertex count (ids mod n).
  ``pagerank`` (alpha 0.85, 20 iterations) and ``connected_components``.
  Gates: the ranks summing to 1 within 1e-5, their L1 distance to a
  float64 power iteration on the card within :data:`PR_L1_TOL`, the
  components equal to scipy's weak components, each mapped to its
  smallest vertex id;
- ``svdpp_ml1m``: MovieLens-1M's shape (6,040 users, 3,706 items,
  1,000,209 ratings; ``tools/ml.py``'s generator) through
  ``svd_plus_plus`` at rank 8 (:data:`SVDPP_LR`, :data:`SVDPP_ITERS`).
  Gates: the loss falling, the training RMSE below the global mean's, and
  the model saved and loaded by ``ml/persistence.py`` predicting bit for
  bit;
- ``dense_graph_16k``: the dense regime's ceiling, n = 2^14, Graph500
  R-MAT at scale 14 and edge factor 16 (262,144 edges):
  ``triangle_count``, ``label_propagation`` (10 steps) and
  ``strongly_connected_components`` with TF32 off.  Gates: each equal to
  its host check (scipy's ``(A @ A) * A`` row sums, scipy's strong
  components mapped to their smallest ids, ten numpy label-propagation
  steps).

Each record carries seconds (fenced), the arm's rates, peak device bytes
and the card (``nvidia-smi``'s name and power limit).  The records are
also written to a ``KVStore`` opened with ``backend="native"`` and read
back by the Python backend (the ``dataset_graph_store`` line).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import queue
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
from asyncframework_tpu_torch.context import AsyncContext
from asyncframework_tpu_torch.data.dataset import DistributedDataset
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.engine.barrier import bucket_predicate
from asyncframework_tpu_torch.engine.scheduler import JobScheduler
from asyncframework_tpu_torch.graph import (
    Graph,
    connected_components,
    label_propagation,
    pagerank,
    pregel,
    strongly_connected_components,
    svd_plus_plus,
    triangle_count,
)
from asyncframework_tpu_torch.ml.persistence import load_model, save_model
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops import shuffle
from asyncframework_tpu_torch.ops import steps
from asyncframework_tpu_torch.storage import KVStore
from asyncframework_tpu_torch.tools import ml as ml_tools

SEED = 19
ARMS = ("async_reduce", "wordcount", "pagerank", "svdpp", "dense")

# (a) epsilon through the dataset API: phase 3's shape, recipe and budget
EPS_N, EPS_D, EPS_WORKERS = 400_000, 2_000, 8
EPS_GAMMA, EPS_B, EPS_BUCKET, EPS_BUDGET = 100.0, 0.1, 0.7, 1_000
EPS_TAW = 16  # staleness bound of the apply
# (b) text8
TEXT8_TOKENS, TEXT8_VOCAB, TEXT8_BLOCKS = 17_005_207, 253_854, 8
# (c) soc-LiveJournal1 by R-MAT
LJ_N, LJ_E, LJ_SCALE = 4_847_571, 68_993_773, 23
RMAT = (0.57, 0.19, 0.19)
PR_ALPHA, PR_ITERS, PR_L1_TOL, PR_SUM_TOL = 0.85, 20, 1e-4, 1e-5
# (d) MovieLens-1M
SVDPP_RANK, SVDPP_ITERS = 8, 200
#: the full-batch step: the loss is a mean over the 1,000,209 ratings, so
#: the JAX package's default (0.5, sized for its small tests) barely moves
#: a factor at this shape; three times this value diverges on this data
SVDPP_LR = 40.0
# (e) the dense regime
DENSE_SCALE, DENSE_EDGE_FACTOR, LP_STEPS = 14, 16, 10


def _fence(dev) -> None:
    torch.cuda.synchronize(dev)


def _peak_reset(dev) -> None:
    _fence(dev)
    torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev))


def _gen(dev, offset: int = 0) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + offset)
    return gen


# ------------------------------------------------- (a) async_reduce_epsilon
def async_reduce_arm(dev, card,
                     run_updates_per_s: Optional[float] = None) -> dict:
    """The paper's driver loop (``barrier`` -> ``map_partitions`` ->
    ``async_reduce``, drained and applied by the driver) on epsilon's
    shape; ``run_updates_per_s`` is phase 3's ``run()`` for the record."""
    _peak_reset(dev)
    budget = EPS_BUDGET
    ds = ShardedDataset.generate_on_device(EPS_N, EPS_D, EPS_WORKERS, [dev],
                                           seed=7, noise=0.01)
    n, d = ds.n, ds.d
    sched = JobScheduler(num_workers=EPS_WORKERS, devices=[dev] * EPS_WORKERS)
    ctx = AsyncContext()
    step = steps.make_asgd_worker_step(EPS_B)
    apply = steps.make_asgd_apply(EPS_GAMMA, EPS_B, n, EPS_WORKERS)
    evaluate = steps.make_trajectory_loss_eval("least_squares")
    gens = {w: _gen(dev, 100 + w) for w in range(EPS_WORKERS)}
    data = DistributedDataset(
        sched, {w: (lambda s=shard: [s]) for w, shard in ds.shards.items()})
    tasks = {"n": 0}
    tasks_lock = threading.Lock()

    def gradients(w_pub):
        def f(shards):
            out = []
            for s in shards:
                weights, idx = step.sample(gens[s.worker_id], s.size)
                out.append(step.grad(s.X, s.y, w_pub, weights, idx))
                # completion only: the gradient stays on the card
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                with tasks_lock:
                    tasks["n"] += 1
            return out

        return f

    def objective(w) -> float:
        return sum(float(evaluate(s.X, s.y, w[None, :])[0])
                   for s in ds.shards.values()) / n

    w = torch.zeros(d, device=dev)
    k = torch.zeros((), device=dev)
    obj0 = objective(w)
    data.count()  # the scheduler's first job blocks (its warm-up)
    mg.masked_grad.launches = 0
    mg.masked_grad.launches_staged = 0
    mg.masked_grad.launches_tiled = 0
    accepted: List[int] = []
    dropped, rounds, waiters = 0, 0, []
    t0 = time.monotonic()
    try:
        while len(accepted) < budget:
            failed = next((x.failed for x in waiters if x.failed), None)
            if failed is not None:
                raise RuntimeError("async job aborted") from failed
            cohort, gated = data.barrier(
                ctx, bucket_predicate(ctx, EPS_WORKERS, EPS_BUCKET))
            if cohort:
                waiters.append(gated.map_partitions(gradients(w))
                               .async_reduce(torch.add, ctx, cohort))
                rounds += 1
            # drain: everything queued; wait for one result when no cohort
            # could be formed
            timeout = 0 if cohort else 5.0
            while len(accepted) < budget:
                try:
                    r = ctx.collect_all(timeout=timeout)
                except queue.Empty:
                    break
                timeout = 0
                if r.staleness > EPS_TAW:
                    dropped += 1
                    continue
                w, k = apply(w, r.data, k)
                accepted.append(r.staleness)
        # the cohorts still in flight finish before the clock stops
        while ctx.available_workers() < EPS_WORKERS:
            ctx.collect_all(timeout=30)
        _fence(dev)
        seconds = time.monotonic() - t0
    finally:
        sched.shutdown()
    obj1 = objective(w)
    launches = mg.masked_grad.launches
    stale = np.asarray(accepted)
    rec = {
        "phase": "dataset_graph", "arm": "async_reduce_epsilon",
        "card": card, "n": n, "d": d, "partitions": EPS_WORKERS,
        "gamma": EPS_GAMMA, "batch_rate": EPS_B, "bucket_ratio": EPS_BUCKET,
        "taw": EPS_TAW, "seconds": seconds, "accepted": len(accepted),
        "dropped": dropped, "rounds": rounds, "tasks": tasks["n"],
        "updates_per_s": len(accepted) / seconds,
        "phase3_run_updates_per_s": run_updates_per_s,
        "tasks_per_accepted_update": tasks["n"] / max(len(accepted), 1),
        "staleness_p50": float(np.median(stale)) if stale.size else None,
        "staleness_max": int(stale.max()) if stale.size else None,
        "objective_at_w0": obj0, "final_objective": obj1,
        "b1_launches": launches,
        "b1_launches_staged": mg.masked_grad.launches_staged,
        "b1_launches_tiled": mg.masked_grad.launches_tiled,
        "peak_device_bytes": _peak(dev),
    }
    rec["gates"] = {
        "objective_below_tenth_of_w0": bool(np.isfinite(obj1))
        and obj1 < obj0 / 10,
        "one_b1_launch_a_task": launches == tasks["n"] > 0,
        "accepted_staleness_within_taw": bool(stale.size)
        and int(stale.max()) <= EPS_TAW,
        "budget_reached": len(accepted) == budget,
    }
    del ds, data, w
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------ (b) wordcount_text8
def text8_tokens(dev, n: int, vocab: int):
    """``n`` word ids drawn from Zipf(1) over ``vocab`` on the card."""
    p = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(n, generator=_gen(dev, 1), dtype=torch.float64,
                   device=dev)
    return torch.clamp(torch.searchsorted(cdf, u), max=vocab - 1)


def _plane_run(ds, plane: Optional[str]):
    set_global_conf(None if plane is None
                    else AsyncConf({"async.shuffle.data.plane": plane}))
    try:
        before = dict(shuffle.calls)
        t0 = time.monotonic()
        out = ds.reduce_by_key("sum")
        parts = {pid: out._compute(pid)[0] for pid in out.partition_ids()}
        seconds = time.monotonic() - t0
        taken = {p: shuffle.calls[p] - before[p] for p in before}
    finally:
        set_global_conf(None)
    return parts, seconds, taken


def wordcount_arm(dev, card) -> dict:
    n, vocab = TEXT8_TOKENS, TEXT8_VOCAB
    _peak_reset(dev)
    keys = text8_tokens(dev, n, vocab)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    bounds = np.linspace(0, n, TEXT8_BLOCKS + 1).astype(np.int64)
    blocks = {w: (keys[bounds[w]:bounds[w + 1]], ones[bounds[w]:bounds[w + 1]])
              for w in range(TEXT8_BLOCKS)}
    sched = JobScheduler(num_workers=TEXT8_BLOCKS,
                         devices=[dev] * TEXT8_BLOCKS)
    try:
        ds = DistributedDataset.from_array_pairs(sched, blocks)
        ds.count()  # the scheduler's first job blocks (its warm-up)
        # auto: the device plane, its first call (the sort's and scatter's
        # first launches in the process) and a warm one
        dev_parts, dev_s, dev_taken = _plane_run(ds, None)
        warm_parts, warm_s, _ = _plane_run(ds, None)
        host_parts, host_s, host_taken = _plane_run(ds, "host")
    finally:
        sched.shutdown()
    want = np.bincount(keys.cpu().numpy(), minlength=vocab)
    present = np.nonzero(want)[0]

    def merged(parts):
        k = np.concatenate([parts[p][0] for p in sorted(parts)])
        v = np.concatenate([parts[p][1] for p in sorted(parts)])
        order = np.argsort(k)
        in_place = all(np.all(parts[p][0] % TEXT8_BLOCKS == p)
                       for p in parts)
        return k[order], v[order], in_place

    dk, dv, d_in_place = merged(dev_parts)
    wk, wv, _ = merged(warm_parts)
    hk, hv, h_in_place = merged(host_parts)
    rec = {
        "phase": "dataset_graph", "arm": "wordcount_text8", "card": card,
        "tokens": n, "vocab": vocab, "distinct_keys": int(present.size),
        "blocks": TEXT8_BLOCKS, "key_dtype": str(keys.dtype),
        "device_plane_s": dev_s, "device_plane_warm_s": warm_s,
        "host_plane_s": host_s, "device_tokens_per_s": n / warm_s,
        "host_tokens_per_s": n / host_s,
        "planes_taken": {"auto": dev_taken, "host": host_taken},
        "peak_device_bytes": _peak(dev),
    }
    rec["gates"] = {
        "device_plane_taken": dev_taken == {"device": 1, "host": 0},
        "device_equals_bincount": np.array_equal(dk, present)
        and np.array_equal(dv, want[present]) and np.array_equal(wk, dk)
        and np.array_equal(wv, dv),
        "host_equals_bincount": np.array_equal(hk, present)
        and np.array_equal(hv, want[present]),
        "key_mod_p_partitions": d_in_place and h_in_place,
        "counts_total_tokens": int(dv.sum()) == n == int(hv.sum()),
    }
    del keys, ones, blocks, ds
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------- (c) pagerank_livejournal
def rmat_edges(dev, scale: int, m: int, n: Optional[int] = None,
               offset: int = 2):
    """``m`` R-MAT edges (Graph500's a, b, c) at ``scale`` on the card as
    int64 ``(src, dst)``, folded into ``n`` vertices (ids mod n) when
    given."""
    a, b, c = RMAT
    gen = _gen(dev, offset)
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    for level in range(scale):
        u = torch.rand(m, generator=gen, device=dev)
        src |= (u >= a + b).long() << level
        dst |= (((u >= a) & (u < a + b)) | (u >= a + b + c)).long() << level
        del u
    if n is not None:
        src %= n
        dst %= n
    return src, dst


def pagerank64(src, dst, n: int, alpha: float, iterations: int):
    """The same power iteration in float64 on the card."""
    outdeg = torch.bincount(src, minlength=n).double()
    dangling = outdeg == 0
    deg_e = torch.clamp(outdeg, min=1)[src]
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=src.device)
    for _ in range(iterations):
        inc = torch.zeros_like(r).index_add_(0, dst, r[src] / deg_e)
        r = (1 - alpha) / n + alpha * (inc + r[dangling].sum() / n)
    return r


def _csr_host(src, dst, n: int):
    """The edges as a host scipy CSR matrix, its rows sorted on the card
    (scipy's own conversion of 69M pairs takes seconds)."""
    import scipy.sparse as sp

    order = torch.argsort(src, stable=True)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    indices = dst[order].int().cpu().numpy()
    return sp.csr_matrix((np.ones(indices.size, np.int8), indices,
                          indptr.cpu().numpy()), shape=(n, n))


def _min_id_labels(labels: np.ndarray) -> np.ndarray:
    """Component labels -> each component's smallest vertex id."""
    uniq, first = np.unique(labels, return_index=True)
    lookup = np.empty(int(uniq.max()) + 1, np.int64)
    lookup[uniq] = first
    return lookup[labels]


def pagerank_arm(dev, card) -> dict:
    from scipy.sparse.csgraph import connected_components as sp_cc

    n, m, scale = LJ_N, LJ_E, LJ_SCALE
    _peak_reset(dev)
    src, dst = rmat_edges(dev, scale, m, n)
    g = Graph(src.int(), dst.int(), n, device=dev)
    del src, dst
    torch.cuda.empty_cache()
    _peak_reset(dev)
    t0 = time.monotonic()
    ranks = pagerank(g, alpha=PR_ALPHA, num_iterations=PR_ITERS)
    _fence(dev)
    pr_s = time.monotonic() - t0
    pr_iters = pregel.last_iterations
    pr_peak = _peak(dev)
    r64 = pagerank64(g.src_index, g.dst_index, n, PR_ALPHA, PR_ITERS)
    l1 = float(torch.sum(torch.abs(ranks.double() - r64)))
    rank_sum = float(ranks.double().sum())
    del r64
    _peak_reset(dev)
    t0 = time.monotonic()
    labels = connected_components(g)
    _fence(dev)
    cc_s = time.monotonic() - t0
    cc_iters = pregel.last_iterations
    cc_peak = _peak(dev)
    got = labels.cpu().numpy()
    t0 = time.monotonic()
    A = _csr_host(g.src_index, g.dst_index, n)
    _, weak = sp_cc(A, directed=True, connection="weak")
    host_s = time.monotonic() - t0
    want = _min_id_labels(weak)
    rec = {
        "phase": "dataset_graph", "arm": "pagerank_livejournal",
        "card": card, "vertices": n, "edges": m, "rmat_scale": scale,
        "rmat_abc": list(RMAT), "fold": "ids mod n",
        "pagerank_s": pr_s, "pagerank_iterations": pr_iters,
        "pagerank_s_per_iteration": pr_s / max(pr_iters, 1),
        "pagerank_edges_per_s": m * pr_iters / pr_s,
        "pagerank_peak_device_bytes": pr_peak,
        "ranks_sum": rank_sum, "ranks_l1_vs_f64": l1,
        "cc_s": cc_s, "cc_iterations": cc_iters,
        "cc_s_per_iteration": cc_s / max(cc_iters, 1),
        "cc_edges_per_s": 2 * m * cc_iters / cc_s,
        "cc_peak_device_bytes": cc_peak,
        "components": int(np.unique(want).size),
        "widened_index_bytes": 2 * m * 8,
        "scipy_host_s": host_s,
    }
    rec["gates"] = {
        "ranks_sum_to_1": abs(rank_sum - 1.0) <= PR_SUM_TOL,
        "ranks_l1_within_tol_of_f64": l1 <= PR_L1_TOL,
        "twenty_iterations": pr_iters == PR_ITERS,
        "components_equal_scipy_weak": np.array_equal(got, want),
    }
    del g, ranks, labels, A
    torch.cuda.empty_cache()
    return rec


# ----------------------------------------------------------- (d) svdpp_ml1m
def svdpp_arm(dev, card) -> dict:
    R, train, test = ml_tools.ml1m_data(dev)
    users, items = torch.nonzero((train + test) > 0, as_tuple=True)
    ratings = R[users, items].contiguous()
    del R, train, test
    torch.cuda.empty_cache()
    _peak_reset(dev)
    t0 = time.monotonic()
    model = svd_plus_plus(users, items, ratings, rank=SVDPP_RANK,
                          num_iterations=SVDPP_ITERS, lr=SVDPP_LR,
                          num_users=ml_tools.ML1M_USERS,
                          num_items=ml_tools.ML1M_ITEMS, seed=SEED,
                          device=dev)
    seconds = time.monotonic() - t0  # the model's host copy fences
    peak = _peak(dev)
    u, i, r = (x.cpu().numpy() for x in (users, items, ratings))
    pred = model.predict(u, i)
    rmse = float(np.sqrt(np.mean((pred - r) ** 2)))
    rmse_mean = float(np.sqrt(np.mean((r.mean() - r) ** 2)))
    with tempfile.TemporaryDirectory() as tmp:
        back = load_model(save_model(model, f"{tmp}/svdpp"), device=dev)
    losses = model.loss_history
    rec = {
        "phase": "dataset_graph", "arm": "svdpp_ml1m", "card": card,
        "users": ml_tools.ML1M_USERS, "items": ml_tools.ML1M_ITEMS,
        "ratings": int(r.size), "rank": SVDPP_RANK, "lr": SVDPP_LR,
        "iterations": SVDPP_ITERS, "seconds": seconds,
        "iterations_per_s": SVDPP_ITERS / seconds,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "train_rmse": rmse, "global_mean_rmse": rmse_mean,
        "peak_device_bytes": peak,
    }
    rec["gates"] = {
        "loss_falls": bool(np.isfinite(losses).all())
        and float(losses[-1]) < float(losses[0]),
        "rmse_below_global_mean": rmse < rmse_mean,
        "saved_model_predicts_bit_equal": type(back).__name__
        == "SVDPlusPlusModel" and np.array_equal(back.predict(u, i), pred),
    }
    del users, items, ratings
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------ (e) dense_graph_16k
def label_propagation_host(src, dst, n: int, steps_: int) -> np.ndarray:
    """``steps_`` synchronous label-propagation steps in numpy: each vertex
    takes its neighbours' most frequent label, ties to the smallest."""
    s2 = np.concatenate([src, dst]).astype(np.int64)
    d2 = np.concatenate([dst, src]).astype(np.int64)
    labels = np.arange(n, dtype=np.int64)
    for _ in range(steps_):
        uk, cnt = np.unique(d2 * n + labels[s2], return_counts=True)
        v, lab = uk // n, uk % n
        order = np.lexsort((lab, -cnt, v))
        v, lab = v[order], lab[order]
        first = np.ones(v.size, bool)
        first[1:] = v[1:] != v[:-1]
        labels = labels.copy()
        labels[v[first]] = lab[first]
    return labels


def dense_arm(dev, card) -> dict:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_cc

    scale = DENSE_SCALE
    n = 1 << scale
    m = DENSE_EDGE_FACTOR * n
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        src, dst = rmat_edges(dev, scale, m, offset=3)
        g = Graph(src.int(), dst.int(), n, device=dev)
        del src, dst
        _peak_reset(dev)
        secs = {}
        t0 = time.monotonic()
        tri = triangle_count(g)
        _fence(dev)
        secs["triangle_count_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        lp = label_propagation(g, max_iterations=LP_STEPS)
        _fence(dev)
        secs["label_propagation_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        scc = strongly_connected_components(g)
        _fence(dev)
        secs["scc_s"] = time.monotonic() - t0
        peak = _peak(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    s_h, d_h = g.src.cpu().numpy(), g.dst.cpu().numpy()
    t0 = time.monotonic()
    keep = s_h != d_h
    A = sp.csr_matrix((np.ones(int(keep.sum()), np.float64),
                       (s_h[keep], d_h[keep])), shape=(n, n))
    U = ((A + A.T) > 0).astype(np.float64)
    tri_host = np.asarray((U @ U).multiply(U).sum(axis=1)).ravel() / 2
    _, strong = sp_cc(A, directed=True, connection="strong")
    lp_host = label_propagation_host(s_h, d_h, n, LP_STEPS)
    host_s = time.monotonic() - t0
    # the dense products' work: one n^3 product, then ceil(log2 n) of them
    squarings = int(math.ceil(math.log2(n)))
    rec = {
        "phase": "dataset_graph", "arm": "dense_graph_16k", "card": card,
        "vertices": n, "edges": m, "rmat_scale": scale,
        "edge_factor": DENSE_EDGE_FACTOR, **secs,
        "triangle_tflop_per_s": 2 * n ** 3 / secs["triangle_count_s"] / 1e12,
        "scc_squarings": squarings,
        "scc_tflop_per_s": 2 * n ** 3 * squarings / secs["scc_s"] / 1e12,
        "triangles": int(tri.to(torch.int64).sum()) // 3,
        "strong_components": int(np.unique(strong).size),
        "lp_labels": int(torch.unique(lp).numel()),
        "allow_tf32": False, "peak_device_bytes": peak,
        "host_check_s": host_s,
    }
    rec["gates"] = {
        "triangles_equal_scipy": np.array_equal(tri.cpu().numpy(),
                                                tri_host.astype(np.int64)),
        "scc_equal_scipy_strong": np.array_equal(scc.cpu().numpy(),
                                                 _min_id_labels(strong)),
        "label_propagation_equal_numpy": np.array_equal(lp.cpu().numpy(),
                                                        lp_host),
    }
    del g, tri, lp, scc
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------------ phase
def phase(dev, card: str, arms=ARMS, emit=print,
          run_updates_per_s: Optional[float] = None) -> Dict[str, object]:
    """Run ``arms`` on ``dev``, one JSON line an arm; raises if a gate
    failed.  Returns ``{"records": [...], "launches": {"masked_grad": B1
    launches of arm (a)}}``."""
    recs: List[dict] = []
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/dataset_graph.akv"
        # the records go through the native store, and are read back by
        # the Python backend (the two speak one file format)
        with KVStore(path, backend="native") as kv:

            def done(rec):
                rec["ok"] = all(rec["gates"].values())
                emit(json.dumps(rec))
                recs.append(rec)
                kv.put_obj(rec["arm"], rec)

            if "async_reduce" in arms:
                done(async_reduce_arm(dev, card, run_updates_per_s))
            if "wordcount" in arms:
                done(wordcount_arm(dev, card))
            if "pagerank" in arms:
                done(pagerank_arm(dev, card))
            if "svdpp" in arms:
                done(svdpp_arm(dev, card))
            if "dense" in arms:
                done(dense_arm(dev, card))
        with KVStore(path, backend="python") as back:
            store = {
                "phase": "dataset_graph_store", "card": card,
                "backend": "native", "records": len(back),
                "bytes": os.path.getsize(path),
                "read_back_equal": all(
                    back.get_obj(r["arm"]) == json.loads(json.dumps(r))
                    for r in recs) and len(back) == len(recs),
            }
    emit(json.dumps(store))
    failed = [(r["arm"], k) for r in recs for k, v in r["gates"].items()
              if not v]
    if not store["read_back_equal"]:
        failed.append(("store", "read_back_equal"))
    if failed:
        raise RuntimeError(f"dataset_graph gates failed: {failed}")
    return {"records": recs, "launches": {"masked_grad": sum(
        r["b1_launches"] for r in recs
        if r["arm"] == "async_reduce_epsilon")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default=",".join(ARMS),
                    help=f"comma-separated subset of {','.join(ARMS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools.dataset_graph: no CUDA device")
    import subprocess

    from asyncframework_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    out = phase(dev, card, args.arms.split(","))
    print(json.dumps({"phase": "dataset_graph_total",
                      "seconds": time.monotonic() - t0,
                      "launches": out["launches"]}), flush=True)


if __name__ == "__main__":
    main()

"""The rcv1 deployment on one GPU: its data, its solver recipes and gates.

The JAX package's benchmark runs rcv1 at its published shape
(``bench.py:105-113``, built by ``bench.py:370-384``): 697,641 x 47,236
padded-ELL f32, 75 nonzeros a row (K = 80), generated on the device
(seed 7, noise 0.01), 8 workers, ASGD at gamma 2,361.8, b = 0.05, 1,200
updates, ``taw`` 2^31-1, bucket ratio 0.7, a snapshot every 50 updates.
Here ASGD's updater drains up to :data:`DRAIN_BATCH` queued results a wake
into one apply (``SolverConfig.drain_batch``; exact up to the order of
float additions), as the reference's updater drains its whole queue a wake
(``SparkASGDThread.scala:154-158``): taking one result a wake, the port's
updater falls behind the workers on the H100 and applies results hundreds
of updates stale (ROADMAP C4).
The real ``rcv1_full.binary`` loads through ``data/libsvm.py``
(``load_libsvm_sparse``) into ``SparseShardedDataset`` once the file is
present; until then the recipe runs on its shape.

:func:`phase` runs ASGD ``run()`` and ``run_sync()`` and ASAGA ``run()``
and ``run_sync()`` on one dataset and holds each to its gate, the JAX
package's own (``tests/test_sparse.py``): ASGD ``run()`` reaches a best
objective below 0.1x and ends below 0.3x the objective at w = 0
(``:214-219``); ``run_sync()`` and ASAGA end below it (``:143-157``); ASAGA
keeps ``alpha_bar`` the history table's mean (``tests/test_fused.py:166``).
:func:`fused_phase` does the same for ``run_fused()`` of both solvers.
Each run counts kernel S1's launches (set to 0 just before it, read just
after; ``tools/runs.py``) and the calls of S1's plain versions.
``chip_smoke.py``'s sparse phase and ``tools/asgd_gate.py --config rcv1``
run them.
"""

from __future__ import annotations

import numpy as np
import torch

from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig
from asyncframework_tpu_torch.tools.runs import run_one

N, D, NNZ, WORKERS = 697_641, 47_236, 75, 8
SEED, NOISE = 7, 0.01
BATCH_RATE, PRINTER_FREQ = 0.05, 50
ASGD_GAMMA, ASGD_UPDATES, ASGD_ROUNDS = 2361.8, 1_200, 300
DRAIN_BATCH = 16
# ASAGA's step size, chosen on the card (tools/asgd_gate.py --config rcv1
# --saga-gamma; PERF.md, rcv1): the JAX package's benchmark runs ASGD only
SAGA_GAMMA, SAGA_UPDATES, SAGA_ROUNDS = 50.0, 1_200, 300
# alpha_bar advances in f32 by one delta / N an accepted update; the
# table's mean is summed once (the dense phase's band, chip_smoke.py)
INVARIANT_TOL = "1e-3 * |mean| + 1e-3 * max|mean|"
# run_fused: the JAX package's own band for its fused sparse ASAGA
FUSED_INVARIANT = (5e-3, 5e-5, "5e-3 * |mean| + 5e-5")


def dataset(device, n: int = N, d: int = D) -> SparseShardedDataset:
    """rcv1's shape generated on ``device`` (``bench.py``'s seed and
    noise)."""
    return SparseShardedDataset.generate_on_device(
        n, d, NNZ, WORKERS, devices=[device], seed=SEED, noise=NOISE)


def config(iterations: int, gamma: float,
           drain_batch: int = DRAIN_BATCH) -> SolverConfig:
    """``bench.py``'s rcv1 solver settings (ASAGA has no drain batching
    and ignores ``drain_batch``)."""
    return SolverConfig(num_workers=WORKERS, num_iterations=iterations,
                        gamma=gamma, taw=2**31 - 1, batch_rate=BATCH_RATE,
                        bucket_ratio=0.7, printer_freq=PRINTER_FREQ,
                        coeff=0.0, seed=42, calibration_iters=100,
                        drain_batch=drain_batch)


def describe(ds: SparseShardedDataset) -> dict:
    """The dataset's bytes on its devices, pad width and skew report."""
    from asyncframework_tpu_torch.utils.hbm import dataset_residency_bytes

    return {
        "n": ds.n, "d": ds.d, "workers": ds.num_workers,
        "K": int(ds.shard(0).cols.shape[1]),
        "bytes": sum(dataset_residency_bytes(ds).values()),
        "padded_nnz": ds.padded_nnz(), "skew_report": ds.skew_report(),
    }


def table_mean(ds: SparseShardedDataset, alpha) -> np.ndarray:
    """``(1/N) sum_i x_i alpha_i`` over every shard, as one launch of
    kernel S1's coefficient form over the shards' rows taken together (f32
    products, each column added in row order, in chunks of
    ``sparse_grad.CHUNK`` where it is longer)."""
    dev = ds.shard(0).device
    cols = torch.cat([ds.shard(w).cols.to(dev) for w in range(ds.num_workers)])
    vals = torch.cat([ds.shard(w).vals.to(dev) for w in range(ds.num_workers)])
    a = torch.cat([torch.as_tensor(alpha[w], device=dev)
                   for w in range(ds.num_workers)])
    g = sg.grad_sum(cols, vals, a, ds.d)
    return g.cpu().numpy().astype(np.float64) / ds.n


def _gates(rec, res, ds, solver_cls) -> dict:
    first, final = rec["objective_at_w0"], rec["final_objective"]
    mode = rec["mode"]
    budget_met = (res.rounds if mode == "run_sync"
                  else res.accepted) == rec["budget"]
    launches, on_path = rec["launches"], rec["launches_on_path"]
    # a task is one fused S1 launch (on the fused path, captured once a
    # round and replayed); ASAGA's accepted async results add one launch
    # of its coefficient form each (the table delta); the evaluation runs
    # the residual alone; no launch of the earlier chain's segment sum, no
    # plain version
    commits = res.accepted if solver_cls is ASAGA and mode == "run" else 0
    gates = {
        "budget": budget_met, "finite": rec["finite"],
        "through_s1": on_path["compacted_grad"] >= rec["tasks_run"] > 0
        and launches["grad_sum"] >= commits
        and launches["ell_residual"] > 0
        and launches["segment_sum"] == 0
        and launches["compacted_grad_plain"] == 0
        and launches["grad_sum_plain"] == 0
        and launches["ell_residual_plain"] == 0
        and launches["segment_sum_plain"] == 0
        and launches["masked_grad"] == 0,
    }
    if solver_cls is ASGD and mode in ("run", "run_fused"):
        gates["best_below_0.1x"] = rec["best_objective"] < 0.1 * first
        gates["final_below_0.3x"] = final < 0.3 * first
    else:
        gates["final_below_first"] = final < first
    if solver_cls is ASAGA:
        expected = table_mean(ds, res.extras["alpha"])
        ab = res.extras["alpha_bar"].astype(np.float64)
        err = np.abs(ab - expected)
        rtol, atol, tol = FUSED_INVARIANT if mode == "run_fused" else (
            1e-3, 1e-3 * np.abs(expected).max(), INVARIANT_TOL)
        rec["alpha_bar_max_abs_err"] = float(err.max())
        rec["alpha_bar_max"] = float(np.abs(expected).max())
        rec["invariant_tol"] = tol
        gates["alpha_bar_is_table_mean"] = bool(
            np.all(err <= rtol * np.abs(expected) + atol))
    return gates


def _gated(runs, ds, device, drain_batch: int = DRAIN_BATCH):
    records = []
    for solver_cls, mode, iters, gamma in runs:
        res, rec = run_one(solver_cls, mode, ds,
                           config(iters, gamma, drain_batch), device)
        rec["gates"] = _gates(rec, res, ds, solver_cls)
        rec["ok"] = all(rec["gates"].values())
        records.append(rec)
    return records


def phase(ds, device, saga_gamma: float = SAGA_GAMMA,
          drain_batch: int = DRAIN_BATCH):
    """ASGD and ASAGA, ``run()`` and ``run_sync()``, on ``ds`` with the
    rcv1 recipes; one record a run, each with its ``gates`` (name ->
    passed) and ``ok``."""
    return _gated([
        (ASGD, "run", ASGD_UPDATES, ASGD_GAMMA),
        (ASGD, "run_sync", ASGD_ROUNDS, ASGD_GAMMA),
        (ASAGA, "run", SAGA_UPDATES, saga_gamma),
        (ASAGA, "run_sync", SAGA_ROUNDS, saga_gamma),
    ], ds, device, drain_batch)


def fused_phase(ds, device, saga_gamma: float = SAGA_GAMMA):
    """ASGD and ASAGA ``run_fused()`` on ``ds`` with the same recipes (the
    JAX package's ``fused`` arm runs ASGD's), gated as above: ASGD's best
    below 0.1x and final below 0.3x, ASAGA's final below the objective at
    w = 0 and ``alpha_bar`` the table's mean within the JAX package's
    fused tolerance (``tests/test_fused.py:180``)."""
    return _gated([
        (ASGD, "run_fused", ASGD_UPDATES, ASGD_GAMMA),
        (ASAGA, "run_fused", SAGA_UPDATES, saga_gamma),
    ], ds, device)

"""Common solver configuration and result types.

Counterpart of the part of ``asyncframework_tpu/solvers/base.py`` that
``solvers/asgd.py`` and ``solvers/asaga.py`` use, plus the helpers the two
share around their loops (:class:`ShardedSolverMixin`).  ``SolverConfig``
carries the reference drivers' algorithmic knobs
(``SparkASGDThread.scala:28-48``) under their long names, plus the
engine's own settings.  The switches of subsystems not ported yet
(checkpointing, speculation, dynamic allocation, the metrics sinks) keep
their names and defaults and raise ``NotImplementedError`` when turned on.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
from asyncframework_tpu_torch.ops.sampling import worker_generator
from asyncframework_tpu_torch.solvers.instrumentation import FaultTolerantRun
from asyncframework_tpu_torch.utils.hbm import plan_for_run, shard_tensors


class DeadWorkerError(RuntimeError):
    """A synchronous drain can never complete: a cohort worker's executor
    is dead and nothing will replace it.  Carries the per-worker liveness
    diagnostic (who is dead, last-heartbeat ages, who already reported)."""


def dead_worker_diagnostic(pool, dead: Dict[int, float],
                           collected: Optional[set] = None) -> str:
    """Per-worker liveness table for the fail-fast abort message."""
    collected = collected or set()
    lines = [
        "synchronous drain cannot complete: "
        f"executor(s) {sorted(dead)} dead with no replacement"
    ]
    for wid, ex in sorted(pool.executors.items()):
        age = ex._clock.now_ms() - ex.last_heartbeat_ms
        lines.append(
            f"  wid {wid:3d}: {'DEAD' if not ex.alive else 'alive':5s} "
            f"last-heartbeat {age:8.0f}ms ago  busy={ex.busy!s:5s} "
            f"reported={'yes' if wid in collected else 'no'}"
        )
    return "\n".join(lines)


def collect_checked(ctx, waiter, timeout_s: float, pool=None,
                    cohort=None, dead_grace_s: float = 1.0,
                    collected: Optional[set] = None):
    """Blocking collect that surfaces a job abort instead of hanging --
    and, given the executor ``pool``, fails fast with a per-worker liveness
    diagnostic when a cohort executor dies and stays dead past
    ``dead_grace_s`` (nobody will ever deliver its result), instead of
    sitting out the full ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    dead_since: Dict[int, float] = {}
    while True:
        if waiter.failed is not None:
            raise RuntimeError("job aborted during drain") from waiter.failed
        try:
            return ctx.collect_all(timeout=0.1)
        except queue.Empty:
            now = time.monotonic()
            if pool is not None and not pool.closed:
                watch = cohort if cohort is not None else list(pool.executors)
                for wid in watch:
                    ex = pool.executors.get(wid)
                    if (ex is not None and not ex.alive
                            and not ex.shutdown_requested):
                        first = dead_since.setdefault(wid, now)
                        if now - first > dead_grace_s:
                            raise DeadWorkerError(dead_worker_diagnostic(
                                pool, dead_since, collected
                            ))
                    else:
                        # replaced (heartbeat path) or healthy again
                        dead_since.pop(wid, None)
            if now > deadline:
                raise TimeoutError("sync drain timed out")


def check_hbm_plan(X, cfg: "SolverConfig", devices,
                   history_table: bool = False) -> None:
    """Consult the device-memory planner before committing to a run: host
    arrays are planned from shape before placement; a pre-built dataset has
    its actual residency measured.  Raises ``MemoryError`` with the
    planner's accounting when the budget is oversubscribed."""
    if not isinstance(X, (np.ndarray, ShardedDataset, SparseShardedDataset)):
        return  # resolve_dataset refuses it
    versions = (
        cfg.max_live_versions if cfg.stale_read_offset is not None else 2
    )
    target = (X.shape[0], X.shape[1]) if isinstance(X, np.ndarray) else X
    plan_for_run(
        target,
        cfg.num_workers,
        max(len(set(devices)), 1),
        devices[0],
        model_versions=versions,
        budget_bytes=cfg.hbm_budget_bytes,
        history_table=history_table,
    ).require_fits()


def resolve_dataset(X, y, num_workers: int, devices):
    """Accept host arrays (sharded here) or a pre-built dataset
    (:class:`ShardedDataset` or :class:`SparseShardedDataset`); validate
    consistency with the solver's setup."""
    if isinstance(X, (ShardedDataset, SparseShardedDataset)):
        if y is not None:
            raise ValueError(
                "y must be None when passing a pre-built dataset "
                "(its labels are already resident on device)"
            )
        if X.num_workers != num_workers:
            raise ValueError(
                f"dataset is sharded for {X.num_workers} workers but the "
                f"solver is configured for {num_workers}"
            )
        for wid in range(num_workers):
            expect = devices[wid % len(devices)]
            actual = X.shard(wid).device
            if actual != expect:
                raise ValueError(
                    f"shard {wid} lives on {actual} but the solver will "
                    f"dispatch worker {wid} to {expect}; rebuild the dataset "
                    f"with the solver's device list"
                )
        return X
    if not isinstance(X, np.ndarray):
        raise NotImplementedError(
            f"{type(X).__name__} is not taken as it is: pass a dense host "
            "array or a pre-built dataset; sparse data goes in as a "
            "SparseShardedDataset built from its CSR arrays (ROADMAP A4)"
        )
    return ShardedDataset(X, y, num_workers, devices)


class FlopsAccountingMixin:
    """Counted-flops accounting for the solvers (``utils/flops.py`` model).

    Hosts provide ``self._recovery`` (shard view), ``self.cfg`` and
    ``self.ds``; a dense step that compacts sampled rows sets
    ``_dense_compact`` so only the compacted rows count.  The sparse step
    always compacts (``utils/flops.sparse_task_flops`` of the compacted
    rows and the shard's pad width)."""

    def _task_flops(self, wid: int) -> float:
        cache = self.__dict__.setdefault("_flops_cache", {})
        cached = cache.get(wid)
        if cached is None:
            from asyncframework_tpu_torch.ops.steps import sparse_step_capacity
            from asyncframework_tpu_torch.utils import flops as _fl

            shard = self._recovery.shard(wid)
            rows = shard.size
            sparse = hasattr(shard, "cols")
            if sparse or getattr(self, "_dense_compact", False):
                rows = sparse_step_capacity(self.cfg.batch_rate, rows)
            cached = (
                _fl.sparse_task_flops(rows, shard.cols.shape[1]) if sparse
                else _fl.dense_task_flops(rows, self.ds.d)
            )
            cache[wid] = cached
        return cached


class ShardedSolverMixin(FlopsAccountingMixin):
    """What ASGD and ASAGA share around their loops: worker placement, mask
    generators, fault tolerance, the fail-fast drain and the trajectory
    evaluation.  Hosts provide ``cfg``, ``ds``, ``devices``, ``_recovery``
    (shard view) and ``_eval`` (per-shard loss of stacked snapshots)."""

    def _shard_device(self, wid: int):
        return self.devices[wid % len(self.devices)]

    def _generators(self):
        """Per-worker mask generators on each shard's device, and a lock
        per worker so two tasks of one worker never draw concurrently."""
        gens = {
            wid: worker_generator(self.cfg.seed, wid, self._shard_device(wid))
            for wid in range(self.cfg.num_workers)
        }
        return gens, {wid: threading.Lock() for wid in gens}

    def _fault_tolerance(self, sched, inst, on_moved=None):
        """Heartbeat + executor replacement + shard re-homing for one run
        (None with ``heartbeat`` off); ``on_moved(shard_id, shard)`` lets
        per-worker state follow a re-homed shard."""
        cfg = self.cfg
        if not cfg.heartbeat:
            return None
        ft = FaultTolerantRun(
            sched, self._recovery, inst, cfg.num_workers,
            heartbeat_timeout_ms=cfg.heartbeat_timeout_ms,
            check_interval_s=cfg.heartbeat_interval_s,
            max_slot_failures=cfg.max_slot_failures,
            on_moved=on_moved,
        )
        ft.start()
        return ft

    def _collect_checked(self, ctx, waiter, timeout_s: float, pool=None,
                         cohort=None, collected=None):
        """Shared fail-fast drain: surfaces job aborts, and -- given the
        pool -- aborts promptly with the per-worker liveness diagnostic
        when a cohort executor dies unreplaced."""
        grace = (
            4.0 * self.cfg.heartbeat_interval_s + 2.0
            if self.cfg.heartbeat else 0.5
        )
        return collect_checked(
            ctx, waiter, timeout_s, pool=pool, cohort=cohort,
            dead_grace_s=grace, collected=collected,
        )

    def _evaluate_trajectory(self, snapshots) -> List[Tuple[float, float]]:
        """One-pass objective evaluation for all snapshots (optVars parity):
        snapshots stacked into (S, d); per shard one pass gives (S,)
        losses, summed on the host in f64."""
        W = torch.stack([h for (_t, h) in snapshots])
        totals = np.zeros(len(snapshots), np.float64)
        for wid in range(self.cfg.num_workers):
            shard = self._recovery.shard(wid)  # follows re-homed shards
            part = self._eval(*shard_tensors(shard), W.to(shard.device))
            totals += part.cpu().numpy().astype(np.float64)
        totals /= self.ds.n
        return [(t, float(l)) for (t, _), l in zip(snapshots, totals)]


@dataclass
class SolverConfig:
    num_workers: int = 8          # [num partitions]
    num_iterations: int = 1000    # [num iterations] (accepted updates / rounds)
    gamma: float = 0.1            # [step size]
    taw: int = 2**31 - 1          # [taw] staleness bound
    batch_rate: float = 0.1       # [batch rate] Bernoulli b
    bucket_ratio: float = 0.5     # [bucket ratio] cohort threshold
    printer_freq: int = 100       # [printer freq] trajectory snapshot period
    coeff: float = 0.0            # [coeff] delay intensity; -1 = cloud mode
    seed: int = 42                # [seed]
    loss: str = "least_squares"
    calibration_iters: Optional[int] = None  # default 100 * num_workers
    collect_timeout_s: float = 0.05
    run_timeout_s: float = 600.0
    # updater drain batching: with drain_batch >= BATCH_DRAIN_MIN a drained
    # batch folds into one masked weighted sum (exact up to addition order)
    drain_batch: int = 1
    # features not ported yet: each raises NotImplementedError when set
    # (ROADMAP queue A); their tuning knobs come with them
    checkpoint_dir: Optional[str] = None
    ui_port: Optional[int] = None
    event_log: Optional[str] = None
    metrics_csv: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    trace_sample: Optional[float] = None
    speculation: bool = False
    dynamic_allocation: bool = False
    # failure detection / elastic recovery (HeartbeatReceiver parity)
    heartbeat: bool = True
    heartbeat_timeout_ms: float = 2000.0
    heartbeat_interval_s: float = 0.25
    max_slot_failures: int = 2
    # stale-read experiment (ASYNCbroadcast.value(index) parity): workers
    # read model version (latest - offset) from a VersionedModelStore
    stale_read_offset: Optional[int] = None
    max_live_versions: int = 4
    # device-memory budget consulted before placement; None = the device's
    hbm_budget_bytes: Optional[int] = None

    def effective_calibration_iters(self) -> int:
        if self.calibration_iters is not None:
            return self.calibration_iters
        return 100 * self.num_workers

    @property
    def bucket_threshold(self) -> int:
        return math.floor(self.num_workers * self.bucket_ratio)


@dataclass
class TrainResult:
    """What a driver run produces (the reference prints these; we return them).

    ``trajectory`` is the optVars analog evaluated post-hoc in one pass:
    ``(wall_ms_since_start, objective)`` where objective is the mean loss over
    the full dataset.
    """

    final_w: np.ndarray
    trajectory: List[Tuple[float, float]]
    elapsed_s: float
    accepted: int = 0
    dropped: int = 0
    rounds: int = 0
    max_staleness: int = 0
    avg_delay_ms: float = 0.0
    updates_per_sec: float = 0.0
    # counted worker-gradient flops (utils/flops.py model; excludes the
    # post-hoc trajectory evaluation) -- the MFU numerator
    total_flops: float = 0.0
    waiting_time_ms: Dict[int, float] = field(default_factory=dict)
    extras: Dict[str, object] = field(default_factory=dict)

    @property
    def final_objective(self) -> float:
        return self.trajectory[-1][1] if self.trajectory else float("nan")


class WaitingTimeTable:
    """Per-worker idle-gap bookkeeping.

    Parity: ``WaitingTime`` / ``SubmitJobTime`` / ``FinishTimeTable``
    (``SparkASGDThread.scala:112-115,328-335``): at submit, a worker's waiting
    time grows by (submit wall time - its last finish wall time).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.submit_ms: Dict[int, float] = {}
        self.finish_ms: Dict[int, float] = {}
        self.waiting_ms: Dict[int, float] = {}

    def on_submit(self, worker_ids, now_ms: float) -> None:
        with self._lock:
            for wid in worker_ids:
                gap = now_ms - self.finish_ms.get(wid, now_ms)
                self.waiting_ms[wid] = self.waiting_ms.get(wid, 0.0) + gap
                self.submit_ms[wid] = now_ms

    def on_finish(self, worker_id: int, now_ms: float) -> float:
        """Record finish; returns (finish - submit) for delay calibration."""
        with self._lock:
            dt = now_ms - self.submit_ms.get(worker_id, now_ms)
            self.finish_ms[worker_id] = now_ms
            return dt

    def snapshot(self) -> Dict[int, float]:
        with self._lock:
            return dict(self.waiting_ms)


class DelayCalibrator:
    """Average-delay measurement over the warm-up phase.

    Parity: ``culTime``/``culCount`` accumulation while ``k < 100*numPart``
    and the one-shot ``avgDelay = culTime/culCount``
    (``SparkASGDThread.scala:174-183,244-249``).
    """

    def __init__(self, calibration_iters: int):
        self._iters = calibration_iters
        self._cul_time = 0.0
        self._cul_count = 0
        self._lock = threading.Lock()
        self.avg_delay_ms = 0.0
        self.calibrated = False

    def record(self, k: int, task_ms: float) -> None:
        with self._lock:
            if k < self._iters:
                self._cul_time += task_ms
                self._cul_count += 1

    def maybe_finalize(self, k: int) -> bool:
        """Returns True the single time calibration completes."""
        with self._lock:
            if not self.calibrated and k > self._iters and self._cul_count > 0:
                self.avg_delay_ms = self._cul_time / self._cul_count
                self.calibrated = True
                return True
            return False


def check_ported(cfg: SolverConfig) -> None:
    """Raise ``NotImplementedError`` for a switched-on feature whose
    subsystem the port does not have yet, naming the ROADMAP item."""
    waiting = {
        "checkpoint_dir": ("checkpointing", cfg.checkpoint_dir is not None),
        "speculation": ("speculation and allocation", cfg.speculation),
        "dynamic_allocation": (
            "speculation and allocation", cfg.dynamic_allocation
        ),
    }
    for name, (item, on) in waiting.items():
        if on:
            raise NotImplementedError(
                f"SolverConfig.{name} is not ported yet (ROADMAP.md queue A: "
                f"{item})"
            )

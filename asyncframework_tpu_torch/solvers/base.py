"""Common solver configuration and result types.

Counterpart of the part of ``asyncframework_tpu/solvers/base.py`` that
``solvers/asgd.py`` and ``solvers/asaga.py`` use, plus the helpers the two
share around their loops (:class:`ShardedSolverMixin`) and the fused
loop's chunks of rounds (:class:`RoundChunk`, :func:`run_fused_plan`: a
CUDA graph a chunk on the card, eager rounds on the CPU).  ``SolverConfig``
carries the reference drivers' algorithmic knobs
(``SparkASGDThread.scala:28-48``) under their long names, plus the
engine's own settings, with the reference's defaults.  The checkpoint
plumbing (:class:`SolverCheckpointer`, :func:`validate_resume`) and
:func:`make_allocation_manager` are the reference's.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.checkpoint import CheckpointManager
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
from asyncframework_tpu_torch.ops.sampling import worker_generator
from asyncframework_tpu_torch.solvers.instrumentation import FaultTolerantRun
from asyncframework_tpu_torch.utils.devices import device_scope, fence
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
        # the JAX package takes the same two kinds of input: it hands any
        # other X to ShardedDataset, whose device placement accepts only
        # arrays
        raise TypeError(
            f"X must be a dense host array (numpy) or a pre-built dataset, "
            f"not {type(X).__name__}: sparse data goes in as a "
            "SparseShardedDataset built from its CSR arrays "
            "(data/sparse.py)"
        )
    return ShardedDataset(X, y, num_workers, devices)


#: rounds a chunk of the fused loop holds (one CUDA graph on the card)
CHUNK_ROUNDS = 16


class FusedRounds(NamedTuple):
    """One round of a fused solver and the state it runs on."""

    #: ``round_fn(*carry) -> carry'``: new tensors; never writes its input
    round_fn: Callable
    #: the state buffers, model first: ``(w, k)`` or ``(w, alpha_bar,
    #: *alphas)``; a chunk reads them at its start and writes them at its end
    carry: Tuple[torch.Tensor, ...]
    #: each worker's mask generator, in worker order
    generators: Tuple[torch.Generator, ...]


class RoundChunk:
    """``rounds`` rounds of ``fused.round_fn`` from the state buffers back
    into them, each round's model copied into a row of ``snap``.  Run
    eagerly, or, once :meth:`capture` has run, as one replay of a CUDA graph
    (the graph's buffers are its static inputs and outputs: a replay
    overwrites ``snap``, so a caller keeps copies of the rows it needs
    before the next one)."""

    def __init__(self, fused: FusedRounds, rounds: int):
        self.fused = fused
        self.rounds = rounds
        w = fused.carry[0]
        self.snap = torch.empty((rounds, w.shape[0]), dtype=w.dtype,
                                device=w.device)
        self.graph = None

    def run_eager(self) -> None:
        carry = self.fused.carry
        for j in range(self.rounds):
            carry = self.fused.round_fn(*carry)
            self.snap[j].copy_(carry[0])
        for buf, new in zip(self.fused.carry, carry):
            buf.copy_(new)

    def capture(self, stream) -> None:
        """Capture :meth:`run_eager` as a CUDA graph on ``stream``, with
        every worker generator registered, so each replay draws the next
        numbers of each stream.  Raises where the capture fails."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.fused.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=stream):
            self.run_eager()
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.run_eager()
        else:
            self.graph.replay()


def capture_chunks(fused: FusedRounds, chunks) -> None:
    """Capture each of ``chunks`` as a CUDA graph on one dedicated stream.

    Each first runs once eagerly on that stream: that builds the kernels,
    makes the wrappers' per-stream scratch (B1's chunk counter, S1's zeroed
    workspace, which the graphs then keep) and fills the allocator.  The
    state buffers and the generators are then put back as they were before,
    so the first replay starts where an eager run from the same state
    would.  Replays of these graphs share that scratch: they must run one
    at a time, on one stream.  Fenced before it returns; a capture that
    fails raises (no eager fallback)."""
    dev = fused.carry[0].device
    saved = [t.clone() for t in fused.carry]
    states = [gen.get_state() for gen in fused.generators]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for chunk in chunks:
            chunk.run_eager()
        for buf, old in zip(fused.carry, saved):
            buf.copy_(old)
    for chunk in chunks:
        chunk.capture(stream)
    for gen, state in zip(fused.generators, states):
        gen.set_state(state)
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize(dev)


def fused_chunks(fused: FusedRounds, total_rounds: int) -> List[RoundChunk]:
    """The chunks that run ``total_rounds`` rounds, in order: chunks of
    ``min(CHUNK_ROUNDS, total_rounds)`` rounds and a remainder.  On a CUDA
    device the full chunk and the remainder are each captured once
    (:func:`capture_chunks`) and every entry is a replay; on the CPU they
    run eagerly."""
    chunk = min(CHUNK_ROUNDS, total_rounds)
    full, rem = divmod(total_rounds, chunk)
    runner = RoundChunk(fused, chunk)
    tail = RoundChunk(fused, rem) if rem else None
    if fused.carry[0].device.type == "cuda":
        with device_scope(fused.carry[0].device):
            capture_chunks(fused, [runner] + ([tail] if tail else []))
    return [runner] * full + ([tail] if tail else [])


def run_fused_plan(fused: FusedRounds, total_rounds: int, nw: int,
                   printer_freq: int):
    """The chunk, warm-up, snapshot and timing machinery of ASGD.run_fused
    and ASAGA.run_fused (``solvers/base.py:141-179`` of the JAX package):
    :func:`fused_chunks` (both chunks captured, warmed and fenced before
    the clock starts), then :func:`replay_chunks`."""
    return replay_chunks(fused_chunks(fused, total_rounds), nw, printer_freq)


def replay_chunks(plan: List[RoundChunk], nw: int, printer_freq: int):
    """Run ``plan`` on the clock: one snapshot every ``max(1, printer_freq
    // nw)`` rounds of a chunk, copied out of its ``snap`` on the device (no
    sync) before the next replay.  Timestamps are taken at dispatch; the
    caller fences before it takes elapsed.  Returns ``(snapshots,
    start_wall, done_rounds, replays)``, ``replays`` 0 where the rounds ran
    eagerly (CPU)."""
    w = plan[0].fused.carry[0]
    snap_every = max(1, printer_freq // nw)
    with device_scope(w.device):
        start_wall = time.monotonic()
        snapshots: List[Tuple[float, torch.Tensor]] = [(0.0, w.clone())]
        for chunk in plan:
            chunk()
            t_ms = (time.monotonic() - start_wall) * 1e3
            for j in range(0, chunk.rounds, snap_every):
                snapshots.append((t_ms, chunk.snap[j].clone()))
    replays = len(plan) if plan[0].graph is not None else 0
    return snapshots, start_wall, sum(c.rounds for c in plan), replays


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
    generators, fault tolerance, the fail-fast drain, the fused loop's
    inputs and result, and the trajectory evaluation.  Hosts provide
    ``cfg``, ``ds``, ``devices``, ``driver_device``, ``_recovery`` (shard
    view), ``_eval`` (per-shard loss of stacked snapshots) and
    ``fused_rounds()``."""

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

    @staticmethod
    def _one_draw(step, gen, gen_lock, size: int):
        """A task's sample, drawn once.  The first body to run draws it
        under the worker's lock and keeps the tensors; any later body (a
        retry, a speculative copy, an allocation sibling) reuses them, so
        every body computes the same gradient and the generator advances
        exactly once a task -- as in the JAX package, whose task takes its
        key at submit."""
        kept = []
        lock = threading.Lock()

        def draw():
            with lock:
                if not kept:
                    with gen_lock:
                        kept.append(step.sample(gen, size))
                return kept[0]

        return draw

    @staticmethod
    def _checkpoint_extras(ckpt, k0: int, save_ms: List[float]):
        """``resumed_from`` and the saves' count and host time (ms), where
        checkpointing is on."""
        if not ckpt.enabled:
            return {}
        return {"resumed_from": k0, "checkpoint_saves": len(save_ms),
                "checkpoint_save_ms": float(sum(save_ms))}

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

    def _fused_inputs(self):
        """``(shards, generators)`` of the fused loop: every shard's
        tensors on the driver device, and each worker's mask generator
        from the run's seed there."""
        drv = self.driver_device
        nw = self.cfg.num_workers
        shards = [
            tuple(t.to(drv) for t in shard_tensors(self._recovery.shard(wid)))
            for wid in range(nw)
        ]
        gens = tuple(worker_generator(self.cfg.seed, wid, drv)
                     for wid in range(nw))
        return shards, gens

    def _run_fused(self, extras=None) -> "TrainResult":
        """Run the solver's ``fused_rounds()`` for the iteration budget (full
        waves: ``ceil(num_iterations / nw)`` rounds) and report it as the
        JAX package's ``run_fused`` does (``solvers/asgd.py:528-548``).
        ``extras(carry)`` adds to the result's extras from the final state.
        Raises where ``coeff`` asks for stragglers: no host runs between
        updates."""
        cfg = self.cfg
        nw = cfg.num_workers
        if cfg.coeff != 0.0:
            raise ValueError(
                "run_fused cannot inject stragglers (no host between "
                "updates); use run()"
            )
        fused = self.fused_rounds()
        total_rounds = max(1, -(-cfg.num_iterations // nw))
        snapshots, start_wall, done_rounds, replays = run_fused_plan(
            fused, total_rounds, nw, cfg.printer_freq)
        w = fused.carry[0]
        fence(w.device)  # before elapsed: device work, not the enqueue
        elapsed = time.monotonic() - start_wall
        final_w = w.cpu().numpy()
        snapshots.append((elapsed * 1e3, w.clone()))
        traj = self._evaluate_trajectory(snapshots)
        accepted = done_rounds * nw
        return TrainResult(
            final_w=final_w,
            trajectory=traj,
            elapsed_s=elapsed,
            accepted=accepted,
            dropped=0,
            rounds=done_rounds,
            max_staleness=nw - 1,  # by construction of the full wave
            avg_delay_ms=0.0,
            updates_per_sec=accepted / elapsed if elapsed > 0 else 0.0,
            total_flops=sum(self._task_flops(wid) for wid in range(nw))
            * done_rounds,
            waiting_time_ms={},
            extras={"fused": True,
                    "rounds_per_call": min(CHUNK_ROUNDS, total_rounds),
                    "graph_replays": replays,
                    **(extras(fused.carry) if extras else {})},
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
        traj = [(t, float(l)) for (t, _), l in zip(snapshots, totals)]
        # continuous telemetry: the finished run's loss-vs-wallclock curve
        # lands in the process-global convergence history (the /api/status
        # `convergence` section the in-process live UI serves)
        from asyncframework_tpu_torch.metrics import timeseries as _ts

        _ts.fold_trajectory(traj)
        return traj


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
    # DCN data plane (parallel/ps_dcn.py), each None = resolve from its conf
    # key: pull_mode (async.pull.mode: 'full' ships the whole model a PULL,
    # 'delta' negotiates NOT_MODIFIED / XOR delta / full), push_merge
    # (async.push.merge: pushes coalesced into one drain), push_codec
    # (async.codec.push: 'off', 'fp16', 'int8'), pipeline_depth
    # (async.pipeline.depth: 0 = the serial worker loop), conv_sample
    # (async.convergence.sample: every Nth update a logical worker samples
    # its shard's loss for the PS's curves; 0 = off)
    pull_mode: Optional[str] = None
    push_merge: Optional[int] = None
    push_codec: Optional[str] = None
    pipeline_depth: Optional[int] = None
    conv_sample: Optional[int] = None
    # checkpoint/resume (solvers/base.py of the JAX package; the same npz
    # layout, plus each worker's generator state under ``worker_gens``)
    checkpoint_dir: Optional[str] = None  # None = checkpointing off
    checkpoint_freq: int = 0              # accepted updates between saves; 0 = off
    checkpoint_keep: int = 3
    # observability (EventLoggingListener / MetricsSystem parity; None = off)
    # live dashboard (SparkUI.scala:39 parity): HTTP port serving run state
    # DURING the run; 0 = ephemeral (metrics/live.py); None = off
    ui_port: Optional[int] = None
    event_log: Optional[str] = None       # JSONL (.gz ok) event log path
    metrics_csv: Optional[str] = None     # CsvSink path
    metrics_jsonl: Optional[str] = None   # JsonlSink path
    metrics_period_s: float = 1.0
    # lifecycle tracing (metrics/trace.py): per-update sampling rate of the
    # compute / merge.queue / merge.apply spans; None or 0 = off (explicit
    # opt-in: the updater thread is the measured hot path)
    trace_sample: Optional[float] = None
    # speculative execution (TaskSetManager.checkSpeculatableTasks parity)
    speculation: bool = False
    speculation_quantile: float = 0.75
    speculation_multiplier: float = 1.5
    speculation_min_ms: float = 100.0
    # dynamic executor allocation (ExecutorAllocationManager.scala:82
    # parity): sibling host threads added to backlogged slots, retired idle
    dynamic_allocation: bool = False
    allocation_max_extra: int = 1
    allocation_backlog_threshold: int = 2
    allocation_idle_timeout_s: float = 1.0
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
    # mesh_devices: None = resolve from conf async.mesh.devices (0 = the
    # classic single-device worker gradient step; >= 2 = each DCN worker
    # computes its mini-batch gradient over a local dp mesh of this many
    # ranks of its process's device list, one gradient a PUSH as before).
    # Clamped to the list's length; degrades to the single-device step
    # (logged) when fewer than 2 ranks result or the shard is sparse.
    mesh_devices: Optional[int] = None

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


class SolverCheckpointer:
    """Checkpoint plumbing of the async solvers (``solvers/base.py:216-282``
    of the JAX package): the manager, the compatibility metadata, the save
    cadence and the validated restore, so ASGD and ASAGA differ only in
    which state they save (ASAGA adds the history table).

    The state keeps the reference's names and layout (``w``, ``k``,
    ``clock``, ``alpha``, ``alpha_bar``, ``meta``), so the model state
    crosses between the packages.  The port's worker streams are
    ``torch.Generator`` states under ``worker_gens`` (the JAX package's
    threefry keys are ``worker_keys``): :meth:`restore` refuses a
    checkpoint without them rather than reseed."""

    def __init__(self, cfg: "SolverConfig", solver: str, d: int, n: int):
        self.cfg = cfg
        self.meta = {
            "solver": solver, "num_workers": cfg.num_workers, "d": d, "n": n
        }
        self.mgr = (
            CheckpointManager(cfg.checkpoint_dir, cfg.checkpoint_keep)
            if cfg.checkpoint_dir
            else None
        )

    @property
    def enabled(self) -> bool:
        return self.mgr is not None

    def restore(self) -> Optional[Dict]:
        """Latest checkpoint, validated against this run; None = cold start."""
        if self.mgr is None:
            return None
        ck = self.mgr.restore_latest_or_none()
        if ck is not None:
            validate_resume(ck.get("meta", {}), **self.meta)
            if "worker_gens" not in ck:
                raise ValueError(
                    "checkpoint has no 'worker_gens' (each worker's "
                    "torch.Generator state): it cannot resume the workers' "
                    "streams here; a JAX package checkpoint carries "
                    "'worker_keys' instead"
                )
        return ck

    def should_save(self, k: int) -> bool:
        return (
            self.mgr is not None
            and self.cfg.checkpoint_freq > 0
            and k % self.cfg.checkpoint_freq == 0
        )

    def should_save_range(self, k_old: int, k_new: int) -> bool:
        """True when any k in (k_old, k_new] hits the cadence -- a batched
        drain may jump over a checkpoint boundary and must still save."""
        freq = self.cfg.checkpoint_freq
        return (
            self.mgr is not None
            and freq > 0
            and k_new // freq > k_old // freq
        )

    def save(self, k: int, **state) -> None:
        self.mgr.save(k, {**state, "k": k, "meta": self.meta})


def validate_resume(meta: Dict, **expect) -> None:
    """Fail fast when a checkpoint does not match the resuming run (worker
    count, dataset shape, solver)."""
    for key, want in expect.items():
        got = meta.get(key)
        if got != want:
            raise ValueError(
                f"checkpoint incompatible with this run: {key}={got!r} "
                f"in checkpoint but {want!r} configured"
            )


def generator_states(gens: Dict[int, torch.Generator],
                     gen_locks: Dict[int, threading.Lock]) -> Dict[int, np.ndarray]:
    """Each worker's generator state as host bytes (a CUDA generator's is
    a CPU ``ByteTensor`` of seed and offset), read under its draw lock."""
    out = {}
    for wid, gen in gens.items():
        with gen_locks[wid]:
            out[wid] = gen.get_state().numpy().copy()
    return out


def restore_generators(gens: Dict[int, torch.Generator],
                       saved: Dict[int, np.ndarray]) -> None:
    """Put each worker's saved generator state back (:func:`generator_states`)."""
    if set(saved) != set(gens):
        raise ValueError(
            f"checkpoint 'worker_gens' has workers {sorted(saved)}, the run "
            f"{sorted(gens)}"
        )
    for wid, gen in gens.items():
        gen.set_state(torch.from_numpy(np.asarray(saved[wid], np.uint8).copy()))


def make_allocation_manager(cfg: "SolverConfig", scheduler):
    """Start a dynamic-allocation manager when the config asks for one
    (``ExecutorAllocationManager`` parity); returns None otherwise.  Shared
    by every solver run path."""
    if not cfg.dynamic_allocation:
        return None
    from asyncframework_tpu_torch.engine.allocation import (
        ExecutorAllocationManager,
    )

    mgr = ExecutorAllocationManager(
        scheduler,
        max_extra_per_slot=cfg.allocation_max_extra,
        backlog_threshold=cfg.allocation_backlog_threshold,
        idle_timeout_s=cfg.allocation_idle_timeout_s,
    )
    mgr.start()
    return mgr


class RunSidecars:
    """Speculation and dynamic allocation of one run (the reference starts
    both in every ``run()`` and ``run_sync()``): a
    :class:`~asyncframework_tpu_torch.engine.speculation.SpeculationMonitor`
    whose launches are posted to the run's instruments, and the allocation
    manager; either is None when its switch is off.  Spares and siblings
    issue on their device's current stream, as every executor does."""

    def __init__(self, cfg: "SolverConfig", scheduler, inst):
        self.sched = scheduler
        self.spec = None
        if cfg.speculation:
            from asyncframework_tpu_torch.engine.speculation import (
                SpeculationMonitor,
            )

            self.spec = SpeculationMonitor(
                scheduler, quantile=cfg.speculation_quantile,
                multiplier=cfg.speculation_multiplier,
                min_time_ms=cfg.speculation_min_ms,
                on_launch=inst.on_speculative_launch,
            )
            self.spec.start()
        self.alloc = make_allocation_manager(cfg, scheduler)

    def stop(self) -> None:
        if self.spec is not None:
            self.spec.stop()
        if self.alloc is not None:
            self.alloc.stop()

    def extras(self) -> Dict[str, object]:
        """``speculated``/``speculation_wins`` and ``executors_added``/
        ``executors_removed``, as the reference reports them."""
        out: Dict[str, object] = {}
        if self.spec is not None:
            out["speculated"] = self.spec.speculated_count()
            out["speculation_wins"] = self.sched.speculative_wins()
        if self.alloc is not None:
            out["executors_added"], out["executors_removed"] = (
                self.alloc.counts()
            )
        return out

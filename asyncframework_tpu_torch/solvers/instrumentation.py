"""Run instrumentation: the sidecar subsystems wired into solver runs.

Counterpart of ``asyncframework_tpu/solvers/instrumentation.py`` in its
default-off form.  :class:`RunInstruments` keeps the hooks the solvers call
from their hot threads and the counters behind ``TrainResult.extras``; the
optional sinks of the JAX package (event log, live UI, tracing, CSV/JSONL
metrics) need ``metrics/*``, which is not ported yet, and raise
``NotImplementedError`` when configured.  :class:`FaultTolerantRun` wires
heartbeats, executor replacement and shard re-homing into a run.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

_SINKS = ("event_log", "ui_port", "metrics_csv", "metrics_jsonl")


class RunInstruments:
    """Per-run observability bundle (listener-bus parity, counters only)."""

    def __init__(self, cfg, num_workers: int):
        for name in _SINKS:
            value = getattr(cfg, name, None)
            # a negative ui_port is off, as in the JAX package
            if value is not None and not (name == "ui_port" and value < 0):
                raise NotImplementedError(
                    f"SolverConfig.{name} needs metrics/*, not ported yet "
                    "(ROADMAP.md queue A: metrics and instrumentation sinks)"
                )
        if (getattr(cfg, "trace_sample", None) or 0) > 0:
            raise NotImplementedError(
                "SolverConfig.trace_sample > 0 needs metrics/trace, not "
                "ported yet (ROADMAP.md queue A: metrics and instrumentation "
                "sinks)"
            )
        self.cfg = cfg
        self.num_workers = num_workers
        self.tracer = None  # the updater reads this; tracing is not ported
        self.workers_lost = 0
        self.shards_moved = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ run hooks
    def register_queue_depth(self, fn: Callable[[], int]) -> None:
        """Queue-depth source for a metrics system (none is ported)."""

    def on_round_submitted(self, round_idx: int, cohort, model_version: int) -> None:
        """A cohort was dispatched (an event for the listener bus)."""

    def on_gradient_merged(self, worker_id: int, staleness: int,
                           accepted: bool, iteration: int, **timings) -> None:
        """A result was accepted or dropped (an event for the listener bus)."""

    def on_worker_lost(self, worker_id: int, reason: str) -> None:
        with self._lock:
            self.workers_lost += 1

    def on_shard_moved(self, shard_id: int, new_owner: int, device) -> None:
        with self._lock:
            self.shards_moved += 1

    # ----------------------------------------------------------------- close
    def close(self, trajectory: Optional[List[Tuple[float, float]]] = None,
              printer_freq: int = 1) -> None:
        """End of run; idempotent (the crash path closes early)."""

    # ---------------------------------------------------------------- extras
    def extras(self) -> Dict[str, object]:
        """Summary facts for ``TrainResult.extras``."""
        out: Dict[str, object] = {}
        with self._lock:
            if self.workers_lost:
                out["workers_lost"] = self.workers_lost
            if self.shards_moved:
                out["shards_moved"] = self.shards_moved
        return out


class FaultTolerantRun:
    """Heartbeat + executor replacement + shard re-homing for one run.

    Wires :class:`~asyncframework_tpu_torch.engine.heartbeat.HeartbeatMonitor`
    to the scheduler's ``on_executor_lost`` (in-flight task resubmission on
    a fresh executor -- the transient-failure path) and, when the same
    worker slot keeps dying (``max_slot_failures``), re-homes its data shard
    onto a surviving worker's device via
    :class:`~asyncframework_tpu_torch.engine.recovery.ShardRecovery` (the
    permanent-loss path).
    """

    def __init__(
        self,
        scheduler,
        recovery,
        instruments: RunInstruments,
        num_workers: int,
        heartbeat_timeout_ms: float = 2000.0,
        check_interval_s: float = 0.25,
        max_slot_failures: int = 2,
        on_moved=None,
    ):
        from asyncframework_tpu_torch.engine.heartbeat import HeartbeatMonitor

        self._sched = scheduler
        self._recovery = recovery
        self._inst = instruments
        self._nw = num_workers
        self._max_slot_failures = max_slot_failures
        self._on_moved = on_moved  # callback(shard_id, moved_shard)
        self._losses: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.monitor = HeartbeatMonitor(
            scheduler.pool,
            self._on_lost,
            timeout_ms=heartbeat_timeout_ms,
            check_interval_s=check_interval_s,
            on_sibling_lost=scheduler.on_sibling_lost,
        )

    def _on_lost(self, worker_id: int) -> None:
        with self._lock:
            n = self._losses.get(worker_id, 0) + 1
            self._losses[worker_id] = n
        self._inst.on_worker_lost(worker_id, f"heartbeat timeout (loss #{n})")
        # replacement executor + in-flight resubmission (DAGScheduler parity)
        self._sched.on_executor_lost(worker_id)
        if n >= self._max_slot_failures and self._recovery is not None:
            # repeated deaths: treat the slot's device home as suspect and
            # re-home the shard to the least-loaded surviving slot
            from asyncframework_tpu_torch.engine.recovery import plan_reassignment

            survivors = [w for w in range(self._nw) if w != worker_id]
            if survivors:
                plan = plan_reassignment(range(self._nw), [worker_id])
                new_owner = plan.moves[worker_id]
                moved = self._recovery.move_shard(worker_id, new_owner)
                self._inst.on_shard_moved(worker_id, new_owner, moved.device)
                if self._on_moved is not None:
                    self._on_moved(worker_id, moved)

    def start(self) -> None:
        self.monitor.start()

    def stop(self) -> None:
        self.monitor.stop()

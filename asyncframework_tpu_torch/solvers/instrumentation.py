"""Run instrumentation: the sidecar subsystems wired INTO solver runs.

The reference's observability and resilience live *inside* jobs, not beside
them: every task launch flows through ``LiveListenerBus`` listeners
(``scheduler/LiveListenerBus.scala:44``), ``EventLoggingListener`` streams the
run to disk (``scheduler/EventLoggingListener.scala:55``), ``MetricsSystem``
polls sources on an interval (``metrics/MetricsSystem.scala:70``), and
``HeartbeatReceiver`` (``HeartbeatReceiver.scala:59``) watches executor
liveness for the scheduler.  :class:`RunInstruments` is the per-run bundle of
those capabilities for this framework's solvers: one object the solver
creates from its :class:`~asyncframework_tpu_torch.solvers.base.SolverConfig`,
posts events to from its hot threads, and closes at the end of the run.

Everything here is optional and off the hot path: posting to the bus is a
non-blocking enqueue; when no event log / metrics sink / heartbeat is
configured the instruments are inert no-ops.

Counterpart of ``asyncframework_tpu/solvers/instrumentation.py``: the same
bus, event-log writer, metrics system and tracer, so an event log written
here is read by the JAX package's ``EventLogReader`` and ``render_report``
and the other way round, and the live UI (``ui_port``, ``metrics/live.py``)
serves the run as there.  What the port's spans measure, on a CUDA device:

- ``compute``: the worker task's wall time, submit to finish.  The task
  body waits on a CUDA event after its launches, so it covers the device's
  work, queueing behind other launches included.
- ``merge.queue``: the updater's time from draining a result to the start
  of the apply (taking the state lock, the tau filter, moving gradients to
  the driver device).
- ``merge.apply``: the host's time to issue the apply's launches (for a
  batched drain, split evenly over its results).  No fence: the device
  runs the apply later, and fencing would change the loop it measures.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from asyncframework_tpu_torch.metrics.bus import (
    Event,
    GradientMerged,
    ListenerBus,
    ModelSnapshot,
    RoundSubmitted,
    ShardMoved,
    SpeculativeLaunch,
    WorkerLost,
)
from asyncframework_tpu_torch.metrics import trace as trace_mod
from asyncframework_tpu_torch.metrics.eventlog import EventLogWriter
from asyncframework_tpu_torch.metrics.system import CsvSink, JsonlSink, MetricsSystem


class _GlobalTraceFold:
    """Bus listener folding TraceSpan events into the process-global
    aggregator (bench.py / tools read it) -- on the dispatch thread, so
    the solver's updater never pays for histogram updates."""

    def on_trace_span(self, ev) -> None:
        trace_mod.aggregator().add(trace_mod.Span(
            stage=ev.stage, trace_id=ev.trace_id, span_id=ev.span_id,
            parent_id=ev.parent_id, worker_id=ev.worker_id,
            model_version=ev.model_version, start_ms=ev.start_ms,
            dur_ms=ev.dur_ms, staleness=ev.staleness,
            staleness_ms=ev.staleness_ms, accepted=ev.accepted,
        ))

    def on_event(self, event) -> None:
        pass


class RunInstruments:
    """Per-run observability bundle: listener bus + event log + metrics.

    The solver calls the ``on_*`` hooks from its submitter/updater threads;
    they update metrics instruments synchronously (cheap: a lock and an
    append) and post typed events to the asynchronous bus (never blocks).
    """

    def __init__(self, cfg, num_workers: int):
        self.cfg = cfg
        self._t0 = time.monotonic()
        self.bus = ListenerBus()
        self.writer: Optional[EventLogWriter] = None
        self.metrics: Optional[MetricsSystem] = None
        self.workers_lost = 0
        self.shards_moved = 0
        self._lock = threading.Lock()

        event_log = getattr(cfg, "event_log", None)
        if event_log:
            self.writer = EventLogWriter(event_log)
            self.bus.add_listener(self.writer)
            self.bus.start()

        self.ui = None
        self.live_state = None
        self.final_status: Optional[Dict[str, object]] = None
        ui_port = getattr(cfg, "ui_port", None)
        # None or negative = off (the conf registry's -1 sentinel); 0 = bind
        # an ephemeral port
        if ui_port is not None and ui_port >= 0:
            from asyncframework_tpu_torch.metrics.live import (
                LiveStateListener,
                LiveUIServer,
            )

            self.live_state = LiveStateListener(num_workers)
            self.bus.add_listener(self.live_state)
            self.bus.start()
            self.ui = LiveUIServer(self.live_state, port=ui_port).start()

        # lifecycle tracing: the single-process solvers' slice of the
        # vocabulary (compute / merge.queue / merge.apply; the pull/push
        # stages are the DCN plane's).  Sampled spans go to the bus as
        # TraceSpan events (-> event log) and a bus listener folds them
        # into the process-global aggregator.  Explicit opt-in only
        # (cfg.trace_sample): the updater thread is the measured hot path,
        # and even microseconds of per-merge work (or the bus dispatch
        # thread's GIL share) shift marginal-stability engine runs.  None
        # or 0 = no tracer, no per-merge work.
        self.tracer: Optional[trace_mod.TraceRecorder] = None
        _rate = getattr(cfg, "trace_sample", None)
        if _rate is not None and float(_rate) > 0:
            _rec = trace_mod.TraceRecorder(
                sample_rate=float(_rate), sink=self._fold_span,
            )
            if _rec.enabled:
                self.tracer = _rec
                # start the bus so the updater pays only a queue put;
                # span fan-out runs on the dispatch thread
                self.bus.add_listener(_GlobalTraceFold())
                self.bus.start()

        # the hot hooks build and post their events only when a listener
        # takes them: with no event log, no live UI and no tracer the
        # instruments stay inert (even microseconds a merge shift the
        # engine's staleness)
        self._listened = (self.writer is not None or self.tracer is not None
                          or self.live_state is not None)
        self._queue_source = None

        metrics_csv = getattr(cfg, "metrics_csv", None)
        metrics_jsonl = getattr(cfg, "metrics_jsonl", None)
        if metrics_csv or metrics_jsonl:
            self.metrics = MetricsSystem()
            if metrics_csv:
                self.metrics.add_sink(CsvSink(metrics_csv))
            if metrics_jsonl:
                self.metrics.add_sink(JsonlSink(metrics_jsonl))
            self._c_accepted = self.metrics.counter("updates.accepted")
            self._c_dropped = self.metrics.counter("updates.dropped")
            self._c_rounds = self.metrics.counter("rounds.submitted")
            self._h_staleness = self.metrics.histogram("staleness")
            self._h_task_ms = self.metrics.histogram("task.ms")
            self._g_updates_per_sec = self.metrics.gauge("updates.per_sec")
            self.metrics.start(getattr(cfg, "metrics_period_s", 1.0))

    # ----------------------------------------------------------------- time
    def now_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1e3

    # ------------------------------------------------------------ run hooks
    def register_queue_depth(self, fn: Callable[[], int]) -> None:
        """Expose the result queue's depth as a polled metrics source, to
        the live state and, while the live UI serves, as the ``queue``
        time-series source (``queue.depth``, beside the live state's
        ``queue.accepted`` count at the same tick)."""
        if self.metrics is not None:
            self.metrics.register_source("queue", lambda: {"depth": fn()})
        if self.live_state is not None:
            from asyncframework_tpu_torch.metrics import timeseries

            self.live_state.register_queue_depth(fn)
            state = self.live_state

            def source() -> Dict[str, object]:
                return {"depth": fn(), "accepted": state.accepted}

            self._queue_source = source
            timeseries.register_source("queue", source)

    def on_round_submitted(
        self, round_idx: int, cohort, model_version: int
    ) -> None:
        if self._listened:
            self.bus.post(RoundSubmitted(self.now_ms(), round_idx,
                                         tuple(cohort), model_version))
        if self.metrics is not None:
            self._c_rounds.inc()

    def _fold_span(self, span: "trace_mod.Span") -> None:
        # hot-thread cost: one non-blocking queue put (the bus is started
        # whenever the tracer is on); aggregation happens on the dispatch
        # thread via _GlobalTraceFold
        self.bus.post(trace_mod.span_event(span, self.now_ms()))

    def on_gradient_merged(
        self,
        worker_id: int,
        staleness: int,
        accepted: bool,
        iteration: int,
        batch_size: int = 0,
        task_ms: float = 0.0,
        queue_ms: float = 0.0,
        apply_ms: float = 0.0,
    ) -> None:
        if self._listened:
            self.bus.post(GradientMerged(self.now_ms(), worker_id, staleness,
                                         accepted, iteration, batch_size))
        if self.tracer is not None:
            ut = self.tracer.start_update(worker_id)
            if ut is not None:
                # the stages ran back-to-back and just ended: reconstruct
                # their starts from the measured durations
                ut.ctx.model_version = int(iteration)
                t_now = trace_mod.now_ms()
                t_apply0 = t_now - apply_ms
                t_queue0 = t_apply0 - queue_ms
                t_comp0 = t_queue0 - task_ms
                if task_ms:
                    ut.add(trace_mod.COMPUTE, t_comp0, t_queue0)
                if queue_ms:
                    ut.add(trace_mod.MERGE_QUEUE, t_queue0, t_apply0)
                # staleness in TIME: how old the worker's model basis was
                # at merge = its task wall-clock + result-queue wait
                ut.add(
                    trace_mod.MERGE_APPLY, t_apply0, t_now,
                    staleness=int(staleness),
                    staleness_ms=float(task_ms + queue_ms),
                    accepted=bool(accepted),
                )
        if self.metrics is not None:
            (self._c_accepted if accepted else self._c_dropped).inc()
            self._h_staleness.update(float(staleness))
            if task_ms:
                self._h_task_ms.update(task_ms)
            el = time.monotonic() - self._t0
            if el > 0:
                self._g_updates_per_sec.set(self._c_accepted.value / el)

    def on_worker_lost(self, worker_id: int, reason: str) -> None:
        with self._lock:
            self.workers_lost += 1
        self.bus.post(WorkerLost(self.now_ms(), worker_id, reason))

    def on_shard_moved(self, shard_id: int, new_owner: int, device) -> None:
        with self._lock:
            self.shards_moved += 1
        self.bus.post(
            ShardMoved(self.now_ms(), shard_id, new_owner, str(device))
        )

    def on_speculative_launch(self, job_id: int, worker_id: int) -> None:
        self.bus.post(SpeculativeLaunch(self.now_ms(), job_id, worker_id))

    def post(self, event: Event) -> None:
        self.bus.post(event)

    # ----------------------------------------------------------------- close
    def close(
        self, trajectory: Optional[List[Tuple[float, float]]] = None,
        printer_freq: int = 1,
    ) -> None:
        """Flush trajectory snapshots (objectives are evaluated post-hoc, so
        ``ModelSnapshot`` events are emitted at close) and stop everything.

        Idempotent: the solvers' ``finally`` blocks close WITHOUT a
        trajectory when an exception is unwinding (the event log must get
        its gzip footer exactly when the run crashed); the success path then
        skips its second close.
        """
        with self._lock:
            if getattr(self, "_closed", False):
                return
            self._closed = True
        if trajectory:
            for i, (t_ms, obj) in enumerate(trajectory):
                self.bus.post(
                    ModelSnapshot(t_ms, iteration=i * printer_freq,
                                  objective=float(obj))
                )
        if self.metrics is not None:
            self.metrics.report()  # final sample so short runs get >= 1 row
            self.metrics.stop()
        if self._queue_source is not None:
            from asyncframework_tpu_torch.metrics import timeseries

            # identity-gated: a later run's source stays registered
            timeseries.unregister_source("queue", self._queue_source)
        self.bus.stop()
        if self.live_state is not None:
            # the run's last /api/status, taken once its bus has drained
            self.final_status = self.live_state.snapshot()
        if self.ui is not None:
            self.ui.stop()
        if self.writer is not None:
            self.writer.close()

    # ---------------------------------------------------------------- extras
    def extras(self) -> Dict[str, object]:
        """Summary facts for ``TrainResult.extras``."""
        out: Dict[str, object] = {}
        with self._lock:
            if self.workers_lost:
                out["workers_lost"] = self.workers_lost
            if self.shards_moved:
                out["shards_moved"] = self.shards_moved
        if self.bus.dropped_events:
            out["dropped_events"] = self.bus.dropped_events
        if self.ui is not None:
            out["ui_port"] = self.ui.port
        if self.final_status is not None:
            out["ui_status"] = self.final_status
        return out


def log_trajectory(path, trajectory, printer_freq: int = 1) -> None:
    """Write a bare trajectory as ModelSnapshot events (for runs that have no
    per-task event stream, e.g. the fused-scan baseline); numbering matches
    :meth:`RunInstruments.close` so report tooling sees one convention."""
    from asyncframework_tpu_torch.metrics.bus import ModelSnapshot
    from asyncframework_tpu_torch.metrics.eventlog import EventLogWriter

    wr = EventLogWriter(path)
    try:
        for i, (t_ms, obj) in enumerate(trajectory):
            wr.on_event(
                ModelSnapshot(t_ms, iteration=i * printer_freq,
                              objective=float(obj))
            )
    finally:
        wr.close()


class FaultTolerantRun:
    """Heartbeat + executor replacement + shard re-homing for one run.

    Wires :class:`~asyncframework_tpu_torch.engine.heartbeat.HeartbeatMonitor` to
    the scheduler's ``on_executor_lost`` (in-flight task resubmission on a
    fresh executor -- the transient-failure path) and, when the same worker
    slot keeps dying (``max_slot_failures``), re-homes its data shard onto a
    surviving worker's device via
    :class:`~asyncframework_tpu_torch.engine.recovery.ShardRecovery` (the
    permanent-loss path; lineage-recomputation analog, SURVEY.md section 5).
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
                self._inst.on_shard_moved(
                    worker_id, new_owner, moved.device
                )
                if self._on_moved is not None:
                    self._on_moved(worker_id, moved)

    def start(self) -> None:
        self.monitor.start()

    def stop(self) -> None:
        self.monitor.stop()

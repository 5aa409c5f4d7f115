"""Device executors: the worker side of the engine.

Parity: ``executor/Executor.scala:53`` (``TaskRunner.run`` 290: run task,
report status) + ``executor/CoarseGrainedExecutorBackend.scala:40``
(``LaunchTask`` inbox) + per-task ``TaskMetrics``
(``executor/TaskMetrics.scala:45``) + executor heartbeats (``Executor.scala:814``).

Device mapping: an executor is a daemon thread bound to one *logical worker*.
Each worker owns a ``torch.device`` slot -- with 8 GPUs that is one card per
worker; on a single card, workers share the device and its CUDA stream
serializes their compute while the host threads still overlap dispatch,
transfers, and the driver loop (this mirrors the reference's ``local[8]``
mode, where 8 executor threads share one machine).

Failure semantics: a task closure raising is reported to the scheduler
(status FAILED -> retry/resubmit policy there); an executor can also be
``kill()``-ed to simulate worker loss -- its heartbeat stops and the
:class:`HeartbeatMonitor` (engine/heartbeat.py) declares it dead, triggering
task resubmission on a replacement. That is the Spark executor-loss /
``DistributedSuite`` story in one process.

Exit: an executor told to stop (``shutdown``/``kill``) finishes the task it
holds on its own thread after ``run()`` has returned.  The interpreter's
exit joins those threads (bounded): a daemon thread still inside a torch op
when the runtime is torn down aborts the process (``terminate called
without an active exception``) after the run has printed its result.
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from asyncframework_tpu_torch.engine.job import TaskSpec
from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


@dataclass
class TaskMetrics:
    """Per-task observability record (TaskMetrics parity, trimmed to what a
    host-dispatched kernel launch actually has)."""

    job_id: int
    worker_id: int
    attempt: int
    launch_ms: float
    finish_ms: float = 0.0
    run_ms: float = 0.0
    injected_delay_ms: float = 0.0
    succeeded: bool = False
    error: Optional[str] = None


# executors told to stop whose threads may still hold a task
_stopping: "weakref.WeakSet[DeviceExecutor]" = weakref.WeakSet()


@atexit.register
def _join_stopping(timeout_s: float = 5.0) -> None:
    deadline = time.monotonic() + timeout_s
    for ex in list(_stopping):
        ex.join(max(0.0, deadline - time.monotonic()))


class DeviceExecutor:
    """One worker: a daemon thread draining an inbox of :class:`TaskSpec`.

    ``status_update(executor, task, result, exc)`` is invoked on this thread
    when a task finishes (Spark's ``statusUpdate`` RPC, minus the RPC).
    """

    def __init__(
        self,
        worker_id: int,
        status_update: Callable[["DeviceExecutor", TaskSpec, Any, Optional[BaseException]], None],
        device=None,
        clock: Optional[Clock] = None,
    ):
        self.worker_id = worker_id
        self.device = device
        self._status_update = status_update
        self._clock = clock or SystemClock()
        self._inbox: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._alive = True
        self._killed = False
        self.shutdown_requested = False
        self.busy = False
        self.current_task: Optional[TaskSpec] = None
        self.busy_since_ms = 0.0
        self.last_heartbeat_ms = self._clock.now_ms()
        self.metrics: List[TaskMetrics] = []
        self._thread = threading.Thread(
            target=self._run, name=f"executor-{worker_id}", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ API
    def launch_task(self, task: TaskSpec) -> None:
        if not self._alive:
            raise RuntimeError(f"executor {self.worker_id} is not alive")
        self._inbox.put(task)

    def kill(self) -> None:
        """Simulate worker loss: stop heartbeating and stop taking work."""
        self._killed = True
        self._alive = False
        _stopping.add(self)
        self._inbox.put(None)

    def shutdown(self) -> None:
        """Graceful stop: NOT a failure -- the heartbeat monitor must not
        declare this executor lost (unlike :meth:`kill`)."""
        self.shutdown_requested = True
        self._alive = False
        _stopping.add(self)
        self._inbox.put(None)

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._alive

    def pending_tasks(self) -> int:
        return self._inbox.qsize()

    def idle(self) -> bool:
        """True iff no queued AND no dequeued-but-unfinished task.  Uses
        the queue's unfinished-task count (decremented only after the task
        completes), so the dequeue->busy window cannot misreport idle."""
        return self._inbox.unfinished_tasks == 0

    # ------------------------------------------------------------ main loop
    def _run(self) -> None:
        while True:
            try:
                task = self._inbox.get(timeout=0.1)
            except queue.Empty:
                if not self._alive:
                    return
                self.last_heartbeat_ms = self._clock.now_ms()
                continue
            if task is None or self._killed:
                if task is not None or not self._killed:
                    self._inbox.task_done()  # sentinel / killed-drop
                if (
                    task is None
                    and self.shutdown_requested
                    and not self._killed
                ):
                    # graceful retirement: a task enqueued concurrently
                    # with shutdown() may sit behind the sentinel -- drain
                    # and run it rather than strand its job forever
                    try:
                        task = self._inbox.get_nowait()
                    except queue.Empty:
                        return
                    if task is None:
                        self._inbox.task_done()
                        return
                else:
                    return
            self.last_heartbeat_ms = self._clock.now_ms()
            self.busy = True
            self.current_task = task
            self.busy_since_ms = self.last_heartbeat_ms
            m = TaskMetrics(
                job_id=task.job_id,
                worker_id=self.worker_id,
                attempt=task.attempt,
                launch_ms=self._clock.now_ms(),
            )
            try:
                result = task.fn()
                m.succeeded = True
                exc: Optional[BaseException] = None
            except BaseException as e:  # noqa: BLE001 - report, don't die
                result = None
                exc = e
                m.error = repr(e)
            m.finish_ms = self._clock.now_ms()
            m.run_ms = m.finish_ms - m.launch_ms
            self.metrics.append(m)
            self.busy = False
            self.current_task = None
            self._inbox.task_done()
            self.last_heartbeat_ms = self._clock.now_ms()
            if self._killed:
                return  # killed mid-task: never report (the monitor handles it)
            self._status_update(self, task, result, exc)


class ExecutorPool:
    """Creates and tracks executors; supports replacement after failure.

    Parity: the standalone ``Master``/``Worker`` pair's role of (re)launching
    executors (``deploy/master/Master.scala``), collapsed to in-process
    thread management -- the in-process engine has no separate OS processes
    to manage; the host's GPUs are a fixed resource.
    """

    def __init__(
        self,
        num_workers: int,
        status_update,
        devices: Optional[List] = None,
        clock: Optional[Clock] = None,
    ):
        self.closed = False
        self._clock = clock or SystemClock()
        self._status_update = status_update
        if devices is not None and len(devices) > 0:
            device_of = lambda wid: devices[wid % len(devices)]  # noqa: E731
        else:
            device_of = lambda wid: None  # noqa: E731
        self._device_of = device_of
        self._lock = threading.Lock()
        self.executors: Dict[int, DeviceExecutor] = {
            wid: DeviceExecutor(wid, status_update, device_of(wid), self._clock)
            for wid in range(num_workers)
        }
        self._spares: List[DeviceExecutor] = []
        # long-lived extra executors per slot, added/removed by the
        # allocation manager (dynamic allocation); distinct from one-shot
        # speculation spares
        self._siblings: Dict[int, List[DeviceExecutor]] = {}
        # TaskMetrics of retired siblings: their tasks must stay accounted
        self._retired_metrics: List[TaskMetrics] = []

    def get(self, worker_id: int) -> DeviceExecutor:
        with self._lock:
            return self.executors[worker_id]

    # ------------------------------------------------- dynamic allocation
    def add_sibling(self, worker_id: int) -> DeviceExecutor:
        """Register a long-lived extra executor on a slot.  New launches go
        to the least-loaded of the slot's executors (``least_loaded``) --
        the in-process analog of dynamic executor allocation adding
        capacity where tasks back up."""
        with self._lock:
            if self.closed:
                raise RuntimeError("pool is shut down; cannot add sibling")
            ex = DeviceExecutor(
                worker_id, self._status_update,
                self._device_of(worker_id), self._clock,
            )
            self._siblings.setdefault(worker_id, []).append(ex)
            return ex

    def remove_idle_sibling(self, worker_id: int) -> bool:
        """Retire one idle sibling from the slot (scale-down); returns
        whether one was removed.  Busy siblings (running OR queued work)
        are never killed; the check and the removal happen under the pool
        lock, the same lock ``launch_on_slot`` holds while enqueuing, so a
        concurrently-launched task cannot land on a retiring sibling."""
        with self._lock:
            sibs = self._siblings.get(worker_id, [])
            for i, ex in enumerate(sibs):
                if ex.idle():
                    del sibs[i]
                    self._retired_metrics.extend(ex.metrics)
                    break
            else:
                return False
        ex.shutdown()
        return True

    def launch_on_slot(self, worker_id: int, task) -> None:
        """Pick the slot's least-loaded executor and enqueue the task in
        one pool-locked step, so sibling retirement (which takes the same
        lock) can never shut down the chosen executor between the pick and
        the enqueue."""
        with self._lock:
            self._least_loaded_locked(worker_id).launch_task(task)

    def sibling_count(self, worker_id: int) -> int:
        with self._lock:
            return len(self._siblings.get(worker_id, []))

    def slot_backlog(self, worker_id: int) -> int:
        """Queued-but-unstarted tasks across the slot's executors."""
        with self._lock:
            ex = self.executors.get(worker_id)
            total = ex.pending_tasks() if ex is not None and ex.alive else 0
            for s in self._siblings.get(worker_id, []):
                if s.alive:
                    total += s.pending_tasks()
            return total

    def siblings_of(self, worker_id: int) -> List[DeviceExecutor]:
        with self._lock:
            return list(self._siblings.get(worker_id, []))

    def drop_sibling(self, worker_id: int, ex: DeviceExecutor):
        """Remove a dead/hung sibling (failure path -- contrast the
        scale-down path ``remove_idle_sibling``); its metrics are retained
        and it is killed, not drained.  Returns ``(queued, running)``: the
        never-started tasks recovered from its inbox (relaunchable at the
        SAME attempt) and the task it was running when it died, if any
        (failed once -- relaunch bumps the attempt)."""
        with self._lock:
            sibs = self._siblings.get(worker_id, [])
            self._siblings[worker_id] = [s for s in sibs if s is not ex]
            self._retired_metrics.extend(ex.metrics)
        running = ex.current_task
        ex.kill()
        queued = []
        try:
            while True:
                t = ex._inbox.get_nowait()
                if t is not None:
                    queued.append(t)
        except queue.Empty:
            pass
        return queued, running

    def _least_loaded_locked(self, worker_id: int) -> DeviceExecutor:
        """The slot's executor with the lightest load (primary when tied --
        keeps single-executor behavior identical).  Load counts the queued
        inbox PLUS the currently-running task: a busy executor with an
        empty inbox must lose the tie to an idle sibling.  Internal: pick
        and enqueue must share one lock hold (``launch_on_slot``)."""
        def load_of(ex: DeviceExecutor) -> float:
            if not ex.alive:
                return float("inf")
            return ex.pending_tasks() + (1 if ex.busy else 0)

        best = self.executors[worker_id]
        load = load_of(best)
        for s in self._siblings.get(worker_id, []):
            if load_of(s) < load:
                best, load = s, load_of(s)
        return best

    # ----------------------------------------------------- speculative spares
    def spawn_spare(self, worker_id: int) -> DeviceExecutor:
        """Extra executor bound to the same device slot, for a speculative
        copy; not registered under the worker id (the primary keeps it)."""
        with self._lock:
            if self.closed:
                raise RuntimeError("pool is shut down; cannot spawn spare")
            ex = DeviceExecutor(
                worker_id, self._status_update, self._device_of(worker_id), self._clock
            )
            self._spares.append(ex)
            return ex

    def is_spare(self, ex: DeviceExecutor) -> bool:
        with self._lock:
            return any(s is ex for s in self._spares)

    def discard_spare(self, ex: DeviceExecutor) -> None:
        """One-shot spares are shut down and dropped after their task."""
        with self._lock:
            self._spares = [s for s in self._spares if s is not ex]
            self._retired_metrics.extend(ex.metrics)
        ex.shutdown()

    def replace(self, worker_id: int) -> DeviceExecutor:
        """Start a fresh executor for a dead worker (elastic recovery)."""
        with self._lock:
            if self.closed:
                raise RuntimeError("pool is shut down; cannot replace executor")
            old = self.executors.get(worker_id)
            if old is not None:
                self._retired_metrics.extend(old.metrics)
                if old.alive:
                    old.shutdown()
            ex = DeviceExecutor(
                worker_id, self._status_update, self._device_of(worker_id), self._clock
            )
            self.executors[worker_id] = ex
            return ex

    def kill(self, worker_id: int) -> None:
        with self._lock:
            self.executors[worker_id].kill()

    def alive_ids(self) -> List[int]:
        with self._lock:
            return [wid for wid, ex in self.executors.items() if ex.alive]

    def shutdown(self) -> None:
        with self._lock:
            self.closed = True
            for ex in self.executors.values():
                ex.shutdown()
            for ex in self._spares:
                self._retired_metrics.extend(ex.metrics)
                ex.shutdown()
            self._spares = []
            for sibs in self._siblings.values():
                for ex in sibs:
                    self._retired_metrics.extend(ex.metrics)
                    ex.shutdown()
            self._siblings = {}

    def all_metrics(self) -> List[TaskMetrics]:
        with self._lock:
            out: List[TaskMetrics] = []
            for ex in self.executors.values():
                out.extend(ex.metrics)
            for sibs in self._siblings.values():
                for ex in sibs:
                    out.extend(ex.metrics)
            for ex in self._spares:
                out.extend(ex.metrics)
            out.extend(self._retired_metrics)
            return out

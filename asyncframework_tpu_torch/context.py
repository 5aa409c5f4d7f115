"""Driver-side hub for asynchronous result streaming.

Reference parity (studied, not copied):
- ``AsyncContext``  ~ ``core/.../rdd/ASYNCcontext.scala:14-81`` -- blocking
  result queue, worker-state table, logical clock, consumer API.
- ``WorkerState``   ~ ``core/.../rdd/workerState.scala:14-87`` -- per-worker
  staleness / average task time / availability / task count, plus table-wide
  aggregates ``available_workers`` and ``max_staleness``.
- ``PartialResult`` ~ ``core/.../rdd/RDDPartialRes.scala:13-37`` -- immutable
  (result, staleness, batch size, worker id) record.

Design deltas from the reference (deliberate, device-first):
- The reference mutates an unsynchronized HashMap from the DAG-scheduler event
  loop while two driver threads read it (a benign race it tolerates).  Here the
  state table is guarded by a single lock and the logical clock is atomic;
  semantics are identical but defined.
- The "result" payload is opaque to this layer: it may be a host numpy array or
  a ``torch.Tensor`` still resident in device memory (the updater decides when --
  and whether -- to bring it to host).  This is what makes the queue a
  device-to-host streaming channel rather than an RPC deserialization point.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class PartialResult(Generic[T]):
    """Immutable record for one worker's streamed partial result.

    Parity: ``RDDPartialRes`` -- (data, ts=staleness, recs=batch size, id).
    """

    data: T
    staleness: int
    batch_size: int
    worker_id: int

    # Reference getter names, kept for drop-in familiarity.
    def get_task_result(self) -> T:
        return self.data

    def get_staleness(self) -> int:
        return self.staleness

    def get_batch_size(self) -> int:
        return self.batch_size

    def get_worker_id(self) -> int:
        return self.worker_id


class WorkerState:
    """Mutable per-worker state: staleness, avg task time, availability.

    Parity: ``workerState.scala`` fields ``staleness`` / ``averageTaskTime`` /
    ``availability`` / ``numTasks`` and the table-scanning aggregates
    ``getAvailableWorkers`` / ``getMaxStaleness`` (which in the reference scan
    ``AC.STAT``; here they live on :class:`AsyncContext` where they belong,
    with back-compat delegating methods kept on the state object).
    """

    __slots__ = ("_ctx", "staleness", "average_task_time", "available", "num_tasks")

    def __init__(
        self,
        ctx: "AsyncContext",
        staleness: int = 0,
        average_task_time: float = 0.0,
        available: bool = False,
    ):
        self._ctx = ctx
        self.staleness = staleness
        self.average_task_time = average_task_time
        self.available = available
        self.num_tasks = 0

    def update_num_tasks(self, n: int) -> None:
        self.num_tasks += n

    # Aggregates delegate to the owning context (single source of truth).
    def get_available_workers(self) -> int:
        return self._ctx.available_workers()

    def get_max_staleness(self) -> int:
        return self._ctx.max_staleness()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"WorkerState(staleness={self.staleness}, "
            f"avg_ms={self.average_task_time:.2f}, available={self.available}, "
            f"num_tasks={self.num_tasks})"
        )


class AsyncContext(Generic[T]):
    """The driver-side hub shared by the submitter and updater threads.

    Producers (device-executor completion callbacks) ``put`` results; the
    consumer (updater thread) drains with :meth:`collect` /
    :meth:`collect_all`.  A logical clock counts merged gradients; staleness of
    a result is ``clock_at_completion - clock_at_submit``.

    Parity: ``ASYNCcontext.scala`` -- ``ResultList`` (LinkedBlockingQueue),
    ``STAT`` (HashMap[Int, workerState]), ``CurrentTime`` / ``add2currentTime``
    / ``getCurrentTime``, ``ASYNCcollect`` / ``ASYNCcollectAll`` / ``getSize``
    / ``hasNext``, ``setLastTime`` / ``isOld``.
    """

    def __init__(self) -> None:
        self._results: "queue.Queue[PartialResult[T]]" = queue.Queue()
        self._stat: Dict[int, WorkerState] = {}
        self._lock = threading.RLock()
        self._clock = 0
        self._last_time = -(2**31)
        self._record_stat = False

    # ------------------------------------------------------------------ clock
    def set_current_time(self, t: int) -> None:
        with self._lock:
            self._clock = t

    def add_to_current_time(self, dt: int = 1) -> None:
        with self._lock:
            self._clock += dt

    def get_current_time(self) -> int:
        with self._lock:
            return self._clock

    def set_last_time(self, t: int) -> None:
        with self._lock:
            self._last_time = t

    def is_old(self) -> bool:
        """True when no new gradient has arrived since the last submit stamp."""
        with self._lock:
            return self._clock == self._last_time

    def set_record_stat(self, b: bool) -> None:
        self._record_stat = b

    def get_record_stat(self) -> bool:
        return self._record_stat

    # ------------------------------------------------------------ result queue
    def put(self, result: PartialResult[T]) -> None:
        self._results.put(result)

    def collect(self, timeout: Optional[float] = None) -> T:
        """Blocking take of the next task result (payload only)."""
        return self._results.get(timeout=timeout).data

    def collect_all(self, timeout: Optional[float] = None) -> PartialResult[T]:
        """Blocking take of the next full :class:`PartialResult`."""
        return self._results.get(timeout=timeout)

    def size(self) -> int:
        return self._results.qsize()

    def has_next(self) -> bool:
        return not self._results.empty()

    # -------------------------------------------------------------- STAT table
    def get_state(self, worker_id: int) -> Optional[WorkerState]:
        with self._lock:
            return self._stat.get(worker_id)

    def get_or_create_state(self, worker_id: int) -> WorkerState:
        with self._lock:
            ws = self._stat.get(worker_id)
            if ws is None:
                ws = WorkerState(self)
                self._stat[worker_id] = ws
            return ws

    def set_state(self, worker_id: int, state: WorkerState) -> None:
        with self._lock:
            self._stat[worker_id] = state

    def states(self) -> Dict[int, WorkerState]:
        """Snapshot copy of the state table (safe to iterate)."""
        with self._lock:
            return dict(self._stat)

    def num_workers_tracked(self) -> int:
        with self._lock:
            return len(self._stat)

    def mark_busy(self, worker_ids) -> None:
        """Mark a cohort unavailable before dispatch.

        Parity: the pre-submit loop in ``RDD.ASYNCreduce``
        (``rdd/RDD.scala:1136-1142``) setting availability=false for every
        selected partition.
        """
        with self._lock:
            for wid in worker_ids:
                self.get_or_create_state(wid).available = False

    def merge_result(
        self,
        worker_id: int,
        data: T,
        submit_clock: int,
        elapsed_ms: float,
        batch_size: int,
    ) -> PartialResult[T]:
        """Record a finished task: push result, update STAT, bump the clock.

        Parity: the ``mergeResult`` closure in ``RDD.ASYNCreduce``
        (``rdd/RDD.scala:1144-1165``): staleness = clock_now - submit_clock;
        per-worker average task time = elapsed / (num_tasks + 1); worker
        becomes available; logical clock += 1.
        """
        with self._lock:
            staleness = self._clock - submit_clock
            ws = self.get_or_create_state(worker_id)
            # Mutate in place (never replace) so references held by other
            # threads observe the update -- a deliberate tightening of the
            # reference, which installs a fresh workerState object per merge.
            # Deliberate delta: average_task_time is a true running mean of
            # task latencies; the reference's fresh-object dance makes its
            # "average" just elapsed/2 after the first task
            # (rdd/RDD.scala:1150-1156 reads the previous state's numTasks,
            # which is always 1).
            ws.staleness = staleness
            ws.average_task_time = (
                ws.average_task_time * ws.num_tasks + elapsed_ms
            ) / (ws.num_tasks + 1)
            ws.available = True
            ws.num_tasks += 1
            res = PartialResult(data, staleness, batch_size, worker_id)
            self._clock += 1
        self._results.put(res)
        return res

    def mark_available(self, worker_id: int) -> None:
        """Empty-result path of ``mergeResult`` (worker freed, no clock bump)."""
        with self._lock:
            self.get_or_create_state(worker_id).available = True

    # -------------------------------------------------------------- aggregates
    def available_workers(self) -> int:
        """Parity: ``workerState.getAvailableWorkers`` scanning ``AC.STAT``."""
        with self._lock:
            return sum(1 for ws in self._stat.values() if ws.available)

    def max_staleness(self) -> int:
        """Parity: ``workerState.getMaxStaleness`` (returns -1 when empty)."""
        with self._lock:
            n = -1
            for ws in self._stat.values():
                if ws.staleness > n:
                    n = ws.staleness
            return n

    def drain(self) -> Iterator[PartialResult[T]]:
        """Non-blocking drain of everything currently queued."""
        while True:
            try:
                yield self._results.get_nowait()
            except queue.Empty:
                return

"""Typed event stream with an asynchronous listener bus.

Parity: ``SparkListenerEvent`` case classes + ``LiveListenerBus``
(``scheduler/LiveListenerBus.scala:44``): producers post from hot threads;
a dispatch thread fans events out to registered listeners; the queue is
bounded and *drops* (counting) rather than blocking the producer when a slow
listener falls behind -- exactly the reference's drop-and-log policy.

The event vocabulary is this framework's: training rounds, gradient merges
(with staleness), model snapshots, worker loss -- the observable facts of the
async parameter-server loop, not Spark's stage/RDD taxonomy.
"""

from __future__ import annotations

import functools
import queue
import threading
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type


@dataclass(frozen=True)
class Event:
    time_ms: float


@dataclass(frozen=True)
class JobStart(Event):
    job_id: int
    worker_ids: tuple


@dataclass(frozen=True)
class JobEnd(Event):
    job_id: int
    succeeded: bool
    error: Optional[str] = None


@dataclass(frozen=True)
class TaskEnd(Event):
    job_id: int
    worker_id: int
    attempt: int
    run_ms: float
    succeeded: bool
    error: Optional[str] = None


@dataclass(frozen=True)
class RoundSubmitted(Event):
    round_idx: int
    cohort: tuple
    model_version: int


@dataclass(frozen=True)
class GradientMerged(Event):
    worker_id: int
    staleness: int
    accepted: bool
    iteration: int
    batch_size: int = 0


@dataclass(frozen=True)
class ModelSnapshot(Event):
    iteration: int
    objective: float


@dataclass(frozen=True)
class WorkerLost(Event):
    worker_id: int
    reason: str


@dataclass(frozen=True)
class ShardMoved(Event):
    """Elastic recovery re-homed a data shard (engine/recovery.py)."""

    shard_id: int
    new_owner: int
    device: str


@dataclass(frozen=True)
class SpeculativeLaunch(Event):
    """A speculative task copy was launched (engine/speculation.py)."""

    job_id: int
    worker_id: int


@dataclass(frozen=True)
class TraceSpan(Event):
    """One completed lifecycle-stage span of a traced update
    (metrics/trace.py): pull.wait / pull.rtt / compute / push.wait /
    push.rtt / merge.queue / merge.apply.  ``start_ms`` is wall-clock epoch
    milliseconds (cross-process comparable; ``time_ms`` stays the posting
    process's run-relative clock like every other event)."""

    stage: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    worker_id: int
    model_version: int
    start_ms: float
    dur_ms: float
    staleness: Optional[int] = None
    staleness_ms: Optional[float] = None
    accepted: Optional[bool] = None
    bytes: Optional[int] = None  # wire bytes of the RPC the span covers


EVENT_TYPES: Dict[str, Type[Event]] = {
    cls.__name__: cls
    for cls in (
        JobStart, JobEnd, TaskEnd, RoundSubmitted, GradientMerged,
        ModelSnapshot, WorkerLost, ShardMoved, SpeculativeLaunch, TraceSpan,
    )
}


class Listener:
    """Override ``on_event`` (catch-all) or per-type ``on_<snake_name>``."""

    def on_event(self, event: Event) -> None:  # pragma: no cover - default
        pass


@functools.lru_cache(maxsize=None)
def _snake(name: str) -> str:
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i > 0:
            out.append("_")
        out.append(c.lower())
    return "".join(out)


class ListenerBus:
    """Bounded async fan-out bus.

    ``post`` never blocks the producer: when the queue is full the event is
    dropped and counted (``dropped_events``), matching ``LiveListenerBus``'s
    behavior under backpressure.  ``stop`` drains what is queued.
    """

    def __init__(self, capacity: int = 10_000):
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue(capacity)
        self._listeners: List[Listener] = []
        self._lock = threading.Lock()
        self.dropped_events = 0
        self.posted_events = 0
        self._started = False
        self._stop_requested = False
        self._thread: Optional[threading.Thread] = None

    def add_listener(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_listener(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.remove(listener)

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="listener-bus", daemon=True
        )
        self._thread.start()

    def post(self, event: Event) -> None:
        self.posted_events += 1
        if not self._started:
            self._deliver(event)  # synchronous mode (tests, simple tools)
            return
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            self.dropped_events += 1

    def stop(self, timeout: float = 5.0) -> None:
        """Drain and stop.  Never blocks past ``timeout``: if the queue is
        full behind a wedged listener the sentinel is skipped (the dispatch
        loop also polls the stop flag) and the daemon thread is abandoned
        after the join timeout -- stop must obey the same never-block policy
        as post."""
        if not self._started:
            return
        self._stop_requested = True
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._started = False
        self._stop_requested = False

    # ------------------------------------------------------------- internals
    def _dispatch_loop(self) -> None:
        while True:
            try:
                ev = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._stop_requested:
                    return
                continue
            if ev is None:
                return
            self._deliver(ev)

    def _deliver(self, event: Event) -> None:
        with self._lock:
            listeners = list(self._listeners)
        hook = "on_" + _snake(type(event).__name__)
        for lst in listeners:
            try:
                fn = getattr(lst, hook, None)
                if fn is not None:
                    fn(event)
                else:
                    lst.on_event(event)
            except Exception:  # noqa: BLE001 - a bad listener must not kill the bus
                pass

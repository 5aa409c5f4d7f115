"""Dynamic executor allocation: scale slot capacity with task backlog.

Parity (studied, not copied): ``core/src/main/scala/org/apache/spark/
ExecutorAllocationManager.scala:82`` -- Spark requests extra executors when
tasks stay backlogged past ``schedulerBacklogTimeout`` and releases
executors idle past ``executorIdleTimeout``.

Device mapping: the host's GPUs are a fixed resource, so "adding an
executor" cannot mean adding a card -- it means adding a HOST THREAD (a sibling
``DeviceExecutor``) to a backlogged device slot.  That is precisely the
resource that runs out in this runtime: a slot's executor thread serializes
task bodies (host-side preprocessing, straggler sleeps, dispatch), so a
backlog of queued tasks on one slot is drained by a second thread sharing
the same device stream.  Scale-down retires idle siblings, never the
primary.

The policy mirrors the reference: a slot must stay backlogged for
``sustained_ticks`` consecutive checks before scale-up (the
schedulerBacklogTimeout analog), and a slot must be quiet for
``idle_timeout_s`` before a sibling is retired.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


class ExecutorAllocationManager:
    """Periodic backlog scan over a :class:`JobScheduler`'s pool."""

    def __init__(
        self,
        scheduler,
        max_extra_per_slot: int = 1,
        backlog_threshold: int = 2,
        sustained_ticks: int = 2,
        idle_timeout_s: float = 1.0,
        check_interval_s: float = 0.05,
        clock: Optional[Clock] = None,
        on_scale=None,
    ):
        if backlog_threshold < 1:
            raise ValueError("backlog_threshold must be >= 1")
        self._sched = scheduler
        self.max_extra = max_extra_per_slot
        self.backlog_threshold = backlog_threshold
        self.sustained_ticks = sustained_ticks
        self.idle_timeout_s = idle_timeout_s
        self._interval = check_interval_s
        self._clock = clock or SystemClock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._on_scale = on_scale  # callback(worker_id, +1 | -1)
        self._backlog_streak: Dict[int, int] = {}
        self._idle_since_ms: Dict[int, float] = {}
        self._added = 0
        self._removed = 0
        self.last_error: Optional[BaseException] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ policy
    def check_once(self) -> List[Tuple[int, int]]:
        """One scan; returns [(worker_id, delta)] scale events (testable
        without threads)."""
        pool = self._sched.pool
        events: List[Tuple[int, int]] = []
        now = self._clock.now_ms()
        for wid in pool.alive_ids():
            backlog = pool.slot_backlog(wid)
            if backlog >= self.backlog_threshold:
                self._idle_since_ms.pop(wid, None)
                streak = self._backlog_streak.get(wid, 0) + 1
                self._backlog_streak[wid] = streak
                if (
                    streak >= self.sustained_ticks
                    and pool.sibling_count(wid) < self.max_extra
                ):
                    pool.add_sibling(wid)
                    self._backlog_streak[wid] = 0
                    events.append((wid, +1))
            else:
                self._backlog_streak[wid] = 0
                if backlog == 0 and pool.sibling_count(wid) > 0:
                    since = self._idle_since_ms.setdefault(wid, now)
                    if now - since >= self.idle_timeout_s * 1e3:
                        if pool.remove_idle_sibling(wid):
                            events.append((wid, -1))
                        self._idle_since_ms.pop(wid, None)
                else:
                    self._idle_since_ms.pop(wid, None)
        if events:
            with self._lock:
                for _wid, delta in events:
                    if delta > 0:
                        self._added += 1
                    else:
                        self._removed += 1
            if self._on_scale is not None:
                for wid, delta in events:
                    self._on_scale(wid, delta)
        return events

    def counts(self) -> Tuple[int, int]:
        with self._lock:
            return self._added, self._removed

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._interval):
                try:
                    self.check_once()
                except Exception as e:
                    if self._sched.pool.closed:
                        return  # pool torn down mid-scan: normal exit
                    # a real policy/callback bug: record it, log it once,
                    # and stop scanning -- silently retrying every tick
                    # would leave allocation half-applied with misleading
                    # counts and no diagnostic
                    self.last_error = e
                    logging.getLogger(__name__).warning(
                        "dynamic allocation stopped after error: %r", e
                    )
                    return

        self._thread = threading.Thread(
            target=loop, name="executor-allocation", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

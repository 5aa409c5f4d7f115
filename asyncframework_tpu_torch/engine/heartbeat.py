"""Executor liveness monitoring and failure detection.

Parity: ``core/.../HeartbeatReceiver.scala:59`` (driver-side liveness via
periodic executor heartbeats; silent executors are declared dead and their
tasks resubmitted) + standalone Master/Worker heartbeats.  Executors here
touch ``last_heartbeat_ms`` whenever their loop wakes; the monitor thread
compares against a timeout and notifies the scheduler (``on_executor_lost``),
which replaces the executor and resubmits in-flight tasks.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from asyncframework_tpu_torch.engine.executor import ExecutorPool
from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


class HeartbeatMonitor:
    def __init__(
        self,
        pool: ExecutorPool,
        on_executor_lost: Callable[[int], None],
        timeout_ms: float = 5000.0,
        check_interval_s: float = 0.5,
        task_timeout_ms: Optional[float] = None,
        clock: Optional[Clock] = None,
        on_sibling_lost=None,
    ):
        """``timeout_ms`` applies to *idle* silence (a dead thread).  A worker
        legitimately goes silent while running a long task (the first kernel
        build takes seconds), so busy executors are only timed out when
        ``task_timeout_ms`` is set (hung-task detection, off by default --
        slow tasks are the *straggler* story, handled by cohort selection,
        not by killing workers)."""
        self._pool = pool
        self._on_lost = on_executor_lost
        # on_sibling_lost(wid, queued_tasks, running_task): a failed
        # dynamic-allocation sibling must NOT escalate to slot loss -- the
        # primary is healthy, and resubmitting ITS in-flight tasks would
        # inflate their attempts (spurious max-failures abort) and
        # duplicate running work.  Only the sibling's own tasks resubmit.
        self._on_sibling_lost = on_sibling_lost
        self._timeout_ms = timeout_ms
        self._task_timeout_ms = task_timeout_ms
        self._interval = check_interval_s
        self._clock = clock or SystemClock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="heartbeat-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def check_once(self) -> list:
        """One scan; returns the worker ids declared lost (test-friendly)."""
        if self._pool.closed:
            return []
        now = self._clock.now_ms()

        def is_bad(ex) -> bool:
            if ex.shutdown_requested:
                return False  # graceful stop, not a failure
            if not ex.alive:
                return True
            if ex.busy:
                return (
                    self._task_timeout_ms is not None
                    and now - ex.busy_since_ms > self._task_timeout_ms
                )
            return now - ex.last_heartbeat_ms > self._timeout_ms

        lost = []
        for wid, ex in list(self._pool.executors.items()):
            if is_bad(ex):
                lost.append(wid)
            # dynamic-allocation siblings carry tasks too: a dead or hung
            # sibling is dropped and ONLY ITS tasks resubmit -- the healthy
            # primary's in-flight work keeps its attempt counts.  Without a
            # resubmission handler the sibling's tasks would be silently
            # discarded (hung jobs), so fall back to escalating the whole
            # slot -- on_lost's resubmission covers them
            for sib in self._pool.siblings_of(wid):
                if is_bad(sib):
                    if self._on_sibling_lost is not None and wid not in lost:
                        queued, running = self._pool.drop_sibling(wid, sib)
                        self._on_sibling_lost(wid, queued, running)
                    else:
                        # no handler, OR the slot is already being
                        # escalated this scan: on_lost's resubmission
                        # covers the sibling's tasks -- relaunching them
                        # here too would double-execute and double-bump
                        # their attempts
                        self._pool.drop_sibling(wid, sib)
                        if wid not in lost:
                            lost.append(wid)
        for wid in lost:
            self._on_lost(wid)
        return lost

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.check_once()

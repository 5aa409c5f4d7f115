"""Worker blacklisting after repeated task failures.

Parity: ``scheduler/BlacklistTracker.scala:50`` -- executors accumulating task
failures inside a time window are excluded from scheduling until the
blacklist entry expires.

Device mapping: a "worker" is a logical device slot driven by an executor
thread, and the hardware behind it is fixed (the host's GPUs are the cluster), so
blacklisting cannot move work to different *hardware*.  What it can do --
and what the reference's tracker really provides -- is (a) stop offering
tasks to a slot whose runtime state is poisoned (wedged CUDA stream, leaked
buffers, a straggling host thread) until it is replaced, and (b) force the
replacement: the scheduler swaps in a fresh executor for a blacklisted slot
before the next launch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


class BlacklistTracker:
    """Sliding-window failure counting with timed expiry.

    A worker with ``max_failures`` failures inside ``window_ms`` is
    blacklisted until ``timeout_ms`` after its most recent failure
    (``spark.blacklist.timeout`` semantics).  A success clears nothing --
    like the reference, only time heals a blacklisted worker -- but it also
    does not extend the window.
    """

    def __init__(
        self,
        max_failures: int = 2,
        timeout_ms: float = 60_000.0,
        window_ms: Optional[float] = None,
        clock: Optional[Clock] = None,
    ):
        if max_failures < 1:
            raise ValueError("max_failures must be >= 1")
        self.max_failures = max_failures
        self.timeout_ms = timeout_ms
        self.window_ms = window_ms if window_ms is not None else timeout_ms
        self._clock = clock or SystemClock()
        self._lock = threading.Lock()
        self._failures: Dict[int, Deque[float]] = {}

    def clear(self, worker_id: int) -> None:
        """Forget a worker's failures (called after its executor is replaced:
        the fresh executor starts with a clean slate)."""
        with self._lock:
            self._failures.pop(worker_id, None)

    def record_failure(self, worker_id: int) -> None:
        now = self._clock.now_ms()
        with self._lock:
            dq = self._failures.setdefault(worker_id, deque())
            dq.append(now)
            self._prune(dq, now)

    def _prune(self, dq: Deque[float], now: float) -> None:
        while dq and now - dq[0] > self.window_ms:
            dq.popleft()

    def is_blacklisted(self, worker_id: int) -> bool:
        now = self._clock.now_ms()
        with self._lock:
            dq = self._failures.get(worker_id)
            if not dq:
                return False
            self._prune(dq, now)
            if len(dq) < self.max_failures:
                return False
            return now - dq[-1] <= self.timeout_ms

    def blacklisted_workers(self) -> List[int]:
        with self._lock:
            ids = list(self._failures)
        return [wid for wid in ids if self.is_blacklisted(wid)]

    def failure_count(self, worker_id: int) -> int:
        now = self._clock.now_ms()
        with self._lock:
            dq = self._failures.get(worker_id)
            if not dq:
                return 0
            self._prune(dq, now)
            return len(dq)

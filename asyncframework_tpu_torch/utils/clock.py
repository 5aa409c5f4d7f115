"""Clock abstraction for deterministic tests.

Parity: the reference's streaming suites inject a ``ManualClock`` to make
time-driven logic deterministic (SURVEY.md section 4); the engine here takes a
:class:`Clock` everywhere it would otherwise read wall time, so scheduler and
heartbeat tests run with virtual time.
"""

from __future__ import annotations

import threading
import time


class Clock:
    def now_ms(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait_for(self, event: "threading.Event", seconds: float) -> bool:
        """Sleep up to ``seconds`` but wake early when ``event`` is set.

        Returns True iff the event was set.  Periodic loops must use this
        instead of :meth:`sleep` so shutdown can interrupt them (a ManualClock
        ``sleep`` blocks until virtual time advances, which at shutdown it
        never does).
        """
        raise NotImplementedError


class SystemClock(Clock):
    def now_ms(self) -> float:
        return time.monotonic() * 1000.0

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait_for(self, event: "threading.Event", seconds: float) -> bool:
        return event.wait(timeout=seconds)


class ManualClock(Clock):
    """Virtual clock advanced explicitly by the test."""

    def __init__(self, start_ms: float = 0.0):
        self._ms = start_ms
        self._cond = threading.Condition()

    def now_ms(self) -> float:
        with self._cond:
            return self._ms

    def advance(self, ms: float) -> None:
        with self._cond:
            self._ms += ms
            self._cond.notify_all()

    def sleep(self, seconds: float) -> None:
        """Blocks until the clock is advanced past the deadline."""
        with self._cond:
            deadline = self._ms + seconds * 1000.0
            while self._ms < deadline:
                self._cond.wait(timeout=1.0)

    def wait_for(self, event, seconds: float) -> bool:
        """Virtual-time sleep that also wakes (promptly) on ``event``."""
        with self._cond:
            deadline = self._ms + seconds * 1000.0
            while self._ms < deadline:
                if event.is_set():
                    return True
                self._cond.wait(timeout=0.05)
        return event.is_set()

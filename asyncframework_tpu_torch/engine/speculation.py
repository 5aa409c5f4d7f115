"""Speculative execution: duplicate slow tasks, first finisher wins.

Parity: ``scheduler/TaskSetManager.checkSpeculatableTasks``
(``TaskSetManager.scala:975``): once at least ``quantile`` of a job's tasks
have finished, any task running longer than ``multiplier * median(finished
durations)`` (and at least ``min_time_ms``) gets a speculative copy launched
on a different executor; whichever copy finishes first supplies the result
and the other is ignored.

Device mapping: the straggler is a host thread + kernel launches, not a bad
machine, so the "different executor" is a *spare* executor thread bound to
the same device slot (the device stream serializes compute, but the common
straggler causes here -- injected delay, a wedged host thread, host-side GC
-- are bypassed by the spare).  De-duplication happens in ``JobWaiter``:
a worker's second completion is dropped before the result handler runs.
"""

from __future__ import annotations

import statistics
import threading
from typing import Dict, List, Optional, Set, Tuple

from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


def find_speculatable(
    finished_ms: List[float],
    running_elapsed_ms: Dict[int, float],
    quantile: float = 0.75,
    multiplier: float = 1.5,
    min_time_ms: float = 100.0,
) -> List[int]:
    """Pure selection logic (unit-testable with no threads).

    ``finished_ms``: durations of this job's finished tasks.
    ``running_elapsed_ms``: worker id -> elapsed time of its running task.
    Returns worker ids whose running task qualifies for a speculative copy.
    """
    total = len(finished_ms) + len(running_elapsed_ms)
    if total == 0 or not finished_ms:
        return []
    if len(finished_ms) / total < quantile:
        return []
    threshold = max(multiplier * statistics.median(finished_ms), min_time_ms)
    return [wid for wid, el in running_elapsed_ms.items() if el > threshold]


class SpeculationMonitor:
    """Periodic scan over a scheduler's active jobs.

    The scheduler exposes ``speculation_snapshot()`` (per-job finished
    durations + running task elapsed times) and ``speculative_launch(job_id,
    worker_id)``; this monitor owns only the policy and the scan cadence.
    One speculative copy per (job, worker), like the reference.
    """

    def __init__(
        self,
        scheduler,
        quantile: float = 0.75,
        multiplier: float = 1.5,
        min_time_ms: float = 100.0,
        check_interval_s: float = 0.1,
        clock: Optional[Clock] = None,
        on_launch=None,
    ):
        self._sched = scheduler
        self.quantile = quantile
        self.multiplier = multiplier
        self.min_time_ms = min_time_ms
        self._interval = check_interval_s
        self._clock = clock or SystemClock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._speculated: Set[Tuple[int, int]] = set()
        self._lock = threading.Lock()
        self._on_launch = on_launch  # callback(job_id, worker_id) per copy

    def check_once(self) -> List[Tuple[int, int]]:
        """One scan; returns the (job_id, worker_id) copies launched."""
        launched: List[Tuple[int, int]] = []
        for job_id, (finished, running) in self._sched.speculation_snapshot().items():
            for wid in find_speculatable(
                finished, running, self.quantile, self.multiplier, self.min_time_ms
            ):
                with self._lock:
                    if (job_id, wid) in self._speculated:
                        continue
                    self._speculated.add((job_id, wid))
                if self._sched.speculative_launch(job_id, wid):
                    launched.append((job_id, wid))
                    if self._on_launch is not None:
                        try:
                            self._on_launch(job_id, wid)
                        except Exception:  # noqa: BLE001 - observer must not kill scan
                            pass
        return launched

    def speculated_count(self) -> int:
        with self._lock:
            return len(self._speculated)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="speculation-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.check_once()

"""Jobs, tasks, and the completion future.

Parity: ``core/.../scheduler/JobWaiter.scala:30`` -- per-task
``taskSucceeded(index, result)`` invoking the job's ``resultHandler`` and a
completion future resolved when all tasks finish; ``ActiveJob`` /
``ResultTask`` carry (job id, partition/worker id, function).

Device mapping: a "task" is a host closure that launches kernels on
one worker's device (plus any injected delay); the "cluster" it runs on is the
in-process :class:`ExecutorPool`.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_job_ids = itertools.count()


@dataclass
class TaskSpec:
    """One unit of work bound to a logical worker.

    ``speculative`` marks a duplicate copy launched by the speculation
    monitor: its success merges normally (first completion wins) but its
    *failure* is dropped -- the healthy primary is still running and must not
    be retried or counted against the job's attempt budget.  The flag also
    keeps the copy from comparing equal to the primary's in-flight entry.
    """

    job_id: int
    worker_id: int
    fn: Callable[[], Any]
    attempt: int = 0
    speculative: bool = False


class JobWaiter:
    """Completion future for a job; streams per-task results to a handler.

    ``result_handler(worker_id, result)`` runs on the completing executor's
    thread (parity: Spark's handler runs on the DAG event loop) -- handlers
    must therefore be thread-safe; in this framework the canonical handler is
    ``AsyncContext.merge_result`` which is.
    """

    def __init__(
        self,
        job_id: int,
        worker_ids: List[int],
        result_handler: Callable[[int, Any], None],
    ):
        self.job_id = job_id
        self._expected = set(worker_ids)
        self._claimed: set = set()   # first completion claims the worker slot
        self._handled: set = set()   # handler has fully run for the worker
        self._failed: Optional[BaseException] = None
        self._handler = result_handler
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._failure_cbs: List[Callable[[BaseException], None]] = []
        if not self._expected:
            self._done.set()  # zero-task job is trivially complete

    def is_claimed(self, worker_id: int) -> bool:
        """True when some completion (primary or speculative) already claimed
        this worker's slot -- a late failure of the other copy is then moot."""
        with self._lock:
            return worker_id in self._claimed

    def task_succeeded(self, worker_id: int, result: Any) -> bool:
        """Returns True when this completion claimed the worker's slot
        (False = a duplicate; the other copy already won the race)."""
        with self._lock:
            if worker_id in self._claimed:
                return False  # duplicate (speculative copy lost the race)
            self._claimed.add(worker_id)
        # Handler runs outside the lock but BEFORE the worker counts toward
        # completion: await_result must never release while a claimed
        # result is still being merged.
        self._handler(worker_id, result)
        with self._lock:
            self._handled.add(worker_id)
            if self._handled >= self._expected:
                self._done.set()
        return True

    def job_failed(self, exc: BaseException) -> None:
        with self._lock:
            self._failed = exc
            self._done.set()
            cbs = list(self._failure_cbs)
        for cb in cbs:
            cb(exc)

    def on_failure(self, cb: Callable[[BaseException], None]) -> None:
        """Register a callback invoked (once) if the job aborts.

        Fires immediately when the job has already failed -- async submitters
        use this to release resources (e.g. un-busy a cohort) without polling.
        """
        with self._lock:
            if self._failed is None:
                self._failure_cbs.append(cb)
                return
            exc = self._failed
        cb(exc)

    def await_result(self, timeout: Optional[float] = None) -> None:
        """Block until every task has merged (mode-0 / first-iteration path).

        Raises the job's failure if any task exhausted its retries.
        """
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"job {self.job_id} did not complete in {timeout}s")
        if self._failed is not None:
            raise self._failed

    @property
    def completed(self) -> bool:
        return self._done.is_set() and self._failed is None

    @property
    def failed(self) -> Optional[BaseException]:
        return self._failed


@dataclass
class Job:
    """An active job: one task per cohort worker."""

    job_id: int
    tasks: Dict[int, TaskSpec]
    waiter: JobWaiter

    @staticmethod
    def create(
        worker_fns: Dict[int, Callable[[], Any]],
        result_handler: Callable[[int, Any], None],
    ) -> "Job":
        job_id = next(_job_ids)
        tasks = {
            wid: TaskSpec(job_id=job_id, worker_id=wid, fn=fn)
            for wid, fn in worker_fns.items()
        }
        waiter = JobWaiter(job_id, list(worker_fns), result_handler)
        return Job(job_id, tasks, waiter)

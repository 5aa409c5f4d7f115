"""The job scheduler: non-blocking submission is the core ASYNC mechanism.

Parity (the heart of the reference delta):
- ``DAGScheduler.scala:139-145`` -- ``mode`` (0 sync / 1 async) and
  ``first_iter`` flags, set from user code via ``SparkContext.set_mode``
  (``SparkContext.scala:89-101``).
- ``DAGScheduler.scala:641-663`` -- ``runJob`` blocks on the waiter when
  ``mode==0 || first_iter``, and returns immediately after submission when
  ``mode==1``; per-task results flow through the result handler either way.
- Task retry on failure: ``TaskSetManager`` resubmits a failed task up to
  ``maxTaskFailures`` then aborts the job.

Design deltas: ``mode`` is per-scheduler state settable per submission (not a
process-global), and the first-iteration block is an explicit, documented
warm-up (it is what builds the CUDA kernels here, exactly analogous to
the reference warming its block/broadcast caches).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from asyncframework_tpu_torch.engine.blacklist import BlacklistTracker
from asyncframework_tpu_torch.engine.executor import DeviceExecutor, ExecutorPool
from asyncframework_tpu_torch.engine.job import Job, JobWaiter, TaskSpec
from asyncframework_tpu_torch.utils.clock import Clock, SystemClock

SYNC = 0
ASYNC = 1


class JobScheduler:
    """Submits per-worker tasks to an :class:`ExecutorPool`; owns retry policy.

    One scheduler per training context.  Thread-safe: submissions come from
    the driver thread; status updates arrive on executor threads.
    """

    def __init__(
        self,
        num_workers: int,
        devices: Optional[List] = None,
        max_task_failures: int = 4,
        clock: Optional[Clock] = None,
        pool: Optional[ExecutorPool] = None,
        blacklist: Optional[BlacklistTracker] = None,
    ):
        self.num_workers = num_workers
        self.max_task_failures = max_task_failures
        self._clock = clock or SystemClock()
        self._mode = SYNC
        self._first_iter = True
        self._lock = threading.Lock()
        self._active_jobs: Dict[int, Job] = {}
        # in-flight task registry for resubmission on executor death:
        # worker_id -> list of TaskSpec currently launched there
        self._inflight: Dict[int, List[TaskSpec]] = {}
        # speculation bookkeeping: launch stamps + finished durations per job
        self._launch_ms: Dict[Tuple[int, int], float] = {}
        self._finished_ms: Dict[int, List[float]] = {}
        self._spec_wins = 0  # speculative copies that beat their primary
        self.blacklist = blacklist
        self.pool = pool or ExecutorPool(
            num_workers, self._status_update, devices=devices, clock=self._clock
        )

    @property
    def clock(self) -> Clock:
        return self._clock

    # ------------------------------------------------------------------ mode
    def set_mode(self, mode: int) -> None:
        """Parity: ``SparkContext.set_mode`` -> ``dagScheduler.set_mode``."""
        if mode not in (SYNC, ASYNC):
            raise ValueError(f"mode must be {SYNC} or {ASYNC}, got {mode}")
        self._mode = mode

    def get_mode(self) -> int:
        return self._mode

    # ---------------------------------------------------------------- submit
    def run_job(
        self,
        worker_fns: Dict[int, Callable[[], Any]],
        result_handler: Callable[[int, Any], None],
        timeout: Optional[float] = None,
    ) -> JobWaiter:
        """Submit one task per cohort worker.

        Blocking iff ``mode==SYNC`` or this is the scheduler's first job
        (``DAGScheduler.scala:641-663`` semantics).  Returns the waiter either
        way so sync callers can inspect it and async callers can ignore it.
        """
        job = Job.create(worker_fns, result_handler)
        with self._lock:
            self._active_jobs[job.job_id] = job
        for wid, task in job.tasks.items():
            self._launch(wid, task)
        block = self._mode == SYNC or self._first_iter
        self._first_iter = False
        if block:
            job.waiter.await_result(timeout=timeout)
            with self._lock:
                self._active_jobs.pop(job.job_id, None)
        return job.waiter

    def _launch(self, worker_id: int, task: TaskSpec) -> None:
        with self._lock:
            ex = self.pool.executors[worker_id]
            if not ex.alive:
                ex = self.pool.replace(worker_id)
            elif (
                self.blacklist is not None
                and self.blacklist.is_blacklisted(worker_id)
            ):
                # blacklisted slot: swap in a fresh executor before offering
                # it more work (the in-process analog of scheduling elsewhere); the
                # swap heals the slot, so clear the entry -- without this,
                # every launch in the timeout window would churn executors
                ex = self.pool.replace(worker_id)
                self.blacklist.clear(worker_id)
            else:
                # healthy slot: route to its least-loaded executor (equals
                # the primary unless dynamic allocation added siblings).
                # Pick + enqueue happen atomically under the POOL lock so a
                # concurrent sibling retirement cannot shut the chosen
                # executor down in between (see ExecutorPool.launch_on_slot)
                ex = None
            self._inflight.setdefault(worker_id, []).append(task)
            self._launch_ms[(task.job_id, worker_id)] = self._clock.now_ms()
        if ex is not None:
            ex.launch_task(task)
        else:
            self.pool.launch_on_slot(worker_id, task)

    # -------------------------------------------------------- status updates
    def _status_update(
        self,
        executor: DeviceExecutor,
        task: TaskSpec,
        result: Any,
        exc: Optional[BaseException],
    ) -> None:
        """Runs on the executor thread (Spark's ``statusUpdate`` path)."""
        with self._lock:
            job = self._active_jobs.get(task.job_id)
            if not task.speculative:
                lst = self._inflight.get(task.worker_id, [])
                if task in lst:
                    lst.remove(task)
                start = self._launch_ms.pop((task.job_id, task.worker_id), None)
                # record only while the job is live: a losing primary landing
                # after completion must not resurrect the entry (leak)
                if start is not None and exc is None and job is not None:
                    self._finished_ms.setdefault(task.job_id, []).append(
                        self._clock.now_ms() - start
                    )
        if self.pool.is_spare(executor):
            self.pool.discard_spare(executor)  # one speculative copy, one task
        if task.speculative and exc is not None:
            return  # copy failed; the healthy primary is still running
        if exc is not None and self.blacklist is not None:
            self.blacklist.record_failure(task.worker_id)
        if job is None:
            return  # job already finished/aborted (e.g. sync caller gone)
        if exc is not None and job.waiter.is_claimed(task.worker_id):
            # primary failed after its speculative copy already delivered the
            # result: nothing to retry, and certainly nothing to abort
            return
        if exc is None:
            won = job.waiter.task_succeeded(task.worker_id, result)
            if task.speculative and won:
                # the copy beat the (straggling) primary -- the observable
                # payoff of TaskSetManager-style speculation
                with self._lock:
                    self._spec_wins += 1
            if job.waiter.completed:
                with self._lock:
                    self._active_jobs.pop(task.job_id, None)
                    self._finished_ms.pop(task.job_id, None)
        else:
            self._retry_or_abort(job, task, exc)

    def _retry_or_abort(self, job: Job, task: TaskSpec, exc: BaseException) -> None:
        if task.attempt + 1 >= self.max_task_failures:
            job.waiter.job_failed(
                RuntimeError(
                    f"task for worker {task.worker_id} in job {job.job_id} failed "
                    f"{task.attempt + 1} times; aborting job"
                )
            )
            with self._lock:
                self._active_jobs.pop(job.job_id, None)
                self._finished_ms.pop(job.job_id, None)
            return
        retry = TaskSpec(
            job_id=task.job_id,
            worker_id=task.worker_id,
            fn=task.fn,
            attempt=task.attempt + 1,
        )
        self._launch(task.worker_id, retry)

    # ------------------------------------------------------------ speculation
    def speculative_wins(self) -> int:
        """Speculative copies whose result claimed the slot (copy beat the
        primary) -- the observable payoff of speculation."""
        with self._lock:
            return self._spec_wins

    def speculation_snapshot(self) -> Dict[int, Tuple[List[float], Dict[int, float]]]:
        """Per active job: (finished task durations, running task elapsed).

        Consumed by :class:`~asyncframework_tpu_torch.engine.speculation.SpeculationMonitor`.
        """
        now = self._clock.now_ms()
        with self._lock:
            out: Dict[int, Tuple[List[float], Dict[int, float]]] = {}
            for job_id in self._active_jobs:
                finished = list(self._finished_ms.get(job_id, []))
                running = {
                    wid: now - t
                    for (jid, wid), t in self._launch_ms.items()
                    if jid == job_id
                }
                out[job_id] = (finished, running)
            return out

    def speculative_launch(self, job_id: int, worker_id: int) -> bool:
        """Launch a copy of a running task on a spare executor (same device
        slot, fresh host thread).  First completion wins -- the
        :class:`JobWaiter` drops the loser.  Returns False when the task
        already finished (nothing to speculate)."""
        with self._lock:
            job = self._active_jobs.get(job_id)
            if job is None:
                return False
            orig = next(
                (t for t in self._inflight.get(worker_id, []) if t.job_id == job_id),
                None,
            )
            if orig is None:
                return False
        copy = TaskSpec(
            job_id=job_id, worker_id=worker_id, fn=orig.fn,
            attempt=orig.attempt, speculative=True,
        )
        spare = self.pool.spawn_spare(worker_id)
        spare.launch_task(copy)
        return True

    # ------------------------------------------------------- failure recovery
    def on_executor_lost(self, worker_id: int) -> None:
        """Resubmit every in-flight task of a dead worker on a replacement.

        Parity: ``DAGScheduler`` resubmitting tasks on executor loss; invoked
        by the heartbeat monitor (engine/heartbeat.py).
        """
        with self._lock:
            lost = self._inflight.pop(worker_id, [])
        self.pool.replace(worker_id)
        for task in lost:
            with self._lock:
                active = self._active_jobs.get(task.job_id)
            if active is not None and active.waiter.is_claimed(task.worker_id):
                with self._lock:
                    # nothing will relaunch or report this task: drop its
                    # launch stamp or speculation_snapshot sees a phantom
                    # forever-running task
                    self._launch_ms.pop((task.job_id, task.worker_id), None)
                continue  # a speculative copy already delivered this result
            retry = TaskSpec(
                job_id=task.job_id,
                worker_id=task.worker_id,
                fn=task.fn,
                attempt=task.attempt + 1,
            )
            if retry.attempt >= self.max_task_failures:
                with self._lock:
                    job = self._active_jobs.pop(task.job_id, None)
                    self._finished_ms.pop(task.job_id, None)
                if job is not None:
                    job.waiter.job_failed(
                        RuntimeError(
                            f"worker {worker_id} lost with task at max attempts"
                        )
                    )
            else:
                self._launch(worker_id, retry)

    def on_sibling_lost(self, worker_id: int, queued, running) -> None:
        """Resubmit a failed dynamic-allocation sibling's own tasks.

        ``queued`` never started: relaunch at the SAME attempt.  ``running``
        died mid-task: bump its attempt (one real failure), abort the job
        at ``max_task_failures`` exactly like the slot-loss path.  The
        healthy primary's in-flight tasks are untouched.
        """
        # drop the sibling's entries from the in-flight registry first
        # (identity match): _launch re-registers each relaunch, and a stale
        # duplicate would look forever-running to the speculation monitor
        # and get re-executed on a later primary loss
        with self._lock:
            gone = {id(t) for t in queued}
            if running is not None:
                gone.add(id(running))
            inflight = self._inflight.get(worker_id, [])
            self._inflight[worker_id] = [
                t for t in inflight if id(t) not in gone
            ]
        for task in queued:
            self._launch(worker_id, task)
        if running is None:
            return
        with self._lock:
            active = self._active_jobs.get(running.job_id)
        if active is not None and active.waiter.is_claimed(running.worker_id):
            with self._lock:
                self._launch_ms.pop(
                    (running.job_id, running.worker_id), None
                )
            return  # another copy already delivered this result
        retry = TaskSpec(
            job_id=running.job_id,
            worker_id=running.worker_id,
            fn=running.fn,
            attempt=running.attempt + 1,
        )
        if retry.attempt >= self.max_task_failures:
            with self._lock:
                job = self._active_jobs.pop(running.job_id, None)
                self._finished_ms.pop(running.job_id, None)
            if job is not None:
                job.waiter.job_failed(
                    RuntimeError(
                        f"sibling on slot {worker_id} lost with task at "
                        "max attempts"
                    )
                )
        else:
            self._launch(worker_id, retry)

    def shutdown(self) -> None:
        self.pool.shutdown()

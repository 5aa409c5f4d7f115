"""Partial-barrier cohort selection.

Parity: ``RDD.ASYNCbarrier`` (``rdd/RDD.scala:1050-1077``): given a predicate
over per-worker state and the driver's state table, select the workers that
participate in the next round; workers with no table entry yet (cold start)
are always selected.  The reference materializes the selection as a global
``RDD.WorkerList`` consumed by ``mapPartitionsWithIndex``; here the cohort is
a returned value (no global mutable state) that the solver passes to
``JobScheduler.run_job``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Union

from asyncframework_tpu_torch.context import AsyncContext, WorkerState


def partial_barrier(
    ctx: AsyncContext,
    workers: Union[int, Sequence[int]],
    predicate: Callable[[WorkerState], bool],
) -> List[int]:
    """Return the cohort: workers whose state passes ``predicate`` AND are
    available, plus workers never seen (no STAT entry).

    ``workers`` is either a worker count (ids ``0..n-1``) or an explicit id
    sequence (for datasets with non-contiguous partition ids).
    """
    ids = range(workers) if isinstance(workers, int) else workers
    cohort: List[int] = []
    states = ctx.states()
    for wid in ids:
        ws = states.get(wid)
        if ws is None:
            cohort.append(wid)
        elif predicate(ws) and ws.available:
            cohort.append(wid)
    return cohort


def bucket_predicate(ctx: AsyncContext, num_workers: int, bucket_ratio: float):
    """The drivers' predicate: enough of the fleet is available.

    Parity: ``SparkASGDThread.scala:282`` --
    ``state.getAvailableWorkers() >= floor(numPart * bucketRatio)``.
    """
    threshold = math.floor(num_workers * bucket_ratio)

    def pred(_ws: WorkerState) -> bool:
        return ctx.available_workers() >= threshold

    return pred

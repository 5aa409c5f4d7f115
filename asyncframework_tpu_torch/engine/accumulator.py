"""Accumulators: write-only shared counters updated from task closures.

Parity: ``AccumulatorV2`` (``core/.../util/AccumulatorV2.scala``) --
``LongAccumulator`` / ``DoubleAccumulator`` / ``CollectionAccumulator``,
added to from tasks, read on the driver.  The reference ships per-task
accumulator deltas back in task results and merges on the DAG event loop;
here tasks run in executor threads of the same process, so an accumulator is
a lock-guarded cell the closure captures directly -- same API, and `add` is
thread-safe against concurrent tasks (the semantics Spark only guarantees
via its merge protocol).

Spark's caveat carries over deliberately: a task that is retried or
speculatively duplicated may double-count (only the reference's *internal*
metrics accumulators de-duplicate; user accumulators there double-count on
resubmission too).
"""

from __future__ import annotations

import threading
from typing import Any, Generic, List, TypeVar

T = TypeVar("T")


class Accumulator(Generic[T]):
    """Base: subclasses define ``_zero`` and ``_combine``."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._value: T = self._zero()

    def _zero(self) -> T:
        raise NotImplementedError

    def _combine(self, cur: T, update) -> T:
        raise NotImplementedError

    def add(self, update) -> None:
        with self._lock:
            self._value = self._combine(self._value, update)

    def merge(self, other: "Accumulator[T]") -> None:
        """Fold another accumulator in (multi-host: one per host, merged).

        The other's value is snapshotted BEFORE taking our lock: holding
        both would deadlock on self-merge and ABBA-deadlock on concurrent
        cross-merges.
        """
        snapshot = other.value
        with self._lock:
            self._value = self._combine(self._value, snapshot)

    def reset(self) -> None:
        with self._lock:
            self._value = self._zero()

    @property
    def value(self) -> T:
        with self._lock:
            return self._value

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.name!r}, value={self.value!r})"


class LongAccumulator(Accumulator[int]):
    """Sum + count (so ``avg`` works), like the reference's LongAccumulator."""

    def __init__(self, name: str = ""):
        self._count = 0
        super().__init__(name)

    def _zero(self) -> int:
        return 0

    def _combine(self, cur: int, update) -> int:
        return cur + int(update)

    def add(self, update) -> None:
        with self._lock:
            self._value = self._combine(self._value, update)
            self._count += 1

    def merge(self, other: "LongAccumulator") -> None:
        # one acquisition of other's lock: (sum, count) must not tear
        with other._lock:
            v, c = other._value, other._count
        with self._lock:
            self._value += v
            self._count += c

    def reset(self) -> None:
        with self._lock:
            self._value = 0
            self._count = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def avg(self) -> float:
        with self._lock:
            return self._value / self._count if self._count else 0.0


class DoubleAccumulator(Accumulator[float]):
    def _zero(self) -> float:
        return 0.0

    def _combine(self, cur: float, update) -> float:
        return cur + float(update)


class CollectionAccumulator(Accumulator[List[Any]]):
    def _zero(self) -> List[Any]:
        return []

    def _combine(self, cur: List[Any], update) -> List[Any]:
        if isinstance(update, list):
            return cur + update
        return cur + [update]

    def merge(self, other: "Accumulator[List[Any]]") -> None:
        snapshot = list(other.value)
        with self._lock:
            self._value = self._value + snapshot


class MaxAccumulator(Accumulator[float]):
    """Running maximum (handy for staleness/latency high-water marks)."""

    def _zero(self) -> float:
        return float("-inf")

    def _combine(self, cur: float, update) -> float:
        return max(cur, float(update))

"""Distributed dataset: the user-facing partitioned-collection API (L5).

Parity (studied, not copied): the reference's RDD surface --
transformations ``map`` / ``filter`` / ``mapPartitions`` / ``sample``
(``rdd/RDD.scala:488``) / ``zipWithIndex`` (``rdd/RDD.scala:1527``), actions
``reduce`` / ``aggregate`` (``rdd/RDD.scala:1227-1261``) / ``treeAggregate``
(``rdd/RDD.scala:1358+``) / ``count`` / ``collect``, caching, and the ASYNC
delta ops ``ASYNCreduce`` (``rdd/RDD.scala:1087-1171``), ``ASYNCaggregate``
(``rdd/RDD.scala:1268-1345``) and ``ASYNCbarrier`` (``rdd/RDD.scala:1050-1077``).

Design deltas (the JAX package's, kept by this copy of its
``data/dataset.py``):
- A partition is a lazily-computed payload produced by a compute closure; the
  closure runs on the partition's worker (an executor thread owning a device
  slot), so a payload is typically a ``torch.Tensor`` batch resident in that
  worker's device memory -- lineage is closure composition, not a DAG of
  shuffle files.
- Payloads are iterables of elements.  Device-array users produce one-element
  payloads (e.g. ``[gradient]``) via :meth:`map_partitions`; the engine never
  forces a host transfer -- reduction combines whatever the elements are.
- ``ASYNCbarrier``'s global mutable ``RDD.WorkerList`` (``rdd/RDD.scala:2152``)
  is replaced by an explicit cohort value: :meth:`barrier` *returns* the
  selected worker ids, and the async actions take a ``cohort`` argument.
- The driver-side merge in ``ASYNCreduce``'s ``mergeResult`` callback
  (staleness stamp, STAT update, clock bump -- ``rdd/RDD.scala:1144-1165``)
  is ``AsyncContext.merge_result`` here, invoked from the completing
  executor's thread exactly as the reference invokes it from the DAG
  event-loop thread.

What differs from the JAX package: :meth:`DistributedDataset.from_array_pairs`
places blocks on the scheduler's devices (the card by default, raising
without one; the CPU under ``ASYNCTPU_FORCE_CPU``), and a checkpoint stores
tensors as host numpy, so a checkpoint directory written by either package
loads in the other.
"""

from __future__ import annotations

import bisect
import pickle
import threading
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
    TypeVar,
)

import numpy as np

from asyncframework_tpu_torch.context import AsyncContext, WorkerState
from asyncframework_tpu_torch.data.pairs import PairOpsMixin
from asyncframework_tpu_torch.engine.barrier import partial_barrier
from asyncframework_tpu_torch.engine.job import JobWaiter
from asyncframework_tpu_torch.engine.scheduler import ASYNC, SYNC, JobScheduler

E = TypeVar("E")
U = TypeVar("U")


class DistributedDataset(PairOpsMixin, Generic[E]):
    """A partitioned collection whose partitions compute on engine workers.

    Construction is cheap and lazy; partition payloads materialize only when
    an action runs (or :meth:`cache` pins them).  Transformations compose
    compute closures -- the functional-lineage analog of RDD chaining.
    """

    def __init__(
        self,
        scheduler: JobScheduler,
        parts: Dict[int, Callable[[], Iterable[E]]],
    ):
        bad = [wid for wid in parts if not 0 <= wid < scheduler.num_workers]
        if bad:
            raise ValueError(
                f"partition ids {bad} out of range for a "
                f"{scheduler.num_workers}-worker scheduler (a partition is "
                f"pinned to the worker with its id)"
            )
        self.scheduler = scheduler
        self._parts = dict(parts)
        self._cache: Optional[Dict[int, List[E]]] = None
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_list(
        cls,
        scheduler: JobScheduler,
        data: Sequence[E],
        num_partitions: Optional[int] = None,
    ) -> "DistributedDataset[E]":
        """``sc.parallelize`` analog: contiguous balanced split of a sequence."""
        p = num_partitions or scheduler.num_workers
        if p > scheduler.num_workers:
            raise ValueError(
                f"num_partitions={p} exceeds num_workers="
                f"{scheduler.num_workers}; partitions are worker-pinned"
            )
        n = len(data)
        sizes = [n // p + (1 if i < n % p else 0) for i in range(p)]
        parts: Dict[int, Callable[[], Iterable[E]]] = {}
        lo = 0
        for wid, s in enumerate(sizes):
            chunk = list(data[lo : lo + s])
            parts[wid] = (lambda c=chunk: c)
            lo += s
        return cls(scheduler, parts)

    @classmethod
    def from_partitions(
        cls,
        scheduler: JobScheduler,
        payloads: Dict[int, Iterable[E]],
    ) -> "DistributedDataset[E]":
        return cls(
            scheduler,
            {wid: (lambda p=list(pl): p) for wid, pl in payloads.items()},
        )

    @classmethod
    def from_array_pairs(
        cls,
        scheduler: JobScheduler,
        blocks: Dict[int, Tuple],
        devices: Optional[Sequence] = None,
    ) -> "DistributedDataset":
        """Column-format pair partitions for the DEVICE shuffle path: each
        partition's payload is ONE element -- a ``(keys, values)`` pair of
        tensors on the partition's device (``devices``, else the
        scheduler's, else the card; raises without one unless
        ``ASYNCTPU_FORCE_CPU`` asks for the CPU).  Tensors keep their
        dtype (the JAX package narrows int64 to int32 without x64).
        ``reduce_by_key`` with a string op then shuffles on the device
        (ops/shuffle.py)."""
        import torch

        from asyncframework_tpu_torch.utils.devices import entry_devices

        if devices is None:
            devices = getattr(scheduler, "devices", None)
        devs = entry_devices(devices)
        placed: Dict[int, List] = {}
        for wid, (k, v) in blocks.items():
            dev = devs[wid % len(devs)]
            placed[wid] = [tuple(
                x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev)
                for x in (k, v)
            )]
        return cls(
            scheduler,
            {wid: (lambda p=pl: p) for wid, pl in placed.items()},
        )

    # ---------------------------------------------------------------- plumbing
    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def partition_ids(self) -> List[int]:
        return sorted(self._parts)

    def _compute(self, wid: int) -> List[E]:
        """Materialize one partition (on the calling thread).

        Cache hits return a fresh list (shallow copy) so downstream in-place
        list mutation cannot corrupt the cached payload.  The cache dict is
        captured once per call: :meth:`checkpoint` may null ``_cache`` from
        another thread mid-action (writing into the dead dict is harmless).
        """
        cache = self._cache
        if cache is not None:
            with self._cache_lock:
                hit = cache.get(wid)
            if hit is not None:
                return list(hit)
        out = list(self._parts[wid]())
        if cache is not None:
            with self._cache_lock:
                cache[wid] = out
                out = list(out)
        return out

    def cache(self) -> "DistributedDataset[E]":
        """Pin computed payloads (``RDD.cache`` parity: compute-once)."""
        if self._cache is None:
            self._cache = {}
        return self

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self, directory: str) -> "DistributedDataset[E]":
        """Materialize every partition to reliable storage and TRUNCATE
        lineage.

        Parity: ``RDD.checkpoint`` (``rdd/RDD.scala:1773``) +
        ``ReliableCheckpointRDD`` (``rdd/ReliableCheckpointRDD.scala:38``) --
        after this call the (possibly long) upstream closure chain is cut:
        this dataset's partitions read back from ``directory``, upstream
        compute never runs again, and the data survives process restart via
        :meth:`from_checkpoint`.  Two deliberate deltas from the reference:
        materialization is EAGER (the reference defers to the end of the
        next job -- with lazy closures there is no "next job" hook worth the
        surprise), and payload device arrays are stored as host numpy (a
        restarted process re-places them; device residency is a property of
        the worker, not the bytes).

        Layout (FsHistoryProvider-style): ``part-NNNNN.pkl`` per partition,
        ``_meta.json``, then a ``_SUCCESS`` marker written LAST -- a reader
        never trusts a directory without it (torn writes are invisible).
        """
        import json
        import os

        os.makedirs(directory, exist_ok=True)
        # invalidate any previous checkpoint FIRST: a crash mid-rewrite must
        # never leave an old _SUCCESS blessing a torn mix of old/new parts
        for marker in ("_SUCCESS", "_meta.json"):
            try:
                os.remove(os.path.join(directory, marker))
            except FileNotFoundError:
                pass

        def write_part(wid: int):
            # runs ON the partition's worker: one partition in memory at a
            # time per worker (ReliableCheckpointRDD writes per-task too),
            # not the whole dataset staged on the driver
            def task():
                payload = self._compute(wid)
                path = os.path.join(directory, f"part-{wid:05d}.pkl")
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(
                        [_payload_to_host(e) for e in payload],
                        f,
                        protocol=pickle.HIGHEST_PROTOCOL,
                    )
                os.replace(tmp, path)
                return wid

            return task

        written = self._run_sync(write_part)
        meta = {"format": 1, "partitions": sorted(written)}
        with open(os.path.join(directory, "_meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(directory, "_SUCCESS"), "w") as f:
            f.write("")
        # lineage truncation: from here on, partitions come from disk
        with self._cache_lock:
            self._parts = {
                wid: _checkpoint_loader(directory, wid) for wid in written
            }
            self._cache = None  # payloads may be large; disk is the pin now
        return self

    @classmethod
    def from_checkpoint(
        cls, scheduler: JobScheduler, directory: str
    ) -> "DistributedDataset[E]":
        """Reconstruct a checkpointed dataset in a (possibly new) process."""
        import json
        import os

        if not os.path.exists(os.path.join(directory, "_SUCCESS")):
            raise FileNotFoundError(
                f"no complete checkpoint at {directory!r} (missing _SUCCESS)"
            )
        with open(os.path.join(directory, "_meta.json")) as f:
            meta = json.load(f)
        return cls(
            scheduler,
            {
                int(wid): _checkpoint_loader(directory, int(wid))
                for wid in meta["partitions"]
            },
        )

    def _run_job_dict(
        self,
        fns: Dict[int, Callable[[], Any]],
        timeout: Optional[float] = None,
    ) -> Dict[int, Any]:
        """One blocking job from an explicit task dict; per-wid results."""
        results: Dict[int, Any] = {}
        lock = threading.Lock()

        def handler(wid: int, res: Any) -> None:
            with lock:
                results[wid] = res

        mode = self.scheduler.get_mode()
        self.scheduler.set_mode(SYNC)
        try:
            self.scheduler.run_job(fns, handler, timeout=timeout)
        finally:
            self.scheduler.set_mode(mode)
        return results

    def _run_sync(
        self,
        fn_of_wid: Callable[[int], Callable[[], Any]],
        timeout: Optional[float] = None,
    ) -> Dict[int, Any]:
        """One blocking job, one task per partition; collects per-wid results."""
        return self._run_job_dict(
            {wid: fn_of_wid(wid) for wid in self.partition_ids()},
            timeout=timeout,
        )

    # --------------------------------------------------------- transformations
    def map_partitions(
        self, f: Callable[[List[E]], Iterable[U]]
    ) -> "DistributedDataset[U]":
        return DistributedDataset(
            self.scheduler,
            {
                wid: (lambda w=wid: f(self._compute(w)))
                for wid in self._parts
            },
        )

    def map(self, f: Callable[[E], U]) -> "DistributedDataset[U]":
        return self.map_partitions(lambda xs: [f(x) for x in xs])

    def flat_map(self, f: Callable[[E], Iterable[U]]) -> "DistributedDataset[U]":
        """``RDD.flatMap`` parity: one-to-many element expansion."""
        return self.map_partitions(
            lambda xs: [y for x in xs for y in f(x)]
        )

    def filter(self, pred: Callable[[E], bool]) -> "DistributedDataset[E]":
        return self.map_partitions(lambda xs: [x for x in xs if pred(x)])

    def union(self, other: "DistributedDataset[E]") -> "DistributedDataset[E]":
        """``RDD.union`` parity: partition-wise concatenation (both datasets
        are worker-pinned, so partition ``wid`` unions with partition
        ``wid``; a partition present in only one side passes through)."""
        if other.scheduler is not self.scheduler:
            raise ValueError("union requires datasets on the same scheduler")
        parts: Dict[int, Callable[[], Iterable[E]]] = {}
        for wid in sorted(set(self._parts) | set(other._parts)):
            def compute(w=wid):
                out: List[E] = []
                if w in self._parts:
                    out.extend(self._compute(w))
                if w in other._parts:
                    out.extend(other._compute(w))
                return out

            parts[wid] = compute
        return DistributedDataset(self.scheduler, parts)

    def distinct(self) -> "DistributedDataset[E]":
        """``RDD.distinct`` parity.  The reference shuffles by key so each
        value lands on one partition; worker-pinned partitions have no
        shuffle, so dedup is two-phase: per-partition local dedup in the
        tasks, then a driver-side global pass that keeps each value's first
        (lowest-partition) occurrence and re-pins survivors in place."""
        local = self._run_sync(
            lambda wid: (lambda w=wid: list(dict.fromkeys(self._compute(w))))
        )
        seen: set = set()
        payloads: Dict[int, List[E]] = {}
        for wid in sorted(local):
            keep = [x for x in local[wid] if not (x in seen or seen.add(x))]
            payloads[wid] = keep
        return DistributedDataset.from_partitions(self.scheduler, payloads)

    def sample(self, fraction: float, seed: int) -> "DistributedDataset[E]":
        """Per-partition Bernoulli sampling, deterministic in (seed, wid).

        Parity: ``RDD.sample(false, b, seed)`` backed by
        ``PartitionwiseSampledRDD`` -- independent per-partition streams from
        a shared seed.
        """
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")

        def sampler(wid: int) -> Callable[[], Iterable[E]]:
            def compute() -> Iterable[E]:
                from asyncframework_tpu_torch.data.pairs import partition_draws

                xs = self._compute(wid)
                mask = partition_draws(seed, wid, len(xs)) < fraction
                return [x for x, m in zip(xs, mask) if m]

            return compute

        return DistributedDataset(
            self.scheduler, {wid: sampler(wid) for wid in self._parts}
        )

    def zip_with_index(self) -> "DistributedDataset[Tuple[E, int]]":
        """Global contiguous indices; runs a count job for partition offsets
        (parity: ``zipWithIndex`` launching its size-scan job,
        ``rdd/ZippedWithIndexRDD``)."""
        sizes = self._run_sync(
            lambda wid: (lambda w=wid: len(self._compute(w)))
        )
        offsets: Dict[int, int] = {}
        acc = 0
        for wid in self.partition_ids():
            offsets[wid] = acc
            acc += sizes[wid]

        def indexer(wid: int) -> Callable[[], Iterable[Tuple[E, int]]]:
            def compute() -> Iterable[Tuple[E, int]]:
                xs = self._compute(wid)
                base = offsets[wid]
                return [(x, base + j) for j, x in enumerate(xs)]

            return compute

        return DistributedDataset(
            self.scheduler, {wid: indexer(wid) for wid in self._parts}
        )

    def glom(self) -> "DistributedDataset[List[E]]":
        """``RDD.glom`` parity: each partition becomes one list element."""
        return self.map_partitions(lambda xs: [xs])

    def key_by(self, f: Callable[[E], Any]) -> "DistributedDataset":
        """``RDD.keyBy`` parity: element -> (f(element), element)."""
        return self.map(lambda x: (f(x), x))

    def coalesce(self, num_partitions: int) -> "DistributedDataset[E]":
        """``RDD.coalesce(n)`` parity (shuffle=false spirit): adjacent
        partitions concatenate into ``num_partitions`` groups, preserving
        element order; growing the partition count requires a reshuffle
        (use :meth:`partition_by` on keyed data)."""
        ids = self.partition_ids()
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        if num_partitions >= len(ids):
            return self
        groups: Dict[int, List[int]] = {i: [] for i in range(num_partitions)}
        for j, wid in enumerate(ids):
            groups[j * num_partitions // len(ids)].append(wid)

        def compute_group(members):
            def run(ms=tuple(members)):
                out: List[E] = []
                for w in ms:
                    out.extend(self._compute(w))
                return out

            return run

        return DistributedDataset(
            self.scheduler,
            {i: compute_group(m) for i, m in groups.items()},
        )

    def sort_by(
        self, key: Callable[[E], Any], ascending: bool = True,
        num_partitions: Optional[int] = None,
    ) -> "DistributedDataset[E]":
        """``RDD.sortBy`` parity, riding the pair layer's range-partitioned
        ``sort_by_key``."""
        return self.key_by(key).sort_by_key(
            ascending=ascending, num_partitions=num_partitions
        ).values()

    def count_by_value(self) -> Dict[E, int]:
        """``RDD.countByValue`` parity (driver-side dict)."""
        return self.map(lambda x: (x, 1)).count_by_key()

    def stats(self) -> "StatCounter":
        """``DoubleRDDFunctions.stats`` parity: one pass merging per-
        partition (count, mean, M2, min, max) with Chan's parallel-moments
        update -- the numerically stable merge ``StatCounter.scala`` uses."""
        def seq(acc: "StatCounter", x) -> "StatCounter":
            acc.merge_value(float(x))
            return acc

        def comb(a: "StatCounter", b: "StatCounter") -> "StatCounter":
            a.merge_stats(b)
            return a

        return self.aggregate(StatCounter(), seq, comb)

    def histogram(self, buckets):
        """``DoubleRDDFunctions.histogram`` parity.

        ``buckets`` int: ``buckets`` evenly spaced bins over [min, max],
        returns ``(bucket_edges, counts)``.  ``buckets`` sequence: custom
        edges (len B+1, ascending), returns counts only.  The last bucket
        is closed on the right (reference semantics); values outside custom
        edges are ignored.
        """
        if isinstance(buckets, int):
            if buckets < 1:
                raise ValueError("buckets must be >= 1")
            st = self.stats()
            if st.count == 0:
                raise ValueError("histogram of an empty dataset")
            lo, hi = st.min, st.max
            if not (np.isfinite(lo) and np.isfinite(hi)):
                # DoubleRDDFunctions.histogram parity: an infinite/NaN
                # range has no meaningful even buckets -- raise, never
                # fabricate a distribution
                raise ValueError(
                    f"histogram range is not finite: [{lo}, {hi}]"
                )
            edges = [
                lo + (hi - lo) * i / buckets for i in range(buckets + 1)
            ]
            # float rounding can land edges[-1] BELOW the true max (which
            # would silently drop the maximum values), and a range tiny
            # relative to |lo| can collapse interior edges entirely
            edges[-1] = hi
            if lo == hi or any(
                a >= b for a, b in zip(edges, edges[1:])
            ):
                # constant (or unresolvably narrow) data: one occupied
                # bucket with edges spaced representably at lo's magnitude
                span = max(1.0, abs(lo) * 1e-9)
                edges = [lo + span * i for i in range(buckets + 1)]
                counts = [0] * buckets
                counts[0] = int(st.count)
                return edges, counts
            return edges, self.histogram(edges)
        edges = [float(b) for b in buckets]
        if len(edges) < 2 or any(
            a >= b for a, b in zip(edges, edges[1:])
        ):
            raise ValueError("bucket edges must be ascending, len >= 2")
        nb = len(edges) - 1

        def seq(counts, x):
            x = float(x)
            if edges[0] <= x <= edges[-1]:
                # right-closed last bucket, like the reference
                i = min(bisect.bisect_right(edges, x) - 1, nb - 1)
                counts[i] += 1
            return counts

        def comb(a, b):
            return [x + y for x, y in zip(a, b)]

        return self.aggregate([0] * nb, seq, comb)

    def count_approx_distinct(self, relative_sd: float = 0.05) -> int:
        """``RDD.countApproxDistinct`` parity: per-partition HyperLogLog
        sketches merged on the driver (register-max is the shuffle-free
        combine).  ``relative_sd`` sets the register count like the
        reference maps it to HLL precision."""
        import math

        from asyncframework_tpu_torch.utils.sketch import HyperLogLog

        p = int(math.ceil(2 * math.log2(1.04 / relative_sd)))
        if p > 18:
            raise ValueError(
                f"relative_sd={relative_sd} needs HLL precision p={p} > 18; "
                "the achievable floor is ~0.0021"
            )
        p = max(p, 4)

        def sketch(wid: int):
            def run(w=wid):
                h = HyperLogLog(p=p)
                xs = self._compute(w)
                if xs:
                    h.add(_hashable_u64(xs))
                return h

            return run

        per = self._run_sync(sketch)
        acc: Optional[object] = None
        for wid in self.partition_ids():
            acc = per[wid] if acc is None else acc.merge(per[wid])
        return int(round(acc.estimate())) if acc is not None else 0

    def take_sample(
        self, with_replacement: bool, num: int, seed: int = 42
    ) -> List[E]:
        """``RDD.takeSample`` parity: a fixed-size uniform sample collected
        to the driver."""
        if num < 0:
            raise ValueError("num must be >= 0")
        if num == 0:
            return []
        rs = np.random.default_rng(seed)
        allv = self.collect()
        if not allv:
            return []
        idx = rs.choice(len(allv), size=num, replace=with_replacement) \
            if (with_replacement or num <= len(allv)) \
            else rs.permutation(len(allv))
        return [allv[i] for i in np.atleast_1d(idx)[:num]]

    def fold(self, zero: E, op: Callable[[E, E], E]) -> E:
        """``RDD.fold`` parity: like reduce with a per-partition zero."""
        return self.aggregate(zero, op, op)

    def top(self, n: int, key: Optional[Callable[[E], Any]] = None) -> List[E]:
        """``RDD.top`` parity: n largest, descending (per-partition heads
        combined on the driver)."""
        import heapq

        k = key or (lambda x: x)
        per = self._run_sync(
            lambda wid: (
                lambda w=wid: heapq.nlargest(n, self._compute(w), key=k)
            )
        )
        allv = [x for wid in self.partition_ids() for x in per[wid]]
        return heapq.nlargest(n, allv, key=k)

    def take_ordered(
        self, n: int, key: Optional[Callable[[E], Any]] = None
    ) -> List[E]:
        """``RDD.takeOrdered`` parity: n smallest, ascending."""
        import heapq

        k = key or (lambda x: x)
        per = self._run_sync(
            lambda wid: (
                lambda w=wid: heapq.nsmallest(n, self._compute(w), key=k)
            )
        )
        allv = [x for wid in self.partition_ids() for x in per[wid]]
        return heapq.nsmallest(n, allv, key=k)

    def _lazy_elements(self) -> Callable[[], List[E]]:
        """Memoized deferred materialization of every element, computed
        DIRECTLY on the first caller's thread (not via scheduler jobs:
        transformations stay lazy like the rest of the file, and a nested
        job launched from inside a worker task could deadlock the pool)."""
        cell: Dict[str, List[E]] = {}
        lock = threading.Lock()

        def get() -> List[E]:
            with lock:
                if "v" not in cell:
                    cell["v"] = [
                        x
                        for wid in self.partition_ids()
                        for x in self._compute(wid)
                    ]
                return cell["v"]

        return get

    def subtract(self, other: "DistributedDataset[E]") -> "DistributedDataset[E]":
        """``RDD.subtract`` parity: elements of self not present in other
        (duplicates of surviving elements are preserved, like the
        reference's cogroup formulation).  Lazy: ``other`` materializes at
        first action, not at definition."""
        get_other = other._lazy_elements()
        return self.map_partitions(
            lambda xs: (lambda gone: [x for x in xs if x not in gone])(
                set(get_other())
            )
        )

    def intersection(
        self, other: "DistributedDataset[E]"
    ) -> "DistributedDataset[E]":
        """``RDD.intersection`` parity: distinct elements present in both."""
        get_other = other._lazy_elements()
        return self.distinct().map_partitions(
            lambda xs: (lambda have: [x for x in xs if x in have])(
                set(get_other())
            )
        )

    def cartesian(
        self, other: "DistributedDataset[U]"
    ) -> "DistributedDataset[Tuple[E, U]]":
        """``RDD.cartesian`` parity: partition (i) pairs with the WHOLE other
        dataset (the reference builds p*q partitions; worker-pinned
        partitions keep self's layout and broadcast other's rows)."""
        get_other = other._lazy_elements()
        return self.map_partitions(
            lambda xs: [(x, o) for x in xs for o in get_other()]
        )

    def barrier(
        self,
        ctx: AsyncContext,
        predicate: Callable[[WorkerState], bool],
    ) -> Tuple[List[int], "DistributedDataset[E]"]:
        """Partial barrier: select the cohort, empty out the rest.

        Parity: ``RDD.ASYNCbarrier`` -- non-selected partitions yield
        ``Iterator.empty`` (``rdd/RDD.scala:1066-1073``); the cohort is
        returned instead of written to the global ``RDD.WorkerList``.
        """
        cohort = partial_barrier(ctx, self.partition_ids(), predicate)
        in_cohort = set(cohort)

        def gate(wid: int) -> Callable[[], Iterable[E]]:
            def compute() -> Iterable[E]:
                return self._compute(wid) if wid in in_cohort else []

            return compute

        return cohort, DistributedDataset(
            self.scheduler, {wid: gate(wid) for wid in self._parts}
        )

    # ---------------------------------------------------------------- actions
    def collect(self) -> List[E]:
        per = self._run_sync(lambda wid: (lambda w=wid: self._compute(w)))
        out: List[E] = []
        for wid in self.partition_ids():
            out.extend(per[wid])
        return out

    def take(self, n: int) -> List[E]:
        """First ``n`` elements in partition order.

        ``RDD.take``-style incremental scan, collapsed to two rounds: probe
        the first partition alone (the common small-n case touches nothing
        else), then -- only if short -- compute every remaining partition in
        ONE parallel job instead of a sequential per-partition walk.
        """
        if n <= 0:
            return []
        ids = self.partition_ids()
        if not ids:
            return []
        first = self._run_job_dict(
            {ids[0]: (lambda w=ids[0]: self._compute(w))}
        )[ids[0]]
        out: List[E] = list(first[:n])
        if len(out) >= n or len(ids) == 1:
            return out
        rest = self._run_job_dict(
            {wid: (lambda w=wid: self._compute(w)) for wid in ids[1:]}
        )
        for wid in ids[1:]:
            out.extend(rest[wid][: n - len(out)])
            if len(out) >= n:
                break
        return out

    def first(self) -> E:
        got = self.take(1)
        if not got:
            raise ValueError("first() on an empty dataset")
        return got[0]

    def count(self) -> int:
        per = self._run_sync(lambda wid: (lambda w=wid: len(self._compute(w))))
        return sum(per.values())

    def reduce(self, op: Callable[[E, E], E]) -> E:
        """Local per-partition reduce, then driver-side merge in partition
        order (the reference's driver-mediated collective)."""
        per = self._run_sync(
            lambda wid: (lambda w=wid: _local_reduce(self._compute(w), op))
        )
        acc: Optional[E] = None
        for wid in self.partition_ids():
            got, nonempty = per[wid]
            if not nonempty:
                continue
            acc = got if acc is None else op(acc, got)
        if acc is None:
            raise ValueError("reduce on an empty dataset")
        return acc

    def aggregate(
        self,
        zero: U,
        seq_op: Callable[[U, E], U],
        comb_op: Callable[[U, U], U],
    ) -> U:
        import copy

        per = self._run_sync(
            lambda wid: (
                lambda w=wid: _local_aggregate(self._compute(w), zero, seq_op)
            )
        )
        acc = copy.deepcopy(zero)  # never mutate the caller's zero
        for wid in self.partition_ids():
            acc = comb_op(acc, per[wid])
        return acc

    def tree_aggregate(
        self,
        zero: U,
        seq_op: Callable[[U, E], U],
        comb_op: Callable[[U, U], U],
        depth: int = 2,
    ) -> U:
        """Multi-round combine (``treeAggregate`` parity).

        The reference inserts shuffle stages to halve the fan-in per round;
        here rounds are extra (tiny) jobs pair-combining partials on workers,
        keeping the driver's final fan-in bounded.  The device-native analog
        for sharded tensors is ``ops/collectives.py``'s all-reduce -- this is
        the host-payload path.
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        per = self._run_sync(
            lambda wid: (
                lambda w=wid: _local_aggregate(self._compute(w), zero, seq_op)
            )
        )
        partials = [per[wid] for wid in self.partition_ids()]
        for _ in range(depth - 1):
            if len(partials) <= 2:
                break
            pairs = [
                (partials[i], partials[i + 1])
                for i in range(0, len(partials) - 1, 2)
            ]
            tail = [partials[-1]] if len(partials) % 2 else []
            combined = self._run_job_dict(
                {
                    i: (lambda p=pair: comb_op(p[0], p[1]))
                    for i, pair in enumerate(pairs)
                }
            )
            partials = [combined[i] for i in range(len(pairs))] + tail
        import copy

        acc = copy.deepcopy(zero)  # never mutate the caller's zero
        for p in partials:
            acc = comb_op(acc, p)
        return acc

    # ------------------------------------------------------------- async delta
    def async_reduce(
        self,
        op: Callable[[E, E], E],
        ctx: AsyncContext,
        cohort: Optional[List[int]] = None,
    ) -> Optional[JobWaiter]:
        """Non-blocking reduce streaming per-partition results into ``ctx``.

        Parity: ``RDD.ASYNCreduce`` (``rdd/RDD.scala:1087-1171``) -- stamp the
        submit clock, mark the cohort busy, submit without blocking; each
        finishing partition merges via ``ctx.merge_result`` (staleness =
        clock_now - submit_clock, clock += 1).  Empty cohort skips the run
        (``rdd/RDD.scala:1095-1097`` returns without submitting).
        """
        return self._async_action(lambda xs: _local_reduce(xs, op), ctx, cohort)

    def async_aggregate(
        self,
        zero: U,
        seq_op: Callable[[U, E], U],
        comb_op: Callable[[U, U], U],
        ctx: AsyncContext,
        cohort: Optional[List[int]] = None,
    ) -> Optional[JobWaiter]:
        """Non-blocking aggregate (``RDD.ASYNCaggregate`` parity); ``comb_op``
        is applied driver-side by the consumer of ``ctx`` (the updater)."""
        del comb_op  # driver-side merge belongs to the updater thread
        return self._async_action(
            lambda xs: (_local_aggregate(xs, zero, seq_op), True), ctx, cohort
        )

    def _async_action(
        self,
        local: Callable[[List[E]], Any],
        ctx: AsyncContext,
        cohort: Optional[List[int]],
    ) -> Optional[JobWaiter]:
        wids = self.partition_ids() if cohort is None else list(cohort)
        if not wids:
            return None  # empty-cohort skip
        submit_clock = ctx.get_current_time()
        ctx.set_last_time(submit_clock)
        ctx.mark_busy(wids)
        clock = self.scheduler.clock

        def make_task(wid: int) -> Callable[[], Any]:
            def run() -> Any:
                t0 = clock.now_ms()
                xs = self._compute(wid)
                out = local(xs)
                return out, len(xs), clock.now_ms() - t0

            return run

        def handler(wid: int, payload: Any) -> None:
            out, n, elapsed_ms = payload
            value, nonempty = out
            if not nonempty:
                ctx.mark_available(wid)  # empty partition: freed, no merge
                return
            ctx.merge_result(
                wid, value, submit_clock, elapsed_ms, batch_size=n
            )

        mode = self.scheduler.get_mode()
        self.scheduler.set_mode(ASYNC)
        try:
            waiter = self.scheduler.run_job(
                {wid: make_task(wid) for wid in wids}, handler
            )
        except BaseException:
            # the scheduler's first job blocks (warm-up) and re-raises task
            # failures synchronously -- release the cohort before propagating
            for w in wids:
                ctx.mark_available(w)
            raise
        finally:
            self.scheduler.set_mode(mode)
        # If the job aborts (a task exhausted retries), release the whole
        # cohort so the driver loop does not deadlock on availability; the
        # caller observes the error via ``waiter.failed``.  Workers that
        # already merged are available anyway (mark_available is idempotent).
        waiter.on_failure(
            lambda _exc: [ctx.mark_available(w) for w in wids]
        )
        return waiter


def _payload_to_host(e):
    """Recursively convert tensors (and other packages' arrays, a
    ``jax.Array`` through its ``__array__``) to host numpy for pickling
    (tuples/lists/dicts of arrays are common payload shapes), as the JAX
    package converts its device arrays.  Tuple subclasses (namedtuples) are
    rebuilt with their own type so a checkpoint round trip preserves
    element types."""
    import torch

    if isinstance(e, torch.Tensor):
        return e.detach().cpu().numpy()
    if (hasattr(e, "__array__") and hasattr(e, "dtype")
            and not isinstance(e, (np.ndarray, np.generic))):
        return np.array(e)
    if isinstance(e, tuple):
        converted = [_payload_to_host(x) for x in e]
        if type(e) is tuple:
            return tuple(converted)
        return type(e)(*converted)  # namedtuple and friends
    if isinstance(e, list):
        return [_payload_to_host(x) for x in e]
    if isinstance(e, dict):
        return {k: _payload_to_host(v) for k, v in e.items()}
    return e


def _checkpoint_loader(directory: str, wid: int):
    """Partition-reader closure; runs on the partition's worker thread."""
    import os

    path = os.path.join(directory, f"part-{wid:05d}.pkl")

    def load():
        with open(path, "rb") as f:
            return pickle.load(f)

    return load


def _hashable_u64(xs: List) -> np.ndarray:
    """Elements -> uint64 for sketching: numeric sequences take the
    vectorized path; everything else (tuples, strings, mixed) hashes per
    element through the stable portable hash (tuple support is what makes
    countApproxDistinct work on pair datasets)."""
    try:
        a = np.asarray(xs)
    except ValueError:  # ragged
        a = None
    if a is not None and a.ndim == 1 and a.dtype.kind in "iuf":
        return a
    from asyncframework_tpu_torch.data.pairs import portable_hash

    return np.asarray(
        [portable_hash(x) & 0xFFFFFFFFFFFFFFFF for x in xs], np.uint64
    )


def _local_reduce(xs: List[E], op: Callable[[E, E], E]) -> Tuple[Any, bool]:
    """(value, nonempty): the reference's ``reducePartition`` returns an
    Option; empty partitions contribute nothing."""
    it = iter(xs)
    try:
        acc = next(it)
    except StopIteration:
        return None, False
    for x in it:
        acc = op(acc, x)
    return acc, True


def _local_aggregate(
    xs: List[E], zero: U, seq_op: Callable[[U, E], U]
) -> U:
    import copy

    acc = copy.deepcopy(zero)
    for x in xs:
        acc = seq_op(acc, x)
    return acc


class StatCounter:
    """Running (count, mean, variance, min, max) with a numerically stable
    merge (``org.apache.spark.util.StatCounter`` parity: Chan et al.'s
    parallel-moments update, the same algebra ``stats()`` relies on)."""

    def __init__(self):
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def merge_value(self, x: float) -> "StatCounter":
        delta = x - self.mean
        self.count += 1
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        if x != x:
            # NaN poisons min/max like the moments (StatCounter parity:
            # Java's Math.min propagates NaN; Python's min() would
            # silently skip it and report an inconsistent clean range)
            self.min = float("nan")
            self.max = float("nan")
        else:
            self.min = min(self.min, x)
            self.max = max(self.max, x)
        return self

    def merge_stats(self, other: "StatCounter") -> "StatCounter":
        if other.count == 0:
            return self
        if self.count == 0:
            self.count = other.count
            self.mean = other.mean
            self._m2 = other._m2
            self.min = other.min
            self.max = other.max
            return self
        delta = other.mean - self.mean
        total = self.count + other.count
        self.mean += delta * other.count / total
        self._m2 += other._m2 + delta * delta * self.count * other.count / total
        self.count = total
        if other.min != other.min or self.min != self.min:
            self.min = float("nan")
            self.max = float("nan")
        else:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self

    @property
    def variance(self) -> float:
        """Population variance (StatCounter.variance semantics)."""
        return self._m2 / self.count if self.count else float("nan")

    @property
    def sample_variance(self) -> float:
        return (
            self._m2 / (self.count - 1)
            if self.count > 1
            else float("nan")
        )

    @property
    def stdev(self) -> float:
        return self.variance ** 0.5

    @property
    def sum(self) -> float:
        return self.mean * self.count

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"StatCounter(count={self.count}, mean={self.mean:.6g}, "
            f"stdev={self.stdev:.6g}, min={self.min:.6g}, max={self.max:.6g})"
        )

"""Pair (key, value) dataset operations: the other half of the RDD API.

Parity (studied, not copied): ``core/src/main/scala/org/apache/spark/rdd/
PairRDDFunctions.scala`` -- ``combineByKey`` (the base primitive),
``reduceByKey`` (~line 300), ``foldByKey``, ``groupByKey``, ``countByKey``,
``join``/``leftOuterJoin``/``rightOuterJoin``/``fullOuterJoin``, ``cogroup``,
``partitionBy``, ``keys``/``values``/``mapValues``/``flatMapValues``, plus
``OrderedRDDFunctions.sortByKey`` (range partitioner + per-partition sort).

TPU-first design: the reference shuffles through sorted spill files fetched
over the network because its partitions live in different JVMs.  Here
partitions are worker-pinned host/device payloads inside ONE process, and the
driver is already the reduction point for every collective (SURVEY.md
section 2.3: Spark's collectives are driver-mediated -- that is *why* ASYNC
exists).  The shuffle therefore decomposes into:

1. **map-side combine on workers** (a parallel job; the analog of Spark's
   map-side ``Aggregator``),
2. **driver routing** of the (already combined, so small) per-key entries to
   their hash/range target partition (the analog of the shuffle fetch, minus
   the network), and
3. **reduce-side merge on workers** (a second parallel job producing the
   output partitions).

Keys are hashed with a *portable* hash (Python's builtin is salted per
process, which would break any persisted partitioning), matching the spirit
of the reference's ``Partitioner.defaultPartitioner`` + Java hashCode.

A copy of the JAX package's ``data/pairs.py``: the same hash, the same
partitions, the same per-partition draws (numpy ``SeedSequence``, so a
sample is bit-equal across the packages).  Only ``reduce_by_key``'s
``auto`` rule differs: the JAX package asks JAX for its default backend,
the port looks at the partitions' tensors -- CUDA tensors take the device
plane, anything else the host plane -- and moves nothing to pick one.
"""

from __future__ import annotations

from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Tuple,
    TypeVar,
)

from asyncframework_tpu_torch.storage.kvstore import string_hash_code

K = TypeVar("K")
V = TypeVar("V")
W = TypeVar("W")
C = TypeVar("C")


def partition_draws(seed: int, wid: int, n: int):
    """The shared per-partition uniform-draw recipe: deterministic in
    (seed, partition id) -- ``PartitionwiseSampledRDD`` parity.  Both
    ``DistributedDataset.sample`` and ``sample_by_key`` derive their
    Bernoulli draws from here so their seeding stays in lockstep."""
    import numpy as _np

    rs = _np.random.default_rng(
        _np.random.SeedSequence(entropy=seed, spawn_key=(wid,))
    )
    return rs.random(n)


def _append(c: list, v) -> list:
    c.append(v)
    return c


def _extend(a: list, b: list) -> list:
    a.extend(b)
    return a


def portable_hash(key: Any) -> int:
    """Process-stable hash (Python's ``hash`` is salted for str/bytes)."""
    if key is None:
        return 0
    if isinstance(key, bool):
        return int(key)
    if isinstance(key, int):
        return key
    if isinstance(key, str):
        return string_hash_code(key)
    if isinstance(key, bytes):
        return string_hash_code(key.decode("utf-8", "surrogateescape"))
    if isinstance(key, float):
        return hash(key)  # floats are not salted
    if isinstance(key, tuple):
        h = 0x345678
        for item in key:
            h = (h * 1000003) ^ portable_hash(item)
        return h
    raise TypeError(
        f"unhashable/unstable key type for partitioning: {type(key).__name__}"
    )


def hash_partition(key: Any, num_partitions: int) -> int:
    return portable_hash(key) % num_partitions


class PairOpsMixin:
    """Pair-op surface mixed into ``DistributedDataset``.

    Elements are assumed to be ``(key, value)`` tuples, like an
    ``RDD[(K, V)]`` picking up ``PairRDDFunctions`` implicitly.
    """

    # ------------------------------------------------------- simple projections
    def keys(self):
        return self.map(lambda kv: kv[0])

    def values(self):
        return self.map(lambda kv: kv[1])

    def map_values(self, f: Callable[[V], W]):
        """``mapValues`` parity: preserves partitioning (no shuffle)."""
        return self.map(lambda kv: (kv[0], f(kv[1])))

    def flat_map_values(self, f: Callable[[V], Iterable[W]]):
        return self.flat_map(lambda kv: [(kv[0], w) for w in f(kv[1])])

    # ---------------------------------------------------------------- shuffles
    def _resolve_p(self, num_partitions: Optional[int]) -> int:
        p = num_partitions or max(len(self._parts), 1)
        if p > self.scheduler.num_workers:
            raise ValueError(
                f"num_partitions={p} exceeds num_workers="
                f"{self.scheduler.num_workers}; partitions are worker-pinned"
            )
        return p

    def partition_by(
        self,
        num_partitions: Optional[int] = None,
        partition_func: Callable[[Any, int], int] = hash_partition,
    ):
        """``partitionBy`` parity: route each pair to its key's partition.

        The ROUTING buffer is memory-bounded (past
        ``async.shuffle.spill.bytes`` it spills to disk runs,
        data/spill.py), which halves peak residency during the route: the
        input lists and the full routed copy never coexist.  The OUTPUT
        partitions are in-memory payloads -- like every dataset in this
        architecture -- so partitioning N pairs still ends with N pairs
        resident; ops that shrink (combine_by_key) or stream per-partition
        (sort) get the full benefit of the bound."""
        from asyncframework_tpu_torch.data.spill import (
            SpillingRouter,
            configured_spill_bytes,
        )

        p = self._resolve_p(num_partitions)
        per = self._run_sync(lambda wid: (lambda w=wid: self._compute(w)))
        with SpillingRouter(p, configured_spill_bytes(),
                            label="partition_by") as router:
            for wid in sorted(per):
                for kv in per[wid]:
                    router.add(partition_func(kv[0], p), kv)
            routed = {i: router.partition_list(i) for i in range(p)}
        return type(self).from_partitions(self.scheduler, routed)

    def combine_by_key(
        self,
        create_combiner: Callable[[V], C],
        merge_value: Callable[[C, V], C],
        merge_combiners: Callable[[C, C], C],
        num_partitions: Optional[int] = None,
    ):
        """``combineByKey`` parity -- the base of every by-key aggregation.

        Map-side combine runs on workers, the driver routes the (small)
        per-key combiners, reduce-side merge runs on workers again.
        """
        p = self._resolve_p(num_partitions)

        def local_combine(wid: int):
            def run(w=wid):
                acc: Dict[Any, Any] = {}
                for k, v in self._compute(w):
                    if k in acc:
                        acc[k] = merge_value(acc[k], v)
                    else:
                        acc[k] = create_combiner(v)
                return list(acc.items())

            return run

        from asyncframework_tpu_torch.data.spill import (
            SpillingRouter,
            configured_spill_bytes,
        )

        combined = self._run_sync(local_combine)
        router = SpillingRouter(p, configured_spill_bytes(),
                                label="combine_by_key")
        for wid in sorted(combined):
            for k, c in combined[wid]:
                router.add(hash_partition(k, p), (k, c))

        def reduce_side(pid: int):
            def run(r=router, i=pid):
                # reduce-side merge streams this partition's entries out of
                # the spill runs + memory tail -- never the whole shuffle
                acc: Dict[Any, Any] = {}
                for k, c in r.partition(i):
                    acc[k] = merge_combiners(acc[k], c) if k in acc else c
                return list(acc.items())

            return run

        try:
            merged = self._run_job_dict(
                {pid: reduce_side(pid) for pid in range(p)}
            )
        finally:
            router.close()
        return type(self).from_partitions(
            self.scheduler, {pid: merged[pid] for pid in range(p)}
        )

    def reduce_by_key(
        self, op, num_partitions: Optional[int] = None,
        distinct_hint: Optional[int] = None,
    ):
        """``reduceByKey`` parity (map-side combine included, like the
        reference's default).

        ``op`` may be a callable (host path: arbitrary Python keys/values,
        driver-routed) or one of ``'sum'|'max'|'min'`` with array-typed
        partitions (``from_array_pairs``), which takes the ARRAY data
        plane (``async.shuffle.data.plane``, default ``auto``):

        - CUDA tensors -> the DEVICE shuffle: one sort and segment reduce
          on the card (ops/shuffle.py -- the SortShuffleManager-role data
          plane);
        - anything else (CPU tensors, host arrays) -> the vectorized HOST
          shuffle (numpy bincount/sort+reduceat).

        ``device`` or ``host`` forces a plane: ``device`` runs the same
        torch code on CPU tensors, ``host`` copies card tensors to the
        host.
        """
        if isinstance(op, str):
            from asyncframework_tpu_torch.conf import (
                SHUFFLE_DATA_PLANE,
                global_conf,
            )

            plane = str(global_conf().get(SHUFFLE_DATA_PLANE))
            if plane not in ("auto", "host", "device"):
                raise ValueError(
                    f"async.shuffle.data.plane={plane!r}: must be "
                    "'auto', 'host', or 'device'"
                )
            return self._reduce_by_key_arrays(plane, op, distinct_hint)
        return self.combine_by_key(lambda v: v, op, op, num_partitions)

    def _reduce_by_key_arrays(self, plane: str, op: str, distinct_hint=None):
        import torch

        from asyncframework_tpu_torch.ops import shuffle as _shuffle

        blocks = self._run_sync(lambda wid: (lambda w=wid: self._compute(w)))
        parts = {}
        for wid, payload in blocks.items():
            payload = list(payload)
            kv = payload[0] if len(payload) == 1 else None
            if not (
                isinstance(kv, tuple) and len(kv) == 2
                and hasattr(kv[0], "shape") and hasattr(kv[1], "shape")
            ):
                raise ValueError(
                    "device reduce_by_key needs array-pair partitions "
                    "(build with from_array_pairs); got a generic payload -- "
                    "pass a callable op for the host path"
                )
            parts[wid] = kv
        if plane == "auto":
            # by the blocks themselves: a CUDA tensor never leaves the card
            # to pick a plane
            on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                          for kv in parts.values() for x in kv)
            plane = "device" if on_card else "host"
        if plane == "host":
            out = _shuffle.host_reduce_by_key(parts, op=op)
        else:
            out = _shuffle.device_reduce_by_key(
                parts, op=op, distinct_hint=distinct_hint
            )
        return type(self).from_partitions(
            self.scheduler, {pid: [kv] for pid, kv in out.items()}
        )

    def fold_by_key(
        self,
        zero: V,
        op: Callable[[V, V], V],
        num_partitions: Optional[int] = None,
    ):
        import copy

        return self.combine_by_key(
            lambda v: op(copy.deepcopy(zero), v), op, op, num_partitions
        )

    def group_by_key(self, num_partitions: Optional[int] = None):
        """``groupByKey`` parity: values are collected into lists (the
        reference documents the same no-map-side-combine memory caveat)."""
        return self.combine_by_key(
            lambda v: [v],
            _append,  # in-place: `c + [v]` would be O(m^2) per skewed key
            _extend,
            num_partitions,
        )

    def sample_by_key(self, fractions: Dict[Any, float], seed: int = 42):
        """``sampleByKey`` parity: per-key Bernoulli fractions, deterministic
        in (seed, partition) like :meth:`DistributedDataset.sample`; keys
        absent from ``fractions`` are dropped."""
        for k, f in fractions.items():
            if not 0.0 <= f <= 1.0:
                raise ValueError(f"fraction for key {k!r} must be in [0, 1]")

        def sampler(wid: int):
            def run(w=wid):
                xs = self._compute(w)
                draws = partition_draws(seed, w, len(xs))
                return [
                    kv for kv, u in zip(xs, draws)
                    if u < fractions.get(kv[0], 0.0)
                ]

            return run

        return type(self)(
            self.scheduler, {wid: sampler(wid) for wid in self._parts}
        )

    def count_by_key(self) -> Dict[Any, int]:
        """``countByKey`` action: driver-side dict of counts."""
        counts = self.map_values(lambda _v: 1).reduce_by_key(lambda a, b: a + b)
        return dict(counts.collect())

    # ------------------------------------------------------------------- joins
    def cogroup(self, other, num_partitions: Optional[int] = None):
        """``cogroup`` parity: (k, ([vs], [ws])) with both sides grouped."""
        p = self._resolve_p(num_partitions)
        left = self.group_by_key(p)
        right = other.group_by_key(p)
        lper = left._run_sync(lambda wid: (lambda w=wid: left._compute(w)))
        rper = right._run_sync(lambda wid: (lambda w=wid: right._compute(w)))

        def merge_partition(pid: int):
            def run(ls=lper.get(pid, []), rs=rper.get(pid, [])):
                acc: Dict[Any, Tuple[list, list]] = {}
                for k, vs in ls:
                    acc.setdefault(k, ([], []))[0].extend(vs)
                for k, ws in rs:
                    acc.setdefault(k, ([], []))[1].extend(ws)
                return list(acc.items())

            return run

        merged = self._run_job_dict(
            {pid: merge_partition(pid) for pid in range(p)}
        )
        return type(self).from_partitions(
            self.scheduler, {pid: merged[pid] for pid in range(p)}
        )

    def _join_with(self, other, num_partitions, keep_left, keep_right):
        co = self.cogroup(other, num_partitions)

        def expand(kv):
            k, (vs, ws) = kv
            if vs and ws:
                return [(k, (v, w)) for v in vs for w in ws]
            if vs and not ws and keep_left:
                return [(k, (v, None)) for v in vs]
            if ws and not vs and keep_right:
                return [(k, (None, w)) for w in ws]
            return []

        return co.flat_map(expand)

    def join(self, other, num_partitions: Optional[int] = None):
        """Inner ``join`` parity: (k, (v, w)) for every matching pair."""
        return self._join_with(other, num_partitions, False, False)

    def left_outer_join(self, other, num_partitions: Optional[int] = None):
        return self._join_with(other, num_partitions, True, False)

    def right_outer_join(self, other, num_partitions: Optional[int] = None):
        return self._join_with(other, num_partitions, False, True)

    def full_outer_join(self, other, num_partitions: Optional[int] = None):
        return self._join_with(other, num_partitions, True, True)

    # ----------------------------------------------------------------- sorting
    def sort_by_key(
        self,
        ascending: bool = True,
        num_partitions: Optional[int] = None,
    ):
        """``sortByKey`` parity: range-partition by sampled bounds, then sort
        within partitions -- partition order IS global order, like the
        reference's ``RangePartitioner`` + per-partition sort."""
        p = self._resolve_p(num_partitions)
        per = self._run_sync(lambda wid: (lambda w=wid: self._compute(w)))
        all_pairs = [kv for wid in sorted(per) for kv in per[wid]]
        if not all_pairs:
            return type(self).from_partitions(
                self.scheduler, {i: [] for i in range(p)}
            )
        keys = sorted(kv[0] for kv in all_pairs)
        # p-1 range bounds from evenly spaced order statistics
        bounds = [
            keys[(i + 1) * len(keys) // p] for i in range(p - 1)
        ]

        def target(k) -> int:
            import bisect

            t = bisect.bisect_right(bounds, k)
            return t if ascending else p - 1 - t

        from asyncframework_tpu_torch.data.spill import (
            SpillingRouter,
            configured_spill_bytes,
        )

        router = SpillingRouter(p, configured_spill_bytes(),
                                label="sort_by_key")
        for kv in all_pairs:
            router.add(target(kv[0]), kv)

        def sort_partition(pid: int):
            def run(r=router, i=pid):
                return sorted(
                    r.partition(i), key=lambda kv: kv[0],
                    reverse=not ascending
                )

            return run

        try:
            merged = self._run_job_dict(
                {pid: sort_partition(pid) for pid in range(p)}
            )
        finally:
            router.close()
        return type(self).from_partitions(
            self.scheduler, {pid: merged[pid] for pid in range(p)}
        )

"""The port's dataset layer against the JAX package's own suites and across
the packages.

- The JAX package's cases (``tests/test_dataset.py``,
  ``tests/test_pairs.py``, ``tests/test_spill.py``, the sketch and dataset
  classes of ``tests/test_sketch_accum.py``, and ``tests/test_native.py``'s
  key/value store and string hash) run here a second time on the port's
  copies on the CPU: the reference modules' globals are swapped by
  monkeypatch, and their lazy ``asyncframework_tpu.*`` imports are
  aliased in ``sys.modules`` to the port's modules.  ``ASYNCTPU_FORCE_CPU``
  stands in for the JAX package's default device.  The two cases that
  build JAX arrays or start a JAX-package process are ported to tensors
  and to a port process, under their own names.
- Across the packages, on the same seeded numpy inputs: ``reduce_by_key``
  (``sum``/``max``/``min``) of the JAX package on its 8 virtual CPU
  devices (its ``all_to_all`` path) against the port's shared-device and
  host planes, exactly; a binding ``distinct_hint`` against the JAX
  package's own shared-device path (its blocks on one device), dropping
  the same keys; ``sample``/``sample_by_key`` bit-equal; a checkpoint
  directory and a ``KVStore`` file written by one package read by the
  other; the staleness stamped by ``async_reduce`` behind
  ``barrier(bucket_predicate(...))`` under a fake clock, merge by merge;
  the random datasets reproducible per seed and within stated bands.
"""

import functools
import importlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_dataset as ref_dataset
import test_native as ref_native
import test_pairs as ref_pairs
import test_sketch_accum as ref_sketch
import test_spill as ref_spill
from test_dataset import sched  # noqa: F401  (the reference's fixture)
from test_pairs import plane  # noqa: F401  (the reference's fixture)
from test_spill import bounded_conf  # noqa: F401  (the reference's fixture)

from asyncframework_tpu import conf as j_conf
from asyncframework_tpu.context import AsyncContext as JAsyncContext
from asyncframework_tpu.data import random as j_random
from asyncframework_tpu.data.dataset import DistributedDataset as JDataset
from asyncframework_tpu.engine.barrier import bucket_predicate as j_bucket
from asyncframework_tpu.engine.scheduler import JobScheduler as JScheduler
from asyncframework_tpu.storage.kvstore import KVStore as JKVStore
from asyncframework_tpu.utils.clock import ManualClock as JManualClock
from asyncframework_tpu_torch import convert
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch.context import AsyncContext
from asyncframework_tpu_torch.data import dataset as t_dataset
from asyncframework_tpu_torch.data import pairs as t_pairs
from asyncframework_tpu_torch.data import random as t_random
from asyncframework_tpu_torch.data import spill as t_spill
from asyncframework_tpu_torch.engine import barrier as t_barrier
from asyncframework_tpu_torch.engine import scheduler as t_scheduler
from asyncframework_tpu_torch.metrics import registry as t_registry
from asyncframework_tpu_torch.ops import shuffle as t_shuffle
from asyncframework_tpu_torch.storage import kvstore as t_kvstore
from asyncframework_tpu_torch.utils import sketch as t_sketch
from asyncframework_tpu_torch.utils.clock import ManualClock

CPU = torch.device("cpu")
REPO = ref_dataset.__file__.rsplit("/tests/", 1)[0]

#: the JAX package's modules the reference cases import lazily -> the port's
ALIASES = {
    "asyncframework_tpu.conf": t_conf,
    "asyncframework_tpu.data.dataset": t_dataset,
    "asyncframework_tpu.data.pairs": t_pairs,
    "asyncframework_tpu.data.spill": t_spill,
    "asyncframework_tpu.engine.scheduler": t_scheduler,
    "asyncframework_tpu.ops.shuffle": t_shuffle,
    "asyncframework_tpu.storage.kvstore": t_kvstore,
    "asyncframework_tpu.utils.sketch": t_sketch,
}

#: each reference module's globals -> the port's objects
GLOBALS = {
    ref_dataset: dict(
        AsyncContext=AsyncContext,
        DistributedDataset=t_dataset.DistributedDataset,
        bucket_predicate=t_barrier.bucket_predicate,
        JobScheduler=t_scheduler.JobScheduler),
    ref_pairs: dict(
        DistributedDataset=t_dataset.DistributedDataset,
        hash_partition=t_pairs.hash_partition,
        portable_hash=t_pairs.portable_hash),
    ref_spill: dict(
        AsyncConf=t_conf.AsyncConf, set_global_conf=t_conf.set_global_conf,
        SpillingRouter=t_spill.SpillingRouter,
        _reset_totals=t_spill._reset_totals,
        shuffle_totals=t_spill.shuffle_totals),
    ref_sketch: dict(
        DistributedDataset=t_dataset.DistributedDataset,
        JobScheduler=t_scheduler.JobScheduler,
        BloomFilter=t_sketch.BloomFilter,
        CountMinSketch=t_sketch.CountMinSketch),
    ref_native: dict(
        KVStore=t_kvstore.KVStore,
        string_hash_code=t_kvstore.string_hash_code),
}


@pytest.fixture(autouse=True)
def _port_modules(request, monkeypatch):
    """Point the reference cases at the port's modules on the CPU; the
    cases across the packages (``port_modules = False``) run unpatched."""
    if not getattr(request.cls, "port_modules", True):
        yield
        return
    monkeypatch.setenv("ASYNCTPU_FORCE_CPU", "1")
    for name, module in ALIASES.items():
        parent, _, attr = name.rpartition(".")
        monkeypatch.setitem(sys.modules, name, module)
        monkeypatch.setattr(importlib.import_module(parent), attr, module,
                            raising=False)
    for ref, values in GLOBALS.items():
        for name, value in values.items():
            monkeypatch.setattr(ref, name, value)
    t_spill.reset_shuffle_totals()
    yield
    t_conf.set_global_conf(None)


# ---------------------------------------- tests/test_dataset.py on the port
for _name in dir(ref_dataset):
    if _name.startswith("test_"):
        globals()[_name] = getattr(ref_dataset, _name)


class TestRDDBreadthOnThePort(ref_dataset.TestRDDBreadth):
    pass


class TestStatsAndHistogramOnThePort(ref_dataset.TestStatsAndHistogram):
    pass


class TestCheckpointOnThePort(ref_dataset.TestCheckpoint):
    def test_device_arrays_roundtrip(self, sched, tmp_path):
        """The reference case with tensors for its JAX arrays: they are
        stored as host numpy and read back as such."""
        ds = t_dataset.DistributedDataset.from_partitions(
            sched, {w: [torch.arange(4) + w] for w in range(4)}
        )
        ds.checkpoint(str(tmp_path / "ck"))
        out = ds.collect()
        for w, arr in enumerate(out):
            assert isinstance(arr, np.ndarray)
            np.testing.assert_array_equal(arr, np.arange(4) + w)

    def test_restart_survival(self, sched, tmp_path):
        """The reference case with a port process reading the checkpoint
        back (the JAX-package process reads one in the cases across the
        packages)."""
        ck = str(tmp_path / "ck")
        (t_dataset.DistributedDataset.from_list(sched, list(range(100)))
         .map(lambda x: x + 1)
         .checkpoint(ck))
        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "from asyncframework_tpu_torch.data.dataset import "
            "DistributedDataset\n"
            "from asyncframework_tpu_torch.engine.scheduler import "
            "JobScheduler\n"
            "s = JobScheduler(num_workers=4)\n"
            "ds = DistributedDataset.from_checkpoint(s, %r)\n"
            "print(sum(ds.collect()))\n"
            "s.shutdown()\n"
        ) % (REPO, ck)
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == str(sum(range(1, 101)))


# ------------------------------------------ tests/test_pairs.py on the port
class TestPortableHashOnThePort(ref_pairs.TestPortableHash):
    pass


class TestByKeyOnThePort(ref_pairs.TestByKey):
    pass


class TestJoinsOnThePort(ref_pairs.TestJoins):
    pass


class TestSortByKeyOnThePort(ref_pairs.TestSortByKey):
    pass


class TestSampleByKeyOnThePort(ref_pairs.TestSampleByKey):
    pass


class TestDeviceShuffleOnThePort(ref_pairs.TestDeviceShuffle):
    pass


# ------------------------------------------ tests/test_spill.py on the port
class TestSpillingRouterOnThePort(ref_spill.TestSpillingRouter):
    pass


class TestShuffleOpsSpillOnThePort(ref_spill.TestShuffleOpsSpill):
    pass


# --------------------------- tests/test_sketch_accum.py's sketch and dataset
class TestCountMinSketchOnThePort(ref_sketch.TestCountMinSketch):
    pass


class TestBloomFilterOnThePort(ref_sketch.TestBloomFilter):
    pass


class TestDatasetOpsOnThePort(ref_sketch.TestDatasetOps):
    pass


class TestHyperLogLogOnThePort(ref_sketch.TestHyperLogLog):
    pass


# ------------------------- tests/test_native.py's key/value store and hash
class TestKVStoreOnThePort(ref_native.TestKVStore):
    pass


class TestStringHashCodeOnThePort(ref_native.TestStringHashCode):
    pass


# -------------------------------------------------- the port's own surface
class TestPortSurface:
    def test_from_array_pairs_takes_the_schedulers_devices(self):
        s = t_scheduler.JobScheduler(num_workers=2, devices=[CPU] * 2)
        try:
            ds = t_dataset.DistributedDataset.from_array_pairs(
                s, {0: (np.arange(3), np.ones(3, np.float32)),
                    1: (torch.arange(2), torch.ones(2))})
            for (k, v), in (ds._compute(w) for w in ds.partition_ids()):
                assert k.device == CPU and v.device == CPU
            assert ds._compute(0)[0][0].dtype == torch.int64  # kept
        finally:
            s.shutdown()

    def test_entry_points_raise_without_a_card(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default is the card")
        monkeypatch.delenv("ASYNCTPU_FORCE_CPU", raising=False)
        s = t_scheduler.JobScheduler(num_workers=2)
        try:
            with pytest.raises(RuntimeError, match="CUDA"):
                t_dataset.DistributedDataset.from_array_pairs(
                    s, {0: (np.arange(3), np.ones(3))})
            with pytest.raises(RuntimeError, match="CUDA"):
                t_random.uniform_dataset(s, 10)
        finally:
            s.shutdown()

    def test_auto_plane_follows_the_blocks(self, monkeypatch):
        """CPU tensors take the host plane under ``auto``; ``device``
        runs the torch plane on them; each plane counts its calls."""
        s = t_scheduler.JobScheduler(num_workers=2, devices=[CPU] * 2)
        try:
            ds = t_dataset.DistributedDataset.from_array_pairs(
                s, {0: (np.array([3, 1, 3]), np.ones(3, np.float32)),
                    1: (np.array([2]), np.ones(1, np.float32))})
            before = dict(t_shuffle.calls)
            ds.reduce_by_key("sum")
            assert t_shuffle.calls["host"] == before["host"] + 1
            assert t_shuffle.calls["device"] == before["device"]
            t_conf.set_global_conf(
                t_conf.AsyncConf({"async.shuffle.data.plane": "device"}))
            ds.reduce_by_key("sum")
            assert t_shuffle.calls["device"] == before["device"] + 1
            t_conf.set_global_conf(
                t_conf.AsyncConf({"async.shuffle.data.plane": "nope"}))
            with pytest.raises(ValueError, match="data.plane"):
                ds.reduce_by_key("sum")
        finally:
            t_conf.set_global_conf(None)
            s.shutdown()

    def test_blocks_on_several_devices_raise_naming_a6b6(self):
        """The exchange between devices is not ported: a block on another
        device (here the meta device) raises, naming the ROADMAP item."""
        parts = {0: (torch.tensor([1, 2]), torch.ones(2)),
                 1: (torch.tensor([1, 2], device="meta"),
                     torch.ones(2, device="meta"))}
        with pytest.raises(NotImplementedError, match="A6b.6"):
            t_shuffle.device_reduce_by_key(parts, "sum")

    def test_segment_reduce_drops_sentinels_and_overflow(self):
        keys = torch.tensor([5, -1, 3, 5, 9, -1, 3, 7])
        vals = torch.tensor([1, 100, 2, 3, 4, 100, 5, 6], dtype=torch.int32)
        k, v = t_shuffle._segment_reduce(keys, vals, "sum", 3)
        assert k.tolist() == [3, 5, 7] and v.tolist() == [7, 4, 6]
        k, v = t_shuffle._segment_reduce(keys, vals, "max", 10)
        assert k.tolist() == [3, 5, 7, 9] and v.tolist() == [5, 3, 6, 4]

    def test_shuffle_family_counts_the_routes(self):
        t_spill.reset_shuffle_totals()
        fam = dict(t_registry.families())["shuffle"]
        s = t_scheduler.JobScheduler(num_workers=2, devices=[CPU] * 2)
        try:
            ds = t_dataset.DistributedDataset.from_list(
                s, [(i % 3, i) for i in range(30)])
            ds.group_by_key().collect()
        finally:
            s.shutdown()
        got = fam.totals()
        assert got["shuffles"] == 1 and got["records_routed"] > 0
        fam.reset()
        assert fam.totals()["records_routed"] == 0

    def test_exports(self):
        from asyncframework_tpu_torch import data

        assert data.DistributedDataset is t_dataset.DistributedDataset
        assert data.random_datasets is t_random


# ---------------------------------------------------- across the packages
def _blocks(seed, parts, n, vocab, val_kind):
    rs = np.random.default_rng(seed)
    out = {}
    for w in range(parts):
        m = n + 37 * w  # uneven blocks
        keys = rs.integers(0, vocab, size=m).astype(np.int64)
        if val_kind == "int":
            vals = rs.integers(-50, 50, size=m).astype(np.int32)
        else:
            vals = rs.normal(size=m).astype(np.float32)
        out[w] = (keys, vals)
    return out


def _by_partition(ds):
    """``{pid: (keys int64, values)}`` of a reduce_by_key result."""
    out = {}
    for pid in ds.partition_ids():
        (k, v), = ds._compute(pid)
        out[pid] = (np.asarray(k).astype(np.int64), np.asarray(v))
    return out


def _jax_plane(plane):
    j_conf.set_global_conf(
        j_conf.AsyncConf({"async.shuffle.data.plane": plane}))


@functools.lru_cache(maxsize=None)
def _jax_all_to_all(op, val_kind):
    """The JAX package's reduce_by_key of :func:`_blocks` on its 8 virtual
    CPU devices (one compile of its shard_map a case, shared by both of
    the port's planes)."""
    import jax

    blocks = _blocks(11, 8, 3_000, 700, val_kind)
    js = JScheduler(num_workers=8)
    try:
        _jax_plane("device")
        jds = JDataset.from_array_pairs(js, blocks, devices=jax.devices()[:8])
        return _by_partition(jds.reduce_by_key(op))
    finally:
        j_conf.set_global_conf(None)
        js.shutdown()


class TestAcrossReduceByKey:
    port_modules = False

    @pytest.mark.parametrize("op,val_kind", [
        ("sum", "int"), ("max", "normal"), ("min", "normal")])
    @pytest.mark.parametrize("port_plane", ["device", "host"])
    def test_equal_to_the_jax_all_to_all(self, devices8, op, val_kind,
                                         port_plane):
        blocks = _blocks(11, 8, 3_000, 700, val_kind)
        want = _jax_all_to_all(op, val_kind)
        ts = t_scheduler.JobScheduler(num_workers=8, devices=[CPU] * 8)
        try:
            t_conf.set_global_conf(t_conf.AsyncConf(
                {"async.shuffle.data.plane": port_plane}))
            tds = t_dataset.DistributedDataset.from_array_pairs(ts, blocks)
            got = _by_partition(tds.reduce_by_key(op))
        finally:
            t_conf.set_global_conf(None)
            ts.shutdown()
        assert sorted(got) == sorted(want) == list(range(8))
        for pid in want:
            np.testing.assert_array_equal(got[pid][0], want[pid][0])
            np.testing.assert_array_equal(got[pid][1], want[pid][1])
            assert np.all(got[pid][0] % 8 == pid)
        total = sum(len(k) for k, _ in want.values())
        assert total == len(np.unique(np.concatenate(
            [k for k, _ in blocks.values()])))

    @pytest.mark.parametrize("hint", [40, 90])
    def test_binding_distinct_hint_drops_what_the_jax_shared_path_drops(
            self, devices8, hint):
        blocks = _blocks(12, 4, 500, 600, "int")
        js = JScheduler(num_workers=4)
        ts = t_scheduler.JobScheduler(num_workers=4, devices=[CPU] * 4)
        try:
            _jax_plane("device")
            jds = JDataset.from_array_pairs(js, blocks,
                                            devices=[devices8[0]])
            want = _by_partition(jds.reduce_by_key("sum",
                                                   distinct_hint=hint))
            t_conf.set_global_conf(t_conf.AsyncConf(
                {"async.shuffle.data.plane": "device"}))
            tds = t_dataset.DistributedDataset.from_array_pairs(ts, blocks)
            got = _by_partition(tds.reduce_by_key("sum",
                                                  distinct_hint=hint))
        finally:
            j_conf.set_global_conf(None)
            t_conf.set_global_conf(None)
            js.shutdown()
            ts.shutdown()
        kept = sum(len(k) for k, _ in got.values())
        distinct = len(np.unique(np.concatenate(
            [k for k, _ in blocks.values()])))
        assert kept == hint * 4 < distinct  # the hint binds
        for pid in want:
            np.testing.assert_array_equal(got[pid][0], want[pid][0])
            np.testing.assert_array_equal(got[pid][1], want[pid][1])


class TestAcrossSamples:
    port_modules = False

    def test_sample_and_sample_by_key_are_bit_equal(self):
        data = [(i % 7, float(i)) for i in range(2_000)]
        js = JScheduler(num_workers=4)
        ts = t_scheduler.JobScheduler(num_workers=4, devices=[CPU] * 4)
        try:
            jds = JDataset.from_list(js, data)
            tds = t_dataset.DistributedDataset.from_list(ts, data)
            for seed in (0, 7, 12345):
                assert (tds.sample(0.3, seed).collect()
                        == jds.sample(0.3, seed).collect())
                fr = {k: 0.1 * k for k in range(6)}
                assert (tds.sample_by_key(fr, seed).collect()
                        == jds.sample_by_key(fr, seed).collect())
            assert tds.sample(0.3, 1).count() != tds.sample(0.3, 2).count() \
                or tds.sample(0.3, 1).collect() != tds.sample(0.3, 2).collect()
        finally:
            js.shutdown()
            ts.shutdown()

    def test_partitioning_and_hash_are_equal(self):
        from asyncframework_tpu.data.pairs import portable_hash

        keys = ["a", b"b", 3, -4, 2.5, None, True, ("x", 1, ("y", b"z"))]
        for k in keys:
            assert t_pairs.portable_hash(k) == portable_hash(k)
        data = [(k, i) for i, k in enumerate(keys * 5)]
        js = JScheduler(num_workers=4)
        ts = t_scheduler.JobScheduler(num_workers=4, devices=[CPU] * 4)
        try:
            j = JDataset.from_list(js, data).partition_by(3)
            t = t_dataset.DistributedDataset.from_list(ts, data)
            t = t.partition_by(3)
            for pid in range(3):
                assert t._compute(pid) == j._compute(pid)
        finally:
            js.shutdown()
            ts.shutdown()


class TestAcrossCheckpointsAndStores:
    port_modules = False

    @staticmethod
    def _payloads(make_array):
        return {w: [(w, make_array(np.arange(5, dtype=np.float32) + w)),
                    {"k": make_array(np.full(2, w, np.int32)), "s": "x"},
                    float(w)]
                for w in range(4)}

    def _check(self, collected):
        rows = [collected[i:i + 3] for i in range(0, len(collected), 3)]
        for w, (pair, d, f) in enumerate(rows):
            assert pair[0] == w and isinstance(pair[1], np.ndarray)
            np.testing.assert_array_equal(pair[1],
                                          np.arange(5, dtype=np.float32) + w)
            np.testing.assert_array_equal(d["k"], np.full(2, w, np.int32))
            assert d["s"] == "x" and f == float(w)

    def test_a_port_checkpoint_loads_in_the_jax_package(self, tmp_path):
        ts = t_scheduler.JobScheduler(num_workers=4, devices=[CPU] * 4)
        js = JScheduler(num_workers=4)
        try:
            ck = str(tmp_path / "ck")
            t_dataset.DistributedDataset.from_partitions(
                ts, self._payloads(torch.from_numpy)).checkpoint(ck)
            self._check(JDataset.from_checkpoint(js, ck).collect())
        finally:
            js.shutdown()
            ts.shutdown()

    def test_a_jax_checkpoint_loads_in_the_port(self, tmp_path):
        import jax.numpy as jnp

        ts = t_scheduler.JobScheduler(num_workers=4, devices=[CPU] * 4)
        js = JScheduler(num_workers=4)
        try:
            ck = str(tmp_path / "ck")
            JDataset.from_partitions(
                js, self._payloads(jnp.asarray)).checkpoint(ck)
            back = t_dataset.DistributedDataset.from_checkpoint(ts, ck)
            self._check(back.collect())
            # and the payloads cross in memory too (convert.py)
            moved = convert.distributed_dataset_from_reference(
                ts, JDataset.from_partitions(js,
                                             self._payloads(jnp.asarray)))
            self._check(moved.collect())
        finally:
            js.shutdown()
            ts.shutdown()

    @pytest.mark.parametrize("writer,reader", [
        ("port:native", "jax:python"), ("port:python", "jax:native"),
        ("jax:native", "port:python"), ("jax:python", "port:native")])
    def test_a_store_file_is_read_by_the_other_package(self, tmp_path,
                                                       writer, reader):
        stores = {"port": t_kvstore.KVStore, "jax": JKVStore}
        path = tmp_path / "app.kv"
        pkg, backend = writer.split(":")
        with stores[pkg](path, backend=backend) as kv:
            assert kv.backend == backend
            for i in range(20):
                kv.put(f"k{i}", f"v{i}")
            kv.delete("k3")
            kv.put_obj("obj", {"a": [1, 2], "b": "c"})
            if backend == "native":
                kv.compact()
        pkg, backend = reader.split(":")
        with stores[pkg](path, backend=backend) as kv:
            assert len(kv) == 20
            assert kv.get("k3") is None and kv.get("k4") == b"v4"
            assert kv.get_obj("obj") == {"a": [1, 2], "b": "c"}
            kv.put("after", b"1")
        with stores[writer.split(":")[0]](path, backend="python") as kv:
            assert kv.get("after") == b"1"


def _staleness_script(pkg):
    """A fixed schedule of rounds -- barrier(bucket_predicate(ctx, 4, 0.5))
    then async_reduce -- with each task held until the script releases it,
    one merge at a time, under a fake clock.  Returns each round's cohort
    and each merge's (worker, staleness, batch size, clock after)."""
    if pkg == "port":
        Dataset, Scheduler, Context, bucket, Clock = (
            t_dataset.DistributedDataset, t_scheduler.JobScheduler,
            AsyncContext, t_barrier.bucket_predicate, ManualClock)
        kw = {"devices": [CPU] * 4}
    else:
        Dataset, Scheduler, Context, bucket, Clock = (
            JDataset, JScheduler, JAsyncContext, j_bucket, JManualClock)
        kw = {}
    gates = {w: threading.Semaphore(0) for w in range(4)}
    gating = {"on": False}

    def part(w):
        def compute():
            if gating["on"]:
                assert gates[w].acquire(timeout=30)
            return [float(w), float(10 * w + 1)]
        return compute

    sched = Scheduler(num_workers=4, clock=Clock(), **kw)
    ctx = Context()
    log = {"cohorts": [], "merges": []}
    try:
        ds = Dataset(sched, {w: part(w) for w in range(4)})
        ds.count()  # the scheduler's first job blocks (warm-up parity)
        gating["on"] = True
        # each round: workers released (in order) before the next round
        script = [[2, 0], [0], [], [1], [3, 2], [0, 1, 3]]
        for release in script:
            cohort, gated = ds.barrier(ctx, bucket(ctx, 4, 0.5))
            log["cohorts"].append(list(cohort))
            gated.async_reduce(lambda a, b: a + b, ctx, cohort=cohort)
            for w in release:
                gates[w].release()
                r = ctx.collect_all(timeout=30)
                log["merges"].append((r.worker_id, r.staleness,
                                      r.batch_size, r.data,
                                      ctx.get_current_time()))
        # drain the stragglers still held
        for w in range(4):
            gates[w].release()
        while ctx.available_workers() < 4:
            r = ctx.collect_all(timeout=30)
            log["merges"].append((r.worker_id, r.staleness, r.batch_size,
                                  r.data, ctx.get_current_time()))
        log["tasks"] = {w: s.num_tasks for w, s in ctx.states().items()}
        log["avg_ms"] = {w: s.average_task_time
                         for w, s in ctx.states().items()}
    finally:
        for w in range(4):
            gates[w].release()
        sched.shutdown()
    return log


class TestAcrossAsyncReduce:
    port_modules = False

    def test_staleness_sequence_is_the_jax_packages(self):
        port = _staleness_script("port")
        jax_log = _staleness_script("jax")
        assert port == jax_log
        stale = [m[1] for m in port["merges"]]
        assert max(stale) > 0 and stale[0] == 0
        assert [] in port["cohorts"]  # an empty cohort was skipped
        assert set(port["avg_ms"].values()) == {0.0}  # the fake clock


#: the random datasets' bands: (generator, args, mean, band on the mean,
#: variance, relative band on the variance) at n = 40,000 (the mean bands
#: are ~6 standard errors)
RANDOM_BANDS = [
    ("uniform_dataset", (), 0.5, 0.009, 1 / 12, 0.05),
    ("normal_dataset", (), 0.0, 0.03, 1.0, 0.05),
    ("poisson_dataset", (4.0,), 4.0, 0.06, 4.0, 0.06),
    ("exponential_dataset", (2.0,), 2.0, 0.06, 4.0, 0.08),
    ("gamma_dataset", (2.0, 3.0), 6.0, 0.13, 18.0, 0.08),
    ("log_normal_dataset", (0.0, 0.5), float(np.exp(0.125)), 0.02,
     float((np.exp(0.25) - 1) * np.exp(0.25)), 0.08),
]


#: the port's draws of :data:`RANDOM_BANDS`, in processes of their own:
#: after the JAX package's CPU computations in this process, a log-normal
#: draw (torch's CPU ``exp``) was seen, in some runs, to differ in one
#: element by 5e-5 from the same seed's next draw, so reproducibility is
#: held where no JAX runs
_DRAWS = """
import hashlib, json, sys
import numpy as np, torch
from asyncframework_tpu_torch.data import random as t_random
from asyncframework_tpu_torch.engine.scheduler import JobScheduler
ts = JobScheduler(num_workers=4, devices=[torch.device("cpu")] * 4)
out = {}
for name, args in json.loads(sys.argv[1]):
    a = getattr(t_random, name)(ts, 40_000, *args, seed=3).collect()
    b = getattr(t_random, name)(ts, 40_000, *args, seed=3).collect()
    c = getattr(t_random, name)(ts, 40_000, *args, seed=4).collect()
    v = np.asarray(a)
    out[name] = {"n": len(a), "a_is_b": a == b, "a_is_not_c": a != c,
                 "digest": hashlib.sha256(v.tobytes()).hexdigest(),
                 "mean": float(v.mean()), "var": float(v.var())}
ts.shutdown()
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _port_draws():
    """Two processes' records of the port's draws, by generator."""
    import json

    args = json.dumps([(name, list(a)) for name, a, *_ in RANDOM_BANDS])
    runs = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-c", _DRAWS, args], capture_output=True,
            text=True, timeout=300, cwd=REPO,
            env={"PATH": "/usr/bin:/bin", "HOME": REPO, "PYTHONPATH": REPO})
        assert out.returncode == 0, out.stderr
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    return runs


class TestAcrossRandomDatasets:
    port_modules = False

    @pytest.mark.parametrize("name,args,mean,mband,var,vband", RANDOM_BANDS)
    def test_reproducible_and_within_bands(self, name, args, mean, mband,
                                           var, vband):
        """The port's draws: equal for one seed within a process and across
        two processes, different for another seed; the port's and the JAX
        package's moments within the stated bands (threefry and torch's
        generator cannot be bit-equal, ROADMAP C2)."""
        first, second = (run[name] for run in _port_draws())
        assert first["a_is_b"] and first["a_is_not_c"], name
        assert first["digest"] == second["digest"], name
        js = JScheduler(num_workers=4)
        try:
            j = np.asarray(getattr(j_random, name)(js, 40_000, *args,
                                                   seed=3).collect())
        finally:
            js.shutdown()
        assert first["n"] == j.size == 40_000
        for m, v in ((first["mean"], first["var"]), (j.mean(), j.var())):
            assert abs(m - mean) < mband, (name, m)
            assert abs(v / var - 1) < vband, (name, v)

    @pytest.mark.parametrize("name", ["uniform_vector_dataset",
                                      "normal_vector_dataset"])
    def test_vectors(self, name):
        ts = t_scheduler.JobScheduler(num_workers=4, devices=[CPU] * 4)
        try:
            ds = getattr(t_random, name)(ts, 1_000, 6, num_partitions=3,
                                         seed=5)
            rows = ds.collect()
            again = getattr(t_random, name)(ts, 1_000, 6, num_partitions=3,
                                            seed=5).collect()
        finally:
            ts.shutdown()
        assert ds.num_partitions == 3 and len(rows) == 1_000
        assert all(r.shape == (6,) and r.dtype == np.float32 for r in rows)
        np.testing.assert_array_equal(np.stack(rows), np.stack(again))
        m = np.stack(rows).mean()
        assert abs(m - (0.5 if name.startswith("uniform") else 0.0)) < 0.03

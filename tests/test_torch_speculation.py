"""Speculation, dynamic allocation and the accumulators in the port, and
one draw a task, on the CPU.

``engine/{speculation,allocation,accumulator}.py`` are copied into the
port; the scenarios of ``tests/test_fault_tolerance.py`` (speculation),
``tests/test_allocation.py`` and the accumulator cases of
``tests/test_sketch_accum.py`` run on both packages (parametrized
``pkg``).  Then the solvers: every body of a task -- a retry, a
speculative copy, an allocation sibling -- computes the same gradient
from one draw, and the generator advances once a task, as the JAX
package's key does; ``run()`` and ``run_sync()`` speculate around an
injected straggler and grow siblings; and every ``run()`` switch is on at
once for ASGD ``run()``/``run_sync()`` and ASAGA ``run()``, dense and
padded-ELL.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from asyncframework_tpu.data import make_regression, make_sparse_regression

PKGS = ["asyncframework_tpu", "asyncframework_tpu_torch"]
CPU = [torch.device("cpu")]


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _slow_task(gate):
    def fn():
        gate.wait(5.0)
        return 1

    return fn


# ------------------------------------------------------------ speculation
@pytest.mark.parametrize("pkg", PKGS)
def test_find_speculatable(pkg):
    find = mod(pkg, "engine.speculation").find_speculatable
    assert find([100.0], {1: 10_000.0}, quantile=0.75) == []
    finished = [100.0, 110.0, 90.0, 105.0, 95.0, 100.0]
    assert find(finished, {6: 500.0, 7: 120.0}, quantile=0.5,
                multiplier=1.5) == [6]
    assert find([1.0, 1.0, 1.0], {3: 20.0}, quantile=0.5, multiplier=1.5,
                min_time_ms=100.0) == []
    assert find([], {0: 1e9}) == []


@pytest.mark.parametrize("pkg", PKGS)
def test_speculative_copy_rescues_stuck_task(pkg):
    """7 fast tasks and one stuck; the copy finishes the job while the
    primary is blocked, and the primary's late result is dropped."""
    sm = mod(pkg, "engine.scheduler")
    release = threading.Event()
    first = {"done": False}
    lock = threading.Lock()

    def make_fn(wid):
        if wid != 7:
            return lambda: wid

        def stuck():
            with lock:
                is_first = not first["done"]
                first["done"] = True
            if is_first:
                release.wait(timeout=30)
            return wid

        return stuck

    sched = sm.JobScheduler(num_workers=8)
    sched.set_mode(sm.ASYNC)
    monitor = mod(pkg, "engine.speculation").SpeculationMonitor(
        sched, quantile=0.75, multiplier=1.5, min_time_ms=10.0)
    results, res_lock = [], threading.Lock()

    def handler(wid, r):
        with res_lock:
            results.append((wid, r))

    try:
        sched.run_job({0: lambda: None}, lambda w, r: None)
        waiter = sched.run_job({w: make_fn(w) for w in range(8)}, handler)
        deadline = time.monotonic() + 30
        launched = []
        while not launched and time.monotonic() < deadline:
            time.sleep(0.05)
            launched = monitor.check_once()
        assert launched
        waiter.await_result(timeout=30)
        release.set()
        time.sleep(0.3)
        with res_lock:
            assert sorted(r for _, r in results) == list(range(8))
        assert monitor.speculated_count() == 1
        assert monitor.check_once() == []  # one copy a task
    finally:
        release.set()
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_speculative_copy_is_dropped(pkg):
    sm = mod(pkg, "engine.scheduler")
    release = threading.Event()
    calls = {"n": 0}
    lock = threading.Lock()

    def task():
        with lock:
            calls["n"] += 1
            is_first = calls["n"] == 1
        if is_first:
            release.wait(timeout=30)
            return "primary"
        raise RuntimeError("speculative copy crashes")

    sched = sm.JobScheduler(num_workers=2, max_task_failures=1)
    sched.set_mode(sm.ASYNC)
    monitor = mod(pkg, "engine.speculation").SpeculationMonitor(
        sched, quantile=0.5, min_time_ms=1.0)
    results = []
    try:
        sched.run_job({0: lambda: None}, lambda w, r: None)
        waiter = sched.run_job({0: task, 1: lambda: "fast"},
                               lambda w, r: results.append(r))
        deadline = time.monotonic() + 30
        while not monitor.check_once():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        time.sleep(0.2)
        assert waiter.failed is None
        release.set()
        waiter.await_result(timeout=30)
        assert sorted(results) == ["fast", "primary"]
    finally:
        release.set()
        sched.shutdown()


# ------------------------------------------------------ dynamic allocation
@pytest.mark.parametrize("pkg", PKGS)
def test_scale_up_on_sustained_backlog_then_down_when_idle(pkg):
    sm = mod(pkg, "engine.scheduler")
    sched = sm.JobScheduler(num_workers=2)
    sched.set_mode(sm.ASYNC)
    clock = mod(pkg, "utils.clock").ManualClock()
    mgr = mod(pkg, "engine.allocation").ExecutorAllocationManager(
        sched, max_extra_per_slot=1, backlog_threshold=2, sustained_ticks=2,
        idle_timeout_s=0.5, clock=clock)
    gate = threading.Event()
    try:
        for _ in range(3):
            sched.run_job({0: _slow_task(gate)}, lambda *a: None)
        assert sched.pool.slot_backlog(0) >= 2
        assert mgr.check_once() == []
        assert mgr.check_once() == [(0, 1)]
        assert sched.pool.sibling_count(0) == 1
        assert mgr.check_once() == []
        gate.set()
        deadline = time.monotonic() + 5
        while sched.pool.slot_backlog(0) > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert mgr.check_once() == []
        clock.advance(600)
        assert mgr.check_once() == [(0, -1)]
        assert sched.pool.sibling_count(0) == 0
        assert mgr.counts() == (1, 1)
    finally:
        gate.set()
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_no_scale_without_backlog_and_validation(pkg):
    sm = mod(pkg, "engine.scheduler")
    Mgr = mod(pkg, "engine.allocation").ExecutorAllocationManager
    sched = sm.JobScheduler(num_workers=2)
    try:
        mgr = Mgr(sched, backlog_threshold=1)
        assert mgr.check_once() == [] and mgr.counts() == (0, 0)
        with pytest.raises(ValueError):
            Mgr(sched, backlog_threshold=0)
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_sibling_drains_backlog_concurrently(pkg):
    sm = mod(pkg, "engine.scheduler")
    sched = sm.JobScheduler(num_workers=1)
    sched.set_mode(sm.ASYNC)
    try:
        sched.pool.add_sibling(0)
        sched.run_job({0: (lambda: 0)}, lambda *a: None)
        t0 = time.monotonic()
        waiters = [sched.run_job({0: (lambda: time.sleep(0.3) or 1)},
                                 lambda *a: None) for _ in range(2)]
        for w in waiters:
            w.await_result(timeout=5)
        assert time.monotonic() - t0 < 0.55
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_dead_sibling_dropped_without_slot_escalation(pkg):
    sm = mod(pkg, "engine.scheduler")
    HM = mod(pkg, "engine.heartbeat").HeartbeatMonitor
    sched = sm.JobScheduler(num_workers=2)
    try:
        sib = sched.pool.add_sibling(1)
        lost, sib_events = [], []
        mon = HM(sched.pool, on_executor_lost=lost.append, timeout_ms=1000.0,
                 on_sibling_lost=lambda w, q, r: sib_events.append(w))
        assert mon.check_once() == []
        sib.kill()
        assert mon.check_once() == []
        assert sib_events == [1] and lost == []
        assert sched.pool.sibling_count(1) == 0
        assert mon.check_once() == []
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_sibling_loss_without_handler_escalates_to_slot(pkg):
    sm = mod(pkg, "engine.scheduler")
    HM = mod(pkg, "engine.heartbeat").HeartbeatMonitor
    sched = sm.JobScheduler(num_workers=1)
    try:
        sib = sched.pool.add_sibling(0)
        lost = []
        mon = HM(sched.pool, on_executor_lost=lost.append, timeout_ms=1000.0)
        sib.kill()
        assert mon.check_once() == [0] and lost == [0]
        assert sched.pool.sibling_count(0) == 0
    finally:
        sched.shutdown()


# ------------------------------------------------------------ accumulators
@pytest.mark.parametrize("pkg", PKGS)
def test_accumulators_sum_merge_and_self_merge(pkg):
    acc = mod(pkg, "engine.accumulator")
    a = acc.LongAccumulator("steps")
    for i in range(10):
        a.add(i)
    assert (a.value, a.count, a.avg) == (45, 10, 4.5)
    a.reset()
    assert a.value == 0 and a.count == 0
    x, y = acc.LongAccumulator(), acc.LongAccumulator()
    x.add(5)
    y.add(7)
    y.add(1)
    x.merge(y)
    assert x.value == 13 and x.count == 3
    x.merge(x)  # doubles, must not hang
    assert x.value == 26
    d = acc.DoubleAccumulator()
    d.add(1.5)
    d.merge(d)
    assert d.value == 3.0
    c = acc.CollectionAccumulator()
    c.add("x")
    c.add(["y", "z"])
    assert c.value == ["x", "y", "z"]
    m = acc.MaxAccumulator()
    m.add(3.0)
    m.add(-1.0)
    assert m.value == 3.0


@pytest.mark.parametrize("pkg", PKGS)
def test_accumulator_thread_safety_and_task_updates(pkg):
    acc = mod(pkg, "engine.accumulator")
    total = acc.DoubleAccumulator()

    def worker():
        for _ in range(5000):
            total.add(1.0)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
        assert not t.is_alive()
    assert total.value == 40_000.0
    sm = mod(pkg, "engine.scheduler")
    sched = sm.JobScheduler(num_workers=4)
    rows = acc.LongAccumulator("rows")
    try:
        sched.run_job({w: (lambda: rows.add(10)) for w in range(4)},
                      lambda *a: None)
        assert rows.value == 40
    finally:
        sched.shutdown()


# ---------------------------------------------------------- one draw a task
def _port_data(sparse):
    if sparse:
        from asyncframework_tpu_torch.data import SparseShardedDataset

        csr = make_sparse_regression(512, 64, 0.1, seed=2)
        return SparseShardedDataset(*csr, 64, 4, devices=CPU), None, csr
    X, y, _ = make_regression(512, 16, seed=2)
    return X, y, (X, y)


def _cfg(pkg, **kw):
    base = dict(num_workers=4, num_iterations=20, gamma=0.1, batch_rate=0.3,
                bucket_ratio=0.5, printer_freq=10, seed=42,
                calibration_iters=10, run_timeout_s=120.0)
    base.update(kw)
    return mod(pkg, "solvers").SolverConfig(**base)


def _outputs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [t for t in out if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("solver", ["ASGD", "ASAGA"])
def test_every_body_of_a_task_uses_one_draw(solver, sparse, devices8):
    """A task's ``fn`` run twice, as a retry (or a speculative copy, or an
    allocation sibling) runs it: both bodies give bit-equal results, and
    the worker's generator has advanced by exactly one draw.  The JAX
    package's task, given its key at submit, is the same."""
    from asyncframework_tpu_torch.engine.straggler import DelayModel
    from asyncframework_tpu_torch.ops.sampling import worker_generator

    data, y, ref_data = _port_data(sparse)
    s = getattr(mod("asyncframework_tpu_torch", "solvers"), solver)(
        data, y, _cfg("asyncframework_tpu_torch"), devices=CPU)
    gens, locks = s._generators()
    wid = 1
    w = torch.linspace(-0.5, 0.5, s.ds.d)
    args = (wid, w) + ((s._zeros(s.ds.shard(wid).size),)
                       if solver == "ASAGA" else ()) + (
        gens[wid], locks[wid], DelayModel(0.0, 4, 42))
    fn = s._make_task(*args)
    first, second = _outputs(fn()), _outputs(fn())
    assert len(first) == len(second) >= 1
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    once = worker_generator(42, wid, CPU[0])
    s._step.sample(once, s.ds.shard(wid).size)
    assert torch.equal(gens[wid].get_state(), once.get_state())

    # the JAX package: the task's key is fixed at submit
    import jax

    from asyncframework_tpu.data import SparseShardedDataset as JaxSparse
    from asyncframework_tpu.engine.straggler import DelayModel as JaxDelay

    if sparse:
        jdata, jy = JaxSparse(*ref_data, 64, 4, devices8[:4]), None
    else:
        jdata, jy = ref_data
    js = getattr(mod("asyncframework_tpu", "solvers"), solver)(
        jdata, jy, _cfg("asyncframework_tpu"), devices=devices8[:4])
    key = jax.random.fold_in(jax.random.PRNGKey(42), wid)
    jw = jax.numpy.asarray(w.numpy())
    jargs = (wid, jw, key) + ((jax.numpy.zeros(js.ds.shard(wid).size),)
                              if solver == "ASAGA" else ()) + (
        JaxDelay(0.0, 4, 42),)
    jfn = js._make_task(*jargs)
    for a, b in zip(jax.tree_util.tree_leaves(jfn()),
                    jax.tree_util.tree_leaves(jfn())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -------------------------------------------------------- the solver wiring
@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_regression(2048, 32, seed=3)
    return X, y


def _wiring_cfg(**kw):
    base = dict(num_workers=8, num_iterations=200, gamma=0.5,
                taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.5,
                printer_freq=50, coeff=0.0, seed=42, calibration_iters=10,
                run_timeout_s=120.0)
    base.update(kw)
    return _cfg("asyncframework_tpu_torch", **base)


def test_sync_run_speculates_around_straggler(problem):
    from asyncframework_tpu_torch.solvers import ASGD

    X, y = problem
    cfg = _wiring_cfg(num_iterations=40, coeff=3.0, calibration_iters=5,
                      speculation=True, speculation_quantile=0.5,
                      speculation_multiplier=1.3, speculation_min_ms=5.0)
    res = ASGD(X, y, cfg, devices=CPU).run_sync()
    assert res.rounds == 40
    assert res.extras.get("speculated", 0) >= 1


def test_async_run_speculative_copy_wins(problem, tmp_path):
    """A speculative copy launches and claims the slot before its delayed
    primary (the injected delay fires only in the first body), and each
    launch reaches the event log.  Timing-based: a loaded host can starve
    the copy's window, so up to four attempts."""
    from asyncframework_tpu_torch.metrics import EventLogReader
    from asyncframework_tpu_torch.metrics.bus import SpeculativeLaunch
    from asyncframework_tpu_torch.solvers import ASGD

    X, y = problem
    for attempt in range(4):
        log = tmp_path / f"spec{attempt}.jsonl"
        cfg = _wiring_cfg(num_iterations=150, coeff=120.0,
                          calibration_iters=5, speculation=True,
                          speculation_quantile=0.3,
                          speculation_multiplier=1.2,
                          speculation_min_ms=10.0, event_log=str(log))
        res = ASGD(X, y, cfg, devices=CPU).run()
        if res.extras.get("speculation_wins", 0) >= 1:
            break
    assert res.accepted == 150
    assert res.extras["speculated"] >= 1
    assert res.extras["speculation_wins"] >= 1
    # one event a launched copy; ``speculated`` also counts a task whose
    # copy found no spare to launch on
    launches = [e for e in EventLogReader(log).replay()
                if isinstance(e, SpeculativeLaunch)]
    assert 1 <= len(launches) <= res.extras["speculated"]


def test_async_run_with_dynamic_allocation(problem):
    from asyncframework_tpu_torch.solvers import ASGD

    X, y = problem
    cfg = _wiring_cfg(dynamic_allocation=True,
                      allocation_backlog_threshold=1,
                      allocation_idle_timeout_s=0.05)
    res = ASGD(X, y, cfg, devices=CPU).run()
    assert res.accepted == 200
    assert "executors_added" in res.extras
    assert np.all(np.isfinite(res.final_w))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("entry", ["ASGD.run", "ASGD.run_sync", "ASAGA.run"])
def test_every_switch_at_once(entry, sparse, tmp_path):
    """Checkpoint, speculation (stragglers injected), dynamic allocation,
    the event log, CSV/JSONL metrics and tracing, all on: the run
    completes and converges, and each sink holds what it should."""
    from asyncframework_tpu_torch.metrics import EventLogReader, trace

    data, y, _ = _port_data(sparse)
    name, method = entry.split(".")
    cfg = _cfg(
        "asyncframework_tpu_torch", num_iterations=60,
        gamma=0.5 if name == "ASGD" else 0.05, coeff=2.0, calibration_iters=8,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_freq=20,
        event_log=str(tmp_path / "ev.jsonl"),
        metrics_csv=str(tmp_path / "m.csv"),
        metrics_jsonl=str(tmp_path / "m.jsonl"), metrics_period_s=0.2,
        trace_sample=0.25, speculation=True, speculation_quantile=0.5,
        speculation_min_ms=1.0, dynamic_allocation=True,
        allocation_backlog_threshold=1)
    solver = getattr(mod("asyncframework_tpu_torch", "solvers"), name)(
        data, y, cfg, devices=CPU)
    res = getattr(solver, method)()
    assert np.isfinite(res.final_w).all()
    assert res.final_objective < res.trajectory[0][1]
    assert {"speculated", "speculation_wins", "executors_added",
            "executors_removed"} <= set(res.extras)
    summary = EventLogReader(tmp_path / "ev.jsonl").summary()
    assert summary["merges"] >= 60 and summary["rounds"] > 0
    assert (tmp_path / "m.csv").read_text().count("\n") >= 2
    assert (tmp_path / "m.jsonl").stat().st_size > 0
    spans, _ = trace.load_trace_events(tmp_path / "ev.jsonl")
    assert {s.stage for s in spans} >= {"compute", "merge.apply"}
    if method == "run":
        from asyncframework_tpu_torch.checkpoint import CheckpointManager

        assert res.extras["checkpoint_saves"] >= 3
        assert CheckpointManager(tmp_path / "ck").latest_step() == 60

"""The port's copies of the JAX-free modules against their originals.

``context.py``, ``utils/clock.py`` and ``engine/*`` are copied into the
port (it may not import the JAX package).  Each test here runs the same
scenario on both packages' modules (parametrized ``pkg``) so a copy that
drifts fails beside the original; the torch-specific modules
(``broadcast.py``, ``engine/recovery.py``, ``utils/hbm.py``) are held to
the JAX package's semantics on CPU tensors.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

PKGS = ["asyncframework_tpu", "asyncframework_tpu_torch"]


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def collector():
    results = []
    lock = threading.Lock()

    def handler(wid, res):
        with lock:
            results.append((wid, res))

    return results, handler


@pytest.mark.parametrize("pkg", PKGS)
def test_scheduler_modes_and_streaming(pkg):
    sm = mod(pkg, "engine.scheduler")
    sched = sm.JobScheduler(num_workers=2)
    try:
        results, handler = collector()
        sched.set_mode(sm.ASYNC)
        # the first job blocks even in async mode (warm-up parity)
        assert sched.run_job({0: lambda: 0, 1: lambda: 1}, handler).completed
        results.clear()
        gate = threading.Event()
        waiter = sched.run_job(
            {0: lambda: "fast", 1: lambda: (gate.wait(5), "slow")[1]}, handler
        )
        deadline = time.monotonic() + 5
        while not results and time.monotonic() < deadline:
            time.sleep(0.005)
        assert results == [(0, "fast")]
        gate.set()
        waiter.await_result(timeout=5)
        assert sorted(results) == [(0, "fast"), (1, "slow")]
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_then_abort(pkg):
    sm = mod(pkg, "engine.scheduler")
    sched = sm.JobScheduler(num_workers=1, max_task_failures=3)
    try:
        attempts = {"n": 0}

        def flaky():
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RuntimeError("transient")
            return "ok"

        results, handler = collector()
        assert sched.run_job({0: flaky}, handler).completed
        assert results == [(0, "ok")] and attempts["n"] == 3

        def always_fail():
            raise ValueError("boom")

        with pytest.raises(RuntimeError, match="failed 3 times"):
            sched.run_job({0: always_fail}, handler)
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_executor_loss_resubmits_inflight_task(pkg):
    sm = mod(pkg, "engine.scheduler")
    hb = mod(pkg, "engine.heartbeat")
    sched = sm.JobScheduler(num_workers=2)
    try:
        results, handler = collector()
        sched.run_job({0: lambda: 0, 1: lambda: 1}, handler)
        results.clear()
        sched.set_mode(sm.ASYNC)
        release = threading.Event()
        ran = []

        def task0():
            ran.append(1)
            if not release.is_set():
                time.sleep(30)
            return "recovered"

        waiter = sched.run_job({0: task0, 1: lambda: "fine"}, handler)
        monitor = hb.HeartbeatMonitor(sched.pool, sched.on_executor_lost,
                                      timeout_ms=1e9)
        deadline = time.monotonic() + 5
        while not ran and time.monotonic() < deadline:
            time.sleep(0.01)
        release.set()
        sched.pool.kill(0)
        assert monitor.check_once() == [0]
        waiter.await_result(timeout=10)
        assert sorted(results) == [(0, "recovered"), (1, "fine")]
        assert len(ran) == 2
    finally:
        sched.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_barrier_and_context_bookkeeping(pkg):
    ctx = mod(pkg, "context").AsyncContext()
    barrier = mod(pkg, "engine.barrier")
    assert barrier.partial_barrier(ctx, 4, lambda ws: False) == [0, 1, 2, 3]
    ctx.mark_busy([0, 1, 2, 3])
    ctx.set_current_time(5)
    res = ctx.merge_result(2, "g", submit_clock=3, elapsed_ms=4.0, batch_size=7)
    assert (res.staleness, res.batch_size, res.worker_id) == (2, 7, 2)
    assert ctx.get_current_time() == 6 and ctx.max_staleness() == 2
    pred = barrier.bucket_predicate(ctx, 4, 0.25)  # needs floor(1) available
    assert barrier.partial_barrier(ctx, 4, pred) == [2]
    assert ctx.collect_all(timeout=1).data == "g"


@pytest.mark.parametrize("coeff", [-1, 2.0, 0.0])
def test_delay_model_draws_match(coeff):
    models = [mod(p, "engine.straggler").DelayModel(coeff, 8, seed=7)
              for p in PKGS]
    for m in models:
        m.calibrate(10.0)
    for _ in range(5):
        for wid in range(8):
            a, b = (m.delay_ms(wid) for m in models)
            assert a == b


@pytest.mark.parametrize("pkg", PKGS)
def test_blacklist_with_manual_clock(pkg):
    clock = mod(pkg, "utils.clock").ManualClock()
    bl = mod(pkg, "engine.blacklist").BlacklistTracker(
        max_failures=2, timeout_ms=100.0, clock=clock
    )
    bl.record_failure(3)
    assert not bl.is_blacklisted(3)
    bl.record_failure(3)
    assert bl.blacklisted_workers() == [3]
    clock.advance(150.0)
    assert not bl.is_blacklisted(3)


def test_recovery_plan_matches_and_moves_tensors():
    plans = [mod(p, "engine.recovery").plan_reassignment(range(5), [1, 3])
             for p in PKGS]
    assert plans[0].moves == plans[1].moves
    from asyncframework_tpu_torch.data import ShardedDataset
    from asyncframework_tpu_torch.engine.recovery import ShardRecovery

    X = np.arange(24, dtype=np.float32).reshape(8, 3)
    cpu = torch.device("cpu")
    ds = ShardedDataset(X, X[:, 0].copy(), 4, devices=[cpu])
    rec = ShardRecovery(ds, [cpu])
    moved = rec.move_shard(1, 2)
    assert rec.owner(1) == 2 and moved.device == cpu
    assert [s.worker_id for s in rec.assignments(2)] == [1, 2]
    np.testing.assert_array_equal(rec.shard(1).X.numpy(), X[2:4])


def test_versioned_store_semantics():
    from asyncframework_tpu_torch.broadcast import VersionedModelStore

    cpu = torch.device("cpu")
    store = VersionedModelStore(max_live_versions=2)
    with pytest.raises(KeyError):
        store.latest_version()
    w = np.zeros(3, np.float32)
    v0 = store.publish(w, devices=[cpu])
    w[:] = 1.0  # the store holds a snapshot, not the caller's array
    v1 = store.publish(w)
    assert store.value(cpu, version=v0).tolist() == [0.0, 0.0, 0.0]
    assert store.value(cpu).tolist() == [1.0, 1.0, 1.0]
    store.publish(w)
    assert store.live_versions() == [v1, v1 + 1]
    with pytest.raises(KeyError):
        store.value(cpu, version=v0)


def test_memory_plan_and_flops():
    from asyncframework_tpu_torch.utils import flops, hbm

    plan = hbm.plan_for_run((1000, 10), 4, 1, "cpu", budget_bytes=10**9)
    assert plan.fits
    assert plan.bytes_per_device == 4 * 250 * 11 * 4 + 2 * 10 * 4
    with pytest.raises(MemoryError):
        hbm.plan_for_run((10**6, 100), 4, 1, "cpu", budget_bytes=10**6).require_fits()
    assert hbm.device_memory_bytes("cpu") > 0
    assert flops.dense_task_flops(10, 5) == 200.0
    assert flops.chip_peak_flops("cpu") is None


def test_exit_hook_joins_an_executor_stopped_mid_task():
    """The port's executors, told to stop while one holds a task, finish
    it before the interpreter exits (``engine/executor.py``'s exit hook):
    a daemon thread left inside a torch op when the runtime is torn down
    aborts the process after the run has printed its result."""
    from asyncframework_tpu_torch.engine import executor as ex_mod
    from asyncframework_tpu_torch.engine.job import TaskSpec

    started, done = threading.Event(), []

    def fn():
        started.set()
        time.sleep(0.3)
        return torch.ones(4).sum()

    ex = ex_mod.DeviceExecutor(0, lambda e, t, r, exc: done.append(r))
    ex.launch_task(TaskSpec(job_id=0, worker_id=0, fn=fn))
    assert started.wait(5)
    ex.shutdown()
    assert ex._thread.is_alive()  # still in the task
    ex_mod._join_stopping()
    assert not ex._thread.is_alive() and [float(r) for r in done] == [4.0]

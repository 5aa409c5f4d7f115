"""The port's ASGD solver against the JAX package's, end to end on the CPU.

``run_sync()`` with ``batch_rate=1.0`` is deterministic in both packages
(every mask is all ones), so the final model and the trajectory are held
to ``rtol=1e-5, atol=1e-5 * max|w|``: the per-worker gradients and the
drained sum differ only in f32 summation order, and XLA's folded step
coefficient differs from the port's in its last bit.

``run()`` is asynchronous, so it is held to invariants both packages keep
(the accepted count, the staleness filter) and to a band around the JAX
run's final objective: the arrival order, hence every staleness, differs
from run to run, and the two packages draw different sample bits.
"""

import numpy as np
import pytest
import torch

from asyncframework_tpu.data import make_classification, make_regression
from asyncframework_tpu.solvers import ASGD as JaxASGD
from asyncframework_tpu.solvers import SolverConfig as JaxConfig
from asyncframework_tpu.solvers import instrumentation as jax_inst
from asyncframework_tpu_torch.convert import dataset_from_reference
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.solvers import instrumentation as port_inst

CPU = [torch.device("cpu")]


def _cfg(**kw):
    base = dict(num_workers=4, num_iterations=300, gamma=1.0, batch_rate=0.3,
                bucket_ratio=0.5, printer_freq=50, seed=42,
                calibration_iters=10, run_timeout_s=120.0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def regression():
    X, y, _ = make_regression(2048, 32, seed=3)
    return X, y


@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_run_sync_matches_jax_trajectory(loss):
    if loss == "logistic":
        X, y, _ = make_classification(2048, 16, seed=5)
        gamma = 2.0
    else:
        X, y, _ = make_regression(2048, 32, seed=3)
        gamma = 1.0
    kw = _cfg(num_iterations=40, batch_rate=1.0, printer_freq=10,
              gamma=gamma, loss=loss)
    ref = JaxASGD(X, y, JaxConfig(**kw)).run_sync()
    got = ASGD(X, y, SolverConfig(**kw), devices=CPU).run_sync()
    scale = float(np.abs(ref.final_w).max())
    np.testing.assert_allclose(got.final_w, ref.final_w, rtol=1e-5,
                               atol=1e-5 * scale)
    assert len(got.trajectory) == len(ref.trajectory) == 6
    np.testing.assert_allclose([o for _, o in got.trajectory],
                               [o for _, o in ref.trajectory], rtol=1e-5)
    assert got.rounds == ref.rounds == 40
    assert got.accepted == ref.accepted == 160
    assert got.total_flops == ref.total_flops


def test_run_sync_on_the_jax_shards(regression):
    """The same run from the JAX package's own device shards, carried
    across as numpy (``convert.dataset_from_reference``); the drained sum's
    arrival order still varies, hence ``rtol=1e-6``."""
    from asyncframework_tpu.data.sharded import ShardedDataset as JaxDataset

    X, y = regression
    kw = _cfg(num_iterations=10, batch_rate=1.0, printer_freq=5)
    jds = JaxDataset(X, y, 4)
    shards = [(np.asarray(s.X), np.asarray(s.y)) for s in jds.shards.values()]
    ds = dataset_from_reference(shards, CPU)
    assert ds.partition_cum == jds.partition_cum
    got = ASGD(ds, None, SolverConfig(**kw), devices=CPU).run_sync()
    want = ASGD(X, y, SolverConfig(**kw), devices=CPU).run_sync()
    np.testing.assert_allclose(got.final_w, want.final_w, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want.final_w).max()))


def _record_merges(monkeypatch, module):
    seen = []
    orig = module.RunInstruments.on_gradient_merged

    def spy(self, worker_id, staleness, accepted, iteration, **kw):
        seen.append((staleness, accepted))
        return orig(self, worker_id, staleness, accepted, iteration, **kw)

    monkeypatch.setattr(module.RunInstruments, "on_gradient_merged", spy)
    return seen


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_staleness_filter_invariants(pkg, regression, monkeypatch):
    """taw=1: every accepted result had staleness <= 1, every dropped one
    more; the run still accepts exactly num_iterations.  Held in both
    packages."""
    X, y = regression
    kw = _cfg(num_iterations=150, taw=1)
    if pkg == "port":
        seen = _record_merges(monkeypatch, port_inst)
        res = ASGD(X, y, SolverConfig(**kw), devices=CPU).run()
    else:
        seen = _record_merges(monkeypatch, jax_inst)
        res = JaxASGD(X, y, JaxConfig(**kw)).run()
    assert res.accepted == 150
    assert sum(a for _, a in seen) == 150
    assert all(s <= 1 for s, a in seen if a)
    assert all(s > 1 for s, a in seen if not a)
    assert res.dropped == sum(1 for _, a in seen if not a)


def test_taw_zero_drops_stale_results(regression):
    X, y = regression
    res = ASGD(X, y, SolverConfig(**_cfg(num_iterations=100, taw=0)),
               devices=CPU).run()
    # with 4 concurrent workers and tau=0, some results must be stale
    assert res.accepted == 100
    assert res.dropped > 0


def test_async_objective_within_band_of_jax(regression):
    """Both runs converge (final objective below 1/20 of the objective at
    w = 0), and the port's final objective lies within a factor of 3 of
    the JAX run's (measured ratios on this problem: 1.1 to 1.4)."""
    X, y = regression
    kw = _cfg()
    ref = JaxASGD(X, y, JaxConfig(**kw)).run()
    got = ASGD(X, y, SolverConfig(**kw), devices=CPU).run()
    assert got.accepted == ref.accepted == 300
    assert got.dropped == ref.dropped == 0  # taw = inf
    obj0 = ref.trajectory[0][1]
    assert got.trajectory[0][1] == pytest.approx(obj0, rel=1e-6)
    for r in (ref, got):
        assert r.final_objective < obj0 / 20, r.trajectory
    assert 1 / 3 < got.final_objective / ref.final_objective < 3
    times = [t for t, _ in got.trajectory]
    assert all(b >= a for a, b in zip(times, times[1:]))


def test_stale_reads_and_batched_drain_converge(regression):
    X, y = regression
    kw = _cfg(num_iterations=200, stale_read_offset=1, drain_batch=8)
    res = ASGD(X, y, SolverConfig(**kw), devices=CPU).run()
    assert res.accepted == 200
    assert res.final_objective < res.trajectory[0][1] / 10


@pytest.mark.parametrize("option", [
    dict(speculation=True), dict(dynamic_allocation=True),
    dict(checkpoint_dir="ckpt"), dict(event_log="log.jsonl"),
    dict(ui_port=0), dict(trace_sample=0.5), dict(metrics_csv="m.csv"),
])
def test_unported_features_raise(option, regression):
    X, y = regression
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ASGD(X, y, SolverConfig(**_cfg(num_iterations=5, **option)),
             devices=CPU).run()


def test_run_fused_is_not_ported_yet(regression):
    """``run_fused`` was a stub that raised; it is ported now and runs the
    whole budget in full waves on the CPU (``tests/test_torch_fused.py``
    holds it against the JAX package)."""
    X, y = regression
    res = ASGD(X, y, SolverConfig(**_cfg()), devices=CPU).run_fused()
    assert res.extras["fused"] is True
    assert res.accepted == 300 and res.rounds == 75 and res.dropped == 0
    assert res.final_objective < res.trajectory[0][1] / 10

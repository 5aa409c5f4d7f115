"""The port's ``MiniBatchSGD`` against the JAX package's.

Twins of ``tests/test_solvers.py``'s ``TestMiniBatchSGD`` and
``TestMiniBatchSGD2D`` on the port (``devices=[cpu] * 8``, the counterpart
of the JAX package's 8 virtual CPU devices), then the two packages on the
same inputs: at ``batch_rate = 1.0`` every Bernoulli draw keeps every row
in both, so the runs are the same computation, and every updater x loss
on a 1-D and a 2-D mesh agrees for 40 iterations to rtol 1e-4, atol 1e-6
(f32 products summed in two libraries' orders).  Below 1.0 the packages'
draws differ (torch generators against threefry, ROADMAP C2).
"""

import numpy as np
import pytest
import torch

import jax

from asyncframework_tpu.parallel import make_mesh as jmake_mesh
from asyncframework_tpu.solvers import MiniBatchSGD as JMiniBatchSGD
from asyncframework_tpu_torch.metrics import trace as ttrace
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.parallel import make_mesh
from asyncframework_tpu_torch.solvers import MiniBatchSGD

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def problem():
    rs = np.random.default_rng(0)
    n, d = 512, 16
    X = rs.normal(size=(n, d)).astype(np.float32)
    w_true = rs.normal(size=(d,)).astype(np.float32)
    y = (X @ w_true + 0.01 * rs.normal(size=(n,))).astype(np.float32)
    return X, y, w_true


def make_regression(n, d, seed):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(np.float32)
    w = rs.normal(size=(d,)).astype(np.float32)
    return X, (X @ w).astype(np.float32), w


def mesh8():
    return make_mesh(8, devices=CPU8)


class TestMiniBatchSGD:
    def test_full_batch_matches_exact_gd(self, problem):
        X, y, _ = problem
        sgd = MiniBatchSGD(gamma=2.0, batch_rate=1.0, num_iterations=5, seed=0)
        w, losses, snaps = sgd.run(X, y, mesh=mesh8())
        n = X.shape[0]
        wr = np.zeros(X.shape[1], np.float32)
        for i in range(5):
            g = X.T @ (X @ wr - y)
            wr = wr - 2.0 / np.sqrt(i + 1.0) * g / n
        np.testing.assert_allclose(w, wr, rtol=2e-3, atol=2e-4)

    def test_loss_history_decreasing(self, problem):
        X, y, _ = problem
        sgd = MiniBatchSGD(gamma=1.0, batch_rate=0.5, num_iterations=40)
        _, losses, _ = sgd.run(X, y, mesh=mesh8())
        assert losses[-1] < losses[0]
        assert len(losses) == 40

    def test_padding_rows_do_not_change_result(self):
        # n=1000 over 8 ranks: no padding; 1001 pads 7 rows, and the
        # count must exclude them
        X, y, _ = make_regression(1001, 8, seed=9)
        sgd = MiniBatchSGD(gamma=1.0, batch_rate=1.0, num_iterations=3,
                           seed=1)
        w, _, _ = sgd.run(X, y, mesh=mesh8())
        n = X.shape[0]
        wr = np.zeros(8, np.float32)
        for i in range(3):
            g = X.T @ (X @ wr - y)
            wr = wr - 1.0 / np.sqrt(i + 1.0) * g / n
        np.testing.assert_allclose(w, wr, rtol=2e-3, atol=2e-4)

    def test_l2_updater(self, problem):
        X, y, _ = problem
        w, losses, _ = MiniBatchSGD(
            gamma=1.0, batch_rate=1.0, num_iterations=10, updater="l2",
            reg_param=0.1,
        ).run(X, y, mesh=mesh8())
        w_simple, _, _ = MiniBatchSGD(
            gamma=1.0, batch_rate=1.0, num_iterations=10
        ).run(X, y, mesh=mesh8())
        assert np.linalg.norm(w) < np.linalg.norm(w_simple)

    def test_l1_updater_sparsifies(self, problem):
        X, y, _ = problem
        w, _, _ = MiniBatchSGD(
            gamma=1.0, batch_rate=1.0, num_iterations=20, updater="l1",
            reg_param=0.5,
        ).run(X, y, mesh=mesh8())
        assert np.mean(np.abs(w) < 1e-6) > 0.1  # some exact zeros

    def test_snapshots_warray_parity(self, problem):
        X, y, _ = problem
        sgd = MiniBatchSGD(gamma=1.0, batch_rate=0.5, num_iterations=25,
                           snapshot_every=10)
        _, _, snaps = sgd.run(X, y, mesh=mesh8())
        assert [s[0] for s in snaps] == [0, 10, 20]

    def test_convergence_tol_stops_early(self, problem):
        X, y, _ = problem
        sgd = MiniBatchSGD(gamma=0.01, batch_rate=1.0, num_iterations=100,
                           convergence_tol=0.5)
        _, losses, _ = sgd.run(X, y, mesh=mesh8())
        assert len(losses) < 100

    def test_unknown_updater_and_loss_raise(self):
        with pytest.raises(ValueError, match="updater"):
            MiniBatchSGD(updater="adam")
        with pytest.raises(ValueError, match="loss"):
            MiniBatchSGD(loss="hinge")


class TestMiniBatchSGD2D:
    """(dp, md) mesh: features over md, rows over dp; the result matches
    the dp-only layout up to float association."""

    @pytest.mark.parametrize("updater,reg", [
        ("simple", 0.0), ("l2", 0.01), ("l1", 0.001),
    ])
    def test_md_sharding_matches_dp_only(self, problem, updater, reg):
        X, y, _ = problem

        def mk():
            return MiniBatchSGD(gamma=0.5, batch_rate=0.5,
                                num_iterations=40, seed=1, updater=updater,
                                reg_param=reg)

        m1 = make_mesh(4, axis_names=("dp", "md"), axis_sizes=(4, 1),
                       devices=CPU8[:4])
        m2 = make_mesh(8, axis_names=("dp", "md"), axis_sizes=(4, 2),
                       devices=CPU8)
        w1, l1, _ = mk().run(X, y, mesh=m1)
        w2, l2, _ = mk().run(X, y, mesh=m2)
        np.testing.assert_allclose(w1, w2, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-6)

    def test_md_sharding_with_feature_padding(self):
        rs = np.random.default_rng(3)
        n, d = 256, 13  # 13 % 4 != 0
        X = rs.normal(size=(n, d)).astype(np.float32)
        y = (X @ rs.normal(size=(d,)).astype(np.float32)).astype(np.float32)
        mesh = make_mesh(8, axis_names=("dp", "md"), axis_sizes=(2, 4),
                         devices=CPU8)
        w, losses, _ = MiniBatchSGD(
            gamma=0.5, batch_rate=1.0, num_iterations=150, seed=0
        ).run(X, y, mesh=mesh)
        assert w.shape == (d,)
        assert losses[-1] < 0.05 * losses[0]


# ---------------------------------------------------- against the JAX one
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["1d", "2d"])
@pytest.mark.parametrize("updater,reg", [
    ("simple", 0.0), ("l2", 0.01), ("l1", 0.001),
])
@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_matches_the_jax_package_at_full_batch(devices8, loss, updater, reg,
                                               shape):
    X, y, _ = make_regression(1000, 13, seed=4)
    if loss == "logistic":
        y = (y > 0).astype(np.float32)
    kw = dict(gamma=0.5, batch_rate=1.0, num_iterations=40, seed=1,
              updater=updater, reg_param=reg, loss=loss, snapshot_every=10)
    names = ("dp", "md")
    jw, jl, jsnaps = JMiniBatchSGD(**kw).run(
        X, y, mesh=jmake_mesh(8, axis_names=names, axis_sizes=shape,
                              devices=devices8))
    tw, tl, tsnaps = MiniBatchSGD(**kw).run(
        X, y, mesh=make_mesh(8, axis_names=names, axis_sizes=shape,
                             devices=CPU8))
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4, atol=1e-6)
    assert [i for i, _ in tsnaps] == [i for i, _ in jsnaps] == [0, 10, 20, 30]
    for (_i, a), (_j, b) in zip(tsnaps, jsnaps):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_convergence_tol_cut_matches_the_jax_package(devices8, problem):
    X, y, _ = problem
    kw = dict(gamma=0.01, batch_rate=1.0, num_iterations=100,
              convergence_tol=0.5)
    jw, jl, _ = JMiniBatchSGD(**kw).run(X, y, mesh=jmake_mesh(
        8, devices=devices8))
    tw, tl, _ = MiniBatchSGD(**kw).run(X, y, mesh=mesh8())
    assert len(tl) == len(jl) < 100
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------- the port's own path
def test_each_rank_gradient_is_one_b1_call_a_iteration(problem):
    """Least squares on a 1-D mesh: one ``saga_grad`` a rank an iteration
    (its plain version on the CPU, counted); logistic on a 1-D mesh: the
    margin, then one full masked ``masked_grad`` a rank; 2-D: the margin,
    then one ``xt_coeff`` a rank."""
    X, y, _ = problem
    for loss, axes, form in (
            ("least_squares", ((8,), ("dp",)), mg.saga_grad_reference),
            ("logistic", ((8,), ("dp",)), mg.masked_grad_reference),
            ("least_squares", ((4, 2), ("dp", "md")),
             mg.xt_coeff_reference)):
        sizes, names = axes
        mesh = make_mesh(8, axis_names=names, axis_sizes=sizes, devices=CPU8)
        yy = (y > 0).astype(np.float32) if loss == "logistic" else y
        sgd = MiniBatchSGD(gamma=0.5, batch_rate=0.5, num_iterations=7,
                           loss=loss)
        before = (mg.saga_grad_reference.calls, mg.xt_coeff_reference.calls,
                  mg.masked_grad_reference.calls)
        sgd.run(X, yy, mesh=mesh)
        calls = (mg.saga_grad_reference.calls - before[0],
                 mg.xt_coeff_reference.calls - before[1],
                 mg.masked_grad_reference.calls - before[2])
        want = {mg.saga_grad_reference: (56, 0, 0),
                mg.xt_coeff_reference: (0, 56, 0),
                mg.masked_grad_reference: (0, 0, 56)}[form]
        assert calls == want, (loss, names, calls)
        assert sgd.last_run == {"iterations": 7, "graph_replays": 0,
                                "enqueued_iterations": 7, "ranks": 8,
                                "elapsed_s": sgd.last_run["elapsed_s"]}


def test_masks_are_drawn_per_dp_index_and_shared_over_md(problem,
                                                         monkeypatch):
    """Each dp index draws its rows' mask from its own generator, once an
    iteration; every md shard of a row block uses it."""
    import asyncframework_tpu_torch.solvers.minibatch_sgd as mod

    X, y, _ = problem
    draws = []
    real = mod.bernoulli_mask

    def spy(gen, n, rate):
        draws.append((gen.initial_seed(), n))
        return real(gen, n, rate)

    monkeypatch.setattr(mod, "bernoulli_mask", spy)
    mesh = make_mesh(8, axis_names=("dp", "md"), axis_sizes=(4, 2),
                     devices=CPU8)
    MiniBatchSGD(gamma=0.5, batch_rate=0.5, num_iterations=3,
                 seed=5).run(X, y, mesh=mesh)
    assert len(draws) == 3 * 4 and all(n == 128 for _s, n in draws)
    assert len({s for s, _n in draws}) == 4


def test_graph_needs_one_card(problem):
    X, y, _ = problem
    with pytest.raises(ValueError, match="one card"):
        MiniBatchSGD(num_iterations=2).run(X, y, mesh=mesh8(), graph=True)


def test_trace_span_only_when_asked(problem):
    X, y, _ = problem
    agg = ttrace.aggregator()
    agg.reset()
    MiniBatchSGD(num_iterations=3).run(X, y, mesh=mesh8())
    assert agg.snapshot()["spans"] == 0
    MiniBatchSGD(num_iterations=3, trace_sample=1.0).run(X, y, mesh=mesh8())
    assert agg.snapshot()["spans"] == 1
    agg.reset()


def test_entry_point_refuses_to_fall_back_to_the_cpu(problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    X, y, _ = problem
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniBatchSGD(num_iterations=2).run(X, y)


def test_tensor_inputs_on_the_rank_device_are_read_in_place(problem):
    X, y, _ = problem
    Xt, yt = torch.from_numpy(X.copy()), torch.from_numpy(y.copy())
    w1, l1, _ = MiniBatchSGD(num_iterations=5, batch_rate=0.5).run(
        Xt, yt, mesh=mesh8())
    w2, l2, _ = MiniBatchSGD(num_iterations=5, batch_rate=0.5).run(
        X, y, mesh=mesh8())
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(l1, l2)
    assert jax.device_count() >= 8  # the JAX package's devices stay as set


@pytest.mark.parametrize("sizes", [(8,), (4, 2)], ids=["1d", "2d"])
def test_caller_w0_is_never_written(problem, sizes):
    X, y, _ = problem
    names = ("dp",) if len(sizes) == 1 else ("dp", "md")
    w0 = np.full(X.shape[1], 0.25, np.float32)
    before = w0.copy()
    w, _, _ = MiniBatchSGD(num_iterations=5).run(
        X, y, mesh=make_mesh(8, axis_names=names, axis_sizes=sizes,
                             devices=CPU8), w0=w0)
    np.testing.assert_array_equal(w0, before)
    assert not np.array_equal(w, before)

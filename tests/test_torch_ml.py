"""The port's ML optimizers and linear models against the JAX package's.

Twins of ``tests/test_ml.py`` (``GradientDescentSuite``, ``LBFGSSuite``
and the model suites) and of ``tests/test_ml_breadth.py``'s softmax,
ridge and lasso cases on the port, with ``devices=[cpu] * 8`` (the
counterpart of the JAX package's eight virtual CPU devices).  Then the two
packages on the same numpy inputs: at ``mini_batch_fraction`` 1.0 every
Bernoulli draw keeps every row in both, so ``GradientDescent`` is the same
computation, and every gradient x updater agrees for 40 iterations to
rtol 1e-4, atol 1e-6 (f32 products summed in two libraries' orders);
L-BFGS agrees to rtol 1e-3 on ``w`` over the iterations it runs.  Below
1.0 the draws differ (torch generators against threefry, ROADMAP C2),
and the twins hold the JAX tests' own quality gates.  On the CPU each
gradient is the plain version of its B1 form, counted.
"""

import numpy as np
import pytest
import torch

import jax

from asyncframework_tpu import ml as jml
from asyncframework_tpu.parallel import make_mesh as jmake_mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from asyncframework_tpu_torch import convert
from asyncframework_tpu_torch.ml import (
    GradientDescent,
    HingeGradient,
    L1Updater,
    LBFGS,
    Lasso,
    LeastSquaresGradient,
    LinearRegression,
    LinearSVM,
    LogisticGradient,
    LogisticRegression,
    RidgeRegression,
    SimpleUpdater,
    SoftmaxRegression,
    SquaredL2Updater,
)
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh(devices8):
    return jmake_mesh(8, devices=devices8)


@pytest.fixture(scope="module")
def regression_problem():
    rs = np.random.default_rng(3)
    n, d = 1024, 12
    X = rs.normal(size=(n, d)).astype(np.float32)
    w_true = rs.normal(size=(d,)).astype(np.float32)
    y = (X @ w_true + 0.05 * rs.normal(size=(n,))).astype(np.float32)
    return X, y, w_true


@pytest.fixture(scope="module")
def classification_problem():
    rs = np.random.default_rng(4)
    n, d = 1024, 8
    X = rs.normal(size=(n, d)).astype(np.float32)
    w_true = (3.0 * rs.normal(size=(d,))).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rs.random(n) < p).astype(np.float32)
    return X, y, w_true


def _objective(X, y, w):
    r = X @ w - y
    return 0.5 * float(r @ r) / X.shape[0]


# ---------------------------------------------------------------- gradients
GRADIENTS = {"least_squares": (LeastSquaresGradient, jml.LeastSquaresGradient),
             "logistic": (LogisticGradient, jml.LogisticGradient),
             "hinge": (HingeGradient, jml.HingeGradient)}


@pytest.mark.parametrize("name", sorted(GRADIENTS))
def test_gradient_matches_autograd_and_the_jax_package(name):
    """Each batched gradient equals torch autograd of its summed loss and
    the JAX package's ``local`` on the same inputs (hinge off its kink:
    generic random data)."""
    rs = np.random.default_rng(0)
    X = rs.normal(size=(32, 5)).astype(np.float32)
    w = rs.normal(size=(5,)).astype(np.float32)
    mask = (rs.random(32) < 0.7).astype(np.float32)
    y = (rs.normal(size=(32,)) if name == "least_squares"
         else rs.random(32) < 0.5).astype(np.float32)
    port, ref = GRADIENTS[name]
    Xt, yt, mt = (torch.from_numpy(a) for a in (X, y, mask))
    g, loss = port().local(Xt, yt, torch.from_numpy(w), mt)
    wt = torch.from_numpy(w).clone().requires_grad_(True)
    margin = Xt @ wt
    c_loss = port().coefficient(margin, yt, mt)[1]
    (g_auto,) = torch.autograd.grad(c_loss, wt)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-4,
                               atol=1e-4)
    jg, jloss = ref().local(X, y, w, mask)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_each_gradient_is_one_b1_form_a_call():
    """On the CPU the plain version of each B1 form runs once a call:
    ``saga_grad`` (least squares), the logistic full form, ``xt_coeff``
    (hinge)."""
    rs = np.random.default_rng(1)
    X = torch.from_numpy(rs.normal(size=(16, 4)).astype(np.float32))
    y = torch.from_numpy((rs.random(16) < 0.5).astype(np.float32))
    w, m = torch.ones(4), torch.ones(16)
    for grad, plain in ((LeastSquaresGradient(), mg.saga_grad_reference),
                        (LogisticGradient(), mg.masked_grad_reference),
                        (HingeGradient(), mg.xt_coeff_reference)):
        counts = {f: f.calls for f in (mg.saga_grad_reference,
                                       mg.masked_grad_reference,
                                       mg.xt_coeff_reference)}
        grad.local(X, y, w, m)
        assert {f: f.calls - c for f, c in counts.items()} == {
            f: int(f is plain) for f in counts}


# ---------------------------------------------------------------- updaters
@pytest.mark.parametrize("port,ref,reg", [
    (SimpleUpdater, jml.SimpleUpdater, 0.0),
    (SquaredL2Updater, jml.SquaredL2Updater, 0.1),
    (L1Updater, jml.L1Updater, 0.05),
])
def test_updater_matches_the_jax_package(port, ref, reg):
    rs = np.random.default_rng(2)
    w = rs.normal(size=(9,)).astype(np.float32)
    g = rs.normal(size=(9,)).astype(np.float32)
    for it in (1, 4, 9):
        w2, rv = port().apply(torch.from_numpy(w), torch.from_numpy(g), 0.7,
                              float(it), reg)
        jw2, jrv = ref().apply(w, g, 0.7, np.float32(it), reg)
        np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(rv), float(jrv), rtol=1e-6,
                                   atol=1e-7)


# -------------------------------------------------- against the JAX package
@pytest.mark.parametrize("gradient,updater,reg", [
    ("least_squares", "simple", 0.0), ("logistic", "simple", 0.0),
    ("hinge", "l2", 0.01), ("least_squares", "l1", 0.001),
    ("logistic", "l2", 0.01),
])
def test_gradient_descent_matches_the_jax_package_at_full_batch(
        jmesh, mesh, gradient, updater, reg):
    """40 iterations at fraction 1.0 on a 1-D 8-rank mesh, every gradient
    and every updater: ``w``, the loss history and the ``Warray``
    snapshots agree."""
    rs = np.random.default_rng(4)
    X = rs.normal(size=(1000, 13)).astype(np.float32)
    y = (X @ rs.normal(size=(13,))).astype(np.float32)
    if gradient != "least_squares":
        y = (y > 0).astype(np.float32)
    upd = {"simple": (SimpleUpdater, jml.SimpleUpdater),
           "l2": (SquaredL2Updater, jml.SquaredL2Updater),
           "l1": (L1Updater, jml.L1Updater)}[updater]
    kw = dict(step_size=0.5, num_iterations=40, reg_param=reg,
              mini_batch_fraction=1.0, seed=1, snapshot_every=10)
    jgd = jml.GradientDescent(gradient=GRADIENTS[gradient][1](),
                              updater=upd[1](), **kw)
    tgd = GradientDescent(gradient=GRADIENTS[gradient][0](),
                          updater=upd[0](), **kw)
    w0 = np.full(13, 0.1, np.float32)
    jw, jl = jgd.optimize(X, y, w0=w0, mesh=jmesh)
    tw, tl = tgd.optimize(X, y, w0=w0, mesh=mesh)
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    th, jh = tgd.get_all_weights(), jgd.get_all_weights()
    assert len(th) == len(jh) == 4
    for (_t, a), (_j, b) in zip(th, jh):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_convergence_cut_matches_the_jax_package(regression_problem, jmesh,
                                                 mesh):
    X, y, _ = regression_problem
    kw = dict(step_size=1.0, num_iterations=500, mini_batch_fraction=1.0,
              convergence_tol=1e-3, seed=1)
    jw, jl = jml.GradientDescent(**kw).optimize(X, y, mesh=jmesh)
    gd = GradientDescent(**kw)
    tw, tl = gd.optimize(X, y, mesh=mesh)
    assert len(tl) == len(jl) < 500
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gd.get_all_weights()[-1][1], tw)


@pytest.mark.parametrize("gradient,reg,iters", [
    ("least_squares", 0.0, 6), ("logistic", 1e-3, 8),
])
def test_lbfgs_matches_the_jax_package(regression_problem,
                                       classification_problem, jmesh, mesh,
                                       gradient, reg, iters):
    """The host two-loop recursion and the line search on both packages'
    full-batch evaluations: the same accepted steps, ``w`` within rtol
    1e-3, the objective history within rtol 1e-5."""
    X, y, _ = (regression_problem if gradient == "least_squares"
               else classification_problem)
    port, ref = GRADIENTS[gradient]
    jw, jh = jml.LBFGS(ref(), max_iterations=iters, reg_param=reg).optimize(
        X, y, mesh=jmesh)
    lb = LBFGS(port(), max_iterations=iters, reg_param=reg)
    tw, th = lb.optimize(X, y, mesh=mesh)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    np.testing.assert_allclose(tw, jw, rtol=1e-3, atol=1e-5)
    assert lb.last_run["evaluations"] >= iters + 1


def test_two_dimensional_mesh_matches_the_one_dimensional(regression_problem,
                                                         mesh):
    """Features over ``md`` (each slice its own updater step, the L2 norm
    folded over the slices): the same run as rows alone."""
    X, y, _ = regression_problem
    mesh2 = make_mesh(8, axis_names=("dp", "md"), axis_sizes=(4, 2),
                      devices=CPU8)
    kw = dict(updater=SquaredL2Updater(), step_size=0.5, num_iterations=30,
              reg_param=0.01, seed=0)
    w1, l1 = GradientDescent(**kw).optimize(X, y, mesh=mesh)
    w2, l2 = GradientDescent(**kw).optimize(X, y, mesh=mesh2)
    np.testing.assert_allclose(w2, w1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(l2, l1, rtol=1e-4, atol=1e-6)


# --------------------------------------------------- twins of test_ml.py
def test_exact_first_iteration_gradient_with_l2(regression_problem, mesh):
    """GradientDescentSuite parity: one full-batch iteration from w0 is
    w0 (1 - reg) - avg_grad, and the recorded loss is the pre-update
    objective with the regularization of the initial weights."""
    X, y, _ = regression_problem
    w0 = np.ones(X.shape[1], np.float32)
    reg = 0.1
    gd = GradientDescent(gradient=LeastSquaresGradient(),
                         updater=SquaredL2Updater(), step_size=1.0,
                         num_iterations=1, reg_param=reg,
                         mini_batch_fraction=1.0, seed=0)
    w1, losses = gd.optimize(X, y, w0=w0, mesh=mesh)
    r = X @ w0 - y
    expected = w0 * (1.0 - reg) - X.T @ r / X.shape[0]
    np.testing.assert_allclose(w1, expected, rtol=2e-4, atol=2e-4)
    reg0 = 0.5 * reg * float(w0 @ w0)
    np.testing.assert_allclose(
        losses[0], 0.5 * float(r @ r) / X.shape[0] + reg0, rtol=1e-4)


def test_loss_decreasing_and_converges(regression_problem, mesh):
    X, y, w_true = regression_problem
    gd = GradientDescent(step_size=1.0, num_iterations=300,
                         mini_batch_fraction=0.5, seed=1)
    w, losses = gd.optimize(X, y, mesh=mesh)
    assert losses[-1] < 0.05 * losses[0]
    assert len(gd.get_all_weights()) >= 1
    assert np.linalg.norm(w - w_true) / np.linalg.norm(w_true) < 0.2


def test_l1_updater_sparsifies(mesh):
    rs = np.random.default_rng(5)
    n, d = 512, 16
    X = rs.normal(size=(n, d)).astype(np.float32)
    w_true = np.zeros(d, np.float32)
    w_true[:3] = [2.0, -3.0, 1.5]
    y = (X @ w_true + 0.01 * rs.normal(size=(n,))).astype(np.float32)
    w, _ = GradientDescent(updater=L1Updater(), step_size=0.5,
                           num_iterations=300, reg_param=0.1,
                           seed=2).optimize(X, y, mesh=mesh)
    assert np.sum(np.abs(w[3:]) < 0.05) >= d - 5
    assert np.all(np.abs(w[:3]) > 0.5)


def test_weight_history_cadence_and_final(regression_problem, mesh):
    X, y, _ = regression_problem
    gd = GradientDescent(step_size=1.0, num_iterations=250,
                         mini_batch_fraction=0.3, seed=0, snapshot_every=100)
    w, _ = gd.optimize(X, y, mesh=mesh)
    hist = gd.get_all_weights()
    # iterations 100, 200, plus the final iterate (250 not a multiple)
    assert len(hist) == 3
    np.testing.assert_allclose(hist[-1][1], w, rtol=1e-6)
    ts = [t for t, _w in hist]
    assert ts == sorted(ts)
    assert np.linalg.norm(hist[0][1] - hist[1][1]) > 0


def test_zero_row_samples_skip_update(mesh):
    """MLlib parity: an iteration whose draw selects no rows neither moves
    the weights nor appends to the loss history."""
    rs = np.random.default_rng(11)
    X = rs.normal(size=(8, 4)).astype(np.float32)
    y = rs.normal(size=(8,)).astype(np.float32)
    w0 = np.ones(4, np.float32)
    gd = GradientDescent(updater=SquaredL2Updater(), step_size=0.0,
                         num_iterations=200, reg_param=0.5,
                         mini_batch_fraction=0.01, seed=0)
    w, losses = gd.optimize(X, y, w0=w0, mesh=mesh)
    assert len(losses) < 200
    np.testing.assert_allclose(w, w0, rtol=1e-6)


def test_lbfgs_history_resets_between_runs(regression_problem, mesh):
    X, y, _ = regression_problem
    lb = LBFGS(max_iterations=10)
    lb.optimize(X, y, mesh=mesh)
    n1 = len(lb.get_all_weights())
    lb.optimize(X, y, mesh=mesh)
    assert len(lb.get_all_weights()) == n1


def test_lbfgs_beats_sgd_on_full_batch(regression_problem, mesh):
    X, y, _ = regression_problem
    w_lb, hist = LBFGS(max_iterations=50).optimize(X, y, mesh=mesh)
    w_gd, _ = GradientDescent(step_size=1.0, num_iterations=50,
                              seed=0).optimize(X, y, mesh=mesh)
    assert _objective(X, y, w_lb) <= _objective(X, y, w_gd) + 1e-6
    assert hist[-1] < hist[0]


def test_lbfgs_logistic(classification_problem, mesh):
    X, y, _ = classification_problem
    w, hist = LBFGS(gradient=LogisticGradient(), max_iterations=60,
                    reg_param=1e-3).optimize(X, y, mesh=mesh)
    assert np.mean(((X @ w) > 0) == (y > 0.5)) > 0.85
    assert hist[-1] < hist[0]


def test_linear_regression_with_intercept(mesh):
    rs = np.random.default_rng(6)
    X = rs.normal(size=(512, 6)).astype(np.float32)
    w_true = rs.normal(size=(6,)).astype(np.float32)
    y = (X @ w_true + 2.5 + 0.01 * rs.normal(size=(512,))).astype(np.float32)
    m = LinearRegression(step_size=1.0, num_iterations=300,
                         fit_intercept=True, seed=0).fit(X, y, mesh=mesh)
    assert abs(m.intercept - 2.5) < 0.2
    assert np.sqrt(np.mean((m.predict(X) - y) ** 2)) < 0.2
    assert len(m.weight_history) >= 1


def test_logistic_regression_accuracy(classification_problem, mesh):
    X, y, _ = classification_problem
    m = LogisticRegression(step_size=2.0, num_iterations=200,
                           seed=0).fit(X, y, mesh=mesh)
    assert np.mean(m.predict(X) == y) > 0.85
    p = m.predict_proba(X)
    assert np.all((p >= 0) & (p <= 1))
    # a tensor predicts on its device, the same labels
    np.testing.assert_array_equal(m.predict(torch.from_numpy(X)).numpy(),
                                  m.predict(X))


def test_svm_separable(mesh):
    rs = np.random.default_rng(7)
    X = rs.normal(size=(512, 4)).astype(np.float32)
    y = ((X @ np.array([1.0, -1.0, 0.5, 2.0], np.float32)) > 0).astype(
        np.float32)
    m = LinearSVM(step_size=1.0, num_iterations=200, reg_param=0.01,
                  seed=0).fit(X, y, mesh=mesh)
    assert np.mean(m.predict(X) == y) > 0.93


def test_ridge_and_lasso(mesh):
    rs = np.random.default_rng(0)
    X = rs.normal(size=(600, 10)).astype(np.float32)
    w_true = np.zeros(10, np.float32)
    w_true[:3] = [2.0, -1.5, 1.0]
    y = (X @ w_true + 0.05 * rs.normal(size=600)).astype(np.float32)
    ridge = RidgeRegression(step_size=0.1, num_iterations=300,
                            reg_param=0.01).fit(X, y, mesh=mesh)
    lasso = Lasso(step_size=0.1, num_iterations=300,
                  reg_param=0.05).fit(X, y, mesh=mesh)
    np.testing.assert_allclose(ridge.weights[:3], w_true[:3], atol=0.2)
    assert np.abs(lasso.weights[3:]).max() < 0.05
    assert np.abs(ridge.weights[3:]).max() < 0.2


def test_softmax_regression_matches_the_jax_package():
    """Full batch, fixed rate: the same loop in both packages, so the
    weights and the loss history agree; the JAX test's gates hold."""
    rs = np.random.default_rng(7)
    centers = 2.0 * rs.normal(size=(3, 12))
    y = rs.integers(0, 3, 600)
    X = (centers[y] + rs.normal(size=(600, 12))).astype(np.float32)
    kw = dict(step_size=0.5, num_iterations=100)
    jm = jml.SoftmaxRegression(**kw).fit(X, y)
    tm = SoftmaxRegression(**kw).fit(X, y, device=CPU)
    np.testing.assert_allclose(tm.W, jm.W, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=1e-5)
    assert tm.loss_history[-1] < tm.loss_history[0]
    assert (tm.predict(X) == y).mean() > 0.8
    np.testing.assert_allclose(tm.predict_proba(X[:5]).sum(axis=1), 1.0,
                               rtol=1e-5)


# ------------------------------------------------------- models carried over
def test_linear_models_carry_across_both_ways(classification_problem, jmesh,
                                              mesh):
    """A JAX-fitted logistic model predicts the same in the port, and a
    port-fitted SVM the same in the JAX package."""
    X, y, _ = classification_problem
    jm = jml.LogisticRegression(step_size=2.0, num_iterations=20).fit(
        X, y, mesh=jmesh)
    tm = convert.linear_model_from_reference(jm)
    assert type(tm).__name__ == "LogisticRegressionModel"
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               rtol=1e-6)
    assert len(tm.weight_history) == len(jm.weight_history)
    sm = LinearSVM(num_iterations=20, fit_intercept=True).fit(X, y,
                                                             mesh=mesh)
    back = jml.models.SVMModel(**convert.linear_model_to_reference(sm))
    np.testing.assert_array_equal(back.predict(X), sm.predict(X))
    assert back.intercept == sm.intercept

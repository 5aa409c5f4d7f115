"""The port's ASAGA (B1's history forms, the steps, the solver) against the
JAX package.

On the CPU the kernel's history forms run their plain PyTorch versions.
Inputs come from a seeded numpy generator and go to both packages as numpy;
masks are injected into both (the two draw different random bits).

Tolerances: f32 contractions ``rtol=1e-5, atol=1e-5 * max|.|`` (the same
f32 products summed in different orders); bf16 ``saga_grad`` ``rtol=1e-2,
atol=1e-2 * max|g|`` (a one-ulp flip of a row coefficient's bf16 rounding,
which follows from the f32 order of its dot product, moves g by 2^-8 of that
row's term); the elementwise appliers ``rtol=1e-6`` (XLA folds and rewrites
the step coefficients, see ``tests/test_torch_steps.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asyncframework_tpu.data import make_regression
from asyncframework_tpu.ops import gradients as jgrad
from asyncframework_tpu.ops import steps as jsteps
from asyncframework_tpu.solvers import ASAGA as JaxASAGA
from asyncframework_tpu.solvers import SolverConfig as JaxConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from asyncframework_tpu_torch.convert import saga_state_from_reference
from asyncframework_tpu_torch.ops import gradients as tgrad
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops import steps as tsteps
from asyncframework_tpu_torch.ops.sampling import worker_generator
from asyncframework_tpu_torch.solvers import ASAGA, SolverConfig
from asyncframework_tpu_torch.solvers import instrumentation as port_inst

CPU = torch.device("cpu")
GAMMA, B, N, P = 0.3, 0.4, 600, 4


def _problem(n, d, seed=0):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(np.float32)
    y = rs.normal(size=n).astype(np.float32)
    w = rs.normal(size=d).astype(np.float32)
    alpha = rs.normal(size=n).astype(np.float32)
    mask = (rs.random(n) < 0.5).astype(np.float32)
    return X, y, w, alpha, mask


def _bf16(X):
    """X rounded to bf16 by JAX, as a jax bf16 array and a torch bf16."""
    Xj = jnp.asarray(X, jnp.bfloat16)
    exact = np.array(Xj.astype(jnp.float32))
    return Xj, torch.from_numpy(exact).to(torch.bfloat16)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rel, atol=rel * float(np.abs(want).max(initial=1.0))
    )


def _cfg(**kw):
    base = dict(num_workers=4, num_iterations=300, gamma=0.1, batch_rate=0.3,
                bucket_ratio=0.5, printer_freq=50, seed=42,
                calibration_iters=10, run_timeout_s=120.0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def regression():
    X, y, _ = make_regression(2048, 32, seed=3)
    return X, y


# ------------------------------------------------------------ kernel forms
@pytest.mark.parametrize("n,d", [(256, 128), (300, 100), (17, 8)])
@pytest.mark.parametrize("masked", [True, False])
def test_saga_grad_f32_matches_saga_shard_step(n, d, masked):
    X, y, w, alpha, mask = _problem(n, d)
    m = mask if masked else np.ones(n, np.float32)
    jg, jdiff = jgrad.saga_shard_step(X, y, w, alpha, m)
    g, diff = mg.saga_grad(*_t(X, y, w, alpha), _t(mask)[0] if masked else None)
    _close(g, jg)
    _close(diff, jdiff)
    assert g.dtype == diff.dtype == torch.float32


@pytest.mark.parametrize("n,d", [(256, 128), (300, 100)])
def test_saga_grad_bf16_keeps_the_mm_f32_contract(n, d):
    """bf16 X: w and the coefficient are rounded to bf16, both products
    accumulate in f32 (``mm_f32``)."""
    X, y, w, alpha, mask = _problem(n, d, seed=1)
    Xj, Xt = _bf16(X)
    jg, jdiff = jgrad.saga_shard_step(Xj, y, w, alpha, mask)
    g, diff = mg.saga_grad(Xt, *_t(y, w, alpha, mask))
    _close(diff, jdiff)
    _close(g, jg, 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xt_coeff_matches_the_table_delta(dtype):
    X, _, _, alpha, mask = _problem(300, 100, seed=2)
    diff = np.random.default_rng(3).normal(size=300).astype(np.float32)
    if dtype == "bfloat16":
        Xj, Xt = _bf16(X)
    else:
        Xj, Xt = X, torch.from_numpy(X)
    want = jsteps.make_saga_table_delta()(Xj, diff, mask, alpha)
    got = tsteps.make_saga_table_delta()(Xt, *_t(diff, mask, alpha))
    _close(got, want)


def test_xt_coeff_promotes_bf16_and_does_not_round_c():
    """The JAX table delta is a plain ``X.T @ c``: jnp promotes a bf16 X to
    f32 and keeps c in f32.  The port matches it, and rounding c to bf16
    (the ``mm_f32`` contract of the other forms) would not."""
    X, _, _, _, _ = _problem(400, 64, seed=4)
    c = np.random.default_rng(5).normal(size=400).astype(np.float32)
    Xj, Xt = _bf16(X)
    want = np.asarray(Xj.T @ jnp.asarray(c))
    assert (Xj.T @ jnp.asarray(c)).dtype == jnp.float32
    got = mg.xt_coeff(Xt, torch.from_numpy(c))
    c_rounded = torch.from_numpy(c).to(torch.bfloat16).float()
    rounded = Xt.float().T @ c_rounded
    err = float(np.abs(got.numpy() - want).max())
    err_rounded = float(np.abs(rounded.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max())
    assert err_rounded > 100 * err


@pytest.mark.parametrize("fn", ["saga_grad", "xt_coeff"])
def test_forms_reject_bad_inputs(fn):
    X, y, w, alpha, mask = _t(*_problem(16, 4))
    with pytest.raises(ValueError):
        if fn == "saga_grad":
            mg.saga_grad(X, y, w, alpha[:5], mask)
        else:
            mg.xt_coeff(X.T, y)
    with pytest.raises(TypeError):
        if fn == "saga_grad":
            mg.saga_grad(X.double(), y, w, alpha, mask)
        else:
            mg.xt_coeff(X, y.double())


def test_forms_edges():
    X = torch.zeros(0, 5)
    g, diff = mg.saga_grad(X, torch.zeros(0), torch.ones(5), torch.zeros(0))
    assert g.shape == (5,) and not g.any() and diff.shape == (0,)
    assert not mg.xt_coeff(X, torch.zeros(0)).any()
    y = torch.arange(3.0)
    g, diff = mg.saga_grad(torch.zeros(3, 0), y, torch.zeros(0), torch.zeros(3))
    assert g.shape == (0,) and torch.equal(diff, -y)


def test_residual_goes_through_the_history_form():
    X, y, w, _, _ = _problem(64, 16, seed=6)
    _close(tgrad.least_squares_residual(*_t(X, y, w)),
           jgrad.least_squares_residual(X, y, w))


# ------------------------------------------------------------------ steps
def test_commit_history_writes_diff_and_never_alpha():
    _, _, _, alpha, mask = _problem(50, 2, seed=7)
    diff = np.random.default_rng(8).normal(size=50).astype(np.float32)
    want = np.asarray(jsteps.saga_commit_history(jnp.asarray(alpha),
                                                 jnp.asarray(diff),
                                                 jnp.asarray(mask)))
    a, dt, m = _t(alpha, diff, mask)
    a_before = a.clone()
    got = tsteps.saga_commit_history(a, dt, m)
    assert np.array_equal(got.numpy(), want)  # elementwise: exact
    assert got.data_ptr() == dt.data_ptr()    # into diff's buffer
    assert torch.equal(a, a_before)           # the old slice is a version


def test_worker_step_draws_a_full_shard_mask():
    X, y, w, alpha, _ = _problem(400, 8, seed=9)
    step = tsteps.make_saga_worker_step(0.25)
    g, diff, mask = step(*_t(X, y, w, alpha), worker_generator(1, 2, CPU))
    assert mask.shape == (400,) and mask.dtype == torch.float32
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    assert 60 < int(mask.sum()) < 140  # Bernoulli(0.25) over 400 rows
    jg, jdiff = jgrad.saga_shard_step(X, y, w, alpha, mask.numpy())
    _close(g, jg)
    _close(diff, jdiff)


def test_accept_sequence_matches_from_a_shared_table():
    """Both packages start from the same state (``convert.
    saga_state_from_reference``) and run 12 accepts with injected masks:
    worker step against the table as dispatched, exact table delta against
    the current slice, commit, apply.  Two workers are dispatched before
    either commits (the overlap the table delta exists for)."""
    rs = np.random.default_rng(10)
    d, n_w = 24, 150
    shards = [(rs.normal(size=(n_w, d)).astype(np.float32),
               rs.normal(size=n_w).astype(np.float32)) for _ in range(P)]
    alpha0 = {wid: rs.normal(size=n_w).astype(np.float32) for wid in range(P)}
    w0 = rs.normal(size=d).astype(np.float32)
    ab0 = rs.normal(size=d).astype(np.float32)
    w_t, a_t, ab_t, _ = saga_state_from_reference(w0, alpha0, ab0, 0, [CPU])
    w_j, ab_j = jnp.asarray(w0), jnp.asarray(ab0)
    a_j = {wid: jnp.asarray(a) for wid, a in alpha0.items()}
    japply = jsteps.make_saga_apply(GAMMA, B, N, P)
    tapply = tsteps.make_saga_apply(GAMMA, B, N, P)
    jdelta, tdelta = jsteps.make_saga_table_delta(), tsteps.make_saga_table_delta()
    for it in range(6):
        pair = (it % P, (it + 1) % P)
        masks = {wid: (rs.random(n_w) < 0.5).astype(np.float32) for wid in pair}
        # dispatch both against the current model and slices ...
        jout = {wid: jgrad.saga_shard_step(*shards[wid], w_j, a_j[wid], masks[wid])
                for wid in pair}
        tout = {wid: tgrad.saga_shard_step(*_t(*shards[wid]), w_t, a_t[wid],
                                           torch.from_numpy(masks[wid]))
                for wid in pair}
        # ... then accept both, in order
        for wid in pair:
            Xj = jnp.asarray(shards[wid][0])
            jg, jdiff = jout[wid]
            delta_j = jdelta(Xj, jdiff, jnp.asarray(masks[wid]), a_j[wid])
            a_j[wid] = jsteps.saga_commit_history(a_j[wid], jdiff,
                                                  jnp.asarray(masks[wid]))
            w_j, ab_j = japply(w_j, ab_j, jg, delta_j)
            tg, tdiff = tout[wid]
            m = torch.from_numpy(masks[wid])
            delta_t = tdelta(torch.from_numpy(shards[wid][0]), tdiff, m, a_t[wid])
            a_t[wid] = tsteps.saga_commit_history(a_t[wid], tdiff, m)
            w_prev = w_t
            w_t, ab_t = tapply(w_t, ab_t, tg, delta_t)
            assert w_t is not w_prev  # out of place: w_prev is a version
    _close(w_t, w_j, 1e-5)
    _close(ab_t, ab_j, 1e-5)
    for wid in range(P):
        _close(a_t[wid], a_j[wid], 1e-5)


def test_apply_sequence_matches():
    """12 applies on shared gradients: elementwise, so the models agree to
    a few ulps (``rtol=1e-6``)."""
    rs = np.random.default_rng(11)
    d = 33
    japply = jsteps.make_saga_apply(GAMMA, B, N, P)
    tapply = tsteps.make_saga_apply(GAMMA, B, N, P)
    w_j, ab_j = jnp.zeros(d, jnp.float32), jnp.zeros(d, jnp.float32)
    w_t, _, ab_t, _ = saga_state_from_reference(np.zeros(d), {}, np.zeros(d),
                                                0, [CPU])
    for _ in range(12):
        g, delta = (rs.normal(size=d).astype(np.float32) for _ in range(2))
        w_j, ab_j = japply(w_j, ab_j, jnp.asarray(g), jnp.asarray(delta))
        w_t, ab_t = tapply(w_t, ab_t, *_t(g, delta))
    _close(w_t, w_j, 1e-6)
    _close(ab_t, ab_j, 1e-6)


# ------------------------------------------------------------------ solver
def test_run_sync_matches_jax_trajectory(regression):
    """``batch_rate=1.0``: every mask is all ones in both packages, so the
    run is deterministic; 4 workers, 40 rounds.  ``rtol=1e-5, atol=1e-5 *
    max|w|``: the per-worker sums and the drained sum differ in f32 order."""
    X, y = regression
    kw = _cfg(num_iterations=40, batch_rate=1.0, printer_freq=10, gamma=0.5)
    ref = JaxASAGA(X, y, JaxConfig(**kw)).run_sync()
    got = ASAGA(X, y, SolverConfig(**kw), devices=[CPU]).run_sync()
    scale = float(np.abs(ref.final_w).max())
    np.testing.assert_allclose(got.final_w, ref.final_w, rtol=1e-5,
                               atol=1e-5 * scale)
    assert len(got.trajectory) == len(ref.trajectory) == 6
    np.testing.assert_allclose([o for _, o in got.trajectory],
                               [o for _, o in ref.trajectory], rtol=1e-5)
    assert got.rounds == ref.rounds == 40
    assert got.accepted == ref.accepted == 160
    assert got.trajectory[-1][1] < got.trajectory[0][1] / 2


def _table_mean(X, res, n_workers):
    n = X.shape[0]
    expected = np.zeros(X.shape[1], np.float64)
    lo = 0
    for wid in range(n_workers):
        a = res.extras["alpha"][wid]
        expected += X[lo:lo + a.shape[0]].T.astype(np.float64) @ a
        lo += a.shape[0]
    return expected / n


def test_async_run_keeps_alpha_bar_the_table_mean(regression):
    """The commit protocol's invariant, after an overlapped async run, at
    the JAX test's bound (``tests/test_solvers.py``: ``rtol=1e-3,
    atol=1e-4``; alpha_bar is advanced in f32 over every accept, the mean
    is taken here in f64)."""
    X, y = regression
    res = ASAGA(X, y, SolverConfig(**_cfg(bucket_ratio=0.25)),
                devices=[CPU]).run()
    assert res.accepted == 300
    assert res.dropped == 0  # taw = 2^31 - 1
    np.testing.assert_allclose(res.extras["alpha_bar"],
                               _table_mean(X, res, 4), rtol=1e-3, atol=1e-4)
    assert res.final_objective < res.trajectory[0][1] / 2


def test_sync_run_keeps_alpha_bar_the_table_mean(regression):
    X, y = regression
    res = ASAGA(X, y, SolverConfig(**_cfg(num_iterations=30)),
                devices=[CPU]).run_sync()
    np.testing.assert_allclose(res.extras["alpha_bar"],
                               _table_mean(X, res, 4), rtol=1e-3, atol=1e-4)


def test_taw_zero_keeps_the_asaga_acceptance_rule(regression, monkeypatch):
    """ASAGA accepts iff ``k - staleness <= taw`` (not ASGD's ``staleness
    <= taw``).  With taw = 0 the first round's second result, staleness 1
    at k = 1, is accepted; later results are dropped once k outgrows their
    staleness, so the run stops at its time limit."""
    X, y = regression
    seen = []
    orig = port_inst.RunInstruments.on_gradient_merged

    def spy(self, worker_id, staleness, accepted, iteration, **kw):
        seen.append((iteration, staleness, accepted))
        return orig(self, worker_id, staleness, accepted, iteration, **kw)

    monkeypatch.setattr(port_inst.RunInstruments, "on_gradient_merged", spy)
    res = ASAGA(X, y, SolverConfig(**_cfg(taw=0, num_iterations=200,
                                          run_timeout_s=1.5)),
                devices=[CPU]).run()
    assert seen and all((k - s <= 0) == a for k, s, a in seen)
    assert any(a and s > 0 for _, s, a in seen)
    assert res.dropped == sum(1 for *_, a in seen if not a) > 0
    assert res.accepted == sum(1 for *_, a in seen if a)


def test_rejects_non_least_squares(regression):
    X, y = regression
    with pytest.raises(ValueError, match="least_squares"):
        ASAGA(X, y, SolverConfig(**_cfg(loss="logistic")), devices=[CPU])


@pytest.mark.parametrize("option", [
    dict(speculation=True), dict(dynamic_allocation=True),
    dict(checkpoint_dir="ckpt"),
])
def test_unported_features_raise(option, regression, tmp_path):
    """These switches raised until they were ported; now each runs
    (``tests/test_torch_checkpoint.py``, ``test_torch_speculation.py``
    and ``test_torch_telemetry.py`` hold what they do), alone and beside
    the live UI (``ui_port=0``, served on an ephemeral port)."""
    X, y = regression
    option = {k: str(tmp_path / v) if isinstance(v, str) else v
              for k, v in option.items()}
    res = ASAGA(X, y, SolverConfig(**_cfg(num_iterations=20, **option)),
                devices=[CPU]).run()
    assert res.accepted == 20
    if "checkpoint_dir" in option:  # a second run must not resume the first
        option["checkpoint_dir"] = str(tmp_path / "ckpt_ui")
    res = ASAGA(X, y, SolverConfig(**_cfg(num_iterations=20, ui_port=0,
                                          **option)), devices=[CPU]).run()
    assert res.accepted == 20
    assert res.extras["ui_port"] > 0


def test_run_fused_and_sparse_data_are_not_ported_yet(regression):
    """``run_fused`` was a stub that raised; it is ported now and runs in
    full waves on the CPU (``tests/test_torch_fused.py`` holds it against
    the JAX package).  A scipy sparse matrix is not taken as it is, in
    either package (sparse data goes in as a ``SparseShardedDataset``
    built from its CSR arrays, ``tests/test_torch_sparse.py``): the
    refusal says so, and names no ROADMAP item."""
    import scipy.sparse as sp

    X, y = regression
    res = ASAGA(X, y, SolverConfig(**_cfg()), devices=[CPU]).run_fused()
    assert res.extras["fused"] is True and res.dropped == 0
    assert res.accepted == _cfg()["num_iterations"]
    assert res.final_objective < res.trajectory[0][1]
    with pytest.raises(TypeError, match="SparseShardedDataset") as err:
        ASAGA(sp.csr_matrix(X), y, SolverConfig(**_cfg()), devices=[CPU])
    assert "ROADMAP" not in str(err.value)
    # the JAX package does not take it either
    with pytest.raises(Exception):
        JaxASAGA(sp.csr_matrix(X), y, JaxConfig(**_cfg()))


def test_entry_point_raises_without_a_gpu(regression):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    X, y = regression
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ASAGA(X, y, SolverConfig(**_cfg()))


@pytest.mark.slow
def test_smoke_step_size_halves_in_jax():
    """``chip_smoke.py``'s ASAGA step size: gamma = 0.5, the largest of
    {0.5, 0.2, 0.1, 0.05, 0.02}, halves the objective in the JAX package's
    ``run_sync`` over 1,500 rounds on a 16,000 x 2,000 draw of the port's
    generator (seed 7, noise 0.01, 8 workers, b = 0.1) on the CPU.  About a
    minute, hence ``slow``: run with ``-m slow``."""
    from asyncframework_tpu_torch.data.sharded import ShardedDataset

    ds = ShardedDataset.generate_on_device(16_000, 2_000, 8, [CPU], seed=7,
                                           noise=0.01)
    X = np.concatenate([ds.shard(w).X.numpy() for w in range(8)])
    y = np.concatenate([ds.shard(w).y.numpy() for w in range(8)])
    cfg = JaxConfig(num_workers=8, num_iterations=1_500, gamma=0.5,
                    batch_rate=0.1, bucket_ratio=0.7, printer_freq=150,
                    seed=42)
    res = JaxASAGA(X, y, cfg).run_sync()
    assert res.trajectory[-1][1] < res.trajectory[0][1] / 2

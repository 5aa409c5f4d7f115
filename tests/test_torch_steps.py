"""The port's step layer against the JAX package's, on shared inputs.

The appliers are elementwise but not bit-equal to the JAX package: XLA
rewrites ``w - (gamma/sqrt(k/P+1)/parRecs) * g`` into ``w - (c * rsqrt(k *
(1/P) + 1)) * g`` with ``c = gamma/parRecs`` folded at compile time, while
the port rounds the expression as written.  The step coefficient then
differs in its last bit, so the model agrees to ``rtol=1e-6, atol=1e-6 *
max|w|`` (a few ulps of f32).  ``apply_batch``'s weighted sum and the
matmul-based evaluations also differ in f32 summation order (``rtol=1e-5,
atol=1e-5 * max|.|``).  Masks and index lists are injected into both
packages: the two draw different random bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asyncframework_tpu.ops import gradients as jgrad
from asyncframework_tpu.ops import steps as jsteps
from asyncframework_tpu_torch.convert import model_from_reference
from asyncframework_tpu_torch.ops import gradients as tgrad
from asyncframework_tpu_torch.ops import steps as tsteps
from asyncframework_tpu_torch.ops.sampling import worker_generator

CPU = torch.device("cpu")
GAMMA, B, N, P = 0.7, 0.3, 600, 4


def _grads(count, d, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.normal(size=d).astype(np.float32) for _ in range(count)]


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rel,
        atol=rel * float(np.abs(want).max(initial=1.0)),
    )


def test_asgd_apply_sequence_matches():
    d = 33
    japply = jsteps.make_asgd_apply(GAMMA, B, N, P)
    tapply = tsteps.make_asgd_apply(GAMMA, B, N, P)
    w_j, k_j = jnp.zeros(d, jnp.float32), jnp.float32(0.0)
    w_t, k_t = model_from_reference(np.zeros(d, np.float32), 0, CPU)
    for g in _grads(12, d):
        w_prev = w_t
        w_j, k_j = japply(w_j, jnp.array(g), k_j)
        w_t, k_t = tapply(w_t, torch.from_numpy(g), k_t)
        assert w_t is not w_prev  # out of place: w_prev is a model version
    _close(w_t, w_j, 1e-6)
    assert float(k_t) == float(k_j) == 12.0


def test_sync_apply_sequence_matches():
    d = 21
    japply = jsteps.make_sync_apply(GAMMA, B, N)
    tapply = tsteps.make_sync_apply(GAMMA, B, N)
    w_j, k_j = jnp.ones(d, jnp.float32), jnp.float32(3.0)
    w_t, k_t = model_from_reference(np.ones(d, np.float32), 3, CPU)
    for g in _grads(8, d, seed=1):
        w_j, k_j = japply(w_j, jnp.array(g), k_j)
        w_t, k_t = tapply(w_t, torch.from_numpy(g), k_t)
    _close(w_t, w_j, 1e-6)
    assert float(k_t) == float(k_j) == 11.0


@pytest.mark.parametrize("accepted", [[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0]])
def test_apply_batch_matches_and_equals_serial_applies(accepted):
    d, m = 17, 4
    G = np.stack(_grads(m, d, seed=2))
    mask = np.array(accepted, np.float32)
    w0 = np.random.default_rng(3).normal(size=d).astype(np.float32)
    jb = jsteps.make_asgd_apply_batch(GAMMA, B, N, P, m)
    w_j, k_j = jb(jnp.array(w0), jnp.array(G), jnp.array(mask), jnp.float32(5.0))
    tb = tsteps.make_asgd_apply_batch(GAMMA, B, N, P)
    w_t, k_t = tb(torch.from_numpy(w0), torch.from_numpy(G),
                  torch.from_numpy(mask), torch.tensor(5.0))
    _close(w_t, w_j)
    assert float(k_t) == float(k_j) == 5.0 + sum(accepted)
    # the batch is the serial accept path up to addition order
    serial = tsteps.make_asgd_apply(GAMMA, B, N, P)
    w_s, k_s = torch.from_numpy(w0), torch.tensor(5.0)
    for g, a in zip(G, accepted):
        if a:
            w_s, k_s = serial(w_s, torch.from_numpy(g), k_s)
    _close(w_t, w_s.numpy())


def test_add_grads_accumulates_in_place():
    a, b = (torch.from_numpy(g) for g in _grads(2, 9, seed=4))
    want = np.asarray(jsteps.add_grads(jnp.array(a.numpy()), jnp.array(b.numpy())))
    out = tsteps.add_grads(a, b)
    assert out is a
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("b,n", [(0.1, 1000), (0.5, 64), (0.05, 7), (0.3, 50_000)])
def test_capacity_matches(b, n):
    assert tsteps.sparse_step_capacity(b, n) == jsteps.sparse_step_capacity(b, n)


@pytest.mark.parametrize("cap", [8, 40, 64])
def test_compact_mask_matches_nonzero(cap):
    mask = np.random.default_rng(cap).random(64) < 0.4
    valid, idx = tsteps.compact_mask(torch.from_numpy(mask), cap)
    (jidx,) = jnp.nonzero(jnp.array(mask), size=cap, fill_value=0)
    jvalid = (jnp.arange(cap) < jnp.sum(mask)).astype(jnp.float32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("b", [0.7, 0.2])
@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_worker_step_with_injected_sample(b, loss):
    n, d = 200, 24
    rs = np.random.default_rng(7)
    X = rs.normal(size=(n, d)).astype(np.float32)
    y = (rs.random(n) < 0.5).astype(np.float32)
    w = rs.normal(size=d).astype(np.float32) * 0.1
    mask = rs.random(n) < b
    jgrad_sum = (jgrad.least_squares_grad_sum if loss == "least_squares"
                 else jgrad.logistic_grad_sum)
    step = tsteps.make_asgd_worker_step(b, loss)
    Xt, yt, wt = (torch.from_numpy(a) for a in (X, y, w))
    if b > 0.5:
        want = jgrad_sum(X, y, w, mask.astype(np.float32))
        got = step.grad(Xt, yt, wt, torch.from_numpy(mask).float())
    else:
        cap = tsteps.sparse_step_capacity(b, n)
        (idx,) = jnp.nonzero(jnp.array(mask), size=cap, fill_value=0)
        valid = (jnp.arange(cap) < mask.sum()).astype(jnp.float32)
        want = jgrad_sum(jnp.array(X)[idx], jnp.array(y)[idx], w, valid)
        got = step.grad(Xt, yt, wt, *tsteps.compact_mask(torch.from_numpy(mask), cap))
    _close(got, want)
    # the one-call step is the sample then the gradient on that sample
    sample = step.sample(worker_generator(42, 3, CPU), n)
    torch.testing.assert_close(
        step(Xt, yt, wt, worker_generator(42, 3, CPU)),
        step.grad(Xt, yt, wt, *sample), rtol=0, atol=0,
    )
    if b <= 0.5:
        weights, idx = sample
        assert weights.shape == idx.shape == (tsteps.sparse_step_capacity(b, n),)


def test_worker_generators_are_seeded_per_worker():
    a = torch.rand(16, generator=worker_generator(42, 0, CPU))
    assert torch.equal(a, torch.rand(16, generator=worker_generator(42, 0, CPU)))
    assert not torch.equal(a, torch.rand(16, generator=worker_generator(42, 1, CPU)))
    assert not torch.equal(a, torch.rand(16, generator=worker_generator(43, 0, CPU)))


@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_trajectory_eval_and_losses_match(loss):
    rs = np.random.default_rng(8)
    X = rs.normal(size=(90, 12)).astype(np.float32)
    y = (rs.random(90) < 0.5).astype(np.float32)
    W = rs.normal(size=(5, 12)).astype(np.float32)
    got = tsteps.make_trajectory_loss_eval(loss)(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(W))
    _close(got, jsteps.make_trajectory_loss_eval(loss)(X, y, W))
    tl = tgrad.least_squares_loss if loss == "least_squares" else tgrad.logistic_loss
    jl = jgrad.least_squares_loss if loss == "least_squares" else jgrad.logistic_loss
    _close(tl(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(W[0])),
           jl(X, y, W[0]))


def test_mm_f32_bf16_matches():
    rs = np.random.default_rng(9)
    X = rs.normal(size=(70, 16)).astype(np.float32)
    v = rs.normal(size=16).astype(np.float32)
    Xj = jnp.asarray(X, jnp.bfloat16)
    Xt = torch.from_numpy(np.array(Xj.astype(jnp.float32))).to(torch.bfloat16)
    got = tgrad.mm_f32(Xt, torch.from_numpy(v))
    assert got.dtype == torch.float32
    _close(got, jgrad.mm_f32(Xj, jnp.asarray(v)))
    assert jax.devices()[0].platform == "cpu"

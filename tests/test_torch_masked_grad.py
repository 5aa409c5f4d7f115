"""The port's masked-gradient contraction against the JAX package.

On the CPU :func:`masked_grad` runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (as ``tests/test_aux.py`` does) and
the XLA gradient sums.  Inputs come from a seeded numpy generator and go to
both packages as numpy.

Tolerances: f32 ``rtol=1e-5, atol=1e-5 * max|g|`` -- both sides sum the
same f32 products in different orders.  bf16 ``rtol=1e-2, atol=1e-2 *
max|g|`` -- a one-ulp flip of a row coefficient's bf16 rounding follows from
the f32 order of its dot product and moves g by 2^-8 of that row's term.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asyncframework_tpu.ops import gradients as jgrad
from asyncframework_tpu.ops.pallas_kernels import fused_masked_grad
from asyncframework_tpu_torch.ops import gradients as tgrad
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops.masked_grad import (
    masked_grad,
    masked_grad_reference,
)

SHAPES = [(256, 128), (300, 100), (64, 17), (17, 8)]


def _problem(n, d, seed=0):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(np.float32)
    y = rs.normal(size=(n,)).astype(np.float32)
    w = rs.normal(size=(d,)).astype(np.float32)
    mask = (rs.random(n) < 0.5).astype(np.float32)
    return X, y, w, mask


def _bf16_rows(X):
    """X rounded to bf16 by JAX, as exact f32 numpy and as a torch bf16."""
    Xb = np.array(jnp.asarray(X, jnp.bfloat16).astype(jnp.float32))
    return Xb, torch.from_numpy(Xb).to(torch.bfloat16)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=rel, atol=rel * float(np.abs(want).max(initial=1.0))
    )


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("masked", [True, False])
def test_f32_matches_pallas_and_xla(n, d, masked):
    X, y, w, mask = _problem(n, d)
    m = mask if masked else None
    got = masked_grad(torch.from_numpy(X), torch.from_numpy(y),
                      torch.from_numpy(w),
                      None if m is None else torch.from_numpy(m))
    _close(got, fused_masked_grad(X, y, w, m, interpret=True), 1e-5)
    ones = np.ones(n, np.float32) if m is None else m
    _close(got, jgrad.least_squares_grad_sum(X, y, w, ones), 1e-5)


@pytest.mark.parametrize("n,d", SHAPES)
def test_bf16_matches_mm_f32_contract(n, d):
    X, y, w, mask = _problem(n, d, seed=1)
    Xb_np, Xb = _bf16_rows(X)
    got = masked_grad(Xb, torch.from_numpy(y), torch.from_numpy(w),
                      torch.from_numpy(mask))
    want = jgrad.least_squares_grad_sum(
        jnp.asarray(Xb_np, jnp.bfloat16), y, w, mask
    )
    _close(got, want, 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compacted_idx_form_matches_gathered_rows(dtype):
    n, d, cap = 300, 100, 64
    X, y, w, mask = _problem(n, d, seed=2)
    rs = np.random.default_rng(3)
    count = 50
    idx = np.zeros(cap, np.int64)
    idx[:count] = np.sort(rs.choice(n, size=count, replace=False))
    valid = (np.arange(cap) < count).astype(np.float32)
    if dtype == "bfloat16":
        X, Xt = _bf16_rows(X)
        Xj = jnp.asarray(X, jnp.bfloat16)
        rel = 1e-2
    else:
        Xt, Xj, rel = torch.from_numpy(X), X, 1e-5
    got = masked_grad(Xt, torch.from_numpy(y), torch.from_numpy(w),
                      torch.from_numpy(valid), torch.from_numpy(idx))
    want = jgrad.least_squares_grad_sum(Xj[idx], y[idx], w, valid)
    _close(got, want, rel)


@pytest.mark.parametrize("compact", [False, True])
def test_logistic_matches_logistic_grad_sum(compact):
    n, d = 256, 32
    X, _, w, mask = _problem(n, d, seed=4)
    y = (np.random.default_rng(5).random(n) < 0.5).astype(np.float32)
    if compact:
        idx = np.arange(0, n, 3, dtype=np.int64)
        weights = np.ones(idx.shape[0], np.float32)
        want = jgrad.logistic_grad_sum(X[idx], y[idx], w, weights)
        t_idx = torch.from_numpy(idx)
    else:
        weights, t_idx = mask, None
        want = jgrad.logistic_grad_sum(X, y, w, mask)
    got = tgrad.logistic_grad_sum(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(weights), t_idx,
    )
    _close(got, want, 1e-5)


def test_empty_inputs_give_zeros():
    d = 8
    w = torch.ones(d)
    g = masked_grad(torch.zeros(0, d), torch.zeros(0), w)
    assert g.shape == (d,) and not g.any()
    X = torch.ones(5, d)
    g = masked_grad(X, torch.zeros(5), w, torch.zeros(0),
                    torch.zeros(0, dtype=torch.int64))
    assert g.shape == (d,) and not g.any()


@pytest.mark.parametrize("bad,exc", [
    (dict(y=torch.zeros(5, dtype=torch.float64)), TypeError),
    (dict(w=torch.zeros(3)), ValueError),
    (dict(mask=torch.ones(4)), ValueError),
    (dict(idx=torch.zeros(2, dtype=torch.int32)), TypeError),
    (dict(X=torch.zeros(8, 5).T), ValueError),
    (dict(X=torch.zeros(5, 4, dtype=torch.float16)), TypeError),
    (dict(loss="hinge"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    args = dict(X=torch.zeros(5, 4), y=torch.zeros(5), w=torch.zeros(4),
                mask=None, idx=None, loss="least_squares")
    args.update(bad)
    with pytest.raises(exc):
        masked_grad(**args)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    X, y, w, mask = (torch.from_numpy(a) for a in _problem(64, 17))
    before = masked_grad.launches
    assert torch.equal(masked_grad(X, y, w, mask),
                       masked_grad_reference(X, y, w, mask))
    assert masked_grad.launches == before
    assert mg.LOSSES == {"least_squares": 0, "logistic": 1}


"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip with a reason where there is no CUDA device.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports neither ``jax`` nor ``asyncframework_tpu``.
"""

import numpy as np
import pytest
import torch

from asyncframework_tpu_torch.ops.masked_grad import (
    masked_grad,
    masked_grad_reference,
)
from asyncframework_tpu_torch.ops.steps import compact_mask

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version sum the same products in different
# orders; bf16: a one-ulp flip of a row coefficient's bf16 rounding moves g
# by 2^-8 of that row's term
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _problem(n, d, dev, dtype, seed=0):
    rs = np.random.default_rng(seed)
    X = torch.tensor(rs.normal(size=(n, d)), dtype=torch.float32, device=dev)
    y = torch.tensor(rs.normal(size=n), dtype=torch.float32, device=dev)
    w = torch.tensor(rs.normal(size=d), dtype=torch.float32, device=dev)
    mask = torch.tensor(rs.random(n) < 0.5, device=dev)
    return X.to(dtype), y, w, mask


def _close(got, want, rel):
    want = want.cpu()
    torch.testing.assert_close(
        got.cpu(), want, rtol=rel, atol=rel * float(want.abs().max().clamp(min=1))
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(999, 130), (17, 8), (300, 100), (5000, 784)])
@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_kernel_matches_plain_version(dev, dtype, n, d, loss):
    X, y, w, sel = _problem(n, d, dev, dtype)
    cap = max(8, n // 3)
    valid, idx = compact_mask(sel, cap)
    for m, i in ((sel.float(), None), (None, None), (valid, idx)):
        got = masked_grad(X, y, w, m, i, loss)
        _close(got, masked_grad_reference(X, y, w, m, i, loss), REL[dtype])
        assert torch.equal(got, masked_grad(X, y, w, m, i, loss))


def test_kernel_edges(dev):
    w = torch.ones(8, device=dev)
    g = masked_grad(torch.zeros(0, 8, device=dev), torch.zeros(0, device=dev), w)
    assert g.shape == (8,) and not g.any()
    # a row too wide for the shared-memory accumulator takes the global one
    X, y, w, sel = _problem(40, 60_000, dev, torch.float32, seed=1)
    _close(masked_grad(X, y, w, sel.float()),
           masked_grad_reference(X, y, w, sel.float()), REL[torch.float32])
    # a width that is no multiple of 4 takes the scalar-load path
    Xs = X[:, 1:].contiguous()
    ws = w[1:].contiguous()
    _close(masked_grad(Xs, y, ws), masked_grad_reference(Xs, y, ws),
           REL[torch.float32])


def test_launch_counter_counts_kernel_calls(dev):
    X, y, w, sel = _problem(64, 16, dev, torch.float32)
    before = masked_grad.launches
    masked_grad(X, y, w, sel.float())
    assert masked_grad.launches == before + 1

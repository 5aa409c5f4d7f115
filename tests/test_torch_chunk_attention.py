"""The port's block-attention kernel (B2) against the JAX package.

On the CPU :func:`chunk_attention` runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode (as ``tests/test_ring.py``
does).  Inputs come from a seeded numpy generator and go to both packages
as numpy.

Tolerances are ``tests/test_ring.py``'s own for this kernel: ``m`` at
``rtol=1e-6`` (a maximum of the same scores, which differ only in the
order their f32 dot products were summed), ``l`` at ``rtol=1e-5`` (a sum of
exponentials of those scores), ``o`` at ``rtol=1e-4, atol=1e-5`` (a second
f32 product on top).  ``m`` also gets ``atol=1e-6``: the scores here are
O(1), and a row maximum that lands near 0 after cancellation (0.01 for one
row of seed 2) carries the few-ulp error of its O(1) products, which is
far more than 1e-6 of its own size.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asyncframework_tpu.ops.pallas_kernels import chunk_attention as jax_chunk
from asyncframework_tpu_torch.ops import chunk_attention as ca
from asyncframework_tpu_torch.ops.chunk_attention import (
    chunk_attention,
    chunk_attention_reference,
)


def _qkv(rs, b=2, tq=24, tk=18, h=3, d=20):
    q = rs.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rs.normal(size=(b, tk, h, d)).astype(np.float32)
    v = rs.normal(size=(b, tk, h, d)).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _compare(got, want):
    (o, m, l), (jo, jm, jl) = got, want
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
def test_plain_version_matches_the_pallas_kernel(masked):
    """``tests/test_ring.py``'s shapes: (2, 24, 3, 20) against Tk = 18."""
    rs = np.random.default_rng(0)
    q, k, v = _qkv(rs)
    mask = rs.random((24, 18)) > 0.3 if masked else None
    want = jax_chunk(q, k, v, mask, interpret=True)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = chunk_attention(*_torch(q, k, v), tmask)
    assert got[0].shape == (2, 24, 3, 20) and got[1].shape == (2, 3, 24)
    assert all(t.dtype == torch.float32 for t in got)
    _compare(got, want)


def test_bf16_inputs_match():
    """bf16 inputs are widened to f32 before the products in both
    packages (exact), so the f32 tolerances hold."""
    rs = np.random.default_rng(1)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in _qkv(rs))
    mask = rs.random((24, 18)) > 0.3
    want = jax_chunk(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     mask, interpret=True)
    got = chunk_attention(*(t.to(torch.bfloat16) for t in _torch(q, k, v)),
                          torch.from_numpy(mask))
    _compare(got, want)


def test_fully_masked_row_counts_the_padded_columns():
    """A row with no unmasked key: the TPU kernel pads Tk = 18 to 24 with
    masked columns, so m = -1e30, l = 24 and o = sum_k v_k -- in both
    packages."""
    rs = np.random.default_rng(2)
    q, k, v = _qkv(rs)
    mask = rs.random((24, 18)) > 0.3
    mask[5] = False
    jo, jm, jl = jax_chunk(q, k, v, mask, interpret=True)
    o, m, l = chunk_attention(*_torch(q, k, v), torch.from_numpy(mask))
    assert float(np.asarray(jl)[0, 0, 5]) == 24.0
    assert torch.all(l[:, :, 5] == 24.0)
    assert torch.all(m[:, :, 5] == np.float32(-1e30))
    np.testing.assert_allclose(o[:, 5].numpy(), v.sum(axis=1), rtol=1e-5,
                               atol=1e-5)
    _compare((o, m, l), (jo, jm, jl))


@pytest.mark.parametrize("tq,tk,d", [(1, 18, 64), (8, 8, 64), (33, 70, 128)])
def test_edge_shapes_match(tq, tk, d):
    rs = np.random.default_rng(3)
    q, k, v = _qkv(rs, b=1, tq=tq, tk=tk, h=2, d=d)
    mask = np.tril(np.ones((tq, tk), bool), k=tk - tq)
    want = jax_chunk(q, k, v, mask, interpret=True)
    _compare(chunk_attention(*_torch(q, k, v), torch.from_numpy(mask)), want)


def test_scale_is_multiplied_in_not_divided():
    """s = (q k^T) * f32(1/sqrt(D)): D = 20 is a width where multiplying by
    the rounded reciprocal and dividing by sqrt(D) round differently for
    some scores; the plain version takes the JAX kernel's form."""
    rs = np.random.default_rng(4)
    q, k, v = _qkv(rs, b=1, tq=16, tk=16, h=1, d=20)
    dots = torch.einsum("bqhd,bkhd->bhqk", *_torch(q, k))
    mult = dots * torch.tensor(1.0 / math.sqrt(20), dtype=torch.float32)
    div = dots / math.sqrt(20)
    assert not torch.equal(mult, div)
    _, m, _ = chunk_attention_reference(*_torch(q, k, v))
    assert torch.equal(m, mult.amax(-1))


def test_strided_views_are_read_in_place():
    """q, k and v may be views (a sequence slice of a longer tensor); the
    result equals that of contiguous copies."""
    rs = np.random.default_rng(5)
    q, k, v = _torch(*_qkv(rs, tq=40, tk=40))
    qs, ks, vs = q[:, 8:32], k[:, 4:22], v[:, 4:22]
    assert not qs.is_contiguous()
    got = chunk_attention(qs, ks, vs)
    want = chunk_attention(qs.contiguous(), ks.contiguous(), vs.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_uint8_mask_equals_bool_mask():
    rs = np.random.default_rng(6)
    q, k, v = _torch(*_qkv(rs))
    mask = torch.from_numpy(rs.random((24, 18)) > 0.5)
    for a, b in zip(chunk_attention(q, k, v, mask),
                    chunk_attention(q, k, v, mask.to(torch.uint8))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("mixed", ValueError), ("shape", ValueError),
    ("mask_shape", ValueError), ("mask_dtype", TypeError),
    ("wide", ValueError), ("stride", ValueError), ("empty_k", ValueError),
])
def test_wrapper_rejects_bad_inputs(case, exc):
    rs = np.random.default_rng(7)
    q, k, v = _torch(*_qkv(rs))
    mask = None
    if case == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "shape":
        v = v[:, :, :2]
    elif case == "mask_shape":
        mask = torch.ones(24, 17, dtype=torch.bool)
    elif case == "mask_dtype":
        mask = torch.ones(24, 18)
    elif case == "wide":
        q, k, v = (torch.zeros(1, 4, 1, 257) for _ in range(3))
    elif case == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    elif case == "empty_k":
        k, v = k[:, :0], v[:, :0]
    with pytest.raises(exc):
        chunk_attention(q, k, v, mask)


def test_grad_raises_naming_the_roadmap():
    rs = np.random.default_rng(8)
    q, k, v = _torch(*_qkv(rs))
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chunk_attention(q, k, v)
    with torch.no_grad():
        chunk_attention(q, k, v)  # no graph: the forward alone is fine


def test_cpu_tensors_are_not_counted_as_launches():
    rs = np.random.default_rng(9)
    before = chunk_attention.launches
    chunk_attention(*_torch(*_qkv(rs)))
    assert chunk_attention.launches == before
    assert ca.chunk_attention is chunk_attention

"""The port's ring and Ulysses attention against the JAX package.

The port runs the per-rank program as a loop over the ranks of
``make_mesh(8, axis_names=("sp",), devices=[cpu] * 8)``; the JAX package runs it under
``shard_map`` on its 8 virtual CPU devices.  Both block paths are held:
``"torch"`` (JAX ``"xla"``) and ``"cuda"`` (JAX ``"pallas"``, whose kernel
runs in interpret mode; the port's wrapper takes its plain version for CPU
tensors).  Inputs come from a seeded numpy generator and go to both
packages as numpy; the shapes are ``tests/test_ring.py``'s.

Tolerances are ``tests/test_ring.py``'s: outputs ``rtol=2e-4, atol=2e-5``
(both sides sum f32 products and exponentials in different orders, and
fold the blocks through the same rescale), gradients ``rtol=5e-4,
atol=5e-5`` (the backward adds a second pass of such sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asyncframework_tpu.parallel import make_mesh as jax_make_mesh
from asyncframework_tpu.parallel import reference_attention as jax_reference
from asyncframework_tpu.parallel import ring_attention as jax_ring
from asyncframework_tpu.parallel import ulysses_attention as jax_ulysses
from asyncframework_tpu_torch.ops.chunk_attention import chunk_attention
from asyncframework_tpu_torch.parallel import (
    make_mesh,
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from asyncframework_tpu_torch.tools import ring_attention_demo

CPU = torch.device("cpu")
JAX_KERNEL = {"torch": "xla", "cuda": "pallas"}


@pytest.fixture(scope="module")
def meshes():
    return (make_mesh(8, axis_names=("sp",), devices=[CPU] * 8),
            jax_make_mesh(8, axis_names=("sp",), devices=jax.devices()[:8]))


def _qkv(seed, shape):
    rs = np.random.default_rng(seed)
    return [rs.normal(size=shape).astype(np.float32) for _ in range(3)]


def _close(got, want, rtol=2e-4, atol=2e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel,shape", [
    ("torch", (2, 64, 8, 16)), ("cuda", (2, 32, 2, 16)),
])
def test_ring_matches_jax_and_reference(meshes, kernel, shape, causal):
    mesh, jmesh = meshes
    q, k, v = _qkv(0, shape)
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                         causal=causal, block_kernel=kernel)
    # jitted: one XLA program, where the eager shard_map ring compiles
    # op by op
    want = jax.jit(lambda q, k, v: jax_ring(
        q, k, v, jmesh, causal=causal,
        block_kernel=JAX_KERNEL[kernel]))(q, k, v)
    assert got.shape == shape and got.dtype == torch.float32
    _close(got, want)
    _close(got, jax_reference(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel,shape,block", [
    ("torch", (2, 64, 8, 16), 512), ("cuda", (2, 32, 8, 16), 512),
    ("cuda", (1, 32, 8, 8), 8),
])
def test_ulysses_matches_jax_and_reference(meshes, kernel, shape, block,
                                           causal):
    """``pallas_block=8`` folds the 32-long sequence in four K/V blocks."""
    mesh, jmesh = meshes
    q, k, v = _qkv(1, shape)
    got = ulysses_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                            causal=causal, block_kernel=kernel,
                            pallas_block=block)
    want = jax.jit(lambda q, k, v: jax_ulysses(
        q, k, v, jmesh, causal=causal, block_kernel=JAX_KERNEL[kernel],
        pallas_block=block))(q, k, v)
    _close(got, want)
    _close(got, jax_reference(q, k, v, causal=causal))


def test_ulysses_pads_a_ragged_last_block(meshes):
    """A block size that does not divide the sequence: the padded K columns
    are masked, so the result is still exact attention."""
    mesh, _ = meshes
    q, k, v = map(torch.from_numpy, _qkv(2, (1, 32, 8, 8)))
    for causal in (False, True):
        got = ulysses_attention(q, k, v, mesh, causal=causal,
                                block_kernel="cuda", pallas_block=12)
        _close(got, reference_attention(q, k, v, causal=causal))


def test_cuda_block_path_goes_through_the_block_kernel(meshes, monkeypatch):
    """Causal ring at P = 8 folds 1 + 2 + ... + 8 = 36 blocks (future blocks
    are skipped); Ulysses with 4 K/V blocks folds 4 per rank."""
    from asyncframework_tpu_torch.parallel import ring as ring_mod

    calls = []

    def counting(*args):
        calls.append(args[1].shape[1])
        return chunk_attention(*args)

    monkeypatch.setattr(ring_mod, "chunk_attention", counting)
    mesh, _ = meshes
    q, k, v = map(torch.from_numpy, _qkv(3, (1, 32, 8, 8)))
    ring_attention(q, k, v, mesh, causal=True, block_kernel="cuda")
    assert len(calls) == 36
    calls.clear()
    ulysses_attention(q, k, v, mesh, causal=True, block_kernel="cuda",
                      pallas_block=8)
    assert calls == [8] * 32


def test_single_rank_mesh_degenerates():
    q, k, v = map(torch.from_numpy, _qkv(4, (2, 32, 8, 16)))
    mesh = make_mesh(1, axis_names=("sp",), devices=[CPU])
    _close(ring_attention(q, k, v, mesh), reference_attention(q, k, v))
    _close(ulysses_attention(q, k, v, mesh, block_kernel="cuda"),
           reference_attention(q, k, v))


def test_causal_first_position_attends_to_itself_only(meshes):
    mesh, _ = meshes
    q, k, v = map(torch.from_numpy, _qkv(5, (1, 64, 8, 16)))
    for kernel in ("torch", "cuda"):
        out = ring_attention(q, k, v, mesh, causal=True, block_kernel=kernel)
        _close(out[0, 0], v[0, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["ring", "ulysses"])
def test_bf16_keeps_its_dtype_and_error_band(meshes, fn):
    """bf16 inputs: the output is bf16, and its error against an f32 oracle
    stays in the band of single-shot bf16 attention (``tests/test_ring.py``'s
    criterion: f32 running state, so it does not grow with ring steps)."""
    mesh, _ = meshes
    q, k, v = map(torch.from_numpy, _qkv(6, (2, 64, 8, 16)))
    oracle = reference_attention(q, k, v)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    run = ring_attention if fn == "ring" else ulysses_attention
    ref_err = float((reference_attention(qb, kb, vb).float() - oracle).abs().max())
    for kernel in ("torch", "cuda"):
        out = run(qb, kb, vb, mesh, block_kernel=kernel)
        assert out.dtype == torch.bfloat16
        err = float((out.float() - oracle).abs().max())
        assert err < 2.5 * ref_err + 1e-3, (kernel, err, ref_err)


def test_bf16_ring_matches_jax(meshes):
    """The "torch" block path keeps the JAX package's casts (f32 scores,
    p cast to v's dtype): the two agree to 2^-7, two bf16 roundings -- each
    side rounds its output to bf16 once, and p's bf16 rounding can flip
    where the f32 scores differ in their last bit."""
    mesh, jmesh = meshes
    q, k, v = _qkv(7, (2, 64, 8, 16))
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_ring(qj, kj, vj, jmesh, causal=True).astype(jnp.float32)
    got = ring_attention(*(torch.from_numpy(np.array(x.astype(jnp.float32)))
                           .to(torch.bfloat16) for x in (qj, kj, vj)),
                         mesh, causal=True)
    _close(got, want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("case,match", [
    ("ring_uneven", "not divisible"), ("ring_qk", "equal q/k seq lens"),
    ("ring_kernel", "block_kernel"), ("ulysses_heads", "heads"),
    ("ulysses_uneven", "not divisible"), ("ulysses_kernel", "block_kernel"),
    ("ulysses_causal_qk", "equal q/k seq lens"), ("mesh_size", "9-device"),
    ("mesh_axis", "no axis"),
])
def test_value_errors(meshes, case, match):
    mesh, _ = meshes
    q, k, v = map(torch.from_numpy, _qkv(8, (1, 32, 8, 4)))
    with pytest.raises(ValueError, match=match):
        if case == "ring_uneven":
            ring_attention(q[:, :30], k[:, :30], v[:, :30], mesh)
        elif case == "ring_qk":
            ring_attention(q[:, :16], k, v, mesh, causal=True)
        elif case == "ring_kernel":
            ring_attention(q, k, v, mesh, block_kernel="pallas")
        elif case == "ulysses_heads":
            ulysses_attention(q[:, :, :6], k[:, :, :6], v[:, :, :6], mesh)
        elif case == "ulysses_uneven":
            ulysses_attention(q, k[:, :30], v[:, :30], mesh)
        elif case == "ulysses_kernel":
            ulysses_attention(q, k, v, mesh, block_kernel="xla")
        elif case == "ulysses_causal_qk":
            ulysses_attention(q[:, :16], k, v, mesh, causal=True)
        elif case == "mesh_size":
            make_mesh(9, devices=[CPU] * 8)
        elif case == "mesh_axis":
            ring_attention(q, k, v, mesh, axis="dp")


def test_gradient_matches_jax_grad_of_the_ring(meshes):
    """The "torch" path is differentiable: the gradient of sum(out^2) with
    respect to q, k and v against ``jax.grad`` of the JAX ring (causal)."""
    mesh, jmesh = meshes
    q, k, v = _qkv(9, (1, 32, 4, 8))

    def loss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, jmesh, causal=True) ** 2)

    # jitted: one XLA program (the eager gradient of the shard_map ring
    # compiles op by op, ~20x slower on the CPU)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (ring_attention(*ts, mesh, causal=True) ** 2).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, rtol=5e-4, atol=5e-5)


def test_ulysses_gradient_matches_reference(meshes):
    q, k, v = _qkv(10, (1, 32, 8, 8))
    grads = []
    for fn in (lambda *a: ulysses_attention(*a, meshes[0], causal=True),
               lambda *a: reference_attention(*a, causal=True)):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*ts) ** 2).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        _close(a, b, rtol=5e-4, atol=5e-5)


def test_demo_runs_on_the_cpu(capsys):
    out = ring_attention_demo.main(t=64, h=2, d=8, devices=[CPU] * 4)
    assert out.shape == (1, 64, 2, 8)
    assert "max |err| vs full attention" in capsys.readouterr().out


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention])
def test_a_mesh_across_processes_is_refused_naming_its_item(fn):
    """Ranks held by other processes (``multihost.global_mesh``) need the
    torch.distributed ring, which is not ported: refused, never run as if
    every rank were local."""
    from asyncframework_tpu_torch.parallel.mesh import Mesh

    q, k, v = map(torch.from_numpy, _qkv(4, (1, 8, 2, 4)))
    mesh = Mesh([CPU] * 4, ("sp",), process_of=[0, 0, 1, 1])
    with pytest.raises(NotImplementedError, match="ROADMAP A6b.6"):
        fn(q, k, v, mesh)

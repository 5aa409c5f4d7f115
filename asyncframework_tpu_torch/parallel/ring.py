"""Long-context attention: ring attention and all-to-all sequence parallelism.

Counterpart of ``asyncframework_tpu/parallel/ring.py``, with the same
signatures: the functions take global ``(batch, seq, heads, head_dim)``
tensors and a :class:`~asyncframework_tpu_torch.parallel.mesh.Mesh`, shard
the sequence over the mesh axis, and return the global output in ``q``'s
dtype on ``q``'s device.  Causal masking uses global positions.

- :func:`ring_attention` -- flash-style online-softmax attention where the
  K/V blocks rotate around the ring of ranks; rank ``p`` holds ``T/P`` of
  the sequence and at ring step ``s`` the K/V block of rank
  ``(p - s) mod P``.
- :func:`ulysses_attention` -- switch from sequence sharding to head
  sharding (all-to-all), attend over the full sequence per local head
  group, switch back; needs ``heads % P == 0``.

From SPMD to one process: JAX runs the per-rank program under
``shard_map``; here the program is a loop over the P ranks, and shard ``p``
lives on ``mesh.devices[p]``.  ``ppermute`` becomes a rotation of the
rank list with ``.to(next_device, non_blocking=True)`` (a no-op where a
device repeats), and ``all_to_all`` becomes slicing along heads plus a
concatenation along the sequence across ranks.  A mesh whose ranks span
processes (``parallel/multihost.py::global_mesh``) is refused: the ring
and the all-to-all over ``torch.distributed`` (send and recv,
``all_to_all_single``) are not ported yet (ROADMAP A6b.6).

``block_kernel`` names the per-block computation:

- ``"torch"`` (JAX: ``"xla"``) -- einsum and ``torch.matmul``, which XLA
  runs outside any Pallas kernel (:func:`_block_accumulate`); differentiable
  by autograd, as JAX differentiates its XLA path;
- ``"cuda"`` (JAX: ``"pallas"``) -- the hand-written block kernel
  :func:`~asyncframework_tpu_torch.ops.chunk_attention.chunk_attention`
  (its plain version on CPU tensors), whose ``(o, m, l)`` triple the same
  flash rescale (:func:`_merge_stats`) folds.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from asyncframework_tpu_torch.ops.chunk_attention import chunk_attention
from asyncframework_tpu_torch.parallel.mesh import Mesh
from asyncframework_tpu_torch.utils.devices import device_scope

_NEG = -1e30  # mask fill / softmax-max init: finite so (-inf) - (-inf) never NaNs
BLOCK_KERNELS = ("torch", "cuda")


def reference_attention(q, k, v, causal: bool = False):
    """Single-device full softmax attention (the correctness oracle)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril(tk - tq)
        s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _block_accumulate(q, k, v, m, l, o, mask):
    """One flash step: fold a K/V block into the running (max, denom, out).

    ``q``: (B, Tq, H, D); ``k``/``v``: (B, Tk, H, D); ``m``/``l``: (B, H, Tq)
    f32; ``o``: (B, Tq, H, D) f32; ``mask``: (Tq, Tk) or None.  The products
    accumulate in f32 whatever the input dtype, and ``p`` is cast to ``v``'s
    dtype before the second product, as in the JAX package.
    """
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG)
    m_b = s.amax(dim=-1)                         # (B, H, Tq) f32
    p = torch.exp(s - m_b[..., None])            # (B, H, Tq, Tk) f32
    l_b = p.sum(dim=-1)
    o_b = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return _merge_stats(m, l, o, m_b, l_b, o_b)


def _merge_stats(m, l, o, m_b, l_b, o_b):
    """Fold a block's local softmax stats into the running (m, l, o) -- the
    standard flash rescale, shared by the two block paths."""
    m_new = torch.maximum(m, m_b)
    c_old = torch.exp(m - m_new)
    c_new = torch.exp(m_b - m_new)
    l_new = l * c_old + l_b * c_new
    o_new = (
        o * c_old.transpose(1, 2)[..., None]
        + o_b * c_new.transpose(1, 2)[..., None]
    )
    return m_new, l_new, o_new


def _check_kernel(block_kernel: str) -> None:
    if block_kernel not in BLOCK_KERNELS:
        raise ValueError("block_kernel must be 'torch' or 'cuda'")


def _shards(x, devs) -> List[torch.Tensor]:
    """The per-rank sequence chunks of a global tensor, each on its rank's
    device (a view where the device is the tensor's own)."""
    tl = x.shape[1] // len(devs)
    return [
        x[:, p * tl:(p + 1) * tl].to(dev, non_blocking=True)
        for p, dev in enumerate(devs)
    ]


def _gather(parts, dim: int, device) -> torch.Tensor:
    return torch.cat([x.to(device, non_blocking=True) for x in parts], dim=dim)


def _rotate(blocks, devs) -> List[torch.Tensor]:
    """``ppermute`` to the next rank: rank j receives rank j-1's block."""
    n = len(devs)
    return [blocks[(j - 1) % n].to(devs[j], non_blocking=True) for j in range(n)]


def _check_one_process(mesh: Mesh) -> None:
    if mesh.spans_processes():
        raise NotImplementedError(
            "ring and Ulysses attention over a mesh that spans processes "
            "(torch.distributed send/recv and all_to_all_single) are not "
            "ported to the PyTorch package yet (ROADMAP A6b.6)")


def ring_attention(
    q, k, v, mesh: Mesh, axis: str = "sp", causal: bool = False,
    block_kernel: str = "torch",
):
    """Exact attention over a sequence-sharded mesh axis via a K/V ring.

    Rank ``p`` starts with its own K/V block and at ring step ``s`` holds
    the block of rank ``(p - s) mod P``.  With ``causal``, a block wholly in
    the future of rank ``p`` (``k_block > p``) is skipped, the diagonal
    block folds with the global-position mask, and a block wholly in the
    past folds unmasked.  The last fold has no rotation after it.
    """
    _check_kernel(block_kernel)
    _check_one_process(mesh)
    devs = mesh.axis_devices(axis)
    n_dev = len(devs)
    if q.shape[1] % n_dev:
        raise ValueError(
            f"seq len {q.shape[1]} not divisible by mesh axis size {n_dev}"
        )
    if q.shape[1] != k.shape[1]:
        # the block-position causal mask assumes aligned q/k positions;
        # cross-attention-style tq != tk would be silently wrong
        raise ValueError(
            f"ring_attention requires equal q/k seq lens, got {q.shape[1]} "
            f"vs {k.shape[1]}"
        )
    b, t, h, d = q.shape
    tl = t // n_dev
    qs, kb, vb = _shards(q, devs), _shards(k, devs), _shards(v, devs)
    m = [torch.full((b, h, tl), _NEG, dtype=torch.float32, device=x) for x in devs]
    l = [torch.zeros((b, h, tl), dtype=torch.float32, device=x) for x in devs]
    o = [torch.zeros((b, tl, h, d), dtype=torch.float32, device=x) for x in devs]
    for s in range(n_dev):
        for p, dev in enumerate(devs):
            mask = None
            k_block = (p - s) % n_dev
            if causal and k_block > p:
                continue  # wholly in the future: nothing to fold
            with device_scope(dev):
                if causal and k_block == p:
                    # the diagonal block; a block wholly in the past is all
                    # attended, so it needs no mask (the same result as
                    # the all-True mask the JAX package builds for it)
                    q_pos = p * tl + torch.arange(tl, device=dev)
                    k_pos = k_block * tl + torch.arange(tl, device=dev)
                    mask = q_pos[:, None] >= k_pos[None, :]
                if block_kernel == "cuda":
                    o_b, m_b, l_b = chunk_attention(qs[p], kb[p], vb[p], mask)
                    m[p], l[p], o[p] = _merge_stats(m[p], l[p], o[p], m_b, l_b, o_b)
                else:
                    m[p], l[p], o[p] = _block_accumulate(
                        qs[p], kb[p], vb[p], m[p], l[p], o[p], mask
                    )
        if s < n_dev - 1:
            kb, vb = _rotate(kb, devs), _rotate(vb, devs)
    outs = [
        (o[p] / l[p].transpose(1, 2)[..., None]).to(q.dtype) for p in range(n_dev)
    ]
    return _gather(outs, 1, q.device)


def _ulysses_blocks(qh, kh, vh, causal: bool, pallas_block: int):
    """Full-sequence attention of one rank's head group, folded through the
    block kernel in ``pallas_block``-sized K/V blocks with per-block masks
    from index arithmetic (nothing O(Tq * Tk) is made); padded K columns
    are masked."""
    tq, tk = qh.shape[1], kh.shape[1]
    blk = min(tk, max(int(pallas_block), 8))
    pad_k = (-tk) % blk
    if pad_k:
        kh = F.pad(kh, (0, 0, 0, 0, 0, pad_k))
        vh = F.pad(vh, (0, 0, 0, 0, 0, pad_k))
    nb = (tk + pad_k) // blk
    b, _, hl, _ = qh.shape
    dev = qh.device
    q_pos = torch.arange(tq, device=dev)
    m = torch.full((b, hl, tq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hl, tq), dtype=torch.float32, device=dev)
    o = torch.zeros(qh.shape, dtype=torch.float32, device=dev)
    for i in range(nb):
        kb = kh[:, i * blk:(i + 1) * blk]
        vb = vh[:, i * blk:(i + 1) * blk]
        k_pos = i * blk + torch.arange(blk, device=dev)
        valid = k_pos[None, :] < tk
        if causal:
            mask_b = (q_pos[:, None] >= k_pos[None, :]) & valid
        else:
            mask_b = valid.expand(tq, blk).contiguous()
        o_b, m_b, l_b = chunk_attention(qh, kb, vb, mask_b)
        m, l, o = _merge_stats(m, l, o, m_b, l_b, o_b)
    return (o / l.transpose(1, 2)[..., None]).to(qh.dtype)


def ulysses_attention(
    q, k, v, mesh: Mesh, axis: str = "sp", causal: bool = False,
    block_kernel: str = "torch", pallas_block: int = 512,
):
    """All-to-all sequence parallelism (Ulysses-style): reshard seq->heads,
    attend over the full sequence per local head group, reshard back.

    ``block_kernel="cuda"`` folds the full-sequence attention through the
    block kernel in ``pallas_block``-sized K/V blocks merged by the shared
    flash rescale; ``"torch"`` runs :func:`reference_attention`.
    """
    _check_kernel(block_kernel)
    _check_one_process(mesh)
    devs = mesh.axis_devices(axis)
    n_dev = len(devs)
    h = q.shape[2]
    if h % n_dev:
        raise ValueError(f"heads {h} not divisible by mesh axis size {n_dev}")
    for name, t in (("q", q.shape[1]), ("k", k.shape[1])):
        if t % n_dev:
            raise ValueError(
                f"{name} seq len {t} not divisible by mesh axis size {n_dev}"
            )
    if causal and q.shape[1] != k.shape[1]:
        # the reference aligns the causal mask bottom-right for tq != tk;
        # the resharded local attention would mask with absolute positions
        raise ValueError(
            f"causal ulysses_attention requires equal q/k seq lens, got "
            f"{q.shape[1]} vs {k.shape[1]}"
        )
    hl = h // n_dev

    def seq_to_heads(chunks):
        # rank p gathers head group p of every rank's sequence chunk
        return [
            _gather([c[:, :, p * hl:(p + 1) * hl] for c in chunks], 1, dev)
            for p, dev in enumerate(devs)
        ]

    def heads_to_seq(groups):
        # rank r gathers sequence chunk r of every rank's head group
        tl = groups[0].shape[1] // n_dev
        return [
            _gather([g[:, r * tl:(r + 1) * tl] for g in groups], 2, dev)
            for r, dev in enumerate(devs)
        ]

    qh, kh, vh = (seq_to_heads(_shards(x, devs)) for x in (q, k, v))
    oh = []
    for p, dev in enumerate(devs):
        with device_scope(dev):
            if block_kernel == "cuda":
                oh.append(_ulysses_blocks(qh[p], kh[p], vh[p], causal, pallas_block))
            else:
                oh.append(reference_attention(qh[p], kh[p], vh[p], causal=causal))
    return _gather(heads_to_seq(oh), 1, q.device)

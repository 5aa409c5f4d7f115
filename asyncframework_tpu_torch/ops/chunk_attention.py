"""Block attention with local softmax statistics, ``(o, m, l)``.

Counterpart of ``asyncframework_tpu/ops/pallas_kernels.py::chunk_attention``
(the Pallas TPU kernel, ``pallas_call`` at ``:155``).

Semantics (``pallas_kernels.py:127-227``), for each (batch, head):
``s = (q k^T) * scale`` with ``scale = f32(1/sqrt(D))`` multiplied in, set
to ``-1e30`` where ``mask == 0``; ``m = rowmax s``, ``p = exp(s - m)``,
``l = rowsum p``, ``o = p v`` unnormalised, all in f32 (q, k and v are
widened to f32 before the products).  The TPU kernel pads Tk to a multiple
of 8 with masked columns, so a row with no unmasked key comes back as
``m = -1e30``, ``o = sum_k v_k`` and ``l = Tk`` rounded up to 8; every
version here returns the same.

On CPU tensors :func:`chunk_attention` runs
:func:`chunk_attention_reference`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against.  On CUDA tensors it launches the
hand-written Hopper kernel in ``csrc/chunk_attention.cu`` (built by nvcc at
first use, bound with ctypes) by one of two routes, picked explicitly by
:func:`tensor_core_route`:

* the tensor-core route, for bf16 q/k/v with D a multiple of 16 whose views
  TMA can read: ``q k^T`` in bf16 ``wgmma`` with f32 accumulation (bf16
  products are exact in f32), and ``p v`` as three bf16 ``wgmma`` passes
  over ``p = p1 + p2 + p3`` (:func:`split_p`, exact for p in [2^-100, 1]),
  so p stays the f32 value; counted in ``chunk_attention.launches_tc``;
* the f32 route (f32 inputs, and bf16 views the first route does not
  take): f32 FMAs on the CUDA cores.

Both count in ``chunk_attention.launches``.  There is no fallback between
routes or to the plain version: a CUDA tensor goes to its route's kernel or
raises.  :func:`chunk_attention_tc_emulation` repeats the tensor-core
route's arithmetic in plain PyTorch for the tests.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from asyncframework_tpu_torch.ops import _build
from asyncframework_tpu_torch.ops._checks import on_cuda

NEG = -1e30  # the TPU kernel's mask fill
MAX_D = 256  # widest head the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_DTYPES = (torch.bool, torch.uint8)

_count_lock = threading.Lock()
_lib = None


def _scale(D: int) -> torch.Tensor:
    # the Python double 1/sqrt(D), rounded once to f32 (JAX's weak-typed
    # constant) and multiplied in, not divided
    return torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)


def chunk_attention_reference(q, k, v, mask=None):
    """Plain PyTorch version of the kernel (the einsum form), with the
    padded-Tk semantics of the TPU kernel."""
    D = q.shape[-1]
    tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * _scale(D).to(s.device)
    if mask is not None:
        s = torch.where(mask[None, None] != 0, s, NEG)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # each masked padding column of the TPU kernel adds exp(-1e30 - m):
    # 1 for a row with no unmasked key, 0 for any other row
    l = p.sum(-1) + ((-tk) % 8) * torch.exp(NEG - m)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def split_p(p):
    """``(p1, p2, p3)``, bf16 tensors with ``p1 + p2 + p3 == p`` exactly for
    f32 ``p`` in [2^-100, 1]: each term takes the next 8 significant bits
    (rounded to nearest), and each remainder is exact in f32."""
    p1 = p.to(torch.bfloat16)
    r = p - p1.float()
    p2 = r.to(torch.bfloat16)
    p3 = (r - p2.float()).to(torch.bfloat16)
    return p1, p2, p3


def chunk_attention_tc_emulation(q, k, v, mask=None, tile: int = 64):
    """The tensor-core route's arithmetic in plain PyTorch (used by the
    tests only): bf16 inputs, f32 products, an online max and sum over
    ``tile``-key tiles as the kernel runs them, and each tile's
    ``p1 v + p2 v + p3 v`` (the three bf16 terms of its p) folded into the
    rescaled ``o`` in f32."""
    B, tq, H, D = q.shape
    tk = k.shape[1]
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    scale = _scale(D).to(q.device)
    m = torch.full((B, H, tq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, tk, tile):
        ks = slice(k0, min(k0 + tile, tk))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, ks]) * scale
        if mask is not None:
            s = torch.where(mask[None, None, :, ks] != 0, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        vt = vf[:, ks].transpose(1, 2)  # (B, H, keys, D)
        p1, p2, p3 = (term.float() for term in split_p(p))
        o = o * corr[..., None] + ((p1 @ vt + p2 @ vt) + p3 @ vt)
        m = m_new
    l = l + ((-tk) % 8) * torch.exp(NEG - m)
    return o.transpose(1, 2), m, l


def _view_strides(t):
    """Element strides of a (B, T, H, D) view along b, t and h; a dimension
    of size 1 gets the stride it would have in a packed layout (any value
    is right for it, and TMA asks for multiples of 16 bytes)."""
    st = list(t.stride()[:3])
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = t.shape[i + 1] * (st[i + 1] if i < 2 else t.stride(3))
    return st


def tensor_core_route(q, k, v) -> bool:
    """Whether CUDA tensors take the tensor-core route: bf16 inputs, D a
    multiple of 16, and views TMA can read (every b/t/h stride a multiple
    of 8 elements, every base 16-byte aligned)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] % 16:
        return False
    return all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _view_strides(t))
        for t in (q, k, v)
    )


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("chunk_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.chunk_attention_launch.argtypes = [
            vp, vp, vp, i, vp, i, i, i, i, i, vp, ctypes.c_float, i,
            vp, vp, vp, vp,
        ]
        lib.chunk_attention_launch.restype = i
        lib.chunk_attention_launch_tc.argtypes = [
            vp, vp, vp, vp, i, i, i, i, i, vp, ctypes.c_float, i,
            vp, vp, vp, vp,
        ]
        lib.chunk_attention_launch_tc.restype = i
        lib.chunk_attention_error_string.argtypes = [i]
        lib.chunk_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d (B, T, H, D) torch.Tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and one device")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must have unit stride along D")
    B, tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(
            f"k and v must be (B, Tk, H, D) = ({B}, Tk, {H}, {D}), got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if k.shape[1] < 1:
        raise ValueError("Tk must be at least 1")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"head dimension D must be in [1, {MAX_D}], got {D}")
    if mask is not None:
        if not isinstance(mask, torch.Tensor) or mask.dtype not in _MASK_DTYPES:
            raise TypeError("mask must be a bool or uint8 torch.Tensor")
        if tuple(mask.shape) != (tq, k.shape[1]):
            raise ValueError(
                f"mask must have shape (Tq, Tk) = ({tq}, {k.shape[1]}), got "
                f"{tuple(mask.shape)}"
            )
        if mask.device != q.device:
            raise ValueError(f"mask is on {mask.device}, q on {q.device}")
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "chunk_attention has no backward kernel, as the TPU kernel has "
            "none (ROADMAP.md, B2); differentiate the 'torch' block path "
            "instead"
        )


def chunk_attention(q, k, v, mask=None):
    """``(o, m, l)``: ``o`` (B, Tq, H, D) f32 unnormalised, ``m`` and ``l``
    (B, H, Tq) f32.

    ``q``: (B, Tq, H, D); ``k``, ``v``: (B, Tk, H, D); f32 or bf16, one
    dtype, any strides with a unit stride along D (no copy is made);
    ``mask``: (Tq, Tk) contiguous bool or uint8 (nonzero = attend) or None.
    ``1 <= D <= 256``.  CPU tensors run the plain version; CUDA tensors
    launch the kernel by the route :func:`tensor_core_route` picks
    (counted in ``chunk_attention.launches``, and the tensor-core route
    also in ``chunk_attention.launches_tc``) or raise.
    """
    _check(q, k, v, mask)
    device = q.device
    if not on_cuda(device, "chunk_attention"):
        return chunk_attention_reference(q, k, v, mask)
    B, tq, H, D = q.shape
    tk = k.shape[1]
    if B * H > 65535:
        raise ValueError(f"B * H must be at most 65535, got {B * H}")
    o = torch.empty((B, tq, H, D), dtype=torch.float32, device=device)
    m = torch.empty((B, H, tq), dtype=torch.float32, device=device)
    l = torch.empty((B, H, tq), dtype=torch.float32, device=device)
    if tq == 0 or B == 0 or H == 0:
        return o, m, l
    lib = _library()
    tc = tensor_core_route(q, k, v)
    strides = (ctypes.c_longlong * 9)(
        *(s for t in (q, k, v) for s in _view_strides(t))
    )
    args = (
        None if mask is None else mask.data_ptr(), B, H, tq, tk, D,
        ctypes.cast(strides, ctypes.c_void_p), float(_scale(D)),
        (-tk) % 8, o.data_ptr(), m.data_ptr(), l.data_ptr(),
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if tc:
            rc = lib.chunk_attention_launch_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *args, stream)
        else:
            rc = lib.chunk_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPES[q.dtype],
                *args, stream)
    if rc != 0:
        msg = lib.chunk_attention_error_string(rc).decode()
        route = "tensor-core" if tc else "f32"
        raise RuntimeError(
            f"chunk_attention kernel launch failed ({route} route): {msg} ({rc})"
        )
    with _count_lock:
        chunk_attention.launches += 1
        chunk_attention.launches_tc += tc
    return o, m, l


chunk_attention.launches = 0  # every kernel launch, both routes
chunk_attention.launches_tc = 0  # the tensor-core route's launches

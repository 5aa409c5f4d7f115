"""Block attention with local softmax statistics, ``(o, m, l)``.

Counterpart of ``asyncframework_tpu/ops/pallas_kernels.py::chunk_attention``
(the Pallas TPU kernel, ``pallas_call`` at ``:155``).  On CUDA tensors
:func:`chunk_attention` launches the hand-written Hopper kernel in
``csrc/chunk_attention.cu`` (built by nvcc at first use, bound with
ctypes); on CPU tensors it runs :func:`chunk_attention_reference`, the
plain PyTorch version the tests and ``chip_smoke.py`` hold the kernel
against.  There is no fallback between the two: a CUDA tensor goes to the
kernel or raises.

Semantics (``pallas_kernels.py:127-227``), for each (batch, head):
``s = (q k^T) * scale`` with ``scale = f32(1/sqrt(D))`` multiplied in, set
to ``-1e30`` where ``mask == 0``; ``m = rowmax s``, ``p = exp(s - m)``,
``l = rowsum p``, ``o = p v`` unnormalised, all in f32 (q, k and v are
widened to f32 before the products).  The TPU kernel pads Tk to a multiple
of 8 with masked columns, so a row with no unmasked key comes back as
``m = -1e30``, ``o = sum_k v_k`` and ``l = Tk`` rounded up to 8; both
versions here return the same.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from asyncframework_tpu_torch.ops import _build

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
            "chunk_attention has no backward kernel (neither has the TPU "
            "kernel); differentiate the 'torch' block path instead "
            "(ROADMAP.md queue B: B2 backward)"
        )


def chunk_attention(q, k, v, mask=None):
    """``(o, m, l)``: ``o`` (B, Tq, H, D) f32 unnormalised, ``m`` and ``l``
    (B, H, Tq) f32.

    ``q``: (B, Tq, H, D); ``k``, ``v``: (B, Tk, H, D); f32 or bf16, one
    dtype, any strides with a unit stride along D (no copy is made);
    ``mask``: (Tq, Tk) contiguous bool or uint8 (nonzero = attend) or None.
    ``1 <= D <= 256``.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (counted in ``chunk_attention.launches``) or raise.
    """
    _check(q, k, v, mask)
    device = q.device
    if device.type == "cpu":
        return chunk_attention_reference(q, k, v, mask)
    if device.type != "cuda":
        raise ValueError(f"chunk_attention runs on cpu or cuda tensors, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("chunk_attention got a CUDA tensor but CUDA is unavailable")
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
    strides = (ctypes.c_longlong * 9)(
        *(t.stride(i) for t in (q, k, v) for i in range(3))
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.chunk_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPES[q.dtype],
            None if mask is None else mask.data_ptr(), B, H, tq, tk, D,
            ctypes.cast(strides, ctypes.c_void_p), float(_scale(D)),
            (-tk) % 8, o.data_ptr(), m.data_ptr(), l.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.chunk_attention_error_string(rc).decode()
        raise RuntimeError(f"chunk_attention kernel launch failed: {msg} ({rc})")
    with _count_lock:
        chunk_attention.launches += 1
    return o, m, l


chunk_attention.launches = 0

"""The ASGD worker step's contraction, ``g = X^T (mask * (f(X w) - y))``.

Counterpart of ``asyncframework_tpu/ops/pallas_kernels.py::fused_masked_grad``
(the Pallas TPU kernel, ``pallas_call`` at ``:58``).  On a CUDA tensor
:func:`masked_grad` launches the hand-written Hopper kernel in
``csrc/masked_grad.cu`` (built by nvcc at first use, bound with ctypes); on
CPU tensors it runs :func:`masked_grad_reference`, the plain PyTorch
version the tests and ``chip_smoke.py`` hold the kernel against.  There is
no fallback between the two: a CUDA tensor goes to the kernel or raises.

Semantics (``asyncframework_tpu/ops/gradients.py:32-88``):

- ``f`` is the identity (``loss="least_squares"``) or the sigmoid
  (``loss="logistic"``);
- ``mask`` (f32, optional) weights each summed row;
- with ``idx`` (int64, optional) row ``i`` of the sum is ``X[idx[i]]`` /
  ``y[idx[i]]`` and ``mask`` is indexed by slot ``i`` -- the compacted
  worker step without a gathered copy of ``X``;
- for bf16 ``X`` (the ``mm_f32`` contract) ``w`` is rounded to bf16 before
  the first product and ``mask * (f - y)`` before the ``X^T`` product, and
  both products accumulate in f32.

The same kernel has two ASAGA forms, full shard only, each with its plain
version here, each counted in ``masked_grad.launches`` and in its own
``launches``:

- :func:`saga_grad` -- ``(g, diff)`` with ``diff_i = x_i.w - y_i`` for every
  row and ``g = X^T (mask * (diff - alpha))`` (``gradients.py:99-123``), in
  one pass over ``X``; bf16 rounding as above;
- :func:`xt_coeff` -- ``X^T c`` (the table delta of ``steps.py:218-237``).
  The JAX package writes it as a plain ``X.T @ c``, where a bf16 ``X`` is
  promoted to f32, so ``c`` is *not* rounded to bf16 here either.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from asyncframework_tpu_torch.ops import _build

LOSSES = {"least_squares": 0, "logistic": 1}
_SAGA, _XT_COEFF = 2, 3  # the kernel's other modes
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16

_count_lock = threading.Lock()
_lib = None


def masked_grad_reference(X, y, w, mask=None, idx=None,
                          loss: str = "least_squares"):
    """Plain PyTorch version of the kernel, with the same casts."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    if idx is not None:
        X = X[idx]
        y = y[idx]
    Xf = X.float()
    z = Xf @ w.to(X.dtype).float()
    r = (torch.sigmoid(z) if loss == "logistic" else z) - y
    if mask is not None:
        r = mask * r
    return Xf.T @ r.to(X.dtype).float()


def saga_grad_reference(X, y, w, alpha, mask=None):
    """Plain PyTorch version of :func:`saga_grad`, with the same casts."""
    Xf = X.float()
    diff = Xf @ w.to(X.dtype).float() - y
    c = diff - alpha
    if mask is not None:
        c = mask * c
    return Xf.T @ c.to(X.dtype).float(), diff


def xt_coeff_reference(X, c):
    """Plain PyTorch version of :func:`xt_coeff`: ``X`` promoted to f32."""
    return X.float().T @ c


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("masked_grad")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.masked_grad_launch.argtypes = [
            vp, i, ll, ll, vp, vp, vp, vp, ll, i, vp, vp, i, vp, i, vp, vp,
        ]
        lib.masked_grad_launch.restype = i
        lib.masked_grad_tile_rows.argtypes = []
        lib.masked_grad_tile_rows.restype = i
        lib.masked_grad_error_string.argtypes = [i]
        lib.masked_grad_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % _VEC_BYTES == 0 for t in ts)


def _check_X(X):
    if not isinstance(X, torch.Tensor) or X.dim() != 2:
        raise ValueError("X must be a 2-d torch.Tensor")
    if X.dtype not in _X_DTYPES:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous (row-major)")
    return X.device, X.shape[0], X.shape[1]


def _on_cuda(device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (plain version); raises for anything else."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"masked_grad runs on cpu or cuda tensors, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("masked_grad got a CUDA tensor but CUDA is unavailable")
    return True


def _launch(X, y, w, mask, idx, m, mode, alpha=None, diff=None, form=None):
    """Enqueue one form of the kernel on the current stream; returns g.
    Counted in ``masked_grad.launches`` and in the launching ``form``'s own
    count."""
    device = X.device
    n, d = X.shape
    lib = _library()
    tile = lib.masked_grad_tile_rows()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nblocks = min(-(-m // tile), 2 * sms)
    vec = 8 if X.dtype == torch.bfloat16 else 4
    use_vec = d % vec == 0 and _aligned(*(t for t in (X, w) if t is not None))
    partial = torch.empty((nblocks, d), dtype=torch.float32, device=device)
    g = torch.empty(d, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.masked_grad_launch(
        ptr(X), _X_DTYPES[X.dtype], n, d, ptr(y), ptr(w), ptr(mask), ptr(idx),
        m, mode, ptr(alpha), ptr(diff), int(use_vec), ptr(partial), nblocks,
        ptr(g), stream,
    )
    if rc != 0:
        msg = lib.masked_grad_error_string(rc).decode()
        raise RuntimeError(f"masked_grad kernel launch failed: {msg} ({rc})")
    with _count_lock:
        masked_grad.launches += 1
        if form is not None:
            form.launches += 1
    return g


def masked_grad(X, y, w, mask=None, idx=None, loss: str = "least_squares"):
    """``g = X^T (mask * (f(X w) - y))`` as an f32 ``(d,)`` tensor.

    ``X``: ``(n, d)`` contiguous f32 or bf16; ``y``: ``(n,)`` f32; ``w``:
    ``(d,)`` f32; ``mask``: ``(m,)`` f32 or None; ``idx``: ``(m,)`` int64 or
    None (then ``m = n``).  Any ``n`` and ``d`` work, ``n = 0`` and an empty
    ``idx`` included (``g = 0``).  An ``idx`` entry outside ``[0, n)``
    contributes nothing.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (counted in ``masked_grad.launches``) or raise.
    """
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    device, n, d = _check_X(X)
    m = n if idx is None else idx.shape[0]
    _check("y", y, torch.float32, (n,), device)
    _check("w", w, torch.float32, (d,), device)
    if idx is not None:
        _check("idx", idx, torch.int64, (m,), device)
    if mask is not None:
        _check("mask", mask, torch.float32, (m,), device)
    if not _on_cuda(device):
        return masked_grad_reference(X, y, w, mask, idx, loss)
    if d == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return _launch(X, y, w, mask, idx, m, LOSSES[loss])


def saga_grad(X, y, w, alpha, mask=None):
    """ASAGA's worker contraction over the full shard: ``(g, diff)`` with
    ``diff = X w - y`` (every row; the candidate history scalars) and
    ``g = X^T (mask * (diff - alpha))``, both f32.

    ``X``: ``(n, d)`` contiguous f32 or bf16; ``y``, ``alpha``: ``(n,)``
    f32; ``w``: ``(d,)`` f32; ``mask``: ``(n,)`` f32 or None (all ones).
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``masked_grad.launches`` and ``saga_grad.launches``) or
    raise.
    """
    device, n, d = _check_X(X)
    _check("y", y, torch.float32, (n,), device)
    _check("w", w, torch.float32, (d,), device)
    _check("alpha", alpha, torch.float32, (n,), device)
    if mask is not None:
        _check("mask", mask, torch.float32, (n,), device)
    if not _on_cuda(device):
        return saga_grad_reference(X, y, w, alpha, mask)
    if d == 0:
        return torch.zeros(0, dtype=torch.float32, device=device), -y
    diff = torch.empty(n, dtype=torch.float32, device=device)
    g = _launch(X, y, w, mask, None, n, _SAGA, alpha, diff, form=saga_grad)
    return g, diff


def xt_coeff(X, c):
    """``X^T c`` as an f32 ``(d,)`` tensor, ``c`` an f32 ``(n,)`` tensor
    (not rounded to bf16 for a bf16 ``X``).  CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in
    ``masked_grad.launches`` and ``xt_coeff.launches``) or raise."""
    device, n, d = _check_X(X)
    _check("c", c, torch.float32, (n,), device)
    if not _on_cuda(device):
        return xt_coeff_reference(X, c)
    if d == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return _launch(X, None, None, c, None, n, _XT_COEFF, form=xt_coeff)


masked_grad.launches = 0
saga_grad.launches = 0
xt_coeff.launches = 0

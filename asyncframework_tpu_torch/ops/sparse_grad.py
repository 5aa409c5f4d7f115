"""The sparse (padded-ELL) worker step's kernel, S1: a gather residual and a
deterministic segment sum.

The JAX package computes this step in XLA, not Pallas: ``sparse_residual``
(``asyncframework_tpu/ops/gradients.py:131``) and the sorted scatter-add of
``make_sparse_grad_sum`` (``:138``).  On a CUDA tensor each function here
launches its hand-written Hopper kernel in ``csrc/sparse_grad.cu`` (built by
nvcc at first use, bound with ctypes); on CPU tensors it runs its plain
PyTorch version, which the tests and ``chip_smoke.py`` hold the kernel
against.  There is no fallback between the two: a CUDA tensor goes to the
kernel or raises.

- :func:`ell_residual` -- ``r_j = sum_k (vals[row_j, k] * valid_j) *
  w[cols[row_j, k]] - y[row_j] * valid_j`` with ``row_j = idx[j]`` (or
  ``j``), one warp a row, reading the sampled rows straight from the shard.
  Lane ``l`` sums ``k = l, l + 32, ...`` in turn, then a shuffle tree adds
  the lanes; :func:`ell_residual_plain` takes the same order, so the two
  are bit-equal.  With ``with_keys`` it also returns the segment sum's
  flat sort keys: the column of each entry whose value (times ``valid``)
  is nonzero, else ``d``.
- :func:`segment_sum` -- ``g[c] = sum of coeff_j * (vals[row_j, k] *
  valid_j)`` over the entries keyed ``c``, taken after a stable sort of the
  keys (:func:`sort_keys`), added one at a time in sorted order, which is
  the flat order within a column, as the reference's stable argsort adds
  them.  Entries keyed ``d`` (ELL padding, unfilled slots, zero values)
  are left out: each would add ``+-0`` to a sum that is never ``-0``
  (for a finite coefficient), so leaving it out changes no bit.
  :func:`segment_sum_plain` is ``torch.zeros(d).index_add_`` over the live
  entries in sorted order: on the CPU it adds in that order too and equals
  the kernel bit for bit; on the card ``index_add_`` sums with atomics, in
  an order that changes from launch to launch.

Each kernel launch counts in its function's ``launches``; each call of a
plain version counts in its ``calls``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from asyncframework_tpu_torch.ops import _build
from asyncframework_tpu_torch.ops._checks import check_tensor, on_cuda

WARP = 32  # lanes of a row in ell_residual (csrc/sparse_grad.cu: kWarp)

_count_lock = threading.Lock()
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("sparse_grad")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ell_residual_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, ll, i, i, vp, vp, vp,
        ]
        lib.ell_residual_launch.restype = i
        lib.segment_sum_launch.argtypes = [
            vp, ll, vp, vp, vp, vp, vp, i, i, vp, vp, vp,
        ]
        lib.segment_sum_launch.restype = i
        lib.sparse_grad_error_string.argtypes = [i]
        lib.sparse_grad_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check_rows(vals, idx, valid):
    """``(device, n, K, m)`` of a padded-ELL ``vals`` and its slots."""
    if not isinstance(vals, torch.Tensor) or vals.dim() != 2:
        raise ValueError("vals must be a 2-d torch.Tensor")
    device = vals.device
    n, K = vals.shape
    check_tensor("vals", vals, torch.float32, (n, K), device)
    m = n if idx is None else idx.shape[0]
    if idx is not None:
        check_tensor("idx", idx, torch.int64, (m,), device)
    if valid is not None:
        check_tensor("valid", valid, torch.float32, (m,), device)
    return device, n, K, m


def _raise(lib, rc, name):
    if rc != 0:
        msg = lib.sparse_grad_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ plain versions
def ell_residual_plain(cols, vals, y, w, idx=None, valid=None,
                       with_keys: bool = False):
    """Plain PyTorch version of :func:`ell_residual`, in the kernel's order
    of additions (so the two are bit-equal on the same inputs)."""
    with _count_lock:
        ell_residual_plain.calls += 1
    d = w.shape[0]
    if idx is not None:
        cols, vals, y = cols[idx], vals[idx], y[idx]
    if valid is not None:
        vals = vals * valid[:, None]
        y = y * valid
    prod = vals * w[cols.long()]
    m, K = prod.shape
    prod = torch.nn.functional.pad(prod, (0, (-K) % WARP))
    lanes = torch.zeros(m, WARP, dtype=torch.float32, device=vals.device)
    for t in range(0, prod.shape[1], WARP):   # lane l sums k = l, l + 32, ...
        lanes = lanes + prod[:, t:t + WARP]
    off = WARP // 2
    while off:                                # lane l += lane l + off
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
        off //= 2
    r = lanes[:, 0] - y
    if not with_keys:
        return r
    keys = torch.where(vals != 0, cols, torch.full_like(cols, d))
    return r, keys.reshape(-1).to(torch.int32)


def segment_sum_plain(keys, perm, vals, coeff, d: int, idx=None, valid=None):
    """Plain PyTorch version of :func:`segment_sum`: the live entries'
    products ``coeff_j * (vals * valid_j)`` added into zeros with
    ``index_add_`` in sorted order (on the CPU one at a time, in order)."""
    with _count_lock:
        segment_sum_plain.calls += 1
    rows = vals if idx is None else vals[idx]
    if valid is not None:
        rows = rows * valid[:, None]
    contrib = (rows * coeff[:, None]).reshape(-1)
    live = keys < d
    g = torch.zeros(d, dtype=torch.float32, device=vals.device)
    return g.index_add_(0, keys[live].long(), contrib[perm[live]])


# ------------------------------------------------------------------ kernels
def ell_residual(cols, vals, y, w, idx=None, valid=None,
                 with_keys: bool = False):
    """``r (m,)`` f32 (and, ``with_keys``, the flat ``(m*K,)`` int32 sort
    keys) for the padded-ELL rows ``cols``/``vals`` (``(n, K)``, int32 in
    ``[0, d)`` / f32), labels ``y (n,)``, model ``w (d,)``, slots ``idx``
    (``(m,)`` int64 in ``[0, n)``, or None for every row) and slot weights
    ``valid`` (``(m,)`` f32 or None).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (counted in ``ell_residual.launches``)
    or raise."""
    device, n, K, m = _check_rows(vals, idx, valid)
    check_tensor("cols", cols, torch.int32, (n, K), device)
    check_tensor("y", y, torch.float32, (n,), device)
    if not isinstance(w, torch.Tensor) or w.dim() != 1:
        raise ValueError("w must be a 1-d torch.Tensor")
    d = w.shape[0]
    check_tensor("w", w, torch.float32, (d,), device)
    if not on_cuda(device, "sparse_grad"):
        return ell_residual_plain(cols, vals, y, w, idx, valid, with_keys)
    r = torch.empty(m, dtype=torch.float32, device=device)
    keys = (torch.empty(m * K, dtype=torch.int32, device=device)
            if with_keys else None)
    if m == 0:
        return (r, keys) if with_keys else r
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.ell_residual_launch(
        _ptr(cols), _ptr(vals), _ptr(y), _ptr(w), _ptr(idx), _ptr(valid),
        m, K, d, _ptr(r), _ptr(keys), stream,
    )
    _raise(lib, rc, "ell_residual")
    _count(ell_residual)
    return (r, keys) if with_keys else r


def sort_keys(keys):
    """``(sorted keys, perm)``: the stable sort the segment sum takes its
    order from (a pre-pass, ``torch.sort``)."""
    return torch.sort(keys, stable=True)


def segment_sum(keys, perm, vals, coeff, d: int, idx=None, valid=None):
    """``g (d,)`` f32, ``g[c]`` the in-order sum of ``coeff_j * (vals[row_j,
    k] * valid_j)`` over the entries keyed ``c``.

    ``keys`` (``(m*K,)`` int32, ascending, in ``[0, d]``; ``d`` marks an
    entry left out) and ``perm`` (``(m*K,)`` int64, each entry's flat id
    ``j*K + k``) come from :func:`sort_keys`; ``vals`` is ``(n, K)`` f32
    read through ``idx`` (``(m,)`` int64, or None: ``m = n``);
    ``coeff`` ``(m,)`` f32; ``valid`` ``(m,)`` f32 or None.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (counted in
    ``segment_sum.launches``) or raise."""
    device, n, K, m = _check_rows(vals, idx, valid)
    check_tensor("keys", keys, torch.int32, (m * K,), device)
    check_tensor("perm", perm, torch.int64, (m * K,), device)
    check_tensor("coeff", coeff, torch.float32, (m,), device)
    d = int(d)
    if d < 0:
        raise ValueError(f"d must be >= 0, got {d}")
    if not on_cuda(device, "sparse_grad"):
        return segment_sum_plain(keys, perm, vals, coeff, d, idx, valid)
    g = torch.empty(d, dtype=torch.float32, device=device)
    if d == 0:
        return g
    ends = torch.empty(d, dtype=torch.int64, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.segment_sum_launch(
        _ptr(keys), m * K, _ptr(perm), _ptr(vals), _ptr(idx), _ptr(valid),
        _ptr(coeff), K, d, _ptr(ends), _ptr(g), stream,
    )
    _raise(lib, rc, "segment_sum")
    _count(segment_sum)
    return g


ell_residual.launches = 0
segment_sum.launches = 0
ell_residual_plain.calls = 0
segment_sum_plain.calls = 0

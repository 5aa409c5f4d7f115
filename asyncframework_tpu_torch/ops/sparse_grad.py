"""The sparse (padded-ELL) worker step's kernel, S1: the residual, a stable
sort of the entries by column and a deterministic segment sum, in one
launch.

The JAX package computes this step in XLA, not Pallas: ``sparse_residual``
(``asyncframework_tpu/ops/gradients.py:131``) and the sorted scatter-add of
``make_sparse_grad_sum`` (``:138``).  On a CUDA tensor each function here
launches its hand-written Hopper kernel in ``csrc/sparse_grad.cu`` (built by
nvcc at first use, bound with ctypes); on CPU tensors it runs its plain
PyTorch version, which the tests and ``chip_smoke.py`` hold the kernel
against.  There is no fallback between the two: a CUDA tensor goes to the
kernel or raises.

- :func:`compacted_grad` -- the whole task: ``r_j = sum_k (vals[row_j, k] *
  valid_j) * w[cols[row_j, k]] - y[row_j] * valid_j`` (``row_j = idx[j]``
  or ``j``) and ``g[c] = sum of coeff_j * (vals[row_j, k] * valid_j)`` over
  the entries of column ``c`` in flat order, ``coeff_j = r_j`` or ``r_j -
  alpha[row_j]``; :func:`grad_sum` is the same sum for a given ``coeff``;
  :func:`saga_slots_grad` the DCN ASAGA worker's task, ``coeff_j = r_j -
  alpha[j]`` with ``alpha`` indexed by slot.
  One cooperative launch (``sparse_task_kernel``): the residual, a stable
  radix sort by column, and the segment sums, with no sort or memset
  launch.  The kernel picks one of two routes from the data, the same on
  every block: where no top-digit bucket of live entries is longer than
  4,096 (nor than ``L``) and the keys have at most two 8-bit digits, the
  *local* route sorts once by the top digit and then each bucket in
  shared memory by its low digit, summing each column there (three grid
  barriers); else the *global* route runs a stable LSD sort over the
  digits the keys ``[0, d]`` need (:func:`launch_plan`) and sums the
  columns from the sorted array, long ones in chunks (six barriers at two
  digits).  A column of at most ``L = plan.chunk`` entries is added one
  product at a time from ``0.0`` in flat order, which is the reference's
  sorted scatter bit for bit; a longer column is cut into chunks of ``L``,
  each added in order, and the chunk sums are added in chunk order
  (:func:`grad_sum_plain` takes the same order).  That is the one place
  where the kernel's order differs from one serial chain.
- :func:`ell_residual` -- the residual alone, one warp a row (the
  evaluation's launch).  Lane ``l`` sums ``k = l, l + 32, ...`` in turn,
  then a shuffle tree adds the lanes; :func:`ell_residual_plain` takes the
  same order, so the two are bit-equal, and the fused kernel's residual is
  the same.  With ``with_keys`` it also returns the flat sort keys: the
  column of each entry whose value (times ``valid``) is nonzero, else ``d``.
- :func:`sort_keys` (``torch.sort``) and :func:`segment_sum` -- the earlier
  three-launch chain after ``ell_residual(with_keys=True)``, kept callable
  for timing against the fused design; not on the solvers' path.
  :func:`segment_sum_plain` is ``torch.zeros(d).index_add_`` over the live
  entries in sorted order: one serial chain a column.

Entries keyed ``d`` (ELL padding, unfilled slots, zero values) are left out
of every sum: each would add ``+-0`` to a sum that is never ``-0`` (for a
finite coefficient), so leaving it out changes no bit.

Each kernel launch counts in its function's ``launches``; each call of a
plain version counts in its ``calls``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from asyncframework_tpu_torch.ops import _build
from asyncframework_tpu_torch.ops._checks import check_tensor, on_cuda

WARP = 32  # lanes of a row in ell_residual (csrc/sparse_grad.cu: kWarp)

# the fused kernel's geometry (csrc/sparse_grad.cu, namespace task)
DIGIT_BITS = 8          # radix of a sort pass (kDigits = 256)
CHUNK = 4096            # L: the longest column one warp adds in one chain
SHORT_MAX = 16          # the longest column one thread adds (kShortMax)
COL_TILE = 1024         # columns a tile of the count scan (kColTile)
MAX_COL_TILES = 4096    # so d <= 4,194,304 (kMaxColTiles)
VEC_BYTES = 16
STAMPS = 32             # phase boundaries a block may stamp (kStamps)
ROUTE_STAMP = 23        # stamp 23 holds 1 where the local route ran

_count_lock = threading.Lock()
_lib = None
_plan_lock = threading.Lock()
_pinned: dict = {}
# (device, stream) -> the fused kernel's zeroed scratch (uint8): each launch
# leaves it zero, so launches on one stream (which never overlap) share it
_zeroed: dict = {}
_timeline = None        # (blocks, STAMPS) int64 for record_timeline


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
        lp = ctypes.POINTER(ll)
        lib.sparse_task_workspace.argtypes = [ll, i, i, i, i, ll, lp, lp]
        lib.sparse_task_workspace.restype = i
        lib.sparse_task_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i, ll, i, i, i, i, i, i, i, i, ll,
            i, vp, vp, vp, vp, vp, vp,
        ]
        lib.sparse_task_launch.restype = i
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


# ---------------------------------------------------------------- the plan
class LaunchPlan(NamedTuple):
    """One launch of the fused kernel."""

    passes: int     # 8-bit digits of the keys [0, d] the sort takes
    wide: bool      # 64-bit entry positions (m * K >= 2^31)
    vec: bool       # rows read as 16-byte vectors (K % 4 == 0, aligned)
    chunk: int      # L: a column longer than this is summed in chunks
    max_items: int  # bound on the chunks of columns longer than SHORT_MAX
    route: str      # "auto": the kernel picks from the data; "global"


def launch_plan(m: int, K: int, d: int, aligned: bool = True) -> LaunchPlan:
    """The fused kernel's launch over ``m`` slots of ``K`` entries into
    ``d`` columns: as many sort passes as the keys ``[0, d]`` have 8-bit
    digits (``ceil(log2(d + 1) / 8)``, at least 1: 2 at rcv1's 47,236),
    64-bit positions only where ``m * K >= 2^31``, 16-byte row loads where
    ``K % 4 == 0`` and the rows are ``aligned``, and ``L =`` :data:`CHUNK`.
    The kernel itself picks its route from the data (see the module
    docstring); :func:`pinned_plan` overrides ``wide``, ``chunk`` and
    ``route`` (tests, timing)."""
    if d < 0 or K < 0 or m < 0:
        raise ValueError(f"negative shape: m={m}, K={K}, d={d}")
    if -(-d // COL_TILE) > MAX_COL_TILES:
        raise ValueError(f"d = {d} is above the kernel's "
                         f"{COL_TILE * MAX_COL_TILES} columns")
    n = m * K
    passes = max(1, -(-d.bit_length() // DIGIT_BITS))
    vec = K % (VEC_BYTES // 4) == 0 and aligned
    with _plan_lock:
        wide = _pinned.get("wide", n >= 2 ** 31)
        chunk = _pinned.get("chunk", CHUNK)
        route = _pinned.get("route", "auto")
    if route not in ("auto", "global"):
        raise ValueError(f"unknown route {route!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    # columns longer than min(SHORT_MAX, chunk), each cut into
    # ceil(count / chunk) items
    longer = min(SHORT_MAX, chunk) + 1
    max_items = min(d, n // longer) + n // chunk + 1
    return LaunchPlan(passes, wide, vec, chunk, max_items, route)


@contextlib.contextmanager
def pinned_plan(**fields):
    """Launch with these :class:`LaunchPlan` fields inside the block, on the
    card and in the plain versions alike: a small ``chunk`` runs the
    chunked order at small shapes, ``wide=True`` the 64-bit positions,
    ``route="global"`` the global route where the local one would run.
    For tests and timing; not for the solvers."""
    unknown = set(fields) - {"wide", "chunk", "route"}
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}")
    with _plan_lock:
        before = dict(_pinned)
        _pinned.update(fields)
    try:
        yield
    finally:
        with _plan_lock:
            _pinned.clear()
            _pinned.update(before)


@contextlib.contextmanager
def record_timeline(stamps):
    """Fused launches inside the block write each block's ``%globaltimer``
    (ns) at every phase boundary into ``stamps`` (a ``(blocks, STAMPS)``
    int64 CUDA tensor; ``tools/probe_sparse_grad.py``).  Not thread-safe;
    the solvers never use it."""
    global _timeline
    before, _timeline = _timeline, stamps
    try:
        yield
    finally:
        _timeline = before


# ------------------------------------------------------------ plain versions
def ell_residual_plain(cols, vals, y, w, idx=None, valid=None,
                       with_keys: bool = False):
    """Plain PyTorch version of :func:`ell_residual`, in the kernel's order
    of additions (so the two are bit-equal on the same inputs)."""
    with _count_lock:
        ell_residual_plain.calls += 1
    return _residual(cols, vals, y, w, idx, valid, with_keys)


def _residual(cols, vals, y, w, idx, valid, with_keys):
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


def grad_sum_plain(cols, vals, coeff, d: int, idx=None, valid=None,
                   chunk: int = CHUNK):
    """Plain PyTorch version of :func:`grad_sum`, in the kernel's order: the
    live entries' products ``coeff_j * (vals * valid_j)`` sorted by column
    (stable), each column added from 0 in that order (``index_add_`` on the
    CPU adds one at a time, in order); a column longer than ``chunk`` is
    added a chunk of ``chunk`` entries at a time, then the chunk sums in
    chunk order."""
    with _count_lock:
        grad_sum_plain.calls += 1
    return _grad_sum(cols, vals, coeff, d, idx, valid, chunk)


def _grad_sum(cols, vals, coeff, d, idx, valid, chunk):
    if idx is not None:
        cols, vals = cols[idx], vals[idx]
    if valid is not None:
        vals = vals * valid[:, None]
    contrib = (vals * coeff[:, None]).reshape(-1)
    live = (vals != 0).reshape(-1)
    keys, perm = torch.sort(cols.reshape(-1)[live].long(), stable=True)
    prods = contrib[live][perm]
    g = torch.zeros(d, dtype=torch.float32, device=vals.device)
    counts = torch.bincount(keys, minlength=d)
    if keys.numel() == 0 or int(counts.max()) <= chunk:
        return g.index_add_(0, keys, prods)
    starts = torch.cumsum(counts, 0) - counts
    chunks = (counts + chunk - 1) // chunk
    first = torch.cumsum(chunks, 0) - chunks
    pos = torch.arange(keys.numel(), device=keys.device) - starts[keys]
    seg = first[keys] + torch.div(pos, chunk, rounding_mode="floor")
    total = int(chunks.sum())
    partial = torch.zeros(total, dtype=torch.float32, device=vals.device)
    partial.index_add_(0, seg, prods)
    owner = torch.repeat_interleave(
        torch.arange(d, device=keys.device), chunks)
    return g.index_add_(0, owner, partial)


def compacted_grad_plain(cols, vals, y, w, idx=None, valid=None, d=None,
                         alpha=None, chunk: int = CHUNK, alpha_slots=False):
    """Plain PyTorch version of :func:`compacted_grad` (and, with
    ``alpha_slots``, of :func:`saga_slots_grad`): ``(g, r)`` from
    :func:`ell_residual_plain` (the kernel's lane order) and
    :func:`grad_sum_plain` (its column order)."""
    with _count_lock:
        compacted_grad_plain.calls += 1
    d = w.shape[0] if d is None else d
    r = _residual(cols, vals, y, w, idx, valid, False)
    coeff = r
    if alpha is not None:
        coeff = r - (alpha if idx is None or alpha_slots else alpha[idx])
    return _grad_sum(cols, vals, coeff, d, idx, valid, chunk), r


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


def _workspace(lib, device, stream, plan, m, K, d, blocks):
    """The launch's scratch: a fresh uint8 buffer (written before it is
    read) and the stream's zeroed one, grown as needed."""
    wbytes, zbytes = _workspace_bytes(lib, m, K, d, blocks, plan.wide,
                                      plan.max_items)
    ws = torch.empty(max(wbytes, 16), dtype=torch.uint8, device=device)
    key = (device, stream)
    with _count_lock:
        zws = _zeroed.get(key)
        if zws is None or zws.numel() < zbytes:
            zws = torch.zeros(max(zbytes, 1 << 16), dtype=torch.uint8,
                              device=device)
            _zeroed[key] = zws
    return ws, zws


@functools.lru_cache(maxsize=256)
def _workspace_bytes(lib, m, K, d, blocks, wide, max_items):
    wb, zb = ctypes.c_longlong(0), ctypes.c_longlong(0)
    lib.sparse_task_workspace(m, K, d, blocks, int(wide), max_items,
                              ctypes.byref(wb), ctypes.byref(zb))
    return wb.value, zb.value


def _task(cols, vals, y, w, idx, valid, coeff, alpha, d, form,
          alpha_slots=False):
    """Enqueue one fused launch on the current stream; returns ``(g, r)``
    (``r`` None in the coefficient form).  Counted in ``form.launches``."""
    device, n, K, m = _check_rows(vals, idx, valid)
    check_tensor("cols", cols, torch.int32, (n, K), device)
    if coeff is None:
        check_tensor("y", y, torch.float32, (n,), device)
        if not isinstance(w, torch.Tensor) or w.dim() != 1:
            raise ValueError("w must be a 1-d torch.Tensor")
        d = w.shape[0]
        check_tensor("w", w, torch.float32, (d,), device)
        if alpha is not None:
            check_tensor("alpha", alpha, torch.float32,
                         (m if alpha_slots else n,), device)
    else:
        check_tensor("coeff", coeff, torch.float32, (m,), device)
    d = int(d)
    aligned = cols.data_ptr() % VEC_BYTES == 0 and vals.data_ptr() % VEC_BYTES == 0
    plan = launch_plan(m, K, d, aligned)
    if not on_cuda(device, "sparse_grad"):
        if coeff is None:
            return compacted_grad_plain(cols, vals, y, w, idx, valid, d, alpha,
                                        plan.chunk, alpha_slots)
        return grad_sum_plain(cols, vals, coeff, d, idx, valid,
                              plan.chunk), None
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    # one block an SM: a cooperative launch needs every block resident
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    g = torch.empty(d, dtype=torch.float32, device=device)
    r = (torch.empty(m, dtype=torch.float32, device=device)
         if coeff is None else None)
    ws, zws = _workspace(lib, device, stream, plan, m, K, d, blocks)
    rc = lib.sparse_task_launch(
        _ptr(cols), _ptr(vals), _ptr(y), _ptr(w), _ptr(idx), _ptr(valid),
        _ptr(coeff), _ptr(alpha), int(alpha_slots), m, K, d, plan.passes,
        plan.chunk,
        int(plan.vec), int(plan.wide), int(coeff is None),
        int(plan.route == "global"), plan.max_items,
        blocks, _ptr(r), _ptr(g), _ptr(ws), _ptr(zws), _ptr(_timeline),
        stream,
    )
    if rc != 0:
        with _count_lock:  # a failed launch may leave its scratch dirty
            _zeroed.pop((device, stream), None)
    _raise(lib, rc, "sparse_task")
    _count(form)
    return g, r


def compacted_grad(cols, vals, y, w, idx=None, valid=None, d=None,
                   alpha=None):
    """``(g (d,), r (m,))`` f32 for one sparse task, in one launch: the
    residual ``r`` of the slots (as :func:`ell_residual`) and ``g = sum_j
    coeff_j x_{row_j}`` with ``coeff_j = r_j``, or ``r_j - alpha[row_j]``
    when ``alpha`` (``(n,)`` f32: ASAGA's history slice) is given.

    ``cols``/``vals``: ``(n, K)`` int32 in ``[0, d)`` / f32; ``y (n,)``;
    ``w (d,)``; ``idx``: ``(m,)`` int64 in ``[0, n)`` or None (every row);
    ``valid``: ``(m,)`` f32 or None; ``d`` defaults to ``w``'s length.  A
    column of at most ``L`` entries is summed in flat order, one longer in
    chunks of ``L`` (:func:`launch_plan`).  CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in
    ``compacted_grad.launches``) or raise."""
    if d is not None and isinstance(w, torch.Tensor) and int(d) != w.shape[0]:
        raise ValueError(f"d = {d} but w has {w.shape[0]} entries")
    return _task(cols, vals, y, w, idx, valid, None, alpha, d, compacted_grad)


def saga_slots_grad(cols, vals, y, w, idx, valid, alpha):
    """The DCN ASAGA worker's sparse task (``steps.py:883-908`` of the JAX
    package), in one launch: ``(g (d,), diff (m,))`` f32 with ``diff`` the
    slots' residuals as :func:`compacted_grad` takes them and ``g = sum_j
    (diff_j - alpha_j) (x_{idx_j} * valid_j)``, where ``alpha`` (``(m,)``
    f32, the sampled rows' history scalars shipped by the parameter
    server) is indexed by slot ``j``, not by row.  A slot with ``valid_j``
    0 has ``diff_j`` 0 and adds nothing.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (counted in
    ``saga_slots_grad.launches``) or raise."""
    if idx is None or valid is None:
        raise ValueError("saga_slots_grad takes the slots' idx and valid")
    return _task(cols, vals, y, w, idx, valid, None, alpha, None,
                 saga_slots_grad, alpha_slots=True)


def grad_sum(cols, vals, coeff, d: int, idx=None, valid=None):
    """``g (d,)`` f32, ``g[c]`` the sum of ``coeff_j * (vals[row_j, k] *
    valid_j)`` over the entries of column ``c``, in :func:`compacted_grad`'s
    order, for a given ``coeff`` (``(m,)`` f32).  One launch of the same
    kernel without its residual; counted in ``grad_sum.launches``."""
    if int(d) < 0:
        raise ValueError(f"d must be >= 0, got {d}")
    return _task(cols, vals, None, None, idx, valid, coeff, None, d,
                 grad_sum)[0]


ell_residual.launches = 0
segment_sum.launches = 0
ell_residual_plain.calls = 0
segment_sum_plain.calls = 0
compacted_grad.launches = 0
grad_sum.launches = 0
saga_slots_grad.launches = 0
compacted_grad_plain.calls = 0
grad_sum_plain.calls = 0

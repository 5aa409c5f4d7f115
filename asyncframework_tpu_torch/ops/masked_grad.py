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

The kernel has two routes, chosen by shape and dtype alone in
:func:`launch_plan` (never by a failed launch):

- ``staged`` -- one cooperative launch of one persistent block an SM; a
  producer warp stages rows in shared memory with bulk copies, chunk by
  chunk, and 16 consumer warps fold them from registers.  It takes rows of
  a multiple of 16 bytes at a 16-byte-aligned ``X`` and ``w`` with at most
  :data:`CONSUMERS` column lanes (``d <= 2048`` f32, ``4096`` bf16) and at
  least :data:`STAGED_MIN_BYTES` of X in the slots, every form alike;
- ``tiled`` -- the two-launch design of 16-row tiles, for every other
  launch.

Both read each row of X from HBM once, and both are bit-equal from launch
to launch; the two routes sum in different orders.

Each launch counts in ``masked_grad.launches`` (the total, every form) and
in ``masked_grad.launches_staged`` or ``masked_grad.launches_tiled``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from asyncframework_tpu_torch.ops import _build

LOSSES = {"least_squares": 0, "logistic": 1}
_SAGA, _XT_COEFF = 2, 3  # the kernel's other modes
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16

# the kernel's geometry (csrc/masked_grad.cu)
TILE_ROWS = 16                   # tiled route: rows of a tile (kTileRows)
CONSUMERS = 512                  # staged route: consumer threads (kConsumers)
MAX_STAGE_ROWS = 32              # rows of a ring stage (kMaxStageRows)
MAX_GROUP_ROWS = 8               # rows a group takes a stage (kMaxGroupRows)
STAGED_STATIC_SMEM = 512 * 4      # static shared memory (kSumFloats f32)
SMEM_LIMIT = 232_448             # shared memory a block may use (H100)
STAGE_BYTES = 64 * 1024          # aim for one ring stage
RING_BYTES = 192 * 1024          # the ring's budget
MAX_STAGES = 8
# below this many bytes of X in the slots a launch's fixed costs decide,
# and the tiled route's are the smaller (chip_smoke.py phase 2 on an H100
# 80GB HBM3 at 700 W: 300 x 100 f32, 0.0111 ms tiled and 0.0125 staged;
# 132 x 2,000 f32 (1 MB), 0.0164 and 0.0122)
STAGED_MIN_BYTES = 512 * 1024

_count_lock = threading.Lock()
_lib = None
_occupancy: dict = {}
# (device, stream) -> the staged route's chunk counter (int32, zero between
# launches: each launch sets it back at its end).  Launches that share a
# counter must not overlap; launches on one stream never do, and launches
# on two streams, which may, claim from two counters.
_counters: dict = {}
_pinned: Optional[str] = None


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
        ip = ctypes.POINTER(i)
        lib.masked_grad_staged_launch.argtypes = [
            vp, i, ll, ll, vp, vp, vp, vp, ll, i, vp, vp, i, i, i, ip, ip, i,
            vp, ll, i, vp, vp, vp,
        ]
        lib.masked_grad_staged_launch.restype = i
        lib.masked_grad_staged_occupancy.argtypes = [
            i, ll, ctypes.POINTER(i),
        ]
        lib.masked_grad_staged_occupancy.restype = i
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


class Geometry(NamedTuple):
    """The staged route's block layout for one row width."""

    stages: int  # ring stages
    rows: int    # rows of X a stage holds: groups x (rows a group takes)
    groups: int  # row groups; a group is lanes rounded up to whole warps
    lanes: int   # column lanes a group uses: d / V, V = 16 bytes of X
    smem: int    # dynamic shared memory bytes


@functools.lru_cache(maxsize=None)
def staged_geometry(d: int, elem_bytes: int) -> Optional[Geometry]:
    """The staged route's layout for rows of ``d`` elements of
    ``elem_bytes``, or None where the route does not take them: rows that
    are no multiple of 16 bytes, more column lanes than :data:`CONSUMERS`
    threads (too wide for the register accumulators), or a ring of fewer
    than two stages.  Dynamic shared memory, in the kernel's order: the
    ring, each ring slot's row number (int64), a full and an empty
    mbarrier a stage, each slot's coefficient, y, alpha and weight (f32),
    each stage's chunk and rows (int), and with more than one group the
    groups' sums of a chunk (f32)."""
    vec = _VEC_BYTES // elem_bytes
    if d <= 0 or d % vec:
        return None
    lanes = d // vec
    pad = -(-lanes // 32) * 32
    if pad > CONSUMERS:
        return None
    row = d * elem_bytes
    groups = CONSUMERS // pad
    per_group = max(1, min(MAX_GROUP_ROWS, MAX_STAGE_ROWS // groups,
                           STAGE_BYTES // (row * groups)))
    rows = groups * per_group
    stages = min(MAX_STAGES, RING_BYTES // (rows * row))
    if stages < 2:
        return None
    slots = stages * rows
    smem = (slots * row + 8 * slots + 16 * stages + 16 * slots + 8 * stages
            + (4 * groups * d if groups > 1 else 0))
    if smem + STAGED_STATIC_SMEM > SMEM_LIMIT:
        return None
    return Geometry(stages, rows, groups, lanes, smem)


MAX_ROUNDS = 48  # the kernel's kMaxRounds


@functools.lru_cache(maxsize=256)
def chunk_rounds(m: int, rows: int, blocks: int) -> Tuple[Tuple[int, int], ...]:
    """How the staged route cuts ``m`` slots into chunks of whole stages of
    ``rows`` slots: rounds ``(size, take)`` of ``take <= blocks`` chunks of
    ``size`` stages, each round's chunks holding half the stages still left
    shared over ``blocks`` (at least one stage), the last chunk cut at
    ``m``.  Block ``b`` runs chunk ``b``, then the chunks it claims as it
    finishes; the small last rounds let faster SMs even out the finish."""
    left, out = -(-m // rows), []
    while left > 0:
        size = max(1, -(-left // (2 * blocks)))
        take = min(blocks, -(-left // size))
        out.append((size, take))
        left -= take * size
    if len(out) > MAX_ROUNDS:
        raise ValueError(f"{len(out)} rounds of chunks, more than {MAX_ROUNDS}")
    return tuple(out)


def chunk_slots(m: int, rows: int, blocks: int) -> List[Tuple[int, int]]:
    """Each chunk's slots ``[lo, hi)``, in chunk order (the kernel's
    ``chunk_slots``); ``g`` sums the chunks' rows of the scratch tensor in
    this order, whichever block ran each."""
    out, start = [], 0
    for size, take in chunk_rounds(m, rows, blocks):
        out.extend(((start + j * size) * rows,
                    min(m, (start + (j + 1) * size) * rows))
                   for j in range(take))
        start += take * size
    return out


class LaunchPlan(NamedTuple):
    """One launch: the route, its grid and, on the staged route, its
    geometry and its chunks' rounds (:func:`chunk_rounds`)."""

    route: str                    # "staged" or "tiled"
    blocks: int
    m: int
    geometry: Optional[Geometry] = None
    rounds: Tuple[Tuple[int, int], ...] = ()

    @property
    def nchunks(self) -> int:
        return sum(take for _, take in self.rounds)

    def chunks(self) -> List[Tuple[int, int]]:
        return chunk_slots(self.m, self.geometry.rows, self.blocks)


def launch_plan(d: int, m: int, elem_bytes: int, aligned: bool, mode: int,
                sms: int, occupancy: Callable[[int], int],
                route: Optional[str] = None) -> LaunchPlan:
    """The launch of one form over ``m`` slots of rows of ``d`` elements of
    ``elem_bytes``: the staged route where the slots hold at least
    :data:`STAGED_MIN_BYTES` of X, the rows are ``aligned`` (``X`` and ``w``
    at 16-byte addresses) and :func:`staged_geometry` has a layout for
    them, else the tiled route.  ``mode`` (the form) does not choose.
    ``occupancy(smem)`` gives the staged blocks one SM holds at that much
    dynamic shared memory (the device's answer); the grid is that many on
    each of ``sms`` SMs.  ``route``
    pins a route (``"tiled"`` times the earlier design at a staged shape);
    pinning ``"staged"`` on rows it has no layout for raises."""
    geo = staged_geometry(d, elem_bytes) if aligned else None
    staged = geo is not None and m * d * elem_bytes >= STAGED_MIN_BYTES
    if route == "staged" and geo is None:
        raise ValueError("the staged route does not take this shape")
    if route is not None:
        staged = route == "staged"
    if not staged:
        return LaunchPlan("tiled", min(-(-m // TILE_ROWS), 2 * sms), m)
    per_sm = occupancy(geo.smem)
    if per_sm < 1:
        raise RuntimeError(f"no SM holds a staged masked_grad block at "
                           f"{geo.smem} bytes of shared memory")
    blocks = per_sm * sms
    return LaunchPlan("staged", blocks, m, geo,
                      chunk_rounds(m, geo.rows, blocks))


@contextlib.contextmanager
def pinned_route(route: str):
    """Launch every form on ``route`` ("staged" or "tiled") inside the
    block: for timing one design against the other at the same shape.  Not
    thread-safe; the solvers never use it."""
    global _pinned
    if route not in ("staged", "tiled"):
        raise ValueError(f"unknown route {route!r}")
    before, _pinned = _pinned, route
    try:
        yield
    finally:
        _pinned = before


@functools.lru_cache(maxsize=256)
def _round_arrays(rounds):
    """The rounds' sizes and takes as C int arrays (for the launch)."""
    n = max(len(rounds), 1)
    return ((ctypes.c_int * n)(*(r[0] for r in rounds)),
            (ctypes.c_int * n)(*(r[1] for r in rounds)))


def _staged_occupancy(lib, x_is_bf16: int, smem: int) -> int:
    key = (x_is_bf16, smem)
    if key not in _occupancy:
        per_sm = ctypes.c_int(0)
        rc = lib.masked_grad_staged_occupancy(x_is_bf16, smem,
                                              ctypes.byref(per_sm))
        if rc != 0:
            msg = lib.masked_grad_error_string(rc).decode()
            raise RuntimeError(f"masked_grad occupancy query failed: {msg} ({rc})")
        _occupancy[key] = per_sm.value
    return _occupancy[key]


def _launch(X, y, w, mask, idx, m, mode, alpha=None, diff=None, form=None):
    """Enqueue one form of the kernel on the current stream; returns g.
    Counted in ``masked_grad.launches``, in its route's count and in the
    launching ``form``'s own count."""
    device = X.device
    n, d = X.shape
    lib = _library()
    x_is_bf16 = _X_DTYPES[X.dtype]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    aligned = _aligned(*(t for t in (X, w) if t is not None))
    plan = launch_plan(
        d, m, X.element_size(), aligned, mode, sms,
        lambda smem: _staged_occupancy(lib, x_is_bf16, smem), _pinned,
    )
    rows = plan.nchunks if plan.route == "staged" else plan.blocks
    partial = torch.empty((max(rows, 1), d), dtype=torch.float32,
                          device=device)
    g = torch.empty(d, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(X), x_is_bf16, n, d, ptr(y), ptr(w), ptr(mask), ptr(idx), m,
            mode, ptr(alpha), ptr(diff))
    if plan.route == "staged":
        geo = plan.geometry
        counter = _counters.get((device, stream))
        if counter is None:
            counter = torch.zeros(1, dtype=torch.int32, device=device)
            _counters[(device, stream)] = counter
        sizes, takes = _round_arrays(plan.rounds)
        rc = lib.masked_grad_staged_launch(
            *args, geo.stages, geo.rows, geo.groups, sizes, takes,
            len(plan.rounds), ptr(counter), geo.smem, plan.blocks,
            ptr(partial), ptr(g), stream,
        )
    else:
        use_vec = d % (_VEC_BYTES // X.element_size()) == 0 and aligned
        rc = lib.masked_grad_launch(
            *args, int(use_vec), ptr(partial), plan.blocks, ptr(g), stream,
        )
    if rc != 0:
        msg = lib.masked_grad_error_string(rc).decode()
        raise RuntimeError(f"masked_grad kernel launch failed ({plan.route} "
                           f"route): {msg} ({rc})")
    with _count_lock:
        masked_grad.launches += 1
        if plan.route == "staged":
            masked_grad.launches_staged += 1
        else:
            masked_grad.launches_tiled += 1
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
masked_grad.launches_staged = 0
masked_grad.launches_tiled = 0
saga_grad.launches = 0
xt_coeff.launches = 0

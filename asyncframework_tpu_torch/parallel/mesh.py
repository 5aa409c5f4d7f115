"""Device meshes and the placement helpers.

Counterpart of ``asyncframework_tpu/parallel/mesh.py``.  A JAX mesh is an
array of devices with named axes, and a sharded array lives as one block a
device.  Here a :class:`Mesh` is a row-major list of ranks over named axes
(``("dp",)`` by default; ``("dp", "md")`` shards rows over ``dp`` and
features over ``md``), each rank naming the ``torch.device`` it computes
on, and a sharded array is a list of per-rank tensors in rank order:

- :func:`shard_batch` splits rows over ``dp`` (each block replicated over
  the other axes);
- :func:`pad_and_shard` pads rows to a multiple of the ``dp`` size first
  and adds the ``valid`` mask (0 on padded rows);
- :func:`pad_and_shard_2d` pads and splits rows over ``dp`` and features
  over ``md``; ``w`` is split over ``md`` and never whole on one rank.

A device may repeat: ``devices=[torch.device("cuda", 0)] * 4`` gives four
ranks on one card (a block that already lies on its rank's device is a
view, not a copy), and ``[torch.device("cpu")] * 8`` gives the tests'
eight-rank mesh, the counterpart of the eight virtual CPU devices the JAX
tests run on.  ``parallel/ring.py`` runs on a mesh with an ``"sp"`` axis
(``make_mesh(P, axis_names=("sp",), ...)``).

Under a process group (``parallel/multihost.py``) a mesh spans processes:
``process_of[r]`` is the process that holds rank ``r``, and the placement
helpers place only this process's ranks (:meth:`Mesh.local_ranks`), each
process holding the same global host arrays, as the JAX package's
``_put_sharded`` does.

``resolve_shard_map`` and ``pcast_varying`` of the JAX package are shims
over JAX releases' ``shard_map`` surfaces; nothing here traces a program,
so they have no counterpart.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.utils.devices import resolve_devices

logger = logging.getLogger(__name__)


class Mesh:
    """Named axes over a row-major list of ranks, each on a device."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Tuple[str, ...],
                 axis_sizes: Optional[Tuple[int, ...]] = None,
                 process_of: Optional[Sequence[int]] = None,
                 process_index: int = 0):
        if not axis_names:
            raise ValueError("a mesh needs at least one axis name")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must be distinct: {axis_names}")
        self.devices: List[torch.device] = list(devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if axis_sizes is None:
            axis_sizes = (len(self.devices),) + (1,) * (len(axis_names) - 1)
        axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(axis_sizes)} axis sizes for "
                             f"{len(self.axis_names)} axes")
        if math.prod(axis_sizes) != len(self.devices):
            raise ValueError(f"axis sizes {axis_sizes} do not hold "
                             f"{len(self.devices)} devices")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, axis_sizes))
        self.process_of: List[int] = (list(process_of) if process_of is not None
                                      else [process_index] * len(self.devices))
        if len(self.process_of) != len(self.devices):
            raise ValueError("process_of must name a process for every rank")
        self.process_index = int(process_index)

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> Dict[str, int]:
        """``{axis: index}`` of flat ``rank`` (row-major over the axes)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank(self, **coords: int) -> int:
        """The flat rank at ``coords`` (missing axes at 0)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + int(coords.get(name, 0))
        return r

    def local_ranks(self) -> List[int]:
        """The ranks this process holds, in rank order."""
        return [r for r, p in enumerate(self.process_of)
                if p == self.process_index]

    def spans_processes(self) -> bool:
        return len(set(self.process_of)) > 1

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of the ranks along ``axis`` (the other coordinates
        at 0), in rank order."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {self.axis_names})")
        return [self.devices[self.rank(**{axis: i})]
                for i in range(self.shape[axis])]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mesh({self.shape}, devices={self.devices})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("dp",),
    axis_sizes: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
    clamp: bool = False,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device; raises ``RuntimeError`` without one).

    The first axis holds every device and any further axis has size 1,
    unless ``axis_sizes`` says otherwise.  Asking for more devices than the
    list holds raises ``ValueError``; with ``clamp=True`` the count is
    clamped to the list's length and logged instead (the conf-driven path,
    ``async.mesh.devices`` on a worker, degrades on a smaller rig and never
    crashes the process)."""
    devs = resolve_devices(devices)
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"n_devices must be at least 1, got {n_devices}")
        if len(devs) < n_devices:
            if not clamp:
                raise ValueError(
                    f"requested a {n_devices}-device mesh but only "
                    f"{len(devs)} devices are available"
                )
            logger.warning(
                "make_mesh: requested %d devices but only %d available; "
                "clamping", n_devices, len(devs),
            )
            n_devices = len(devs)
        devs = devs[:n_devices]
    mesh = Mesh(devs, tuple(axis_names), axis_sizes)
    if clamp:
        logger.info("make_mesh: using mesh %s over %d %s device(s)",
                    mesh.shape, len(devs), devs[0].type)
    return mesh


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def as_rows(X, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """``X`` and ``y`` as tensors: host arrays become f32; a tensor stays
    where it is, f32 or bf16 ``X`` read in place."""
    Xt = X if isinstance(X, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(X, np.float32))
    if Xt.dtype not in (torch.float32, torch.bfloat16):
        Xt = Xt.float()
    yt = y if isinstance(y, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(y, np.float32))
    return Xt, yt.float()


def _place(block: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``block`` on ``device``, contiguous; a view where it already is."""
    return block.to(device).contiguous()


def shard_batch(mesh: Mesh, *arrays, axis: str = "dp"):
    """Place arrays (numpy or tensors) onto the mesh split on their leading
    dim over ``axis``: per array, a list over the mesh's ranks (``None`` on
    another process's rank) holding the row block of the rank's ``axis``
    index, replicated over the other axes.  The leading dim must divide by
    the axis size (:func:`pad_and_shard` pads)."""
    n_ax = mesh.shape[axis]
    local = set(mesh.local_ranks())
    out = []
    for a in arrays:
        t = _as_tensor(a)
        if t.shape[0] % n_ax:
            raise ValueError(f"{t.shape[0]} rows do not split over the "
                             f"{n_ax} ranks of axis {axis!r}")
        blk = t.shape[0] // n_ax
        parts: List[Optional[torch.Tensor]] = []
        for r in range(mesh.size):
            if r not in local:
                parts.append(None)
                continue
            p = mesh.coords(r)[axis]
            parts.append(_place(t[p * blk:(p + 1) * blk], mesh.devices[r]))
        out.append(parts)
    return tuple(out) if len(out) > 1 else out[0]


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def pad_and_shard(mesh: Mesh, *arrays, axis: str = "dp"):
    """Pad rows to a multiple of the ``axis`` size (zeros) and shard on it.

    Returns ``(*sharded_arrays, valid_sharded, n)``: ``valid`` is an f32
    mask that is 0 on padding rows and ``n`` the original row count.  A
    tensor input stays where it is until its blocks are placed, so an
    unpadded tensor on a rank's device gives views of itself."""
    n_ax = mesh.shape[axis]
    ts = [_as_tensor(a) for a in arrays]
    n = ts[0].shape[0]
    pad = (-n) % n_ax
    valid = torch.ones(n, dtype=torch.float32, device=ts[0].device)
    padded = [_pad_rows(t, pad) for t in ts] + [_pad_rows(valid, pad)]
    sharded = shard_batch(mesh, *padded, axis=axis)
    return (*sharded, n)


def pad_and_shard_2d(mesh: Mesh, X, y, w0, dp_axis: str = "dp",
                     md_axis: str = "md"):
    """2-D layout: rows pad and split over ``dp_axis`` and features over
    ``md_axis``, ``w`` split over the feature axis (never whole on one
    rank).  Returns ``(Xs, ys, valid, ws, d)``, each a per-rank list
    (``None`` on another process's rank), with ``d`` the original feature
    count (padded feature columns are zero and slice off the results).
    ``X`` and ``y`` are f32, as the JAX package casts them."""
    Xt = _as_tensor(X).float()
    yt = _as_tensor(y).float()
    wt = _as_tensor(w0).float()
    n, d = Xt.shape
    n_dp, n_md = mesh.shape[dp_axis], mesh.shape[md_axis]
    pad_n, pad_d = (-n) % n_dp, (-d) % n_md
    if pad_d:
        Xt = torch.cat([Xt, Xt.new_zeros((n, pad_d))], dim=1)
        wt = torch.cat([wt, wt.new_zeros(pad_d)])
    Xt, yt = _pad_rows(Xt, pad_n), _pad_rows(yt, pad_n)
    valid = _pad_rows(torch.ones(n, dtype=torch.float32, device=Xt.device),
                      pad_n)
    rb, cb = Xt.shape[0] // n_dp, Xt.shape[1] // n_md
    Xs, ys, vs, ws = [], [], [], []
    local = set(mesh.local_ranks())
    for r in range(mesh.size):
        if r not in local:
            for lst in (Xs, ys, vs, ws):
                lst.append(None)
            continue
        c = mesh.coords(r)
        i, j, dev = c[dp_axis], c[md_axis], mesh.devices[r]
        rows, cols = slice(i * rb, (i + 1) * rb), slice(j * cb, (j + 1) * cb)
        Xs.append(_place(Xt[rows, cols], dev))
        ys.append(_place(yt[rows], dev))
        vs.append(_place(valid[rows], dev))
        ws.append(_place(wt[cols], dev))
    return Xs, ys, vs, ws, d

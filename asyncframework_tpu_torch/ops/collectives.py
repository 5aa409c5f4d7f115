"""Reduction collectives over a mesh.

Counterpart of ``asyncframework_tpu/ops/collectives.py``.  Where JAX runs
``jax.lax.psum`` inside a ``shard_map``'d program, a port mesh holds a
per-rank list of tensors (``parallel/mesh.py``), and:

- :func:`psum_over_mesh` folds the per-rank partials in rank order onto
  the device of the group's first rank (the sequential device-order fold
  the JAX package's CPU all-reduce is); when the mesh spans processes
  (``parallel/multihost.py``), that is followed by one
  ``torch.distributed.all_reduce`` across them;
- :func:`tree_combine` is the host-side pairwise tree fold
  (``treeReduce``'s combine topology, depth log2);
- :func:`data_parallel_grad_fn` is the data-parallel summed gradient: a
  per-rank gradient sum, then :func:`psum_over_mesh`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from asyncframework_tpu_torch.parallel.mesh import Mesh


def _groups(mesh: Mesh, axis: str) -> Dict[Tuple[int, ...], List[int]]:
    """Ranks that reduce together over ``axis`` (equal coordinates on the
    other axes), keyed by those coordinates, each group in rank order."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {mesh.axis_names})")
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        key = tuple(c[a] for a in mesh.axis_names if a != axis)
        groups.setdefault(key, []).append(r)
    return groups


def _all_reduce_across(totals: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each of ``totals`` across the processes of the group in one
    ``all_reduce`` (they are stacked into one buffer and split again)."""
    import torch.distributed as dist

    dev = totals[0].device
    flat = torch.cat([t.reshape(-1).to(dev) for t in totals])
    dist.all_reduce(flat)
    out, at = [], 0
    for t in totals:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.device))
        at += t.numel()
    return out


def psum_over_mesh(parts: Sequence[Optional[torch.Tensor]], mesh: Mesh,
                   axis: str = "dp") -> List[Optional[torch.Tensor]]:
    """All-reduce sum over a mesh axis.

    ``parts`` holds one tensor per rank (``None`` on another process's
    rank).  Returns a list of the same length whose entries are each
    rank's group total: ``parts`` of the ranks that differ only in their
    ``axis`` coordinate, added in rank order onto the device of the
    group's first rank (one tensor object shared by the group; ``None`` on
    another process's rank).  When the group crosses processes, each
    process folds its own ranks so, and one ``all_reduce`` of every
    group's fold sums them across the processes."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} partials for a {mesh.size}-rank mesh")
    groups = _groups(mesh, axis)
    local = set(mesh.local_ranks())
    totals: List[torch.Tensor] = []
    members: List[List[int]] = []
    crosses = mesh.spans_processes() and any(
        len({mesh.process_of[r] for r in ranks}) > 1
        for ranks in groups.values())
    for ranks in groups.values():
        mine = [r for r in ranks if r in local]
        if not mine:
            if crosses:
                # every process must enter the all_reduce with the same
                # groups in the same order
                raise ValueError(f"this process holds no rank of a group "
                                 f"reducing over {axis!r}")
            continue
        dev = parts[mine[0]].device
        acc = parts[mine[0]]
        for r in mine[1:]:
            acc = acc + parts[r].to(dev)
        totals.append(acc)
        members.append(mine)
    if crosses:
        totals = _all_reduce_across(totals)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for total, mine in zip(totals, members):
        for r in mine:
            out[r] = total
    return out


def tree_combine(items: Sequence[Any], op: Callable[[Any, Any], Any]) -> Any:
    """Pairwise tree fold on the host: log2(n) depth, parity with
    treeReduce's combine topology.  ``op`` must be commutative and
    associative (the reference's requirement for ``reduce``)."""
    items = list(items)
    if not items:
        raise ValueError("tree_combine over empty sequence")
    while len(items) > 1:
        nxt: List[Any] = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(op(items[i], items[i + 1]))
        if len(items) % 2 == 1:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def data_parallel_grad_fn(grad_sum_fn: Callable, mesh: Mesh,
                          axis: str = "dp"):
    """A data-parallel summed-gradient function over ``mesh``.

    ``grad_sum_fn(X, y, w, mask) -> g`` is a per-rank summed gradient (e.g.
    :func:`~asyncframework_tpu_torch.ops.gradients.least_squares_grad_sum`,
    one launch of kernel B1 on a card).  The returned function takes
    per-rank lists ``Xs``, ``ys``, ``masks`` (rows split over ``axis``, as
    :func:`~asyncframework_tpu_torch.parallel.mesh.shard_batch` places
    them) and one ``w`` (replicated: each rank reads it on its own
    device), and returns the global gradient sum on the first local
    rank's device."""

    def grad(Xs, ys, w, masks):
        parts: List[Optional[torch.Tensor]] = [None] * mesh.size
        for r in mesh.local_ranks():
            parts[r] = grad_sum_fn(Xs[r], ys[r], w.to(mesh.devices[r]),
                                   masks[r])
        return psum_over_mesh(parts, mesh, axis)[mesh.local_ranks()[0]]

    return grad

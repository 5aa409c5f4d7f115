"""Pregel: bulk-synchronous vertex programs.

Parity: ``graphx/.../Pregel.scala:59`` -- iterate { aggregateMessages;
joinVertices(vprog) } until no messages or maxIterations.  The reference's
signature is per-vertex/per-edge callbacks over RDD triplets with an
arbitrary ``mergeMsg`` closure executed during a shuffle.

Counterpart of ``asyncframework_tpu/graph/pregel.py``, with its deltas:
- Each superstep gathers vertex attrs to edges, computes messages
  vectorized over all edges, and segment-combines them to vertices
  (``index_add_`` for ``sum``, ``scatter_reduce_`` for ``min``/``max``).
  The JAX package runs the loop as one ``lax.while_loop``; here it is a
  Python loop with the same stopping rule (``graph/pregel.py:92-110``
  there): the first iteration always runs, then the loop stops once the
  attributes are unchanged (exact equality, or max-abs within ``tol``
  when one is given) or after ``max_iterations``.  Each check reads one
  flag off the device.  :attr:`pregel.last_iterations` holds the number
  of supersteps the last call ran.
- ``merge`` is a named monoid ('sum' | 'min' | 'max') rather than an
  arbitrary closure; every GraphX algorithm in the reference's ``lib/``
  uses a monoid.
- Vertices are always "active"; convergence is detected globally (attrs
  unchanged -> stop), which subsumes the reference's empty-message
  termination for monoid merges with identity elements.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from asyncframework_tpu_torch.graph.graph import (
    Graph,
    as_tensor,
    graph_device,
)

_MERGES = ("sum", "min", "max")


def merge_identity(dtype: torch.dtype, merge: str):
    """The monoid identity in the message dtype (a vertex with no incoming
    edges keeps exactly this value): 0 for sum, dtype-max for min, dtype-min
    for max -- exact for integer dtypes, +/-inf for floats."""
    if merge == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if merge == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if merge == "min" else info.min


def segment_combine(msgs, dst, num_vertices: int, merge: str):
    """Combine per-edge messages (1-D, or (E, ...) with a message per row)
    into per-vertex aggregates on the messages' device."""
    if merge not in _MERGES:
        raise ValueError(f"merge must be one of {sorted(_MERGES)}")
    if not isinstance(msgs, torch.Tensor):
        msgs = as_tensor(msgs, graph_device(dst))
    idx = (dst if isinstance(dst, torch.Tensor)
           else as_tensor(dst, msgs.device)).to(msgs.device).long()
    shape = (num_vertices,) + tuple(msgs.shape[1:])
    out = torch.full(shape, merge_identity(msgs.dtype, merge),
                     dtype=msgs.dtype, device=msgs.device)
    if merge == "sum":
        return out.index_add_(0, idx, msgs)
    if msgs.dim() > 1:
        idx = idx.view(-1, *([1] * (msgs.dim() - 1))).expand_as(msgs)
    return out.scatter_reduce_(0, idx, msgs,
                               reduce="amin" if merge == "min" else "amax")


def pregel(
    graph: Graph,
    initial_attr,
    vprog: Callable,
    send_msg: Callable,
    merge: str = "sum",
    max_iterations: int = 100,
    tol: Optional[float] = None,
):
    """Run a vertex program to convergence.

    ``vprog(attr, agg) -> attr'`` -- vectorized over ALL vertices; ``agg`` is
    the merged message tensor (monoid identity where a vertex got none).
    ``send_msg(src_attr, dst_attr, edge_attr) -> msgs`` -- vectorized over
    ALL edges (``src_attr = attr[g.src]`` etc.).
    Stops after ``max_iterations`` or when the attribute update is within
    ``tol`` (max-abs for float attrs; exact equality when ``tol`` is None).
    Returns the final vertex attribute tensor.
    """
    attr = as_tensor(initial_attr, graph.device)
    if attr.shape[0] != graph.num_vertices:
        raise ValueError("initial_attr first dim must equal num_vertices")
    src, dst = graph.src_index, graph.dst_index
    eattr = graph.edge_attr
    n = graph.num_vertices
    it = 0
    while it < max_iterations:
        msgs = send_msg(attr[src], attr[dst], eattr)
        new = vprog(attr, segment_combine(msgs, dst, n, merge))
        it += 1
        changed = (
            bool(torch.any(torch.abs(new - attr) > tol))
            if tol is not None
            else bool(torch.any(new != attr))
        )
        attr = new
        if not changed:
            break
    pregel.last_iterations = it
    return attr


pregel.last_iterations = 0

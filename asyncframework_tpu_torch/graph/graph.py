"""Graph representation: dense edge arrays in device memory.

Parity: GraphX's ``Graph``/``VertexRDD``/``EdgeRDD``
(``graphx/.../Graph.scala`` family) -- there, vertices and edges are
partitioned RDDs with routing tables so triplets can join vertex attrs to
edges.  Here a graph is two int32 edge-endpoint tensors plus optional
vertex/edge attribute tensors, all on one device.  The "join" is a gather
(``attr[src]``), the "message aggregation" is a segment combine
(scatter-add/min/max) -- single device ops replacing GraphX's
shuffle-based ``aggregateMessages``.

Counterpart of ``asyncframework_tpu/graph/graph.py``.  ``src``/``dst`` stay
int32, as the user sees them in both packages; torch's gathers and scatters
index with int64, so a graph widens its endpoints once, at first use, into
:attr:`Graph.src_index` / :attr:`Graph.dst_index` (8 more bytes an edge,
kept for the graph's life).  A graph lives on ``device``, else on its
``src`` tensor's device, else on the card (raises without one unless
``ASYNCTPU_FORCE_CPU`` asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asyncframework_tpu_torch.utils.devices import canonical, entry_devices


def graph_device(like=None, device=None) -> torch.device:
    """Where a graph built from ``like`` lives: ``device``, else ``like``'s
    device when it is a tensor, else the entry device."""
    if device is not None:
        return canonical(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return entry_devices()[0]


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``; host float64 becomes float32 (the
    JAX package's default float width)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def _endpoints(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)


class Graph:
    """Immutable edge-list graph.

    ``src``/``dst``: int32 tensors of shape (E,).  Vertex ids are dense
    ``0..num_vertices-1`` (the reference allows arbitrary i64 ids and pays a
    routing table for it; dense ids keep every op a flat gather/scatter).
    """

    def __init__(
        self,
        src,
        dst,
        num_vertices: Optional[int] = None,
        vertex_attr=None,
        edge_attr=None,
        device=None,
    ):
        self.device = graph_device(src, device)
        self.src = _endpoints(src, self.device)
        self.dst = _endpoints(dst, self.device)
        if self.src.shape != self.dst.shape or self.src.ndim != 1:
            raise ValueError("src/dst must be 1-d arrays of equal length")
        if num_vertices is None:
            if self.src.numel() == 0:
                raise ValueError("num_vertices required for an empty graph")
            num_vertices = int(
                max(int(self.src.max()), int(self.dst.max())) + 1
            )
        self.num_vertices = int(num_vertices)
        self.vertex_attr = (
            None if vertex_attr is None else as_tensor(vertex_attr,
                                                       self.device)
        )
        self.edge_attr = (
            None if edge_attr is None else as_tensor(edge_attr, self.device)
        )
        if (
            self.vertex_attr is not None
            and self.vertex_attr.shape[0] != self.num_vertices
        ):
            raise ValueError("vertex_attr first dim must equal num_vertices")
        if (self.edge_attr is not None
                and self.edge_attr.shape[0] != self.src.shape[0]):
            raise ValueError("edge_attr first dim must equal num_edges")
        self._src64: Optional[torch.Tensor] = None
        self._dst64: Optional[torch.Tensor] = None

    @property
    def src_index(self) -> torch.Tensor:
        """``src`` widened to int64 (torch's index dtype), made once."""
        if self._src64 is None:
            self._src64 = self.src.long()
        return self._src64

    @property
    def dst_index(self) -> torch.Tensor:
        """``dst`` widened to int64, made once."""
        if self._dst64 is None:
            self._dst64 = self.dst.long()
        return self._dst64

    @classmethod
    def from_edge_ids(
        cls,
        src_ids,
        dst_ids,
        vertex_attr_by_id: Optional[dict] = None,
        edge_attr=None,
        device=None,
    ) -> "Graph":
        """Build a graph from ARBITRARY vertex ids (sparse i64, hashes --
        the ids GraphX accepts and pays a routing table for).

        The dense relabeling is computed once on host (`np.unique` over the
        edge endpoints) and remembered: ``vertex_ids[j]`` is the original id
        of dense vertex ``j``, and every algorithm's per-vertex output can
        be re-keyed with :meth:`original_ids`.  This is the routing table's
        job done once at construction instead of per-superstep shuffle.
        """
        src_ids = np.asarray(src_ids)
        dst_ids = np.asarray(dst_ids)
        endpoints = np.concatenate([src_ids, dst_ids])
        # ids supplied only through attributes become ISOLATED vertices
        # (GraphX keeps the vertex set's extra ids; silently dropping an
        # entity the caller named would corrupt per-vertex outputs)
        universe = endpoints
        if vertex_attr_by_id is not None:
            universe = np.concatenate([
                endpoints,
                np.asarray(list(vertex_attr_by_id), endpoints.dtype),
            ])
        ids = np.unique(universe)
        inv = np.searchsorted(ids, endpoints)
        e = len(src_ids)
        vattr = None
        if vertex_attr_by_id is not None:
            missing = [i for i in ids.tolist() if i not in vertex_attr_by_id]
            if missing:
                raise ValueError(
                    f"vertex_attr_by_id missing ids (first few): "
                    f"{missing[:5]}"
                )
            vattr = np.asarray([vertex_attr_by_id[i] for i in ids.tolist()])
        g = cls(
            inv[:e].astype(np.int32),
            inv[e:].astype(np.int32),
            num_vertices=int(len(ids)),
            vertex_attr=vattr,
            edge_attr=edge_attr,
            device=device,
        )
        g.vertex_ids = ids  # dense index -> original id
        return g

    def original_ids(self) -> np.ndarray:
        """Original vertex id per dense index (identity for graphs built
        with dense ids)."""
        ids = getattr(self, "vertex_ids", None)
        return ids if ids is not None else np.arange(self.num_vertices)

    def _keep_ids(self, g: "Graph") -> "Graph":
        """Views preserve the vertex DOMAIN, so the original-id mapping
        carries over unchanged (derived graphs must re-key correctly)."""
        ids = getattr(self, "vertex_ids", None)
        if ids is not None:
            g.vertex_ids = ids
        return g

    def _view(self, src, dst, vertex_attr, edge_attr) -> "Graph":
        return self._keep_ids(Graph(src, dst, self.num_vertices, vertex_attr,
                                    edge_attr, device=self.device))

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    # --------------------------------------------------------------- degrees
    def out_degrees(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.num_vertices).int()

    def in_degrees(self) -> torch.Tensor:
        return torch.bincount(self.dst, minlength=self.num_vertices).int()

    def degrees(self) -> torch.Tensor:
        return self.out_degrees() + self.in_degrees()

    # ---------------------------------------------------------------- views
    def reverse(self) -> "Graph":
        return self._view(self.dst, self.src, self.vertex_attr,
                          self.edge_attr)

    def with_vertex_attr(self, attr) -> "Graph":
        return self._view(self.src, self.dst, attr, self.edge_attr)

    def map_vertices(self, f) -> "Graph":
        """``Graph.mapVertices`` parity: new vertex attributes from one
        vectorized map over the attribute tensor."""
        if self.vertex_attr is None:
            raise ValueError("graph has no vertex_attr to map")
        return self.with_vertex_attr(f(self.vertex_attr))

    def map_edges(self, f) -> "Graph":
        """``Graph.mapEdges`` parity (vectorized over the edge tensor)."""
        if self.edge_attr is None:
            raise ValueError("graph has no edge_attr to map")
        return self._view(self.src, self.dst, self.vertex_attr,
                          f(self.edge_attr))

    def subgraph(self, edge_mask=None, vertex_mask=None) -> "Graph":
        """``Graph.subgraph`` parity: keep edges passing ``edge_mask``
        whose BOTH endpoints pass ``vertex_mask``.  Vertex ids are
        preserved (dropped vertices just become isolates), matching the
        reference's behavior of keeping the vertex domain."""
        keep = torch.ones(self.num_edges, dtype=torch.bool,
                          device=self.device)
        if edge_mask is not None:
            keep &= as_tensor(edge_mask, self.device).bool()
        if vertex_mask is not None:
            vm = as_tensor(vertex_mask, self.device).bool()
            if vm.shape[0] != self.num_vertices:
                raise ValueError("vertex_mask must have num_vertices entries")
            keep &= vm[self.src_index] & vm[self.dst_index]
        idx = torch.nonzero(keep).squeeze(1)
        return self._view(
            self.src[idx], self.dst[idx], self.vertex_attr,
            None if self.edge_attr is None else self.edge_attr[idx],
        )

    def aggregate_messages(self, send_msg, merge: str = "sum"):
        """``Graph.aggregateMessages`` parity -- THE GraphX primitive: per
        edge, ``send_msg(src_attr, dst_attr, edge_attr)`` produces a message
        to the edge's destination; messages combine per vertex with one
        device segment-``merge``.  Returns the (num_vertices, ...) combined
        tensor (vertices with no messages get the merge identity)."""
        from asyncframework_tpu_torch.graph.pregel import segment_combine

        sa = (
            self.vertex_attr[self.src_index]
            if self.vertex_attr is not None else None
        )
        da = (
            self.vertex_attr[self.dst_index]
            if self.vertex_attr is not None else None
        )
        msgs = send_msg(sa, da, self.edge_attr)
        return segment_combine(msgs, self.dst_index, self.num_vertices, merge)

    @classmethod
    def from_edges(cls, edges, num_vertices: Optional[int] = None,
                   device=None) -> "Graph":
        """Build from an (E, 2) array or list of (src, dst) pairs."""
        e = np.asarray(edges, np.int32)
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError("edges must be (E, 2)")
        return cls(e[:, 0], e[:, 1], num_vertices, device=device)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph(V={self.num_vertices}, E={self.num_edges})"

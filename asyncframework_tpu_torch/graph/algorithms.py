"""Graph algorithms on the Pregel substrate.

Parity: GraphX ``lib/`` -- ``PageRank.scala`` (damping 0.85, teleport
``(1-a)/n`` formulation in the standalone runner) and
``ConnectedComponents.scala`` (min-id label propagation).

Counterpart of ``asyncframework_tpu/graph/algorithms.py``: the same
algorithms and outputs in torch on the graph's device.  The dense
products (``triangle_count``'s ``A @ A``, SCC's log-squaring) are f32
matmuls of 0/1 matrices, exact while the path counts stay below 2^24
(n up to 2^14, the dense regime's ceiling) and TF32 is off.
``svd_plus_plus`` draws its initial factors with a ``torch.Generator``
(not threefry, ROADMAP C2) and trains with ``torch.autograd`` through
:func:`_train_svd_plus_plus`, which takes the initial factors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from asyncframework_tpu_torch.graph.graph import Graph, as_tensor, graph_device
from asyncframework_tpu_torch.graph.pregel import pregel


def _pagerank_impl(
    graph: Graph,
    teleport: torch.Tensor,
    alpha: float,
    num_iterations: int,
    tol: Optional[float],
) -> torch.Tensor:
    """One power-iteration lowering shared by both PageRank variants:
    ``r' = (1-a)*teleport + a*(sum_in r/outdeg + dangling_mass*teleport)``
    -- uniform ``teleport`` is classic PageRank, a one-hot is the
    personalized form.  Teleport and dangling mass share the same
    destination distribution (both variants' semantics)."""
    outdeg = graph.out_degrees().float()
    dangling = (outdeg == 0).float()
    # the source's degree per edge, gathered once for every superstep
    edge_deg = torch.clamp(outdeg, min=1)[graph.src_index]

    def vprog(r, incoming):
        # dangling vertices' rank re-enters via the teleport distribution;
        # recomputed from the *current* ranks
        d_mass = torch.sum(r * dangling)
        return (1.0 - alpha) * teleport + alpha * (
            incoming + d_mass * teleport
        )

    def send_msg(src_r, dst_r, _e):
        return src_r / edge_deg

    return pregel(
        graph, teleport, vprog, send_msg, merge="sum",
        max_iterations=num_iterations, tol=tol,
    )


def pagerank(
    graph: Graph,
    alpha: float = 0.85,
    num_iterations: int = 20,
    tol: Optional[float] = None,
) -> torch.Tensor:
    """Normalized PageRank (ranks sum to 1; dangling mass redistributed).

    ``r' = (1-a)/n + a * (sum_in r/outdeg + dangling/n)``.
    With ``tol`` set, stops early once max-abs rank change <= tol.
    """
    n = graph.num_vertices
    uniform = torch.full((n,), 1.0 / n, dtype=torch.float32,
                         device=graph.device)
    return _pagerank_impl(graph, uniform, alpha, num_iterations, tol)


def personalized_pagerank(
    graph: Graph,
    source: int,
    alpha: float = 0.85,
    num_iterations: int = 20,
    tol: Optional[float] = None,
) -> torch.Tensor:
    """Personalized PageRank from a single source vertex (GraphX
    ``PageRank.runWithOptions`` with ``srcId`` semantics): the teleport
    mass returns to ``source`` instead of spreading uniformly, so ranks
    measure proximity to the source."""
    n = graph.num_vertices
    if not 0 <= source < n:
        raise ValueError(f"source {source} out of range [0, {n})")
    onehot = torch.zeros(n, dtype=torch.float32, device=graph.device)
    onehot[source] = 1.0
    return _pagerank_impl(graph, onehot, alpha, num_iterations, tol)


def _both_directions(graph: Graph, src_first: bool = True) -> Graph:
    """The graph with every edge in both directions (weak connectivity)."""
    a, b = (graph.src, graph.dst) if src_first else (graph.dst, graph.src)
    return Graph(torch.cat([a, b]), torch.cat([b, a]), graph.num_vertices,
                 device=graph.device)


def connected_components(graph: Graph,
                         max_iterations: int = 100) -> torch.Tensor:
    """Label each vertex with the smallest vertex id in its (weakly)
    connected component (GraphX ``ConnectedComponents`` semantics)."""
    n = graph.num_vertices
    g2 = _both_directions(graph)
    # int32 labels: exact for every representable vertex count (float32
    # would collide ids above 2**24); the min-merge identity is INT32_MAX
    labels0 = torch.arange(n, dtype=torch.int32, device=graph.device)

    def vprog(lbl, incoming):
        return torch.minimum(lbl, incoming)

    def send_msg(src_lbl, dst_lbl, _e):
        return src_lbl

    return pregel(
        g2, labels0, vprog, send_msg, merge="min",
        max_iterations=max_iterations,
    )


def _dense_adjacency(graph: Graph, dtype: torch.dtype) -> torch.Tensor:
    """The (n, n) 0/1 adjacency of ``graph`` without self loops."""
    n = graph.num_vertices
    keep = graph.src != graph.dst
    A = torch.zeros((n, n), dtype=dtype, device=graph.device)
    A[graph.src_index[keep], graph.dst_index[keep]] = 1
    return A


def triangle_count(graph: Graph) -> torch.Tensor:
    """Per-vertex triangle counts (GraphX ``TriangleCount.scala`` semantics:
    the graph is canonicalized -- undirected, deduped, no self loops).

    The graph is materialized as a dense 0/1 adjacency matrix and counted
    with one matmul -- ``count_v = (A @ A * A).sum(row)/2`` counts, for each
    edge (v,u), the common neighbors of v and u.  O(n^2) memory by design:
    the dense regime (n up to ~2^14, 1 GB at f32).  The row sums are taken
    in float64, exact at every count that regime can produce.
    """
    A = _dense_adjacency(graph, torch.float32)
    A = torch.maximum(A, A.T)  # canonical undirected, deduped
    common = (A @ A) * A
    return (common.sum(dim=1, dtype=torch.float64) / 2).to(torch.int32)


def label_propagation(graph: Graph, max_iterations: int = 10) -> torch.Tensor:
    """Community detection by synchronous label propagation (GraphX
    ``LabelPropagation.scala``): every step each vertex adopts the most
    frequent label among its neighbors (ties -> smallest label, a
    deterministic refinement of the reference's map-ordering tie).

    Dense label-histogram formulation: labels live in ``0..n-1``, so one
    scatter-add builds the (n, n) neighbor-label histogram per step --
    O(n^2) memory, same regime note as :func:`triangle_count`.
    """
    n = graph.num_vertices
    g2 = _both_directions(graph)
    src, dst = g2.src_index, g2.dst_index
    labels = torch.arange(n, dtype=torch.int32, device=graph.device)
    hist = torch.zeros(n * n, dtype=torch.int32, device=graph.device)
    ones = torch.ones_like(src, dtype=torch.int32)
    for _ in range(max_iterations):
        hist.zero_()
        hist.index_add_(0, dst * n + labels[src].long(), ones)
        h = hist.view(n, n)
        # most frequent neighbor label; ties break to the SMALLEST label
        # (argmax returns the first maximum)
        best = torch.argmax(h, dim=1).to(torch.int32)
        has_neighbors = h.sum(dim=1) > 0
        labels = torch.where(has_neighbors, best, labels)
    return labels


def shortest_paths(
    graph: Graph, landmarks, max_iterations: int = 50
) -> torch.Tensor:
    """Hop-count distances from every vertex to each landmark (GraphX
    ``ShortestPaths.scala``).  Returns (n, L) float32 with ``inf`` for
    unreachable pairs.  One Pregel run with a vector vertex attribute:
    the per-edge message is ``dist[src] + 1`` and the merge is ``min`` --
    the min-plus semiring ridden by a segment-min.
    """
    n = graph.num_vertices
    lms = as_tensor(landmarks, graph.device).long()
    L = int(lms.shape[0])
    # undirected hop counts: propagate along both edge directions
    g2 = _both_directions(graph, src_first=False)
    d0 = torch.full((n, L), float("inf"), dtype=torch.float32,
                    device=graph.device)
    d0[lms, torch.arange(L, device=graph.device)] = 0.0

    def vprog(d, incoming):
        return torch.minimum(d, incoming)

    def send_msg(src_d, dst_d, _e):
        return src_d + 1.0

    return pregel(
        g2, d0, vprog, send_msg, merge="min",
        max_iterations=max_iterations,
    )


def strongly_connected_components(
    graph: Graph, max_iterations: int = 100
) -> torch.Tensor:
    """Label each vertex with the smallest vertex id in its strongly
    connected component (GraphX ``StronglyConnectedComponents.scala``
    semantics).

    Forward-backward reachability on dense boolean adjacency: vertices u, v
    are in the same SCC iff v reaches u AND u reaches v.  Reachability
    closure is computed by log-squaring the adjacency matrix (O(log n)
    f32 matmuls) -- the dense-regime trade documented for
    :func:`triangle_count` (the reference instead peels color-by-color
    through repeated Pregel rounds).  The SCC label is the min id over the
    intersection of forward and backward reachable sets.
    """
    n = graph.num_vertices
    R = _dense_adjacency(graph, torch.bool)
    R |= torch.eye(n, dtype=torch.bool, device=graph.device)  # reflexive
    # transitive closure by boolean log-squaring: R <- R "or-and" R; the
    # count is the JAX package's (a float32 log2)
    iters = max(1, min(int(math.ceil(float(np.log2(np.float32(max(n, 2)))))),
                       max_iterations))
    for _ in range(iters):
        Rf = R.float()
        R = R | ((Rf @ Rf) > 0)
    both = R & R.T  # u ~ v iff mutual reachability
    ids = torch.arange(n, dtype=torch.int32, device=graph.device)
    big = torch.iinfo(torch.int32).max
    return torch.where(both, ids[None, :], big).min(dim=1).values


def svd_plus_plus(
    src,
    dst,
    ratings,
    rank: int = 8,
    num_iterations: int = 200,
    lr: float = 0.5,
    reg: float = 0.015,
    num_users: Optional[int] = None,
    num_items: Optional[int] = None,
    seed: int = 0,
    device=None,
):
    """SVD++ collaborative filtering on a bipartite rating graph.

    Parity: GraphX ``lib/SVDPlusPlus.scala`` (Koren's model) -- prediction

        r_hat(u, i) = mu + b_u + b_i + q_i . (p_u + |N(u)|^-1/2 sum_j y_j)

    trained by gradient steps on squared error with L2 regularization.
    The reference runs per-edge Pregel messages; here every iteration is
    one dense gather/scatter-add pass over the edge list, full-batch GD
    instead of the reference's per-edge SGD (the JAX package's documented
    delta: same objective, stabler on a batched device).

    The initial factors are drawn with a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the ratings' device, else the card).  Returns
    an :class:`SVDPlusPlusModel` carrying the effective user vectors
    (explicit + implicit-feedback term already folded in) and the loss of
    each iteration (``loss_history``).
    """
    dev = graph_device(src, device)
    src = as_tensor(src, dev).long()
    dst = as_tensor(dst, dev).long()
    nu = int(num_users) if num_users is not None else int(src.max()) + 1
    ni = int(num_items) if num_items is not None else int(dst.max()) + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scale = 1.0 / math.sqrt(rank)

    def draw(rows):
        return torch.randn((rows, rank), generator=gen, device=dev) \
            * scale * 0.1

    P0, Q0, Y0 = draw(nu), draw(ni), draw(ni)
    return _train_svd_plus_plus(src, dst, ratings, P0, Q0, Y0, num_iterations,
                                lr, reg, nu, ni)


def _train_svd_plus_plus(src, dst, ratings, P0, Q0, Y0, num_iterations: int,
                         lr: float, reg: float,
                         num_users: Optional[int] = None,
                         num_items: Optional[int] = None):
    """Train SVD++ from the initial factors ``P0`` (users x rank), ``Q0``
    and ``Y0`` (items x rank): the gradient steps of
    :func:`svd_plus_plus`, on ``P0``'s device."""
    dev = P0.device if isinstance(P0, torch.Tensor) else graph_device(src)
    src = as_tensor(src, dev).long()
    dst = as_tensor(dst, dev).long()
    r = as_tensor(ratings, dev).float()
    P0, Q0, Y0 = (as_tensor(x, dev).float() for x in (P0, Q0, Y0))
    nu = int(num_users) if num_users is not None else int(src.max()) + 1
    ni = int(num_items) if num_items is not None else int(dst.max()) + 1
    # validate explicit bounds: an underestimate would silently corrupt
    # training
    if int(src.max()) >= nu or int(src.min()) < 0:
        raise ValueError(f"user ids must be in [0, {nu}) -- got "
                         f"[{int(src.min())}, {int(src.max())}]")
    if int(dst.max()) >= ni or int(dst.min()) < 0:
        raise ValueError(f"item ids must be in [0, {ni}) -- got "
                         f"[{int(dst.min())}, {int(dst.max())}]")
    rank = int(P0.shape[1])
    mu = float(torch.mean(r))
    m = r.shape[0]

    # |N(u)|^{-1/2} and the per-user implicit-feedback item sets ride the
    # edge list: sum_j y_j per user is one segment-sum over edges
    deg = torch.zeros(nu, device=dev).index_add_(
        0, src, torch.ones(m, device=dev))
    inv_sqrt = (1.0 / torch.sqrt(torch.clamp(deg, min=1.0)))[:, None]

    def effective_users(P, Y):
        ysum = torch.zeros((nu, rank), device=dev).index_add(0, src, Y[dst])
        return P + ysum * inv_sqrt

    def loss_fn(P, Q, Y, bu, bi):
        pu_eff = effective_users(P, Y)
        pred = mu + bu[src] + bi[dst] + torch.sum(Q[dst] * pu_eff[src], dim=1)
        err = pred - r
        l2 = (
            torch.sum(P * P) + torch.sum(Q * Q) + torch.sum(Y * Y)
            + torch.sum(bu * bu) + torch.sum(bi * bi)
        )
        # per-edge normalization makes the learning rate scale-free (the
        # reference's per-edge SGD has the same property by construction)
        return (0.5 * torch.sum(err * err) + 0.5 * reg * l2) / m

    params = [P0.clone(), Q0.clone(), Y0.clone(),
              torch.zeros(nu, device=dev), torch.zeros(ni, device=dev)]
    for p in params:
        p.requires_grad_(True)
    losses = []
    for _ in range(num_iterations):
        loss = loss_fn(*params)
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.detach())
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
    with torch.no_grad():
        P, Q, Y, bu, bi = params
        losses.append(loss_fn(*params))
        # fold the implicit-feedback sum into effective user vectors once,
        # so prediction needs no edge list
        P_eff = effective_users(P, Y)
    return SVDPlusPlusModel(
        user_vectors=P_eff.cpu().numpy(),
        item_vectors=Q.detach().cpu().numpy(),
        user_bias=bu.detach().cpu().numpy(),
        item_bias=bi.detach().cpu().numpy(),
        mean=mu,
        loss_history=torch.stack(losses).cpu().numpy(),
    )


class SVDPlusPlusModel:
    """Trained SVD++ factors (host arrays); ``predict`` is one gather + dot
    per pair.  ``loss_history`` is the training loss before each iteration
    and after the last (None for a loaded model)."""

    def __init__(self, user_vectors, item_vectors, user_bias, item_bias,
                 mean: float, loss_history=None):
        self.user_vectors = user_vectors  # effective: implicit term folded
        self.item_vectors = item_vectors
        self.user_bias = user_bias
        self.item_bias = item_bias
        self.mean = mean
        self.loss_history = loss_history

    def predict(self, users, items):
        u = np.asarray(users, np.int64)
        i = np.asarray(items, np.int64)
        return (
            self.mean + self.user_bias[u] + self.item_bias[i]
            + np.sum(self.item_vectors[i] * self.user_vectors[u], axis=1)
        )


# ------------------------------------------------------------- partitioning
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) held in int64: the constant
    is split in 16-bit halves so no product leaves int64's range (torch has
    little uint32 arithmetic)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix(x: torch.Tensor) -> torch.Tensor:
    # xorshift-multiply mix (splitmix-style), stable across runs
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def partition_edges(
    graph: Graph, num_partitions: int, strategy: str = "edge_2d"
) -> torch.Tensor:
    """Edge -> partition assignment (GraphX ``PartitionStrategy.scala``).

    Strategies: ``edge_1d`` (hash src -- co-locates out-edges),
    ``edge_2d`` (sqrt-grid block of (src, dst) -- bounds vertex replication
    by 2*sqrt(p)), ``random_vertex_cut`` (hash of the ordered pair),
    ``canonical_random_vertex_cut`` (hash of the sorted pair, so both
    directions of an undirected edge land together).  Deterministic: a
    mixed-congruential integer hash, no process salt -- the JAX package's
    uint32 arithmetic, emulated in int64 masked to 32 bits, so both
    packages assign every edge alike.
    """
    if num_partitions < 1:
        raise ValueError("num_partitions must be >= 1")
    src = graph.src.long() & _U32
    dst = graph.dst.long() & _U32
    p = num_partitions

    if strategy == "edge_1d":
        out = _mix(src) % p
    elif strategy == "edge_2d":
        side = int(math.ceil(math.sqrt(num_partitions)))
        col = _mix(src) % side
        row = _mix(dst) % side
        out = (col * side + row) % p
    elif strategy == "random_vertex_cut":
        out = _mix(_mul_u32(src, 0x9E3779B1) ^ dst) % p
    elif strategy == "canonical_random_vertex_cut":
        lo = torch.minimum(src, dst)
        hi = torch.maximum(src, dst)
        out = _mix(_mul_u32(lo, 0x9E3779B1) ^ hi) % p
    else:
        raise ValueError(
            "strategy must be edge_1d / edge_2d / random_vertex_cut / "
            "canonical_random_vertex_cut"
        )
    return out.to(torch.int32)

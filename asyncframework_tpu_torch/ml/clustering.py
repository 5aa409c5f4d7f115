"""k-means and its variants as rank-parallel Lloyd iterations.

Counterpart of ``asyncframework_tpu/ml/clustering.py`` (parity:
``mllib/.../clustering/KMeans.scala`` -- k-means++-style seeding, the Lloyd
loop, ``computeCost``; ``BisectingKMeans.scala``;
``StreamingKMeans.scala``'s forgetful update; ``PowerIterationClustering.
scala``).  A Lloyd step is, per rank, the distances through the
expanded-norm product, the argmin, and the per-centre sums and counts as
a one-hot product; the partials fold over the mesh's ``dp`` axis in rank
order.  The products stay plain, as the JAX package's are XLA's.

k-means++ seeding runs on a host subsample of at most 50,000 rows drawn
with ``numpy.random.default_rng(seed)``, exactly as in the JAX package,
so both seed the same centres from the same rows; with ``X`` on a device
only the sampled rows cross to the host.  The squared row norms of ``X``
are taken once a fit, a block of rows at a time, so no temporary the size
of ``X`` is made.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asyncframework_tpu_torch.ml.stat import on_device
from asyncframework_tpu_torch.ops.collectives import psum_over_mesh
from asyncframework_tpu_torch.parallel.mesh import make_mesh, pad_and_shard
from asyncframework_tpu_torch.utils.devices import resolve_devices

#: rows a block when the squared row norms are taken
NORM_BLOCK_ROWS = 1 << 20


def _pairwise_d2(X, centers, x2=None):
    """Squared euclidean distances (n, k) through the expanded-norm
    product -- the one assignment form the Lloyd steps, the streaming
    update and prediction share (numpy arrays or tensors alike); ``x2``,
    the rows' squared norms, when known."""
    if x2 is None:
        x2 = (X * X).sum(1)
    # 2 (X C^T), not (2 X) C^T: the same numbers (a power of two), and
    # no scaled copy of X
    return (x2[:, None] - 2.0 * (X @ centers.T)
            + (centers * centers).sum(1)[None, :])


def _row_norms(X: torch.Tensor) -> torch.Tensor:
    """``(X * X).sum(1)``, a block of rows at a time."""
    return torch.cat([(b * b).sum(1) for b in torch.split(X, NORM_BLOCK_ROWS)]
                     ) if X.shape[0] else X.new_zeros(0)


def _assign_sums(X, centers, x2=None, valid=None):
    """Per centre ``(sum of the assigned rows, count)`` and the summed
    squared distance to the nearest centre, over the rows ``valid``
    weights: a one-hot product."""
    d2 = _pairwise_d2(X, centers, x2)
    onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1),
                                         centers.shape[0]).to(X.dtype)
    nearest = torch.amin(d2, dim=1)
    if valid is not None:
        onehot = onehot * valid[:, None]
        nearest = nearest * valid
    return onehot.T @ X, onehot.sum(0), torch.sum(nearest)


class KMeansModel:
    def __init__(self, centers: np.ndarray, cost: float, iterations: int):
        self.centers = centers
        self.cost = cost  # computeCost parity: sum of squared distances
        self.iterations = iterations

    @property
    def k(self) -> int:
        return self.centers.shape[0]

    def predict(self, X):
        """Nearest centre of each row: on a tensor's device, or on the
        host."""
        if isinstance(X, torch.Tensor):
            c = torch.as_tensor(self.centers, device=X.device)
            return torch.argmin(_pairwise_d2(X.float(), c), dim=1)
        return np.argmin(_pairwise_d2(X, self.centers), axis=1)


class KMeans:
    def __init__(
        self,
        k: int,
        max_iterations: int = 20,
        tol: float = 1e-4,
        seed: int = 42,
        init: str = "k-means++",
    ):
        if init not in ("k-means++", "random"):
            raise ValueError(f"unknown init {init!r}")
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.init = init

    # ------------------------------------------------------------------ init
    def _seed_centers(self, X) -> np.ndarray:
        """k-means++ seeding on a host subsample (the reference's k-means||
        parallel seeding exists to avoid scanning a giant RDD k times; a
        bounded subsample has the same O(1)-pass property)."""
        rs = np.random.default_rng(self.seed)
        pick = rs.choice(X.shape[0], min(X.shape[0], 50_000), replace=False)
        if isinstance(X, torch.Tensor):
            sub = X[torch.from_numpy(pick).to(X.device)].float().cpu().numpy()
        else:
            sub = X[pick]
        if self.init == "random":
            idx = rs.choice(sub.shape[0], self.k, replace=False)
            return sub[idx].astype(np.float32)
        centers = [sub[rs.integers(sub.shape[0])]]
        d2 = ((sub - centers[0]) ** 2).sum(1)
        for _ in range(1, self.k):
            p = d2 / d2.sum() if d2.sum() > 0 else None
            centers.append(sub[rs.choice(sub.shape[0], p=p)])
            d2 = np.minimum(d2, ((sub - centers[-1]) ** 2).sum(1))
        return np.stack(centers).astype(np.float32)

    # ------------------------------------------------------------------ fit
    def fit(self, X, mesh=None) -> KMeansModel:
        """``X``: a host array or a tensor (read in place on the mesh's
        device where no padding is needed).  ``mesh`` defaults to every
        CUDA device (raises without one)."""
        mesh = mesh or make_mesh()
        Xt = (X.float() if isinstance(X, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(X, np.float32)))
        Xs, vs, _n = pad_and_shard(mesh, Xt)
        local = mesh.local_ranks()
        home = local[0]
        x2s = {r: _row_norms(Xs[r]) for r in local}

        def lloyd_step(centers: torch.Tensor):
            parts = [None] * mesh.size
            for r in local:
                parts[r] = _assign_sums(Xs[r], centers.to(Xs[r].device),
                                        x2s[r], vs[r])
            return tuple(psum_over_mesh([None if p is None else p[i]
                                         for p in parts], mesh, "dp")[home]
                         for i in range(3))

        centers = torch.from_numpy(self._seed_centers(Xt)).to(
            mesh.devices[home])
        it = 0
        for it in range(1, self.max_iterations + 1):
            sums, counts, _cost_prev = lloyd_step(centers)
            counts = torch.clamp_min(counts, 1e-9)[:, None]
            new_centers = sums / counts
            # empty clusters keep their previous center (MLlib behavior)
            new_centers = torch.where(counts > 0.5, new_centers, centers)
            shift = float(torch.sum((new_centers - centers) ** 2))
            centers = new_centers
            if shift < self.tol * self.tol:
                break
        # cost of the RETURNED centers (computeCost parity): one extra
        # assignment pass -- the in-loop cost is w.r.t. pre-update centers
        cost = lloyd_step(centers)[2]
        return KMeansModel(centers.cpu().numpy(), float(cost), it)


class BisectingKMeans:
    """Divisive hierarchical k-means.

    Parity: ``mllib/.../clustering/BisectingKMeans.scala`` -- from one root
    cluster, repeatedly 2-means-split the largest divisible cluster until
    ``k`` leaves exist; ``min_divisible_cluster_size`` gates which clusters
    may split.  Each split is a :class:`KMeans` fit on the member rows over
    ``mesh``; the hierarchy's bookkeeping stays on the host."""

    def __init__(
        self,
        k: int = 4,
        max_iterations: int = 20,
        min_divisible_cluster_size: int = 1,
        seed: int = 42,
    ):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.max_iterations = max_iterations
        self.min_divisible = max(int(min_divisible_cluster_size), 1)
        self.seed = seed

    def fit(self, X, mesh=None) -> KMeansModel:
        """``mesh`` (each split's fit) defaults to every CUDA device."""
        if isinstance(X, torch.Tensor):
            X = X.cpu().numpy()
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        root_center = X.mean(axis=0)
        root_cost = float(((X - root_center) ** 2).sum())
        # leaf: (member row indices, center, sse cost, divisible flag)
        leaves = [(np.arange(n), root_center, root_cost, True)]
        it = 0
        while len(leaves) < self.k:
            # split the largest divisible leaf (>= 2 rows, >= min size)
            order = sorted(
                range(len(leaves)),
                key=lambda i: len(leaves[i][0]),
                reverse=True,
            )
            target = next(
                (
                    i for i in order
                    if leaves[i][3]
                    and len(leaves[i][0]) >= max(2, self.min_divisible)
                ),
                None,
            )
            if target is None:
                break  # nothing divisible: the tree stops growing
            idx, _, _, _ = leaves.pop(target)
            sub = X[idx]
            km = KMeans(
                2,
                max_iterations=self.max_iterations,
                seed=self.seed + it,
            ).fit(sub, mesh)
            assign = km.predict(sub)
            it += 1
            if len(np.unique(assign)) < 2:
                # degenerate split (duplicate rows): keep the leaf, mark it
                # indivisible, and move on to the next candidate
                leaves.append((idx, km.centers[0], km.cost, False))
                continue
            for c in (0, 1):
                members = idx[assign == c]
                center = km.centers[c]
                cost = float(((X[members] - center) ** 2).sum())
                leaves.append((members, center, cost, True))
        centers = np.stack([c for (_i, c, _s, _d) in leaves]).astype(
            np.float32
        )
        return KMeansModel(
            centers, cost=float(sum(s for (_i, _c, s, _d) in leaves)),
            iterations=it,
        )


class StreamingKMeans:
    """Online k-means with exponential forgetfulness.

    Parity: ``StreamingKMeans.scala``'s update, per batch:

        c' = (c * n * a + sum_batch) / (n * a + m),   n' = n * a + m

    with the decay ``a`` applied per batch (``time_unit="batches"``) or as
    ``a^m`` (``"points"``); ``set_half_life`` derives ``a`` from a
    half-life.  Dying clusters (weight below 1e-8 of the heaviest) are
    re-seeded by splitting the heaviest.  Each batch's per-centre sums and
    counts are one one-hot product on ``device`` (the CUDA device by
    default; raises without one)."""

    def __init__(
        self,
        k: int,
        decay_factor: float = 1.0,
        time_unit: str = "batches",
        seed: int = 42,
        device=None,
    ):
        if time_unit not in ("batches", "points"):
            raise ValueError("time_unit must be 'batches' or 'points'")
        if not 0.0 < decay_factor <= 1.0:
            raise ValueError("decay_factor must be in (0, 1]")
        self.k = k
        self.decay = decay_factor
        self.time_unit = time_unit
        self.seed = seed
        self.device = resolve_devices(None if device is None else [device])[0]
        self.centers: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None

    def set_half_life(self, half_life: float,
                      time_unit: str) -> "StreamingKMeans":
        if time_unit not in ("batches", "points"):
            raise ValueError("time_unit must be 'batches' or 'points'")
        self.decay = float(np.exp(np.log(0.5) / half_life))
        self.time_unit = time_unit
        return self

    def set_initial_centers(self, centers, weights=None) -> "StreamingKMeans":
        self.centers = np.asarray(centers, np.float32)
        self.weights = (
            np.asarray(weights, np.float64)
            if weights is not None
            else np.zeros(self.centers.shape[0], np.float64)
        )
        return self

    def set_random_centers(self, d: int,
                           weight: float = 0.0) -> "StreamingKMeans":
        rs = np.random.default_rng(self.seed)
        self.centers = rs.normal(size=(self.k, d)).astype(np.float32)
        self.weights = np.full(self.k, weight, np.float64)
        return self

    def update(self, batch) -> "StreamingKMeans":
        if isinstance(batch, torch.Tensor):
            batch = batch.cpu().numpy()
        batch = np.asarray(batch, np.float32)
        if batch.ndim != 2 or batch.shape[0] == 0:
            return self
        if self.centers is None:
            self.set_random_centers(batch.shape[1])
        sums, counts, _cost = _assign_sums(
            on_device(batch, self.device), on_device(self.centers,
                                                     self.device))
        sums = sums.cpu().numpy().astype(np.float64)
        counts = counts.cpu().numpy().astype(np.float64)
        m = batch.shape[0]
        a = self.decay if self.time_unit == "batches" else self.decay ** m
        discounted = self.weights * a
        new_w = discounted + counts
        safe = np.maximum(new_w, 1e-12)
        updated = (
            (self.centers * discounted[:, None] + sums) / safe[:, None]
        ).astype(np.float32)
        # only centres that received points move: the reference updates
        # from pointStats entries only, so a zero-weight user-supplied
        # centre with no points stays where it was put
        self.centers = np.where((counts > 0)[:, None], updated, self.centers)
        self.weights = new_w
        # re-seed dying clusters: split the heaviest; relative threshold
        # as StreamingKMeans.scala (minWeight < 1e-8 * maxWeight)
        dead = self.weights < 1e-8 * self.weights.max()
        if dead.any() and (~dead).any():
            heavy = int(np.argmax(self.weights))
            for j in np.nonzero(dead)[0]:
                jitter = 1e-4 * np.abs(self.centers[heavy]).max()
                self.centers[j] = self.centers[heavy] + jitter
                self.centers[heavy] = self.centers[heavy] - jitter
                self.weights[j] = self.weights[heavy] / 2
                self.weights[heavy] /= 2
        return self

    def latest_model(self) -> KMeansModel:
        if self.centers is None:
            raise ValueError("no data seen yet")
        return KMeansModel(self.centers.copy(), cost=float("nan"),
                           iterations=0)

    def predict(self, X) -> np.ndarray:
        return self.latest_model().predict(np.asarray(X, np.float32))

    # -------------------------------------------------- DStream integration
    def train_on(self, dstream) -> "StreamingKMeans":
        """Update the model from every batch of a DStream
        (``StreamingKMeans.trainOn`` parity): registers an output op; the
        stream's clock drives the updates."""
        dstream.foreach_batch(lambda _t, b: self.update(np.asarray(b)))
        return self

    def predict_on(self, dstream):
        """Per-interval cluster assignments (``predictOn`` parity): a new
        DStream of label arrays using the model as of each interval."""
        return dstream.map_batch(
            lambda b: self.predict(np.asarray(b, np.float32))
        )


class PowerIterationClustering:
    """Clustering by power iteration on the normalized affinity matrix.

    Parity: ``PowerIterationClustering.scala`` (Lin & Cohen) -- iterate
    ``v <- W v / |W v|_1`` on the row-normalized affinities, then k-means
    the 1-d embedding.  The affinity is a dense (n, n) tensor on
    ``device`` and each iteration one product."""

    def __init__(self, k: int, max_iterations: int = 30, seed: int = 0,
                 device=None):
        if k < 2:
            raise ValueError("k must be >= 2")
        self.k = k
        self.max_iterations = max_iterations
        self.seed = seed
        self.device = device

    def fit_predict(self, affinity) -> np.ndarray:
        W = on_device(affinity, self.device)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError("affinity must be square (n, n)")
        if bool(torch.any(W < 0)):
            raise ValueError("affinities must be nonnegative")
        deg = torch.clamp_min(W.sum(dim=1, keepdim=True), 1e-12)
        Wn = W / deg  # row-normalized
        # init: degree-proportional vector (the reference's default)
        v = _pic_iterate(Wn, deg[:, 0] / torch.sum(deg), self.max_iterations)
        emb = v.cpu().numpy()[:, None]
        km = KMeans(self.k, seed=self.seed).fit(
            emb, make_mesh(1, devices=[W.device]))
        return np.asarray(km.predict(emb))


def _pic_iterate(Wn: torch.Tensor, v: torch.Tensor, iters: int):
    """Power iteration with the Lin & Cohen stopping rule: stop when the
    change of the step delta falls under 1e-5 / n (the reference's
    epsilon).  Wn is row-stochastic, so the fixed point is the uniform
    vector and the cluster signal lives in the transient: stopping early is
    the algorithm."""
    n = v.shape[0]
    eps = torch.tensor(1e-5, dtype=torch.float32) / n
    prev_delta = torch.tensor(float("inf"), device=v.device)
    for _ in range(iters):
        nv = Wn @ v
        nv = nv / torch.sum(torch.abs(nv))
        delta = torch.sum(torch.abs(nv - v))
        v = nv
        if bool(torch.abs(delta - prev_delta) < eps.to(v.device)):
            break
        prev_delta = delta
    return v

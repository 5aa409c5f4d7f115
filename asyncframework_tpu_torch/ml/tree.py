"""Decision trees: histogram-based, level-wise, device-batched.

Counterpart of ``asyncframework_tpu/ml/tree.py`` (parity:
``mllib/src/main/scala/org/apache/spark/mllib/tree/DecisionTree.scala`` --
the reference grows trees level by level; each level is one aggregation
job computing per-(node, feature, bin) statistics over binned features
(``findSplitsBins`` quantile binning, ``DTStatsAggregator``), then the
main process picks best splits by impurity gain).

- The split thresholds are numpy's quantiles on the host, exactly as the
  JAX package computes them (:func:`quantile_bins`), so both packages bin
  alike; the binning itself is one batched ``searchsorted`` on the device
  (``right=False``: ``np.searchsorted``'s ``'left'``).
- A level's histogram is one flat-index reduction on the device.  Class
  counts go through ``bincount``: exact and deterministic.  The regression
  statistics (count, sum, sum of squares) are summed as int64 fixed point
  (:func:`_fixed_point`): integer adds are exact in any order, so the
  histogram -- and with it every split -- does not depend on the order of
  atomics, and two fits of the same data grow the same tree on the card
  and on the CPU alike.  The histogram reaches the host as f32, the dtype
  of the JAX package's, for the split search.
- The split search over the (small) histogram and the tree bookkeeping
  stay on the host, the JAX package's numpy code.  Nodes live in a
  binary-heap layout (root 0, children 2i+1 / 2i+2), so the sample ->
  node update is one gather and ``where`` a level on the device.

Fits run on ``device`` (the CUDA device by default; raises without one).
A model predicts on a tensor's device, or on the host for a host array.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ml.feature import host_array
from asyncframework_tpu_torch.ml.stat import on_device


def quantile_bins(X: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature split thresholds from quantiles (findSplitsBins parity).

    Returns (F, max_bins - 1) thresholds; feature value v falls in bin
    ``searchsorted(thresholds, v, 'left')`` (value <= threshold goes left).
    """
    X = np.asarray(X, np.float32)
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    thr = np.quantile(X, qs, axis=0).T.astype(np.float32)  # (F, B-1)
    return thr


def bin_features(X: torch.Tensor, thr: np.ndarray) -> torch.Tensor:
    """``(n, F)`` bin of each value of ``X`` (f32 on its device) against
    the thresholds ``thr`` (F, B-1): ``np.searchsorted(thr[f], x,
    'left')`` for every column at once."""
    t = torch.from_numpy(np.ascontiguousarray(thr)).to(X.device)
    return torch.searchsorted(t, X.T.contiguous(), right=False).T


def _fence(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work, so that a host clock times it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _class_histogram(bins, node_of, y, n_nodes: int, max_bins: int,
                     num_classes: int) -> torch.Tensor:
    """(n_nodes, F, B, C) int64 class counts in one ``bincount``."""
    F = bins.shape[1]
    f_idx = torch.arange(F, device=bins.device)[None, :]
    flat = ((node_of[:, None] * F + f_idx) * max_bins
            + bins) * num_classes + y[:, None]
    out = torch.bincount(flat.reshape(-1),
                         minlength=n_nodes * F * max_bins * num_classes)
    return out.reshape(n_nodes, F, max_bins, num_classes)


#: headroom of the fixed-point sums: no bucket's sum of scaled magnitudes
#: can reach 2^62
_FIXED_BITS = 62


def _fixed_point(v: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(q, shift)``: ``v`` (float64) as int64 ``q = round(v * 2^shift)``,
    ``shift`` the largest that keeps the sum of all ``|q|`` below 2^62, so
    any sum of a subset is exact in int64 whatever its order.  The quantum
    is ``2^-shift``, about ``max|v| / (n * 2^42)``."""
    n = max(int(v.numel()), 1)
    top = float(torch.max(torch.abs(v))) if v.numel() else 0.0
    if top == 0.0:
        return torch.zeros(v.shape, dtype=torch.int64, device=v.device), 0
    shift = _FIXED_BITS - math.ceil(math.log2(n)) - math.frexp(top)[1]
    shift = min(shift, 1000)  # 2^shift stays a finite float64
    return torch.round(v * math.ldexp(1.0, shift)).to(torch.int64), shift


def _reg_histogram(bins, node_of, y, n_nodes: int,
                   max_bins: int) -> torch.Tensor:
    """(n_nodes, F, B, 3) float64 [count, sum, sumsq] of the f32 rows'
    ``y`` and ``y * y`` (the JAX package's f32 stats), summed exactly in
    int64 fixed point: order-independent, hence deterministic."""
    n, F = bins.shape
    f_idx = torch.arange(F, device=bins.device)[None, :]
    flat = ((node_of[:, None] * F + f_idx) * max_bins + bins).reshape(-1)
    size = n_nodes * F * max_bins
    cols = [torch.bincount(flat, minlength=size).double()]
    for v in (y, y * y):
        q, shift = _fixed_point(v.double())
        acc = torch.zeros(size, dtype=torch.int64, device=bins.device)
        acc.index_add_(0, flat, q[:, None].expand(n, F).reshape(-1))
        cols.append(acc.double() * math.ldexp(1.0, -shift))
    return torch.stack(cols, dim=1).reshape(n_nodes, F, max_bins, 3)


def _gini(counts: np.ndarray) -> np.ndarray:
    """Gini impurity of (..., C) count stacks; 0 for empty."""
    total = counts.sum(-1, keepdims=True)
    p = counts / np.maximum(total, 1e-12)
    return (1.0 - (p * p).sum(-1)) * (total[..., 0] > 0)


@dataclass
class DecisionTreeModel:
    """Heap-layout arrays: node i's children are 2i+1 / 2i+2."""

    feature: np.ndarray    # (n_nodes,) split feature, -1 at leaves
    threshold: np.ndarray  # (n_nodes,) go left when x[f] <= thr
    prediction: np.ndarray # (n_nodes,) class id or regression mean
    depth: int
    task: str

    def _leaves(self, X):
        """The leaf of each row: on a tensor's device (one gather a
        level), or on the host for a host array."""
        if isinstance(X, torch.Tensor):
            X = X.float()
            dev = X.device
            feat = torch.from_numpy(np.asarray(self.feature, np.int64)).to(
                dev)
            thr = torch.from_numpy(np.asarray(self.threshold)).to(dev)
            node = torch.zeros(X.shape[0], dtype=torch.int64, device=dev)
            for _ in range(self.depth):
                f = feat[node]
                x = torch.gather(X, 1, torch.clamp_min(f, 0)[:, None])[:, 0]
                child = 2 * node + 1 + (x > thr[node]).long()
                node = torch.where(f < 0, node, child)
            return node
        X = np.asarray(X, np.float32)
        feat = np.asarray(self.feature, np.int64)
        node = np.zeros(X.shape[0], np.int64)
        rows = np.arange(X.shape[0])
        for _ in range(self.depth):
            f = feat[node]
            x = X[rows, np.maximum(f, 0)]
            child = 2 * node + 1 + (x > self.threshold[node])
            node = np.where(f < 0, node, child)
        return node

    def predict(self, X):
        """Class ids (int64) or regression means (f32): a tensor on
        ``X``'s device for a tensor, a host array for a host array."""
        node = self._leaves(X)
        if isinstance(node, torch.Tensor):
            pred = torch.from_numpy(np.asarray(self.prediction)).to(
                node.device)[node]
            return pred.long() if self.task == "classification" else pred
        out = np.asarray(self.prediction)[node]
        return out.astype(np.int64) if self.task == "classification" else out


class DecisionTree:
    """``DecisionTree.trainClassifier / trainRegressor`` analog."""

    def __init__(
        self,
        task: str = "classification",
        max_depth: int = 5,
        max_bins: int = 32,
        min_instances_per_node: int = 1,
        min_info_gain: float = 0.0,
        num_classes: Optional[int] = None,
        feature_subset: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        """``feature_subset``: consider only that many randomly drawn
        features PER NODE (random-forest mode; the reference's
        ``featureSubsetStrategy`` samples per node too).  ``device``: where
        the fit bins and aggregates (the CUDA device by default; raises
        without one).  After a fit, ``last_run`` holds its fenced seconds:
        the host copy, the host quantiles, the device binning, and per
        level the histogram (with its pull to the host) and the host split
        search."""
        if task not in ("classification", "regression"):
            raise ValueError("task must be classification or regression")
        if max_depth < 1 or max_bins < 2:
            raise ValueError("max_depth >= 1 and max_bins >= 2 required")
        self.task = task
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_node = min_instances_per_node
        self.min_gain = min_info_gain
        self.num_classes = num_classes
        self.feature_subset = feature_subset
        self.seed = seed
        self.device = device

    def fit(self, X, y) -> DecisionTreeModel:
        t0 = time.perf_counter()
        Xh = np.asarray(host_array(X), np.float32)
        Xd = on_device(X if isinstance(X, torch.Tensor) else Xh, self.device)
        t1 = time.perf_counter()
        thr_table = quantile_bins(Xh, self.max_bins)
        t2 = time.perf_counter()
        bins = bin_features(Xd, thr_table)
        _fence(bins.device)
        t3 = time.perf_counter()
        model = self.fit_binned(bins, thr_table, y)
        self.last_run = {"host_copy_s": t1 - t0, "quantile_s": t2 - t1,
                         "bin_s": t3 - t2, **self.last_run}
        return model

    def fit_binned(self, bins: torch.Tensor, thr_table: np.ndarray,
                   y) -> DecisionTreeModel:
        """Grow the tree from the binned rows (``bin_features`` of ``X``
        against ``thr_table``, on the fit's device)."""
        n, F = bins.shape
        dev = bins.device
        B = self.max_bins
        if self.task == "classification":
            y_dev = on_device(y, dev, torch.int32).long()
            C = self.num_classes or int(y_dev.max()) + 1
        else:
            y_dev = on_device(y, dev)

        max_nodes = 2 ** (self.max_depth + 1) - 1
        feature = np.full(max_nodes, -1, np.int32)
        threshold = np.zeros(max_nodes, np.float32)
        split_bin = np.zeros(max_nodes, np.int32)
        prediction = np.zeros(max_nodes, np.float32)
        node_of = torch.zeros(n, dtype=torch.int64, device=dev)

        rng = np.random.default_rng(self.seed)
        hist_s, split_s = [], []
        level_start, level_size = 0, 1
        for depth in range(self.max_depth + 1):
            n_nodes_total = level_start + level_size
            _fence(dev)
            t0 = time.perf_counter()
            if self.task == "classification":
                hist = _class_histogram(bins, node_of, y_dev, n_nodes_total,
                                        B, C)
            else:
                hist = _reg_histogram(bins, node_of, y_dev, n_nodes_total, B)
            hist = hist[level_start:].to(torch.float32).cpu().numpy()
            t1 = time.perf_counter()
            hist_s.append(t1 - t0)

            any_split = False
            for li in range(level_size):
                node = level_start + li
                h = hist[li]  # (F, B, C) or (F, B, 3)
                if self.task == "classification":
                    node_counts = h.sum(axis=(0, 1)) / F  # per-class
                    total = node_counts.sum()
                    prediction[node] = float(np.argmax(node_counts))
                    parent_imp = float(_gini(node_counts[None])[0])
                else:
                    node_stats = h.sum(axis=(0, 1)) / F  # [cnt, s, ss]
                    total = node_stats[0]
                    mean = node_stats[1] / max(total, 1e-12)
                    prediction[node] = float(mean)
                    parent_imp = float(
                        node_stats[2] / max(total, 1e-12) - mean**2
                    )
                if (
                    depth == self.max_depth
                    or total < 2 * self.min_node
                    or parent_imp <= 1e-12
                ):
                    continue  # stays a leaf (feature[node] == -1)

                # vectorized best-split search over (F, B-1) candidates
                left = np.cumsum(h, axis=1)[:, :-1]       # (F, B-1, S)
                if self.task == "classification":
                    right = h.sum(axis=1, keepdims=True) - left
                    nl = left.sum(-1)
                    nr = right.sum(-1)
                    child = (
                        nl * _gini(left) + nr * _gini(right)
                    ) / max(total, 1e-12)
                else:
                    right = h.sum(axis=1, keepdims=True) - left
                    nl, sl, ssl = left[..., 0], left[..., 1], left[..., 2]
                    nr, sr, ssr = right[..., 0], right[..., 1], right[..., 2]
                    vl = ssl / np.maximum(nl, 1e-12) - (
                        sl / np.maximum(nl, 1e-12)
                    ) ** 2
                    vr = ssr / np.maximum(nr, 1e-12) - (
                        sr / np.maximum(nr, 1e-12)
                    ) ** 2
                    child = (nl * vl + nr * vr) / max(total, 1e-12)
                gain = parent_imp - child
                ok = (nl >= self.min_node) & (nr >= self.min_node)
                gain = np.where(ok, gain, -np.inf)
                if self.feature_subset is not None and self.feature_subset < F:
                    allowed = rng.choice(F, self.feature_subset, replace=False)
                    mask = np.full(F, True)
                    mask[allowed] = False
                    gain[mask] = -np.inf
                f_best, b_best = np.unravel_index(
                    np.argmax(gain), gain.shape
                )
                if gain[f_best, b_best] <= self.min_gain:
                    continue
                feature[node] = f_best
                threshold[node] = thr_table[f_best, b_best]
                split_bin[node] = b_best
                any_split = True

            split_s.append(time.perf_counter() - t1)
            if not any_split:
                break
            # advance sample assignments through this level's splits
            feat_dev = torch.from_numpy(feature.astype(np.int64)).to(dev)
            b_of_split = torch.from_numpy(split_bin.astype(np.int64)).to(dev)
            f_of = feat_dev[node_of]
            sample_bin = torch.gather(
                bins, 1, torch.clamp_min(f_of, 0)[:, None])[:, 0]
            child = 2 * node_of + 1 + (sample_bin > b_of_split[node_of]).long()
            node_of = torch.where(f_of >= 0, child, node_of)
            level_start += level_size
            level_size *= 2

        self.last_run = {"histogram_s": hist_s, "split_search_s": split_s}
        return DecisionTreeModel(
            feature=feature,
            threshold=threshold,
            prediction=prediction,
            depth=self.max_depth,
            task=self.task,
        )

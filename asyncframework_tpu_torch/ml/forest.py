"""Random forests: bagged histogram trees.

Counterpart of ``asyncframework_tpu/ml/forest.py`` (parity:
``mllib/src/main/scala/org/apache/spark/mllib/tree/RandomForest.scala`` --
bootstrap-sampled training sets, per-tree feature subsampling
(``featureSubsetStrategy``), majority vote (classification) / mean
(regression)).

Each member is the port's histogram :class:`~.tree.DecisionTree`.  The
bootstrap rows and the per-node feature draws are numpy
``default_rng`` draws, as in the JAX package, so both grow the same forest
from the same seed; a bootstrap sample's thresholds are numpy's quantiles
of its host copy, its rows are gathered and binned on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from asyncframework_tpu_torch.ml.feature import host_array
from asyncframework_tpu_torch.ml.stat import on_device
from asyncframework_tpu_torch.ml.tree import (
    DecisionTree,
    DecisionTreeModel,
    bin_features,
    quantile_bins,
)


@dataclass
class RandomForestModel:
    trees: List[DecisionTreeModel]
    task: str
    num_classes: int

    def predict(self, X):
        """Majority vote (ties to the lowest class) or mean: a tensor on
        ``X``'s device for a tensor, a host array for a host array."""
        if isinstance(X, torch.Tensor):
            votes = [t.predict(X) for t in self.trees]
            if self.task == "regression":
                return torch.stack(votes).mean(dim=0)
            counts = torch.zeros((X.shape[0], self.num_classes),
                                 dtype=torch.int32, device=X.device)
            for v in votes:
                counts.scatter_add_(1, v[:, None], torch.ones_like(
                    counts[:, :1]))
            return counts.argmax(dim=1)
        X = np.asarray(X, np.float32)
        votes = [t.predict(X) for t in self.trees]
        stack = np.stack(votes)
        if self.task == "regression":
            return stack.mean(axis=0)
        # majority vote via per-row bincount
        counts = np.zeros((X.shape[0], self.num_classes), np.int32)
        rows = np.arange(X.shape[0])
        for v in votes:
            counts[rows, v.astype(np.int64)] += 1
        return counts.argmax(axis=1)


class RandomForest:
    """``RandomForest.trainClassifier / trainRegressor`` analog; fits on
    ``device`` (the CUDA device by default; raises without one)."""

    def __init__(
        self,
        task: str = "classification",
        num_trees: int = 10,
        max_depth: int = 5,
        max_bins: int = 32,
        feature_subset_strategy: str = "auto",
        seed: int = 0,
        num_classes: Optional[int] = None,
        device=None,
    ):
        if num_trees < 1:
            raise ValueError("num_trees must be >= 1")
        self.task = task
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.strategy = feature_subset_strategy
        self.seed = seed
        self.num_classes = num_classes
        self.device = device

    def _subset_size(self, F: int) -> int:
        # featureSubsetStrategy defaults: sqrt for classification,
        # one-third for regression ("auto" in the reference)
        if self.strategy == "all":
            return F
        if self.strategy == "sqrt":
            return max(1, int(np.sqrt(F)))
        if self.strategy == "onethird":
            return max(1, F // 3)
        if self.strategy == "auto":
            return (
                max(1, int(np.sqrt(F)))
                if self.task == "classification"
                else max(1, F // 3)
            )
        raise ValueError("feature_subset_strategy: auto/all/sqrt/onethird")

    def fit(self, X, y) -> RandomForestModel:
        Xh = np.asarray(host_array(X), np.float32)
        Xd = on_device(X if isinstance(X, torch.Tensor) else Xh, self.device)
        yh = host_array(y)
        y_dev = on_device(y, Xd.device, torch.float64)
        n, F = Xh.shape
        m = self._subset_size(F)
        rs = np.random.default_rng(self.seed)
        if self.task == "classification":
            C = self.num_classes or int(yh.max()) + 1
        else:
            C = 0
        trees: List[DecisionTreeModel] = []
        for t_idx in range(self.num_trees):
            rows = rs.integers(0, n, n)           # bootstrap sample
            rows_dev = torch.from_numpy(rows).to(Xd.device)
            thr = quantile_bins(Xh[rows], self.max_bins)
            tree = DecisionTree(
                task=self.task,
                max_depth=self.max_depth,
                max_bins=self.max_bins,
                num_classes=C or None,
                feature_subset=m if m < F else None,  # per-NODE sampling
                seed=self.seed + 1000 * t_idx,
                device=Xd.device,
            ).fit_binned(bin_features(Xd[rows_dev], thr), thr,
                         y_dev[rows_dev])
            trees.append(tree)
        return RandomForestModel(trees=trees, task=self.task, num_classes=C)

"""Gradient-boosted trees.

Counterpart of ``asyncframework_tpu/ml/boosting.py`` (parity:
``mllib/src/main/scala/org/apache/spark/mllib/tree/
GradientBoostedTrees.scala`` -- sequential stages of regression trees fit
to the loss gradient (squared error: residuals; logistic: the +-1 margin
formulation's residuals), combined with a learning rate; classification
margins thresholded at 0).

Every stage is the port's histogram tree on the fit's device.  The stages
share one binning: the rows do not change between stages, so their
quantile thresholds (the JAX package recomputes the same ones a stage) and
bins are computed once.  The running margin and the residuals are f32
tensors on the device, updated elementwise as the JAX package's numpy
arrays are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

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
class GradientBoostedTreesModel:
    trees: List[DecisionTreeModel]
    learning_rate: float
    init_value: float
    task: str

    def raw_predict(self, X):
        """The f32 margins: a tensor on ``X``'s device for a tensor, a host
        array for a host array (the same f32 operations in the same
        order)."""
        if isinstance(X, torch.Tensor):
            out = torch.full((X.shape[0],), self.init_value,
                             dtype=torch.float32, device=X.device)
            for t in self.trees:
                out += self.learning_rate * t.predict(X).to(torch.float32)
            return out
        X = np.asarray(X, np.float32)
        out = np.full(X.shape[0], self.init_value, np.float32)
        for t in self.trees:
            out += self.learning_rate * t.predict(X).astype(np.float32)
        return out

    def predict(self, X):
        raw = self.raw_predict(X)
        if self.task == "classification":
            return ((raw >= 0.0).long() if isinstance(raw, torch.Tensor)
                    else (raw >= 0.0).astype(np.int64))
        return raw


class GradientBoostedTrees:
    """``GradientBoostedTrees.train`` analog; fits on ``device`` (the CUDA
    device by default; raises without one).

    ``task='regression'``: squared-error boosting (stages fit residuals).
    ``task='classification'``: binary labels {0,1} via logistic loss on the
    +-1 margin formulation, like the reference's ``LogLoss``.
    """

    def __init__(
        self,
        task: str = "regression",
        num_iterations: int = 20,
        learning_rate: float = 0.1,
        max_depth: int = 3,
        max_bins: int = 32,
        device=None,
    ):
        if task not in ("regression", "classification"):
            raise ValueError("task must be regression or classification")
        if not 0 < learning_rate <= 1:
            raise ValueError("learning_rate must be in (0, 1]")
        self.task = task
        self.num_iterations = num_iterations
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.device = device

    def fit(self, X, y) -> GradientBoostedTreesModel:
        Xh = np.asarray(host_array(X), np.float32)
        Xd = on_device(X if isinstance(X, torch.Tensor) else Xh, self.device)
        # the label statistics on the host copy, as the JAX package takes
        # them (numpy's f32 mean)
        yh = np.asarray(host_array(y), np.float32)
        if self.task == "regression":
            target = on_device(yh, Xd.device)
            init = float(yh.mean())
        else:
            if not set(np.unique(yh)) <= {0.0, 1.0}:
                raise ValueError("classification labels must be {0, 1}")
            y_pm = on_device(2.0 * yh - 1.0, Xd.device)  # {-1, +1} margins
            p = float(yh.mean())
            p = min(max(p, 1e-6), 1 - 1e-6)
            init = float(np.log(p / (1 - p)) / 2.0)

        thr = quantile_bins(Xh, self.max_bins)
        bins = bin_features(Xd, thr)
        raw = torch.full((Xh.shape[0],), init, dtype=torch.float32,
                         device=Xd.device)
        trees: List[DecisionTreeModel] = []
        for _ in range(self.num_iterations):
            if self.task == "regression":
                grad = target - raw  # negative gradient of squared error
            else:
                # -dLogLoss/draw for the +-1 formulation:
                # 2y / (1 + exp(2 y raw))
                grad = 2.0 * y_pm / (1.0 + torch.exp(2.0 * y_pm * raw))
            stage = DecisionTree(
                task="regression",
                max_depth=self.max_depth,
                max_bins=self.max_bins,
                device=Xd.device,
            ).fit_binned(bins, thr, grad)
            trees.append(stage)
            raw = raw + self.learning_rate * stage.predict(Xd)
        return GradientBoostedTreesModel(
            trees=trees,
            learning_rate=self.learning_rate,
            init_value=init,
            task=self.task,
        )

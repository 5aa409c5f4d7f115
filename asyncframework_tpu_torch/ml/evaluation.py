"""Evaluation metrics.

Counterpart of ``asyncframework_tpu/ml/evaluation.py`` (parity:
``mllib/src/main/scala/org/apache/spark/mllib/evaluation/`` --
``BinaryClassificationMetrics.scala`` (ROC/AUC/PR by score thresholds),
``RegressionMetrics.scala``, ``MulticlassMetrics.scala`` (confusion-matrix
derived precision/recall/F1), ``RankingMetrics.scala`` and
``MultilabelMetrics.scala``).

A binary metric is a stable sort by score on a device, cumulative TP/FP
counts (float64, exact to 2^53 rows) and the tie collapse there; the
trapezoids over the collapsed curve run on the host.  The regression sums
are one float64 pass; the confusion matrix is one ``bincount`` of
``label * k + prediction``.  Ranking and multi-label metrics are the JAX
package's host-side Python over short ragged lists.

Each metric runs on the device of the tensors it is given, or on
``device`` (the CUDA device by default; raises without one) for host
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ml.stat import on_device


def device_for(device, *arrays) -> Optional[torch.device]:
    """``device`` if given, else the device of the first tensor among
    ``arrays``; None (the CUDA device, through :func:`on_device`) when
    every one is a host array."""
    if device is not None:
        return device
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


# ---------------------------------------------------------------- binary
def _roc_points(scores: torch.Tensor, labels: torch.Tensor):
    """Sorted-by-score-descending cumulative TP/FP counts (a stable sort:
    tied scores keep their input order, as ``jnp.argsort``'s do)."""
    order = torch.argsort(-scores, stable=True)
    y = labels[order].double()
    return torch.cumsum(y, 0), torch.cumsum(1.0 - y, 0), scores[order]


class BinaryClassificationMetrics:
    """AUC-ROC / AUC-PR / curves from (score, label in {0,1}) pairs.

    Ties in scores are handled like the reference: threshold points are
    taken at distinct score boundaries, so tied scores move as one block.
    """

    def __init__(self, scores, labels, device=None):
        dev = device_for(device, scores, labels)
        scores = on_device(scores, dev)
        labels = on_device(labels, scores.device)
        if scores.shape != labels.shape:
            raise ValueError("scores and labels must have the same shape")
        self._n = int(scores.shape[0])
        tp, fp, s = _roc_points(scores, labels)
        # collapse tied scores: keep the LAST cumulative point of each block
        is_boundary = torch.ones(self._n, dtype=torch.bool,
                                 device=scores.device)
        if self._n > 1:
            is_boundary[:-1] = s[:-1] != s[1:]
        self._tp = tp[is_boundary].cpu().numpy()
        self._fp = fp[is_boundary].cpu().numpy()
        self._thresholds = s[is_boundary].cpu().numpy()
        self._p = float(self._tp[-1]) if self._n else 0.0
        self._neg = float(self._fp[-1]) if self._n else 0.0

    def roc(self) -> Tuple[np.ndarray, np.ndarray]:
        """(fpr, tpr) points, starting at (0,0) and ending at (1,1)."""
        tpr = np.concatenate([[0.0], self._tp / max(self._p, 1e-12)])
        fpr = np.concatenate([[0.0], self._fp / max(self._neg, 1e-12)])
        return fpr, tpr

    def area_under_roc(self) -> float:
        fpr, tpr = self.roc()
        return float(np.trapezoid(tpr, fpr))

    def pr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(recall, precision) points; first point (0, p0) like the
        reference (precision of the highest-score block)."""
        recall = self._tp / max(self._p, 1e-12)
        precision = self._tp / np.maximum(self._tp + self._fp, 1e-12)
        return (
            np.concatenate([[0.0], recall]),
            np.concatenate([[precision[0] if len(precision) else 1.0],
                            precision]),
        )

    def area_under_pr(self) -> float:
        recall, precision = self.pr()
        return float(np.trapezoid(precision, recall))

    def thresholds(self) -> np.ndarray:
        return self._thresholds


# ------------------------------------------------------------- regression
def _regression_sums(pred: torch.Tensor, y: torch.Tensor):
    err = pred - y
    sums = torch.stack([torch.sum(err * err), torch.sum(torch.abs(err)),
                        torch.sum(y), torch.sum(y * y), torch.sum(err)])
    return sums.cpu().tolist()


@dataclass(frozen=True)
class RegressionMetrics:
    """mse / rmse / mae / r2 / explained variance over (pred, label)."""

    mean_squared_error: float
    root_mean_squared_error: float
    mean_absolute_error: float
    r2: float
    explained_variance: float

    @classmethod
    def of(cls, predictions, labels, device=None) -> "RegressionMetrics":
        """The sums in float64 (f32 inputs widened) on the inputs'
        device."""
        dev = device_for(device, predictions, labels)
        pred = on_device(predictions, dev).double()
        y = on_device(labels, pred.device).double()
        n = y.shape[0]
        sse, sae, sy, syy, serr = _regression_sums(pred, y)
        mse = sse / n
        var_y = syy / n - (sy / n) ** 2
        # explained variance: Var(y) - Var(err) (the reference's definition)
        var_err = sse / n - (serr / n) ** 2
        return cls(
            mean_squared_error=mse,
            root_mean_squared_error=float(np.sqrt(mse)),
            mean_absolute_error=sae / n,
            r2=1.0 - sse / max(n * var_y, 1e-12),
            explained_variance=var_y - var_err,
        )


# -------------------------------------------------------------- multiclass
class MulticlassMetrics:
    """Confusion-matrix metrics over (prediction, label) integer pairs."""

    def __init__(self, predictions, labels, num_classes: Optional[int] = None,
                 device=None):
        dev = device_for(device, predictions, labels)
        pred = on_device(predictions, dev, torch.int64)
        y = on_device(labels, pred.device, torch.int64)
        k = num_classes or int(max(
            int(pred.max()) if pred.numel() else 0,
            int(y.max()) if y.numel() else 0)) + 1
        cm = torch.bincount(y * k + pred, minlength=k * k)
        self.confusion = cm.reshape(k, k).cpu().numpy()
        self._k = k
        self._n = int(y.shape[0])

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.confusion)) / max(self._n, 1)

    def precision(self, label: int) -> float:
        col = self.confusion[:, label].sum()
        return float(self.confusion[label, label]) / max(col, 1)

    def recall(self, label: int) -> float:
        row = self.confusion[label, :].sum()
        return float(self.confusion[label, label]) / max(row, 1)

    def f1(self, label: int) -> float:
        p, r = self.precision(label), self.recall(label)
        return 2 * p * r / max(p + r, 1e-12)

    def weighted_f1(self) -> float:
        weights = self.confusion.sum(axis=1) / max(self._n, 1)
        return float(sum(w * self.f1(i) for i, w in enumerate(weights)))


class RankingMetrics:
    """Ranking quality over (predicted ranking, ground-truth set) pairs.

    Parity: ``mllib/src/main/scala/org/apache/spark/mllib/evaluation/
    RankingMetrics.scala`` -- precisionAt(k), meanAveragePrecision, and
    ndcgAt(k) with the reference's exact conventions: predictions beyond
    position k are ignored, queries with empty ground truth contribute 0
    (and log a warning there; silently here), relevance is binary, and
    the IDCG normalizer uses min(|truth|, k) ideal hits.

    Host-side: rankings are short, ragged integer lists; there is no dense
    kernel to win on device.
    """

    def __init__(self, prediction_and_labels):
        self._pairs = [
            (list(pred), set(truth)) for pred, truth in prediction_and_labels
        ]
        if not self._pairs:
            raise ValueError("no (prediction, labels) pairs")

    def precision_at(self, k: int) -> float:
        if k < 1:
            raise ValueError("k must be >= 1")
        vals = []
        for pred, truth in self._pairs:
            top = pred[:k]
            hits = sum(1 for p in top if p in truth)
            # reference divides by k even when fewer predictions exist
            vals.append(hits / k)
        return float(np.mean(vals))

    def mean_average_precision(self) -> float:
        vals = []
        for pred, truth in self._pairs:
            if not truth:
                vals.append(0.0)
                continue
            hits = 0
            score = 0.0
            # duplicate predictions each count (reference semantics:
            # RankingMetrics.scala scans positions, not distinct items)
            for i, p in enumerate(pred):
                if p in truth:
                    hits += 1
                    score += hits / (i + 1.0)
            vals.append(score / len(truth))
        return float(np.mean(vals))

    def ndcg_at(self, k: int) -> float:
        if k < 1:
            raise ValueError("k must be >= 1")
        vals = []
        for pred, truth in self._pairs:
            if not truth:
                vals.append(0.0)
                continue
            n = min(k, len(pred))
            dcg = sum(
                1.0 / np.log2(i + 2.0)
                for i in range(n) if pred[i] in truth
            )
            ideal = sum(
                1.0 / np.log2(i + 2.0) for i in range(min(len(truth), k))
            )
            vals.append(dcg / ideal)
        return float(np.mean(vals))


class MultilabelMetrics:
    """Multi-label classification metrics over (predicted set, true set)
    pairs.

    Parity: ``mllib/.../evaluation/MultilabelMetrics.scala`` -- document-
    averaged accuracy/precision/recall/F1, subset accuracy, Hamming loss,
    and micro-averaged precision/recall/F1 over the label universe.
    """

    def __init__(self, prediction_and_labels):
        self._pairs = [
            (set(pred), set(truth)) for pred, truth in prediction_and_labels
        ]
        if not self._pairs:
            raise ValueError("no (prediction, labels) pairs")
        # label universe from GROUND TRUTH only (MultilabelMetrics.scala
        # derives numLabels from the label sets; counting predicted-only
        # labels would deflate hamming_loss)
        self._labels = sorted({x for _p, t in self._pairs for x in t})

    @property
    def accuracy(self) -> float:
        return float(np.mean([
            len(p & t) / max(len(p | t), 1) for p, t in self._pairs
        ]))

    @property
    def precision(self) -> float:
        return float(np.mean([
            len(p & t) / len(p) if p else 0.0 for p, t in self._pairs
        ]))

    @property
    def recall(self) -> float:
        return float(np.mean([
            len(p & t) / len(t) if t else 0.0 for p, t in self._pairs
        ]))

    @property
    def f1_measure(self) -> float:
        return float(np.mean([
            2.0 * len(p & t) / (len(p) + len(t))
            if (p or t) else 0.0
            for p, t in self._pairs
        ]))

    @property
    def subset_accuracy(self) -> float:
        return float(np.mean([p == t for p, t in self._pairs]))

    @property
    def hamming_loss(self) -> float:
        n_labels = max(len(self._labels), 1)
        return float(np.mean([
            len(p ^ t) / n_labels for p, t in self._pairs
        ]))

    @property
    def micro_precision(self) -> float:
        tp = sum(len(p & t) for p, t in self._pairs)
        fp = sum(len(p - t) for p, t in self._pairs)
        return tp / max(tp + fp, 1)

    @property
    def micro_recall(self) -> float:
        tp = sum(len(p & t) for p, t in self._pairs)
        fn = sum(len(t - p) for p, t in self._pairs)
        return tp / max(tp + fn, 1)

    @property
    def micro_f1_measure(self) -> float:
        p, r = self.micro_precision, self.micro_recall
        return 2 * p * r / max(p + r, 1e-12)

"""Pipelines and model selection.

Counterpart of ``asyncframework_tpu/ml/pipeline.py`` (parity: the spark.ml
composition layer the reference ships alongside mllib -- Spark 2.3's
``ml/Pipeline.scala``: an ordered list of transformers ending in an
estimator, fit as a unit -- and ``ml/tuning/CrossValidator.scala``: k-fold
selection over a parameter grid with a metric).

Protocol (duck-typed like the reference's Params):
- transformer stages expose ``transform(X)`` (and optionally ``fit(X)`` for
  fitted transformers like scalers / IDF);
- the FINAL stage is an estimator exposing ``fit(X, y) -> model`` whose
  model exposes ``predict(X)``.

Device tensors pass from stage to stage unconverted.  ``train_test_split``
and ``CrossValidator`` draw their permutations from numpy's
``default_rng(seed)``, as the JAX package does, so both split alike; a
tensor's rows are gathered on its device (a CUDA tensor never round-trips
through the host), a host array's on the host.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def _needs_labels(fit) -> bool:
    """True when a stage's fit requires more than one positional argument
    (estimator-style fit(X, y)); signature inspection, not try/except --
    swallowing a TypeError raised INSIDE fit would mask real errors."""
    import inspect

    try:
        params = [
            p for p in inspect.signature(fit).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
    except (TypeError, ValueError):  # builtins without signatures
        return False
    required = [p for p in params if p.default is inspect.Parameter.empty]
    return len(required) > 1


def _fit_transform(stage, X):
    """Fit a transformer stage if it is fittable, then transform.

    Stage outputs pass through UNCONVERTED: transformers hand device arrays
    to the next stage directly (an np.asarray here would round-trip the full
    matrix through the host per stage)."""
    if hasattr(stage, "fit") and not _needs_labels(stage.fit):
        fitted = stage.fit(X)
        # scalers return self; IDF returns a model -- use whichever object
        # carries transform
        stage = fitted if hasattr(fitted, "transform") else stage
    return stage, stage.transform(X)


@dataclass
class PipelineModel:
    transformers: List[Any]
    model: Any

    def _apply(self, X):
        for t in self.transformers:
            X = t.transform(X)  # device arrays pass through stage to stage
        return X

    def predict(self, X) -> np.ndarray:
        return self.model.predict(self._apply(X))


class Pipeline:
    """``Pipeline(stages=[...]).fit(X, y)`` analog."""

    def __init__(self, stages: Sequence[Any]):
        if not stages:
            raise ValueError("a pipeline needs at least one stage")
        self.stages = list(stages)

    def fit(self, X, y=None) -> PipelineModel:
        fitted: List[Any] = []
        for stage in self.stages[:-1]:
            if not hasattr(stage, "transform"):
                raise TypeError(
                    f"intermediate stage {type(stage).__name__} has no "
                    "transform(); only the final stage may be an estimator"
                )
            stage, X = _fit_transform(stage, X)
            fitted.append(stage)
        last = self.stages[-1]
        if hasattr(last, "fit") and y is not None:
            model = last.fit(X, y)
        elif hasattr(last, "fit"):
            model = last.fit(X)
        else:
            raise TypeError("the final pipeline stage must expose fit()")
        return PipelineModel(transformers=fitted, model=model)


def _rows(A, idx: np.ndarray):
    """Rows ``idx`` of ``A``: gathered on a tensor's device, or from the
    host array."""
    if isinstance(A, torch.Tensor):
        return A[torch.from_numpy(idx).to(A.device)]
    return np.asarray(A)[idx]


def train_test_split(
    X, y, test_fraction: float = 0.25, seed: int = 42
) -> Tuple[Any, Any, Any, Any]:
    """``randomSplit`` analog for supervised fixtures: ``(X_train,
    y_train, X_test, y_test)``, each a tensor on its input's device or a
    host array."""
    if not 0.0 < test_fraction < 1.0:
        raise ValueError("test_fraction must be in (0, 1)")
    rs = np.random.default_rng(seed)
    perm = rs.permutation(len(X))
    cut = int(round(len(X) * (1.0 - test_fraction)))
    if cut == 0 or cut == len(X):
        raise ValueError(
            f"test_fraction={test_fraction} leaves an empty partition for "
            f"{len(X)} rows"
        )
    tr, te = perm[:cut], perm[cut:]
    return _rows(X, tr), _rows(y, tr), _rows(X, te), _rows(y, te)


@dataclass
class CrossValidatorModel:
    best_params: Dict[str, Any]
    best_score: float
    best_model: Any
    all_scores: List[Tuple[Dict[str, Any], float]]

    def predict(self, X) -> np.ndarray:
        return self.best_model.predict(X)


class CrossValidator:
    """k-fold selection over a parameter grid.

    ``estimator_factory(**params)`` builds a fresh estimator per candidate;
    ``scorer(model, X_val, y_val) -> float`` (higher is better).  Parity:
    ``ml/tuning/CrossValidator.scala`` (sequential folds; the reference
    parallelizes fits across the cluster, here each fit is already a device
    program).
    """

    def __init__(
        self,
        estimator_factory: Callable[..., Any],
        param_grid: Dict[str, Sequence[Any]],
        scorer: Callable[[Any, np.ndarray, np.ndarray], float],
        num_folds: int = 3,
        seed: int = 42,
    ):
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        if not param_grid:
            raise ValueError("param_grid must name at least one parameter")
        self.factory = estimator_factory
        self.grid = dict(param_grid)
        self.scorer = scorer
        self.num_folds = num_folds
        self.seed = seed

    def _candidates(self) -> List[Dict[str, Any]]:
        names = sorted(self.grid)
        return [
            dict(zip(names, combo))
            for combo in itertools.product(*(self.grid[n] for n in names))
        ]

    def fit(self, X, y) -> CrossValidatorModel:
        """``X``/``y``: tensors (each fold's rows gathered on their
        device) or host arrays."""
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        if len(X) < self.num_folds:
            raise ValueError(
                f"{self.num_folds}-fold CV needs at least that many rows; "
                f"got {len(X)} (an empty fold would score NaN)"
            )
        rs = np.random.default_rng(self.seed)
        perm = rs.permutation(len(X))
        folds = np.array_split(perm, self.num_folds)
        results: List[Tuple[Dict[str, Any], float]] = []
        for params in self._candidates():
            scores = []
            for i in range(self.num_folds):
                val = folds[i]
                trn = np.concatenate(
                    [folds[j] for j in range(self.num_folds) if j != i]
                )
                model = self.factory(**params).fit(_rows(X, trn),
                                                   _rows(y, trn))
                scores.append(float(self.scorer(model, _rows(X, val),
                                                _rows(y, val))))
            results.append((params, float(np.mean(scores))))
        valid = [r for r in results if not np.isnan(r[1])]
        if not valid:
            raise ValueError(
                "every candidate scored NaN (scorer undefined on these "
                "folds, e.g. constant-target validation splits)"
            )
        best_params, best_score = max(valid, key=lambda r: r[1])
        best_model = self.factory(**best_params).fit(X, y)  # refit on all
        return CrossValidatorModel(
            best_params=best_params,
            best_score=best_score,
            best_model=best_model,
            all_scores=results,
        )


def accuracy_scorer(model, X, y) -> float:
    """The share of rows whose prediction equals the label: on the
    prediction's device when either is a tensor, else on the host."""
    pred = model.predict(X)
    if isinstance(pred, torch.Tensor) or isinstance(y, torch.Tensor):
        dev = (pred if isinstance(pred, torch.Tensor) else y).device
        pred, y = (torch.as_tensor(a, device=dev) for a in (pred, y))
        return float((pred == y).double().mean())
    return float((np.asarray(pred) == np.asarray(y)).mean())


def r2_scorer(model, X, y) -> float:
    from asyncframework_tpu_torch.ml.evaluation import RegressionMetrics

    return RegressionMetrics.of(model.predict(X), y).r2

"""Linear model wrappers over the optimizers.

Counterpart of ``asyncframework_tpu/ml/models.py`` (parity:
``mllib/.../regression/LinearRegression.scala``, whose fork surfaces the
weight trajectory at :178-183, ``LogisticRegressionWithSGD`` and
``SVMWithSGD`` through ``GeneralizedLinearAlgorithm.scala:318-320``):
training runs the optimizer on the (optionally intercept-augmented) design
matrix and wraps the weights in a typed model with ``predict``; the fork's
``getAllWeights`` is :attr:`LinearModel.weight_history`.

The models hold numpy fields, as the JAX package's do.  ``predict`` on a
host array runs on the host; on a tensor it runs on the tensor's device.
:class:`SoftmaxRegression` is a plain full-batch loop (two products an
iteration), as the JAX package's is XLA's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ml.gradient import (
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
)
from asyncframework_tpu_torch.ml.optimization import GradientDescent
from asyncframework_tpu_torch.parallel.mesh import as_rows
from asyncframework_tpu_torch.ml.updater import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
)
from asyncframework_tpu_torch.utils.devices import resolve_devices


def _augment(X, y, fit_intercept: bool):
    X, y = as_rows(X, y)
    if fit_intercept:
        X = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                     device=X.device)], dim=1)
    return X, y


class LinearModel:
    """weights + intercept + the training loss and weight trajectories."""

    def __init__(
        self,
        weights: np.ndarray,
        intercept: float,
        loss_history: np.ndarray,
        weight_history: List[Tuple[float, np.ndarray]],
    ):
        self.weights = weights
        self.intercept = intercept
        self.loss_history = loss_history
        self.weight_history = weight_history

    def margin(self, X):
        if isinstance(X, torch.Tensor):
            w = torch.as_tensor(self.weights, dtype=torch.float32,
                                device=X.device)
            return X.float() @ w + self.intercept
        return X @ self.weights + self.intercept

    def predict(self, X):
        return self.margin(X)


class _SGDEstimator:
    _gradient_cls = LeastSquaresGradient
    _default_updater = SimpleUpdater

    def __init__(
        self,
        step_size: float = 1.0,
        num_iterations: int = 100,
        reg_param: float = 0.0,
        mini_batch_fraction: float = 1.0,
        fit_intercept: bool = False,
        updater: str = "default",
        convergence_tol: float = 0.0,
        seed: int = 42,
        snapshot_every: int = 100,
    ):
        upd = {
            "default": self._default_updater(),
            "simple": SimpleUpdater(),
            "l1": L1Updater(),
            "l2": SquaredL2Updater(),
        }[updater]
        self.fit_intercept = fit_intercept
        self.optimizer = GradientDescent(
            gradient=self._gradient_cls(),
            updater=upd,
            step_size=step_size,
            num_iterations=num_iterations,
            reg_param=reg_param,
            mini_batch_fraction=mini_batch_fraction,
            convergence_tol=convergence_tol,
            seed=seed,
            snapshot_every=snapshot_every,
        )

    def _make_model(self, w_aug: np.ndarray, losses: np.ndarray) -> LinearModel:
        if self.fit_intercept:
            w, b = w_aug[:-1], float(w_aug[-1])
        else:
            w, b = w_aug, 0.0
        return self._model_cls(
            w, b, losses, self.optimizer.get_all_weights()
        )

    _model_cls = LinearModel

    def fit(self, X, y, w0=None, mesh=None):
        """``X``/``y``: host arrays or tensors.  Without an intercept a
        tensor on the mesh's device is read in place; the intercept's
        column makes an augmented copy.  ``mesh`` defaults to every CUDA
        device (raises without one)."""
        Xa, ya = _augment(X, y, self.fit_intercept)
        if w0 is not None and self.fit_intercept:
            w0 = np.concatenate([w0, [0.0]]).astype(np.float32)
        w_aug, losses = self.optimizer.optimize(Xa, ya, w0=w0, mesh=mesh)
        return self._make_model(w_aug, losses)


class LinearRegression(_SGDEstimator):
    """``LinearRegressionWithSGD`` analog (least squares, simple updater)."""

    _gradient_cls = LeastSquaresGradient
    _default_updater = SimpleUpdater


class LogisticRegressionModel(LinearModel):
    def predict_proba(self, X):
        m = self.margin(X)
        if isinstance(m, torch.Tensor):
            return torch.sigmoid(m)
        return 1.0 / (1.0 + np.exp(-m))

    def predict(self, X, threshold: float = 0.5):
        p = self.predict_proba(X)
        if isinstance(p, torch.Tensor):
            return (p >= threshold).to(torch.int32)
        return (p >= threshold).astype(np.int32)


class LogisticRegression(_SGDEstimator):
    """``LogisticRegressionWithSGD`` analog (labels in {0,1})."""

    _gradient_cls = LogisticGradient
    _default_updater = SimpleUpdater
    _model_cls = LogisticRegressionModel


class SVMModel(LinearModel):
    def predict(self, X, threshold: float = 0.0):
        m = self.margin(X)
        if isinstance(m, torch.Tensor):
            return (m >= threshold).to(torch.int32)
        return (m >= threshold).astype(np.int32)


class LinearSVM(_SGDEstimator):
    """``SVMWithSGD`` analog (hinge loss, L2 updater by default)."""

    _gradient_cls = HingeGradient
    _default_updater = SquaredL2Updater
    _model_cls = SVMModel


def _softmax_rows(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


class SoftmaxRegressionModel:
    """Multinomial logistic model: W (d, C) + b (C,)."""

    def __init__(self, W: np.ndarray, b: np.ndarray,
                 loss_history: np.ndarray):
        self.W = W
        self.b = b
        self.loss_history = loss_history

    def predict_proba(self, X):
        if isinstance(X, torch.Tensor):
            W = torch.as_tensor(self.W, device=X.device)
            b = torch.as_tensor(self.b, device=X.device)
            return torch.softmax(X.float() @ W + b, dim=1)
        return _softmax_rows(np.asarray(X, np.float32) @ self.W + self.b)

    def predict(self, X):
        p = self.predict_proba(X)
        if isinstance(p, torch.Tensor):
            return torch.argmax(p, dim=1)
        return np.argmax(p, axis=1)


class SoftmaxRegression:
    """Multinomial logistic regression (``LogisticRegressionWithLBFGS``'s
    ``setNumClasses(k)`` mode): a full-batch gradient loop whose iteration
    is two plain products (logits, ``X^T`` residual), as the JAX package's
    ``lax.scan`` is XLA's."""

    def __init__(
        self,
        step_size: float = 1.0,
        num_iterations: int = 200,
        reg_param: float = 0.0,
        num_classes: Optional[int] = None,
    ):
        self.step_size = step_size
        self.num_iterations = num_iterations
        self.reg_param = reg_param
        self.num_classes = num_classes

    def fit(self, X, y, device=None) -> SoftmaxRegressionModel:
        """``device`` defaults to the CUDA device (raises without one)."""
        dev = resolve_devices(None if device is None else [device])[0]
        Xd = (X if isinstance(X, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(X, np.float32))).to(dev).float()
        labels = (y.long() if isinstance(y, torch.Tensor)
                  else torch.from_numpy(np.asarray(y).astype(np.int64)))
        C = self.num_classes or int(labels.max()) + 1
        Y = torch.nn.functional.one_hot(labels.to(dev), C).float()
        n, d = Xd.shape
        lr, reg = self.step_size, self.reg_param
        W = torch.zeros((d, C), dtype=torch.float32, device=dev)
        b = torch.zeros(C, dtype=torch.float32, device=dev)
        losses = torch.empty(self.num_iterations, dtype=torch.float32,
                             device=dev)
        for i in range(self.num_iterations):
            logits = Xd @ W + b
            p = torch.softmax(logits, dim=1)
            # mean cross-entropy + L2; gradient via the softmax residual
            losses[i] = -torch.mean(torch.sum(
                Y * torch.log_softmax(logits, dim=1), dim=1)) \
                + 0.5 * reg * torch.sum(W * W)
            resid = (p - Y) / n
            gW = Xd.T @ resid + reg * W
            gb = resid.sum(dim=0)
            W, b = W - lr * gW, b - lr * gb
        return SoftmaxRegressionModel(
            W=W.cpu().numpy(), b=b.cpu().numpy(),
            loss_history=losses.cpu().numpy())


class RidgeRegression(_SGDEstimator):
    """``RidgeRegressionWithSGD`` analog: least squares + L2 updater."""

    _gradient_cls = LeastSquaresGradient
    _default_updater = SquaredL2Updater


class Lasso(_SGDEstimator):
    """``LassoWithSGD`` analog: least squares + L1 (soft-threshold) updater."""

    _gradient_cls = LeastSquaresGradient
    _default_updater = L1Updater

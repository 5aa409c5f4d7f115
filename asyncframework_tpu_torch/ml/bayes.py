"""Naive Bayes classifiers.

Counterpart of ``asyncframework_tpu/ml/bayes.py`` (parity:
``mllib/src/main/scala/org/apache/spark/mllib/classification/
NaiveBayes.scala`` -- multinomial and Bernoulli model types with Laplace
smoothing ``lambda``; prediction is ``argmax_c (log pi_c + x . log
theta_c)``; a Gaussian variant for continuous features).

Training is per-class feature aggregation -- the class counts one
``bincount`` and the per-class sums one ``index_add_`` over the label codes
(the JAX package's ``segment_sum``s) -- and prediction is one product
against the log-probability matrix, on the fit's device (the CUDA device
by default; raises without one).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from asyncframework_tpu_torch.ml.stat import on_device


class NaiveBayesModel:
    """Log-priors ``(C,)`` and log-likelihood parameters, tensors on the
    fit's device (host arrays, as a loaded JAX package model gives them,
    go to the CUDA device at the first predict)."""

    def __init__(self, log_pi, log_theta, model_type: str,
                 gaussian_stats=None):
        self.log_pi = log_pi          # (C,)
        self.log_theta = log_theta    # (C, D) or None for gaussian
        self.model_type = model_type
        self._gauss = gaussian_stats  # (mean (C,D), var (C,D)) for gaussian

    @property
    def device(self):
        return (self.log_pi.device if isinstance(self.log_pi, torch.Tensor)
                else None)

    def predict_log_likelihood(self, X) -> torch.Tensor:
        """``(N, C)`` joint log-likelihoods on the model's device."""
        X = on_device(X, self.device)
        dev = X.device
        log_pi = on_device(self.log_pi, dev)
        if self.model_type == "multinomial":
            return log_pi + X @ on_device(self.log_theta, dev).T
        if self.model_type == "bernoulli":
            # log P = x.log(t) + (1-x).log(1-t), folded into one product
            log_t = on_device(self.log_theta, dev)
            log_1mt = torch.log1p(-torch.exp(log_t))
            return log_pi + X @ (log_t - log_1mt).T + torch.sum(
                log_1mt, dim=1
            )
        mean, var = (on_device(a, dev) for a in self._gauss)
        # fully-batched gaussian log-likelihood: (N,1,D) against (C,D)
        z = (X[:, None, :] - mean[None]) ** 2 / var[None]
        return log_pi - 0.5 * torch.sum(
            z + torch.log(2 * math.pi * var)[None], dim=2
        )

    def predict(self, X):
        """Class ids: a tensor on the model's device for a tensor, a host
        array for a host array."""
        pred = torch.argmax(self.predict_log_likelihood(X), dim=1)
        return pred if isinstance(X, torch.Tensor) else pred.cpu().numpy()


class NaiveBayes:
    """``NaiveBayes.train(data, lambda, modelType)`` analog; fits on
    ``device`` (the CUDA device by default; raises without one)."""

    def __init__(self, smoothing: float = 1.0,
                 model_type: str = "multinomial", device=None):
        if model_type not in ("multinomial", "bernoulli", "gaussian"):
            raise ValueError(
                "model_type must be multinomial, bernoulli, or gaussian"
            )
        if smoothing < 0:
            raise ValueError("smoothing must be >= 0")
        self.smoothing = smoothing
        self.model_type = model_type
        self.device = device

    def fit(self, X, y, num_classes: Optional[int] = None) -> NaiveBayesModel:
        X = on_device(X, self.device)
        codes = on_device(y, X.device, torch.int32).long()
        C = num_classes or int(codes.max()) + 1
        counts = torch.bincount(codes, minlength=C).to(torch.float32)

        def class_sums(V: torch.Tensor) -> torch.Tensor:
            return torch.zeros((C, V.shape[1]), dtype=V.dtype,
                               device=V.device).index_add_(0, codes, V)

        log_pi = torch.log(counts) - torch.log(counts.sum())
        lam = self.smoothing
        if self.model_type == "gaussian":
            s1 = class_sums(X)
            s2 = class_sums(X * X)
            mean = s1 / counts[:, None]
            var = s2 / counts[:, None] - mean**2
            # variance smoothing: epsilon of the max variance (sklearn-style)
            eps = 1e-9 * float(torch.max(var)) + 1e-12
            return NaiveBayesModel(log_pi, None, "gaussian",
                                   (mean, var + eps))
        if self.model_type == "bernoulli":
            ones = class_sums((X > 0).to(torch.float32))
            theta = (ones + lam) / (counts[:, None] + 2 * lam)
            return NaiveBayesModel(log_pi, torch.log(theta), "bernoulli")
        # multinomial: theta_cd = (sum of feature d in class c + lam) / ...
        feat = class_sums(X)
        num = feat + lam
        den = feat.sum(dim=1, keepdim=True) + lam * X.shape[1]
        return NaiveBayesModel(log_pi, torch.log(num) - torch.log(den),
                               "multinomial")

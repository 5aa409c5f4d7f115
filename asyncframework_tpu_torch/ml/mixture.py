"""Gaussian mixture models by EM.

Counterpart of ``asyncframework_tpu/ml/mixture.py`` (parity:
``mllib/src/main/scala/org/apache/spark/mllib/clustering/
GaussianMixture.scala`` -- EM with full covariances; the reference's E-step
is a map over points whose ``ExpectationSum`` is folded in Spark's main
process).

One EM iteration is a fixed pipeline on the fit's device: the (n, k)
log-likelihood matrix from the (n, k, d) differences and the inverses of
the k Cholesky factors (one batched triangular solve of the small
factors, one batched product over the rows), responsibilities by a row
``logsumexp``, and the M-step's weighted moments as products.  The means
are seeded by the port's ``KMeans`` (10 Lloyd steps on one rank), which
seeds the same centres as the JAX package's from the same numpy draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from asyncframework_tpu_torch.ml.stat import on_device


def _log_gaussians(X, means, chols) -> torch.Tensor:
    """(n, k) log N(x | mu_j, Sigma_j) via the k Cholesky factors: their
    inverses from one batched triangular solve against the identity, then
    one batched product over the rows.  (A batched triangular solve with
    a right-hand side a row took 6.3 s an EM step and returned NaN at
    581,012 rows on an H100; the k (d, d) solves are exact to rounding.)"""
    d = X.shape[1]
    eye = torch.eye(d, dtype=chols.dtype, device=chols.device)
    inv = torch.linalg.solve_triangular(
        chols, eye.expand_as(chols), upper=False)       # (k, d, d)
    diff = X[:, None, :] - means[None, :, :]            # (n, k, d)
    z = torch.bmm(inv, diff.permute(1, 2, 0))           # (k, d, n)
    maha = torch.sum(z * z, dim=1).T                    # (n, k)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chols, dim1=1, dim2=2)), dim=1
    )
    return -0.5 * (maha + logdet + d * math.log(2.0 * math.pi))


def _em_step(X, weights, means, chols):
    """``(weights, means, covariances, log-likelihood)``: one EM step from
    the given parameters; the log-likelihood is theirs."""
    logp = _log_gaussians(X, means, chols) + torch.log(weights)[None, :]
    norm = torch.logsumexp(logp, dim=1, keepdim=True)
    resp = torch.exp(logp - norm)                        # (n, k)
    nk = resp.sum(dim=0)                                 # (k,)
    new_means = (resp.T @ X) / nk[:, None]
    # covariances: the responsibility-weighted scatter about each new mean
    xc = X[None, :, :] - new_means[:, None, :]           # (k, n, d)
    covs = torch.bmm((xc * resp.T[:, :, None]).transpose(1, 2), xc) \
        / nk[:, None, None]
    ll = torch.sum(norm)
    return nk / X.shape[0], new_means, covs, ll


@dataclass
class GaussianMixtureModel:
    weights: np.ndarray      # (k,)
    means: np.ndarray        # (k, d)
    covariances: np.ndarray  # (k, d, d)
    log_likelihood: float

    def _log_resp(self, X: torch.Tensor) -> torch.Tensor:
        dev = X.device
        chols = torch.linalg.cholesky(on_device(self.covariances, dev))
        logp = _log_gaussians(X, on_device(self.means, dev), chols)
        return logp + torch.log(on_device(self.weights, dev))[None, :]

    def predict_proba(self, X):
        """Responsibilities: on a tensor's device, or on the host for a
        host array."""
        Xt = X.float() if isinstance(X, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(X, np.float32))
        logp = self._log_resp(Xt)
        p = torch.exp(logp - torch.logsumexp(logp, dim=1, keepdim=True))
        return p if isinstance(X, torch.Tensor) else p.numpy()

    def predict(self, X):
        p = self.predict_proba(X)
        return (torch.argmax(p, dim=1) if isinstance(p, torch.Tensor)
                else np.argmax(p, axis=1))


class GaussianMixture:
    """``new GaussianMixture().setK(k).run(data)`` analog; fits on
    ``device`` (the CUDA device by default; raises without one).  After a
    fit, ``last_run["log_likelihoods"]`` holds each EM step's
    log-likelihood (of the parameters the step started from)."""

    def __init__(
        self,
        k: int,
        max_iterations: int = 100,
        tol: float = 1e-3,
        seed: int = 0,
        reg: float = 1e-6,
        device=None,
    ):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.reg = reg  # diagonal jitter keeping covariances SPD
        self.device = device
        self.last_run: dict = {}

    def fit(self, X) -> GaussianMixtureModel:
        from asyncframework_tpu_torch.ml.clustering import KMeans
        from asyncframework_tpu_torch.parallel.mesh import make_mesh

        Xd = on_device(X, self.device)
        n, d = Xd.shape
        # init means with a short k-means run (k-means++ seeding): EM from
        # random points routinely lands in visibly worse optima
        km = KMeans(self.k, max_iterations=10, seed=self.seed).fit(
            Xd, make_mesh(1, devices=[Xd.device]))
        means = on_device(km.centers, Xd.device)
        global_cov = torch.cov(Xd.T).reshape(d, d)
        covs = global_cov[None].repeat(self.k, 1, 1)
        weights = torch.full((self.k,), 1.0 / self.k, dtype=torch.float32,
                             device=Xd.device)
        eye = torch.eye(d, dtype=torch.float32, device=Xd.device)

        lls: List[float] = []
        prev_ll = -np.inf
        ll = prev_ll
        for _ in range(self.max_iterations):
            chols = torch.linalg.cholesky(covs + self.reg * eye[None])
            weights, means, covs, ll_dev = _em_step(Xd, weights, means, chols)
            ll = float(ll_dev)
            lls.append(ll)
            if abs(ll - prev_ll) < self.tol * max(abs(ll), 1.0):
                break
            prev_ll = ll
        self.last_run = {"iterations": len(lls), "log_likelihoods": lls}
        return GaussianMixtureModel(
            weights=weights.cpu().numpy(),
            means=means.cpu().numpy(),
            covariances=(covs + self.reg * eye[None]).cpu().numpy(),
            log_likelihood=ll,
        )

"""ALS matrix factorization (recommendation).

Counterpart of ``asyncframework_tpu/ml/recommendation.py`` (parity:
MLlib's ALS, ``mllib/.../recommendation/ALS.scala``).  Ratings are a dense
(users x items) matrix with an observation mask; one half step solves
every row's normal equations at once:

    A_u = V^T diag(mask_u) V + reg * n_u * I      (ALS-WR's count scaling)
    b_u = V^T (mask_u * r_u)
    U   = batched Cholesky solve of A, b

and symmetrically for the items.  ``A`` is one product of the mask with
the factors' outer products, the solve ``torch.linalg.cholesky`` and
``torch.cholesky_solve`` -- plain, as the JAX package's are XLA's.  The
implicit-feedback half step (Hu-Koren, ``ALS.trainImplicit``) shares the
Gram ``F^T F`` across rows.

The initial factors are drawn from a ``torch.Generator`` seeded with
``seed``: the JAX package's threefry draws are not reproduced, so the two
packages' fits agree in quality, and their half steps exactly, on the same
factors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from asyncframework_tpu_torch.ml.stat import on_device


@dataclass
class ALSModel:
    user_factors: np.ndarray  # (n_users, rank)
    item_factors: np.ndarray  # (n_items, rank)
    rank: int

    def predict(self, users, items) -> np.ndarray:
        u = np.asarray(self.user_factors)[np.asarray(users)]
        v = np.asarray(self.item_factors)[np.asarray(items)]
        return np.sum(u * v, axis=-1)

    def predict_all(self) -> np.ndarray:
        return np.asarray(self.user_factors) @ np.asarray(self.item_factors).T

    def rmse(self, R, mask) -> float:
        R = np.asarray(R, np.float32)
        mask = np.asarray(mask, np.float32)
        err = (self.predict_all() - R) * mask
        denom = max(float(mask.sum()), 1.0)
        return float(np.sqrt((err**2).sum() / denom))


def _outer_rows(F: torch.Tensor) -> torch.Tensor:
    """``(m, k * k)``: row ``j`` the flattened ``F_j F_j^T``."""
    m, k = F.shape
    return (F[:, :, None] * F[:, None, :]).reshape(m, k * k)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve ``A x = b`` through the Cholesky factor."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _half_step(F_other, R, mask, reg):
    """One side's factors given the other side's: ``F_other`` (m, k), ``R``
    and ``mask`` (n, m) this side's rows; returns (n, k)."""
    n = R.shape[0]
    k = F_other.shape[1]
    A = (mask @ _outer_rows(F_other)).reshape(n, k, k)
    counts = mask.sum(dim=1)
    # ALS-WR: reg scaled by each row's observation count (MLlib default)
    eye = torch.eye(k, dtype=F_other.dtype, device=F_other.device)
    A = A + (reg * torch.clamp_min(counts, 1.0))[:, None, None] * eye
    b = (mask * R) @ F_other
    return _solve(A, b)


def _half_step_implicit(F_other, R, alpha, reg):
    """Implicit-feedback half step (Hu-Koren; ``ALS.trainImplicit``):
    confidence ``c = 1 + alpha |r|``, preference ``p = (r > 0)``, normal
    equations ``(F^T F + F^T diag(c - 1) F + reg I) x_i = F^T (c_i p_i)``.
    ``|r|``, as MLlib: a negative "dislike" still means high confidence,
    where ``alpha r`` would make ``A`` indefinite."""
    n = R.shape[0]
    k = F_other.shape[1]
    G = F_other.T @ F_other  # shared gram
    Cm1 = alpha * torch.abs(R)
    A = G[None] + (Cm1 @ _outer_rows(F_other)).reshape(n, k, k)
    A = A + reg * torch.eye(k, dtype=F_other.dtype, device=F_other.device)
    P = (R > 0).to(F_other.dtype)
    b = ((1.0 + Cm1) * P) @ F_other
    return _solve(A, b)


class ALS:
    def __init__(
        self,
        rank: int = 10,
        reg: float = 0.1,
        num_iterations: int = 10,
        seed: int = 42,
        implicit_prefs: bool = False,
        alpha: float = 1.0,
    ):
        """``implicit_prefs=True`` switches to the Hu-Koren confidence
        formulation (``mllib ALS.trainImplicit``; alpha defaults to the
        reference's 1.0)."""
        if rank < 1:
            raise ValueError("rank must be >= 1")
        self.rank = rank
        self.reg = reg
        self.num_iterations = num_iterations
        self.seed = seed
        self.implicit_prefs = implicit_prefs
        self.alpha = alpha

    def initial_factors(self, n_users: int, n_items: int, device):
        """``(U0, V0)``: N(0, 1/rank) entries from a generator seeded with
        ``seed`` on ``device``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        scale = 1.0 / np.sqrt(self.rank)
        U0 = torch.randn(n_users, self.rank, generator=gen,
                         device=device) * scale
        V0 = torch.randn(n_items, self.rank, generator=gen,
                         device=device) * scale
        return U0, V0

    def fit(self, R, mask: Optional[np.ndarray] = None, device=None,
            init=None) -> ALSModel:
        """Factor ``R`` (n_users, n_items) given an observation ``mask``
        (1 = observed; default: nonzero entries are observed), on
        ``device`` (the CUDA device by default; raises without one).
        ``init``: ``(U0, V0)`` in place of :meth:`initial_factors`."""
        R = on_device(R, device)
        if self.implicit_prefs and mask is not None:
            raise ValueError(
                "mask is an explicit-feedback concept; implicit mode "
                "derives confidence from the interaction counts themselves"
            )
        if mask is None:
            mask = (R != 0).to(torch.float32)
        else:
            mask = on_device(mask, R.device)
        if mask.shape != R.shape:
            raise ValueError("mask shape must match ratings shape")
        n_users, n_items = R.shape
        if init is None:
            U, V = self.initial_factors(n_users, n_items, R.device)
        else:
            U, V = (on_device(f, R.device) for f in init)
        Rt, mt = R.T.contiguous(), mask.T.contiguous()
        for _ in range(self.num_iterations):
            if self.implicit_prefs:
                U = _half_step_implicit(V, R, self.alpha, self.reg)
                V = _half_step_implicit(U, Rt, self.alpha, self.reg)
            else:
                U = _half_step(V, R, mask, self.reg)
                V = _half_step(U, Rt, mt, self.reg)
        return ALSModel(
            user_factors=U.cpu().numpy(),
            item_factors=V.cpu().numpy(),
            rank=self.rank,
        )

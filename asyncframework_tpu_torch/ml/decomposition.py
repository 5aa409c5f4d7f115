"""PCA and SVD through the Gram matrix.

Counterpart of ``asyncframework_tpu/ml/decomposition.py`` (parity:
``mllib/.../feature/PCA.scala`` and ``RowMatrix.computeSVD``,
``mllib/.../linalg/distributed/RowMatrix.scala:493``): the d x d Gram
matrix is one product a rank, folded over the mesh's row axis, then
eigendecomposed on the device (``torch.linalg.eigh``; the reference's
local mode), and ``U = A V / s`` is one more product a rank.  The products
stay plain, as the JAX package's are XLA's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ml.stat import on_device
from asyncframework_tpu_torch.ops.collectives import psum_over_mesh
from asyncframework_tpu_torch.parallel.mesh import shard_batch


def _blocks(X, mesh, axis: str):
    """``X``'s row blocks over ``mesh``'s ``axis`` (f32; a tensor on a
    rank's device gives views)."""
    Xt = (X.float() if isinstance(X, torch.Tensor)
          else torch.from_numpy(np.ascontiguousarray(X, np.float32)))
    return shard_batch(mesh, Xt, axis=axis)


def _gram_and_mean(X, mesh, axis: str, device=None):
    """``(n, X^T X, column sums)``, folded over the mesh when given, else
    on ``device``."""
    if mesh is None:
        Xt = on_device(X, device)
        return Xt.shape[0], Xt.T @ Xt, Xt.sum(dim=0)
    blocks = _blocks(X, mesh, axis)
    home = mesh.local_ranks()[0]
    grams = [None if b is None else b.T @ b for b in blocks]
    sums = [None if b is None else b.sum(dim=0) for b in blocks]
    n = X.shape[0]
    return (n, psum_over_mesh(grams, mesh, axis)[home],
            psum_over_mesh(sums, mesh, axis)[home])


def _rows_times(X, V: torch.Tensor, mesh, axis: str, device=None):
    """``X @ V`` on ``device``, or a rank's block at a time over ``mesh``,
    gathered on the first local rank's device."""
    if mesh is None:
        return on_device(X, device) @ V
    blocks = _blocks(X, mesh, axis)
    home = mesh.local_ranks()[0]
    dev = mesh.devices[home]
    # one block a dp index (the blocks repeat over the other axes)
    seen, out = set(), []
    for r, b in enumerate(blocks):
        i = mesh.coords(r)[axis]
        if b is None or i in seen:
            continue
        seen.add(i)
        out.append((b @ V.to(b.device)).to(dev))
    return torch.cat(out)


@dataclass
class PCAModel:
    components: np.ndarray          # (k, d) principal axes, rows
    explained_variance: np.ndarray  # (k,)
    mean: np.ndarray                # (d,)

    def transform(self, X):
        """Projections of ``X``: on a tensor's device, or on the host."""
        if isinstance(X, torch.Tensor):
            mean = torch.as_tensor(self.mean, device=X.device)
            comps = torch.as_tensor(self.components, device=X.device)
            return (X.float() - mean) @ comps.T
        return (np.asarray(X, np.float32) - self.mean) @ self.components.T


class PCA:
    """``new PCA(k).fit(data)`` analog; covariance eigendecomposition."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k

    def fit(self, X, mesh=None, axis: str = "dp", device=None) -> PCAModel:
        """``mesh``: rows split over its ``axis``; else one pass on
        ``device`` (the CUDA device by default; raises without one)."""
        n, gram, colsum = _gram_and_mean(X, mesh, axis, device)
        d = gram.shape[0]
        if self.k > d:
            raise ValueError(f"k={self.k} > d={d}")
        mean = colsum / n
        # covariance from the gram matrix: (X^T X - n mu mu^T) / (n - 1)
        cov = (gram - n * torch.outer(mean, mean)) / max(n - 1, 1)
        evals, evecs = torch.linalg.eigh(cov)  # ascending
        order = torch.argsort(-evals)[: self.k]
        comps = evecs[:, order].T
        # sign convention: largest-|.| coordinate of each axis positive
        # (deterministic across backends; eigh's signs are arbitrary)
        idx = torch.argmax(torch.abs(comps), dim=1)
        signs = torch.sign(comps[torch.arange(self.k, device=comps.device),
                                 idx])
        comps = comps * signs[:, None]
        return PCAModel(
            components=comps.cpu().numpy(),
            explained_variance=evals[order].cpu().numpy(),
            mean=mean.cpu().numpy(),
        )


def svd(
    X,
    k: int,
    mesh=None,
    axis: str = "dp",
    compute_u: bool = True,
    rcond: float = 1e-3,
    device=None,
) -> Tuple[Optional[torch.Tensor], np.ndarray, np.ndarray]:
    """Truncated SVD ``A ~ U diag(s) V^T`` through the Gram matrix.

    ``RowMatrix.computeSVD`` parity: eigendecompose ``A^T A = V S^2 V^T``,
    keep the top-k with ``s > rcond * s_max``, recover ``U = A V S^{-1}``.
    Returns (U (a tensor) or None, s (k',), V (d, k')).  ``rcond``
    defaults to 1e-3: through the f32 Gram matrix, singular values below
    ~sqrt(eps_f32) * s_max ~= 3e-4 * s_max cannot be recovered."""
    n, gram, _ = _gram_and_mean(X, mesh, axis, device)
    d = gram.shape[0]
    if not 1 <= k <= d:
        raise ValueError(f"k must be in [1, {d}], got {k}")
    evals, evecs = torch.linalg.eigh(gram)
    order = torch.argsort(-evals)[:k]
    s = torch.sqrt(torch.clamp_min(evals[order], 0.0))
    keep = torch.nonzero(s > rcond * s[0]).ravel()
    s = s[keep]
    V = evecs[:, order][:, keep]
    # deterministic sign convention, matched in U through the product
    idx = torch.argmax(torch.abs(V), dim=0)
    signs = torch.sign(V[idx, torch.arange(V.shape[1], device=V.device)])
    V = V * signs[None, :]
    U = None
    if compute_u:
        U = _rows_times(X, V, mesh, axis, device) / s.to(V.device)[None, :]
    return U, s.cpu().numpy(), V.cpu().numpy()

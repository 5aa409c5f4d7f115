"""Loss gradients and losses (the worker hot path).

Counterpart of ``asyncframework_tpu/ops/gradients.py``.  A shard's sampled
mini-batch gradient is ``g = X^T (mask * (f(X w) - y))``; where the JAX
package hands the two matmuls to XLA, the port runs them as one pass of the
hand-written kernel :func:`~asyncframework_tpu_torch.ops.masked_grad.masked_grad`.
Losses stay plain PyTorch, as the originals stay plain XLA.

Parity targets: the least-squares ``gradfun`` of the ASYNC drivers
(``SparkASGDThread.scala:420-435``, per sample ``(x.w - y) x``, summed),
MLlib's ``LogisticGradient`` (binary, labels in {0, 1}), and ASAGA's
per-sample scalar form (``SparkASAGAThread.scala:500-515``): for least
squares a per-sample gradient is ``scalar * x`` with ``scalar = x.w - y``,
so the history table holds one scalar per sample.  The ASAGA contraction
runs through the same kernel's history form
(:func:`~asyncframework_tpu_torch.ops.masked_grad.saga_grad`).  The sparse
(padded-ELL) residual and gradient sum run through kernel S1
(:mod:`~asyncframework_tpu_torch.ops.sparse_grad`).
"""

from __future__ import annotations

import torch

from asyncframework_tpu_torch.ops.masked_grad import masked_grad, saga_grad
from asyncframework_tpu_torch.ops.sparse_grad import ell_residual, grad_sum

#: rows widened to f32 at a time when a bf16 matrix meets a vector
_MM_CHUNK_ROWS = 1 << 16


def mm_f32(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` in ``A``'s storage dtype with f32 accumulation.

    ``v`` (``(d,)`` or ``(d, S)``) is rounded to ``A.dtype`` first, as the
    JAX package's ``mm_f32`` does, and the product is f32.  For f32 ``A``
    this is the plain matmul.  A bf16 ``A`` is widened to f32 a block of
    rows at a time (bf16 products are exact in f32), so no f32 copy of a
    whole shard is made.
    """
    v = v.to(A.dtype)
    if A.dtype == torch.float32:
        return A @ v
    vf = v.float()
    parts = [
        A[i:i + _MM_CHUNK_ROWS].float() @ vf
        for i in range(0, A.shape[0], _MM_CHUNK_ROWS)
    ]
    if not parts:
        return torch.zeros((0,) + tuple(v.shape[1:]), device=A.device)
    return torch.cat(parts)


def least_squares_residual(X, y, w):
    """Per-sample scalar ``x_i . w - y_i`` (the ASAGA 'scalar' form), as the
    ``diff`` of one pass of the kernel's history form (with a zero mask,
    so its gradient is zero and discarded)."""
    zeros = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    return saga_grad(X, y, w, zeros, zeros)[1]


def least_squares_grad_sum(X, y, w, mask, idx=None):
    """Sum over masked samples of ``(x_i . w - y_i) x_i`` (with ``idx``:
    over the rows ``X[idx]``, weighted by ``mask`` per slot)."""
    return masked_grad(X, y, w, mask, idx, "least_squares")


def least_squares_loss(X, y, w):
    """Unnormalised squared error ``sum_i (x_i.w - y_i)^2`` over the shard;
    the caller divides by the global N."""
    r = mm_f32(X, w) - y
    return torch.sum(r * r)


def logistic_grad_sum(X, y, w, mask, idx=None):
    """Sum over masked samples of ``(sigmoid(x_i.w) - y_i) x_i``."""
    return masked_grad(X, y, w, mask, idx, "logistic")


def logistic_loss(X, y, w):
    """Unnormalised logistic loss, stable ``log(1 + e^m) - y m`` form."""
    margin = mm_f32(X, w)
    return torch.sum(torch.logaddexp(torch.zeros_like(margin), margin) - y * margin)


def saga_shard_step(X, y, w, alpha, mask):
    """One ASAGA worker computation over a shard: ``(g, diff)`` with
    ``diff_i = x_i.w - y_i`` (the candidate history scalars) and
    ``g = sum_i mask_i (diff_i - alpha_i) x_i`` (the history-corrected
    gradient sum), in one pass of the kernel over ``X``.  Committing
    ``alpha[i] <- diff_i`` is :func:`saga_commit_history`, issued by the
    updater only for accepted results."""
    return saga_grad(X, y, w, alpha, mask)


def saga_commit_history(alpha, diff, mask):
    """``alpha[i] <- diff[i]`` where ``mask_i > 0`` (an accepted update).

    The new slice is written into ``diff``'s buffer (the JAX package
    donates ``diff``: it is dead after the commit) and returned.  ``alpha``
    is never written: an in-flight task dispatched before this commit may
    still hold the old slice."""
    return torch.where(mask > 0, diff, alpha, out=diff)


# ------------------------------------------------------------------ sparse
# rcv1-class data in padded ELL (data/sparse.py): cols/vals are (n, K) with
# zero padding; w stays dense (the updater applies dense updates).  Both
# run through kernel S1 (ops/sparse_grad.py) on the card.

def sparse_residual(cols, vals, y, w):
    """Per-sample ``x_i . w - y_i`` via a gather: padding contributes 0."""
    return ell_residual(cols, vals, y, w)


def make_sparse_grad_sum(d: int):
    """``grad_sum(cols, vals, coeff) -> g (d,)``: ``g = sum_i coeff_i x_i``
    (the sparse ``X^T coeff``) as kernel S1's segment sum over the entries
    sorted by column (a stable sort inside the one launch), added in that
    order -- the reference's sorted scatter-add for every column of at most
    ``sparse_grad.CHUNK`` entries, and the same bits on every launch."""

    def sparse_grad_sum(cols, vals, coeff):
        return grad_sum(cols, vals, coeff, d)

    return sparse_grad_sum

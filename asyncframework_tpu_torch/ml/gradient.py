"""Loss-gradient families for linear models.

Counterpart of ``asyncframework_tpu/ml/gradient.py`` (parity:
``mllib/.../optimization/Gradient.scala`` -- ``LeastSquaresGradient``
(:285), ``LogisticGradient``'s binary case (:166), ``HingeGradient``).  The
unit is a masked batch: ``local(X, y, w, mask)`` returns the summed
gradient and the summed loss over the rows ``mask`` weights.  Labels follow
MLlib: logistic and hinge take {0, 1} (hinge rescales to {-1, +1}).

Where the JAX package hands ``X^T (...)`` to XLA, each gradient here is one
launch of kernel B1 (``ops/masked_grad.py``) on a CUDA tensor, and its
plain version on a CPU one:

- least squares: ``saga_grad`` with ``alpha = 0`` -- the gradient and the
  residual ``X w - y`` (for the loss) in one pass over ``X``, as
  ``MiniBatchSGD``'s 1-D step takes it;
- logistic: ``masked_grad(..., loss="logistic")``, the full masked form;
- hinge: ``xt_coeff`` of the coefficient ``mask * (-s) * [s m < 1]``.

The margin ``m = X w`` that the logistic loss and the hinge coefficient
need is a plain product (``ops/gradients.py::mm_f32``), as the JAX
package's is XLA's.  :meth:`Gradient.coefficient` is the same loss from a
margin already folded over a feature-sharded mesh (``MiniBatchSGD``'s 2-D
layout): the gradient is then ``xt_coeff`` of that coefficient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from asyncframework_tpu_torch.ops import masked_grad as _mg
from asyncframework_tpu_torch.ops.gradients import mm_f32


class Gradient:
    """Batched (summed) loss and gradient over masked rows."""

    def local(self, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(grad_sum, loss_sum)`` over the rows ``mask`` weights."""
        c, loss = self.coefficient(mm_f32(X, w), y, mask)
        return _mg.xt_coeff(X, c), loss

    def coefficient(self, margin: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(c, loss_sum)`` from the margin ``X w``: the gradient is
        ``X^T c``."""
        raise NotImplementedError

    def loss(self, X: torch.Tensor, y: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
        """Summed loss over all rows (the evaluation path)."""
        ones = torch.ones(X.shape[0], dtype=torch.float32, device=X.device)
        return self.local(X, y, w, ones)[1]


class LeastSquaresGradient(Gradient):
    """loss_i = (x_i.w - y_i)^2 / 2;  grad_i = (x_i.w - y_i) x_i."""

    def local(self, X, y, w, mask):
        g, diff = _mg.saga_grad(X, y, w, torch.zeros_like(y), mask)
        return g, 0.5 * torch.sum(mask * diff * diff)

    def coefficient(self, margin, y, mask):
        r = margin - y
        return mask * r, 0.5 * torch.sum(mask * r * r)


def _logistic_loss(margin, y, mask):
    return torch.sum(mask * (torch.logaddexp(torch.zeros_like(margin),
                                             margin) - y * margin))


class LogisticGradient(Gradient):
    """Binary logistic loss, labels in {0, 1}:
    loss_i = log(1 + e^{x_i.w}) - y_i (x_i.w);
    grad_i = (sigmoid(x_i.w) - y_i) x_i."""

    def local(self, X, y, w, mask):
        g = _mg.masked_grad(X, y, w, mask, loss="logistic")
        return g, _logistic_loss(mm_f32(X, w), y, mask)

    def coefficient(self, margin, y, mask):
        return (mask * (torch.sigmoid(margin) - y),
                _logistic_loss(margin, y, mask))


class HingeGradient(Gradient):
    """SVM hinge loss, labels in {0, 1} rescaled to s = 2y - 1: where
    ``1 - s (x_i.w) > 0``, loss_i is that margin and grad_i = -s x_i;
    else both are 0."""

    def coefficient(self, margin, y, mask):
        s = 2.0 * y - 1.0
        viol = 1.0 - s * margin
        active = (viol > 0).to(margin.dtype) * mask
        return -s * active, torch.sum(torch.clamp_min(viol, 0.0) * mask)

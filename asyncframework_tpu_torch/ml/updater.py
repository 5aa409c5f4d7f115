"""Parameter updaters (step and regularization).

Counterpart of ``asyncframework_tpu/ml/updater.py`` (parity:
``mllib/.../optimization/Updater.scala`` -- ``SimpleUpdater`` (:41),
``L1Updater``'s soft threshold (:70), ``SquaredL2Updater`` (:140)): the
learning rate is ``step_size / sqrt(it)`` with ``it`` 1-indexed, applied
to the average gradient, and the regularization value is taken on the new
weights.

The arithmetic is written once, here: ``solvers/minibatch_sgd.py`` runs
its ``updater="simple" | "l2" | "l1"`` through these classes.  A model
sharded over features updates each slice with :meth:`Updater.step`, which
also returns the slice's part of the regularization norm; the parts fold
over the slices and :meth:`Updater.value` turns the total into the value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class Updater:
    def step(self, w: torch.Tensor, avg_grad: torch.Tensor, lr,
             reg_param: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(w_new, part)``: one step at learning rate ``lr`` and this
        slice's part of the regularization norm (None without one)."""
        raise NotImplementedError

    def value(self, part: Optional[torch.Tensor], reg_param: float):
        """The regularization value from the norm's folded parts."""
        return 0.0

    def apply(self, w: torch.Tensor, avg_grad: torch.Tensor,
              step_size: float, it, reg_param: float):
        """``(w_new, reg_val)``; ``it`` is the 1-indexed iteration."""
        w2, part = self.step(w, avg_grad, self._lr(step_size, it), reg_param)
        return w2, torch.as_tensor(self.value(part, reg_param),
                                   dtype=w.dtype, device=w.device)

    @staticmethod
    def _lr(step_size, it):
        return step_size / torch.sqrt(torch.as_tensor(it, dtype=torch.float32))


class SimpleUpdater(Updater):
    def step(self, w, avg_grad, lr, reg_param):
        return w - lr * avg_grad, None


class SquaredL2Updater(Updater):
    """w' = w (1 - lr * reg) - lr * grad;  reg_val = reg/2 ||w'||^2."""

    def step(self, w, avg_grad, lr, reg_param):
        w2 = w * (1.0 - lr * reg_param) - lr * avg_grad
        return w2, torch.sum(w2 * w2)

    def value(self, part, reg_param):
        return 0.5 * reg_param * part


class L1Updater(Updater):
    """Soft threshold at ``lr * reg``;  reg_val = reg ||w'||_1."""

    def step(self, w, avg_grad, lr, reg_param):
        raw = w - lr * avg_grad
        w2 = torch.sign(raw) * torch.clamp_min(torch.abs(raw) - lr * reg_param,
                                               0.0)
        return w2, torch.sum(torch.abs(w2))

    def value(self, part, reg_param):
        return reg_param * part


#: ``MiniBatchSGD``'s ``updater=`` names
UPDATERS = {"simple": SimpleUpdater, "l2": SquaredL2Updater, "l1": L1Updater}

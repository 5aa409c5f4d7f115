"""Optimizers: mini-batch gradient descent and L-BFGS.

Counterpart of ``asyncframework_tpu/ml/optimization.py``.  Parity:

- ``GradientDescent.runMiniBatchSGD`` (``mllib/.../GradientDescent.scala:
  197-295``): per 1-indexed iteration a Bernoulli(``b``) draw, the summed
  ``(grad, loss, count)``, the loss ``loss_sum / count + reg_val(prev)``
  recorded before the update, the pluggable ``Updater``; an iteration whose
  draw took no row is skipped (no update, no loss entry); the convergence
  cut on the weight delta ``||w_t - w_{t-1}|| < tol * max(||w_t||, 1)``
  (``:300-310``);
- the fork's ``Warray`` (``GradientDescent.scala:156,255-259``): ``(ms,
  w)`` every ``snapshot_every`` iterations plus the final iterate, read by
  :meth:`GradientDescent.get_all_weights`;
- ``LBFGS.scala:42``: a host two-loop-recursion L-BFGS with Armijo
  backtracking over the full-batch objective ``mean loss + reg/2 ||w||^2``.

Where the JAX package compiles the SGD loop into one ``shard_map``'d
``lax.scan``, the port runs it on ``MiniBatchSGD``'s loop
(``solvers/minibatch_sgd.py::run_iterations``): per iteration and rank one
launch of kernel B1 through the gradient class (``ml/gradient.py``), the
partials folded in rank order, and on one card the iterations captured as
CUDA graphs of 16.  Each L-BFGS value-and-gradient evaluation is one B1
launch a rank (plus the margin's product for logistic and hinge), folded
over the mesh and read back to the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ml.gradient import Gradient, LeastSquaresGradient
from asyncframework_tpu_torch.ml.updater import SimpleUpdater, Updater
from asyncframework_tpu_torch.ops.collectives import psum_over_mesh
from asyncframework_tpu_torch.parallel.mesh import (
    as_rows, make_mesh, pad_and_shard)
# a module import: solvers/minibatch_sgd.py imports this package's
# gradient and updater classes, so either package may be imported first
from asyncframework_tpu_torch.solvers import minibatch_sgd as _loop


class GradientDescent:
    """Mini-batch SGD with a pluggable :class:`Gradient` and
    :class:`Updater`."""

    def __init__(
        self,
        gradient: Optional[Gradient] = None,
        updater: Optional[Updater] = None,
        step_size: float = 1.0,
        num_iterations: int = 100,
        reg_param: float = 0.0,
        mini_batch_fraction: float = 1.0,
        convergence_tol: float = 0.0,
        seed: int = 42,
        snapshot_every: int = 100,
    ):
        self.gradient = gradient or LeastSquaresGradient()
        self.updater = updater or SimpleUpdater()
        self.step_size = step_size
        self.num_iterations = num_iterations
        self.reg_param = reg_param
        self.mini_batch_fraction = mini_batch_fraction
        self.convergence_tol = convergence_tol
        self.seed = seed
        self.snapshot_every = snapshot_every
        self._weight_history: List[Tuple[float, np.ndarray]] = []
        #: the last run's accounting (``run_iterations``): iterations,
        #: graph replays, enqueued iterations, ranks, fenced seconds
        self.last_run: Dict[str, float] = {}

    def optimize(self, X, y, w0=None,
                 mesh=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(w_final, stochastic_loss_history)`` (numpy).

        ``X``/``y``: host arrays or tensors (a tensor on the rank's device
        is read in place where no padding is needed).  ``mesh`` defaults to
        every CUDA device (raises without one); a 2-D ``("dp", "md")``
        mesh shards the features over ``md``.  Where every local rank is
        on one card the iterations run as CUDA graphs (``run_iterations``)."""
        mesh = mesh or make_mesh()
        d = X.shape[1]
        w0 = np.zeros(d, np.float32) if w0 is None else np.asarray(w0,
                                                                   np.float32)
        T, every = self.num_iterations, self.snapshot_every
        run = _loop.run_iterations(
            X, y, w0, mesh, T, self.mini_batch_fraction, self.step_size,
            self.reg_param, self.gradient, self.updater, self.seed,
            mllib=True)
        self.last_run = run.info
        elapsed_ms = run.info["elapsed_s"] * 1e3
        losses = run.losses.cpu().numpy()
        took = run.took.cpu().numpy()

        def rows(idx) -> np.ndarray:
            """``w`` after the iterations ``idx`` (0-indexed), on the host."""
            sel = torch.as_tensor(np.asarray(idx, np.int64))
            return np.concatenate(
                [h[sel.to(h.device)].cpu().numpy() for h in run.hist],
                axis=1)[:, :d]

        def build_history(upto_iter: int, w_last: np.ndarray):
            """``Warray``: (ms, w) at iterations every, 2 every, ... <=
            ``upto_iter``, plus the final iterate; the times are the run's
            fenced time spread over its iterations, as in the JAX
            package (the loop runs without a host stop per iteration)."""
            iters = list(range(every, upto_iter + 1, every))
            snaps = rows([it - 1 for it in iters]) if iters else []
            hist = [(elapsed_ms * it / T, snaps[i])
                    for i, it in enumerate(iters)]
            if upto_iter % every != 0 or not iters:
                hist.append((elapsed_ms * upto_iter / T, w_last))
            return hist

        if self.convergence_tol > 0:
            ws = rows(range(T))
            prev = w0
            for i in range(T):
                if not took[i]:
                    continue  # skipped iteration (zero-row sample)
                diff = np.linalg.norm(ws[i] - prev)
                if diff < self.convergence_tol * max(np.linalg.norm(ws[i]),
                                                     1.0):
                    # truncate the trajectory at the convergence point so
                    # get_all_weights agrees with the returned model
                    self._weight_history = build_history(i + 1, ws[i])
                    return ws[i], losses[: i + 1][took[: i + 1]]
                prev = ws[i]
        self._weight_history = build_history(T, run.w_final)
        # MLlib appends no loss for an iteration whose draw took no row
        return run.w_final, losses[took]

    def get_all_weights(self) -> List[Tuple[float, np.ndarray]]:
        """The fork's ``Optimizer.getAllWeights`` trajectory accessor."""
        return list(self._weight_history)


class LBFGS:
    """Limited-memory BFGS over the full-batch regularized objective.

    Parity: ``LBFGS.scala:42`` and its breeze ``CostFun``: the objective is
    ``mean loss + reg/2 ||w||^2``.  The two-loop recursion and the Armijo
    backtracking run on the host in f32 numpy, as in the JAX package; each
    objective and gradient evaluation is one B1 launch a rank."""

    def __init__(
        self,
        gradient: Optional[Gradient] = None,
        num_corrections: int = 10,
        convergence_tol: float = 1e-6,
        max_iterations: int = 100,
        reg_param: float = 0.0,
    ):
        self.gradient = gradient or LeastSquaresGradient()
        self.m = num_corrections
        self.tol = convergence_tol
        self.max_iterations = max_iterations
        self.reg_param = reg_param
        self._weight_history: List[Tuple[float, np.ndarray]] = []
        self.loss_history: List[float] = []
        #: the last run's evaluations (each one B1 launch a rank)
        self.last_run: Dict[str, float] = {}

    def _value_grad(self, mesh, X, y):
        """``(loss_sum, grad_sum)`` over every row, folded over ``dp``."""
        Xs, ys, vs, n = pad_and_shard(mesh, *as_rows(X, y))
        local = mesh.local_ranks()
        home = local[0]

        def value_grad(w: np.ndarray):
            wt = torch.from_numpy(np.ascontiguousarray(w, np.float32))
            g_parts = [None] * mesh.size
            l_parts = [None] * mesh.size
            for r in local:
                g_parts[r], l_parts[r] = self.gradient.local(
                    Xs[r], ys[r], wt.to(mesh.devices[r]), vs[r])
            g = psum_over_mesh(g_parts, mesh, "dp")[home]
            loss = psum_over_mesh(l_parts, mesh, "dp")[home]
            return float(loss), g.cpu().numpy()

        return value_grad, n

    def optimize(self, X, y, w0=None, mesh=None) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """Returns ``(w_final, loss_history)`` (numpy).  ``mesh`` defaults
        to every CUDA device (raises without one)."""
        mesh = mesh or make_mesh()
        value_grad, n = self._value_grad(mesh, X, y)
        reg = self.reg_param
        self._weight_history = []
        self.loss_history = []
        evaluations = [0]

        def f_g(w: np.ndarray) -> Tuple[float, np.ndarray]:
            evaluations[0] += 1
            loss, g = value_grad(w)
            f = loss / n + 0.5 * reg * float(w @ w)
            return f, g / n + reg * w

        w = (np.zeros(X.shape[1], np.float32) if w0 is None
             else np.asarray(w0, np.float32))
        t0 = time.monotonic()
        f, g = f_g(w)
        s_list: List[np.ndarray] = []
        y_list: List[np.ndarray] = []
        self.loss_history = [f]
        for _ in range(self.max_iterations):
            # two-loop recursion
            q = g.copy()
            alphas = []
            for s, yk in zip(reversed(s_list), reversed(y_list)):
                a = (s @ q) / (yk @ s)
                q -= a * yk
                alphas.append(a)
            if y_list:
                yk, s = y_list[-1], s_list[-1]
                q *= (s @ yk) / (yk @ yk)
            for (s, yk), a in zip(zip(s_list, y_list), reversed(alphas)):
                beta = (yk @ q) / (yk @ s)
                q += (a - beta) * s
            d = -q
            if g @ d > 0:  # safeguard: fall back to steepest descent
                d = -g
            # Armijo backtracking
            t = 1.0
            gd = g @ d
            for _ls in range(30):
                f_new, g_new = f_g(w + t * d)
                if f_new <= f + 1e-4 * t * gd:
                    break
                t *= 0.5
            s = t * d
            yk = g_new - g
            if np.linalg.norm(s) < self.tol * max(np.linalg.norm(w), 1.0):
                w, f, g = w + s, f_new, g_new
                self.loss_history.append(f)
                break
            if yk @ s > 1e-10:  # curvature condition, keep pair
                s_list.append(s)
                y_list.append(yk)
                if len(s_list) > self.m:
                    s_list.pop(0)
                    y_list.pop(0)
            w, f, g = w + s, f_new, g_new
            self.loss_history.append(f)
            self._weight_history.append(
                ((time.monotonic() - t0) * 1e3, w.copy())
            )
            if len(self.loss_history) >= 2:
                prev, cur = self.loss_history[-2], self.loss_history[-1]
                if abs(prev - cur) / max(abs(prev), abs(cur), 1e-12) < self.tol:
                    break
        self.last_run = {"evaluations": evaluations[0],
                         "iterations": len(self.loss_history) - 1,
                         "ranks": len(mesh.local_ranks()),
                         "elapsed_s": time.monotonic() - t0}
        return w, np.asarray(self.loss_history)

    def get_all_weights(self) -> List[Tuple[float, np.ndarray]]:
        """The iterates (the reference's ``LBFGS.getAllWeights`` is a stub,
        ``LBFGS.scala:45-49``; the JAX package returns them too)."""
        return list(self._weight_history)

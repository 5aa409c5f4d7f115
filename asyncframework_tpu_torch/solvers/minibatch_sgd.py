"""Synchronous mini-batch SGD over a device mesh.

Counterpart of ``asyncframework_tpu/solvers/minibatch_sgd.py`` (parity:
MLlib's ``GradientDescent.runMiniBatchSGD``,
``mllib/.../optimization/GradientDescent.scala:197-295``): per iteration,
a Bernoulli(``batch_rate``) sample of every rank's rows, the summed
gradient, loss and count folded over the ``dp`` axis, an ``Updater``
step (simple / L2 / L1, ``Updater.scala:41,70,140``) at learning rate
``gamma / sqrt(it + 1)``, the stochastic loss, and a weight trajectory
every ``snapshot_every`` iterations (``Warray``).

Where the JAX package runs the whole loop as one ``shard_map``'d
``lax.scan``, the port runs one iteration as a loop over the mesh's ranks
(``parallel/mesh.py``):

- each ``dp`` index draws its rows' mask from its own generator
  (``worker_generator(seed, dp_index)``, the counterpart of the JAX
  package's ``fold_in(key, axis_index)``); every ``md`` shard of a row
  block shares its mask, and padding rows never count;
- each rank's gradient is one launch of kernel B1 on its block, through
  the library's gradient classes (``ml/gradient.py``): on a 1-D mesh
  least squares is ``saga_grad`` with ``alpha = 0`` (the gradient and the
  residual for the loss in one pass) and logistic the full masked form
  beside the margin ``X_l @ w`` (a plain product, as in the JAX package);
  on a 2-D mesh the margin is folded over ``md`` first, then ``xt_coeff``
  of the loss's coefficient;
- the partials fold in rank order (``ops/collectives.py::psum_over_mesh``;
  under a process group, then one ``all_reduce`` across the processes),
  and each ``md`` shard updates its own slice of ``w`` with the library's
  updater arithmetic (``ml/updater.py``).

The loop itself (:func:`run_iterations`) is shared with the library's
``GradientDescent`` (``ml/optimization.py``), which keeps MLlib's
bookkeeping on it.

On one card the iterations are captured as CUDA graphs of
:data:`~asyncframework_tpu_torch.solvers.base.CHUNK_ROUNDS` iterations
with the rank generators registered, and replayed with no host round trip
between iterations (``solvers/base.py::capture_chunks``, as ``run_fused``
does); a replay is bit-equal to the same iterations run eagerly.  A mesh
over several cards or several processes runs them eagerly.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from asyncframework_tpu_torch.metrics import trace as _trace
from asyncframework_tpu_torch.ml.gradient import (
    LeastSquaresGradient,
    LogisticGradient,
)
from asyncframework_tpu_torch.ml.updater import UPDATERS
from asyncframework_tpu_torch.ops import masked_grad as _mg
from asyncframework_tpu_torch.ops.collectives import psum_over_mesh
from asyncframework_tpu_torch.ops.gradients import mm_f32
from asyncframework_tpu_torch.ops.sampling import bernoulli_mask, worker_generator
from asyncframework_tpu_torch.parallel.mesh import (
    as_rows,
    make_mesh,
    pad_and_shard,
    pad_and_shard_2d,
)
from asyncframework_tpu_torch.solvers.base import (
    CHUNK_ROUNDS,
    FusedRounds,
    RoundChunk,
    capture_chunks,
)
from asyncframework_tpu_torch.utils.devices import device_scope, fence

_LOSSES = {"least_squares": LeastSquaresGradient, "logistic": LogisticGradient}


class _Iterations(RoundChunk):
    """``rounds`` iterations from the state buffers ``(*w_slices, it,
    reg)`` back into them; each iteration's ``w`` slices, stochastic loss
    and whether it drew a row are copied into rows of ``snaps``,
    ``losses`` and ``took``.  Run eagerly or, once captured
    (:meth:`RoundChunk.capture`), as one graph replay."""

    def __init__(self, fused: FusedRounds, rounds: int, n_w: int):
        self.fused = fused
        self.rounds = rounds
        self.graph = None
        self.snaps = [torch.empty((rounds, w.shape[0]), dtype=w.dtype,
                                  device=w.device)
                      for w in fused.carry[:n_w]]
        it = fused.carry[n_w]
        self.losses = torch.empty(rounds, dtype=torch.float32,
                                  device=it.device)
        self.took = torch.empty(rounds, dtype=torch.bool, device=it.device)

    def run_eager(self) -> None:
        carry = self.fused.carry
        for j in range(self.rounds):
            *carry, loss, took = self.fused.round_fn(*carry)
            for snap, w in zip(self.snaps, carry):
                snap[j].copy_(w)
            self.losses[j].copy_(loss)
            self.took[j].copy_(took)
        for buf, new in zip(self.fused.carry, carry):
            buf.copy_(new)


def _layout(mesh, X, y, w0, md_axis: Optional[str]):
    """Per-rank blocks and the ``w`` slices: ``(Xs, ys, vs, w_slices,
    homes)`` with ``homes[j]`` the rank holding ``md`` slice ``j`` (the
    first local rank of that slice)."""
    local = mesh.local_ranks()
    if md_axis is None:
        Xs, ys, vs, _n = pad_and_shard(mesh, *as_rows(X, y))
        home = local[0]
        # a copy: the state buffers are written at each chunk's end
        w = torch.tensor(np.asarray(w0, np.float32),
                         device=mesh.devices[home])
        return Xs, ys, vs, [w], [home]
    Xs, ys, vs, ws, _d = pad_and_shard_2d(mesh, X, y, w0)
    homes = []
    for j in range(mesh.shape[md_axis]):
        mine = [r for r in local if mesh.coords(r)[md_axis] == j]
        if not mine:
            raise ValueError(f"this process holds no rank of {md_axis} "
                             f"slice {j}")
        homes.append(mine[0])
    return Xs, ys, vs, [ws[h].clone() for h in homes], homes


def _round_fn(mesh, Xs, ys, vs, homes, md_axis, gens, rate, step_size, reg,
              gradient, updater, mllib: bool):
    """``round_fn(*w_slices, it, reg) -> (*w_slices', it + 1, reg', loss,
    took)``: one iteration, new tensors, never writing its inputs.

    ``mllib`` selects ``GradientDescent.runMiniBatchSGD``'s bookkeeping
    (``ml/optimization.py``): the loss carries the previous update's
    regularization value, and an iteration whose draw took no row leaves
    ``w`` and that value as they were (``took`` False).  Without it
    (``MiniBatchSGD``) the loss carries the new value and every iteration
    updates."""
    local = mesh.local_ranks()
    dp = {r: mesh.coords(r)["dp"] for r in local}
    md = {r: (mesh.coords(r)[md_axis] if md_axis else 0) for r in local}
    first_of_dp = {}
    for r in local:
        first_of_dp.setdefault(dp[r], r)

    def round_fn(*carry):
        ws, it, reg_prev = list(carry[:-2]), carry[-2], carry[-1]
        masks = {}
        for i, r0 in first_of_dp.items():
            n_l = Xs[r0].shape[0]
            masks[i] = bernoulli_mask(gens[i], n_l, rate).float() * vs[r0]
        g_parts = [None] * mesh.size
        lc_parts = [None] * mesh.size
        if md_axis is None:
            for r in local:
                dev = mesh.devices[r]
                m = masks[dp[r]].to(dev)
                g_parts[r], local_loss = gradient.local(
                    Xs[r], ys[r], ws[0].to(dev), m)
                lc_parts[r] = torch.stack([local_loss, torch.sum(m)])
        else:
            parts = [None] * mesh.size
            for r in local:
                parts[r] = mm_f32(Xs[r], ws[md[r]].to(mesh.devices[r]))
            margins = psum_over_mesh(parts, mesh, md_axis)
            for r in local:
                dev = mesh.devices[r]
                m = masks[dp[r]].to(dev)
                c, local_loss = gradient.coefficient(margins[r].to(dev),
                                                     ys[r], m)
                g_parts[r] = _mg.xt_coeff(Xs[r], c)
                lc_parts[r] = torch.stack([local_loss, torch.sum(m)])
        # gradient slices fold over rows only; loss and count are the
        # same on every md shard of a row block, so they fold over dp
        g = psum_over_mesh(g_parts, mesh, "dp")
        lc = psum_over_mesh(lc_parts, mesh, "dp")[homes[0]]
        dev0 = lc.device
        loss_sum, count = lc[0], torch.clamp_min(lc[1], 1.0)
        lr = step_size / torch.sqrt(it + 1.0)
        new_ws, parts = [], []
        for j, h in enumerate(homes):
            dev = mesh.devices[h]
            w2, part = updater.step(ws[j], g[h] / count.to(dev), lr.to(dev),
                                    reg)
            new_ws.append(w2)
            parts.append(part)
        if parts[0] is None:
            reg_new = torch.zeros_like(reg_prev)
        else:
            # |w|^2 and |w|_1 span the md shards: folded in md order
            total = parts[0]
            for part in parts[1:]:
                total = total + part.to(dev0)
            reg_new = updater.value(total, reg)
        if mllib:
            took = lc[1] > 0.0
            new_ws = [torch.where(took.to(w.device), w2, w)
                      for w, w2 in zip(ws, new_ws)]
            stoch = loss_sum / count + reg_prev
            reg_new = torch.where(took, reg_new, reg_prev)
        else:
            took = torch.ones((), dtype=torch.bool, device=dev0)
            stoch = loss_sum / count + reg_new
        return (*new_ws, it + 1.0, reg_new, stoch, took)

    return round_fn


class Trajectory(NamedTuple):
    """A run of :func:`run_iterations`, on the devices: ``w`` after each
    iteration, by ``md`` slice (``(T, d_j)`` each, feature padding
    included), the stochastic losses and the ``took`` flags (``(T,)``
    each), the final ``w`` (numpy, ``(d,)``) and the run's accounting."""

    hist: List[torch.Tensor]
    losses: torch.Tensor
    took: torch.Tensor
    w_final: np.ndarray
    info: Dict[str, float]


def run_iterations(X, y, w0, mesh, iterations: int, rate: float,
                   step_size: float, reg: float, gradient, updater,
                   seed: int, mllib: bool = False,
                   graph: Optional[bool] = None) -> Trajectory:
    """The synchronous loop ``MiniBatchSGD.run`` and
    ``ml.GradientDescent.optimize`` share: ``iterations`` rounds of
    :func:`_round_fn` over ``mesh``, captured as CUDA graphs of
    :data:`~asyncframework_tpu_torch.solvers.base.CHUNK_ROUNDS` iterations
    where every local rank is on one card of one process (``graph=None``;
    False runs them eagerly, True requires the capture)."""
    n, d = X.shape
    md_axis = ("md" if ("md" in mesh.axis_names and mesh.shape["md"] > 1)
               else None)
    w0 = np.asarray(w0, np.float32)
    Xs, ys, vs, ws, homes = _layout(mesh, X, y, w0, md_axis)
    local = mesh.local_ranks()
    gens: Dict[int, torch.Generator] = {}
    for r in local:
        i = mesh.coords(r)["dp"]
        if i not in gens:
            gens[i] = worker_generator(seed, i, mesh.devices[r])
    dev0 = mesh.devices[homes[0]]
    it = torch.zeros((), dtype=torch.float32, device=dev0)
    # MLlib seeds the loss's regularization term from the initial weights
    # (GradientDescent.scala:251-253)
    reg0 = updater.apply(torch.from_numpy(w0), torch.zeros(d), 0.0, 1.0,
                         reg)[1]
    reg_c = torch.tensor(float(reg0), dtype=torch.float32, device=dev0)
    fused = FusedRounds(
        _round_fn(mesh, Xs, ys, vs, homes, md_axis, gens, rate, step_size,
                  reg, gradient, updater, mllib),
        tuple(ws) + (it, reg_c), tuple(gens.values()))
    one_card = (dev0.type == "cuda" and not mesh.spans_processes()
                and all(mesh.devices[r] == dev0 for r in local))
    if graph is None:
        graph = one_card
    elif graph and not one_card:
        raise ValueError("a CUDA graph needs every rank on one card of "
                         "one process")
    T = iterations
    chunk = max(1, min(CHUNK_ROUNDS, T)) if graph else max(T, 1)
    full, rem = divmod(T, chunk)
    runner = _Iterations(fused, chunk, len(ws)) if full else None
    tail = _Iterations(fused, rem, len(ws)) if rem else None
    plan = [runner] * full + ([tail] if tail else [])
    enqueued = T
    if graph and plan:
        built = [c for c in (runner, tail) if c is not None]
        with device_scope(dev0):
            capture_chunks(fused, built)
        enqueued = 2 * sum(c.rounds for c in built)
    hist = [torch.empty((T, w.shape[0]), dtype=w.dtype, device=w.device)
            for w in ws]
    losses = torch.empty(T, dtype=torch.float32, device=dev0)
    took = torch.empty(T, dtype=torch.bool, device=dev0)
    t0 = time.monotonic()
    at = 0
    with device_scope(dev0):
        for c in plan:
            c()
            for h, snap in zip(hist, c.snaps):
                h[at:at + c.rounds].copy_(snap)
            losses[at:at + c.rounds].copy_(c.losses)
            took[at:at + c.rounds].copy_(c.took)
            at += c.rounds
    for r in local:
        fence(mesh.devices[r])
    elapsed = time.monotonic() - t0
    info = {"iterations": T, "graph_replays": len(plan) if graph else 0,
            "enqueued_iterations": enqueued, "ranks": len(local),
            "elapsed_s": elapsed}
    w_final = np.concatenate([w.detach().cpu().numpy()
                              for w in fused.carry[:len(ws)]])[:d]
    return Trajectory(hist, losses, took, w_final, info)


class MiniBatchSGD:
    """Updaters: 'simple' (no reg), 'l2', 'l1' (soft-threshold), matching the
    reference's three Updater classes."""

    def __init__(
        self,
        gamma: float = 1.0,
        batch_rate: float = 1.0,
        num_iterations: int = 100,
        loss: str = "least_squares",
        updater: str = "simple",
        reg_param: float = 0.0,
        seed: int = 42,
        snapshot_every: int = 100,
        convergence_tol: float = 0.0,
        trace_sample: Optional[float] = None,
    ):
        if updater not in UPDATERS:
            raise ValueError(f"unknown updater {updater!r}")
        if loss not in _LOSSES:
            raise ValueError(f"unknown loss {loss!r}")
        self.gamma = gamma
        self.batch_rate = batch_rate
        self.num_iterations = num_iterations
        self.loss = loss
        self.updater = updater
        self.reg_param = reg_param
        self.seed = seed
        self.snapshot_every = snapshot_every
        self.convergence_tol = convergence_tol
        # in-process policy (SolverConfig.trace_sample): tracing is an
        # explicit opt-in
        self.trace_sample = trace_sample
        #: the last run's accounting: iterations, graph replays, the
        #: iterations that enqueued launches (eager: each; captured: the
        #: warm-up's and the capture's), ranks, fenced seconds
        self.last_run: Dict[str, float] = {}

    # ---------------------------------------------------------------- run
    def run(self, X, y, mesh=None, w0=None, graph: Optional[bool] = None):
        """Returns ``(w_final, loss_history, snapshots)`` (numpy), with
        ``snapshots`` the ``Warray`` analog: ``[(iteration, w)]`` every
        ``snapshot_every`` iterations.

        ``X``/``y``: host arrays or tensors (a tensor on a rank's device
        is read in place where no padding is needed).  With a 2-D mesh
        (axes ``("dp", "md")``, md size > 1) the feature dimension shards
        over ``md``.  ``graph``: None captures the iterations as CUDA
        graphs where every local rank is on one card of one process and
        runs them eagerly otherwise; False runs them eagerly; True
        requires the capture."""
        mesh = mesh or make_mesh()
        n, d = X.shape
        w0 = np.zeros(d, np.float32) if w0 is None else np.asarray(w0)
        T = self.num_iterations
        t_run0 = _trace.now_ms()
        run = run_iterations(
            X, y, w0, mesh, T, self.batch_rate, self.gamma, self.reg_param,
            _LOSSES[self.loss](), UPDATERS[self.updater](), self.seed,
            graph=graph)
        self.last_run = run.info
        ws_np = np.concatenate(
            [h.detach().cpu().numpy() for h in run.hist], axis=1)[:, :d]
        losses = run.losses.detach().cpu().numpy()
        wT = run.w_final
        if self.trace_sample is not None and float(self.trace_sample) > 0:
            # the whole run is one compute span (no host between updates,
            # so the per-update decomposition cannot exist here)
            agg = _trace.aggregator()
            ctx = _trace.TraceContext(_trace._new_id(16), 0, T)
            agg.add(_trace.Span(
                stage=_trace.COMPUTE, trace_id=ctx.trace_id,
                span_id=ctx.span_id, parent_id=None, worker_id=0,
                model_version=T, start_ms=t_run0,
                dur_ms=max(0.0, _trace.now_ms() - t_run0),
            ))
        snaps = [(i, ws_np[i]) for i in range(0, T, self.snapshot_every)]
        if self.convergence_tol > 0:
            # post-hoc convergence-tolerance cut (MLlib stops the loop; the
            # captured iterations cannot, so the tail is trimmed after)
            for i in range(1, len(losses)):
                prev, cur = losses[i - 1], losses[i]
                denom = max(abs(prev), abs(cur), 1e-12)
                if abs(prev - cur) / denom < self.convergence_tol:
                    return (ws_np[i], losses[: i + 1],
                            [s for s in snaps if s[0] <= i])
        return wT, losses, snaps

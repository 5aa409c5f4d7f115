"""Step functions of the ASGD and ASAGA paths: worker steps, appliers,
helpers.

Counterpart of the engine-path subset of ``asyncframework_tpu/ops/steps.py``
(dense and padded-ELL sparse).
Every tensor the per-update cycle touches stays on the device; the host
threads move only tensor handles and Python ints.

Model versions: in JAX an old ``w`` handle *is* an old model version, and
trajectory snapshots and in-flight worker tasks hold such handles.  So the
appliers here build the new ``w`` out of place and never write into ``w``.
Only the buffers the JAX package donates are written in place: the
iteration counter ``k`` and the sync drain's accumulator.

- :func:`make_asgd_worker_step`: Bernoulli(b) sample + summed gradient
  (``SparkASGDThread.scala:311-318``), full-shard masked for b > 0.5,
  compacted to :func:`sparse_step_capacity` rows for b <= 0.5.
- :func:`make_asgd_apply`: ``w -= gamma/sqrt(k/numPart+1) * g/(b*N/numPart)``
  (``SparkASGDThread.scala:185-189``), with ``k`` a device f32 scalar.
- :func:`make_sync_apply`: ``w -= gamma/sqrt(k+1) * accGrad/(b*N)``
  (``SparkASGDSync.scala:267-272``).
- :func:`make_asgd_apply_batch`: m drained gradients in one masked
  weighted sum.
- :func:`make_saga_worker_step` / :func:`make_saga_apply` /
  :func:`make_saga_table_delta` / :func:`saga_commit_history`: the ASAGA
  decomposition (``SparkASAGAThread.scala:199-213,369-380``) with the
  per-sample scalar history table on the device, one slice per worker.
  The worker step and the table delta are launches of the masked-gradient
  kernel's history forms.
- :func:`make_sparse_asgd_worker_step`, :func:`make_sparse_saga_worker_step`,
  :func:`make_sparse_saga_commit`, :func:`make_sparse_table_delta`,
  :func:`make_sparse_trajectory_loss_eval`: the padded-ELL (rcv1) path
  (``steps.py:504-670``), always compacted, through kernel S1
  (:mod:`~asyncframework_tpu_torch.ops.sparse_grad`).
- :func:`make_fused_asgd_rounds`, :func:`make_fused_saga_rounds`: one
  full-wave round of the device-resident accept loop (``steps.py:673-855``)
  through the same worker halves, dense and sparse.
"""

from __future__ import annotations

import math

import torch

from asyncframework_tpu_torch.ops.gradients import (
    least_squares_grad_sum,
    logistic_grad_sum,
    make_sparse_grad_sum,
    mm_f32,
    saga_commit_history,  # re-exported: the solvers' committed-history op
    saga_shard_step,
)
from asyncframework_tpu_torch.ops.masked_grad import xt_coeff
from asyncframework_tpu_torch.ops.sampling import bernoulli_mask
from asyncframework_tpu_torch.ops.sparse_grad import compacted_grad, ell_residual


def sparse_step_capacity(batch_rate: float, n_rows: int) -> int:
    """Static slot count for a compacted step: E[count] + 6 sigma of the
    Bernoulli draw, rounded up to 8 and capped at the shard size.  Overflow
    probability per step is ~1e-9; overflowing rows are dropped (the sample
    is fractionally smaller that step, nothing corrupts)."""
    mean = batch_rate * n_rows
    sigma = math.sqrt(max(batch_rate * (1.0 - batch_rate) * n_rows, 0.0))
    cap = int(math.ceil(mean + 6.0 * sigma))
    cap = max(8, ((cap + 7) // 8) * 8)
    return min(cap, n_rows)


def compact_mask(mask: torch.Tensor, cap: int):
    """``(valid, idx)`` for a boolean ``(n,)`` mask: ``idx`` lists the first
    ``cap`` set positions in order, padded with 0; ``valid`` is 1.0 on the
    slots below the count.  Built from a cumsum and a scatter, with no
    device-to-host copy (``jnp.nonzero(size=cap, fill_value=0)`` parity)."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask, 0) - 1
    # set positions scatter to their slot; everything else (and any
    # overflow beyond cap) lands in the extra slot `cap`, which is cut off
    slot = torch.where(mask & (pos < cap), pos, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(n, device=dev))
    valid = (torch.arange(cap, device=dev) < mask.sum()).float()
    return valid, idx[:cap]


def make_asgd_worker_step(batch_rate: float, loss: str = "least_squares"):
    """``step(X, y, w, gen) -> g``: draw the round's sample from the
    worker's generator, then the summed gradient over it.

    For ``batch_rate <= 0.5`` the sampled rows are compacted to a fixed
    capacity first (:func:`sparse_step_capacity`), so the kernel reads
    only ~b of the shard.  The two halves are exposed for tests that feed
    both packages the same sample: ``step.sample(gen, n) -> (weights,
    idx)`` and ``step.grad(X, y, w, weights, idx) -> g``.
    """
    if loss == "least_squares":
        grad_sum = least_squares_grad_sum
    elif loss == "logistic":
        grad_sum = logistic_grad_sum
    else:
        raise ValueError(f"unknown loss {loss!r}")
    compact = batch_rate <= 0.5

    def sample(gen: torch.Generator, n: int):
        mask = bernoulli_mask(gen, n, batch_rate)
        if compact:
            return compact_mask(mask, sparse_step_capacity(batch_rate, n))
        return mask.float(), None

    def grad(X, y, w, weights, idx=None):
        return grad_sum(X, y, w, weights, idx)

    def step(X, y, w, gen):
        return grad(X, y, w, *sample(gen, X.shape[0]))

    step.sample = sample
    step.grad = grad
    return step


def make_asgd_apply(gamma: float, batch_rate: float, n: int, num_workers: int):
    """``apply(w, g, k) -> (w', k)`` with ``k`` advanced by one in place.
    ``w'`` is a new tensor: ``w`` is a model version others may hold."""
    par_recs = batch_rate * n / num_workers

    def apply(w, g, k):
        lr = gamma / torch.sqrt(k / num_workers + 1.0)
        w_new = w - (lr / par_recs) * g
        k.add_(1.0)
        return w_new, k

    return apply


def make_sync_apply(gamma: float, batch_rate: float, n: int):
    """``apply(w, acc_g, k) -> (w', k)`` -- the full-drain synchronous
    update; ``k`` advances in place, ``w`` is kept for snapshots."""

    def apply(w, acc_g, k):
        lr = gamma / torch.sqrt(k + 1.0)
        w_new = w - (lr / (batch_rate * n)) * acc_g
        k.add_(1.0)
        return w_new, k

    return apply


def make_asgd_apply_batch(
    gamma: float, batch_rate: float, n: int, num_workers: int
):
    """``apply_batch(w, G (m, d), mask (m,), k) -> (w', k)``: m drained
    gradients in one masked weighted sum.

    The sequential accept path is ``w <- w - c_j g_j`` with step sizes
    ``c_j = (gamma / sqrt(k_j/P + 1)) / parRecs`` that do not depend on
    ``w``, so a drained batch folds into one product -- the same model up
    to float addition order.  ``mask`` marks accepted slots; ``k`` advances
    in place by their number.
    """
    par_recs = batch_rate * n / num_workers

    def apply_batch(w, G, mask, k):
        kk = k + (torch.cumsum(mask, 0) - mask)  # accepted before each slot
        lr = gamma / torch.sqrt(kk / num_workers + 1.0)
        coeff = (lr / par_recs) * mask
        w_new = w - coeff @ G
        k.add_(mask.sum())
        return w_new, k

    return apply_batch


def make_saga_worker_step(batch_rate: float):
    """``step(X, y, w, alpha, gen) -> (g, diff, mask)``: a Bernoulli(b)
    mask over the full shard (no compaction, as in the JAX package), then
    ``g = X^T (mask * (diff - alpha))`` and the candidate scalars ``diff``
    in one kernel pass.  The halves are exposed as for the ASGD step:
    ``step.sample(gen, n) -> mask`` (f32) and
    ``step.grad(X, y, w, alpha, mask) -> (g, diff)``."""

    def sample(gen: torch.Generator, n: int):
        return bernoulli_mask(gen, n, batch_rate).float()

    def step(X, y, w, alpha, gen):
        mask = sample(gen, X.shape[0])
        return (*saga_shard_step(X, y, w, alpha, mask), mask)

    step.sample = sample
    step.grad = saga_shard_step
    return step


def make_saga_apply(gamma: float, batch_rate: float, n: int, num_workers: int):
    """``apply(w, alpha_bar, g, delta) -> (w', alpha_bar')``:
    ``w' = w - gamma*g/parRecs - gamma*alpha_bar`` (a new tensor: ``w`` is a
    model version others may hold) and ``alpha_bar' = alpha_bar + delta/N``,
    written in place (the JAX package donates ``alpha_bar``).  The sync
    drain passes one accumulator as both ``g`` and ``delta``, which is
    safe: neither is written."""
    par_recs = batch_rate * n / num_workers

    def apply(w, alpha_bar, g, delta):
        w_new = w - (gamma / par_recs) * g - gamma * alpha_bar
        alpha_bar.add_(delta / n)
        return w_new, alpha_bar

    return apply


def make_saga_table_delta():
    """``delta(X, diff, mask, alpha_cur) -> X^T (mask * (diff - alpha_cur))``.

    The exact change the commit makes to the mean history gradient, taken
    against the slice as it is at commit time, so ``alpha_bar`` stays the
    table's mean even when a worker was re-dispatched before its previous
    result was committed (``steps.py:218-237`` of the JAX package).  A plain
    ``X^T c`` there, so a bf16 ``X`` is promoted and ``c`` not rounded: the
    kernel's ``xt_coeff`` form."""

    def delta(X, diff, mask, alpha_cur):
        return xt_coeff(X, mask * (diff - alpha_cur))

    return delta


def add_grads(a, b):
    """Sync drain combine (comOp parity: vector add), accumulated in ``a``
    in place -- the drain's accumulator is dead the moment the next partial
    arrives."""
    return a.add_(b)


def make_trajectory_loss_eval(loss: str = "least_squares"):
    """``eval_shard(X, y, W (S, d)) -> (S,)`` per-snapshot loss sums over a
    shard: all snapshots in one product (``SparkASGDThread.scala:386-401``)."""
    if loss not in ("least_squares", "logistic"):
        raise ValueError(f"unknown loss {loss!r}")

    def eval_shard(X, y, W):
        R = mm_f32(X, W.T)  # (n, S)
        if loss == "least_squares":
            E = R - y[:, None]
            return torch.sum(E * E, dim=0)
        return torch.sum(
            torch.logaddexp(torch.zeros_like(R), R) - y[:, None] * R, dim=0
        )

    return eval_shard


# ------------------------------------------------------------------ sparse
# padded-ELL shards (data/sparse.py): the sampled rows are always compacted
# to sparse_step_capacity slots, as in the JAX package

def _sparse_sample(batch_rate: float):
    """``sample(gen, n) -> (valid, idx)``: a Bernoulli(b) draw compacted to
    :func:`sparse_step_capacity` slots."""

    def sample(gen: torch.Generator, n: int):
        mask = bernoulli_mask(gen, n, batch_rate)
        return compact_mask(mask, sparse_step_capacity(batch_rate, n))

    return sample


def make_sparse_asgd_worker_step(batch_rate: float, d: int):
    """``step(cols, vals, y, w, gen) -> g (d,)``: the sparse worker step
    (``steps.py:543-570``) -- a Bernoulli(b) sample compacted to a fixed
    capacity, the sampled rows' residuals ``r_j = x_j . w - y_j`` and
    ``g = sum_j r_j x_j``, reading only the sampled rows.  The halves are
    exposed for tests that feed both packages one sample:
    ``step.sample(gen, n) -> (valid, idx)`` and
    ``step.grad(cols, vals, y, w, valid, idx) -> g``."""
    sample = _sparse_sample(batch_rate)

    def grad(cols, vals, y, w, valid, idx):
        return compacted_grad(cols, vals, y, w, idx, valid, d)[0]

    def step(cols, vals, y, w, gen):
        return grad(cols, vals, y, w, *sample(gen, y.shape[0]))

    step.sample = sample
    step.grad = grad
    return step


def make_sparse_saga_worker_step(batch_rate: float, d: int):
    """``step(cols, vals, y, w, alpha, gen) -> (g, diff_sel, idx, valid,
    c_sel, v_sel)``, compacted (``steps.py:598-622``): ``diff_sel`` are the
    candidate history scalars of the sampled rows (0 in unfilled slots),
    ``g = sum_j (diff_sel_j - alpha[idx_j]) x_{idx_j}``, and the gathered
    rows ``c_sel``/``v_sel`` (validity-zeroed) ride along for the
    updater's table delta.  Halves as for the ASGD step:
    ``step.sample(gen, n) -> (valid, idx)`` and
    ``step.grad(cols, vals, y, w, alpha, valid, idx) -> (g, ...)``;
    ``step.task(cols, vals, y, w, alpha, valid, idx) -> (g, diff_sel)`` is
    the kernel launch alone, without the gathered rows (the fused rounds
    take no table delta)."""
    sample = _sparse_sample(batch_rate)

    def task(cols, vals, y, w, alpha, valid, idx):
        return compacted_grad(cols, vals, y, w, idx, valid, d, alpha)

    def grad(cols, vals, y, w, alpha, valid, idx):
        g, diff = task(cols, vals, y, w, alpha, valid, idx)
        return g, diff, idx, valid, cols[idx], vals[idx] * valid[:, None]

    def step(cols, vals, y, w, alpha, gen):
        return grad(cols, vals, y, w, alpha, *sample(gen, y.shape[0]))

    step.sample = sample
    step.grad = grad
    step.task = task
    return step


def make_sparse_saga_commit():
    """``commit(alpha, diff_sel, idx, valid) -> alpha'``: ``alpha[idx_j] <-
    diff_sel_j`` for valid slots, into a new tensor (``alpha`` is a slice an
    in-flight task may hold).  Unfilled slots scatter to one extra element
    past the end, which is cut off -- the JAX package's out-of-bounds drop;
    the valid ``idx`` are distinct, so the commit is exact."""

    def commit(alpha, diff_sel, idx, valid):
        n = alpha.shape[0]
        tgt = torch.where(valid > 0, idx, n)
        out = torch.empty(n + 1, dtype=alpha.dtype, device=alpha.device)
        out[:n] = alpha
        out.scatter_(0, tgt, diff_sel)
        return out[:n]

    return commit


def make_sparse_table_delta(d: int):
    """``delta(c_sel, v_sel, diff_sel, alpha_cur, idx) -> (d,)``: the exact
    change the commit makes to the mean history gradient, against the
    current slice (``steps.py:625-640``), as a segment sum over the
    gathered rows."""
    grad_sum = make_sparse_grad_sum(d)

    def delta(c_sel, v_sel, diff_sel, alpha_cur, idx):
        return grad_sum(c_sel, v_sel, diff_sel - alpha_cur[idx])

    return delta


def make_sparse_trajectory_loss_eval():
    """``eval_shard(cols, vals, y, W (S, d)) -> (S,)`` per-snapshot loss
    sums over a shard: one full-shard residual launch a snapshot, so peak
    memory stays one ``(n_p,)`` residual."""

    def eval_shard(cols, vals, y, W):
        sums = []
        for w in W:
            r = ell_residual(cols, vals, y, w)
            sums.append(torch.sum(r * r))
        return torch.stack(sums)

    return eval_shard


# ------------------------------------------------------------------- fused
# The device-resident accept loop (steps.py:673-855 of the JAX package): at
# taw = inf with a full-wave cohort the engine's accept path is "the whole
# wave reads one model version, its gradients are applied in order", a
# function of the state and the workers' draws alone.  Each factory returns
# ONE round as a plain function on tensors; solvers/base.py runs chunks of
# rounds, captured as a CUDA graph on the card.  A round never writes its
# inputs and never copies to the host (one sync would break the capture).

def make_fused_asgd_rounds(gamma: float, batch_rate: float, n: int, shards,
                           generators, loss: str = "least_squares",
                           sparse_d: "int | None" = None):
    """``round_fn(w, k) -> (w', k')``: one full-wave ASGD round.

    ``shards``: one ``(X, y)`` per worker, or with ``sparse_d`` one
    padded-ELL ``(cols, vals, y)`` (least squares only), all on one device;
    ``generators``: each worker's mask generator.  Worker ``i`` draws its
    sample from ``generators[i]`` and takes its gradient through the halves
    of the engine's worker step (``sample`` then ``grad``), so the fused
    path and ``run()`` share one worker computation.  Then, with ``kk = k +
    (0..nw-1)``: ``w' = w - (gamma / sqrt(kk/nw + 1) / parRecs) @ G`` and
    ``k' = k + nw``, both new tensors (``k`` an f32 0-d tensor).
    """
    if loss not in ("least_squares", "logistic"):
        raise ValueError(f"unknown loss {loss!r}")
    if sparse_d is not None:
        if loss != "least_squares":
            raise ValueError(
                "sparse fused rounds support least_squares only (the "
                "compacted residual is least-squares); got " + loss
            )
        step = make_sparse_asgd_worker_step(batch_rate, sparse_d)
    else:
        step = make_asgd_worker_step(batch_rate, loss)
    nw = len(shards)
    par_recs = batch_rate * n / nw
    offsets = torch.arange(nw, dtype=torch.float32, device=shards[0][0].device)

    def round_fn(w, k):
        G = torch.stack([
            step.grad(*shard, w, *step.sample(gen, shard[-1].shape[0]))
            for shard, gen in zip(shards, generators)
        ])
        lr = gamma / torch.sqrt((k + offsets) / nw + 1.0)
        return w - (lr / par_recs) @ G, k + float(nw)

    return round_fn


def make_fused_saga_rounds(gamma: float, batch_rate: float, n: int, shards,
                           generators, sparse_d: "int | None" = None):
    """``round_fn(w, alpha_bar, *alphas) -> (w', alpha_bar', *alphas')``:
    one full-wave ASAGA round (``alphas``: each worker's history slice).

    Every worker computes its history-corrected gradient against the
    round-start ``w`` and its own slice, then commits its candidate scalars
    into a new slice: dense through the kernel's ``saga_grad`` form and
    ``where(mask > 0, diff, alpha)``; sparse through S1's
    ``compacted_grad`` with ``alpha`` and the compacted commit.  The
    results then fold in worker order, ``w <- w - (gamma/parRecs) g_j -
    gamma ab; ab <- ab + g_j/N``.  The table delta of each result is its
    ``g`` exactly (one result a worker a wave, worker-disjoint slices), so
    none is taken.
    """
    if sparse_d is not None:
        step = make_sparse_saga_worker_step(batch_rate, sparse_d)
        commit = make_sparse_saga_commit()

        def one(shard, w, alpha, gen):
            valid, idx = step.sample(gen, shard[-1].shape[0])
            g, diff = step.task(*shard, w, alpha, valid, idx)
            return g, commit(alpha, diff, idx, valid)
    else:
        step = make_saga_worker_step(batch_rate)

        def one(shard, w, alpha, gen):
            mask = step.sample(gen, shard[-1].shape[0])
            g, diff = step.grad(*shard, w, alpha, mask)
            return g, saga_commit_history(alpha, diff, mask)

    par_recs = batch_rate * n / len(shards)

    def round_fn(w, alpha_bar, *alphas):
        results = [one(shard, w, alpha, gen)
                   for shard, alpha, gen in zip(shards, alphas, generators)]
        for g, _ in results:  # the accepts fold in order
            w = w - (gamma / par_recs) * g - gamma * alpha_bar
            alpha_bar = alpha_bar + g / n
        return (w, alpha_bar, *(a for _, a in results))

    return round_fn

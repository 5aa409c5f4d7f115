"""ASAGA: asynchronous SAGA with a per-sample gradient-history table.

Counterpart of ``asyncframework_tpu/solvers/asaga.py`` (parity targets
``SparkASAGAThread.scala`` async and ``SparkASAGASync.scala``), dense and
padded-ELL sparse shards.  For least squares a per-sample gradient is
``scalar_i * x_i`` with ``scalar_i = x_i . w - y_i``, so the history
compresses to one f32 per sample.  Each worker's slice of the table lives
on its shard's device.

Dense shards: a worker task is the mask draw plus one launch of the
masked-gradient kernel's history form: ``g = X^T (mask * (diff - alpha))``
and the candidate scalars ``diff = X w - y`` in one pass over the shard.
The updater, for an accepted result, in this order: the exact table delta
``X^T (mask * (diff - alpha_cur))`` against the slice as it is now (the
kernel's ``xt_coeff`` form), the commit ``where(mask, diff, alpha_cur)``,
then the apply ``w -= gamma * (g/parRecs + alpha_bar)``;
``alpha_bar += delta/N`` -- which keeps ``alpha_bar`` the table's mean
exactly.

Sparse shards: the sample is compacted to ``(idx, valid)`` slots and the
task runs kernel S1 (residual, sort, segment sum) over the sampled rows
only, returning ``(g, diff_sel, idx, valid, c_sel, v_sel)``; the table
delta is an S1 segment sum over ``c_sel``/``v_sel`` against the current
slice, and the commit a scatter of the valid slots.  The sync drain moves
only ``(diff_sel, idx, valid)`` to the commit.

Staleness filter quirk kept from the reference: ASAGA accepts iff
``k - staleness <= taw`` (the ASGD driver tests ``staleness <= taw``).

Versions and buffers: ``w`` and the history slices are never written in
place (an old ``w`` is a model version; an in-flight task may still hold
an old slice).  Written in place, where the JAX package donates: the
committed slice goes into the worker's ``diff`` buffer, and ``alpha_bar``
is advanced in place.

Fused mode (:meth:`ASAGA.run_fused`): full waves against the round-start
``w``, each worker's slice committed in the round and the results folded in
worker order, a chunk of rounds one CUDA-graph replay on the card.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): checkpointing, speculation and dynamic allocation.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Tuple

import torch

from asyncframework_tpu_torch.broadcast import VersionedModelStore
from asyncframework_tpu_torch.context import AsyncContext
from asyncframework_tpu_torch.engine.barrier import bucket_predicate, partial_barrier
from asyncframework_tpu_torch.engine.recovery import ShardRecovery
from asyncframework_tpu_torch.engine.scheduler import ASYNC, JobScheduler
from asyncframework_tpu_torch.engine.straggler import DelayModel
from asyncframework_tpu_torch.ops import steps
from asyncframework_tpu_torch.ops.sampling import worker_generator
from asyncframework_tpu_torch.solvers.base import (
    DelayCalibrator,
    FusedRounds,
    ShardedSolverMixin,
    SolverConfig,
    TrainResult,
    WaitingTimeTable,
    check_hbm_plan,
    check_ported,
    resolve_dataset,
)
from asyncframework_tpu_torch.solvers.instrumentation import RunInstruments
from asyncframework_tpu_torch.utils.devices import (
    device_scope,
    fence,
    resolve_devices,
)
from asyncframework_tpu_torch.utils.hbm import shard_tensors


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


class ASAGA(ShardedSolverMixin):
    def __init__(self, X, y, config: SolverConfig, devices=None):
        """``X`` may be a host array (sharded here) or a pre-built
        :class:`ShardedDataset` (e.g. generated on device), with ``y=None``.
        ``devices=None`` means every CUDA device, and raises without one."""
        if config.loss != "least_squares":
            raise ValueError(
                "ASAGA's scalar history compression requires least_squares "
                "(gradient = scalar * x); got " + config.loss
            )
        check_ported(config)
        self.cfg = config
        self.devices = resolve_devices(devices)
        check_hbm_plan(X, config, self.devices, history_table=True)
        self.ds = resolve_dataset(X, y, config.num_workers, self.devices)
        self.driver_device = self.devices[0]
        self._sparse = bool(getattr(self.ds, "is_sparse", False))
        if self._sparse:
            self._step = steps.make_sparse_saga_worker_step(
                config.batch_rate, self.ds.d
            )
            self._commit_slice = steps.make_sparse_saga_commit()
            self._table_delta = steps.make_sparse_table_delta(self.ds.d)
            self._eval = steps.make_sparse_trajectory_loss_eval()
        else:
            self._step = steps.make_saga_worker_step(config.batch_rate)
            self._table_delta = steps.make_saga_table_delta()
            self._eval = steps.make_trajectory_loss_eval("least_squares")
        self._apply = steps.make_saga_apply(
            config.gamma, config.batch_rate, self.ds.n, config.num_workers
        )
        self._recovery = ShardRecovery(self.ds, self.devices)

    # ------------------------------------------------------------ state
    def _zeros(self, n: int, device=None) -> torch.Tensor:
        dev = self.driver_device if device is None else device
        return torch.zeros(n, dtype=torch.float32, device=dev)

    def _initial_table(self) -> Dict[int, torch.Tensor]:
        """The history table: one zero slice per worker, on its shard's
        device."""
        return {
            wid: self._zeros(self.ds.shard(wid).size, self._shard_device(wid))
            for wid in range(self.cfg.num_workers)
        }

    def _fault_tolerance_with_table(self, sched, inst, alpha, hot_lock):
        def on_shard_moved(shard_id, moved):
            # the history slice follows the shard's new home
            with hot_lock:
                alpha[shard_id] = alpha[shard_id].to(moved.device)

        return self._fault_tolerance(sched, inst, on_moved=on_shard_moved)

    def _commit(self, wid: int, res, alpha, hot_lock, with_delta: bool):
        """Commit an accepted result's candidates into worker ``wid``'s
        slice, on the slice's current home; returns the exact table delta
        against the slice as it was (``with_delta``), else None.  A sparse
        result's payload is ``(diff_sel, idx, valid, c_sel, v_sel)``; the
        sync drain (no delta) moves only its first three."""
        shard = self._recovery.shard(wid)
        payload = res.data[1:]
        if self._sparse and not with_delta:
            payload = payload[:3]
        with hot_lock:
            alpha_cur = alpha[wid]
            home = alpha_cur.device
            # a shard re-homed while this result was in flight leaves the
            # payload on the old device
            payload = [_to(a, home) for a in payload]
            with device_scope(home):
                if self._sparse:
                    diff, idx, valid = payload[:3]
                    delta = (
                        self._table_delta(*payload[3:], diff, alpha_cur, idx)
                        if with_delta else None
                    )
                    alpha[wid] = self._commit_slice(alpha_cur, diff, idx,
                                                    valid)
                else:
                    diff, mask = payload
                    delta = (
                        self._table_delta(shard.X, diff, mask, alpha_cur)
                        if with_delta else None
                    )
                    alpha[wid] = steps.saga_commit_history(alpha_cur, diff,
                                                           mask)
        return delta

    # ------------------------------------------------------------------ async
    def run(self) -> TrainResult:
        """Asynchronous mode (SparkASAGAThread parity)."""
        cfg = self.cfg
        nw = cfg.num_workers
        drv = self.driver_device
        ctx: AsyncContext = AsyncContext()
        sched = JobScheduler(num_workers=nw, devices=self.devices)
        sched.set_mode(ASYNC)
        self.scheduler = sched  # exposed for fault-injection tests/tools
        delay_model = DelayModel(cfg.coeff, nw, cfg.seed)
        calibrator = DelayCalibrator(cfg.effective_calibration_iters())
        waiting = WaitingTimeTable()
        inst = RunInstruments(cfg, nw)
        inst.register_queue_depth(ctx.size)
        d = self.ds.d
        alpha = self._initial_table()
        hot_lock = threading.Lock()  # guards the alpha slots
        ft = self._fault_tolerance_with_table(sched, inst, alpha, hot_lock)
        # stale-read experiment (SparkASAGAThread.scala:268): workers read
        # model version (latest - offset)
        store = (
            VersionedModelStore(cfg.max_live_versions)
            if cfg.stale_read_offset is not None
            else None
        )
        gens, gen_locks = self._generators()
        state = {"w": self._zeros(d), "ab": self._zeros(d), "k": 0,
                 "accepted": 0, "dropped": 0, "rounds": 0, "flops": 0.0}
        state_lock = threading.Lock()
        stop = threading.Event()
        self._warm_hot_path()
        start_wall = time.monotonic()
        snapshots: List[Tuple[float, torch.Tensor]] = [(0.0, state["w"])]

        def now_ms():
            return (time.monotonic() - start_wall) * 1e3

        def updater():
            while not stop.is_set():
                with state_lock:
                    if state["k"] >= cfg.num_iterations:
                        break
                try:
                    res = ctx.collect_all(timeout=cfg.collect_timeout_s)
                except queue.Empty:
                    continue
                task_ms = waiting.on_finish(res.worker_id, now_ms())
                with state_lock:
                    state["flops"] += self._task_flops(res.worker_id)
                    k = state["k"]
                    # ASAGA acceptance quirk: k - staleness <= taw
                    accepted = k - res.staleness <= cfg.taw
                    if accepted:
                        # table delta against the current slice, the
                        # commit, then the apply (alpha_bar == mean(table))
                        delta = self._commit(res.worker_id, res, alpha,
                                             hot_lock, with_delta=True)
                        with device_scope(drv):
                            state["w"], state["ab"] = self._apply(
                                state["w"], state["ab"], _to(res.data[0], drv),
                                _to(delta, drv),
                            )
                        state["k"] = k + 1
                        state["accepted"] += 1
                        calibrator.record(k, task_ms)
                        if k % cfg.printer_freq == 0:
                            snapshots.append((now_ms(), state["w"]))
                    else:
                        state["dropped"] += 1
                inst.on_gradient_merged(
                    res.worker_id, res.staleness, accepted, k,
                    batch_size=res.batch_size, task_ms=task_ms,
                )
                if calibrator.maybe_finalize(state["k"]):
                    delay_model.calibrate(calibrator.avg_delay_ms)
            stop.set()

        upd = threading.Thread(target=updater, name="saga-updater", daemon=True)
        upd.start()

        waiters: deque = deque(maxlen=4 * nw)
        deadline = time.monotonic() + cfg.run_timeout_s
        run_ok = False
        try:
            while not stop.is_set() and time.monotonic() < deadline:
                failed = next((x.failed for x in waiters if x.failed), None)
                if failed is not None:
                    raise RuntimeError("async job aborted") from failed
                with state_lock:
                    if state["k"] >= cfg.num_iterations:
                        break
                cohort = partial_barrier(
                    ctx, nw, bucket_predicate(ctx, nw, cfg.bucket_ratio)
                )
                if not cohort:
                    time.sleep(0.001)
                    continue
                with state_lock:
                    w_pub = state["w"]  # never written in place = a version
                    model_version = state["k"]
                if store is not None:
                    v = store.publish(w_pub.cpu().numpy())
                    live = store.live_versions()
                    tv = max(live[0], v - cfg.stale_read_offset)
                    w_pub = store.value(drv, version=tv)
                    model_version = v
                ts = ctx.get_current_time()
                ctx.set_last_time(ts)
                ctx.mark_busy(cohort)
                waiting.on_submit(cohort, now_ms())
                with hot_lock:
                    captured = {wid: alpha[wid] for wid in cohort}
                fns = {
                    wid: self._make_task(wid, w_pub, captured[wid], gens[wid],
                                         gen_locks[wid], delay_model)
                    for wid in cohort
                }
                with state_lock:
                    state["rounds"] += 1
                    round_idx = state["rounds"]
                # post before launching: a fast worker could otherwise merge
                # before its round's RoundSubmitted event exists
                inst.on_round_submitted(round_idx, cohort, model_version)
                waiters.append(
                    sched.run_job(fns, self._handler(ctx, ts, now_ms))
                )
            run_ok = True
        finally:
            stop.set()
            upd.join(timeout=10)
            if ft is not None:
                ft.stop()
            sched.shutdown()
            if not run_ok:
                inst.close()  # crash path

        with state_lock:
            final_w_dev, final_ab = state["w"], state["ab"]
        # fence before taking elapsed: updates/s covers device work done
        fence(drv)
        final_w = final_w_dev.cpu().numpy()
        elapsed = time.monotonic() - start_wall
        snapshots.append((elapsed * 1e3, final_w_dev))
        traj = self._evaluate_trajectory(snapshots)
        extras = inst.extras()
        inst.close(traj, cfg.printer_freq)
        return TrainResult(
            final_w=final_w,
            trajectory=traj,
            elapsed_s=elapsed,
            accepted=state["accepted"],
            dropped=state["dropped"],
            rounds=state["rounds"],
            max_staleness=ctx.max_staleness(),
            avg_delay_ms=calibrator.avg_delay_ms,
            updates_per_sec=state["accepted"] / elapsed if elapsed > 0 else 0.0,
            total_flops=state["flops"],
            waiting_time_ms=waiting.snapshot(),
            extras={
                "alpha": {wid: a.cpu().numpy() for wid, a in alpha.items()},
                "alpha_bar": final_ab.cpu().numpy(),
                **extras,
            },
        )

    # ----------------------------------------------------------------- fused
    def fused_rounds(self) -> FusedRounds:
        """The fused loop's round (``steps.make_fused_saga_rounds``) over
        every shard on the driver device, its state ``(w, alpha_bar,
        *alphas)`` at zero (the whole history table on that device) and
        the workers' generators."""
        shards, gens = self._fused_inputs()
        round_fn = steps.make_fused_saga_rounds(
            self.cfg.gamma, self.cfg.batch_rate, self.ds.n, shards, gens,
            sparse_d=self.ds.d if self._sparse else None,
        )
        alphas = tuple(self._zeros(s[-1].shape[0]) for s in shards)
        return FusedRounds(round_fn, (self._zeros(self.ds.d),
                                      self._zeros(self.ds.d), *alphas), gens)

    def run_fused(self) -> TrainResult:
        """The device-resident ASAGA loop (``solvers/asaga.py:418-...`` of
        the JAX package; semantics in ``steps.make_fused_saga_rounds``):
        chunks of full-wave rounds, one CUDA-graph replay a chunk on the
        card, eager on the CPU, with the history slices in the state, so
        the whole table stays on the device.  Dense and padded-ELL sparse
        shards.  Scope as :meth:`ASGD.run_fused`, plus ASAGA's ``taw``
        quirk below; ``extras`` carries the final ``alpha_bar`` and every
        worker's slice, as :meth:`run` does."""
        if self.cfg.taw < self.cfg.num_iterations:
            # ASAGA's acceptance quirk binds on the iteration count (accept
            # iff k - staleness <= taw), so only taw >= num_iterations
            # guarantees the engine's filter never fires
            raise ValueError(
                "fused ASAGA requires taw >= num_iterations (the ASAGA "
                "filter quirk `k - staleness <= taw` binds on iteration "
                "count); a tighter taw needs the engine's filter -- use "
                "run()"
            )

        def history(carry):
            _, alpha_bar, *alphas = carry
            return {"alpha_bar": alpha_bar.cpu().numpy(),
                    "alpha": {wid: a.cpu().numpy()
                              for wid, a in enumerate(alphas)}}

        return self._run_fused(history)

    # ------------------------------------------------------------------- sync
    def run_sync(self) -> TrainResult:
        """SparkASAGASync parity: drain all workers per round, commit every
        history, apply one accumulated update with ``parRecs = b*N``."""
        cfg = self.cfg
        nw = cfg.num_workers
        drv = self.driver_device
        ctx: AsyncContext = AsyncContext()
        sched = JobScheduler(num_workers=nw, devices=self.devices)
        sched.set_mode(ASYNC)
        self.scheduler = sched  # exposed for fault-injection tests/tools
        delay_model = DelayModel(cfg.coeff, nw, cfg.seed)
        # rounds, not accepted gradients; explicit calibration_iters overrides
        calibrator = DelayCalibrator(
            cfg.calibration_iters if cfg.calibration_iters is not None else 100
        )
        waiting = WaitingTimeTable()
        inst = RunInstruments(cfg, nw)
        inst.register_queue_depth(ctx.size)
        sync_apply = steps.make_saga_apply(
            cfg.gamma, cfg.batch_rate, self.ds.n, 1  # parRecs = b*N
        )
        d = self.ds.d
        w = self._zeros(d)
        alpha_bar = self._zeros(d)
        alpha = self._initial_table()
        hot_lock = threading.Lock()
        ft = self._fault_tolerance_with_table(sched, inst, alpha, hot_lock)
        gens, gen_locks = self._generators()
        self._warm_hot_path(apply=sync_apply, sync=True)
        start_wall = time.monotonic()
        snapshots: List[Tuple[float, torch.Tensor]] = [(0.0, w)]

        def now_ms():
            return (time.monotonic() - start_wall) * 1e3

        rounds = 0
        flops = 0.0
        run_ok = False
        try:
            for k in range(cfg.num_iterations):
                cohort = list(range(nw))
                ts = ctx.get_current_time()
                ctx.mark_busy(cohort)
                waiting.on_submit(cohort, now_ms())
                with hot_lock:
                    captured = {wid: alpha[wid] for wid in cohort}
                fns = {
                    wid: self._make_task(wid, w, captured[wid], gens[wid],
                                         gen_locks[wid], delay_model)
                    for wid in cohort
                }
                inst.on_round_submitted(k, cohort, model_version=k)
                waiter = sched.run_job(fns, self._handler(ctx, ts, now_ms))
                acc = None
                reported = set()
                for _ in range(nw):
                    res = self._collect_checked(
                        ctx, waiter, cfg.run_timeout_s,
                        pool=sched.pool, cohort=cohort, collected=reported,
                    )
                    reported.add(res.worker_id)
                    flops += self._task_flops(res.worker_id)
                    task_ms = waiting.on_finish(res.worker_id, now_ms())
                    calibrator.record(k, task_ms)
                    inst.on_gradient_merged(
                        res.worker_id, res.staleness, True, k,
                        batch_size=res.batch_size, task_ms=task_ms,
                    )
                    self._commit(res.worker_id, res, alpha, hot_lock,
                                 with_delta=False)
                    g = _to(res.data[0], drv)
                    acc = g if acc is None else steps.add_grads(acc, g)
                # the sync drain has no dispatch overlap: table delta == g
                with device_scope(drv):
                    w, alpha_bar = sync_apply(w, alpha_bar, acc, acc)
                rounds += 1
                if k % cfg.printer_freq == 0:
                    snapshots.append((now_ms(), w))
                if calibrator.maybe_finalize(k):
                    delay_model.calibrate(calibrator.avg_delay_ms)
            run_ok = True
        finally:
            if ft is not None:
                ft.stop()
            sched.shutdown()
            if not run_ok:
                inst.close()  # crash path

        fence(drv)  # see the async path
        final_w = w.cpu().numpy()
        elapsed = time.monotonic() - start_wall
        snapshots.append((elapsed * 1e3, w))
        traj = self._evaluate_trajectory(snapshots)
        extras = inst.extras()
        inst.close(traj, cfg.printer_freq)
        return TrainResult(
            final_w=final_w,
            trajectory=traj,
            elapsed_s=elapsed,
            accepted=rounds * nw,
            rounds=rounds,
            max_staleness=ctx.max_staleness(),
            avg_delay_ms=calibrator.avg_delay_ms,
            updates_per_sec=rounds / elapsed if elapsed > 0 else 0.0,
            total_flops=flops,
            waiting_time_ms=waiting.snapshot(),
            extras={
                "alpha": {wid: a.cpu().numpy() for wid, a in alpha.items()},
                "alpha_bar": alpha_bar.cpu().numpy(),
                **extras,
            },
        )

    # ---------------------------------------------------------------- helpers
    def _warm_hot_path(self, apply=None, sync: bool = False) -> None:
        """Run this mode's hot path once before the trajectory clock starts
        (parity: the reference's blocking first iteration,
        ``DAGScheduler.scala:641-656``); here the first use builds the CUDA
        kernels (nvcc) and fills the caching allocator.  Each distinct
        (shard shape, device) runs the worker step, the table delta (async
        only) and the commit once, on fresh tensors; the applier runs on
        fresh tensors too, never on live state."""
        apply = apply if apply is not None else self._apply
        d = self.ds.d
        drv = self.driver_device
        g = delta = None
        seen = set()
        for wid in range(self.cfg.num_workers):
            shard = self._recovery.shard(wid)
            dev = shard.device
            arrays = shard_tensors(shard)
            key = (tuple(arrays[0].shape), dev)
            if key in seen:
                continue
            seen.add(key)
            with device_scope(dev):
                a0 = self._zeros(shard.size, dev)
                out = self._step(*arrays, self._zeros(d, dev), a0,
                                 worker_generator(0, 0, dev))
                g, diff = out[0], out[1]
                if self._sparse:
                    _, _, idx, valid, c_sel, v_sel = out
                    if not sync:
                        delta = self._table_delta(c_sel, v_sel, diff, a0, idx)
                    self._commit_slice(a0, diff, idx, valid)
                else:
                    mask = out[2]
                    if not sync:
                        delta = self._table_delta(shard.X, diff, mask, a0)
                    steps.saga_commit_history(a0, diff, mask)
        with device_scope(drv):
            g = _to(g, drv)
            delta = g if sync else _to(delta, drv)
            apply(self._zeros(d), self._zeros(d), g, delta)
        for dev in set(self.devices):
            fence(dev)

    def _make_task(self, wid: int, w_pub, alpha_slice, gen, gen_lock,
                   delay_model):
        # recovery view: a re-homed shard is transparently computed on its
        # new device; w and the captured slice follow the shard's home
        shard = self._recovery.shard(wid)
        delay_ms = delay_model.delay_ms(wid)
        dev = shard.device
        step = self._step
        # the injected delay models a slow machine: it fires once, and a
        # replacement executor bypasses it
        delay_fired = threading.Event()

        def fn():
            if delay_ms > 0 and not delay_fired.is_set():
                delay_fired.set()
                time.sleep(delay_ms / 1e3)
            with device_scope(dev):
                with gen_lock:
                    sample = step.sample(gen, shard.size)
                # (valid, idx) sparse; the full-shard mask dense
                drawn = sample if self._sparse else (sample,)
                out = step.grad(*shard_tensors(shard), _to(w_pub, dev),
                                _to(alpha_slice, dev), *drawn)
                if dev.type == "cuda":
                    # completion only; the results stay on the device
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
            # (g, diff, mask) dense; (g, diff_sel, idx, valid, c_sel,
            # v_sel) sparse
            return out if self._sparse else (*out, sample)

        return fn

    def _handler(self, ctx: AsyncContext, submit_clock: int, now_ms):
        submit_wall = now_ms()
        par_recs = int(self.cfg.batch_rate * self.ds.n / self.cfg.num_workers)

        def handler(wid: int, result):
            ctx.merge_result(
                wid,
                result,
                submit_clock=submit_clock,
                elapsed_ms=now_ms() - submit_wall,
                batch_size=par_recs,
            )

        return handler

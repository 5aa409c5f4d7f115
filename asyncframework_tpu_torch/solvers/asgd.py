"""ASGD: asynchronous (and synchronous) stochastic gradient descent.

Counterpart of ``asyncframework_tpu/solvers/asgd.py``:

- async mode ~ ``SparkASGDThread.scala`` -- two driver threads (submitter +
  updater) around an :class:`AsyncContext`; per-worker gradients stream in and
  are applied under a staleness bound ``taw``; cohorts are selected by a
  partial barrier over worker availability; stragglers can be injected after a
  calibration phase.
- sync mode ~ ``SparkASGDSync.scala`` -- the same non-blocking submission
  machinery, but each round drains exactly ``num_workers`` results and applies
  one accumulated update (the "barrier in the driver").
- fused mode (:meth:`ASGD.run_fused`) -- the device-resident accept loop:
  full waves applied in order with no host work between updates, a chunk
  of rounds one CUDA-graph replay (``solvers/base.py::run_fused_plan``).

Device hot path: every tensor the algorithm touches stays in device memory.
A worker task is the mask draw plus one launch of the hand-written
masked-gradient kernel on the worker's device (dense shards), or the
compacted draw, kernel S1's residual, a sort and S1's segment sum
(padded-ELL sparse shards, least squares only); the updater's accept path is
a scaled axpy with the iteration counter ``k`` on the device.  The model is
never written in place, so an old ``w`` tensor is an old model version
(snapshots and in-flight tasks hold them).

Streams: every launch of a run goes to its device's current stream (the
default stream -- no thread sets another), so a gradient is complete, in
stream order, before any later launch that reads it.  A task still fences
its gradient with a CUDA event synchronised on the worker thread (the
``block_until_ready`` of the JAX package), so task times and the
calibrated delays measure device work, not the enqueue.
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

# minimum drained-batch size for the stacked one-launch apply: below this,
# the stack copy costs more than the launches it saves
BATCH_DRAIN_MIN = 3


class ASGD(ShardedSolverMixin):
    def __init__(self, X, y, config: SolverConfig, devices=None):
        """``X`` may be a host array (sharded here) or a pre-built
        :class:`ShardedDataset` (e.g. generated on device), with ``y=None``.
        ``devices=None`` means every CUDA device, and raises without one."""
        check_ported(config)
        self.cfg = config
        self.devices = resolve_devices(devices)
        check_hbm_plan(X, config, self.devices)
        self.ds = resolve_dataset(X, y, config.num_workers, self.devices)
        self.driver_device = self.devices[0]
        if getattr(self.ds, "is_sparse", False):
            if config.loss != "least_squares":
                raise ValueError(
                    "sparse shards currently support least_squares only"
                )
            self._step = steps.make_sparse_asgd_worker_step(
                config.batch_rate, self.ds.d
            )
            self._eval = steps.make_sparse_trajectory_loss_eval()
        else:
            self._step = steps.make_asgd_worker_step(
                config.batch_rate, config.loss
            )
            # flops accounting mirrors the step's row compaction gate
            self._dense_compact = config.batch_rate <= 0.5
            self._eval = steps.make_trajectory_loss_eval(config.loss)
        self._apply = steps.make_asgd_apply(
            config.gamma, config.batch_rate, self.ds.n, config.num_workers
        )
        self._sync_apply = steps.make_sync_apply(
            config.gamma, config.batch_rate, self.ds.n
        )
        # all shard access routes through the recovery view so a re-homed
        # shard is transparently picked up by later rounds and by evaluation
        self._recovery = ShardRecovery(self.ds, self.devices)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.driver_device)

    # ------------------------------------------------------------------ async
    def run(self) -> TrainResult:
        """Asynchronous mode (SparkASGDThread parity)."""
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
        ft = self._fault_tolerance(sched, inst)
        # stale-read experiment: workers read version (latest - offset)
        store = (
            VersionedModelStore(cfg.max_live_versions)
            if cfg.stale_read_offset is not None
            else None
        )
        gens, gen_locks = self._generators()
        state = {
            "w": self._zeros(self.ds.d),
            "k_dev": self._zeros(),
            "k": 0,
            "accepted": 0,
            "dropped": 0,
            "rounds": 0,
            "flops": 0.0,
        }
        state_lock = threading.Lock()
        stop = threading.Event()
        apply_batch = steps.make_asgd_apply_batch(
            cfg.gamma, cfg.batch_rate, self.ds.n, nw
        )
        max_drain = max(cfg.drain_batch, 1)
        self._warm_hot_path(apply_batch, max_drain)
        start_wall = time.monotonic()
        snapshots: List[Tuple[float, torch.Tensor]] = [(0.0, state["w"])]

        def now_ms() -> float:
            return (time.monotonic() - start_wall) * 1e3

        # Short drains pad the gradient list with one zero vector so the
        # stacked G is always (max_drain, d); the slot masks are cached per
        # accepted count.
        mask_cache: Dict[int, torch.Tensor] = {}
        zero_g = self._zeros(self.ds.d)

        # ---------------------------------------------------- updater thread
        def updater():
            while not stop.is_set():
                with state_lock:
                    if state["k"] >= cfg.num_iterations:
                        break
                try:
                    results = [ctx.collect_all(timeout=cfg.collect_timeout_s)]
                except queue.Empty:
                    continue
                # opportunistic drain: everything already queued, up to the
                # batch cap, folds into one apply below
                while len(results) < max_drain:
                    try:
                        results.append(ctx.collect_all(timeout=0))
                    except queue.Empty:
                        break
                with state_lock:
                    k = state["k"]
                    # never apply past the iteration budget: trim the batch
                    room = cfg.num_iterations - k
                    merged = []
                    accepted_g = []
                    for res in results:
                        state["flops"] += self._task_flops(res.worker_id)
                        task_ms = waiting.on_finish(res.worker_id, now_ms())
                        if res.staleness > cfg.taw:
                            state["dropped"] += 1
                            merged.append(
                                (res, False, task_ms, k + len(accepted_g))
                            )
                        elif len(accepted_g) < room:
                            g = res.data
                            if g.device != drv:
                                g = g.to(drv)
                            accepted_g.append(g)
                            calibrator.record(
                                k + len(accepted_g) - 1, task_ms
                            )
                            merged.append(
                                (res, True, task_ms, k + len(accepted_g) - 1)
                            )
                        # else: beyond the iteration budget -- ignored
                    if len(accepted_g) >= BATCH_DRAIN_MIN:
                        mcount = len(accepted_g)
                        G = torch.stack(
                            accepted_g + [zero_g] * (max_drain - mcount)
                        )
                        mask = mask_cache.get(mcount)
                        if mask is None:
                            mask = self._zeros(max_drain)
                            mask[:mcount] = 1.0
                            mask_cache[mcount] = mask
                        state["w"], state["k_dev"] = apply_batch(
                            state["w"], G, mask, state["k_dev"]
                        )
                    else:
                        for g in accepted_g:
                            state["w"], state["k_dev"] = self._apply(
                                state["w"], g, state["k_dev"]
                            )
                    if accepted_g:
                        state["k"] = k + len(accepted_g)
                        state["accepted"] += len(accepted_g)
                        # snapshot when the batch crossed a printer boundary
                        if any(
                            (k + j) % cfg.printer_freq == 0
                            for j in range(len(accepted_g))
                        ):
                            snapshots.append((now_ms(), state["w"]))
                for res, accepted, task_ms, at_k in merged:
                    inst.on_gradient_merged(
                        res.worker_id, res.staleness, accepted, at_k,
                        batch_size=res.batch_size, task_ms=task_ms,
                    )
                if calibrator.maybe_finalize(state["k"]):
                    delay_model.calibrate(calibrator.avg_delay_ms)
            stop.set()

        upd = threading.Thread(target=updater, name="ps-updater", daemon=True)
        upd.start()

        # ---------------------------------------------------- submitter loop
        waiters: deque = deque(maxlen=4 * nw)  # recent jobs, failure check
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
                # cold workers (no STAT entry) always selected; warm workers
                # only when the availability threshold is met
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
                    # ASYNCbroadcast parity: publish this round's model as a
                    # new version, then point workers at (latest - offset);
                    # the version's tensor is resolved here, at submit time,
                    # so a straggler never re-queries an evicted version
                    v = store.publish(w_pub.cpu().numpy())
                    live = store.live_versions()
                    tv = max(live[0], v - cfg.stale_read_offset)
                    w_pub = store.value(drv, version=tv)
                    model_version = v
                ts = ctx.get_current_time()
                ctx.set_last_time(ts)
                ctx.mark_busy(cohort)
                waiting.on_submit(cohort, now_ms())
                fns = {
                    wid: self._make_task(
                        wid, w_pub, gens[wid], gen_locks[wid], delay_model
                    )
                    for wid in cohort
                }
                with state_lock:
                    state["rounds"] += 1
                    round_idx = state["rounds"]
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
            final_w_dev = state["w"]
        # fence BEFORE taking elapsed, so updates/s covers the work done on
        # the device, not merely enqueued
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
            extras=extras,
        )

    # ----------------------------------------------------------------- fused
    def fused_rounds(self) -> FusedRounds:
        """The fused loop's round (``steps.make_fused_asgd_rounds``) over
        every shard on the driver device, its state ``(w, k)`` at zero and
        the workers' generators."""
        shards, gens = self._fused_inputs()
        sparse = getattr(self.ds, "is_sparse", False)
        round_fn = steps.make_fused_asgd_rounds(
            self.cfg.gamma, self.cfg.batch_rate, self.ds.n, shards, gens,
            loss=self.cfg.loss, sparse_d=self.ds.d if sparse else None,
        )
        return FusedRounds(round_fn, (self._zeros(self.ds.d), self._zeros()),
                           gens)

    def run_fused(self) -> TrainResult:
        """The device-resident accept loop (``solvers/asgd.py:454-550`` of
        the JAX package): the ``taw``-unbounded full-wave recipe as chunks
        of rounds with no host work between updates -- on a CUDA device one
        CUDA-graph replay a chunk of up to 16 rounds, on the CPU the same
        rounds run eagerly.  Dense and padded-ELL sparse shards.

        Scope: the recipe of the reference's headline runs (``taw >=
        num_workers - 1``, no straggler injection); anything needing the
        runtime (a tighter staleness bound, stragglers, fault tolerance)
        runs :meth:`run`.
        """
        nw = self.cfg.num_workers
        if self.cfg.taw < nw - 1:
            # one wave in flight, applied in order: the fused staleness is
            # at most nw-1 by construction, so any taw >= nw-1 is a valid
            # bounded-staleness execution (ASGD's filter would never fire)
            raise ValueError(
                f"run_fused admits taw >= num_workers-1 = {nw - 1} (its "
                "wave staleness never exceeds that); a tighter taw needs "
                "the engine's tau filter -- use run()"
            )
        return self._run_fused()

    # ------------------------------------------------------------------ sync
    def run_sync(self) -> TrainResult:
        """SparkASGDSync parity: submit to all, drain all, one update/round."""
        cfg = self.cfg
        nw = cfg.num_workers
        drv = self.driver_device
        ctx: AsyncContext = AsyncContext()
        sched = JobScheduler(num_workers=nw, devices=self.devices)
        sched.set_mode(ASYNC)  # non-blocking submit + driver-side drain
        self.scheduler = sched  # exposed for fault-injection tests/tools
        delay_model = DelayModel(cfg.coeff, nw, cfg.seed)
        # sync counts rounds, not accepted gradients: the reference's
        # k < 100*numPart window covers the first 100 full-drain rounds.
        # An explicit calibration_iters overrides (in rounds).
        calibrator = DelayCalibrator(
            cfg.calibration_iters if cfg.calibration_iters is not None else 100
        )
        waiting = WaitingTimeTable()
        inst = RunInstruments(cfg, nw)
        inst.register_queue_depth(ctx.size)
        ft = self._fault_tolerance(sched, inst)
        gens, gen_locks = self._generators()
        w = self._zeros(self.ds.d)
        k_dev = self._zeros()
        self._warm_hot_path(sync=True)
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
                fns = {
                    wid: self._make_task(
                        wid, w, gens[wid], gen_locks[wid], delay_model
                    )
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
                    g = res.data
                    flops += self._task_flops(res.worker_id)
                    task_ms = waiting.on_finish(res.worker_id, now_ms())
                    calibrator.record(k, task_ms)
                    inst.on_gradient_merged(
                        res.worker_id, res.staleness, True, k,
                        batch_size=res.batch_size, task_ms=task_ms,
                    )
                    if g.device != drv:
                        g = g.to(drv)
                    acc = g if acc is None else steps.add_grads(acc, g)
                w, k_dev = self._sync_apply(w, acc, k_dev)
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
            extras=extras,
        )

    # ---------------------------------------------------------------- helpers
    def _warm_hot_path(self, apply_batch=None, max_drain: int = 0,
                       sync: bool = False) -> None:
        """Run this mode's hot path once before the trajectory clock starts.

        Parity: the reference's first iteration blocks to warm Spark's
        caches (``DAGScheduler.scala:641-656`` ``first_iter``); here the
        first use builds the CUDA kernels (nvcc) and fills the caching
        allocator.  Each distinct (shard shape, device) runs the worker
        step once; the appliers run on fresh tensors, never on live state.
        """
        d = self.ds.d
        drv = self.driver_device
        g = None
        seen = set()
        for wid in range(self.cfg.num_workers):
            shard = self._recovery.shard(wid)
            arrays = shard_tensors(shard)
            key = (tuple(arrays[0].shape), shard.device)
            if key in seen:
                continue
            seen.add(key)
            with device_scope(shard.device):
                w0 = torch.zeros(d, dtype=torch.float32, device=shard.device)
                g = self._step(*arrays, w0,
                               worker_generator(0, 0, shard.device))
        g = g.to(drv)
        if sync:
            self._sync_apply(self._zeros(d), steps.add_grads(self._zeros(d), g),
                             self._zeros())
        else:
            self._apply(self._zeros(d), g, self._zeros())
            if apply_batch is not None and max_drain >= BATCH_DRAIN_MIN:
                apply_batch(self._zeros(d), self._zeros(max_drain, d),
                            self._zeros(max_drain), self._zeros())
        for dev in set(self.devices):
            fence(dev)

    def _make_task(self, wid: int, w_pub, gen, gen_lock, delay_model):
        # recovery view: a re-homed shard is transparently computed on its
        # new device; w follows the shard's home
        shard = self._recovery.shard(wid)
        delay_ms = delay_model.delay_ms(wid)
        dev = shard.device
        step = self._step
        # The injected delay models a slow *machine*: only the first body to
        # run it sleeps -- a replacement executor is a different (healthy)
        # host path and must bypass the straggler.
        delay_fired = threading.Event()

        def fn():
            if delay_ms > 0 and not delay_fired.is_set():
                delay_fired.set()
                time.sleep(delay_ms / 1e3)
            with device_scope(dev):
                w_local = w_pub if w_pub.device == dev else w_pub.to(dev)
                # the generator advances at draw time: one draw at a time
                with gen_lock:
                    sample = step.sample(gen, shard.size)
                g = step.grad(*shard_tensors(shard), w_local, *sample)
                if dev.type == "cuda":
                    # completion only; the gradient stays on the device
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
            return g

        return fn

    def _handler(self, ctx: AsyncContext, submit_clock: int, now_ms):
        submit_wall = now_ms()
        par_recs = int(self.cfg.batch_rate * self.ds.n / self.cfg.num_workers)

        def handler(wid: int, g):
            ctx.merge_result(
                wid,
                g,
                submit_clock=submit_clock,
                elapsed_ms=now_ms() - submit_wall,
                batch_size=par_recs,
            )

        return handler

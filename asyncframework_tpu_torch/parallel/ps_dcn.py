"""Asynchronous parameter server across OS processes (the DCN channel).

Counterpart of ``asyncframework_tpu/parallel/ps_dcn.py``: the same
parameter-server process, worker processes and wire, in PyTorch.  A frame
the port sends parses in the JAX package and the other way round, so a
worker of either package trains against a parameter server of the other.
What changes is where the arrays live and what computes on them:

- the PS keeps ``w``, the step counter ``k`` and ASAGA's ``alpha_bar`` as
  f32 tensors on its ``device`` (``cuda`` unless the caller asks for the
  CPU; there is no fallback) and applies pushes through
  :func:`~asyncframework_tpu_torch.ops.steps.make_asgd_apply_merge` /
  :func:`~asyncframework_tpu_torch.ops.steps.make_saga_apply_merge`: a
  drain folds its queued pushes in slot order through the serial apply
  expression, and the serial path is the same function at m = 1, so a
  fused drain is bit-equal to m serial applies;
- ASAGA's history table and PS-side sampling stay numpy, drawn from
  ``default_rng([seed, wid])`` as in the JAX package, so both packages
  sample the same rows;
- a worker's gradient is one launch of kernel B1 (dense) or S1 (padded
  ELL): the compacted forms for ASGD, the per-slot forms
  (``masked_grad.saga_slots_grad``, ``sparse_grad.saga_slots_grad``) for
  ASAGA; each worker's sampling draws from a ``torch.Generator`` seeded
  from ``(cfg.seed, wid)`` (ROADMAP C2: not the JAX package's bits);
- the pipelined loop's host<->device staging is pinned host buffers and
  ``non_blocking`` copies on a side stream
  (:func:`~asyncframework_tpu_torch.ops.steps.make_pipelined_transfer`).

Semantics, as in the JAX package (``SparkASGDThread.scala``): the logical
clock is the number of merged gradients; a model handed to a worker is
stamped with the clock at send time; accept iff ``staleness <= taw``
(ASAGA: ``k - staleness <= taw``); partial-barrier cohorts release PULLs
in waves of ``floor(P * bucket_ratio)``; straggler delays start after
calibration.  The data plane keeps version-cached replies, delta pulls
(``async.pull.mode=delta``), vectored framing, the merge queue
(``async.push.merge``), lock-free pull serving, the pipelined worker loop
(``async.pipeline.depth``), the native codecs and the shared-memory ring
(``net/``), exactly-once pushes (``net/session.py``), the elastic
supervisor, checkpoints and ``collect_eval``.

The telemetry plane rides along as there: the PS registers its ``ps``
time-series source and ``ps_workers`` status section, folds the
convergence samples that workers of either package piggyback on PUSH and
BYE (``cv``, ``async.convergence.sample``), and workers advertise their
telemetry port on HELLO (``mport``).

Epoch fencing (``async.fence.enabled``: the PS's minted epoch, the
client's ``ep`` stamp, REJECT_FENCED and its self-healing, fenced
checkpoints) and the shard-group surface (``shard_map``, SETMAP, SHARDMAP,
FINISH, the map and epochs on WELCOME, the worker-side map handshake onto
``parallel/shardgroup.py``'s ``ShardedPSClient``) run as there.

So do the hot standby (``standby=True``: REPL_SYNC/REPL_APPEND applied
through the same merge function as the primary's drain, the replicated
dedup window, fence-stamped PROMOTE; ``parallel/replication.py`` streams
from the primary), the adaptive controller's PS side (``set_control``:
the per-item step-DAMP factor in the drain's mask slot, the cohort and
merge-budget overrides, CTRL on WELCOME/PULL/SETMAP/SHARDMAP, the
client's ``cs`` stamp and ``ctrl_sink``; ``parallel/controller.py``
decides), and SUBSCRIBE (the ``have=``-negotiated read without the wave
gate, served by primaries and standbys, with the freshness age; a
SUBSCRIBE carrying ``rport`` registers a relaycast child, which the
root offer loop sends RELAY_OFFER as versions are published).

A worker process with several devices computes each gradient over a
local ``dp`` mesh (``async.mesh.devices`` or ``SolverConfig.mesh_devices``,
over the process's device list): the shard's rows placed once a wid
across the ranks, one B1 launch a rank, the partials folded in rank order
(``ops/steps.py``'s mesh steps), one PUSH a gradient as before.
"""

from __future__ import annotations

import io
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.metrics import flightrec as _flight
from asyncframework_tpu_torch.metrics import profiler as _prof
from asyncframework_tpu_torch.metrics import trace as _trace
from asyncframework_tpu_torch.net import ClientSession, DedupWindow, RetryPolicy
from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.net import shmring as _shmring
from asyncframework_tpu_torch.net import wirecodec, wiredelta
from asyncframework_tpu_torch.parallel import supervisor as supervisor_mod
from asyncframework_tpu_torch.parallel.supervisor import ElasticSupervisor
from asyncframework_tpu_torch.utils.devices import canonical, resolve_devices

# ------------------------------------------------------------------ framing
# The framing moved to net/frame.py (one choke point for the whole control
# + data plane, with fault-injection hooks); these aliases keep the
# historical import site alive for everything that learned it here.
_send_msg = _frame.send_msg
_recv_exact = _frame.recv_exact
_recv_msg = _frame.recv_msg


# ------------------------------------------------- pipeline counters
# Process-global pipelined-loop totals (live UI "pipeline" section).  The
# worker loops accumulate locally (one _PipelineStats per worker process
# run) and ship deltas on PUSH/BYE headers; the PS folds them here -- so
# the counters land in the process that serves the dashboard whether the
# workers are threads in this process or real OS processes across a DCN.
_pl_lock = threading.Lock()
_pl_totals: Dict[str, int] = {}


def pipeline_totals() -> Dict[str, int]:
    """Pipelined update-loop counters: prefetch_hits (model was already
    waiting when the loop asked), prefetch_waits (the loop blocked on the
    prefetch), stale_discards (prefetched model thrown away after a taw
    rejection), pushes_async (pushes sent by the decoupled sender),
    push_errors (pushes whose whole retry budget was spent),
    inflight_max (max unacked pushes observed)."""
    with _pl_lock:
        return dict(_pl_totals)


def reset_pipeline_totals() -> None:
    """Zero the process-global pipeline counters (per-run isolation; see
    ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    with _pl_lock:
        _pl_totals.clear()


def _pl_fold(delta: Dict[str, int]) -> None:
    """Fold a wire-shipped counter delta; ``inflight_max`` is a high-water
    mark (max-merged), everything else a monotone count."""
    if not delta:
        return
    with _pl_lock:
        for k, v in delta.items():
            try:
                v = int(v)
            except (TypeError, ValueError):
                continue
            if k == "inflight_max":
                if v > _pl_totals.get(k, 0):
                    _pl_totals[k] = v
            else:
                _pl_totals[k] = _pl_totals.get(k, 0) + v


# ------------------------------------------ convergence samples taken
# Worker-side count of the convergence samples this process's update
# loops took (one evaluation of the shard each, buffered for a PUSH
# header): the number the PS's ``offered`` count is held against.
_cv_lock = threading.Lock()
_cv_taken = 0


def conv_samples_taken() -> int:
    """Convergence samples taken by this process's workers since the last
    :func:`reset_conv_samples_taken`."""
    with _cv_lock:
        return _cv_taken


def reset_conv_samples_taken() -> None:
    global _cv_taken
    with _cv_lock:
        _cv_taken = 0


# ------------------------------------------------ the worker's mesh plane
# Worker-side counts of the mesh plane (``async.mesh.devices``), taken
# where each happens: ``ranks`` (the largest mesh a worker process of this
# process built), ``placements`` (a wid's shard placed on it) and
# ``steps`` (mesh steps run, each one B1 launch a rank, warm-ups included).
_mesh_lock = threading.Lock()
_mesh_counts_by_key: Dict[str, int] = {}


def mesh_counts() -> Dict[str, int]:
    """The mesh plane's counts since the last :func:`reset_mesh_counts`."""
    with _mesh_lock:
        return dict(_mesh_counts_by_key)


def reset_mesh_counts() -> None:
    with _mesh_lock:
        _mesh_counts_by_key.clear()


def _mesh_bump(key: str, n: int = 1) -> None:
    with _mesh_lock:
        _mesh_counts_by_key[key] = _mesh_counts_by_key.get(key, 0) + n


def _cv_fold(wire, clock: int = 0,
             wall_ms: Optional[float] = None) -> None:
    """Fold piggybacked convergence samples (the ``cv`` PUSH/BYE header
    entry: ``[[version, loss, grad_norm], ...]``) into the process-global
    :class:`~asyncframework_tpu_torch.metrics.timeseries.ConvergenceHistory`,
    stamped with the PS run clock's wallclock and the staleness the PS
    observes (merge clock minus the sample's model version).  Dedup'd
    PUSH retries never reach the handlers, so a sample folds exactly
    once -- the span/pipeline-counter discipline."""
    if not wire:
        return
    from asyncframework_tpu_torch.metrics import timeseries as _ts

    conv = _ts.convergence()
    now_ms = wall_ms if wall_ms is not None else time.time() * 1e3
    for item in wire:
        try:
            version = int(item[0])
            loss = item[1]
            gnorm = item[2] if len(item) > 2 else None
        except (TypeError, ValueError, IndexError):
            continue  # junk from the wire must not kill the handler
        conv.add(now_ms, version, loss=loss, grad_norm=gnorm,
                 staleness=max(0, clock - version) if clock else None)


def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host f32 copy of a model tensor (never a view: the caller
    keeps it past later applies)."""
    return np.array(t.detach().cpu().numpy(), np.float32)


class _PipelineStats:
    """Per-worker-process pipeline counters, shipped to the PS as deltas
    on PUSH headers (``pl``) and on BYE -- the same piggyback discipline
    as trace spans, so the PS-side live UI sees them even when the worker
    is a separate OS process.  A delta taken for a push that terminally
    fails is merged back so the counts ride the next attempt."""

    __slots__ = ("_lock", "_counts", "_shipped_inflight_max")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._shipped_inflight_max = 0

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def high_water(self, key: str, v: int) -> None:
        with self._lock:
            if v > self._counts.get(key, 0):
                self._counts[key] = v

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def take_wire(self) -> Dict[str, int]:
        """Unshipped counter delta (empty dict = nothing to ship, no
        header field, no wire bytes)."""
        with self._lock:
            out = {k: v for k, v in self._counts.items()
                   if k != "inflight_max" and v}
            hw = self._counts.get("inflight_max", 0)
            if hw > self._shipped_inflight_max:
                out["inflight_max"] = hw
                self._shipped_inflight_max = hw
            for k in out:
                if k != "inflight_max":
                    self._counts[k] = 0
            return out

    def merge_back(self, delta: Dict[str, int]) -> None:
        with self._lock:
            for k, v in delta.items():
                if k == "inflight_max":
                    continue  # the high-water mark survives locally
                self._counts[k] = self._counts.get(k, 0) + v


class _ModelSnap:
    """One published model version: the host float32 array, its serialized
    payload bytes, and the CRC32 integrity stamp -- immutable once built,
    swapped in by atomic reference assignment so ``_handle_pull`` can
    serve any reply shape without the model lock."""

    __slots__ = ("ts", "w_host", "wire", "crc", "gen")

    def __init__(self, ts: int, w_host: np.ndarray, wire: bytes, crc: int,
                 gen: int):
        self.ts = ts
        self.w_host = w_host
        self.wire = wire
        self.crc = crc
        #: model GENERATION the build basis carried (bumped on every
        #: accepted push): the send-time clock re-stamp in _handle_pull
        #: is allowed only while the generation is unchanged -- dropped
        #: pushes tick the clock but not the generation, accepted ones
        #: tick both, so gen equality proves "same bytes, newer clock"
        self.gen = gen


class WaitDone:
    """Result of :meth:`ParameterServer.wait_done`: truthy iff the run
    finished; otherwise carries the per-worker progress diagnostic (old
    callers that only truth-test keep working, new callers can print WHY
    the run did not finish)."""

    __slots__ = ("done", "diagnostic")

    def __init__(self, done: bool, diagnostic: Optional[str]):
        self.done = bool(done)
        self.diagnostic = diagnostic

    def __bool__(self) -> bool:
        return self.done

    def __repr__(self) -> str:
        return "WaitDone(done)" if self.done else (
            f"WaitDone(not done)\n{self.diagnostic}"
        )

    def __str__(self) -> str:
        return "done" if self.done else (self.diagnostic or "not done")


class _PendingPush:
    """One decoded PUSH waiting in the PS merge queue.

    The handler thread decodes the payload OUTSIDE the model lock, enqueues
    this record, and whoever holds the lock next drains every pending push
    into one fused device apply (``_drain_merge_locked``) -- per-push
    accept/reject, dedup, calibration, and trace bookkeeping all happen
    per item in FIFO order, exactly as the serial path did; only the
    device dispatch is coalesced."""

    __slots__ = ("wid", "ts", "g_host", "diff", "header", "payload_len",
                 "tc", "t_queue0", "done", "ack", "accepted", "staleness",
                 "task_ms", "t_apply0", "t_done", "k_at_merge",
                 "do_snapshot", "damp")

    def __init__(self, wid: int, ts: int, g_host, diff, header: dict,
                 payload_len: int, tc, t_queue0: float):
        self.wid, self.ts = wid, ts
        self.g_host, self.diff = g_host, diff
        self.header, self.payload_len = header, payload_len
        self.tc, self.t_queue0 = tc, t_queue0
        self.done = False
        self.ack: dict = {}
        self.accepted = False
        self.staleness = 0
        self.task_ms = 0.0
        self.t_apply0 = 0.0
        self.t_done = 0.0
        self.k_at_merge = 0
        self.do_snapshot = False
        # delay-adaptive step-DAMP factor, decided per item at drain
        # time from the installed CTRL law (1.0 = undamped, the only
        # value with control off -- the bit-equal legacy apply)
        self.damp = 1.0


# ----------------------------------------------------------------- PS side
class ParameterServer:
    """Driver-side PS: accept worker connections, run the updater semantics.

    One handler thread per worker connection (the reference's RPC dispatcher
    threads); the model/clock live behind one lock (single-writer updater
    discipline -- the TPU build's answer to the reference's benign races,
    SURVEY.md section 5).
    """

    def __init__(self, cfg, d: int, n: int, device=None, host: str = "0.0.0.0",
                 port: int = 0, algo: str = "asgd",
                 checkpoint_path: Optional[str] = None,
                 supervisor: Optional[ElasticSupervisor] = None,
                 bus=None, shard_map=None, shard_index: int = 0,
                 epoch: Optional[int] = None, shard_epochs=None,
                 standby: bool = False):
        from asyncframework_tpu_torch.conf import FENCE_ENABLED
        from asyncframework_tpu_torch.conf import global_conf as _gc
        from asyncframework_tpu_torch.ops import steps

        if algo not in ("asgd", "asaga"):
            raise ValueError(f"unknown PS algo {algo!r}")
        self.cfg = cfg
        self.d, self.n = d, n
        self.algo = algo
        # fencing epoch (async.fence.enabled): 0 = fencing off, the
        # byte-identical legacy wire (no ep header keys anywhere).  > 0 =
        # this server incarnation's minted epoch; every PULL/PUSH/
        # SUBSCRIBE stamped with a DIFFERENT epoch is answered REJECT_FENCED (admission in
        # _fence_reject), so a deposed client replaying buffered pushes --
        # or any op routed at a deposed incarnation of this range -- can
        # never double-apply against the current owner's state.
        # Restoring from checkpoint bumps past the persisted epoch (every
        # incarnation is a new epoch), and a controller
        # (shardgroup.ShardGroup) passes an explicit epoch that already
        # counts its lease-expiry fences.
        if epoch is None:
            epoch = 1 if _gc().get(FENCE_ENABLED) else 0
        self.epoch = int(epoch)
        #: per-shard epochs of the whole group (index-aligned with
        #: shard_map); installed by SETMAP / the launcher so WELCOME can
        #: hand workers the full epoch vector next to the map
        self.shard_epochs = ([int(e) for e in shard_epochs]
                             if shard_epochs else None)
        #: highest foreign epoch seen ABOVE ours: once a client proves a
        #: successor exists for this range, this incarnation is a zombie
        #: and refuses every stamped op (even same-epoch ones) -- "never
        #: mutate or serve a range it no longer owns"
        self._fenced_above = 0
        self.fenced_rejects = 0
        # sharded PS group (parallel/shardgroup.py): when this server is one
        # range of a shard group, ``shard_map`` is the group's wire map
        # (per-shard [host, port, lo, hi]) and ``shard_index`` names this
        # server's range.  The map is what HELLO's WELCOME reply hands
        # workers so they resolve the group with no side channel; it may
        # also be installed after construction (SETMAP, or attribute
        # assignment before start).  None/0 = the classic single PS --
        # WELCOME omits the key and the wire stays byte-identical.
        self.shard_map = [list(e) for e in shard_map] if shard_map else None
        self.shard_index = int(shard_index)
        self.checkpoint_path = checkpoint_path
        self.resumed_from_k: Optional[int] = None
        # hot-standby replication (parallel/replication.py).
        # standby=True: this server is a WARM STANDBY -- it refuses the
        # training plane (PULL/PUSH answer ERR; it is not in the shard
        # map), applies its primary's replicated merge batches (REPL_SYNC
        # bootstrap + REPL_APPEND stream) through the same merge function
        # the primary's drain runs, and serves SUBSCRIBE/SHARDMAP reads
        # from the mirrored snapshot (staleness priced by replication
        # lag).  A PROMOTE order flips it to range primary under the
        # minted epoch.  standby_map names every shard's standby endpoint
        # ([host, port] | None per range, installed via SETMAP or the
        # launcher); a PRIMARY whose own entry is set runs a
        # ReplicationStream (self.repl) to it.
        self._standby = bool(standby)
        self.standby_map: Optional[List] = None
        self.repl = None
        self.promoted = False
        self.device = (resolve_devices(None)[0] if device is None
                       else canonical(device))
        self._w = torch.zeros(d, dtype=torch.float32, device=self.device)
        self._k_dev = torch.zeros((), dtype=torch.float32, device=self.device)
        # the merge drain folds m pushes through the serial apply
        # expression in slot order, and the serial path is the same
        # function at m = 1 (self._one): a fused drain is bit-equal to m
        # serial applies by construction
        self._one = torch.ones(1, dtype=torch.float32, device=self.device)
        if algo == "asaga":
            # ScalarMap semantics (SparkASAGAThread.scala:114,280-294): the
            # PS owns the per-sample history table AND the sampling -- it
            # draws each worker's Bernoulli(b) rows, ships (idx, alpha[idx])
            # with the model, and commits returned scalars only on accept.
            # delta == g is EXACT here: a worker's samples live in its own
            # shard, and the per-connection pull->push protocol serializes
            # the worker against its own commits, so the alpha the gradient
            # was built against IS the alpha at commit.
            self._apply_merge = steps.make_saga_apply_merge(
                cfg.gamma, cfg.batch_rate, n, cfg.num_workers)
            self._ab = torch.zeros(d, dtype=torch.float32, device=self.device)
            self._table: Dict[int, np.ndarray] = {}   # wid -> shard scalars
            self._rngs: Dict[int, np.random.Generator] = {}
            self._pending_idx: Dict[int, np.ndarray] = {}  # outstanding pull
            # guards table/rng structure + contents against the checkpoint
            # writer's iteration (lock order: _lock -> _saga_lock); pulls
            # hold it WITHOUT _lock so sampling never queues the apply path
            self._saga_lock = threading.Lock()
        else:
            self._apply_merge = steps.make_asgd_apply_merge(
                cfg.gamma, cfg.batch_rate, n, cfg.num_workers)

        # debug lock watchdog (net/lockwatch.py, async.debug.lockwatch):
        # the model lock becomes a watched lock -- any socket send/recv
        # under it raises at the frame choke point.
        from asyncframework_tpu_torch.net import lockwatch as _lockwatch

        self._lock = _lockwatch.named_lock("ps.model")
        # ---- data plane: version-cached encoded PULL replies + deltas.
        # One readback AND one encode per model version, published as an
        # immutable _ModelSnap via atomic reference swap: _handle_pull
        # serves full/NOT_MODIFIED/delta replies from it without touching
        # the model lock.  An accepted push clears the reference; the next
        # pull rebuilds outside the model lock, under _snap_build_lock so a
        # cohort triggers one build, not P.  _w_versions keeps recent
        # versions' host arrays so a worker pulling with ``have=<ts>`` can
        # be served a byte-exact XOR delta (net/wiredelta.py).
        self._snap: Optional[_ModelSnap] = None
        # the build BASIS: (clock, model tensor, generation) written at the
        # end of every applying drain; a rebuild reads it lock-free.  The
        # model generation is +1 per ACCEPTED push (before its clock
        # tick); snapshot re-stamping keys off it (see _ModelSnap.gen).
        # Model tensors are never written in place, so the basis stays
        # readable while later drains apply.
        self._model_gen = 0
        self._snap_basis: Tuple[int, object, int] = (0, self._w, 0)
        self._snap_build_lock = _lockwatch.named_lock("ps.snap_build")
        self._versions_lock = _lockwatch.named_lock("ps.versions")
        # pull-path bookkeeping keeps its own lock (never the model lock)
        self._stats_lock = _lockwatch.named_lock("ps.stats")
        from collections import OrderedDict as _OD2
        from asyncframework_tpu_torch.conf import (
            PULL_DELTA_VERSIONS,
            PUSH_MERGE,
            global_conf as _gconf,
        )

        self._w_versions: "_OD2[int, np.ndarray]" = _OD2()
        # an un-overridden cache depth auto-scales with the worker count: a
        # worker's basis is typically ~P versions old by its next pull
        if _gconf().contains(PULL_DELTA_VERSIONS.key):
            self._delta_versions = max(
                0, int(_gconf().get(PULL_DELTA_VERSIONS))
            )
        else:
            self._delta_versions = max(
                int(_gconf().get(PULL_DELTA_VERSIONS)),
                4 * cfg.num_workers + 2,
            )
        # the version cache is only maintained once a delta-capable client
        # shows up (first pull carrying ``have``)
        self._delta_clients_seen = False
        # pull-reply shape counters (bench/tests: the "zero payload bytes
        # per unchanged-version pull" claim is read off these)
        self.pull_replies: Dict[str, int] = {"full": 0, "nm": 0,
                                             "xdelta": 0}
        self.pull_model_bytes = 0  # model-part payload bytes sent via PULL
        # SUBSCRIBE reply shapes + bytes, counted apart from PULL so the
        # training data plane's numbers stay clean of read traffic
        self.subscribe_replies: Dict[str, int] = {"full": 0, "nm": 0,
                                                  "xdelta": 0}
        self.subscribe_model_bytes = 0
        # relaycast root offer path (asyncframework_tpu_torch/relaycast/): a
        # SUBSCRIBE whose header carries ``rport`` registers the
        # subscriber as a direct relay child (the shared ChildRegistry:
        # bounded by async.relay.fanout with LRU eviction, so a deep
        # node that root-subscribed once cannot squat a slot a planned
        # direct child keeps renewing), and a lazy offer thread
        # announces each new version via RELAY_OFFER so depth-1 nodes
        # fetch event-driven instead of poll-bounded.  Offers are
        # advisory: a lost one costs nothing (the child's refresh loop
        # still polls).
        from asyncframework_tpu_torch.conf import RELAY_FANOUT as _RF

        self._relay_fanout = max(1, int(_gconf().get(_RF)))
        self._relay_registry = None  # built with the first rport seen
        self._relay_lock = threading.Lock()
        self._relay_thread: Optional[threading.Thread] = None
        self._relay_offered = -1  # newest clock already offered
        self.relay_offers = 0
        # version birth times (bounded): ts -> run-clock ms at which that
        # model version was PUBLISHED by an applying drain.  Feeds the
        # freshness-lag-in-ms answer on SUBSCRIBE replies: the age of a
        # served version is "how long ago did a NEWER version appear",
        # which is 0 while the served version is still current (dropped
        # pushes tick the clock without changing the model, and leave no
        # entry here -- correctly aging nothing).
        self._born_lock = threading.Lock()
        self._ver_born: "_OD2[int, float]" = _OD2()
        # ---- data plane: batched gradient apply (merge queue).  All
        # pushes pending at lock acquisition coalesce into ONE drain
        # (at most _merge_max); per-push semantics stay per item.
        merge = getattr(cfg, "push_merge", None)
        self._merge_max = max(1, int(merge if merge is not None
                                     else _gconf().get(PUSH_MERGE)))
        from collections import deque as _deque

        self._merge_q: "_deque[_PendingPush]" = _deque()
        self.merge_batches = 0    # drains that applied >= 1 push
        self.merge_merged = 0     # pushes applied through those drains
        self.merge_batch_max = 0  # largest single batch
        self._clock = 0          # merged gradients (ASYNCcontext.CurrentTime)
        self._k = 0              # accepted updates
        self.accepted = 0
        self.dropped = 0
        self.push_bytes = 0      # wire payload bytes received via PUSH
        self.max_staleness = 0
        # pushes merged at each staleness (clock - ts), dropped ones too
        self.staleness_counts: Dict[int, int] = {}
        self._snapshots: List[Tuple[float, object]] = []
        self._t0: Optional[float] = None
        self._done = threading.Event()
        # calibration (SparkASGDThread.scala:174-183)
        self._cal_ms = 0.0
        self._cal_n = 0
        self.avg_delay_ms = 0.0
        self._pull_times: Dict[int, float] = {}
        # cohort wave gate (ASYNCbarrier + bucketRatio)
        self._wave_cv = threading.Condition()
        self._waiting: List[int] = []
        self._wave_id = 0

        # elastic membership (parallel/supervisor.py); None = the classic
        # fixed-membership PS
        self.supervisor = supervisor
        # per-worker ledgers: wait_done's progress diagnostic and the
        # coverage asserts; they survive a PS restart
        self._last_contact: Dict[int, float] = {}
        self.pushes_by_wid: Dict[int, int] = {}
        self.accepted_by_wid: Dict[int, int] = {}
        # per-worker straggler stats (cluster observer input surface):
        # merge-time facts (staleness, push inter-arrival EWMA) land at
        # drain, latency facts (compute / push.rtt EWMAs) land when this
        # worker's piggybacked spans fold.  Own lock: span folds run on
        # connection handler threads, outside the model lock by design.
        self._wstats_lock = threading.Lock()
        self._wstats: Dict[int, Dict[str, float]] = {}
        self.membership_rejects = 0  # pushes from deposed shard servers
        # exactly-once-applied PUSH: a retried (sid, seq) re-sends the
        # cached ACK instead of merging the gradient twice (net/session.py).
        # Constructed BEFORE a restore so a checkpointed window lands here.
        from asyncframework_tpu_torch.conf import NET_DEDUP_WINDOW, global_conf

        self._dedup = DedupWindow(window=global_conf().get(NET_DEDUP_WINDOW))
        # adaptive control plane (parallel/controller.py): the installed
        # CTRL payload (None = control off, byte-identical legacy wire
        # everywhere) + its parsed effective values.  Installed by the
        # local AsyncController (primary), by SETMAP (shard secondaries
        # and promoted standbys -- decisions SURVIVE promotion because
        # the group re-announces its stored ctrl), and served to workers
        # on WELCOME and on PULL replies whose ``cs`` stamp is stale.
        # _ctrl_lock guards the swap; the drain reads the parsed fields
        # via one attribute read each (GIL-atomic reference swaps).
        self._ctrl_lock = threading.Lock()
        self.ctrl: Optional[dict] = None
        self._ctrl_b = 0            # cohort override (0 = conf value)
        self._ctrl_merge = 0        # effective merge budget (0 = conf)
        self._ctrl_damp: Optional[Tuple[float, float, float]] = None
        self._ctrl_wdamp: Dict[int, float] = {}
        self.ctrl_stale_rejects = 0  # stale (ep, seq) installs refused
        # the damp factors this server's drains applied below 1.0: their
        # count, sum and least value (the controller's effect, read by
        # the launchers' records)
        self.damped_applies = 0
        self.damp_sum = 0.0
        self.damp_min = 1.0

        # distributed tracing (metrics/trace.py): server-side spans for
        # traced updates plus spans piggybacked on PUSH/BYE fold into the
        # process-global aggregator and, with a ListenerBus, post as
        # TraceSpan events.
        self.bus = bus
        self._trace_agg = _trace.aggregator()
        self.trace_spans = 0  # spans folded (own + piggybacked)
        self._trace_lock = threading.Lock()
        from collections import OrderedDict as _OD

        self._seen_span_ids: "_OD[str, None]" = _OD()

        self._elapsed_offset_ms = 0.0  # wall already spent before a resume
        # a STANDBY never boot-restores: its state arrives over the wire
        # (REPL_SYNC) at the epoch its primary streams, and a stale
        # checkpoint restore here would mint an epoch ABOVE the stream's
        # and wrongly fence it out.  The path is still kept: once
        # promoted, this server checkpoints its range there.
        if (checkpoint_path and os.path.exists(checkpoint_path)
                and not self._standby):
            self._restore(checkpoint_path)

        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_trigger = threading.Event()
        # one save at a time: the writer thread and an explicit
        # save_checkpoint() share the temporary file
        self._ckpt_io_lock = threading.Lock()
        self._eval_results: Dict[int, np.ndarray] = {}
        self._eval_cv = threading.Condition()
        self._stop = threading.Event()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "ParameterServer":
        self._t0 = time.monotonic() - self._elapsed_offset_ms / 1e3
        with self._lock:
            if self.resumed_from_k is None:
                self._snapshots.append((0.0, _host(self._w)))
            if self._k >= self.cfg.num_iterations:
                self._done.set()  # checkpoint was already past the finish
                if self.supervisor is not None:
                    self.supervisor.freeze()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ps-accept", daemon=True
        )
        self._accept_thread.start()
        if self.checkpoint_path:
            # async checkpoint writer: the push handler only SIGNALS the
            # cadence; serialization happens under the lock on this thread
            # and the disk write happens off every worker's request path
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_loop, name="ps-checkpoint", daemon=True
            )
            self._ckpt_thread.start()
        if self.supervisor is not None:
            self.supervisor.start()
        # continuous telemetry (metrics/timeseries.py): this PS's core
        # scalars become the ``ps.*`` time series every sampler tick --
        # the updates/s-floor SLO (rate(ps.accepted)).  Last registration
        # wins, matching "the live PS owns the dashboard"; stop() unhooks
        # only itself.
        from asyncframework_tpu_torch.metrics import timeseries as _ts

        self._ts_source = self._telemetry_source
        _ts.register_source("ps", self._ts_source)
        # per-worker stats on /api/status (``ps_workers`` section): the
        # cluster observer's straggler scoring reads it -- same
        # last-registration-wins + identity-gated-unregister discipline
        # as the ``ps`` series source
        from asyncframework_tpu_torch.metrics import live as _live

        self._workers_section = self.worker_stats
        _live.register_status_section("ps_workers", self._workers_section)
        _ts.ensure_started()
        return self

    def worker_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-worker straggler inputs (JSON-able; the ``ps_workers``
        /api/status section): accepted/dropped counts, last observed
        staleness, push inter-arrival EWMA, and -- when this worker's
        spans fold here -- compute and push-RTT EWMAs."""
        with self._wstats_lock:
            return {str(w): dict(st) for w, st in self._wstats.items()}

    _EWMA_A = 0.3  # per-worker EWMA weight (a few pushes to converge)

    def _wstat_merge(self, wid: int, staleness: int,
                     accepted: bool) -> None:
        """Merge-time per-worker facts; called at drain (model lock
        held) -- a dict update, same cost class as accepted_by_wid."""
        now_ms = time.monotonic() * 1e3
        with self._wstats_lock:
            st = self._wstats.setdefault(int(wid), {})
            st["accepted"] = st.get("accepted", 0) + int(accepted)
            st["dropped"] = st.get("dropped", 0) + int(not accepted)
            st["staleness"] = int(staleness)
            last = st.get("last_seen_ms")
            if last is not None and now_ms > last:
                iv = now_ms - last
                prev = st.get("interval_ms")
                st["interval_ms"] = round(
                    iv if prev is None
                    else self._EWMA_A * iv + (1 - self._EWMA_A) * prev, 3)
            st["last_seen_ms"] = now_ms

    def _wstat_span(self, span: "_trace.Span") -> None:
        """Latency facts from a folded span (compute / push.rtt).

        Only updates entries :meth:`_wstat_merge` already created: spans
        fold at PUSH receive (handler threads), merges at drain -- a
        span-only entry would carry a one-sample EWMA with no
        ``accepted`` count, bypassing the observer's warm-up guard and
        flagging a booting worker on its very first sample."""
        if span.worker_id is None or span.dur_ms is None:
            return
        if span.stage == _trace.COMPUTE:
            key = "compute_ms"
        elif span.stage == _trace.PUSH_RTT:
            key = "rtt_ms"
        else:
            return
        with self._wstats_lock:
            st = self._wstats.get(int(span.worker_id))
            if st is None:
                return
            prev = st.get(key)
            st[key] = round(
                span.dur_ms if prev is None
                else self._EWMA_A * span.dur_ms
                + (1 - self._EWMA_A) * prev, 3)

    def _telemetry_source(self) -> Dict[str, float]:
        """Flat scalars the time-series sampler records as ``ps.<key>``
        (lock-free reads of ints: a tick may see a torn multi-field view,
        but each individual series stays monotone/correct)."""
        out = {
            "clock": self._clock,
            "k": self._k,
            "accepted": self.accepted,
            "dropped": self.dropped,
            "push_bytes": self.push_bytes,
            "max_staleness": self.max_staleness,
            # merge-queue backlog at this instant: the observer prices
            # it against the push rate (queue growing faster than the
            # drain = the apply plane is the bottleneck)
            "queue_depth": len(self._merge_q),
            "done": int(self._done.is_set()),
        }
        repl = self.repl
        if repl is not None:
            # the standby's replication lag in merge units -- the
            # ps.standby_lag series the default standby_lag SLO rule
            # watches (read staleness on the standby is priced by it)
            out["standby_lag"] = float(repl.lag_versions())
            out["standby_synced"] = 1.0 if repl.synced else 0.0
        if self._standby:
            out["standby"] = 1.0
        return out

    # ---------------------------------------------------------- checkpointing
    def _checkpoint_state(self) -> dict:
        """Snapshot everything a restarted PS needs, caller holds the lock.
        ``_pending_idx`` is deliberately NOT saved: in-flight pulls die with
        the process, and a post-restart push referencing one is dropped
        (stale by construction)."""
        meta = {
            "algo": self.algo,
            "clock": self._clock,
            "k": self._k,
            "accepted": self.accepted,
            "dropped": self.dropped,
            "push_bytes": self.push_bytes,
            "max_staleness": self.max_staleness,
            "cal_ms": self._cal_ms,
            "cal_n": self._cal_n,
            "avg_delay_ms": self.avg_delay_ms,
            "elapsed_ms": self._now_ms() if self._t0 is not None else 0.0,
            "snap_times": [t for (t, _w) in self._snapshots],
            # session dedup windows ride the checkpoint: a PUSH applied in
            # this life and retried against the NEXT life must be answered
            # from cache, not merged again.  Captured under the same lock
            # as the model, so window and weights can never disagree about
            # which pushes are "in".
            "dedup": self._dedup.state(),
            "pushes_by_wid": {
                str(w): c for w, c in self.pushes_by_wid.items()
            },
            "accepted_by_wid": {
                str(w): c for w, c in self.accepted_by_wid.items()
            },
            "membership_rejects": self.membership_rejects,
            # fencing: the epoch rides the checkpoint so a restart can
            # never come back BELOW a fence (the restore bumps past it),
            # and the reject count survives incarnations for the
            # acceptance assertions / metrics
            "epoch": self.epoch,
            "fenced_rejects": self.fenced_rejects,
        }
        arrays = {"w": _host(self._w)}
        if self._snapshots:
            arrays["snap_stack"] = np.stack(
                [np.asarray(w) for (_t, w) in self._snapshots]
            )
        if self.algo == "asaga":
            arrays["ab"] = _host(self._ab)
            with self._saga_lock:  # consistent table + RNG capture
                for wid, table in self._table.items():
                    arrays[f"table_{wid}"] = table.copy()
                meta["rng_states"] = {
                    str(wid): rng.bit_generator.state
                    for wid, rng in self._rngs.items()
                }
        return {"meta": meta, "arrays": arrays}

    def save_checkpoint(self) -> None:
        """Atomic on-disk PS checkpoint (Master.scala:41 recovery semantics
        applied to the run itself, per SURVEY section 7 stage 5: model +
        history table + RNG + clock).  Serialize under the lock, write
        outside it."""
        if not self.checkpoint_path:
            return
        from asyncframework_tpu_torch.checkpoint import durable_replace

        with self._ckpt_io_lock:
            with self._lock:
                state = self._checkpoint_state()
            buf = io.BytesIO()
            np.savez(buf, __meta__=json.dumps(state["meta"]),
                     **state["arrays"])
            tmp = self.checkpoint_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            # fsync file + rename + fsync directory: the save survives
            # host power loss, not just process death
            # (checkpoint.durable_replace)
            durable_replace(tmp, self.checkpoint_path)

    def _ckpt_loop(self) -> None:
        while not self._stop.is_set():
            if not self._ckpt_trigger.wait(timeout=0.2):
                continue
            self._ckpt_trigger.clear()
            try:
                self.save_checkpoint()
            except Exception:  # noqa: BLE001 - the writer must outlive
                # any one failed save (disk hiccup, transient device
                # fault): a dead checkpoint thread would silently void
                # the restart guarantees for the rest of the run
                pass

    def _restore(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta["algo"] != self.algo:
                raise ValueError(
                    f"checkpoint algo {meta['algo']!r} != PS algo "
                    f"{self.algo!r}"
                )
            self._install_state(z, meta)
            if self.epoch > 0:
                # every incarnation is a NEW epoch: a restart from this
                # checkpoint must dominate anything the previous life
                # stamped or accepted (a controller-passed epoch that
                # already counts more fences wins via max)
                self.epoch = max(self.epoch,
                                 int(meta.get("epoch", 0)) + 1)
            self.fenced_rejects = int(meta.get("fenced_rejects", 0))
        self.resumed_from_k = self._k
        supervisor_mod.bump_total("ps_resumes")

    def _install_state(self, z, meta: dict) -> None:
        """Install a checkpoint image's model + bookkeeping (shared by
        the boot-time restore and the standby's REPL_SYNC applier).
        Deliberately does NOT touch the fencing epoch or the fenced-
        reject counter: incarnation identity belongs to the caller --
        a restore bumps past the persisted epoch, a standby sync keeps
        the epoch its stream runs at."""
        # generation bump FIRST: a lock-free reader mid-build (a live
        # standby keeps serving SUBSCRIBE through a re-sync) must fail
        # its publish guard, or it would cache the PRE-install snapshot
        self._model_gen += 1
        self._w = torch.tensor(z["w"], dtype=torch.float32,
                               device=self.device)
        self._w_versions.clear()
        with self._born_lock:
            self._ver_born.clear()  # prior-life ages are meaningless
        self._snap_basis = (int(meta["clock"]), self._w,
                            self._model_gen)
        self._clock = int(meta["clock"])
        self._k = int(meta["k"])
        # the DEVICE step counter must follow k: the ASGD step-size
        # schedule reads it (gamma/sqrt(k/P+1))
        self._k_dev = torch.tensor(float(self._k), dtype=torch.float32,
                                   device=self.device)
        self.accepted = int(meta["accepted"])
        self.dropped = int(meta["dropped"])
        self.push_bytes = int(meta["push_bytes"])
        self.max_staleness = int(meta["max_staleness"])
        self._cal_ms = float(meta["cal_ms"])
        self._cal_n = int(meta["cal_n"])
        self.avg_delay_ms = float(meta["avg_delay_ms"])
        self._elapsed_offset_ms = float(meta["elapsed_ms"])
        if "snap_stack" in z:
            stack = z["snap_stack"]
            self._snapshots = [
                (t, stack[i].copy())
                for i, t in enumerate(meta["snap_times"])
            ]
        else:
            self._snapshots = []
        if self.algo == "asaga":
            self._ab = torch.tensor(z["ab"], dtype=torch.float32,
                                    device=self.device)
            self._table = {
                int(k.split("_", 1)[1]): z[k].copy()
                for k in z.files if k.startswith("table_")
            }
            for wid_s, state in meta.get("rng_states", {}).items():
                rng = np.random.default_rng()
                rng.bit_generator.state = state
                self._rngs[int(wid_s)] = rng
        self._dedup.load_state(meta.get("dedup"))
        self.pushes_by_wid = {
            int(w): int(c)
            for w, c in meta.get("pushes_by_wid", {}).items()
        }
        self.accepted_by_wid = {
            int(w): int(c)
            for w, c in meta.get("accepted_by_wid", {}).items()
        }
        self.membership_rejects = int(meta.get("membership_rejects", 0))
        # last: a reader that re-reads the basis builds the NEW state
        self._snap = None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"ps-conn-{conn.fileno()}", daemon=True
            )
            t.start()
            # reap on append: a long-running elastic PS accepts a fresh
            # connection per worker reconnect/retry -- without pruning,
            # finished handler threads accumulate for the life of the
            # process (one Thread object + name per connection ever made)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _now_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1e3

    # -------------------------------------------------------------- tracing
    def _bus_time_ms(self) -> float:
        return self._now_ms() if self._t0 is not None else 0.0

    def _fold_span(self, span: "_trace.Span") -> None:
        """One span into the aggregator + (when attached) the event bus."""
        with self._trace_lock:
            self.trace_spans += 1
        self._trace_agg.add(span)
        self._wstat_span(span)
        if self.bus is not None:
            self.bus.post(_trace.span_event(span, self._bus_time_ms()))

    def _fold_wire_spans(self, wire_spans) -> None:
        """Spans piggybacked on a worker's PUSH/BYE header.

        Deduped by span_id: the (sid, seq) window covers same-stamp
        retries, but a push that was DELIVERED and then spent its whole
        retry budget re-queues its piggyback onto the next push under a
        fresh stamp -- without this, exactly the fault windows tracing
        exists to explain would double-count their spans."""
        if not wire_spans:
            return
        for d in wire_spans:
            try:
                span = _trace.Span.from_wire(d)
                with self._trace_lock:
                    if span.span_id in self._seen_span_ids:
                        continue
                    self._seen_span_ids[span.span_id] = None
                    while len(self._seen_span_ids) > 8192:
                        self._seen_span_ids.popitem(last=False)
                self._fold_span(span)
            except Exception:  # noqa: BLE001 - junk from the wire must not
                pass           # kill the connection handler

    # ------------------------------------------------------------- protocol
    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                header, payload = _recv_msg(conn)
                op = header["op"]
                # PULL_SAGA/PUSH_SAGA are the same handlers under their own
                # verbs so fault schedules (net/faults.py) can target the
                # ASAGA stream without also counting ASGD ops
                if op in ("PULL", "PULL_SAGA"):
                    if self._standby:
                        # a standby is a READ replica: SUBSCRIBE serves
                        # from its mirrored snapshot, but the training
                        # plane (wave gate, membership, merges) belongs
                        # to the range primary alone -- it is not in
                        # the shard map, and a client that lands here
                        # anyway must re-resolve, not train against a
                        # mirror
                        _send_msg(conn, {"op": "ERR", "msg": "standby"})
                        continue
                    if self._fence_reject(conn, header):
                        continue
                    self._handle_pull(conn, header)
                elif op == "SUBSCRIBE":
                    # serving-tier snapshot subscription: a read-only,
                    # wave-gate-free pull that keeps answering after DONE
                    # (standbys serve it too -- the read-replica face of
                    # hot-standby replication, staleness priced by lag)
                    if self._fence_reject(conn, header):
                        continue
                    self._handle_subscribe(conn, header)
                elif op in ("PUSH", "PUSH_SAGA"):
                    if self._standby:
                        _send_msg(conn, {"op": "ERR", "msg": "standby"})
                        continue
                    cached = self._dedup.check(header)
                    if cached is not None:
                        # duplicate of an already-applied push (the ACK was
                        # lost on the wire): re-send it, merge nothing.
                        # Dedup wins over the fence check: an op this
                        # incarnation ALREADY applied must re-answer its
                        # cached verdict, not invent a new one.
                        _send_msg(conn, cached[0])
                    elif not self._fence_reject(conn, header, record=True):
                        self._handle_push(conn, header, payload)
                elif op == "HELLO":
                    # a worker process introducing itself (elastic plane):
                    # proc token + logical worker ids + pid/host (+ the
                    # pid's /proc start time, pid-reuse protection)
                    if self.supervisor is not None:
                        self.supervisor.register(
                            str(header.get("proc")),
                            [int(w) for w in header.get("wids", [])],
                            pid=header.get("pid"),
                            host=header.get("host"),
                            pid_start=header.get("pstart"),
                            mport=header.get("mport"),
                        )
                    welcome = {"op": "WELCOME",
                               "elastic": self.supervisor is not None}
                    if self.shard_map:
                        # the shard-map handshake: workers/replicas resolve
                        # the group here and fan every PULL/PUSH out per
                        # range (shardgroup.ShardedPSClient).  Key absent
                        # on an unsharded PS -- byte-identical legacy wire.
                        welcome["shards"] = self.shard_map
                        if self.shard_epochs:
                            welcome["epochs"] = self.shard_epochs
                    if self.epoch:
                        welcome["epoch"] = self.epoch
                    if self.ctrl is not None:
                        # adaptive control plane: a joining worker gets
                        # the current CTRL payload next to the map and
                        # epoch vector (absent with control off --
                        # byte-identical legacy wire)
                        welcome["ctrl"] = self.ctrl
                    _send_msg(conn, welcome)
                elif op == "SHARDMAP":
                    # shard-map query (group members, liveness probes,
                    # serving replicas): the classic single PS answers an
                    # empty list -- "no group here"
                    reply = {"op": "SHARDMAP",
                             "shards": self.shard_map or []}
                    if self.epoch:
                        reply["epoch"] = self.epoch
                        reply["fenced_rejects"] = self.fenced_rejects
                    if self.shard_epochs:
                        reply["epochs"] = self.shard_epochs
                    if self.standby_map:
                        # discovery surface for the read path: serving
                        # replicas / relaycast roots may subscribe to a
                        # range's standby instead of its primary
                        reply["standbys"] = self.standby_map
                    if self._standby:
                        reply["standby"] = True
                    if self.ctrl is not None:
                        reply["ctrl"] = self.ctrl
                    _send_msg(conn, reply)
                elif op == "SETMAP":
                    # group controller installing the assembled map on a
                    # freshly-spawned shard child (it cannot know its
                    # peers' ephemeral ports before they announce)
                    wire = header.get("shards") or None
                    self.shard_map = ([list(e) for e in wire]
                                      if wire else None)
                    if "index" in header:
                        self.shard_index = int(header["index"])
                    if header.get("epochs"):
                        # the controller's epoch vector (post-fence
                        # re-installs ride this too, so WELCOME hands new
                        # workers current epochs, not boot-time ones)
                        self.shard_epochs = [int(e)
                                             for e in header["epochs"]]
                    if "standbys" in header:
                        # the controller's standby endpoints: a primary
                        # whose own entry is set (re)targets its
                        # replication stream here -- promotion re-homes
                        # a NEW standby behind the promoted primary via
                        # the same install
                        self.set_standby_map(header.get("standbys"))
                    if "ctrl" in header:
                        # adaptive-control decisions ride SETMAP next to
                        # the map/epochs/standbys: shard secondaries
                        # damp/serve under the SAME decision the primary
                        # applies, and a promoted standby re-learns the
                        # current CTRL from the group's re-announce
                        # (monotone install; a deposed controller's
                        # stale stamp is refused)
                        self.set_control(header.get("ctrl"))
                    _send_msg(conn, {"op": "ACK"})
                elif op in ("REPL_APPEND", "REPL_SYNC"):
                    # primary->standby replication stream (parallel/
                    # replication.py).  Only a standby applies it, and
                    # the fence admission below is THE promotion-safety
                    # gate: a deposed primary's post-promotion appends
                    # carry its stale epoch and bounce REJECT_FENCED --
                    # including against the PROMOTED (ex-standby)
                    # server itself, whose minted epoch now dominates,
                    # which is how the zombie learns it was deposed.
                    if self._standby:
                        ep = header.get("ep")
                        if ep is not None and int(ep) > self.epoch:
                            # adopt-forward: the stream's source is
                            # authoritative for its standby (a primary
                            # relaunched from checkpoint streams at its
                            # bumped epoch); a STALE stamp still fails
                            # the admission below
                            self.epoch = int(ep)
                    if self._fence_reject(conn, header):
                        continue
                    if not self._standby:
                        _send_msg(conn, {"op": "ERR",
                                         "msg": "not a standby"})
                        continue
                    if op == "REPL_SYNC":
                        self._handle_repl_sync(conn, payload)
                    else:
                        self._handle_repl_append(conn, header, payload)
                elif op == "PROMOTE":
                    # controller order: this standby becomes its range's
                    # primary under the minted epoch (idempotent by
                    # monotone epoch compare)
                    self._handle_promote(conn, header)
                elif op == "FINISH":
                    # group-wide DONE broadcast: a secondary shard serves
                    # its range with an unbounded iteration budget and
                    # learns run completion only from the primary's DONE,
                    # fanned out here (worker BYE and the group controller
                    # both send it; idempotent by construction)
                    self._done.set()
                    if self.supervisor is not None:
                        self.supervisor.freeze()
                    with self._wave_cv:
                        self._wave_cv.notify_all()
                    _send_msg(conn, {"op": "ACK"})
                elif op == "SNAPSHOTS":
                    # only meaningful once the run is done; the stack is
                    # consistent either way (lock-copied)
                    times, W = self.snapshot_stack()
                    _send_msg(
                        conn,
                        {"op": "SNAPSHOTS", "times": times,
                         "shape": list(W.shape)},
                        np.ascontiguousarray(W, np.float32).tobytes(),
                    )
                elif op == "EVAL_RESULT":
                    arr = np.frombuffer(payload, np.float64).copy()
                    with self._eval_cv:
                        self._eval_results[int(header["wid"])] = arr
                        self._eval_cv.notify_all()
                    _send_msg(conn, {"op": "ACK"})
                elif op == "BYE":
                    # a departing worker's last completed spans and its
                    # final pipeline-counter / convergence deltas
                    self._fold_wire_spans(header.get("spans"))
                    _pl_fold(header.get("pl"))
                    _cv_fold(header.get("cv"), clock=self._clock,
                             wall_ms=self._bus_time_ms())
                    _send_msg(conn, {"op": "ACK"})
                    return
                elif op == "SHM_OPEN":
                    # transport upgrade (net/shmring.py): attach to the
                    # colocated client's ring segments and keep serving
                    # the SAME framed protocol over them.  A refused
                    # attach is answered ERR and this TCP conversation
                    # continues.
                    upgraded = _shmring.serve_attach(conn, header)
                    if upgraded is not None:
                        conn = upgraded
                else:
                    _send_msg(conn, {"op": "ERR", "msg": f"bad op {op}"})
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def _fence_reject(self, conn: socket.socket, header: dict,
                      record: bool = False) -> bool:
        """Epoch-fencing admission (async.fence.enabled): True when the
        op was answered REJECT_FENCED and must not be served.

        Rules (``ep`` = the op's stamped epoch, ``self.epoch`` = this
        incarnation's minted one):

        - fencing off (``self.epoch == 0``) or unstamped op (legacy
          client): serve -- the wire stays byte-identical and old
          clients keep their old semantics;
        - ``ep < self.epoch``: the CLIENT is deposed (it pulled its view
          from a fenced incarnation) -- reject, tell it the current
          epoch so it re-resolves and continues;
        - ``ep > self.epoch``: a successor exists, so THIS server is the
          zombie -- remember the foreign epoch and reject; from here on
          every stamped op is refused (a zombie must neither mutate nor
          serve its old range, even to same-epoch stragglers);
        - ``ep == self.epoch`` and not deposed: serve.

        The reply carries the highest epoch this server knows, so a
        fenced client self-heals: it adopts the epoch and its next op
        (stamped fresh) is admitted by the current owner.  Fenced PUSH
        verdicts are recorded in the dedup window (``record=True``) so a
        retry of the same stamp re-answers the fence instead of racing a
        fresh admission."""
        if not self.epoch:
            return False
        ep = header.get("ep")
        if ep is None:
            return False
        ep = int(ep)
        if ep > self.epoch:
            # lock-free int write: monotone max under the GIL; a racing
            # reader sees either value, both of which fence correctly
            if ep > self._fenced_above:
                self._fenced_above = ep
        elif ep == self.epoch and self._fenced_above <= self.epoch:
            return False
        rej = {"op": "REJECT_FENCED",
               "epoch": max(self.epoch, self._fenced_above)}
        with self._stats_lock:
            self.fenced_rejects += 1
        supervisor_mod.bump_total("fenced_rejects")
        if record:
            # PUSH: fold the piggybacked telemetry BEFORE rejecting --
            # the 'fold before any drop path' invariant (_handle_push).
            # Dedup-replayed fenced stamps never reach here (the cached
            # verdict answers them), so nothing double-folds.
            self._fold_wire_spans(header.get("spans"))
            _pl_fold(header.get("pl"))
            _cv_fold(header.get("cv"), clock=self._clock,
                     wall_ms=self._bus_time_ms())
            self._dedup.record(header, rej)
        _send_msg(conn, rej)
        return True

    def note_fenced_above(self, ep: int) -> None:
        """Fold a foreign successor epoch observed OUT of band (the
        replication stream's REJECT_FENCED reply): from here on every
        stamped op is refused, exactly as if a client had proven the
        successor -- which drives workers to re-resolve onto it."""
        ep = int(ep)
        if ep > self._fenced_above:
            self._fenced_above = ep

    # ------------------------------------------------- adaptive control
    def set_control(self, wire: Optional[dict]) -> bool:
        """Install a CTRL payload (parallel/controller.py decisions).

        Monotone by (epoch, seq) -- fence-stamped: a deposed
        controller's decision (stamped with a pre-promotion epoch below
        an already-installed one) is refused and counted, exactly like
        a zombie's write.  ``None`` clears control entirely (back to
        the byte-identical legacy path).  Returns True when installed.
        """
        from asyncframework_tpu_torch.parallel.controller import ctrl_seq

        with self._ctrl_lock:
            if wire is None:
                self.ctrl = None
                self._ctrl_b = 0
                self._ctrl_merge = 0
                self._ctrl_damp = None
                self._ctrl_wdamp = {}
                return True
            new, cur = ctrl_seq(wire), ctrl_seq(self.ctrl)
            if new == cur:
                # idempotent re-delivery (the group re-announces its
                # stored ctrl on every SETMAP sweep): not a fence event
                return False
            if new < cur:
                self.ctrl_stale_rejects += 1
                return False
            self.ctrl = dict(wire)
            self._ctrl_b = max(0, int(wire.get("b", 0) or 0))
            self._ctrl_merge = max(0, int(wire.get("merge", 0) or 0))
            damp = wire.get("damp")
            if damp and self.algo == "asgd":
                # [coeff, floor, free]: the bounded 1/(1+tau)-family
                # law the drain applies per accepted push.  ASAGA is
                # excluded by design: damping the gradient term alone
                # would break its alpha_bar == mean(table) invariant
                # (same exactness stance as the codec exclusion).
                c, fl, fr = (float(damp[0]), float(damp[1]),
                             float(damp[2]))
                self._ctrl_damp = (c, fl, fr) if c > 0 else None
            else:
                self._ctrl_damp = None
            wd = wire.get("wdamp") or {}
            try:
                self._ctrl_wdamp = {int(w): float(f)
                                    for w, f in wd.items()}
            except (TypeError, ValueError):
                self._ctrl_wdamp = {}
        return True

    def _item_damp(self, wid: int, staleness: int) -> float:
        """The per-item step-DAMP factor under the installed CTRL law:
        1/(1 + c*(tau - free)) past the free slack, floored, times the
        per-worker extra factor for observer-flagged stragglers.  1.0
        (exact) whenever control is off or the push is fresh enough."""
        law = self._ctrl_damp
        if law is None:
            return 1.0
        c, floor_, free = law
        damp = 1.0
        over = float(staleness) - free
        if over > 0.0:
            damp = max(floor_, 1.0 / (1.0 + c * over))
        wd = self._ctrl_wdamp.get(wid)
        if wd is not None:
            damp = max(floor_, damp * wd)
        # an ACCEPTED item's damp must stay strictly positive: the merge
        # function's keep bit is ``mask > 0``, and a zero factor (possible
        # only with a hand-crafted CTRL floor of 0) would silently turn
        # an accepted push into a dropped one
        return float(max(damp, 1e-6))

    def control_signals(self) -> Dict[str, float]:
        """PS-local scalars the adaptive controller reads each tick
        (lock-free int reads, same stance as ``_telemetry_source``)."""
        return {
            "clock": float(self._clock),
            "accepted": float(self.accepted),
            "dropped": float(self.dropped),
            "queue_depth": float(len(self._merge_q)),
            "max_staleness": float(self.max_staleness),
            "avg_delay_ms": float(self.avg_delay_ms),
            "done": float(self._done.is_set()),
        }

    # ----------------------------------------------- hot-standby replication
    def attach_standby(self, host: str, port: int) -> None:
        """(Re)point this PRIMARY's replication stream at its warm
        standby (parallel/replication.py).  Idempotent per endpoint.
        ASGD-only, like the sharded plane it serves: ASAGA's per-sample
        history table is not streamed."""
        if self.algo != "asgd":
            raise ValueError("standby replication is ASGD-only")
        if self._standby:
            raise ValueError("a standby does not stream to a standby")
        from asyncframework_tpu_torch.parallel.replication import (
            ReplicationStream,
        )

        cur = self.repl
        if (cur is not None and not cur.fenced
                and (cur.host, cur.port) == (host, int(port))):
            return
        if cur is not None:
            cur.stop()
        self.repl = ReplicationStream(self, host, int(port))

    def set_standby_map(self, wire) -> None:
        """Install the group's standby endpoints (``[host, port]`` |
        None per range, SETMAP/launcher-supplied) and reconcile this
        server's own stream: a primary whose entry is set streams to
        it; an entry gone stops the stream."""
        self.standby_map = ([list(e) if e else None for e in wire]
                            if wire else None)
        if self._standby:
            return
        mine = None
        if (self.standby_map
                and self.shard_index < len(self.standby_map)):
            mine = self.standby_map[self.shard_index]
        if mine:
            self.attach_standby(str(mine[0]), int(mine[1]))
        elif self.repl is not None:
            self.repl.stop()
            self.repl = None

    def _handle_repl_sync(self, conn: socket.socket,
                          payload: bytes) -> None:
        """Standby side of REPL_SYNC: install the primary's checkpoint
        image as this mirror's state.  Idempotent -- re-installing the
        same image converges to the same state; a newer image simply
        supersedes.  The epoch is NOT taken from the image: the stream's
        ``ep`` stamp (adopt-forward in the dispatch) is the incarnation
        authority."""
        from asyncframework_tpu_torch.parallel import replication as _repl

        try:
            with np.load(io.BytesIO(payload), allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"]))
                if meta["algo"] != self.algo:
                    raise ValueError(
                        f"sync algo {meta['algo']!r} != {self.algo!r}")
                with self._lock:
                    self._install_state(z, meta)
                    clock = self._clock
        except (ValueError, KeyError, OSError) as e:
            _send_msg(conn, {"op": "ERR", "msg": f"bad sync: {e}"})
            return
        if self._t0 is not None:
            # align this process's run clock with the primary's elapsed
            # wall, so mirrored version births / snapshot times price
            # freshness on the primary's timeline, not this process's
            self._t0 = time.monotonic() - self._elapsed_offset_ms / 1e3
        _repl.bump("sync_installs")
        _send_msg(conn, {"op": "ACK", "clock": clock})

    def _handle_repl_append(self, conn: socket.socket, header: dict,
                            payload: bytes) -> None:
        """Standby side of REPL_APPEND: apply one replicated merge batch
        exactly as the primary judged it -- same accept verdicts through
        the same apply function in the same order, same ``(sid, seq)``
        dedup records (so a promoted standby re-answers replayed worker
        pushes from the REPLICATED window, never by re-applying), same
        snapshot cadence (the promoted trajectory continues seamlessly).

        Idempotence is the clock compare: a batch entirely at-or-below
        the applied clock is a duplicate delivery and re-ACKs; a batch
        starting exactly AT the clock applies; anything else is a gap --
        refused with ``resync`` so the stream re-bootstraps.  Never
        applied twice, never applied out of order."""
        from asyncframework_tpu_torch.parallel import replication as _repl

        if self.algo != "asgd":
            _send_msg(conn, {"op": "ERR", "msg": "replication is "
                                                 "ASGD-only"})
            return
        items = header.get("items") or []
        pre = int(header.get("pre", -1))
        cal = header.get("cal")
        with self._lock:
            if pre + len(items) <= self._clock:
                reply = {"op": "ACK", "clock": self._clock, "dup": True}
            elif pre != self._clock:
                _repl.bump("resyncs_requested")
                reply = {"op": "ERR", "resync": True,
                         "clock": self._clock}
            else:
                off = 0
                for it in items:
                    wid, ts = int(it[0]), int(it[1])
                    acc = bool(it[2])
                    sid, seq, ack = it[3], it[4], it[5]
                    st = int(it[6])
                    # per-item step-DAMP (absent on a pre-damping
                    # primary's stream: 1.0 = the exact legacy apply)
                    damp = float(it[7]) if len(it) > 7 else 1.0
                    if sid is not None:
                        self._dedup.record({"sid": sid, "seq": seq},
                                           dict(ack))
                    self.pushes_by_wid[wid] = (
                        self.pushes_by_wid.get(wid, 0) + 1)
                    if st > self.max_staleness:
                        self.max_staleness = st
                    if acc:
                        g = np.frombuffer(
                            payload[off:off + 4 * self.d], np.float32)
                        off += 4 * self.d
                        # same unpublish-before-tick discipline as the
                        # drain: lock-free SUBSCRIBE readers must never
                        # pair a new clock with old bytes
                        self._model_gen += 1
                        self._snap = None
                        # the primary's apply for this push, exactly: the
                        # serial apply IS the merge body, so the mirror's
                        # state stays the primary's bit for bit whatever
                        # batching the primary's drain used
                        self._apply_asgd(g, damp)
                        self._k += 1
                        self.accepted += 1
                        self.accepted_by_wid[wid] = (
                            self.accepted_by_wid.get(wid, 0) + 1)
                        if self._k % self.cfg.printer_freq == 0:
                            # the primary's snapshot cadence, mirrored:
                            # an owned host copy, never a buffer view
                            self._snapshots.append((
                                self._now_ms()
                                if self._t0 is not None else 0.0,
                                _host(self._w),
                            ))
                        if self._k >= self.cfg.num_iterations:
                            self._done.set()
                    else:
                        self.dropped += 1
                    self._clock += 1
                if cal:
                    self._cal_ms = float(cal[0])
                    self._cal_n = int(cal[1])
                    self.avg_delay_ms = float(cal[2])
                self._snap_basis = (self._clock, self._w,
                                    self._model_gen)
                if self._t0 is not None:
                    with self._born_lock:
                        self._ver_born[self._clock] = self._now_ms()
                        while len(self._ver_born) > 1024:
                            self._ver_born.popitem(last=False)
                _repl.bump("appends_applied")
                _repl.bump("append_items", len(items))
                reply = {"op": "ACK", "clock": self._clock}
        # deliberately NO checkpoint trigger here: durability is the
        # PRIMARY's job (a dead mirror is respawned and re-synced,
        # nothing to restore), and a mirror writing the shard's durable
        # files would race the acting primary's checkpoint thread on a
        # shared path.  Once PROMOTED, this server checkpoints through
        # the normal push path.
        _send_msg(conn, reply)

    def _handle_promote(self, conn: socket.socket,
                        header: dict) -> None:
        """PROMOTE: this standby becomes its range's primary at the
        controller-minted epoch.  Idempotent by monotone compare; the
        deposed primary needs no teardown order -- its next stream
        append (or any worker op, once note_fenced_above folds the
        bounce back) is REJECT_FENCED by the epoch installed here."""
        from asyncframework_tpu_torch.parallel import replication as _repl

        ep = int(header.get("epoch", 0) or 0)
        with self._lock:
            if self._standby and ep <= self.epoch:
                # a STALE order against a fresh mirror (a late operator
                # retry, a re-delivered PROMOTE after this standby was
                # respawned): flipping would orphan it from its
                # primary's stream -- refuse, loudly.  An already-
                # promoted server re-ACKs below (idempotent).
                stale_ep, cur_ep = ep, self.epoch
                was_standby = None
            else:
                if ep > self.epoch:
                    self.epoch = ep
                was_standby = self._standby
                self._standby = False
                # an already-promoted server re-ACKs a DUPLICATE order
                # (ep == epoch: same map, install idempotent by value)
                # but must NOT install a STALE one (ep < epoch: a late
                # re-delivery from before a LATER failover would regress
                # the map/epoch vector this server hands out)
                stale_order = ep < self.epoch
            clock, k = self._clock, self._k
        if was_standby is None:
            _send_msg(conn, {"op": "ERR",
                             "msg": f"stale promote: epoch {stale_ep} "
                                    f"<= standby epoch {cur_ep}"})
            return
        if not stale_order:
            wire = header.get("shards") or None
            if wire:
                self.shard_map = [list(e) for e in wire]
            if "index" in header:
                self.shard_index = int(header["index"])
            if header.get("epochs"):
                self.shard_epochs = [int(e) for e in header["epochs"]]
            if "standbys" in header:
                # the fresh standby spawned behind THIS promoted primary
                self.set_standby_map(header.get("standbys"))
        if was_standby:
            self.promoted = True
            _repl.bump("promotions")
        _send_msg(conn, {"op": "ACK", "clock": clock, "k": k,
                         "epoch": self.epoch})

    def _release_wave_locked(self) -> None:
        """Fire the partial barrier: everyone currently waiting rides this
        wave.  Caller holds ``_wave_cv``."""
        self._wave_id += 1
        self._waiting.clear()
        self._wave_cv.notify_all()

    def _cohort_threshold(self) -> int:
        """Partial-barrier ``b``, clamped to live membership: when the
        supervisor knows only L workers are alive, a wave of min(b, L)
        keeps flowing immediately instead of leaning on the starvation
        fallback every round (ASAP's membership-as-staleness stance).

        The adaptive controller's cohort override (CTRL ``b``) takes
        precedence over the configured ``bucket_threshold`` -- its
        decision already respects the declared tunable bounds, and a
        re-clamped wave is how one DELAYed worker stops gating every
        round -- but live membership still caps it."""
        b_ctrl = self._ctrl_b
        threshold = (b_ctrl if b_ctrl > 0
                     else max(self.cfg.bucket_threshold, 1))
        threshold = max(threshold, 1)
        if self.supervisor is not None:
            threshold = max(1, min(threshold,
                                   self.supervisor.live_worker_count()))
        return threshold

    def _model_snap(self) -> _ModelSnap:
        """The published snapshot of the current model version, built on
        demand.  The fast path is one attribute read -- no locks at all.
        A rebuild (first pull after an accepted push) reads the
        atomically-published build basis and does the O(d) readback +
        serialize + CRC without touching the model lock either;
        ``_snap_build_lock`` makes a cohort trigger one build, not P."""
        snap = self._snap
        if snap is not None:
            return snap
        with self._snap_build_lock:
            snap = self._snap
            if snap is not None:
                return snap
            # the basis reference is written atomically by the drain (a
            # tuple swap under the model lock); reading it here needs NO
            # lock at all -- the build's only waits are the device
            # readback and peer builders on _snap_build_lock
            basis = self._snap_basis
            ts, w_dev, gen = basis
            # device readback without any lock: model tensors are never
            # written in place, so the basis stays valid while later
            # drains apply; the host copy is owned (_host), never a view
            w_host = _host(w_dev)
            wire = w_host.tobytes()
            snap = _ModelSnap(int(ts), w_host, wire, wiredelta.crc(wire),
                              int(gen))
            # publish only while the model GENERATION is unchanged: a
            # drain may be mid-apply right now (it bumped _model_gen in
            # its accept branch, but writes the new basis only at drain
            # end), and publishing a stale snap then would let the
            # send-time re-stamp below pair the new clock with old
            # bytes.  Serving the unpublished snap is still correct --
            # it is stamped with ITS ts and staleness is priced.
            if self._model_gen == gen:
                self._snap = snap
                # the compare-then-store above is not atomic: an
                # invalidation (a drain's accepted item, a standby's
                # REPL_SYNC install) may bump the generation and clear the
                # reference between the two, and the store would then
                # leave the stale snapshot published until the next
                # invalidation -- a standby synced at the end of a run has
                # none.  Every invalidation bumps the generation BEFORE
                # it clears, so re-checking after the store closes the
                # window (builds are serialized by _snap_build_lock: no
                # newer snapshot can be unpublished here)
                if self._model_gen != gen:
                    self._snap = None
            return snap

    def _negotiated_model(self, have) -> Tuple[int, int, dict, bytes]:
        """The LOCK-FREE model-serving core shared by PULL and SUBSCRIBE:
        everything here reads the published :class:`_ModelSnap` (atomic
        reference) -- the model lock is never taken (net/lockwatch.py
        asserts it in debug runs), so serving never queues behind a merge
        drain and a drain never stalls behind a slow reader's socket.

        Returns ``(ts, clock, model_hdr, model_part)``: the send-time
        version stamp, the raw clock read, the negotiated reply header
        fields (empty for a legacy no-``have`` reply, byte-identical to
        the pre-delta wire), and the model payload bytes.  Encoding
        happens OUTSIDE any lock (the O(d) xor must not queue the apply
        path); the version caches pin every array/bytes object needed."""
        if have is not None:
            self._delta_clients_seen = True  # one-way flag, GIL-atomic
        snap = self._model_snap()
        ts, w_host, w_wire, w_crc = snap.ts, snap.w_host, snap.wire, snap.crc
        # the clock may have ticked past the snapshot on DROPPED pushes
        # (they advance the clock but not the model).  An accepted push
        # bumps the model GENERATION before its clock tick, so if the
        # generation still matches this snapshot's after an atomic clock
        # read, every tick in between was a drop -- same bytes, newer
        # version: stamp the current clock (send-time parity with the
        # serial path).  A lost race just serves snap.ts, which only
        # over-prices staleness, never mispairs version and bytes.
        cur = self._clock
        if cur != ts and self._model_gen == snap.gen:
            ts = cur
        basis = None
        if have is not None and self._delta_versions > 0:
            # recent-version cache for delta encoding, maintained only
            # once a delta client exists; ts is monotone, so insertion
            # order IS version age and eviction pops the oldest
            with self._versions_lock:
                if snap.ts not in self._w_versions:
                    self._w_versions[snap.ts] = w_host
                    while len(self._w_versions) > self._delta_versions:
                        self._w_versions.popitem(last=False)
                if ts != snap.ts and ts not in self._w_versions:
                    self._w_versions[ts] = w_host  # same bytes, newer ts
                    while len(self._w_versions) > self._delta_versions:
                        self._w_versions.popitem(last=False)
        if have is not None:
            if int(have) == ts:
                # exact-version match needs no cache: the basis IS the
                # current version, so this encodes to NOT_MODIFIED
                # (the reply CRC still guards a cross-PS-life clash)
                basis = w_host
            elif self._delta_versions > 0:
                with self._versions_lock:
                    basis = self._w_versions.get(int(have))
        model_hdr: dict = {}
        model_part: bytes = w_wire
        if have is not None:
            wenc, enc_payload, nnz = wiredelta.encode(
                w_host, basis, cur_bytes=w_wire
            )
            model_hdr = {"wenc": wenc, "crc": w_crc}
            if wenc == wiredelta.XDELTA:
                model_hdr["nnz"] = nnz
            model_part = enc_payload
            model_hdr["wlen"] = len(model_part)
        return ts, cur, model_hdr, model_part

    def _handle_pull(self, conn: socket.socket, header: dict) -> None:
        wid = int(header["wid"])
        proc = header.get("proc")
        if self._t0 is not None:
            with self._stats_lock:
                self._last_contact[wid] = self._now_ms()
        sup = self.supervisor
        if sup is not None:
            if not sup.owns(proc, wid):
                # a deposed surrogate (the real owner rejoined): stand down
                _send_msg(conn, {"op": "RELEASED"})
                return
            sup.touch(wid, proc)
            sup.ack_adoption(proc, wid)
        if self._done.is_set():
            _send_msg(conn, {"op": "DONE"})
            return
        # traced update: time spent in the partial-barrier wave gate below
        # is THE server-side pull latency (pull.wait).  Untraced pulls (no
        # tc header -- sampling off or unsampled update) do no trace work.
        tc = _trace.TraceContext.from_wire(header["tc"]) \
            if "tc" in header else None
        t_wait0 = _trace.now_ms() if tc is not None else 0.0
        STARVATION_S = 1.0  # degraded-cohort release when peers are gone
        with self._wave_cv:
            self._waiting.append(wid)
            my_wave = self._wave_id
            if len(self._waiting) >= self._cohort_threshold():
                # the partial barrier fires
                self._release_wave_locked()
            else:
                t_enter = time.monotonic()
                while (
                    my_wave == self._wave_id
                    and not self._done.is_set()
                    and not self._stop.is_set()
                ):
                    self._wave_cv.wait(timeout=0.05)
                    # membership may have shrunk while we waited: the
                    # clamped threshold can release this wave NOW
                    if (
                        my_wave == self._wave_id
                        and len(self._waiting) >= self._cohort_threshold()
                    ):
                        self._release_wave_locked()
                        break
                    # starvation fallback: when fewer than threshold workers
                    # are still alive the wave can never fill -- after a
                    # full second of waiting, release whoever is here as a
                    # degraded cohort (the reference's wait loop assumes
                    # workers come back; dead ones never do)
                    if (
                        my_wave == self._wave_id
                        and time.monotonic() - t_enter > STARVATION_S
                    ):
                        self._release_wave_locked()
                        break
        t_wait1 = _trace.now_ms() if tc is not None else 0.0
        if self._done.is_set():
            _send_msg(conn, {"op": "DONE"})
            return
        extra_hdr: dict = {}
        extra_payload = b""
        if self.algo == "asaga":
            # PS-side seeded sampling (the reference driver's sampledMap
            # draw): per-wid RNG chain, Bernoulli(b) over the worker's
            # shard rows, padded to the static step capacity.  Deliberately
            # OUTSIDE the global lock: per-wid state (rng/table/pending) is
            # only ever touched by this wid's connection thread (pull and
            # push are serialized per connection, and no push can arrive
            # before this MODEL is sent), and O(n_p) sampling must not
            # queue other workers' pulls or the push/apply hot path.
            from asyncframework_tpu_torch.ops.steps import sparse_step_capacity

            n_p = int(header["n_p"])
            with self._saga_lock:  # vs the checkpoint writer's snapshot
                table = self._table.get(wid)
                if table is None or table.shape[0] != n_p:
                    table = np.zeros(n_p, np.float32)
                    self._table[wid] = table
                rng = self._rngs.get(wid)
                if rng is None:
                    rng = np.random.default_rng([self.cfg.seed, wid])
                    self._rngs[wid] = rng
                cap = sparse_step_capacity(self.cfg.batch_rate, n_p)
                idx = np.nonzero(rng.random(n_p) < self.cfg.batch_rate)[0]
                if idx.size > cap:  # ~1e-9/draw: drop the excess (parity
                    idx = idx[:cap]  # with the device steps' capacity rule)
                idx_pad = np.zeros(cap, np.uint32)
                idx_pad[: idx.size] = idx
                alpha_sel = table[idx_pad].astype(np.float32)
                self._pending_idx[wid] = idx.astype(np.int64)
            extra_hdr = {"cap": cap, "n_valid": int(idx.size)}
            extra_payload = idx_pad.tobytes() + alpha_sel.tobytes()
        have = header.get("have")
        ts, _clock, model_hdr, model_part = self._negotiated_model(have)
        with self._stats_lock:
            self._pull_times[wid] = self._now_ms()
            shape = model_hdr.get("wenc", "full")
            self.pull_replies[shape] = self.pull_replies.get(shape, 0) + 1
            self.pull_model_bytes += len(model_part)
        avg = self.avg_delay_ms
        if tc is not None:
            # exactly the wave-gate wait (barrier cost), not the model
            # readback; folded here because the served version ts is only
            # known under the lock
            self._fold_span(_trace.Span(
                stage=_trace.PULL_WAIT, trace_id=tc.trace_id,
                span_id=_trace._new_id(8), parent_id=tc.span_id,
                worker_id=wid, model_version=ts, start_ms=t_wait0,
                dur_ms=max(0.0, t_wait1 - t_wait0),
            ))
        if sup is not None:
            # adoption orders ride the PULL reply (no extra RTT, no side
            # channel): re-delivered until the adopter's first pull FOR the
            # orphan lands, so a lost reply cannot lose a shard
            orders = sup.orders_for(proc)
            if orders:
                extra_hdr["adopt"] = orders
        if self.epoch:
            # fencing on: replies advertise the current epoch so a
            # client that joined before a fence converges without a
            # REJECT_FENCED round trip (absent with fencing off --
            # byte-identical legacy wire)
            extra_hdr["ep"] = self.epoch
        ctrl = self.ctrl
        if ctrl is not None:
            # adaptive-control decisions ride PULL replies the same way
            # adoption orders do: re-delivered until the client's ``cs``
            # stamp catches up with the decision's FULL (epoch, seq)
            # stamp -- a restarted controller under a minted epoch
            # starts seq over, and a bare-seq compare would strand
            # every surviving worker on the deposed decisions.  A lost
            # reply cannot lose a decision and a settled cluster pays
            # zero extra bytes per pull.  Absent with control off.
            cs = header.get("cs")
            if cs is None:
                stamp = (0, -1)
            elif isinstance(cs, (list, tuple)) and len(cs) == 2:
                stamp = (int(cs[0]), int(cs[1]))
            else:  # legacy bare-seq stamp: pair it with OUR epoch
                stamp = (int(ctrl.get("ep", 0) or 0), int(cs))
            from asyncframework_tpu_torch.parallel.controller import ctrl_seq

            if stamp < ctrl_seq(ctrl):
                extra_hdr["ctrl"] = ctrl
        # vectored zero-copy framing: the cached model bytes and the ASAGA
        # extra payload go out as one kernel-gathered iovec -- the payload
        # is never copied into a fresh frame buffer
        _frame.send_msg_vectored(
            conn,
            {"op": "MODEL", "ts": ts, "avg_delay_ms": avg,
             "calibrated":
                 self._cal_n >= self.cfg.effective_calibration_iters(),
             **model_hdr, **extra_hdr},
            (model_part, extra_payload) if extra_payload
            else (model_part,),
        )

    def _version_age_ms(self, ts: int, clock: int) -> float:
        """Freshness age of model version ``ts``: ms since the first NEWER
        version was published (0 while ``ts`` is still the current model).
        Bounded scan of the birth ring -- entries are clock-ascending, so
        the first key past ``ts`` is the moment ``ts`` stopped being the
        latest; an evicted birth (very stale subscriber) under-reports
        rather than guessing."""
        if ts >= clock or self._t0 is None:
            return 0.0
        now = self._now_ms()
        with self._born_lock:
            for v, born in self._ver_born.items():
                if v > ts:
                    return max(0.0, now - born)
        return 0.0

    def _register_relay_child(self, host: str, port: int) -> None:
        """Record a relaycast direct child (SUBSCRIBE carried ``rport``)
        and lazily start the offer thread.  The shared ChildRegistry
        (relaycast/offers.py) bounds the set at the tree fanout with
        LRU eviction: direct children renew their slot on every
        subscribe, so a stale registrant (a deep node that re-homed
        here once) is displaced, never a live one."""
        start = False
        with self._relay_lock:
            if self._relay_registry is None:
                from asyncframework_tpu_torch.relaycast.offers import (
                    ChildRegistry,
                )

                self._relay_registry = ChildRegistry(self._relay_fanout)
            if self._relay_thread is None:
                from asyncframework_tpu_torch.utils.threads import guarded

                self._relay_thread = threading.Thread(
                    target=guarded(self._relay_offer_loop,
                                   "ps-relay-offer"),
                    name="ps-relay-offer", daemon=True,
                )
                start = True
        self._relay_registry.register(host, port)
        if start:
            self._relay_thread.start()

    def _relay_offer_loop(self) -> None:
        """The root offer path: watch the merge clock and announce each
        new published version (RELAY_OFFER: ts + CRC + epoch) to the
        registered direct children via the shared ChildRegistry fan-out.
        Entirely off the hot path -- the snapshot build it may trigger
        is the same one the next pull would pay, and sends happen
        outside every lock with short timeouts."""
        while not self._stop.is_set():
            self._stop.wait(0.02)
            clock = self._clock
            if clock == self._relay_offered:
                continue
            registry = self._relay_registry
            if registry is None or not registry.children():
                self._relay_offered = clock
                continue
            snap = self._model_snap()
            hdr = {"op": "RELAY_OFFER", "ts": snap.ts, "crc": snap.crc}
            if self.epoch:
                hdr["ep"] = self.epoch
            self.relay_offers += registry.offer(hdr)
            self._relay_offered = clock

    def _handle_subscribe(self, conn: socket.socket, header: dict) -> None:
        """Serving-tier snapshot subscription (the JAX package's
        ``serving/replica.py``; a standby's read face).

        Same ``have=``-negotiated NOT_MODIFIED / XDELTA / FULL reply
        shapes as PULL -- the replica cache-invalidation protocol IS the
        delta-pull protocol -- but deliberately WITHOUT the partial-
        barrier wave gate (a read must never wait for a training cohort
        to fill), without membership/ownership discipline (replicas are
        not shard servers), and still answering after DONE (training
        finishing must not take the read path down).  Entirely lock-free
        on the model lock, like ``_handle_pull``.  The reply additionally
        carries the PS merge clock, the accepted-update count, the served
        version's age in ms, and the done flag, so replicas can price
        their own freshness lag in versions AND ms."""
        rp = header.get("rport")
        if rp is not None:
            # relaycast: the subscriber runs a relay node on this port --
            # register it for the root offer path
            try:
                peer = conn.getpeername()[0]
            except OSError:
                peer = None
            if peer is not None:
                self._register_relay_child(peer, int(rp))
        have = header.get("have")
        ts, cur, model_hdr, model_part = self._negotiated_model(have)
        shape = model_hdr.get("wenc", "full")
        with self._stats_lock:
            self.subscribe_replies[shape] = (
                self.subscribe_replies.get(shape, 0) + 1
            )
            self.subscribe_model_bytes += len(model_part)
        if self.epoch:
            model_hdr["ep"] = self.epoch
        _frame.send_msg_vectored(
            conn,
            {"op": "MODEL", "ts": ts, "clock": cur, "k": self._k,
             "done": self._done.is_set(),
             "age_ms": round(self._version_age_ms(ts, cur), 3),
             **model_hdr},
            (model_part,),
        )

    def _handle_push(self, conn: socket.socket, header: dict,
                     payload: bytes) -> None:
        wid = int(header["wid"])
        ts = int(header["ts"])
        proc = header.get("proc")
        # completed client-side spans ride the PUSH header (the piggyback
        # that makes spans survive worker death); fold them before any
        # drop path so a membership-stale push still delivers its telemetry
        self._fold_wire_spans(header.get("spans"))
        # pipelined-loop counter deltas piggyback the same way (only
        # present when the worker runs the pipelined loop): dedup'd
        # retries never reach this handler, so a delta folds exactly once
        _pl_fold(header.get("pl"))
        # convergence samples (conf-gated, async.convergence.sample):
        # (version, loss, grad_norm) tuples fold into the loss-vs-wallclock
        # / loss-vs-version curves, stamped with THIS PS's run clock and
        # the staleness it observes right now
        _cv_fold(header.get("cv"), clock=self._clock,
                 wall_ms=self._bus_time_ms())
        tc = _trace.TraceContext.from_wire(header["tc"]) \
            if "tc" in header else None
        t_queue0 = _trace.now_ms() if tc is not None else 0.0
        sup = self.supervisor
        if sup is not None and not sup.owns(proc, wid):
            # membership-stale push: the shard was re-homed (rejoin deposed
            # this surrogate) -- drop it like any other too-stale gradient,
            # but do not tick the merge clock (nothing was considered)
            with self._lock:
                self.membership_rejects += 1
                ack = {"op": "ACK", "accepted": False, "released": True,
                       "done": self._done.is_set()}
                self._dedup.record(header, ack)
            _send_msg(conn, ack)
            return
        if sup is not None:
            sup.touch(wid, proc)
        diff = None
        if header.get("gq") is not None:
            # quantized gradient (net/wirecodec.py, async.codec.push):
            # fp16/int8 payload back to dense f32.  The worker's error-
            # feedback accumulator already folded this push's
            # quantization residual into its NEXT gradient, so the
            # server applies the dequantized value as-is -- stateless
            # here by design.  ASAGA never quantizes (exact history
            # scalars), so diff stays None.
            try:
                g_host = wirecodec.decode_grad(header, payload, self.d)
            except ValueError as e:
                _send_msg(conn, {"op": "ERR",
                                 "msg": f"bad quantized push: {e}"})
                return
        elif header.get("enc") == "sparse":
            # (idx, val) pair gradient (rcv1-class): scatter into dense on
            # host -- the PS's apply path is dense either way
            nnz = int(header["nnz"])
            idx_g = np.frombuffer(payload[: 4 * nnz], np.uint32)
            val_g = np.frombuffer(payload[4 * nnz: 8 * nnz], np.float32)
            g_host = np.zeros(self.d, np.float32)
            g_host[idx_g] = val_g
            if self.algo == "asaga":
                diff = np.frombuffer(payload[8 * nnz:], np.float32)
        else:
            raw = np.frombuffer(payload, np.float32)
            if self.algo == "asaga":
                g_host, diff = raw[: self.d], raw[self.d:]
            else:
                g_host = raw
        # merge queue: the payload was decoded OUTSIDE the lock; whoever
        # holds the model lock next coalesces every pending push into one
        # fused device apply.  Per-push accept/reject, dedup, clock, and
        # calibration bookkeeping stay per item (FIFO), exactly as the
        # serial path ordered them -- only the device dispatch is batched.
        item = _PendingPush(wid, ts, g_host, diff, header, len(payload),
                            tc, t_queue0)
        self._merge_q.append(item)
        with self._lock:
            while not item.done:
                self._drain_merge_locked()
        # pre-warm the pull snapshot for the version this drain produced,
        # OFF the model lock, on this (push) thread: the next cohort pull
        # finds it published and pays zero build latency.  A no-op when a
        # peer already built it; worst case under heavy churn the build
        # races a newer drain and is skipped at publish (CRC-gated
        # fallback keeps even the raciest interleaving degrade-to-full,
        # never wrong).
        if item.accepted:
            self._model_snap()
        if tc is not None:
            # staleness in TIME (ASAP's quantity): age of the model basis
            # this gradient was computed on = now - that version's pull.
            # merge.queue covers decode + wait for the single-writer model
            # lock; merge.apply covers the drain this push rode (tau
            # filter + fused apply dispatch) under the lock.
            self._fold_span(_trace.Span(
                stage=_trace.MERGE_QUEUE, trace_id=tc.trace_id,
                span_id=_trace._new_id(8), parent_id=tc.span_id,
                worker_id=wid, model_version=ts, start_ms=t_queue0,
                dur_ms=max(0.0, item.t_apply0 - t_queue0),
            ))
            self._fold_span(_trace.Span(
                stage=_trace.MERGE_APPLY, trace_id=tc.trace_id,
                span_id=_trace._new_id(8), parent_id=tc.span_id,
                worker_id=wid, model_version=ts, start_ms=item.t_apply0,
                dur_ms=max(0.0, item.t_done - item.t_apply0),
                staleness=int(item.staleness),
                staleness_ms=float(item.task_ms),
                accepted=bool(item.accepted),
            ))
        if self.bus is not None:
            from asyncframework_tpu_torch.metrics import GradientMerged

            self.bus.post(GradientMerged(
                self._bus_time_ms(), worker_id=wid,
                staleness=int(item.staleness),
                accepted=bool(item.accepted),
                iteration=item.k_at_merge,
            ))
        with self._wave_cv:
            self._wave_cv.notify_all()  # a wave may now meet its threshold
        _send_msg(conn, item.ack)
        if item.do_snapshot:
            # printer_freq cadence: signal the async checkpoint thread --
            # nobody's next message waits behind the disk write
            self._ckpt_trigger.set()

    @_prof.zoned("merge.drain")
    def _drain_merge_locked(self) -> None:
        """Caller holds ``_lock``.  Drain up to ``_merge_max`` pending
        pushes in FIFO order -- per-push accept/reject, dedup, clock, and
        calibration bookkeeping identical to the serial path -- then run
        ONE fused device apply for all accepted gradients
        (``ops/steps.make_*_apply_merge``, bit-identical to the serial
        apply order).  A push landing on the printer_freq snapshot
        boundary closes its batch so the host copy below pins exactly
        that version."""
        drained: List[_PendingPush] = []
        batch: List[Tuple[_PendingPush, Optional[np.ndarray]]] = []
        # replication stream (parallel/replication.py): the standby
        # applies from exactly this clock, so capture it before any item
        # ticks it
        pre_clock = self._clock
        # adaptive control: the EFFECTIVE merge budget moves within
        # [1, _merge_max].  0 = no override = the configured bound.
        budget = self._ctrl_merge or self._merge_max
        budget = max(1, min(budget, self._merge_max))
        while self._merge_q and len(drained) < budget:
            item = self._merge_q.popleft()
            drained.append(item)
            item.t_apply0 = _trace.now_ms() if item.tc is not None else 0.0
            self.push_bytes += item.payload_len
            if self._t0 is not None:
                self._last_contact[item.wid] = self._now_ms()
            self.pushes_by_wid[item.wid] = (
                self.pushes_by_wid.get(item.wid, 0) + 1
            )
            staleness = self._clock - item.ts
            self.max_staleness = max(self.max_staleness, staleness)
            self.staleness_counts[staleness] = (
                self.staleness_counts.get(staleness, 0) + 1)
            task_ms = self._now_ms() - self._pull_times.get(
                item.wid, self._now_ms()
            )
            if self._cal_n < self.cfg.effective_calibration_iters():
                self._cal_ms += task_ms
                self._cal_n += 1
                if self._cal_n >= self.cfg.effective_calibration_iters():
                    self.avg_delay_ms = self._cal_ms / max(self._cal_n, 1)
            idx = None
            if self.algo == "asaga":
                # ASAGA's filter quirk: accept iff k - staleness <= taw
                # (SparkASAGAThread.scala:184; the ASGD driver tests
                # staleness <= taw).  A push whose pull-time sample the PS
                # no longer holds (restart) cannot commit -- drop it.
                idx = self._pending_idx.pop(item.wid, None)
                accepted = (
                    self._k - staleness <= self.cfg.taw
                    and self._k < self.cfg.num_iterations
                    and idx is not None
                )
            else:
                accepted = (
                    staleness <= self.cfg.taw
                    and self._k < self.cfg.num_iterations
                )
            if accepted:
                # bump the model generation and unpublish the snapshot
                # BEFORE the clock tick: a concurrent lock-free pull
                # that reads this item's new clock must see the new
                # generation too and keep the snapshot's own (older)
                # version stamp -- never pair new version, old bytes.
                # Dropped pushes tick the clock WITHOUT bumping: the
                # model is unchanged, so the snapshot stays valid.
                self._model_gen += 1
                self._snap = None
                batch.append((item, idx))
                self._k += 1
                self.accepted += 1
                self.accepted_by_wid[item.wid] = (
                    self.accepted_by_wid.get(item.wid, 0) + 1
                )
                if self._k % self.cfg.printer_freq == 0:
                    item.do_snapshot = True
                if self._k >= self.cfg.num_iterations:
                    self._done.set()
                    if self.supervisor is not None:
                        # run complete: pin membership -- post-done silence
                        # (evaluation, teardown) is not death
                        self.supervisor.freeze()
            else:
                self.dropped += 1
            self._clock += 1
            item.staleness = staleness
            item.task_ms = task_ms
            item.accepted = accepted
            if accepted:
                # delay-adaptive step damping (CTRL law; 1.0 = exact
                # undamped legacy whenever control is off): decided per
                # item at drain time from ITS observed staleness, so a
                # dedup-replayed stamp -- which never reaches a second
                # drain -- keeps exactly the factor it was applied with
                item.damp = self._item_damp(item.wid, staleness)
                if item.damp != 1.0:
                    self.damped_applies += 1
                    self.damp_sum += item.damp
                    self.damp_min = min(self.damp_min, item.damp)
            item.k_at_merge = self._k
            self._wstat_merge(item.wid, staleness, accepted)
            ack = {"op": "ACK", "accepted": bool(accepted),
                   "done": self._done.is_set()}
            # record INSIDE the lock, before any send: (1) a retry after a
            # lost ACK must find the (sid, seq) applied; (2) the checkpoint
            # writer serializes state under this same lock, so a saved
            # model can never be missing the dedup entry of a push it
            # already contains (that gap would re-apply the push after a
            # restart)
            self._dedup.record(item.header, ack)
            item.ack = ack
            if item.do_snapshot:
                # close the batch at the snapshot boundary: the pinned
                # host copy must be exactly version k, not a later one
                break
        if batch:
            if len(batch) == 1:
                self._apply_one(batch[0][0], batch[0][1])
            else:
                # ONE drain for the whole batch: the merge function folds
                # the pushes in slot order through the serial expression
                # (bit-equal to len(batch) serial applies)
                G = torch.from_numpy(np.stack([it.g_host for it, _ in batch]))
                # a mask slot carries the per-item step-DAMP factor (1.0 =
                # the classic keep bit, exact)
                mask = torch.tensor([it.damp for it, _ in batch],
                                    dtype=torch.float32)
                G_dev = G.to(self.device)
                m_dev = mask.to(self.device)
                if self.algo == "asaga":
                    self._w, self._ab = self._apply_merge(
                        self._w, self._ab, G_dev, m_dev
                    )
                    with self._saga_lock:  # vs checkpoint table copies
                        for it, idx2 in batch:
                            self._table[it.wid][idx2] = (
                                it.diff[: idx2.size]
                            )
                else:
                    self._w, self._k_dev = self._apply_merge(
                        self._w, G_dev, m_dev, self._k_dev
                    )
            # publish the new build basis (O(1) tuple swap under the lock
            # this drain already holds): the next snapshot rebuild reads
            # it lock-free instead of queueing on the model lock
            self._snap_basis = (self._clock, self._w, self._model_gen)
            # version birth: this drain PUBLISHED a new model version --
            # stamp its clock with the wall time so SUBSCRIBE replies can
            # price freshness age in ms (O(1), its own small lock)
            if self._t0 is not None:
                with self._born_lock:
                    self._ver_born[self._clock] = self._now_ms()
                    while len(self._ver_born) > 1024:
                        self._ver_born.popitem(last=False)
            self.merge_batches += 1
            self.merge_merged += len(batch)
            self.merge_batch_max = max(self.merge_batch_max, len(batch))
        if self.repl is not None and drained:
            # hot-standby replication: hand the WHOLE drained batch --
            # verdicts, (sid, seq) stamps, staleness, damp factors and
            # the accepted gradients' host arrays -- to the stream.
            # O(items) list work under the lock; serialization and I/O
            # happen on the sender thread.  Dropped items ride too: they
            # tick the standby's clock and land their dedup verdicts, so
            # a promoted standby re-answers EVERY replayed stamp.
            items = []
            grads = []
            for it in drained:
                items.append([it.wid, it.ts, 1 if it.accepted else 0,
                              it.header.get("sid"), it.header.get("seq"),
                              it.ack, int(it.staleness),
                              float(it.damp)])
                if it.accepted:
                    grads.append(it.g_host)
            self.repl.enqueue(pre_clock, items, grads,
                              [self._cal_ms, self._cal_n,
                               self.avg_delay_ms])
        if drained:
            # flight-recorder breadcrumb (metrics/flightrec.py): one
            # event per drain so a SIGKILLed PS's dump ends with its
            # last applied batch (no-op when no recorder is installed)
            _flight.note("merge", clock=self._clock, k=self._k,
                         batch=len(drained),
                         accepted=self.accepted, dropped=self.dropped)
        for item in drained:
            if item.do_snapshot:
                # host copy NOW: the snapshot must pin this version (the
                # boundary item closed its batch above, so _w is exactly
                # the k it rode in on)
                self._snapshots.append((self._now_ms(), _host(self._w)))
            if item.tc is not None:
                item.t_done = _trace.now_ms()
            item.done = True

    def _apply_one(self, item: _PendingPush,
                   idx: Optional[np.ndarray]) -> None:
        """Serial single-push apply (caller holds ``_lock``): the merge
        function at m = 1, so serial and fused drains cannot differ."""
        if self.algo == "asaga":
            # three-term update + alpha_bar advance (delta == g is exact
            # over DCN; see __init__); then the ScalarMap merge -- commit
            # this push's candidate scalars
            g_dev = torch.tensor(item.g_host, dtype=torch.float32,
                                 device=self.device)
            self._w, self._ab = self._apply_merge(
                self._w, self._ab, g_dev[None], self._one)
            with self._saga_lock:  # vs checkpoint table copies
                self._table[item.wid][idx] = item.diff[: idx.size]
        else:
            self._apply_asgd(item.g_host, item.damp)

    def _apply_asgd(self, g_host: np.ndarray, damp: float) -> None:
        """One ASGD apply at step-DAMP ``damp`` (caller holds ``_lock``):
        the merge function at m = 1 with ``damp`` in its mask slot -- the
        fused drain's slot expression, so the serial path, the fused
        drain and a standby's mirror agree bit for bit at every damp."""
        g_dev = torch.tensor(g_host, dtype=torch.float32,
                             device=self.device)
        mask = self._one if damp == 1.0 else torch.tensor(
            [damp], dtype=torch.float32, device=self.device)
        self._w, self._k_dev = self._apply_merge(
            self._w, g_dev[None], mask, self._k_dev)

    # ------------------------------------------------------------ evaluation
    def wait_done(self, timeout_s: float,
                  progress_timeout_s: Optional[float] = None) -> "WaitDone":
        """Progress-aware wait for the run to finish.

        Returns a truthy :class:`WaitDone` on completion.  On timeout --
        or, with ``progress_timeout_s``, as soon as NO worker has contacted
        the PS and the merge clock has not moved for that long -- returns a
        falsy ``WaitDone`` carrying the per-worker last-contact +
        contribution-bitmap diagnostic instead of a bare ``False``, so a
        stalled run names its silent workers instead of hanging mute for
        the full timeout.
        """
        deadline = time.monotonic() + timeout_s
        last_progress = time.monotonic()
        seen_clock = -1
        seen_contact = -1.0
        while True:
            left = deadline - time.monotonic()
            if self._done.wait(timeout=max(0.0, min(0.2, left))):
                return WaitDone(True, None)
            now = time.monotonic()
            with self._lock:
                clock = self._clock
                contact = max(self._last_contact.values(), default=-1.0)
            if clock != seen_clock or contact != seen_contact:
                seen_clock, seen_contact = clock, contact
                last_progress = now
            stalled = (
                progress_timeout_s is not None
                and now - last_progress > progress_timeout_s
            )
            if stalled or now >= deadline:
                return WaitDone(False, self.progress_diagnostic(
                    stalled="stalled" if stalled else "timeout"
                ))

    def progress_diagnostic(self, stalled: str = "timeout") -> str:
        """Per-worker last-contact ages, push/accept counts, and the
        contribution bitmap -- everything needed to see WHO went silent."""
        with self._lock:
            now = self._now_ms() if self._t0 is not None else 0.0
            k, clock = self._k, self._clock
            contact = dict(self._last_contact)
            pushes = dict(self.pushes_by_wid)
            accepted = dict(self.accepted_by_wid)
        member = (self.supervisor.membership()
                  if self.supervisor is not None else {})
        nw = self.cfg.num_workers
        bitmap = "".join(
            "1" if accepted.get(w, 0) > 0 else "0" for w in range(nw)
        )
        lines = [
            f"PS {stalled}: k={k}/{self.cfg.num_iterations} "
            f"clock={clock} contributed-bitmap={bitmap}",
        ]
        for w in range(nw):
            age = contact.get(w)
            age_s = "never" if age is None else f"{now - age:8.0f}ms ago"
            extra = ""
            m = member.get(w)
            if m:
                extra = f" state={m['state']} owner={m['owner']}"
            lines.append(
                f"  wid {w:3d}: last-contact {age_s:>14}  "
                f"pushes={pushes.get(w, 0):<6d} "
                f"accepted={accepted.get(w, 0):<6d}{extra}"
            )
        return "\n".join(lines)

    def snapshot_stack(self) -> Tuple[List[float], np.ndarray]:
        with self._lock:
            final = (self._now_ms(), _host(self._w))
            snaps = list(self._snapshots) + [final]
        times = [t for (t, _w) in snaps]
        W = np.stack([w for (_t, w) in snaps])
        return times, W

    def collect_eval(self, num_worker_procs: int, timeout_s: float
                     ) -> Optional[np.ndarray]:
        """Sum per-process snapshot losses pushed via EVAL_RESULT.

        With the supervisor, the expected count is clamped to processes
        that were still ALIVE when the run finished: a crashed worker's
        EVAL never comes, but its adopted shards are scored by their
        adopter -- the union still covers the full dataset, so waiting
        for the dead process would only trade the objective for a
        timeout."""
        deadline = time.monotonic() + timeout_s
        with self._eval_cv:
            while True:
                expected = num_worker_procs
                if self.supervisor is not None:
                    # clamp only when processes actually registered (an
                    # unelastic client set leaves the roster empty)
                    live = self.supervisor.live_proc_count()
                    if live > 0:
                        expected = min(expected, live)
                if len(self._eval_results) >= expected:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._eval_cv.wait(timeout=min(left, 0.2))
            total = None
            for arr in self._eval_results.values():
                total = arr if total is None else total + arr
            return total

    @property
    def dedup_hits(self) -> int:
        """Retried PUSHes answered from the dedup window (each one is a
        gradient that would have merged twice before net/session.py)."""
        return self._dedup.hits

    def stop(self) -> None:
        self._stop.set()
        self._done.set()
        if self.repl is not None:
            self.repl.stop()
        if getattr(self, "_ts_source", None) is not None:
            from asyncframework_tpu_torch.metrics import timeseries as _ts

            # identity-gated: a stopped PS must not unhook its replacement
            _ts.unregister_source("ps", self._ts_source)
        if getattr(self, "_workers_section", None) is not None:
            from asyncframework_tpu_torch.metrics import live as _live

            _live.unregister_status_section("ps_workers",
                                            self._workers_section)
        if self.supervisor is not None:
            self.supervisor.stop()
        with self._wave_cv:
            self._wave_cv.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass
        # reap on stop: drop every finished handler thread (live ones are
        # daemons draining their last reply; they exit with the sockets)
        self._threads = [x for x in self._threads if x.is_alive()]


class FencedError(ConnectionError):
    """The server refused this client's ops under epoch fencing and the
    client cannot self-heal by adopting a newer epoch -- the server
    itself is at (or below) the client's epoch, i.e. the client is
    talking to a deposed zombie.  Subclasses ConnectionError so worker
    loops treat it like any other dead endpoint: pace, re-dial, and
    land on the current owner."""


# -------------------------------------------------------------- worker side
class PSClient:
    """One TCP connection to the PS (workers may hold several, one per
    logical worker id, or share one -- the protocol is synchronous per
    connection, like an RpcEndpointRef).

    Transport faults are the retry layer's problem now: every RPC routes
    through a :class:`~asyncframework_tpu_torch.net.RetryPolicy` (backoff +
    jitter + per-endpoint circuit breaker), reconnecting between attempts.
    Mutating ops (PUSH) are stamped with this client's session ``(sid,
    seq)`` so a retry after a lost ACK is answered from the PS's dedup
    window instead of merging the gradient twice."""

    def __init__(self, host: str, port: int, timeout_s: float = 120.0,
                 retry: Optional[RetryPolicy] = None,
                 session: Optional[ClientSession] = None,
                 proc: Optional[str] = None,
                 recorder: Optional["_trace.TraceRecorder"] = None,
                 pull_mode: Optional[str] = None,
                 pl_stats: Optional[_PipelineStats] = None,
                 cv_buf=None, epoch: int = 0,
                 push_codec: Optional[str] = None, ctrl_sink=None,
                 shm: Optional[bool] = None):
        self.host, self.port = host, int(port)
        # adaptive control plane: a ControlSink (parallel/controller.py)
        # shared by this worker process's clients.  PULL requests stamp
        # the sink's decision seq (``cs``) and PULL replies carrying a
        # newer CTRL payload install into it (monotone by (ep, seq)).
        # None (every non-controlled client) = no header field,
        # byte-identical wire.
        self.ctrl_sink = ctrl_sink
        self.endpoint = f"{host}:{self.port}"
        # fencing epoch this client stamps on every PULL/PUSH (``ep``
        # header key; 0 = fencing off, no key, byte-identical legacy
        # wire).  Seeded from the WELCOME handshake and advanced by MODEL
        # replies / REJECT_FENCED verdicts -- a fenced client adopts the
        # minted epoch and its NEXT op is admitted; entries already
        # stamped (the windowed push pipe replays verbatim) keep their
        # old epoch and are rejected exactly once each, which is the
        # point: a deposed incarnation's buffered writes never land.
        self.epoch = int(epoch)
        self.fenced_replies = 0
        self.retry = retry if retry is not None else RetryPolicy.from_conf(
            attempt_timeout_s=timeout_s
        )
        self.session = session if session is not None else ClientSession()
        # version-gated delta pulls (net/wiredelta.py): in 'delta' mode the
        # client advertises its basis version (``have=<ts>``) on every
        # PULL and keeps the last successfully decoded model per wid so a
        # NOT_MODIFIED / XDELTA reply can reconstruct byte-exactly.  Any
        # decode mismatch or cache miss falls back to a full pull -- the
        # basis is only ever replaced by a CRC-validated reconstruction or
        # an authoritative full payload, never left wrong.
        if pull_mode is None:
            from asyncframework_tpu_torch.conf import PULL_MODE, global_conf

            pull_mode = str(global_conf().get(PULL_MODE))
        self.pull_mode = pull_mode
        # gradient quantization (net/wirecodec.py, async.codec.push):
        # 'off' (default) ships raw f32 -- byte-identical legacy wire;
        # fp16/int8 quantize each dense ASGD push and keep the residual
        # in a per-wid error-feedback accumulator folded into the next
        # push, so the model's deviation from the uncompressed
        # trajectory is bounded by ONE step's quantization error.
        if push_codec is None:
            from asyncframework_tpu_torch.conf import CODEC_PUSH, global_conf

            push_codec = str(global_conf().get(CODEC_PUSH))
        self.push_codec = push_codec
        self._ef: Dict[int, np.ndarray] = {}  # wid -> carried residual
        # wid -> (ts, float32 basis array, crc of its bytes)
        self._basis: Dict[int, Tuple[int, np.ndarray, int]] = {}
        self.pull_wenc: Dict[str, int] = {"full": 0, "nm": 0, "xdelta": 0}
        self.pull_model_bytes = 0  # model-part payload bytes received
        self.delta_fallbacks = 0   # decode mismatch/cache miss full re-pulls
        # distributed tracing: completed spans from this process's recorder
        # piggyback on PUSH (and BYE) headers -- the PS folds them into its
        # event stream, so spans survive this worker's death.  None =
        # tracing off for this client, zero extra wire bytes.
        self.recorder = recorder
        # pipelined-loop counters (prefetch hits / stale discards /
        # in-flight depth): deltas piggyback on PUSH and BYE headers the
        # same way spans do.  None (every non-pipelined client) = no
        # header field, byte-identical wire.
        self.pl_stats = pl_stats
        # convergence telemetry (metrics/timeseries.ConvergenceBuffer):
        # buffered (version, loss, grad_norm) samples ride PUSH/BYE
        # headers as the ``cv`` entry, same discipline as spans and
        # pipeline counters.  None (the default) = no header field,
        # byte-identical wire.
        self.cv_buf = cv_buf
        # elastic membership: the worker PROCESS token stamped on every
        # PULL/PUSH so the PS supervisor knows who serves which shard;
        # None = classic fixed-membership client
        self.proc = proc
        self.released = False    # the PS deposed this client's wid
        self._orders: List[int] = []  # adoption orders from PULL replies
        # windowed push pipe (push_start/push_finish): sent-but-unACKed
        # entries, oldest first -- replayed wholesale on reconnect.  The
        # window lock serializes senders against the reaper's
        # reconnect+replay; receives happen outside it (full duplex).
        from collections import deque as _dq
        self._push_window: "_dq[list]" = _dq()
        self._win_lock = threading.Lock()
        # the one in-flight prefetched PULL (pull_start/pull_finish)
        self._pending_pull: Optional[tuple] = None
        # shared-memory transport (net/shmring.py): when enabled AND the
        # PS is colocated (loopback peer), each (re)dial opportunistically
        # upgrades the fresh TCP connection to a ring pair -- same framed
        # protocol, fewer copies, no GIL on the byte path.  A ring-level
        # failure latches _shm_failed so the NEXT dial stays on plain
        # TCP: the degrade is one reconnect away and never loops.
        if shm is None:
            from asyncframework_tpu_torch.conf import SHM_ENABLED, global_conf

            shm = bool(global_conf().get(SHM_ENABLED))
        self.shm = bool(shm)
        self._shm_failed = False
        self._sock: Optional[socket.socket] = None
        self.bytes_pushed = 0  # payload bytes shipped by push/push_saga
        # eager first dial (historical behavior: constructing a client to a
        # dead PS raises) -- but through the policy, so a PS mid-restart is
        # ridden out instead of surfaced
        self._call_raw(connect_only=True)

    @property
    def sock(self) -> Optional[socket.socket]:
        return self._sock

    def _drop_sock(self) -> None:
        if self._sock is not None:
            if isinstance(self._sock, _shmring.ShmSocket):
                # a dropped ring transport is never resurrected blind:
                # the next dial stays on plain TCP (the upgrade is
                # opportunistic, the degrade is sticky per client --
                # reconnect-and-retry loops must converge, not oscillate
                # between a wedged ring and the socket)
                self._shm_failed = True
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _dial(self):
        """Fresh connection under this client's transport policy: the
        TCP dial, then the opportunistic shm-ring upgrade (colocated
        peer + conf gate + not previously degraded)."""
        sock = _frame.connect((self.host, self.port),
                              timeout=self.retry.attempt_timeout_s)
        if self.shm and not self._shm_failed:
            sock, _ = _shmring.maybe_upgrade(sock)
        return sock

    def _call_raw(self, header: Optional[dict] = None, payload: bytes = b"",
                  connect_only: bool = False) -> Tuple[dict, bytes]:
        """One stamped-or-not request/reply under the retry policy.  The
        header is REUSED verbatim across attempts -- a stamped op keeps its
        (sid, seq) so the server can dedup."""

        def attempt() -> Tuple[dict, bytes]:
            try:
                if self._sock is None:
                    self._sock = self._dial()
                if connect_only:
                    return {}, b""
                _send_msg(self._sock, header, payload)
                return _recv_msg(self._sock)
            except OSError:
                # dead/poisoned connection: never reuse it for the retry
                # (and _drop_sock pins a failed ring transport to TCP)
                self._drop_sock()
                raise

        return self.retry.call(attempt, endpoint=self.endpoint)

    def _proc_hdr(self, hdr: dict) -> dict:
        if self.proc is not None:
            hdr["proc"] = self.proc
        if self.epoch:
            hdr["ep"] = self.epoch
        return hdr

    def _note_fenced(self, header: dict) -> bool:
        """Fold one REJECT_FENCED verdict: adopt the minted epoch when it
        is NEWER than ours (we were deposed and can self-heal -- the next
        op, stamped fresh, will be admitted) and return True; False means
        the SERVER is the stale party (a zombie) and cannot serve us."""
        self.fenced_replies += 1
        srv_ep = int(header.get("epoch", 0))
        if srv_ep > self.epoch:
            self.epoch = srv_ep
            return True
        return False

    def _note_orders(self, header: dict) -> None:
        if "adopt" in header:
            self._orders.extend(int(w) for w in header["adopt"])
        if self.ctrl_sink is not None and "ctrl" in header:
            # adaptive-control decisions ride replies like adoption
            # orders; the sink's monotone install discards stale ones
            self.ctrl_sink.install(header["ctrl"])

    def take_orders(self) -> List[int]:
        """Adoption orders received so far (drained)."""
        out, self._orders = self._orders, []
        return out

    def hello(self, proc: str, wids: List[int],
              pid: Optional[int] = None) -> dict:
        """Introduce this worker process to the PS (elastic registration;
        a fixed-membership PS just says WELCOME and ignores it).  Carries
        this process's /proc start time next to its pid so the
        supervisor's liveness probe can tell a recycled pid from the
        registered member."""
        import socket as _socket

        hdr = {
            "op": "HELLO", "proc": proc, "wids": [int(w) for w in wids],
            "pid": pid, "host": _socket.gethostname(),
        }
        if pid is not None:
            pstart = supervisor_mod.proc_start_time(pid)
            if pstart is not None:
                hdr["pstart"] = pstart
        # advertise this process's telemetry endpoint (when one serves):
        # the supervisor records it per member and the cluster observer
        # discovers worker scrape targets from the membership instead of
        # needing static endpoints.  Absent when telemetry is off -- the
        # byte-identity suites' wire is unchanged.
        from asyncframework_tpu_torch.metrics import live as _live

        mport = _live.telemetry_port()
        if mport:
            hdr["mport"] = int(mport)
        header, _ = self._call_raw(hdr)
        return header

    def _traced_call(self, tr, stage: str, header: dict,
                     payload: bytes = b"") -> Tuple[dict, bytes]:
        """One RPC under an optional update trace: installs the ambient
        context (frame.send_msg stamps the ``tc`` header from it) for the
        call's duration and records the client-observed round-trip span.
        With ``tr=None`` this is exactly ``_call_raw``."""
        if tr is None:
            return self._call_raw(header, payload)
        token = tr.rpc_begin(stage)
        try:
            out = self._call_raw(header, payload)
        except BaseException:
            _trace.set_current(None)  # never leak the context on failure
            raise
        # wire cost of the RPC that just completed (frame bytes, both
        # directions) rides the rtt span -- latency AND volume decompose
        # per stage (net/frame.py counts at the choke point)
        tr.rpc_end(token, bytes=_frame.last_io_bytes())
        return out

    def _have_hdr(self, wid: int, hdr: dict) -> dict:
        """Advertise this wid's basis version on a PULL (delta mode),
        and the installed CTRL decision seq (``cs``) when this client
        rides a control sink -- the PS re-delivers the CTRL payload
        only while the stamp lags its newest decision."""
        if self.pull_mode == "delta":
            basis = self._basis.get(wid)
            if basis is not None:
                hdr["have"] = basis[0]
        if self.ctrl_sink is not None:
            hdr["cs"] = self.ctrl_sink.stamp
        return hdr

    def _decode_model(self, wid: int, header: dict, payload: bytes,
                      extra_len: int) -> Optional[np.ndarray]:
        """The model part of a MODEL reply -> float32 array, maintaining
        the basis cache.  ``extra_len`` is the trailing non-model payload
        (ASAGA's idx/alpha block).  Returns None on decode mismatch or
        basis cache miss -- the caller MUST fall back to a full pull; the
        basis is only ever replaced by a CRC-validated reconstruction or
        an authoritative full payload, never left wrong."""
        ts = int(header["ts"])
        wenc = header.get("wenc")
        if wenc is None or wenc == wiredelta.FULL:
            if wenc is None:  # legacy reply: model part is the payload head
                end = len(payload) - extra_len
                model_part = payload[:end] if extra_len else payload
            else:
                model_part = payload[: int(header.get("wlen", 0))]
            w = np.frombuffer(model_part, np.float32)
            if self.pull_mode == "delta":
                crc_hdr = header.get("crc")
                self._basis[wid] = (
                    ts, w,
                    int(crc_hdr) if crc_hdr is not None
                    else wiredelta.crc(model_part),
                )
            self.pull_wenc["full"] += 1
            self.pull_model_bytes += len(model_part)
            return w
        model_part = payload[: int(header.get("wlen", 0))]
        basis = self._basis.get(wid)
        crc_hdr = header.get("crc")
        w = wiredelta.decode(
            wenc, model_part, int(header.get("nnz", 0)),
            basis[1] if basis is not None else None,
            int(crc_hdr) if crc_hdr is not None else None,
            basis[2] if basis is not None else None,
        )
        if w is None:
            return None
        self._basis[wid] = (ts, w, int(crc_hdr))
        self.pull_wenc[wenc] = self.pull_wenc.get(wenc, 0) + 1
        self.pull_model_bytes += len(model_part)
        return w

    def _process_pull_reply(self, wid: int, header: dict, payload: bytes,
                            make_hdr, extra_len_of, tr
                            ) -> Optional[Tuple[dict, bytes, np.ndarray]]:
        """Shared back half of a model pull: RELEASED/DONE handling,
        REJECT_FENCED self-healing, adoption orders, and decode with the
        ONE-full-re-pull fallback (basis cache miss, CRC disagreement --
        a full reply always decodes; never a wrong model).  Returns
        (header, payload, w), or None on RELEASED/DONE (``self.released``
        distinguishes them)."""
        fence_left = True
        fallback_left = True
        while True:
            op = header["op"]
            if op == "RELEASED":
                self.released = True
                return None
            if op == "DONE":
                return None
            if op == "ERR":
                # a refusing endpoint (a hot STANDBY answers the
                # training plane this way): surface as a dead endpoint
                # so loops pace and sharded facades re-resolve the map
                raise ConnectionError(
                    f"{self.endpoint} refused: {header.get('msg')!r}")
            if op == "REJECT_FENCED":
                # deposed basis: adopt the minted epoch and re-pull ONCE
                # with the fresh stamp (the current owner admits it); a
                # second fence, or a server whose epoch does not exceed
                # ours, is a zombie endpoint -- surface it
                if self._note_fenced(header) and fence_left:
                    fence_left = False
                    header, payload = self._traced_call(
                        tr, _trace.PULL_RTT,
                        self._proc_hdr(self._have_hdr(wid, make_hdr())),
                    )
                    continue
                raise FencedError(
                    f"fenced by {self.endpoint} at epoch "
                    f"{int(header.get('epoch', 0))} (client epoch "
                    f"{self.epoch})"
                )
            srv_ep = header.get("ep")
            if srv_ep is not None and int(srv_ep) > self.epoch:
                # replies advertise the server's current epoch: track it
                # so our next op is stamped current without a fence trip
                self.epoch = int(srv_ep)
            self._note_orders(header)
            w = self._decode_model(wid, header, payload,
                                   extra_len_of(header))
            if w is not None:
                return header, payload, w
            if not fallback_left:  # pragma: no cover - full always decodes
                break
            fallback_left = False
            self._basis.pop(wid, None)
            self.delta_fallbacks += 1
            header, payload = self._traced_call(
                tr, _trace.PULL_RTT, self._proc_hdr(make_hdr())
            )
        raise ConnectionError("PULL: full reply failed to decode")

    def _pull_model_rpc(self, wid: int, make_hdr, extra_len_of, tr
                        ) -> Optional[Tuple[dict, bytes, np.ndarray]]:
        """One negotiated model pull (request + reply + fallback)."""
        header, payload = self._traced_call(
            tr, _trace.PULL_RTT,
            self._proc_hdr(self._have_hdr(wid, make_hdr())),
        )
        return self._process_pull_reply(wid, header, payload, make_hdr,
                                        extra_len_of, tr)

    # ---------------------------------------------------- prefetched pull
    # The pipelined loop's pull prefetch: pull_start SENDS the next
    # PULL and returns (the request parks in the PS wave gate and the
    # reply accumulates in this socket's kernel buffer while the caller
    # computes); pull_finish receives and decodes it.  Single-threaded
    # by design -- the overlap lives in the socket, not in a thread --
    # and safe to retry: a PULL is idempotent and unstamped, so a
    # reconnect simply re-sends it.

    def pull_start(self, wid: int, tr=None) -> None:
        """Send the next PULL without waiting for the reply."""
        hdr = self._proc_hdr(self._have_hdr(wid, {"op": "PULL",
                                                  "wid": wid}))
        token = tr.rpc_begin(_trace.PULL_RTT) if tr is not None else None
        if tr is not None:
            _trace.set_current(None)
        # trailing slot: sent frame bytes, captured at send (see the
        # push-window entries)
        pending = [hdr, tr, token, 0]
        self._pending_pull = pending
        try:
            if self._sock is None:
                self._sock = self._dial()
            if tr is not None:
                _trace.set_current(tr.ctx)
            try:
                _send_msg(self._sock, hdr)
                pending[3] = _frame.last_sent_bytes()
            finally:
                if tr is not None:
                    _trace.set_current(None)
        except OSError:
            self._drop_sock()  # deferred: pull_finish re-dials + re-sends

    def pull_ready(self) -> bool:
        """True when the prefetched reply's first bytes are already in
        the kernel buffer (the prefetch fully hid the pull)."""
        if self._sock is None:
            return False
        if isinstance(self._sock, _shmring.ShmSocket):
            # ring bytes never show on the retained TCP fd; ask the
            # ring's counters instead (same zero-wait semantics)
            return self._sock.readable()
        import select

        try:
            return bool(select.select([self._sock], [], [], 0.0)[0])
        except (OSError, ValueError):
            return False

    def pull_finish(self, wid: int
                    ) -> Optional[Tuple[int, np.ndarray, float, bool]]:
        """Receive the prefetched PULL's reply; same returns as
        :meth:`pull`.  A dead connection re-dials and re-sends the
        pending request under the retry policy."""
        pending = self._pending_pull
        if pending is None:
            raise RuntimeError("pull_finish without pull_start")
        hdr, tr, token = pending[0], pending[1], pending[2]

        def attempt() -> Tuple[dict, bytes]:
            try:
                if self._sock is None:
                    self._sock = self._dial()
                    if tr is not None:
                        _trace.set_current(tr.ctx)
                    try:
                        _send_msg(self._sock, hdr)
                        pending[3] = _frame.last_sent_bytes()
                    finally:
                        if tr is not None:
                            _trace.set_current(None)
                return _recv_msg(self._sock)
            except OSError:
                self._drop_sock()
                raise

        try:
            header, payload = self.retry.call(attempt,
                                              endpoint=self.endpoint)
        finally:
            self._pending_pull = None
        if tr is not None and token is not None:
            tr.rpc_end(token,
                       bytes=pending[3] + _frame.last_recv_bytes())
        got = self._process_pull_reply(
            wid, header, payload,
            lambda: {"op": "PULL", "wid": wid}, lambda _h: 0, tr,
        )
        if got is None:
            return None
        header, _payload, w = got
        if tr is not None:
            tr.set_model_version(int(header["ts"]))
        return (int(header["ts"]), w, float(header["avg_delay_ms"]),
                bool(header["calibrated"]))

    def pull(self, wid: int, tr=None
             ) -> Optional[Tuple[int, np.ndarray, float, bool]]:
        """Returns (ts, w, avg_delay_ms, calibrated); None when DONE or
        when this client's wid was RELEASED (check ``self.released``).
        ``tr`` (an UpdateTrace) records this pull's round trip as a
        pull.rtt span and propagates the trace context on the wire.

        In ``delta`` pull mode the request advertises the cached basis
        version (``have``) and the reply may be NOT_MODIFIED (zero model
        payload) or a byte-exact XOR delta; a decode mismatch or basis
        cache miss re-pulls FULL -- never a wrong model."""
        got = self._pull_model_rpc(
            wid, lambda: {"op": "PULL", "wid": wid}, lambda _h: 0, tr
        )
        if got is None:
            return None
        header, _payload, w = got
        if tr is not None:
            tr.set_model_version(int(header["ts"]))
        return (int(header["ts"]), w, float(header["avg_delay_ms"]),
                bool(header["calibrated"]))

    def subscribe(self, wid: int = 0, extra: Optional[dict] = None
                  ) -> Optional[Tuple[int, np.ndarray, int, int,
                                      float, bool]]:
        """Serving-tier snapshot subscription: one ``have=``-negotiated
        SUBSCRIBE round trip (NOT_MODIFIED / XDELTA / FULL, CRC-gated,
        full-pull fallback -- the same basis-cache machinery as delta
        PULLs, keyed by ``wid``; replicas pass their replica id).

        Returns ``(ts, w, clock, k, age_ms, done)``: the served version
        and model, the PS merge clock and accepted-update count at reply
        time, the served version's freshness age in ms (0 while it is
        still the current model), and whether training has finished.
        Unlike :meth:`pull` this never parks in the wave gate and keeps
        working after DONE.  ``extra`` merges additional header fields
        into every attempt (a relaycast node advertises its relay port as
        ``rport``)."""
        def mk() -> dict:
            hdr = {"op": "SUBSCRIBE", "wid": wid}
            if extra:
                hdr.update(extra)
            return hdr

        got = self._pull_model_rpc(wid, mk, lambda _h: 0, None)
        if got is None:
            return None  # RELEASED/DONE headers never come from SUBSCRIBE
        header, _payload, w = got
        ts = int(header["ts"])
        return (ts, w, int(header.get("clock", ts)),
                int(header.get("k", 0)),
                float(header.get("age_ms", 0.0)),
                bool(header.get("done", False)))

    @staticmethod
    def _sparse_grad_enc(g: np.ndarray) -> Optional[Tuple[int, bytes]]:
        """(idx u32, val f32) pair encoding when it beats the dense d*4
        bytes (rcv1-class gradients touch only the sampled rows' columns);
        None when dense is smaller."""
        (nz,) = np.nonzero(g)
        if nz.size * 8 >= g.shape[0] * 4:
            return None
        return nz.size, (nz.astype(np.uint32).tobytes()
                         + g[nz].astype(np.float32).tobytes())

    def _encode_push(self, wid: int, ts: int, g: np.ndarray,
                     sparse: bool, diff: Optional[np.ndarray], tr
                     ) -> Tuple[dict, bytes, List[dict], dict, List[list]]:
        """Shared encode/stamp front half of :meth:`push` and
        :meth:`push_start`: returns ``(header, payload, spans, pl_delta,
        cv_wire)`` with the piggybacks already attached to the header."""
        t_enc0 = _trace.now_ms() if tr is not None else 0.0
        g = np.asarray(g, np.float32)
        # ASAGA pushes ride their own verb so fault schedules can tell the
        # two solvers' streams apart (the PS treats both identically)
        op = "PUSH_SAGA" if diff is not None else "PUSH"
        enc = self._sparse_grad_enc(g) if sparse else None
        if enc is not None:
            nnz, payload = enc
            hdr = {"op": op, "wid": wid, "ts": ts,
                   "enc": "sparse", "nnz": nnz}
        else:
            hdr, payload = {"op": op, "wid": wid, "ts": ts}, None
            if diff is None and self.push_codec != wirecodec.OFF:
                # quantize with error feedback (dense ASGD only: sparse
                # already beat dense above, and ASAGA's history scalars
                # must be exact).  encode_grad returns None for any
                # input it cannot encode safely (non-finite, fp16
                # overflow) -- that push ships raw and the residual
                # simply rides to the next quantized one.
                q = wirecodec.encode_grad(g, self.push_codec,
                                          self._ef.get(wid))
                if q is not None:
                    qhdr, payload, new_err = q
                    self._ef[wid] = new_err
                    hdr.update(qhdr)
            if payload is None:
                payload = g.tobytes()
        if diff is not None:
            payload += np.asarray(diff, np.float32).tobytes()
        self.bytes_pushed += len(payload)
        if tr is not None:
            tr.add(_trace.PUSH_WAIT, t_enc0, _trace.now_ms())
        spans: List[dict] = []
        if self.recorder is not None:
            # the PUSH piggyback: completed spans (a previous traced
            # update's push.rtt, this one's pull.rtt/compute/push.wait)
            # ship in the header -- one drain per logical push; retries
            # re-send the same header, and the PS dedup window keeps a
            # re-applied push from double-folding them
            spans = self.recorder.drain_wire()
            if spans:
                hdr["spans"] = spans
        pl_delta: dict = {}
        if self.pl_stats is not None:
            # pipeline-counter piggyback, same discipline as spans: ship
            # the unshipped delta; the PS folds it once (dedup'd retries
            # never reach the handler)
            pl_delta = self.pl_stats.take_wire()
            if pl_delta:
                hdr["pl"] = pl_delta
        cv_wire: List[list] = []
        if self.cv_buf is not None:
            # convergence-sample piggyback: drain the unshipped tail (a
            # bounded slice; the rest rides later pushes)
            cv_wire = self.cv_buf.take_wire()
            if cv_wire:
                hdr["cv"] = cv_wire
        return hdr, payload, spans, pl_delta, cv_wire

    def _requeue_piggybacks(self, spans: List[dict], pl_delta: dict,
                            cv_wire: Optional[List[list]] = None) -> None:
        """A push whose whole retry budget was spent must not silently eat
        its piggybacked telemetry: spans, counter deltas, and convergence
        samples go back to ride the next push/BYE."""
        if spans and self.recorder is not None:
            self.recorder.requeue(spans)
        if pl_delta and self.pl_stats is not None:
            self.pl_stats.merge_back(pl_delta)
        if cv_wire and self.cv_buf is not None:
            self.cv_buf.merge_back(cv_wire)

    def push(self, wid: int, ts: int, g: np.ndarray,
             sparse: bool = False, diff: Optional[np.ndarray] = None,
             tr=None) -> Tuple[bool, bool]:
        """Returns (accepted, run_done).  ``diff`` (ASAGA candidate history
        scalars) rides after the gradient when given.  ``tr`` records this
        push's encode time (push.wait) and round trip (push.rtt); any
        completed spans in the client's recorder piggyback on the header
        either way."""
        hdr, payload, spans, pl_delta, cv_wire = self._encode_push(
            wid, ts, g, sparse, diff, tr
        )
        # stamp ONCE: retries re-send the same (sid, seq), so a push whose
        # ACK was lost is answered from the PS dedup window, not re-applied
        try:
            header, _ = self._traced_call(
                tr, _trace.PUSH_RTT,
                self.session.stamp(self._proc_hdr(hdr)), payload,
            )
        except BaseException:
            self._requeue_piggybacks(spans, pl_delta, cv_wire)
            raise
        if header.get("op") == "REJECT_FENCED":
            # this gradient was computed under a deposed epoch: it is
            # DROPPED (the same loss as a taw rejection), and with the
            # adopted epoch the next round is admitted
            if self._note_fenced(header):
                return False, False
            raise FencedError(
                f"push fenced by zombie {self.endpoint} (epoch "
                f"{int(header.get('epoch', 0))} <= ours {self.epoch})"
            )
        if header.get("op") == "ERR":
            # a refusing endpoint (standby / malformed push): dead-
            # endpoint semantics, same as the pull path
            raise ConnectionError(
                f"push refused by {self.endpoint}: "
                f"{header.get('msg')!r}")
        if header.get("released"):
            self.released = True
        return bool(header.get("accepted")), bool(header.get("done"))

    # ------------------------------------------------- windowed push pipe
    # The pipelined sender's wire window: push k+1 goes OUT before push
    # k's ACK returns, so per-update push cost drops from a full RTT to
    # the send itself.  The server already supports this shape -- its
    # per-connection loop handles frames in order and replies in order --
    # so ACKs pair with pushes FIFO.  Exactly-once survives every fault:
    # each entry is stamped once, and on any connection error the whole
    # unacked window is REPLAYED on the fresh socket (the PS dedup window
    # re-ACKs already-applied entries instead of re-merging them).  These
    # concurrency contract: any number of calls from ONE sending thread
    # (push_start) plus ONE reaping thread (push_finish/push_abandon);
    # the window lock serializes sends and reconnect/replay, receives
    # run outside it (TCP full duplex).

    def push_start(self, wid: int, ts: int, g: np.ndarray,
                   sparse: bool = False,
                   diff: Optional[np.ndarray] = None, tr=None) -> None:
        """Encode, stamp, window, and SEND one push without waiting for
        its ACK.  A send error (or an already-dead socket) is deferred:
        the entry stays in the window and :meth:`push_finish`'s
        reconnect replays it."""
        hdr, payload, spans, pl_delta, cv_wire = self._encode_push(
            wid, ts, g, sparse, diff, tr
        )
        token = tr.rpc_begin(_trace.PUSH_RTT) if tr is not None else None
        if tr is not None:
            _trace.set_current(None)  # _send_entry scopes the context
        # trailing slot: this entry's sent frame bytes (captured at send,
        # so the rtt span's `bytes` pairs OUR send with OUR reply even
        # though the single-threaded loop interleaves other frames)
        entry = [self.session.stamp(self._proc_hdr(hdr)), payload, tr,
                 token, spans, pl_delta, cv_wire, 0]
        with self._win_lock:
            self._push_window.append(entry)
            if self._sock is not None:
                try:
                    self._send_entry(entry)
                except OSError:
                    self._drop_sock()  # reaper reconnects and replays

    def _send_entry(self, entry) -> None:
        hdr, payload, tr = entry[0], entry[1], entry[2]
        if tr is not None:
            _trace.set_current(tr.ctx)  # the tc header for THIS push
        try:
            _send_msg(self._sock, hdr, payload)
            entry[7] = _frame.last_sent_bytes()
        finally:
            if tr is not None:
                _trace.set_current(None)

    def _replay_window(self) -> None:
        """Re-send every unacked push on the (fresh) socket, oldest
        first, same stamps: applied-but-unACKed entries are answered from
        the PS dedup window, lost ones are applied now -- FIFO ACK
        pairing is preserved either way."""
        for entry in self._push_window:
            self._send_entry(entry)

    def inflight_pushes(self) -> int:
        return len(self._push_window)

    def push_finish(self) -> Tuple[bool, bool]:
        """Receive the OLDEST in-flight push's ACK (FIFO), under the
        retry policy: a dead connection is re-dialed and the unacked
        window replayed before the next receive attempt.  Returns
        (accepted, run_done)."""

        def attempt() -> Tuple[dict, bytes]:
            try:
                with self._win_lock:
                    sock = self._sock
                    if sock is None:
                        sock = self._sock = self._dial()
                        self._replay_window()
                # recv OUTSIDE the window lock: the sender keeps sending
                # while this blocks (full duplex)
                return _recv_msg(sock)
            except OSError:
                self._drop_sock()
                raise

        header, _ = self.retry.call(attempt, endpoint=self.endpoint)
        entry = self._push_window.popleft()
        _hdr, _payload, tr, token, _spans, _pl, _cv, sent_bytes = entry
        if tr is not None and token is not None:
            tr.rpc_end(token,
                       bytes=sent_bytes + _frame.last_recv_bytes())
        if header.get("op") == "REJECT_FENCED":
            # a windowed entry stamped under a deposed epoch (typically a
            # replay onto a fenced range's replacement): dropped, epoch
            # adopted -- later push_start calls stamp the current epoch.
            # Judge against THIS ENTRY'S stamp, not self.epoch: with >= 2
            # stale entries in flight, the first fence already advanced
            # self.epoch, and comparing the second reply against the
            # advanced value would misread the healthy replacement as a
            # zombie (each stale entry is rejected exactly once, that is
            # the design -- only a server whose epoch does not exceed
            # what WE stamped on the op is actually stale itself).
            self.fenced_replies += 1
            srv_ep = int(header.get("epoch", 0))
            if srv_ep > self.epoch:
                self.epoch = srv_ep
            if srv_ep > int(_hdr.get("ep", 0) or 0):
                return False, False
            raise FencedError(
                f"push fenced by zombie {self.endpoint} (epoch "
                f"{srv_ep} <= op stamp {_hdr.get('ep')})"
            )
        if header.get("op") == "ERR":
            raise ConnectionError(
                f"windowed push refused by {self.endpoint}: "
                f"{header.get('msg')!r}")
        if header.get("released"):
            self.released = True
        return bool(header.get("accepted")), bool(header.get("done"))

    def push_abandon(self) -> int:
        """Drop every in-flight push (the window's whole retry budget is
        spent -- the serial loop's error path loses its round the same
        way), requeueing piggybacked telemetry.  Returns the number of
        pushes abandoned."""
        with self._win_lock:
            n = len(self._push_window)
            while self._push_window:
                entry = self._push_window.popleft()
                self._requeue_piggybacks(entry[4], entry[5], entry[6])
            self._drop_sock()
        return n

    def pull_saga(self, wid: int, n_p: int, tr=None) -> Optional[
        Tuple[int, np.ndarray, np.ndarray, np.ndarray, int, float, bool]
    ]:
        """ASAGA pull: the PS samples this worker's rows and ships their
        current history scalars with the model (the reference's sampledMap).
        Returns (ts, w, idx, alpha_sel, n_valid, avg_delay_ms, calibrated)
        or None when DONE."""
        got = self._pull_model_rpc(
            wid, lambda: {"op": "PULL_SAGA", "wid": wid, "n_p": n_p},
            lambda h: 8 * int(h["cap"]), tr,
        )
        if got is None:
            return None
        header, payload, w = got
        if tr is not None:
            tr.set_model_version(int(header["ts"]))
        # the ASAGA extra block (idx, alpha) always rides AFTER the model
        # part, whatever its encoding; its offset is the payload tail
        cap = int(header["cap"])
        tail = len(payload) - 8 * cap
        idx = np.frombuffer(payload[tail: tail + 4 * cap], np.uint32)
        alpha_sel = np.frombuffer(payload[tail + 4 * cap:], np.float32)
        return (int(header["ts"]), w, idx, alpha_sel, int(header["n_valid"]),
                float(header["avg_delay_ms"]), bool(header["calibrated"]))

    def push_saga(self, wid: int, ts: int, g: np.ndarray, diff: np.ndarray,
                  sparse: bool = False, tr=None) -> Tuple[bool, bool]:
        """ASAGA push: gradient + candidate history scalars for the sampled
        rows (committed by the PS only on accept).  Returns (accepted, done).
        """
        return self.push(wid, ts, g, sparse=sparse, diff=diff, tr=tr)

    def snapshots(self) -> Tuple[List[float], np.ndarray]:
        header, payload = self._call_raw({"op": "SNAPSHOTS"})
        W = np.frombuffer(payload, np.float32).reshape(header["shape"])
        return list(header["times"]), W

    def send_eval(self, wid: int, losses: np.ndarray) -> None:
        self._call_raw(self.session.stamp({"op": "EVAL_RESULT", "wid": wid}),
                       np.asarray(losses, np.float64).tobytes())

    def bye(self) -> None:
        try:
            if self._pending_pull is not None:
                # a prefetched PULL is still parked in the PS wave gate:
                # its MODEL reply would arrive (possibly after a ~1 s
                # starvation-fallback wait) ahead of any BYE ACK.  Just
                # drop the connection -- the PS treats EOF as goodbye,
                # and this client's telemetry rides its sibling push
                # connection's BYE.
                self._drop_sock()
                return
            if self._sock is not None:
                hdr: dict = {"op": "BYE"}
                if self.recorder is not None:
                    # last drain: the final traced update's push.rtt has no
                    # later PUSH to ride, so it leaves with the goodbye
                    spans = self.recorder.drain_wire()
                    if spans:
                        hdr["spans"] = spans
                if self.pl_stats is not None:
                    pl_delta = self.pl_stats.take_wire()
                    if pl_delta:
                        hdr["pl"] = pl_delta
                if self.cv_buf is not None:
                    # the final unshipped convergence samples leave with
                    # the goodbye, like the last traced update's spans
                    cv_wire = self.cv_buf.take_wire()
                    if cv_wire:
                        hdr["cv"] = cv_wire
                _send_msg(self._sock, hdr)
                _recv_msg(self._sock)
        except (ConnectionError, OSError):
            pass
        self._drop_sock()


def run_worker_process(
    host: str,
    port: int,
    wids: List[int],
    shards: Dict[int, object],
    cfg,
    d: int,
    n: int,
    eval_wid: Optional[int] = None,
    deadline_s: float = 600.0,
    algo: str = "asgd",
    shard_factory=None,
    proc_token: Optional[str] = None,
    devices=None,
) -> Dict[int, int]:
    """Worker-process main loop: one thread per owned logical worker, each
    pulling models and pushing gradients until the PS says DONE.

    ``shards``: wid -> ``Shard`` / ``SparseShard`` (on this process's
    device: ``cuda`` or, asked for, the CPU).  Returns per-wid gradient
    counts.  When ``eval_wid`` is set, after DONE this process scores the
    PS's snapshot stack over ALL its shards and pushes one EVAL_RESULT (the
    distributed optVars evaluation).

    ``algo="asaga"``: the PS samples and ships (idx, alpha) with each model
    (it owns the history table); the worker runs the history-corrected
    gradient step (one launch of B1's or S1's per-slot form) and pushes
    candidate scalars back with the gradient.  ASGD draws each worker's
    sample from a ``torch.Generator`` seeded from ``(cfg.seed, wid)`` and
    takes one launch of B1's or S1's compacted form.

    Elastic plane (``parallel/supervisor.py``): this process HELLOs the PS
    with ``proc_token`` + its wids + pid, and every PULL/PUSH carries the
    token.  When the PS's supervisor re-homes a dead peer's shard here, the
    adoption order arrives on a PULL reply; ``shard_factory(wid)`` builds
    the orphan shard locally and a fresh loop thread starts serving it.  A
    thread whose wid is reclaimed by a rejoining process is told RELEASED
    and stands down.  With ``shard_factory=None`` adoption orders are
    ignored.

    Pipelining (``async.pipeline.depth``): depth 0
    runs the classic serial loop; depth >= 1 runs the pipelined loop --
    prefetched pulls on a second connection, a bounded in-flight push
    sender, and the host<->device transfers staged on a side stream.
    ASAGA always runs serial (PS-side sampling requires pull->push
    alternation).

    Mesh plane (``async.mesh.devices``, or ``cfg.mesh_devices`` when set):
    N >= 2 builds a ``dp`` mesh over the first N of ``devices`` (this
    process's device list: default every CUDA device; the tests pass
    ``[cpu] * 8``, a card run ``[cuda:0] * 4``), clamped to its length
    (logged).  Each wid's shard is placed on it once (ranks on the shard's
    own device hold views), the pulled model lies on the first rank's
    device and every rank reads it there, and each gradient is the mesh
    step's: one B1 launch a rank, the partials folded in rank order, one
    PUSH.  Both loops run it.  Fewer than 2 ranks after the clamp, or
    sparse shards, log and run the single-device step.
    """
    import logging

    from asyncframework_tpu_torch.engine.straggler import DelayModel
    from asyncframework_tpu_torch.ops import steps
    from asyncframework_tpu_torch.ops.sampling import worker_generator

    from asyncframework_tpu_torch.conf import (
        CONV_SAMPLE,
        MESH_DEVICES,
        PIPELINE_DEPTH,
        global_conf,
    )

    proc_token = proc_token or f"{socket.gethostname()}-{os.getpid()}"
    # distributed tracing (metrics/trace.py): one sampling recorder + span
    # ring per worker process, shared by its loop threads.  With
    # async.trace.sample = 0 the recorder is None and the hot path does no
    # tracing work at all (and frames stay byte-identical).
    _rec = _trace.TraceRecorder()
    recorder = _rec if _rec.enabled else None
    sparse = any(hasattr(s, "cols") for s in shards.values())
    if algo == "asaga":
        step = (steps.make_saga_dcn_sparse_worker_step(d) if sparse
                else steps.make_saga_dcn_worker_step())
    else:
        step = (steps.make_sparse_asgd_worker_step(cfg.batch_rate, d)
                if sparse
                else steps.make_asgd_worker_step(cfg.batch_rate, cfg.loss))
    delay_model = DelayModel(cfg.coeff, cfg.num_workers, cfg.seed)
    counts = {wid: 0 for wid in wids}
    stop = threading.Event()
    calibrated_once = threading.Event()
    # pipelined update loop (async.pipeline.depth): 0 = the classic
    # serial pull -> compute -> push loop; >= 1 = prefetched pulls on a
    # second connection + a bounded in-flight push sender (at most
    # `depth` unacked pushes)
    pipe_depth = getattr(cfg, "pipeline_depth", None)
    if pipe_depth is None:
        pipe_depth = global_conf().get(PIPELINE_DEPTH)
    pipe_depth = max(0, int(pipe_depth))
    if algo == "asaga":
        # the PS samples per pull and holds ONE pending (idx, alpha) slot
        # per wid: a prefetched pull would clobber the slot the in-flight
        # push must commit against
        pipe_depth = 0
    pl_stats = _PipelineStats() if pipe_depth > 0 else None
    # the mesh plane: 0 = the single-device step above, byte- and step-
    # identical; >= 2 = the mesh step over this process's devices
    mesh_devices = getattr(cfg, "mesh_devices", None)
    if mesh_devices is None:
        mesh_devices = global_conf().get(MESH_DEVICES)
    mesh_devices = max(0, int(mesh_devices))
    worker_mesh = None
    mesh_step = None
    if mesh_devices:
        mlog = logging.getLogger(__name__)
        if sparse:
            mlog.warning("async.mesh.devices=%d ignored: sparse (padded-ELL) "
                         "shards run the single-device step", mesh_devices)
        else:
            from asyncframework_tpu_torch.parallel.mesh import make_mesh

            # make_mesh owns the clamp and its warning
            mesh = make_mesh(mesh_devices, devices=devices, clamp=True)
            if mesh.size < 2:
                mlog.warning("async.mesh.devices=%d yields a %d-rank mesh; "
                             "running the single-device step", mesh_devices,
                             mesh.size)
            else:
                worker_mesh = mesh
                mesh_step = (steps.make_mesh_saga_dcn_worker_step(mesh)
                             if algo == "asaga"
                             else steps.make_mesh_asgd_worker_step(
                                 cfg.batch_rate, mesh, cfg.loss))
                with _mesh_lock:
                    _mesh_counts_by_key["ranks"] = max(
                        _mesh_counts_by_key.get("ranks", 0), mesh.size)
    # one placement a wid, kept for the run; built lazily under its own
    # lock so adopted shards place too
    mesh_lock = threading.Lock()
    mesh_placed: Dict[int, tuple] = {}

    def mesh_place(wid: int, shard):
        """This wid's rows over the worker mesh (None: no mesh)."""
        if worker_mesh is None:
            return None
        with mesh_lock:
            got = mesh_placed.get(wid)
        if got is not None:
            return got
        from asyncframework_tpu_torch.parallel.mesh import pad_and_shard

        Xs, ys, vs, _n = pad_and_shard(worker_mesh, shard.X, shard.y)
        with mesh_lock:
            if wid not in mesh_placed:
                _mesh_bump("placements")
            return mesh_placed.setdefault(wid, (Xs, ys, vs))

    def model_dev(shard, placed):
        """Where the pulled model goes: the first rank's device on the
        mesh, the shard's otherwise."""
        return worker_mesh.devices[0] if placed is not None \
            else shard_dev(shard)

    # convergence telemetry (async.convergence.sample): every Nth update
    # per logical worker
    # evaluates the shard's mean loss (one extra evaluation against the
    # model the gradient was computed on: dense, one product; padded ELL,
    # one launch of S1's residual) plus the gradient norm, and buffers the
    # (version, loss, grad_norm) sample for the next PUSH header's ``cv``
    # entry -- the PS folds them into the process-global
    # loss-vs-wallclock / loss-vs-version curves (metrics/timeseries.py).
    # 0 = off: no eval, no header field, byte-identical wire.
    conv_every = getattr(cfg, "conv_sample", None)
    if conv_every is None:
        conv_every = global_conf().get(CONV_SAMPLE)
    conv_every = max(0, int(conv_every))
    cv_buf = None
    conv_eval = None
    if conv_every > 0:
        from asyncframework_tpu_torch.metrics.timeseries import (
            ConvergenceBuffer,
        )

        cv_buf = ConvergenceBuffer()
        conv_eval = (steps.make_sparse_trajectory_loss_eval() if sparse
                     else steps.make_trajectory_loss_eval(
                         getattr(cfg, "loss", "least_squares")))

    def conv_sample(shard, w_dev, ts, g_host: np.ndarray) -> None:
        """One convergence sample: shard mean loss at the pulled model +
        gradient norm, buffered for the PUSH piggyback and counted.  A
        failed evaluation raises like a failed gradient step: a sample is
        never dropped without a word."""
        global _cv_taken
        # on the shard's own device (a mesh worker's model lies on the
        # first rank's)
        sums = conv_eval(*shard_args(shard),
                         w_dev.to(shard_dev(shard))[None, :])
        loss = float(sums[0]) / max(1, int(shard.y.shape[0]))
        # against a sharded PS group ``ts`` is the version VECTOR: the
        # sample is stamped with the primary's component (its clock
        # drives the convergence curves)
        ver = int(ts[0]) if isinstance(ts, (tuple, list)) else int(ts)
        cv_buf.add(ver, loss, float(np.linalg.norm(g_host)))
        with _cv_lock:
            _cv_taken += 1

    # sharded PS group (parallel/shardgroup.py): resolved from the HELLO
    # WELCOME below.  None = the classic single PS -- every client below
    # is a stock PSClient and the wire is byte-identical.  The WELCOME
    # also seeds the fencing epochs (async.fence.enabled on the servers;
    # absent = 0 = legacy, clients stamp nothing).
    smap = None
    smap_epochs: Optional[List[int]] = None
    ps_epoch = 0
    # adaptive control plane: built from the WELCOME's CTRL payload when
    # the PS runs a controller (async.control.enabled); every client of
    # this process shares it, and the pipelined loops read the live
    # depth target off it each iteration.  None = control off -- no
    # ``cs`` stamps, byte-identical wire.
    ctrl_sink = None

    def make_client(recorder=None, pl_stats=None, cv_buf=None):
        """One PS-facing client: a ShardedPSClient fan-out facade when
        the HELLO resolved a shard map, the classic PSClient otherwise.
        Same surface either way -- the loops below cannot tell."""
        if smap is not None:
            from asyncframework_tpu_torch.parallel.shardgroup import (
                ShardedPSClient,
            )

            return ShardedPSClient(
                smap, proc=proc_token, recorder=recorder,
                pull_mode=getattr(cfg, "pull_mode", None),
                pl_stats=pl_stats, cv_buf=cv_buf, epochs=smap_epochs,
                ctrl_sink=ctrl_sink)
        return PSClient(host, port, proc=proc_token, recorder=recorder,
                        pull_mode=getattr(cfg, "pull_mode", None),
                        pl_stats=pl_stats, cv_buf=cv_buf, epoch=ps_epoch,
                        push_codec=getattr(cfg, "push_codec", None),
                        ctrl_sink=ctrl_sink)

    # elastic adoption bookkeeping: which wids this process serves (own +
    # adopted), and every loop thread ever started (joined at the end)
    group_lock = threading.Lock()
    active_wids = set(wids)
    threads: List[threading.Thread] = []

    def shard_dev(shard):
        return (shard.cols if sparse else shard.X).device

    def shard_args(shard):
        return ((shard.cols, shard.vals, shard.y) if sparse
                else (shard.X, shard.y))

    def put_model(w_host, dev):
        return torch.tensor(np.asarray(w_host, np.float32), device=dev)

    def saga_step(shard, w_dev, idx, alpha_sel, n_valid, placed=None):
        dev = w_dev.device
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(dev)
        alpha_t = torch.from_numpy(np.array(alpha_sel, np.float32)).to(dev)
        if placed is not None:
            _mesh_bump("steps")
            return mesh_step(placed[0], placed[1], w_dev, idx_t, alpha_t,
                             int(n_valid))
        return step(*shard_args(shard), w_dev, idx_t, alpha_t, int(n_valid))

    def asgd_step(shard, w_dev, gen, placed=None):
        if placed is not None:
            _mesh_bump("steps")
            return mesh_step(*placed, w_dev, gen)
        return step(*shard_args(shard), w_dev, gen)

    # warm every owned shard's step BEFORE the first pull (first-iteration-
    # blocking parity): on a card the first launch builds the kernel, and
    # build skew across worker threads would let fast workers drive the run
    # to done while slow ones are still compiling.  The warm-up draws from
    # a generator of its own, never a worker's.
    warmed = set()
    for wid in wids:
        shard = shards[wid]
        placed = mesh_place(wid, shard)  # once a wid, kept for the run
        dev = model_dev(shard, placed)
        n_p = int(shard.y.shape[0])
        wkey = (tuple((shard.cols if sparse else shard.X).shape),
                "mesh" if placed is not None else dev)
        if wkey in warmed:
            continue
        warmed.add(wkey)
        w0 = torch.zeros(d, dtype=torch.float32, device=dev)
        if algo == "asaga":
            cap = steps.sparse_step_capacity(cfg.batch_rate, n_p)
            saga_step(shard, w0, np.zeros(cap, np.int64),
                      np.zeros(cap, np.float32), 0, placed)
        else:
            asgd_step(shard, w0, worker_generator(0, wid, dev), placed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def adopt(orphan: int) -> None:
        """Adoption order from the PS: materialize the dead peer's shard
        locally and start serving it (idempotent -- orders are re-delivered
        until the first pull for the orphan lands)."""
        with group_lock:
            if orphan in active_wids:
                return
            active_wids.add(orphan)
        try:
            built = shard_factory(orphan)  # device placement: off the lock
        except Exception:
            with group_lock:
                active_wids.discard(orphan)
            return
        with group_lock:
            # shared-dict writes under the lock: the end-of-run eval reads
            # `shards` under it too
            shards[orphan] = built
            counts.setdefault(orphan, 0)
        spawn(orphan)

    def worker_loop(wid: int) -> None:
        shard = shards[wid]
        placed = mesh_place(wid, shard)  # None = single-device step
        dev = model_dev(shard, placed)
        gen = (worker_generator(cfg.seed, wid, dev) if algo != "asaga"
               else None)  # ASAGA samples PS-side
        deadline = time.monotonic() + deadline_s
        cl: Optional[PSClient] = None
        try:
            while not stop.is_set() and time.monotonic() < deadline:
                try:
                    if cl is None:
                        cl = make_client(recorder=recorder, cv_buf=cv_buf)
                    tr = (recorder.start_update(wid)
                          if recorder is not None else None)
                    # per-RPC transport faults are the client's RetryPolicy's
                    # problem; PUSH retries are exactly-once-applied via the
                    # PS dedup window
                    if algo == "asaga":
                        got = cl.pull_saga(wid, int(shard.y.shape[0]),
                                           tr=tr)
                    else:
                        got = cl.pull(wid, tr=tr)
                    if got is None:
                        break  # DONE, or this wid was RELEASED to a rejoiner
                    if shard_factory is not None:
                        for orphan in cl.take_orders():
                            adopt(orphan)
                    if algo == "asaga":
                        (ts, w_host, idx, alpha_sel, n_valid, avg_ms,
                         calibrated) = got
                    else:
                        ts, w_host, avg_ms, calibrated = got
                    if calibrated and not calibrated_once.is_set():
                        delay_model.calibrate(avg_ms)
                        calibrated_once.set()
                    # compute span: straggler delay + host->device put +
                    # gradient step + device->host readback
                    t_c0 = _trace.now_ms() if tr is not None else 0.0
                    dly = delay_model.delay_ms(wid) if calibrated else 0.0
                    if dly > 0:
                        time.sleep(dly / 1e3)
                    w_dev = put_model(w_host, dev)
                    counts[wid] += 1
                    if algo == "asaga":
                        g, diff = saga_step(shard, w_dev, idx, alpha_sel,
                                            n_valid, placed)
                        g_host = g.cpu().numpy()
                        diff_host = diff.cpu().numpy()
                        if tr is not None:
                            tr.add(_trace.COMPUTE, t_c0, _trace.now_ms())
                        if cv_buf is not None and \
                                counts[wid] % conv_every == 0:
                            conv_sample(shard, w_dev, ts, g_host)
                        _accepted, done = cl.push_saga(
                            wid, ts, g_host, diff_host, sparse=sparse,
                            tr=tr,
                        )
                    else:
                        g = asgd_step(shard, w_dev, gen, placed)
                        g_host = g.cpu().numpy()  # the push IS the readback
                        if tr is not None:
                            tr.add(_trace.COMPUTE, t_c0, _trace.now_ms())
                        if cv_buf is not None and \
                                counts[wid] % conv_every == 0:
                            conv_sample(shard, w_dev, ts, g_host)
                        _accepted, done = cl.push(wid, ts, g_host,
                                                  sparse=sparse, tr=tr)
                    # flight-recorder breadcrumb: the last acked push
                    # rides the dump
                    _flight.note("push", wid=wid, ts=ts,
                                 acc=bool(_accepted), n=counts[wid])
                    if done:
                        break
                except (ConnectionError, OSError):
                    # the RPC's whole retry budget is spent or the
                    # endpoint's breaker is open: the PS is restarting from
                    # checkpoint or the DCN is down.  Pace and re-enter.
                    time.sleep(0.2)
        finally:
            if cl is not None:
                if cl.released:
                    # the wid was reclaimed by a rejoiner: forget it so a
                    # LATER re-adoption can restart a loop here
                    with group_lock:
                        active_wids.discard(wid)
                cl.bye()

    def pipelined_worker_loop(wid: int) -> None:
        """Pipelined update loop (``async.pipeline.depth`` >= 1), one
        thread per worker, the overlap in the socket buffers:

        - **prefetched pulls** on a second PSClient connection:
          ``pull_start`` SENDS the pull for model v(k+1) before step k
          computes; ``pull_finish`` decodes it, usually without blocking
          (``prefetch_hits``);
        - **decoupled pushes** on a bounded wire window: ``push_start``
          sends step k's gradient and the loop moves on; only when
          ``depth`` pushes are unacknowledged does it block on one;
        - staleness stays bounded: the PS's taw admission prices the
          in-flight window, and a taw REJECTION discards the prefetched
          model and pulls fresh (``stale_discards``).

        Window entries are stamped once and REPLAYED on reconnect, so a
        delivered-but-unACKed push is re-answered from the PS dedup
        window, never re-applied."""
        shard = shards[wid]
        placed = mesh_place(wid, shard)  # None = single-device step
        dev = model_dev(shard, placed)
        # with a mesh the staged model lands on the first rank's device,
        # where every rank reads it
        stage, readback = steps.make_pipelined_transfer(dev)
        gen = worker_generator(cfg.seed, wid, dev)
        deadline = time.monotonic() + deadline_s
        pull_cl: Optional[PSClient] = None
        push_cl: Optional[PSClient] = None
        done = False
        stale_feedback = False

        def reap_one() -> None:
            """Collect the oldest in-flight push's ACK (FIFO)."""
            nonlocal done, stale_feedback
            try:
                accepted, acked_done = push_cl.push_finish()
                pl_stats.bump("pushes_async")
                _flight.note("push", wid=wid, acc=bool(accepted),
                             n=counts[wid])
                if acked_done:
                    done = True
                elif not accepted:
                    stale_feedback = True
            except (ConnectionError, OSError):
                # whole retry budget spent: the unacked window is lost,
                # as the serial loop's error path loses its round
                lost = push_cl.push_abandon()
                pl_stats.bump("push_errors", max(lost, 1))
                time.sleep(0.2)

        try:
            while not stop.is_set() and time.monotonic() < deadline:
                try:
                    pull_cl = make_client(recorder=recorder)
                    push_cl = make_client(recorder=recorder,
                                          pl_stats=pl_stats,
                                          cv_buf=cv_buf)
                    break
                except (ConnectionError, OSError):
                    time.sleep(0.2)  # PS mid-restart: pace and re-dial
            if push_cl is None:
                return
            tr = recorder.start_update(wid) if recorder is not None else None
            pull_cl.pull_start(wid, tr=tr)
            while (not stop.is_set() and not done
                   and time.monotonic() < deadline):
                was_ready = pull_cl.pull_ready()
                t_w0 = _trace.now_ms()
                try:
                    got = pull_cl.pull_finish(wid)
                except (ConnectionError, OSError):
                    time.sleep(0.2)
                    tr = (recorder.start_update(wid)
                          if recorder is not None else None)
                    pull_cl.pull_start(wid, tr=tr)
                    continue
                if got is None:
                    break  # DONE, or this wid was RELEASED to a rejoiner
                if was_ready:
                    pl_stats.bump("prefetch_hits")   # reply was buffered
                else:
                    pl_stats.bump("prefetch_waits")  # loop blocked on it
                if tr is not None:
                    tr.add(_trace.PIPELINE, t_w0, _trace.now_ms())
                # adoption orders ride PULL replies, i.e. arrive on the
                # prefetch connection
                if shard_factory is not None:
                    for orphan in pull_cl.take_orders():
                        adopt(orphan)
                if stale_feedback:
                    stale_feedback = False
                    pl_stats.bump("stale_discards")
                    tr = (recorder.start_update(wid)
                          if recorder is not None else None)
                    pull_cl.pull_start(wid, tr=tr)
                    continue
                ts, w_host, avg_ms, calibrated = got
                cur_tr = tr
                # prefetch the NEXT model before computing: its wave-gate
                # wait and RTT ride this step's compute
                tr = (recorder.start_update(wid)
                      if recorder is not None else None)
                pull_cl.pull_start(wid, tr=tr)
                if calibrated and not calibrated_once.is_set():
                    delay_model.calibrate(avg_ms)
                    calibrated_once.set()
                t_c0 = _trace.now_ms() if cur_tr is not None else 0.0
                dly = delay_model.delay_ms(wid) if calibrated else 0.0
                if dly > 0:
                    time.sleep(dly / 1e3)
                w_dev = stage(w_host)
                counts[wid] += 1
                g = asgd_step(shard, w_dev, gen, placed)
                g_host = readback(g)
                if cur_tr is not None:
                    cur_tr.add(_trace.COMPUTE, t_c0, _trace.now_ms())
                if cv_buf is not None and counts[wid] % conv_every == 0:
                    conv_sample(shard, w_dev, ts, g_host)
                # depth cap: at most depth_now unACKed pushes in flight
                # -- THE staleness bound the taw admission prices.  The
                # adaptive controller moves the live window within
                # [1, configured depth] (CTRL rides the pull replies
                # this very loop prefetches); without control the cap
                # IS the configured depth.
                depth_now = (ctrl_sink.depth(pipe_depth)
                             if ctrl_sink is not None else pipe_depth)
                t_q0 = _trace.now_ms() if cur_tr is not None else 0.0
                blocked = False
                while (push_cl.inflight_pushes() >= depth_now
                       and not done):
                    blocked = True
                    reap_one()
                if done:
                    break
                push_cl.push_start(wid, ts, g_host, sparse=sparse,
                                   tr=cur_tr)
                pl_stats.high_water("inflight_max",
                                    push_cl.inflight_pushes())
                if blocked and cur_tr is not None:
                    cur_tr.add(_trace.PIPELINE, t_q0, _trace.now_ms())
        finally:
            if push_cl is not None:
                # drain the window: every sent push gets its verdict
                while push_cl.inflight_pushes():
                    reap_one()
            released = ((pull_cl is not None and pull_cl.released)
                        or (push_cl is not None and push_cl.released))
            if released:
                with group_lock:
                    active_wids.discard(wid)
            if push_cl is not None:
                push_cl.bye()
            if pull_cl is not None:
                pull_cl.bye()

    def spawn(w: int) -> None:
        target = pipelined_worker_loop if pipe_depth > 0 else worker_loop
        t = threading.Thread(target=target, args=(w,),
                             name=f"dcn-worker-{w}", daemon=True)
        with group_lock:
            threads.append(t)
        t.start()

    # introduce this process to the PS before serving: the supervisor
    # learns the proc token, wids, and pid; a rejoining process's HELLO is
    # also what deposes its surrogate.  The WELCOME reply is also the
    # SHARD-MAP handshake (parallel/shardgroup.py): against a sharded PS
    # group it carries the per-shard [host, port, lo, hi] map (and the
    # fencing epochs) and every loop below runs a ShardedPSClient instead
    # -- so HELLO is retried for the WHOLE worker deadline, never skipped:
    # without the WELCOME this process cannot know whether the PS is a
    # shard group, and serving a sharded group as if it were one PS would
    # pull a single range as the whole model.  A PS dark past the
    # deadline aborts the process cleanly instead.
    hello_deadline = time.monotonic() + deadline_s
    hello_ok = False
    while True:
        try:
            hello_cl = PSClient(host, port, proc=proc_token)
            welcome = hello_cl.hello(proc_token, wids, pid=os.getpid())
            hello_cl.bye()
            hello_ok = True
            break
        except (ConnectionError, OSError):
            if time.monotonic() >= hello_deadline:
                break
            # gentle pacing: each PSClient ctor already spent a full retry
            # budget (backoff + breaker)
            time.sleep(0.5)
    if not hello_ok:
        # the PS never answered within the worker budget: give up loudly
        # with empty counts
        return dict(counts)
    wire_map = welcome.get("shards") or []
    if len(wire_map) > 1:
        from asyncframework_tpu_torch.parallel.shardgroup import ShardMap

        if algo != "asgd":
            raise ValueError("sharded PS groups serve algo='asgd' only")
        smap = ShardMap.from_wire(wire_map)
        wire_epochs = welcome.get("epochs")
        if wire_epochs:
            smap_epochs = [int(e) for e in wire_epochs]
    ps_epoch = int(welcome.get("epoch", 0) or 0)
    if welcome.get("ctrl"):
        from asyncframework_tpu_torch.parallel.controller import ControlSink

        ctrl_sink = ControlSink(welcome["ctrl"])

    for w in wids:
        spawn(w)
    join_deadline = time.monotonic() + deadline_s
    while time.monotonic() < join_deadline:
        with group_lock:
            snapshot = list(threads)
        if all(not t.is_alive() for t in snapshot):
            break
        time.sleep(0.05)
    if eval_wid is not None:
        # distributed optVars evaluation: score the PS's snapshot stack over
        # this process's shards, push one summed loss vector.  Only shards
        # this process still SERVES count.  Retried under pacing: a PS
        # mid-restart costs the eval plane a pause, not the trajectory.
        eval_deadline = time.monotonic() + min(60.0, deadline_s)
        while True:
            cl = None
            try:
                cl = make_client()
                times, W = cl.snapshots()
                with group_lock:
                    served = {w: s for w, s in shards.items()
                              if w in active_wids}
                losses = evaluate_snapshots_on_shards(served, times, W,
                                                      cfg.loss)
                cl.send_eval(eval_wid, losses)
                break
            except (ConnectionError, OSError):
                if time.monotonic() >= eval_deadline:
                    break  # trajectory forfeited, counts still returned
                if smap is not None:
                    # every retry builds a FRESH facade: refresh the map
                    # from any live member so a rebuild dials the
                    # group's current endpoints and epochs
                    from asyncframework_tpu_torch.parallel.shardgroup import (
                        resolve_live_group,
                    )

                    smap2, epochs2 = resolve_live_group(smap.entries)
                    if smap2 is not None:
                        smap = smap2
                        if epochs2:
                            smap_epochs = epochs2
                time.sleep(0.5)
            finally:
                if cl is not None:
                    try:
                        cl.bye()
                    except (ConnectionError, OSError):
                        pass
    return counts


def evaluate_snapshots_on_shards(shards: Dict[int, object], times: List[float],
                                 W: np.ndarray, loss: str = "least_squares"
                                 ) -> np.ndarray:
    """Per-snapshot loss SUMS over this process's shards (caller divides by
    global N after summing across processes)."""
    from asyncframework_tpu_torch.ops import steps

    ev_dense = steps.make_trajectory_loss_eval(loss)
    ev_sparse = steps.make_sparse_trajectory_loss_eval()
    total = np.zeros(W.shape[0], np.float64)
    for shard in shards.values():
        if hasattr(shard, "cols"):
            Wd = torch.from_numpy(np.array(W, np.float32)).to(shard.cols.device)
            part = ev_sparse(shard.cols, shard.vals, shard.y, Wd)
        else:
            Wd = torch.from_numpy(np.array(W, np.float32)).to(shard.X.device)
            part = ev_dense(shard.X, shard.y, Wd)
        total += part.double().cpu().numpy()
    return total

"""Sharded parameter server: range-partitioned model, elastic shard group.

Counterpart of ``asyncframework_tpu/parallel/shardgroup.py``, in PyTorch:
the same shard map, worker-side fan-out client and shard-group controller,
speaking the same wire, so a worker of either package trains against a
group of the other.  **Staleness becomes a per-shard vector, not a
scalar** (the delay-tolerant analysis of "Faster Asynchronous SGD",
arXiv:1601.04033).

Topology
--------

- the model ``w[0:d]`` is **range-partitioned** (:func:`shard_ranges`,
  contiguous near-equal ranges) across N stock ``ParameterServer``
  processes; each shard owns ``w[lo:hi]`` (on its device: ``cuda`` unless
  the caller asks for the CPU) with its OWN merge clock, taw admission,
  dedup window, and durable checkpoint.  The elementwise ASGD update
  commutes with slicing, so per-range applies are exact;
- a :class:`ShardMap` names the group: workers resolve it **at HELLO**
  (the WELCOME reply carries it) or via the ``SHARDMAP`` op -- no side
  channel, no config fan-out;
- **shard 0 is the primary**: it keeps the partial-barrier wave gate
  (cohort semantics unchanged at ``shards=1``), the elastic WORKER
  supervisor, the calibration broadcast, and the end-of-run EVAL plane.
  Secondaries serve their ranges ungated (``bucket_ratio=0``) and never
  self-finish (their iteration budget is unbounded; the primary's DONE is
  broadcast to them as ``FINISH``);
- a worker-side :class:`ShardedPSClient` presents the PSClient surface to
  the stock worker loops: a PULL becomes N parallel sub-pulls (sent
  back-to-back, reaped primary-first -- each sub-pull reuses the
  per-shard ``have=`` NM/XDELTA/FULL negotiation and CRC gating), a PUSH
  fans out per-shard gradient rows under per-shard ``(sid, seq)``
  exactly-once sessions, and the model version is a **vector** of
  per-shard clocks assembled worker-side.

Elastic shard failover
----------------------

:class:`ShardGroup` spawns the shard processes (the env-driven child
``python -m asyncframework_tpu_torch.parallel.shardgroup``) and folds them
into an :class:`~asyncframework_tpu_torch.parallel.supervisor.ElasticSupervisor`
as first-class members (``adopt=False`` slots, one per shard): each
monitor tick probes every shard's port (the contact signal) and the
supervisor declares a shard dead on **local pid exit or silence**.  A dead
shard is restarted on its pinned port from its durable checkpoint (model +
clock + dedup window captured under one lock); live shards keep serving
their ranges meanwhile.  With fencing on (``async.fence.enabled``) every
restart runs under a freshly minted epoch, announced to the group by
SETMAP.  In-flight pushes to the dead shard replay through the wire-window
machinery onto the recovered shard: a push the dead shard
applied-but-never-ACKed is re-answered from the RESTORED dedup window,
never merged twice, while a push lost past the checkpoint is applied now
(its effect was rolled back with the model).

``async.ps.shards = 1`` (the default) never touches any of this: the
launcher provisions the classic single PS and the wire is byte- and
step-identical.

With ``async.ps.standby`` the group also runs one warm standby child per
managed shard (``parallel/replication.py``), and a dead primary is
PROMOTED -- its standby takes the range under the minted epoch, with no
process spawn and no checkpoint replay -- before a relaunch is tried.
``install_ctrl`` and :class:`CtrlFanout` fan the adaptive controller's
CTRL decisions out to every member (``parallel/controller.py``).
:class:`ShardedSubscriber` is the serving replica's view of a group: a
per-range SUBSCRIBE fan-out, assembled on the replica.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from asyncframework_tpu_torch.metrics import flightrec as _flight
from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.parallel import supervisor as supervisor_mod

# ------------------------------------------------------------- group totals
# Process-global shard-group counters (metrics/registry.py family
# "shardgroup"): bumped by the controller (restarts) and the worker-side
# facade (finish broadcasts, assembled pulls) in whichever process hosts
# them -- the same per-process discipline as every other family.
_totals_lock = threading.Lock()
_totals: Dict[str, int] = {}


def shard_totals() -> Dict[str, int]:
    """Shard-group counters: shard_deaths (supervisor declared a shard
    dead), shards_restarted (children relaunched from checkpoint),
    restart_failures (relaunch attempts that did not come back),
    finish_broadcasts (primary DONE fanned out to secondaries),
    sharded_pulls / sharded_pushes (assembled vector-clock round trips),
    pull_vector_len_<N> (assembled pulls whose version vector had N
    clocks), shard_round_errors (fan-out rounds abandoned on a sub-shard
    fault), fence_epoch_bumps (relaunches announced under a new epoch),
    map_re_resolves, restarts_uncheckpointed."""
    with _totals_lock:
        return dict(_totals)


def reset_shard_totals() -> None:
    """Zero the process-global shard-group counters (per-run isolation;
    see ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    with _totals_lock:
        _totals.clear()


def _bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] = _totals.get(key, 0) + n


# The controller running in THIS process, if any (a cluster launcher, the
# chaos harness): /api/status pages add a per-shard section from it
# (metrics/live.py reads it via active_group()).  Last started wins; a
# stopped group unhooks itself identity-gated, so a stale reference can
# never shadow a live one.
_active_group_lock = threading.Lock()
_active_group: Optional["ShardGroup"] = None


def active_group() -> Optional["ShardGroup"]:
    with _active_group_lock:
        return _active_group


def _set_active_group(group, *, only_if=None) -> None:
    global _active_group
    with _active_group_lock:
        if only_if is not None and _active_group is not only_if:
            return
        _active_group = group


# ---------------------------------------------------------------- shard map
def shard_ranges(d: int, shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal ``[lo, hi)`` ranges covering ``[0, d)``.
    Shard count is clamped to ``d`` (a shard must own >= 1 coordinate);
    the first ``d % shards`` ranges carry the remainder coordinate."""
    d = int(d)
    shards = max(1, min(int(shards), d))
    base, rem = divmod(d, shards)
    out: List[Tuple[int, int]] = []
    lo = 0
    for i in range(shards):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


class ShardMap:
    """The group's wire-shareable identity: per-shard ``(host, port, lo,
    hi)`` in range order.  Validated contiguous on construction -- a map
    with a hole or an overlap cannot exist, so worker-side assembly by
    concatenation is correct by construction."""

    __slots__ = ("entries",)

    def __init__(self, entries: Sequence[Sequence]):
        norm = [(str(h), int(p), int(lo), int(hi))
                for (h, p, lo, hi) in entries]
        if not norm:
            raise ValueError("empty shard map")
        expect = 0
        for (_h, _p, lo, hi) in norm:
            if lo != expect or hi <= lo:
                raise ValueError(f"non-contiguous shard map: {norm}")
            expect = hi
        self.entries = norm

    @classmethod
    def from_wire(cls, wire) -> "ShardMap":
        return cls(wire)

    def to_wire(self) -> List[List]:
        return [list(e) for e in self.entries]

    @property
    def n_shards(self) -> int:
        return len(self.entries)

    @property
    def d(self) -> int:
        return self.entries[-1][3]

    def ranges(self) -> List[Tuple[int, int]]:
        return [(lo, hi) for (_h, _p, lo, hi) in self.entries]

    def __repr__(self) -> str:
        return f"ShardMap({self.entries})"


#: telemetry-port pre-assignment uses the shared reserve-and-release
#: helper (net/frame.py): the slot's scrape URL must be known BEFORE
#: the child binds it, and must survive relaunches
_free_port = _frame.free_port


def _oneshot(host: str, port: int, header: dict,
             timeout_s: float) -> dict:
    """One framed request/reply on a FRESH connection (never a data
    connection: a prefetched PULL reply may be parked in its buffer and
    must not be mispaired with this reply).  Returns the reply header."""
    s = _frame.connect((host, int(port)), timeout=timeout_s)
    try:
        s.settimeout(timeout_s)
        _frame.send_msg(s, header)
        reply, _payload = _frame.recv_msg(s)
        return reply
    finally:
        s.close()


def fetch_shard_map(host: str, port: int,
                    timeout_s: float = 10.0) -> Optional[ShardMap]:
    """One SHARDMAP round trip against any group member.  Returns None
    when the server is unsharded (the classic single PS answers an empty
    map).  Raises on transport failure -- callers own retry pacing."""
    smap, _epochs, _epoch = fetch_group_info(host, port, timeout_s)
    return smap


def fetch_group_info(host: str, port: int, timeout_s: float = 10.0
                     ) -> Tuple[Optional[ShardMap],
                                Optional[List[int]], int]:
    """One SHARDMAP round trip returning ``(shard_map, epochs, epoch)``:
    the group map (None when unsharded), the per-shard fencing-epoch
    vector (None when fencing is off or unknown), and the answering
    server's own epoch (0 = fencing off) -- everything a subscriber
    needs to stamp its reads so a fenced zombie can never serve it."""
    header = _oneshot(host, port, {"op": "SHARDMAP"}, timeout_s)
    wire = header.get("shards") or []
    epochs = header.get("epochs")
    epoch = int(header.get("epoch", 0) or 0)
    if len(wire) <= 1:
        return None, None, epoch
    return (ShardMap.from_wire(wire),
            [int(e) for e in epochs] if epochs else None, epoch)


def finish_endpoint(host: str, port: int, timeout_s: float = 5.0) -> None:
    """One FINISH round trip; idempotent server-side."""
    _oneshot(host, port, {"op": "FINISH"}, timeout_s)


def resolve_live_group(entries, timeout_s: float = 2.0
                       ) -> Tuple[Optional[ShardMap],
                                  Optional[List[int]]]:
    """Sweep a (possibly stale) map's entries for any LIVE member and
    return its view of the CURRENT ``(shard_map, epochs)`` -- the one
    re-resolution primitive behind every 'a promotion moved an
    endpoint' recovery path (worker facade, serving subscriber, the
    eval fan-out).  ``(None, None)`` when nobody answers."""
    for e in list(entries):
        try:
            smap, epochs, _ep = fetch_group_info(
                str(e[0]), int(e[1]), timeout_s=timeout_s)
        except (ConnectionError, OSError):
            continue
        if smap is not None:
            return smap, epochs
        return None, None  # an unsharded answer: nothing to re-resolve
    return None, None


# ------------------------------------------------------- worker-side facade
class ShardedPSClient:
    """The PSClient surface over a shard group: same methods the stock
    worker loops call (serial pull/push, the prefetch pair, the windowed
    push pipe, orders/eval/bye), fanned out per shard.

    Version vector: :meth:`pull` returns ``ts`` as a TUPLE of per-shard
    clocks; :meth:`push` takes that tuple back and stamps each sub-push
    with its own shard's component -- each shard prices staleness against
    its own clock (the per-shard vector contract).  ``accepted`` / ``done``
    verdicts are the PRIMARY's: its clock drives cohorts, calibration,
    and run completion; secondaries follow via FINISH.

    Fault discipline: any sub-shard RPC that exhausts its retry budget
    abandons the WHOLE round on every shard (windows dropped, sockets
    reset) and re-raises -- exactly how the serial loop loses a round
    today, except per-shard sessions guarantee the abandoned pushes that
    DID land are never re-applied when their stamps are seen again.
    Within the retry budget, a restarting shard is ridden out invisibly:
    each sub-client reconnects and replays its unacked window onto the
    recovered shard (dedup-cached re-ACKs, never a double apply).
    """

    def __init__(self, smap: ShardMap, timeout_s: float = 120.0,
                 proc: Optional[str] = None, recorder=None,
                 pull_mode: Optional[str] = None, pl_stats=None,
                 cv_buf=None, epochs: Optional[Sequence[int]] = None,
                 ctrl_sink=None):
        from asyncframework_tpu_torch.parallel.ps_dcn import PSClient

        self.smap = smap
        # rebuild context for a moved endpoint: a sub-shard endpoint can
        # MOVE mid-run (the controller promotes a standby onto its own
        # port), so _re_resolve needs everything a fresh sub-client takes
        self._timeout_s = float(timeout_s)
        self._proc = proc
        self._recorder = recorder
        self._pull_mode = pull_mode
        self._pl_stats = pl_stats
        self._cv_buf = cv_buf
        # adaptive control (parallel/controller.py): EVERY sub-client
        # shares the sink -- any shard may deliver a newer CTRL payload
        # (SETMAP reached it first) and the monotone install keeps the
        # newest decision regardless of which range answered first
        self._ctrl_sink = ctrl_sink
        # piggybacked telemetry (trace spans, pipeline counters,
        # convergence samples) rides the PRIMARY connection only: the
        # primary folds it into the process that serves the dashboard;
        # shipping copies per shard would double-count every sample.
        # ``epochs`` (WELCOME handshake) seeds per-shard fencing epochs:
        # each sub-client stamps ITS shard's epoch -- ranges fence
        # independently, exactly like the staleness vector.
        self.clients: List[PSClient] = [
            PSClient(h, p, timeout_s=timeout_s, proc=proc,
                     recorder=recorder if i == 0 else None,
                     pull_mode=pull_mode,
                     pl_stats=pl_stats if i == 0 else None,
                     cv_buf=cv_buf if i == 0 else None,
                     epoch=(int(epochs[i])
                            if epochs and i < len(epochs) else 0),
                     ctrl_sink=ctrl_sink)
            for i, (h, p, _lo, _hi) in enumerate(smap.entries)
        ]
        self._saw_done = False
        self._finished = False
        # faulted fan-out rounds since construction: every 3rd one also
        # re-resolves the map (promotion-following, paced -- see _reset)
        self._round_errors = 0

    # ------------------------------------------------------------ plumbing
    @property
    def released(self) -> bool:
        return any(c.released for c in self.clients)

    def take_orders(self) -> List[int]:
        return self.clients[0].take_orders()

    def hello(self, proc: str, wids: List[int],
              pid: Optional[int] = None) -> dict:
        return self.clients[0].hello(proc, wids, pid=pid)

    def _rebuild_client(self, i: int, host: str, port: int,
                        epoch: int):
        """One sub-client re-homed onto a moved endpoint (promotion).
        The replacement keeps the OLD client's ClientSession and
        inherits its unacked push window VERBATIM -- original
        ``(sid, seq)`` stamps, original epoch stamps -- and drains the
        replay synchronously: an entry the deposed primary applied AND
        streamed re-answers from the promoted standby's REPLICATED
        dedup window (exactly-once across the failover); an unapplied
        or unstreamed one comes back REJECT_FENCED on its stale stamp
        and is dropped -- the same loss as an abandoned round, never a
        double apply."""
        from asyncframework_tpu_torch.parallel.ps_dcn import PSClient

        old = self.clients[i]
        nc = PSClient(host, int(port), timeout_s=self._timeout_s,
                      proc=self._proc,
                      recorder=self._recorder if i == 0 else None,
                      pull_mode=self._pull_mode,
                      pl_stats=self._pl_stats if i == 0 else None,
                      cv_buf=self._cv_buf if i == 0 else None,
                      session=old.session, epoch=int(epoch),
                      ctrl_sink=self._ctrl_sink)
        with old._win_lock:
            entries = list(old._push_window)
            old._push_window.clear()
        old._drop_sock()
        if entries:
            nc._push_window.extend(entries)
            nc._drop_sock()  # push_finish's reconnect REPLAYS them all
            for _ in range(len(entries)):
                try:
                    nc.push_finish()
                except (ConnectionError, OSError):
                    nc.push_abandon()
                    break
        return nc

    def _re_resolve(self) -> bool:
        """After a sub-shard fault: ask any reachable member for the
        CURRENT map (a promotion re-SETMAPs every member) and re-home
        the sub-clients whose endpoints moved -- every moved one in ONE
        pass, judged against each CLIENT's actual endpoint (an earlier
        partial re-resolve must never mask a still-stale client).
        Best-effort -- the caller is already on an error path and
        retries either way."""
        smap, epochs = resolve_live_group(self.smap.entries,
                                          timeout_s=2.0)
        if smap is None or smap.ranges() != self.smap.ranges():
            return False
        changed = False
        for i, entry in enumerate(smap.entries):
            c = self.clients[i]
            if (str(entry[0]), int(entry[1])) == (c.host, c.port):
                if (epochs and i < len(epochs)
                        and int(epochs[i]) > c.epoch):
                    c.epoch = int(epochs[i])
                continue
            try:
                self.clients[i] = self._rebuild_client(
                    i, entry[0], entry[1],
                    int(epochs[i]) if epochs and i < len(epochs) else 0)
            except (ConnectionError, OSError):
                continue  # that replacement not up yet; retry later
            changed = True
        if changed:
            self.smap = smap
            _bump("map_re_resolves")
        return changed

    def _reset(self) -> None:
        """Abandon the whole fan-out round: every shard's unacked window
        is dropped (piggybacks requeued) and every socket closed, so the
        next round starts from a clean slate on fresh connections --
        a half-consumed reply can never be mispaired."""
        _bump("shard_round_errors")
        self._round_errors += 1
        if self._round_errors % 3 == 0:
            # hot-standby promotion moves a shard's endpoint mid-run:
            # learn the current map and re-home moved sub-clients
            # (their windows ride along and replay against the
            # replicated dedup window).  PACED to every third faulted
            # round -- the overwhelmingly common _reset trigger is a
            # transient (a shard mid-relaunch), which must stay pure
            # local cleanup, not a serial network sweep whose dark-
            # member connect timeouts stall the worker's error path.
            try:
                self._re_resolve()
            except Exception:  # noqa: BLE001 - recovery must never
                pass           # mask the fault that brought us here
        for c in self.clients:
            try:
                c.push_abandon()
            except (ConnectionError, OSError):  # pragma: no cover
                pass
            c._drop_sock()

    def _note_done(self, done: bool) -> None:
        if done:
            self._saw_done = True

    def _broadcast_finish(self) -> None:
        """Primary DONE -> tell the secondaries (idempotent, best-effort;
        the controller's own finish() is the backstop)."""
        if self._finished:
            return
        self._finished = True
        _bump("finish_broadcasts")
        for (h, p, _lo, _hi) in self.smap.entries[1:]:
            try:
                finish_endpoint(h, p)
            except (ConnectionError, OSError):
                pass

    # ---------------------------------------------------------- model pull
    def pull_start(self, wid: int, tr=None) -> None:
        for i, c in enumerate(self.clients):
            c.pull_start(wid, tr=tr if i == 0 else None)

    def pull_ready(self) -> bool:
        return all(c.pull_ready() for c in self.clients)

    def _assemble(self, gots) -> Optional[tuple]:
        if any(g is None for g in gots):
            # DONE (run over / FINISHed shard) or RELEASED (primary
            # deposed this wid).  A torn mix -- some shards answered a
            # model -- is discarded whole; PULL is idempotent.
            if gots[0] is None and not self.released:
                self._note_done(True)
            return None
        _bump("sharded_pulls")
        ts = tuple(int(g[0]) for g in gots)
        # the version vector's length, counted where it is assembled (one
        # clock per range of the map)
        _bump(f"pull_vector_len_{len(ts)}")
        w = np.concatenate([g[1] for g in gots])
        return ts, w, float(gots[0][2]), bool(gots[0][3])

    def pull_finish(self, wid: int) -> Optional[tuple]:
        try:
            gots = [c.pull_finish(wid) for c in self.clients]
        except (ConnectionError, OSError):
            self._reset()
            raise
        return self._assemble(gots)

    def pull(self, wid: int, tr=None) -> Optional[tuple]:
        """N parallel sub-pulls: all requests go out back-to-back (the
        primary's parks in the wave gate; secondaries answer immediately
        into their kernel buffers), then replies are reaped
        primary-first.  Returns ``(ts_vector, w_assembled, avg_delay_ms,
        calibrated)`` or None on DONE/RELEASED."""
        try:
            self.pull_start(wid, tr=tr)
        except (ConnectionError, OSError):
            self._reset()
            raise
        return self.pull_finish(wid)

    # ---------------------------------------------------------- model push
    def _slice(self, g: np.ndarray, i: int) -> np.ndarray:
        _h, _p, lo, hi = self.smap.entries[i]
        return g[lo:hi]

    def _ts_of(self, ts, i: int) -> int:
        if isinstance(ts, (tuple, list)):
            return int(ts[i])
        return int(ts)  # defensive: scalar stamps every shard

    def push(self, wid: int, ts, g: np.ndarray, sparse: bool = False,
             diff: Optional[np.ndarray] = None, tr=None
             ) -> Tuple[bool, bool]:
        """Fan one gradient out as per-shard row pushes (per-shard
        ``(sid, seq)`` stamps, per-shard version stamps from the pull's
        vector), overlapped: all sub-pushes are SENT before any ACK is
        reaped (the per-connection server loop replies in order, so ACKs
        pair FIFO per shard).  Verdict is the primary's."""
        if diff is not None:
            raise ValueError("ASAGA does not ride the sharded PS group "
                             "(PS-side sampling is range-global)")
        g = np.asarray(g, np.float32)
        try:
            for i, c in enumerate(self.clients):
                c.push_start(wid, self._ts_of(ts, i), self._slice(g, i),
                             sparse=sparse, tr=tr if i == 0 else None)
            accepted = done = False
            for i, c in enumerate(self.clients):
                a, dn = c.push_finish()
                if i == 0:
                    accepted, done = a, dn
        except (ConnectionError, OSError):
            self._reset()
            raise
        _bump("sharded_pushes")
        self._note_done(done)
        return accepted, done

    # ------------------------------------------------- windowed push pipe
    def push_start(self, wid: int, ts, g: np.ndarray,
                   sparse: bool = False, diff: Optional[np.ndarray] = None,
                   tr=None) -> None:
        if diff is not None:
            raise ValueError("ASAGA does not ride the sharded PS group")
        g = np.asarray(g, np.float32)
        for i, c in enumerate(self.clients):
            c.push_start(wid, self._ts_of(ts, i), self._slice(g, i),
                         sparse=sparse, tr=tr if i == 0 else None)

    def push_finish(self) -> Tuple[bool, bool]:
        try:
            accepted, done = self.clients[0].push_finish()
            for c in self.clients[1:]:
                c.push_finish()
        except (ConnectionError, OSError):
            self._reset()
            raise
        _bump("sharded_pushes")
        self._note_done(done)
        return accepted, done

    def push_abandon(self) -> int:
        return max(c.push_abandon() for c in self.clients)

    def inflight_pushes(self) -> int:
        return max(c.inflight_pushes() for c in self.clients)

    # -------------------------------------------------------- end of run
    def snapshots(self) -> Tuple[List[float], np.ndarray]:
        """Assembled trajectory stacks: per-shard stacks are fetched and
        tail-aligned (snapshot cadences can drift a row or two across
        shards when accept patterns differ), then concatenated per row in
        range order.  Times are the primary's -- its clock stamps the
        trajectory the same way it governs the run."""
        stacks = [c.snapshots() for c in self.clients]
        length = min(len(t) for (t, _W) in stacks)
        # positive start index: a shard relaunched fresh past the run's
        # last cadence tick has an EMPTY stack, and [-0:] would take every
        # row of the others instead of none
        times = list(stacks[0][0][len(stacks[0][0]) - length:])
        W = np.concatenate(
            [W[W.shape[0] - length:] for (_t, W) in stacks], axis=1)
        return times, W

    def send_eval(self, wid: int, losses: np.ndarray) -> None:
        self.clients[0].send_eval(wid, losses)

    def bye(self) -> None:
        if self._saw_done and not self.released:
            # this worker watched the run finish: make sure the
            # secondaries learn (idempotent; racing peers are fine)
            self._broadcast_finish()
        for c in self.clients:
            c.bye()


# ------------------------------------------------------ serving-side facade
class ShardedSubscriber:
    """The serving tier's view of a shard group (``serving/replica.py``):
    per-range SUBSCRIBE fan-out with replica-side assembly.

    Each range rides the stock delta-pull machinery (``have=`` NM/XDELTA/
    FULL, CRC-gated, full-pull fallback) on its own connection, and the
    subscriber keeps every range's LAST VALIDATED reply.  A refresh round
    touches every range even after one fails, so live ranges keep their
    basis caches warm while a dead shard restarts -- that is the partial
    refresh: when the dark range comes back, one NM/delta round trip
    completes the model instead of a full resync.

    :meth:`subscribe` assembles the per-range slices (each individually
    CRC-validated -- a torn slice is unrepresentable) and returns the
    PSClient.subscribe tuple shape with SUMMED version/clock/k scalars,
    so ``clock - ts`` is the total versions behind across ranges.  Sum
    equality is NOT version identity (a restarted shard rolls its clock
    back, so distinct vectors can sum equal): :attr:`changed_since_last`
    carries the exact vector comparison, and the replica consults it
    before reusing a device buffer on an apparently-unchanged ts.  ``age_ms`` is the WORST range's content age including time
    a dark range has been unreachable -- the replica's freshness gate
    prices the range that is actually stale, not the average.  A range
    with no validated reply yet raises (there is nothing correct to
    serve); per-range ages are exposed so the replica can answer
    UNHEALTHY naming the stale ranges rather than serving a silent lie.
    """

    def __init__(self, smap: ShardMap, timeout_s: float = 120.0,
                 epochs: Optional[Sequence[int]] = None):
        from asyncframework_tpu_torch.net.retry import RetryPolicy
        from asyncframework_tpu_torch.parallel.ps_dcn import PSClient

        self.smap = smap
        # snappy per-call retry: the refresh LOOP is the real retry here
        # (it comes back every interval), so a dark range must cost this
        # round milliseconds of backoff, not the full worker-grade budget
        # -- live ranges' freshness is priced by wall clock and a slow
        # dead-range probe would smear staleness onto healthy ranges.
        # The attempt timeout is capped too: a SYN-blackholed shard (node
        # death, the k8s case) times out the connect, and a 120s socket
        # budget there would stall the serial round just as badly as the
        # backoff would -- a range that cannot answer a SUBSCRIBE in 5s
        # is already hopeless for a 50ms-refresh serving tier
        # max_attempts=1: after ~breaker-threshold dark rounds the shared
        # circuit opens and subsequent rounds fail INSTANTLY, so steady-
        # state cost of a dead range is one <=2s half-open probe per
        # cooldown, not a per-round stall
        retry = RetryPolicy.from_conf(
            attempt_timeout_s=min(float(timeout_s), 2.0), max_attempts=1,
            base_ms=20.0, max_ms=80.0,
        )
        self._retry = retry
        self._timeout_s = float(timeout_s)
        self.clients = [
            PSClient(h, p, timeout_s=timeout_s, retry=retry,
                     pull_mode="delta",
                     epoch=(int(epochs[i])
                            if epochs and i < len(epochs) else 0))
            for i, (h, p, _lo, _hi) in enumerate(smap.entries)
        ]
        self._last: List[Optional[tuple]] = [None] * smap.n_shards
        self._ok_mono: List[Optional[float]] = [None] * smap.n_shards
        # consecutive dark rounds per range: every third one also asks a
        # live member whether the range's endpoint MOVED (hot-standby
        # promotion) -- bounded extra probing, so a plainly-dead shard
        # mid-restart does not buy a map round trip per refresh
        self._dark_rounds: List[int] = [0] * smap.n_shards
        # collision guard for the replica's NOT_MODIFIED fast path: the
        # returned ts is the SUM of per-shard versions (the lag math
        # needs clock - ts in merge units), but a shard RESTART rolls its
        # clock back, so two different vectors can sum equal.  The
        # replica consults this flag before reusing its device buffer.
        self._prev_vector: Optional[tuple] = None
        self.changed_since_last = True

    # aggregated PSClient-compatible counters (the replica reports these)
    @property
    def pull_wenc(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.clients:
            for k, v in c.pull_wenc.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def delta_fallbacks(self) -> int:
        return sum(c.delta_fallbacks for c in self.clients)

    def subscribe(self, rid: int = 0
                  ) -> Tuple[int, np.ndarray, int, int, float, bool]:
        """One refresh round over every range; see the class docstring.
        Raises ``ConnectionError`` only when some range has never
        answered -- a partially-dark group still returns the assembled
        model (stale ranges priced into ``age_ms``)."""
        for i, c in enumerate(self.clients):
            try:
                got = c.subscribe(rid)
            except (ConnectionError, OSError):
                _bump("subscribe_dark_rounds")
                self._dark_rounds[i] += 1
                if self._dark_rounds[i] % 3 == 0:
                    self._maybe_re_resolve(i)
                continue
            self._dark_rounds[i] = 0
            if got is None:  # pragma: no cover - SUBSCRIBE never says DONE
                continue
            self._last[i] = got
            # stamped per reply, not per round: a dark range's retry
            # budget burns seconds mid-round, and pricing that wait into
            # the LIVE ranges' freshness would mark the whole model stale
            self._ok_mono[i] = time.monotonic()
        now = time.monotonic()
        missing = [i for i, l in enumerate(self._last) if l is None]
        if missing:
            raise ConnectionError(
                f"sharded SUBSCRIBE: no validated model yet for "
                f"range(s) {missing}"
            )
        vector = tuple(int(l[0]) for l in self._last)
        self.changed_since_last = vector != self._prev_vector
        self._prev_vector = vector
        ts = sum(vector)
        w = np.concatenate([l[1] for l in self._last])
        clock = sum(int(l[2]) for l in self._last)
        k = sum(int(l[3]) for l in self._last)
        age = 0.0
        for i, l in enumerate(self._last):
            age = max(age,
                      float(l[4]) + (now - self._ok_mono[i]) * 1e3)
        done = all(bool(l[5]) for l in self._last)
        _bump("sharded_subscribes")
        return ts, w, clock, k, age, done

    def _maybe_re_resolve(self, i: int) -> None:
        """Range ``i`` has been dark for a few rounds: ask a LIVE member
        for the current map -- a hot-standby promotion moved the range's
        endpoint, and the subscriber must follow it (the replica's
        partial-refresh machinery then completes the model with one
        NM/delta round trip).  Rebuilds EVERY range whose endpoint
        moved (simultaneous promotions included), judged against each
        CLIENT's actual endpoint -- adopting the new map while
        rebuilding only one range would strand the others forever.
        Best-effort and bounded: one sweep, the dark range excluded
        from the query targets (its blackholed probe must not stall
        the refresh round)."""
        from asyncframework_tpu_torch.parallel.ps_dcn import PSClient

        others = [e for j, e in enumerate(self.smap.entries) if j != i]
        smap, epochs = resolve_live_group(others, timeout_s=1.0)
        if smap is None or smap.ranges() != self.smap.ranges():
            return
        changed = False
        for j, entry in enumerate(smap.entries):
            c = self.clients[j]
            if (str(entry[0]), int(entry[1])) == (c.host, c.port):
                continue
            try:
                nc = PSClient(entry[0], int(entry[1]),
                              timeout_s=self._timeout_s,
                              retry=self._retry, pull_mode="delta",
                              epoch=(int(epochs[j])
                                     if epochs and j < len(epochs)
                                     else 0))
            except (ConnectionError, OSError):
                continue  # that replacement not up yet; next dark round
            c._drop_sock()
            self.clients[j] = nc
            changed = True
        if changed:
            self.smap = smap
            _bump("subscriber_re_resolves")

    def all_ranges_dark(self) -> bool:
        """Whether the last refresh round reached no range at all (the
        group has gone)."""
        return all(n > 0 for n in self._dark_rounds)

    def oldest_ok_age_ms(self) -> Optional[float]:
        """Age of the STALEST range's last successful refresh; None until
        every range has answered at least once."""
        if any(m is None for m in self._ok_mono):
            return None
        now = time.monotonic()
        return max((now - m) * 1e3 for m in self._ok_mono)

    def stale_ranges(self, max_age_ms: float) -> List[int]:
        """Range indices whose last successful refresh is older than
        ``max_age_ms`` (never-refreshed ranges included) -- the
        UNHEALTHY-per-range answer."""
        now = time.monotonic()
        return [
            i for i, m in enumerate(self._ok_mono)
            if m is None or (now - m) * 1e3 > max_age_ms
        ]

    def range_status(self) -> List[Dict]:
        """Per-range freshness for the replica's STATUS reply."""
        now = time.monotonic()
        out = []
        for i, (_h, _p, lo, hi) in enumerate(self.smap.entries):
            last, ok = self._last[i], self._ok_mono[i]
            out.append({
                "shard": i, "lo": lo, "hi": hi,
                "ts": int(last[0]) if last is not None else None,
                "clock": int(last[2]) if last is not None else None,
                "ok_age_ms": (round((now - ok) * 1e3, 1)
                              if ok is not None else None),
            })
        return out

    def bye(self) -> None:
        for c in self.clients:
            try:
                c.bye()
            except (ConnectionError, OSError):  # pragma: no cover
                pass


# --------------------------------------------------------- group controller
class _ShardProc:
    """One managed shard child: Popen handle, pinned port, stdout pump."""

    def __init__(self, index: int):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.restarts = 0
        self.resumed_from: Optional[int] = None
        self.lines: List[str] = []
        self.lines_cv = threading.Condition()
        self._reader: Optional[threading.Thread] = None

    def attach(self, proc: subprocess.Popen) -> None:
        self.proc = proc
        lines: List[str] = []
        self.lines = lines

        # the pump binds ITS life's list: a previous life's reader still
        # draining a killed child's pipe buffer must not deposit a stale
        # line into the new child's announce slot
        def pump(p=proc, lines=lines):
            for line in p.stdout:
                with self.lines_cv:
                    lines.append(line.rstrip("\n"))
                    self.lines_cv.notify_all()

        self._reader = threading.Thread(
            target=pump, name=f"shard-{self.index}-stdout", daemon=True
        )
        self._reader.start()

    def next_line(self, seen: int, timeout_s: float) -> Optional[str]:
        deadline = time.monotonic() + timeout_s
        with self.lines_cv:
            while len(self.lines) <= seen:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self.lines_cv.wait(timeout=min(left, 0.2))
            return self.lines[seen]


class ShardGroup:
    """Spawn, supervise, and recover a PS shard group on this host.

    The controller imports no device code: it Popens the env-driven shard
    child (:func:`_child_main`), probes each shard's port every monitor
    tick (the supervisor's contact signal), and lets an
    :class:`ElasticSupervisor` (``adopt=False``, one slot per shard)
    declare deaths by **local pid exit or silence**.  A dead shard is
    killed-if-wedged and relaunched on its pinned port from its durable
    checkpoint; the restarted child's hello line reports ``resumed_from``
    so recovery is observable.

    ``indices`` selects which shards THIS controller manages (a launcher
    may run the primary in-process and manage only the secondaries).
    ``fixed_entries`` names the unmanaged shards' endpoints so the full
    :class:`ShardMap` can be assembled and SETMAP'd to every managed
    child.  ``device`` is the children's device (``PS_DEVICE`` in their
    environment, as ``tools/ps_child.py`` takes it: ``cuda`` unless the
    caller asks for ``cpu``).

    With standbys on (``standbys`` or ``async.ps.standby`` in the
    overlays), ``standby_indices`` names the shards that get a warm
    standby child (default: the managed ones).  It may name an unmanaged
    shard too (a launcher's in-process primary): that primary learns its
    standby from the SETMAPs the group sends every member and streams to
    it; the group respawns the standby when it dies, but never promotes
    over a primary it does not manage.
    """

    def __init__(self, cfg, d: int, n: int, shards: int,
                 host: str = "127.0.0.1", algo: str = "asgd",
                 checkpoint_dir: Optional[str] = None,
                 indices: Optional[Sequence[int]] = None,
                 fixed_entries: Optional[Dict[int, Tuple[str, int]]] = None,
                 conf_overlays: Optional[Dict[str, object]] = None,
                 env: Optional[Dict[str, str]] = None,
                 worker_procs: int = 0, elastic: bool = False,
                 stderr_dir: Optional[str] = None,
                 dead_after_s: float = 2.0,
                 check_interval_s: float = 0.25,
                 max_restarts: int = 10,
                 spawn_timeout_s: float = 90.0,
                 standbys: Optional[int] = None,
                 telemetry_ports: Optional[object] = None,
                 device: Optional[str] = None,
                 standby_indices: Optional[Sequence[int]] = None):
        if algo != "asgd":
            raise ValueError("sharded PS groups support algo='asgd' only "
                             "(ASAGA's PS-side sampling is range-global)")
        if shards < 1:
            raise ValueError("ShardGroup needs shards >= 1")
        if int(d) < int(shards):
            # shard_ranges would clamp, but the controller still spawns
            # `shards` children -- the surplus ones would die at an
            # IndexError before announcing and start() would block its
            # full spawn timeout on a misleading "did not announce"
            raise ValueError(f"d={d} cannot range-partition over "
                             f"{shards} shards (a shard owns >= 1 "
                             f"coordinate)")
        from asyncframework_tpu_torch.conf import (
            FENCE_ENABLED,
            GRAY_RTT_FACTOR,
            GRAY_RTT_MIN_MS,
            LEASE_S,
            PS_STANDBY,
            SUSPECT_AFTER_S,
            AsyncConf,
        )

        overlay_conf = AsyncConf(dict(conf_overlays or {}))
        # shards=1 is the control arm: ONE managed child process serving
        # the classic single-PS wire (no shard map is assembled or
        # advertised, so clients cannot tell it from an unsharded PS)
        self.cfg = cfg
        self.d, self.n = int(d), int(n)
        self.shards = int(shards)
        self.host = host
        self.algo = algo
        self.checkpoint_dir = checkpoint_dir
        self.indices = sorted(indices if indices is not None
                              else range(self.shards))
        self.fixed_entries = dict(fixed_entries or {})
        self.conf_overlays = dict(conf_overlays or {})
        self.env = dict(env if env is not None else os.environ)
        if device is not None:
            self.env["PS_DEVICE"] = str(device)
        self.worker_procs = int(worker_procs)
        self.elastic = bool(elastic)
        self.stderr_dir = stderr_dir
        self.max_restarts = int(max_restarts)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self._ranges = shard_ranges(self.d, self.shards)
        self._procs: Dict[int, _ShardProc] = {
            i: _ShardProc(i) for i in self.indices
        }
        # adaptive control (parallel/controller.py): the group's stored
        # CTRL payload, re-announced with every SETMAP so decisions
        # reach every shard and survive relaunches/promotions.  None =
        # control off -- SETMAPs carry no ctrl key.  The coalescing
        # announcer thread (lazily started by install_ctrl) keeps dark-
        # member connect timeouts off the controller's decision loop.
        self._ctrl: Optional[dict] = None
        self._ctrl_announce_evt = threading.Event()
        self._ctrl_announce_thread: Optional[threading.Thread] = None
        self.smap: Optional[ShardMap] = None
        # epoch fencing (async.fence.enabled, read through the overlays
        # the children will see so controller and children agree): the
        # controller is the epoch minter for its managed shards -- a
        # shard's running epoch is 1 + its slot's supervisor fence count,
        # passed down at spawn and re-announced to the group via SETMAP
        # after every relaunch.  The child additionally bumps past its
        # checkpoint's persisted epoch, so even a controller-less restart
        # mints a fresh incarnation.
        self.fence = bool(overlay_conf.get(FENCE_ENABLED))
        # hot-standby replication (async.ps.standby, read
        # through the same overlays the children see): one warm standby
        # child per managed shard, fed by its primary's REPL stream.
        # Failover becomes PROMOTE-under-the-minted-epoch instead of
        # restart-from-checkpoint -- promotion additionally requires
        # fencing (the epoch IS the safety primitive) and a shard map
        # to re-announce; without either, standbys still serve as read
        # replicas and recovery stays the classic relaunch.
        if standbys is None:
            standbys = int(overlay_conf.get(PS_STANDBY))
        self.standbys = 1 if int(standbys) > 0 else 0
        self.standby_indices = sorted(
            standby_indices if standby_indices is not None
            else self.indices) if self.standbys else []
        self._standby_procs: Dict[int, _ShardProc] = {}
        self._standby_ok: Dict[int, float] = {}
        self._standby_probe_t: Dict[int, float] = {}
        self._standby_gen: Dict[int, int] = {}
        self._promotions: Dict[int, int] = {}
        self.promotions = 0
        # deposed-but-alive primaries (promoted over while partitioned):
        # fenced out of every write path, kept only so stop() reaps them
        self._deposed: List[subprocess.Popen] = []
        # gray-failure detection: the liveness probes below time their
        # round trips into a cohort RTT suspector; a slow-but-alive shard
        # is marked SUSPECT in membership (and surfaced in telemetry)
        # without being killed -- lease expiry alone escalates to DEAD.
        from asyncframework_tpu_torch.net.health import RttSuspector

        self._gray = RttSuspector(
            factor=overlay_conf.get(GRAY_RTT_FACTOR),
            min_ms=overlay_conf.get(GRAY_RTT_MIN_MS),
        )
        # the supervisor, shard edition: one slot per shard, no adoption
        # planning (a PS shard is re-homed by RESTART, not by handing its
        # range to a peer -- the range's durable state lives in its
        # checkpoint).  Port probes feed touch(); pid probes catch local
        # exits between ticks.  async.lease.s / async.suspect.after.s
        # (same overlay discipline as the fence flag) override the ctor's
        # dead_after_s default.
        self.sup = supervisor_mod.ElasticSupervisor(
            self.shards, dead_after_s=dead_after_s,
            check_interval_s=check_interval_s, boot_grace_s=dead_after_s,
            adopt=False, fence=self.fence,
            lease_s=float(overlay_conf.get(LEASE_S)) or None,
            suspect_after_s=float(overlay_conf.get(SUSPECT_AFTER_S))
            or None,
        )
        self._check_interval_s = float(check_interval_s)
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._restart_lock = threading.Lock()
        self._ts_source = None
        # per-slot telemetry endpoints (cluster-observer discovery):
        # "auto" pre-assigns one free port per PRIMARY slot, a dict pins
        # them explicitly.  The slot's port survives relaunches -- every
        # (re)spawn sets it via ASYNCTPU_ASYNC_METRICS_PORT, so the
        # observer's scrape URL for "ps-shard-i" stays valid across a
        # failover.  Standbys get their OWN ports (two processes cannot
        # share one bind), and a PROMOTION hands the standby's port to
        # the slot -- the role name keeps resolving to whoever currently
        # serves the range.
        self.telemetry_ports: Dict[int, int] = {}
        self._standby_tports: Dict[int, int] = {}
        if telemetry_ports == "auto":
            self.telemetry_ports = {
                i: _free_port(self.host) for i in self.indices
            }
            if self.standbys:
                self._standby_tports = {
                    i: _free_port(self.host) for i in self.standby_indices
                }
        elif isinstance(telemetry_ports, dict):
            self.telemetry_ports = {
                int(i): int(p) for i, p in telemetry_ports.items()
            }

    def telemetry_targets(self) -> List[Tuple[str, str, str]]:
        """(name, role, url) scrape targets for the observer: one per
        managed shard slot with an assigned telemetry port."""
        return [
            (f"ps-shard-{i}", "ps",
             f"http://{self.host}:{port}")
            for i, port in sorted(self.telemetry_ports.items())
        ]

    # ------------------------------------------------------------ lifecycle
    def _ckpt_path(self, index: int) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        return os.path.join(self.checkpoint_dir,
                            f"ps_shard{index}.npz")

    def _ckpt_standby_path(self, index: int) -> Optional[str]:
        """Where THIS GENERATION's standby would checkpoint its range
        once promoted.  Per-generation file (the spawn counter is in
        the name): every durable file for a range has exactly ONE
        writer ever -- a mirror never checkpoints while standby, and
        successive promoted incarnations never share a path, so no
        zombie's final save can race or roll back a successor's image."""
        if not self.checkpoint_dir:
            return None
        gen = self._standby_gen.get(index, 0)
        return os.path.join(self.checkpoint_dir,
                            f"ps_shard{index}.standby{gen}.npz")

    def _ckpt_newest_path(self, index: int) -> Optional[str]:
        """The range's FRESHEST durable image for a fallback relaunch:
        after promotions the acting primary persists to its generation's
        standby file, so restoring the original path would silently
        roll the range back past everything merged since the first
        failover.  Candidates are ranked by the image's own (epoch,
        clock) -- mtime alone could prefer a fenced zombie's last
        stale save -- with mtime as the tiebreak/fallback for
        unreadable files."""
        primary = self._ckpt_path(index)
        if not primary:
            return None
        import glob as _glob

        candidates = [p for p in [primary] + sorted(_glob.glob(
            os.path.join(self.checkpoint_dir,
                         f"ps_shard{index}.standby*.npz")))
            if os.path.exists(p)]
        if not candidates:
            return primary

        def rank(path):
            try:
                with np.load(path, allow_pickle=False) as z:
                    meta = json.loads(str(z["__meta__"]))
                return (int(meta.get("epoch", 0)),
                        int(meta.get("clock", 0)),
                        os.path.getmtime(path))
            except Exception:  # noqa: BLE001 - torn/corrupt image
                return (-1, -1, os.path.getmtime(path))

        return max(candidates, key=rank)

    def _child_env(self, index: int, bind_port: int,
                   role: str = "primary") -> Dict[str, str]:
        import dataclasses

        env = dict(self.env)
        env["ASYNC_SHARD_INDEX"] = str(index)
        env["ASYNC_SHARD_COUNT"] = str(self.shards)
        env["ASYNC_SHARD_D"] = str(self.d)
        env["ASYNC_SHARD_N"] = str(self.n)
        env["ASYNC_SHARD_ALGO"] = self.algo
        env["ASYNC_SHARD_BIND_PORT"] = str(bind_port)
        env["ASYNC_SHARD_CFG"] = json.dumps(dataclasses.asdict(self.cfg))
        env["ASYNC_SHARD_ROLE"] = role
        env["ASYNC_SHARD_CKPT"] = (
            (self._ckpt_standby_path(index) if role == "standby"
             else self._ckpt_newest_path(index)) or ""
        )
        env["ASYNC_SHARD_WORKER_PROCS"] = str(self.worker_procs)
        env["ASYNC_SHARD_ELASTIC"] = (
            "1" if self.elastic and role == "primary" else "0"
        )
        env["ASYNC_SHARD_CONF"] = json.dumps(self.conf_overlays)
        env["ASYNC_SHARD_MAP"] = (json.dumps(self.smap.to_wire())
                                  if self.smap is not None else "")
        env["ASYNC_SHARD_EPOCH"] = str(self.epoch_of(index))
        epochs = self.epochs_wire()
        env["ASYNC_SHARD_EPOCHS"] = json.dumps(epochs) if epochs else ""
        sbs = self.standbys_wire() if role == "primary" else None
        env["ASYNC_SHARD_STANDBYS"] = (
            json.dumps(sbs) if sbs and any(sbs) else ""
        )
        mport = (self.telemetry_ports.get(index) if role == "primary"
                 else self._standby_tports.get(index))
        if mport:
            # the slot's pinned telemetry endpoint (observer discovery):
            # conf async.metrics.port's env spelling -- the child's
            # start_telemetry_from_conf lights it up.  Standbys bind
            # their own port; a promotion hands it to the slot (see
            # _promote).
            env["ASYNCTPU_ASYNC_METRICS_PORT"] = str(mport)
        return env

    def epoch_of(self, index: int) -> int:
        """The fencing epoch shard ``index`` currently runs at (0 =
        fencing off): base epoch 1 plus one bump per lease-expiry/exit
        fence the supervisor declared for its slot."""
        if not self.fence:
            return 0
        return 1 + self.sup.epoch_of(index)

    def epochs_wire(self) -> Optional[List[int]]:
        """The whole group's epoch vector in range order (None with
        fencing off); unmanaged shards sit at their base epoch unless
        their own restarts bump them -- their minting rides their
        checkpoints, not this controller."""
        if not self.fence:
            return None
        return [self.epoch_of(i) for i in range(self.shards)]

    def _spawn(self, index: int, bind_port: int,
               role: str = "primary") -> dict:
        standby = role == "standby"
        if standby:
            # per-generation identity (names this life's post-promotion
            # checkpoint file -- see _ckpt_standby_path)
            self._standby_gen[index] = (
                self._standby_gen.get(index, 0) + 1)
        rec = (self._standby_procs if standby else self._procs)[index]
        stderr = subprocess.DEVNULL
        if self.stderr_dir:
            # crash forensics: each life of each shard appends to its own
            # log
            os.makedirs(self.stderr_dir, exist_ok=True)
            suffix = "-standby" if standby else ""
            stderr = open(os.path.join(
                self.stderr_dir,
                f"shard{index}{suffix}.stderr.log"), "a")
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "asyncframework_tpu_torch.parallel.shardgroup"],
            env=self._child_env(index, bind_port, role=role),
            stdout=subprocess.PIPE, stderr=stderr, text=True,
        )
        if stderr is not subprocess.DEVNULL:
            stderr.close()  # the child owns the fd now
        rec.attach(proc)
        if not standby:
            # register the relaunch IMMEDIATELY -- pid + /proc start time
            # land under the supervisor lock the moment the child exists,
            # not after its (possibly long) announce wait.  Otherwise the
            # slot stays DEAD for the whole spawn and a concurrent scan
            # (check_once is public) could schedule a SECOND spawn for the
            # same shard, killing the fresh child.  _restart's membership
            # guard is the other half of the fix.
            self.sup.register(f"ps-shard-{index}", [index], pid=proc.pid,
                              host=socket.gethostname())
        line = rec.next_line(0, self.spawn_timeout_s)
        if line is None:
            proc.kill()
            raise RuntimeError(
                f"PS shard {index} {role} did not announce within "
                f"{self.spawn_timeout_s:.0f}s"
            )
        hello = json.loads(line)
        rec.port = int(hello["port"])
        if standby:
            self._standby_ok[index] = time.monotonic()
        return hello

    def start(self) -> "ShardGroup":
        try:
            # the children start together, primaries and warm standbys
            # alike (each one's interpreter and device start-up overlap),
            # and each announces its port.  A standby is announced to its
            # primary via SETMAP below; a failed standby spawn degrades
            # that shard to the classic restart recovery -- it never
            # fails the group.
            errors: List[BaseException] = []
            if self.standbys:
                for i in self.standby_indices:
                    self._standby_procs[i] = _ShardProc(i)

            def spawn(i: int, role: str) -> None:
                try:
                    self._spawn(i, 0, role=role)
                except (RuntimeError, OSError) as e:
                    if role == "standby":
                        _bump("standby_spawn_failures")
                        self._standby_procs.pop(i, None)
                    else:
                        errors.append(e)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            spawners = [threading.Thread(target=spawn,
                                         args=(i, "primary"),
                                         name=f"shard-{i}-spawn",
                                         daemon=True)
                        for i in self.indices]
            spawners += [threading.Thread(target=spawn,
                                          args=(i, "standby"),
                                          name=f"shard-{i}-standby-spawn",
                                          daemon=True)
                         for i in list(self._standby_procs)]
            for t in spawners:
                t.start()
            for t in spawners:
                t.join()
            if errors:
                raise errors[0]
            if self.shards > 1:
                entries = []
                for i, (lo, hi) in enumerate(self._ranges):
                    if i in self._procs:
                        entries.append(
                            (self.host, self._procs[i].port, lo, hi))
                    else:
                        fh, fp = self.fixed_entries[i]
                        entries.append((fh, int(fp), lo, hi))
                self.smap = ShardMap(entries)
                # hand every managed child the assembled map (it answers
                # SHARDMAP / HELLO from it); unmanaged shards get it from
                # their own launcher
                for i in self.indices:
                    self._setmap(i)
            elif self.standbys and self._standby_procs:
                # shards=1 control arm: no map, but the single child
                # still learns its standby endpoint (read replica +
                # replicated state; failover for the unmapped single PS
                # stays restart-from-checkpoint -- there is no map to
                # re-announce a moved endpoint through)
                for i in self.indices:
                    self._setmap(i)
        except Exception:
            # a later spawn, map assembly, or SETMAP failed: the children
            # already up must not be leaked (the caller's `group` variable
            # was never assigned, so its cleanup path cannot reach them)
            for rec in list(self._procs.values()) + list(
                    self._standby_procs.values()):
                if rec.proc is not None and rec.proc.poll() is None:
                    rec.proc.kill()
            raise
        self._monitor = threading.Thread(
            target=self._run, name="shard-group-monitor", daemon=True
        )
        self._monitor.start()
        # continuous telemetry: per-range availability becomes the
        # ``ps_shards.*`` series each sampler tick -- the
        # shard_availability SLO rule's input surface
        from asyncframework_tpu_torch.metrics import timeseries as _ts

        self._ts_source = self._telemetry_source
        _ts.register_source("ps_shards", self._ts_source)
        _set_active_group(self)
        return self

    def standbys_wire(self) -> Optional[List]:
        """Per-shard standby endpoints in range order (``[host, port]``
        or None per entry; None overall when the standby plane is off).
        What SETMAP installs and SHARDMAP advertises."""
        if not self.standbys:
            return None
        out: List = []
        for i in range(self.shards):
            rec = self._standby_procs.get(i)
            alive = (rec is not None and rec.port is not None
                     and rec.proc is not None and rec.proc.poll() is None)
            out.append([self.host, rec.port] if alive else None)
        return out

    def install_ctrl(self, wire: dict) -> None:
        """Adaptive-control decision fan-out (parallel/controller.py):
        store the CTRL payload and re-SETMAP it to every member next to
        the map/epochs/standbys.  The STORE is what makes decisions
        survive failover -- a relaunched shard's boot SETMAP and a
        promoted standby's re-announce both carry the group's current
        ctrl, and each member's monotone (ep, seq) install refuses
        anything stale.

        The announce runs on a lazily-started coalescing thread (the
        relaycast offer-thread discipline): a dark/partitioned member's
        per-target connect timeout must burn the announcer, never the
        controller's decision loop -- which is busiest exactly when a
        member is dark.  Back-to-back decisions coalesce into one sweep
        carrying the newest ctrl."""
        self._ctrl = dict(wire)
        if self._ctrl_announce_thread is None:
            import threading as _threading

            from asyncframework_tpu_torch.utils.threads import guarded

            def _announce_loop() -> None:
                while not self._stop.is_set():
                    if not self._ctrl_announce_evt.wait(timeout=0.5):
                        continue
                    self._ctrl_announce_evt.clear()
                    self._announce_group()

            self._ctrl_announce_thread = _threading.Thread(
                target=guarded(_announce_loop),
                name="shardgroup-ctrl-announce", daemon=True)
            self._ctrl_announce_thread.start()
        self._ctrl_announce_evt.set()

    def _setmap(self, index: int) -> None:
        hdr = {"op": "SETMAP", "index": index,
               "shards": (self.smap.to_wire()
                          if self.smap is not None else [])}
        epochs = self.epochs_wire()
        if epochs:
            hdr["epochs"] = epochs
        sbs = self.standbys_wire()
        if sbs is not None:
            hdr["standbys"] = sbs
        if self._ctrl is not None:
            hdr["ctrl"] = self._ctrl
        _oneshot(self.host, self._procs[index].port, hdr, timeout_s=10.0)

    def _announce_group(self, timeout_s: float = 3.0) -> None:
        """Best-effort SETMAP of the CURRENT map + epoch vector +
        standby endpoints to every reachable member (unmanaged fixed
        entries included -- an in-process primary serves every worker
        HELLO, so it above all must hand out current state).  This is
        where a promotion or a standby respawn actually reaches the wire;
        a still-partitioned member self-
        heals later via fencing.  The per-target timeout is kept SHORT:
        this runs on the monitor thread, and a partitioned member must
        cost seconds, not stall the next death scan for 10s a target."""
        epochs = self.epochs_wire()
        sbs = self.standbys_wire()
        if self.smap is not None:
            targets = [(j, h, p)
                       for j, (h, p, _lo, _hi)
                       in enumerate(self.smap.entries)]
        else:
            targets = [(i, self.host, rec.port)
                       for i, rec in self._procs.items()
                       if rec.port is not None]
        for j, h, p in targets:
            hdr = {"op": "SETMAP", "index": j,
                   "shards": (self.smap.to_wire()
                              if self.smap is not None else [])}
            if epochs:
                hdr["epochs"] = epochs
            if sbs is not None:
                hdr["standbys"] = sbs
            if self._ctrl is not None:
                # adaptive-control decisions survive relaunch AND
                # promotion: every re-announce re-installs the group's
                # current CTRL next to the map and epoch vector
                hdr["ctrl"] = self._ctrl
            try:
                _oneshot(h, p, hdr, timeout_s=timeout_s)
            except (ConnectionError, OSError):
                pass

    def _telemetry_source(self) -> Dict[str, float]:
        member = self.sup.membership()
        dark = sum(1 for i in self._procs
                   if member.get(i, {}).get("state") == supervisor_mod.DEAD)
        suspect = sum(
            1 for i in self._procs
            if member.get(i, {}).get("state") == supervisor_mod.SUSPECT
        )
        totals = shard_totals()
        live_standbys = sum(
            1 for rec in self._standby_procs.values()
            if rec.proc is not None and rec.proc.poll() is None
        )
        return {
            "total": float(self.shards),
            "managed": float(len(self._procs)),
            "dark_ranges": float(dark),
            "suspect_ranges": float(suspect),
            "live": float(self.shards - dark),
            "restarts": float(totals.get("shards_restarted", 0)),
            "fence_epoch_bumps": float(
                totals.get("fence_epoch_bumps", 0)),
            "standbys": float(live_standbys),
            "promotions": float(self.promotions),
            "done": float(self._finished.is_set()),
        }

    # ------------------------------------------------------------- monitor
    def _probe(self, index: int) -> bool:
        """One liveness probe: a SHARDMAP round trip against the shard's
        pinned port.  Success feeds the supervisor's contact signal (the
        lease renewal) AND the gray-failure RTT suspector: a shard that
        answers, but at a multiple of its cohort's round trip, is marked
        SUSPECT -- surfaced in membership/telemetry, never killed on
        latency alone."""
        endpoint = f"{self.host}:{self._procs[index].port}"
        t0 = time.monotonic()
        try:
            _oneshot(self.host, self._procs[index].port,
                     {"op": "SHARDMAP"}, timeout_s=1.0)
        except (ConnectionError, OSError):
            return False
        if self._gray.observe(endpoint, (time.monotonic() - t0) * 1e3):
            self.sup.suspect(index)
        else:
            self.sup.unsuspect(index)
        self.sup.touch(index, f"ps-shard-{index}")
        return True

    def check_once(self) -> List[int]:
        """One monitor scan (public for deterministic tests): probe every
        managed shard, let the supervisor declare deaths (pid exit or
        probe silence), restart the dead from their checkpoints.  Shards
        still DEAD from an earlier failed relaunch are retried every scan
        (the supervisor reports a death once; the restart loop must not
        strand the range on one unlucky spawn)."""
        for i in self._procs:
            self._probe(i)
        newly_dead = [i for i in self.sup.check_once() if i in self._procs]
        for i in newly_dead:
            _bump("shard_deaths")
            # a dead member's frozen RTT EWMA must leave the cohort:
            # left in, it skews every later suspicion median
            self._gray.forget(f"{self.host}:{self._procs[i].port}")
            self._restart(i)
        member = self.sup.membership()
        for i in self._procs:
            if (i not in newly_dead
                    and member.get(i, {}).get("state")
                    == supervisor_mod.DEAD):
                self._restart(i)
        if self.standbys:
            self._check_standbys()
        return newly_dead

    def _run(self) -> None:
        while not self._stop.wait(self._check_interval_s):
            if self._finished.is_set():
                continue  # post-done exits are teardown, not death
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 - the monitor must outlive
                pass           # any one bad scan (spawn failure, junk IO)

    def _check_standbys(self) -> None:
        """Standby liveness, OUTSIDE the fencing supervisor: a standby
        owns no range, so its death mints no epoch -- it is simply
        respawned, and its primary's stream re-bootstraps it with a
        fresh REPL_SYNC on reconnect.  Runs on the monitor thread, so
        its network work is bounded: probes are PACED (a dark standby's
        1 s timeout must not recur every 0.25 s scan and delay the next
        PRIMARY death scan -- the gap this module exists to bound)."""
        now = time.monotonic()
        if self._stop.is_set() or self._finished.is_set():
            return
        dead_after_s = self.sup.dead_after_ms / 1e3
        probe_gap_s = max(0.5, self._check_interval_s)
        for i in self.standby_indices:
            rec = self._standby_procs.get(i)
            if rec is None:
                # a promotion (or an earlier failed spawn) left this
                # shard un-backed: recreate the slot and try again
                self._standby_procs[i] = rec = _ShardProc(i)
            proc = rec.proc
            if proc is not None and proc.poll() is None:
                if now - self._standby_probe_t.get(i, 0.0) < probe_gap_s:
                    continue  # paced: this scan skips the probe
                self._standby_probe_t[i] = now
                orphaned = False
                try:
                    hdr = _oneshot(self.host, rec.port,
                                   {"op": "SHARDMAP"}, timeout_s=1.0)
                    # a registered standby that no longer ANSWERS as one
                    # is a self-promoted orphan (a PROMOTE was delivered
                    # but its reply timed out, so the controller fell
                    # back to a relaunch): it would wedge the acting
                    # primary's stream with 'not a standby' forever --
                    # reap and respawn a real standby behind it
                    if hdr.get("standby"):
                        self._standby_ok[i] = now
                        continue
                    orphaned = True
                    _bump("standby_orphans_reaped")
                except (ConnectionError, OSError):
                    pass
                if (not orphaned
                        and now - self._standby_ok.get(i, now)
                        <= dead_after_s):
                    continue  # one dark probe is not death
                try:
                    proc.kill()
                    proc.wait(timeout=5.0)
                except OSError:  # pragma: no cover
                    pass
            if proc is not None:
                _bump("standby_deaths")
            try:
                self._spawn(i, 0, role="standby")
            except (RuntimeError, OSError):
                _bump("standby_spawn_failures")
                continue
            _bump("standbys_respawned")
            # the shard's primary must re-target its stream, and every
            # SHARDMAP reply must advertise the new endpoint
            self._announce_group()

    def promotions_of(self, index: int) -> int:
        return self._promotions.get(index, 0)

    def _promote(self, index: int) -> bool:
        """Hot-standby promotion: the shard's warm standby becomes the
        range primary under the slot's freshly-minted fencing epoch --
        no process spawn, no checkpoint replay on the recovery path;
        the availability gap is the suspicion time plus one RPC.
        Returns False when the promotion path is unavailable (standby
        plane off, fencing off, no map to re-announce the moved
        endpoint through, standby dead) -- the caller falls back to
        restart-from-checkpoint."""
        sb = self._standby_procs.get(index)
        if (not self.standbys or not self.fence or self.smap is None
                or sb is None or sb.proc is None
                or sb.proc.poll() is not None or sb.port is None):
            return False
        new_epoch = self.epoch_of(index)  # the death already minted it
        entries = [list(e) for e in self.smap.entries]
        entries[index] = [self.host, sb.port,
                          entries[index][2], entries[index][3]]
        new_map = ShardMap(entries)
        epochs = self.epochs_wire()
        try:
            rep = _oneshot(self.host, sb.port,
                           {"op": "PROMOTE", "epoch": new_epoch,
                            "index": index, "shards": new_map.to_wire(),
                            "epochs": epochs}, timeout_s=10.0)
        except (ConnectionError, OSError):
            _bump("promotion_failures")
            return False
        if rep.get("op") != "ACK":
            # refused (a stale order against a fresh mirror): fall back
            # to the relaunch path rather than install a map pointing
            # at a member that never flipped
            _bump("promotion_failures")
            return False
        old = self._procs[index]
        if old.proc is not None and old.proc.poll() is None:
            # a PARTITIONED-but-alive primary is deliberately NOT
            # killed here: promotion needs nothing it holds (the
            # standby serves on its own port), and cross-host the
            # controller could not reach it anyway -- the minted epoch
            # deposes it the moment its stream append (or any stamped
            # op) bounces REJECT_FENCED at the promoted member.  It is
            # only retained for teardown reaping.
            self._deposed.append(old.proc)
        self._gray.forget(f"{self.host}:{old.port}")
        promoted = sb
        del self._standby_procs[index]
        self._standby_ok.pop(index, None)
        promoted.restarts = old.restarts
        self._procs[index] = promoted
        self.smap = new_map
        self.promotions += 1
        self._promotions[index] = self._promotions.get(index, 0) + 1
        _bump("standby_promotions")
        _flight.note("promote", shard=int(index),
                     epoch=self.epoch_of(index))
        # telemetry-port handoff: the promoted member serves its OWN
        # (ex-standby) port; the dead primary's pre-assigned port would
        # otherwise read DOWN forever in the fleet view.  The fresh
        # standby spawned below gets a new port of its own.
        sb_port = self._standby_tports.pop(index, None)
        if sb_port is not None:
            self.telemetry_ports[index] = sb_port
            self._standby_tports[index] = _free_port(self.host)
        else:
            self.telemetry_ports.pop(index, None)
        # the minted epoch reaches the wire through the announce below
        # -- the same accounting point as the fenced relaunch path
        _bump("fence_epoch_bumps")
        supervisor_mod.bump_total("epoch_bumps")
        self.sup.register(f"ps-shard-{index}", [index],
                          pid=promoted.proc.pid,
                          host=socket.gethostname())
        # a fresh standby behind the new primary (best-effort: a failed
        # spawn leaves the shard un-backed until the next scan retries)
        self._standby_procs[index] = _ShardProc(index)
        try:
            self._spawn(index, 0, role="standby")
        except (RuntimeError, OSError):
            _bump("standby_spawn_failures")
            del self._standby_procs[index]
        # group-wide announce: every member re-learns map + epochs +
        # standbys; workers/replicas re-resolve on their next fault
        self._announce_group()
        return True

    def _restart(self, index: int) -> None:
        """Re-home a dead shard: PROMOTE its warm standby when the
        replication plane is on (failover without a restart), else kill
        the corpse if the pid is somehow still holding the port
        (wedged, not exited) and relaunch on the SAME port from the
        durable checkpoint.  Live shards never stop serving their
        ranges meanwhile."""
        with self._restart_lock:
            if self._stop.is_set() or self._finished.is_set():
                return
            rec = self._procs[index]
            proc = rec.proc
            # double-spawn guard (the other half of _spawn's early
            # registration): a concurrent scan that queued behind this
            # lock while a relaunch was in flight must NOT kill the
            # fresh child and spawn a second one -- if the slot is no
            # longer DEAD (the relaunch registered its pid the moment
            # it was Popen'd) and its process is alive, there is
            # nothing left to recover.
            state = self.sup.membership().get(index, {}).get("state")
            if (state != supervisor_mod.DEAD
                    and proc is not None and proc.poll() is None):
                return
            if proc is not None and proc.poll() == 0:
                # graceful conclusion (DONE/FINISH reached, result printed,
                # exit 0), not a crash: nothing to recover -- restarting
                # would resurrect a finished shard into a run that is over
                return
            if rec.restarts >= self.max_restarts:
                return  # gave up on this range; counted at each failure
            if self._promote(index):
                # failover WITHOUT a restart: the standby took the
                # range under the minted epoch -- no spawn, no
                # checkpoint replay, availability gap = suspicion time
                return
            if not self._ckpt_path(index):
                # no durable state: the relaunch serves a FRESH (zero)
                # model for this range mid-run.  Still better than a dark
                # range, but it must never happen silently -- convergence
                # for the range restarts from scratch.
                _bump("restarts_uncheckpointed")
                print(f"shard-group: restarting shard {index} WITHOUT a "
                      f"checkpoint (no checkpoint_dir) -- its model "
                      f"range resets to zero", file=sys.stderr, flush=True)
            if proc is not None and proc.poll() is None:
                try:
                    proc.kill()
                    proc.wait(timeout=10.0)
                except OSError:  # pragma: no cover
                    pass
            rec.restarts += 1
            try:
                hello = self._spawn(index, rec.port)
            except (RuntimeError, OSError):
                _bump("restart_failures")
                return
            if self._stop.is_set() or self._finished.is_set():
                # stop()/finish() raced this relaunch while _spawn was
                # blocking on the announce line: the fresh child would be
                # an orphan nobody terminates -- reap it here
                if rec.proc is not None and rec.proc.poll() is None:
                    rec.proc.kill()
                return
            _bump("shards_restarted")
            _flight.note("shard_restart", shard=int(index),
                         restarts=rec.restarts)
            # the child announces what it recovered: resumed_from is the
            # checkpointed k it came back at (None = fresh model, e.g.
            # death before the first cadence checkpoint)
            rec.resumed_from = hello.get("resumed_from")
            if self.fence and self.smap is not None:
                # announce the bumped epoch vector to every reachable
                # member: WELCOME hands NEW workers current epochs, and
                # existing clients converge via MODEL ep stamps /
                # REJECT_FENCED verdicts either way -- best-effort by
                # design (a still-partitioned member self-heals later).
                # This is where a fencing epoch actually reaches the wire,
                # so it is also where recovery.epoch_bumps counts.
                _bump("fence_epoch_bumps")
                supervisor_mod.bump_total("epoch_bumps")
                self._announce_group()

    # ------------------------------------------------------------ plumbing
    def port_of(self, index: int) -> int:
        return self._procs[index].port

    def pid_of(self, index: int) -> int:
        return self._procs[index].proc.pid

    def restarts_of(self, index: int) -> int:
        return self._procs[index].restarts

    def result_of(self, index: int, timeout_s: float) -> Optional[dict]:
        """The child's result JSON line (the line after its hello);
        None on timeout."""
        line = self._procs[index].next_line(1, timeout_s)
        return json.loads(line) if line else None

    def final_result_of(self, index: int,
                        timeout_s: float) -> Optional[dict]:
        """The child's counts after its last apply (the line after its
        result, printed once it is told to stop: :meth:`stop` first);
        None on timeout."""
        line = self._procs[index].next_line(2, timeout_s)
        return json.loads(line) if line else None

    def standby_result_of(self, index: int,
                          timeout_s: float) -> Optional[dict]:
        """Shard ``index``'s current standby's result JSON line (printed
        once it learns DONE: FINISH); None without a standby or on
        timeout."""
        rec = self._standby_procs.get(index)
        if rec is None or rec.proc is None:
            return None
        line = rec.next_line(1, timeout_s)
        return json.loads(line) if line else None

    def status(self) -> Dict[int, dict]:
        member = self.sup.membership()
        out = {}
        for i, rec in self._procs.items():
            proc = rec.proc
            out[i] = {
                "port": rec.port,
                "pid": proc.pid if proc is not None else None,
                "alive": proc is not None and proc.poll() is None,
                "restarts": rec.restarts,
                "state": member.get(i, {}).get("state"),
            }
        return out

    def finish(self) -> None:
        """Broadcast FINISH to every shard (idempotent): the primary's
        DONE becomes group-wide, secondaries' wait_done returns, and the
        monitor stops treating exits as deaths."""
        self._finished.set()
        if self.smap is not None:
            targets = [(h, p) for (h, p, _lo, _hi) in self.smap.entries]
        else:  # shards=1 control group: no map, but the child still FINISHes
            targets = [(self.host, rec.port)
                       for rec in self._procs.values()
                       if rec.port is not None]
        # standbys learn DONE too (their mirrored k may sit just short
        # of the finish when the stream lags the final merges)
        targets += [(self.host, rec.port)
                    for rec in self._standby_procs.values()
                    if rec.port is not None]
        for (h, p) in targets:
            try:
                finish_endpoint(h, p)
            except (ConnectionError, OSError):
                pass

    def status_section(self) -> dict:
        """The /api/status ``shards`` section: map + per-shard liveness,
        fencing epochs, and the gray-failure RTT view."""
        totals = shard_totals()
        out = {
            "shards": self.shards,
            "map": self.smap.to_wire() if self.smap is not None else None,
            "deaths": totals.get("shard_deaths", 0),
            "restarts": totals.get("shards_restarted", 0),
            "done": self._finished.is_set(),
            "members": {str(i): st for i, st in self.status().items()},
        }
        if self.standbys:
            out["standbys"] = self.standbys_wire()
            out["promotions"] = self.promotions
        if self.fence:
            out["epochs"] = self.epochs_wire()
        gray = self._gray.snapshot()
        if gray:
            out["rtt"] = gray
        return out

    def stop(self, timeout_s: float = 15.0) -> None:
        _set_active_group(None, only_if=self)
        self._stop.set()
        self._finished.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        self.sup.stop()
        if self._ts_source is not None:
            from asyncframework_tpu_torch.metrics import timeseries as _ts

            _ts.unregister_source("ps_shards", self._ts_source)
        procs = [rec.proc for rec in
                 list(self._procs.values())
                 + list(self._standby_procs.values())
                 if rec.proc is not None]
        procs += self._deposed
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout_s
        for proc in procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


# -------------------------------------------------------- in-process groups
def secondary_cfg(cfg):
    """The cfg a NON-primary shard runs: no wave gate (``bucket_ratio=0``
    -- cohorts are the primary's job) and an unbounded iteration budget
    (a secondary must never self-finish on its own accept count; the
    primary's DONE arrives as FINISH)."""
    import dataclasses

    return dataclasses.replace(cfg, bucket_ratio=0.0,
                               num_iterations=2**31 - 1)


def launch_inprocess_group(cfg, d: int, n: int, shards: int,
                           device=None, host: str = "127.0.0.1",
                           algo: str = "asgd",
                           checkpoint_dir: Optional[str] = None,
                           supervisor=None, bus=None):
    """Test/bench helper: the shard group as in-process
    ``ParameterServer`` instances on ephemeral loopback ports.  Returns
    ``(ps_list, shard_map)``; ``shards=1`` returns the classic single PS
    (``shard_map=None``) -- the byte-identity baseline.  Callers stop
    every returned PS."""
    from asyncframework_tpu_torch.parallel.ps_dcn import ParameterServer

    def ckpt(i):
        if not checkpoint_dir:
            return None
        return os.path.join(checkpoint_dir, f"ps_shard{i}.npz")

    if shards <= 1:
        ps = ParameterServer(cfg, d, n, device=device, port=0, algo=algo,
                             checkpoint_path=ckpt(0),
                             supervisor=supervisor, bus=bus).start()
        return [ps], None
    if algo != "asgd":
        raise ValueError("sharded PS groups support algo='asgd' only")
    ranges = shard_ranges(d, shards)
    ps_list = []
    for i, (lo, hi) in enumerate(ranges):
        shard_cfg = cfg if i == 0 else secondary_cfg(cfg)
        ps_list.append(ParameterServer(
            shard_cfg, hi - lo, n, device=device, port=0, algo=algo,
            checkpoint_path=ckpt(i),
            supervisor=supervisor if i == 0 else None,
            bus=bus if i == 0 else None,
            shard_index=i,
        ))
    smap = ShardMap([
        (host, ps.port, lo, hi)
        for ps, (lo, hi) in zip(ps_list, ranges)
    ])
    for ps in ps_list:
        ps.shard_map = smap.to_wire()
    if any(p.epoch for p in ps_list):
        # fencing on (each PS minted its conf-derived epoch): hand every
        # member the group's epoch vector so WELCOME/SHARDMAP carry it
        epochs = [p.epoch for p in ps_list]
        for ps in ps_list:
            ps.shard_epochs = epochs
    # start secondaries first, primary LAST: the primary's ``ps`` rolling
    # telemetry source registration must win (last wins by design)
    for ps in reversed(ps_list):
        ps.start()
    return ps_list, smap


# ------------------------------------------------------------- shard child
class CtrlFanout:
    """Adaptive-control decision fan-out, controller-less edition (the
    k8s shard manifests): no :class:`ShardGroup` owns the children --
    the Deployment controller restarts pods -- so the primary's
    AsyncController hands decisions here and every OTHER map entry gets
    a SETMAP re-announcing the static map + the CTRL payload.  Same
    duck type as ShardGroup.install_ctrl; receivers' monotone (ep, seq)
    install makes re-delivery harmless.

    The sends run on a lazily-started coalescing thread (the same
    discipline ShardGroup.install_ctrl uses): a dark member's connect
    timeout burns the announcer, never the controller's decision loop.
    Back-to-back decisions coalesce into one sweep of the newest wire."""

    def __init__(self, ps):
        self.ps = ps
        self._wire: Optional[dict] = None
        self._evt = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def install_ctrl(self, wire: dict) -> None:
        self._wire = dict(wire)
        if self._thread is None:
            from asyncframework_tpu_torch.utils.threads import guarded

            self._thread = threading.Thread(
                target=guarded(self._loop), name="ctrl-fanout",
                daemon=True)
            self._thread.start()
        self._evt.set()

    def stop(self) -> None:
        self._stop.set()
        self._evt.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._evt.wait(timeout=0.5):
                continue
            self._evt.clear()
            if self._stop.is_set():
                return
            self._sweep()

    def _sweep(self) -> None:
        wire = self._wire
        if wire is None:
            return
        smap = self.ps.shard_map or []
        epochs = self.ps.shard_epochs
        for j, entry in enumerate(smap):
            if j == self.ps.shard_index:
                continue
            hdr = {"op": "SETMAP", "index": j, "shards": smap,
                   "ctrl": wire}
            if epochs:
                hdr["epochs"] = epochs
            try:
                _oneshot(str(entry[0]), int(entry[1]), hdr,
                         timeout_s=3.0)
            except (ConnectionError, OSError):
                pass  # a dark shard re-learns ctrl from the next send


def _quiesce(ps, timeout_s: float = 5.0, settle_s: float = 0.05) -> None:
    """Wait, at most ``timeout_s``, until every push ``ps`` has counted
    is applied (accepted or dropped) and no push has come for
    ``settle_s``."""
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        pushes = int(sum(ps.pushes_by_wid.values()))
        now = (pushes, ps.accepted + ps.dropped)
        if now == last and pushes == now[1]:
            return
        last = now
        time.sleep(settle_s)


def _child_main() -> int:
    """Env-driven shard process entry (``python -m
    asyncframework_tpu_torch.parallel.shardgroup``): the role
    :class:`ShardGroup` spawns.  Its device is ``PS_DEVICE`` (``cuda``,
    the default, or ``cpu``), as ``tools/ps_child.py`` takes it.

    Announces ``{"port", "shard", "resumed_from"}`` as the first stdout
    line, serves its range until DONE/FINISH, prints a result line, then
    KEEPS SERVING until the controller tears it down (SIGTERM): after the
    primary's DONE the plane is still draining -- worker eval rounds fan
    SNAPSHOTS over every range, pipelined workers reap their last pull
    round -- so a shard that exits at DONE yanks its range out from under
    them.  A non-zero / signal exit before FINISH is what the controller
    treats as death."""
    import signal

    from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf

    term = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: term.set())

    overlays = os.environ.get("ASYNC_SHARD_CONF")
    if overlays:
        set_global_conf(AsyncConf(json.loads(overlays)))
    import torch

    from asyncframework_tpu_torch.parallel.ps_dcn import ParameterServer
    from asyncframework_tpu_torch.solvers import SolverConfig

    index = int(os.environ["ASYNC_SHARD_INDEX"])
    count = int(os.environ["ASYNC_SHARD_COUNT"])
    d = int(os.environ["ASYNC_SHARD_D"])
    n = int(os.environ["ASYNC_SHARD_N"])
    algo = os.environ.get("ASYNC_SHARD_ALGO", "asgd")
    if count > 1 and algo != "asgd":
        print(json.dumps({"error": "sharded PS groups are ASGD-only"}),
              flush=True)
        return 2
    device = torch.device(os.environ.get("PS_DEVICE", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = SolverConfig(**json.loads(os.environ["ASYNC_SHARD_CFG"]))
    lo, hi = shard_ranges(d, count)[index]
    shard_cfg = cfg if index == 0 else secondary_cfg(cfg)
    map_env = os.environ.get("ASYNC_SHARD_MAP") or ""
    smap_wire = json.loads(map_env) if map_env else None
    # hot-standby role: a standby child runs the SAME cfg as the shard
    # it shadows (post-promotion behavior must match), applies its
    # primary's replication stream instead of worker pushes, and never
    # runs the worker supervisor (after a promotion, membership rebuilds
    # from live traffic via implicit registration).
    role = os.environ.get("ASYNC_SHARD_ROLE", "primary")
    standby = role == "standby"
    sup = None
    if (index == 0 and not standby
            and os.environ.get("ASYNC_SHARD_ELASTIC") == "1"):
        from asyncframework_tpu_torch.parallel.supervisor import (
            ElasticSupervisor,
        )

        sup = ElasticSupervisor.from_conf(cfg.num_workers)
    # per-shard telemetry endpoint (async.metrics.port; -1 = off): the
    # scrape label set carries the shard index so per-shard series do not
    # collapse into one another in an aggregator
    from asyncframework_tpu_torch.metrics.live import (
        start_telemetry_from_conf,
    )

    start_telemetry_from_conf(
        f"ps-{'standby' if standby else 'shard'}-{index}",
        labels={"shard": str(index)})
    # fencing epoch: the controller passes the minted epoch (base 1 + its
    # lease-expiry fences for this slot); 0/absent defers to conf
    # (async.fence.enabled -> 1, off -> 0).  The PS restore additionally
    # bumps past the checkpointed epoch, so every incarnation runs at a
    # fresh epoch.
    epoch_env = int(os.environ.get("ASYNC_SHARD_EPOCH") or 0)
    epochs_env = os.environ.get("ASYNC_SHARD_EPOCHS") or ""
    shard_epochs = json.loads(epochs_env) if epochs_env else None
    ps = ParameterServer(
        shard_cfg, hi - lo, n, device=device,
        port=int(os.environ.get("ASYNC_SHARD_BIND_PORT", "0")),
        algo=algo,
        checkpoint_path=os.environ.get("ASYNC_SHARD_CKPT") or None,
        supervisor=sup,
        shard_map=smap_wire, shard_index=index,
        epoch=epoch_env or None, shard_epochs=shard_epochs or None,
        standby=standby,
    )
    # adaptive asynchrony controller on the PRIMARY shard
    # (async.control.enabled): closes the telemetry->knobs loop with
    # decisions fanned to the other map entries via CtrlFanout.  Started
    # BEFORE ps.start() so the very first WELCOME served already carries
    # the CTRL payload -- a worker that HELLOs in the gap would never
    # build a ControlSink.
    controller = None
    ctrl_fanout = None
    from asyncframework_tpu_torch.conf import CONTROL_ENABLED, global_conf

    if index == 0 and not standby and global_conf().get(CONTROL_ENABLED):
        from asyncframework_tpu_torch.parallel.controller import (
            AsyncController,
        )

        if smap_wire:
            ctrl_fanout = CtrlFanout(ps)
        controller = AsyncController(ps, group=ctrl_fanout).start()
    ps.start()
    sbs_env = os.environ.get("ASYNC_SHARD_STANDBYS") or ""
    if sbs_env and not standby:
        # launcher-known standby endpoints (a controller-less launch,
        # where no SETMAP sends them): installs the map and starts this
        # primary's replication stream
        ps.set_standby_map(json.loads(sbs_env))
    print(json.dumps({"port": ps.port, "shard": index, "role": role,
                      "resumed_from": ps.resumed_from_k,
                      "epoch": ps.epoch}), flush=True)
    print(f"shard {index} ({role}) serving on {ps.port}",
          file=sys.stderr, flush=True)
    ok = ps.wait_done(timeout_s=cfg.run_timeout_s)
    result = {
        "role": "ps-standby" if standby and not ps.promoted
        else "ps-shard", "shard": index, "done": bool(ok),
        "accepted": ps.accepted, "dropped": ps.dropped,
        "clock": ps._clock, "max_staleness": ps.max_staleness,
        "dedup_hits": ps.dedup_hits,
        "resumed_from": ps.resumed_from_k,
        "promoted": bool(ps.promoted),
        "epoch": ps.epoch,
        "fenced_rejects": ps.fenced_rejects,
        "pushes": int(sum(ps.pushes_by_wid.values())),
        "merge_batches": ps.merge_batches,
        "merge_merged": ps.merge_merged,
        "push_bytes": ps.push_bytes,
        "pull_model_bytes": ps.pull_model_bytes,
        "pull_replies": dict(ps.pull_replies),
        "staleness_counts": {str(t): c
                             for t, c in sorted(ps.staleness_counts.items())},
        "peak_device_bytes": (int(torch.cuda.max_memory_allocated(device))
                              if device.type == "cuda" else 0),
        "wire_bytes": {k: int(v) for k, v in _frame.bytes_totals().items()
                       if k in ("sent", "recv", "sent.REPL_APPEND",
                                "sent.REPL_SYNC")},
        "accepted_by_wid": {str(w): c
                            for w, c in ps.accepted_by_wid.items()},
    }
    if index == 0 and (not standby or ps.promoted):
        # the primary's end-of-run eval plane -- a never-promoted
        # standby must not sit a collect_eval timeout for EVAL_RESULTs
        # that only ever go to the real primary
        nproc = int(os.environ.get("ASYNC_SHARD_WORKER_PROCS", "0"))
        traj = None
        if nproc > 0:
            total = ps.collect_eval(nproc, timeout_s=60.0)
            if total is not None:
                times, _W = ps.snapshot_stack()
                # worker-side assembled stacks are tail-aligned across
                # shards: loss rows pair with the TAIL of this primary's
                # snapshot times
                times = times[-len(total):]
                traj = [[t, float(v) / n] for t, v in zip(times, total)]
        result["trajectory"] = traj
        result["recovery"] = sup.counters() if sup is not None else None
    # one last durable save before exit: a graceful teardown leaves the
    # freshest possible restart point for the next life
    try:
        ps.save_checkpoint()
    except Exception:  # noqa: BLE001
        pass
    print(json.dumps(result), flush=True)
    print(f"shard {index} done: {result}", file=sys.stderr, flush=True)
    # post-done linger: serve the range until the controller says stop
    # (bounded so a controller that died without SIGTERM cannot strand
    # an orphan serving forever)
    term.wait(timeout=float(os.environ.get("ASYNC_SHARD_LINGER_S", "600")))
    # the counts after the last apply: a push in flight when FINISH came
    # lands after the result line above, so the launcher reads these
    # (ShardGroup.final_result_of) once it has stopped the group
    _quiesce(ps)
    print(json.dumps({"role": result["role"], "shard": index, "final": True,
                      "accepted": ps.accepted, "dropped": ps.dropped,
                      "clock": ps._clock,
                      "pushes": int(sum(ps.pushes_by_wid.values()))}),
          flush=True)
    if controller is not None:
        controller.stop()
    if ctrl_fanout is not None:
        ctrl_fanout.stop()
    ps.stop()
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())

"""Elastic training supervisor: process-level membership for the DCN plane.

The net layer makes transport blips survivable (retry + exactly-once
sessions); this module makes *process death* survivable.  The paper's whole argument (ASYNC,
arXiv:1907.08526) is that a bounded-staleness run keeps converging when
workers are slow or absent -- ASAP (arXiv:1612.08608) goes further and
treats membership change itself as just another source of staleness.  The
supervisor is that idea applied to ``parallel/ps_dcn.py``'s multi-process
path: the PS-side authority on *who is alive and who owns which shard*.

Mechanism (all of it piggybacked on the existing PULL/PUSH protocol -- no
new control channel, no extra RTTs):

- worker processes ``HELLO`` once with a process token, their logical
  worker ids, and their pid/host; every PULL/PUSH carries the token and
  refreshes per-worker last-contact.
- a monitor thread declares a worker **dead** on process exit (local pid
  probe -- immediate) or silence past ``dead_after_s`` (the remote /
  wedged case).
- dead workers' shards are re-homed with the SAME policy the in-process
  engine uses (``engine/recovery.plan_reassignment``, least-loaded-first,
  deterministic), except the survivors are *processes*: the PS piggybacks
  **adoption orders** on the adopter's next PULL reply, and the adopter
  materializes the orphan shard locally (``shard_factory``) and starts
  pulling for it.  The run completes with full data coverage at a
  degraded cohort size -- the partial barrier ``b`` is clamped to live
  membership so waves keep flowing without waiting on the starvation
  fallback.
- a **rejoining** worker (same shards, fresh process + session) HELLOs,
  takes its shards back, and the adopter's surrogate loop is told
  ``RELEASED`` on its next pull -- membership rebalances with no
  double-serving window: ownership is checked on every PULL *and* PUSH,
  so a push from a deposed owner is membership-stale and dropped.

The supervisor is deliberately jax-free and transport-free: it sees only
(token, wid, pid, clock) events, so it unit-tests with a ``ManualClock``
and the live UI can import its counters without dragging the device stack.
"""

from __future__ import annotations

import socket
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Set

from asyncframework_tpu_torch.metrics import flightrec as _flight
from asyncframework_tpu_torch.utils.clock import Clock, SystemClock

# states a logical worker (shard slot) moves through
UNKNOWN = "unknown"   # never heard from (counts as live for cohort sizing)
LIVE = "live"
SUSPECT = "suspect"   # missed lease renewal / latency outlier; still live
DEAD = "dead"         # lease expired / process exited; under replacement

_totals_lock = threading.Lock()
_totals: Dict[str, int] = {
    "workers_lost": 0,     # wids declared dead (exit or lease expiry)
    "shards_adopted": 0,   # adoption orders issued to survivors
    "rejoins": 0,          # wids reclaimed by a re-registered process
    "releases": 0,         # surrogate loops told to stand down
    "ps_resumes": 0,       # ParameterServer restarts from checkpoint
    "suspicions": 0,       # members marked SUSPECT (silence or RTT)
    "lease_expiries": 0,   # deaths declared by lease expiry (not exit)
    "epoch_bumps": 0,      # fencing epochs minted before replacements
    "fenced_rejects": 0,   # stale-epoch ops servers answered REJECT_FENCED
}


def recovery_totals() -> Dict[str, int]:
    """Process-wide elastic-recovery counters (live UI, next to net/)."""
    with _totals_lock:
        return dict(_totals)


def reset_recovery_totals() -> None:
    """Zero the process-wide counters (per-run isolation; see
    ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    with _totals_lock:
        for k in _totals:
            _totals[k] = 0


def bump_total(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] = _totals.get(key, 0) + n


#: weak registry of running supervisors in this process: the cluster
#: observer (metrics/observer.py) walks it to discover worker-role
#: scrape targets from membership (HELLO ``mport``) without holding any
#: supervisor alive past its own stop()
_active_lock = threading.Lock()
_active_sups: "List[weakref.ref]" = []


def active_supervisors() -> List["ElasticSupervisor"]:
    with _active_lock:
        out = [ref() for ref in _active_sups]
        return [s for s in out if s is not None]


def _pid_alive(pid) -> bool:
    """checkpoint.py's pid probe, hardened against junk pids from the
    wire (one probe implementation for the whole repo)."""
    from asyncframework_tpu_torch.checkpoint import _pid_alive as _probe

    try:
        return _probe(int(pid))
    except (OverflowError, ValueError):
        return True


def proc_start_time(pid) -> Optional[float]:
    """The process's kernel start time (``/proc/<pid>/stat`` field 22, in
    clock ticks since boot) -- the disambiguator that makes a pid probe
    honest: pids are recycled, and "pid N is alive" says nothing about
    WHICH process holds it.  A member records its own start time at HELLO
    (``pstart``); the probe treats a live pid whose start time no longer
    matches as exited (the member died and an unrelated process reused
    its pid).  None on platforms without /proc or on any read failure --
    callers fall back to the bare pid probe."""
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            data = f.read()
        # comm (field 2) may contain spaces and parens: split AFTER the
        # last ')' -- tail[0] is field 3 (state), starttime is field 22
        tail = data.rsplit(b")", 1)[1].split()
        return float(tail[19])
    except (OSError, ValueError, IndexError):
        return None


class _ProcRecord:
    __slots__ = ("token", "pid", "pid_is_local", "pid_start",
                 "registered_ms", "last_contact_ms", "exited",
                 "host", "mport")

    def __init__(self, token: str, now_ms: float, pid: Optional[int] = None,
                 host: Optional[str] = None,
                 pid_start: Optional[float] = None,
                 mport: Optional[int] = None):
        self.token = token
        self.pid = pid
        self.host = host
        # the member's telemetry endpoint (HELLO ``mport``): the cluster
        # observer discovers per-worker scrape targets from membership
        self.mport = int(mport) if mport else None
        # a pid is only probeable when the peer runs on THIS host; trusting
        # a remote pid would test an unrelated local process
        self.pid_is_local = (
            pid is not None
            and host is not None
            and host == socket.gethostname()
        )
        # proc start time pins WHICH process the pid names: supplied by
        # the member itself (HELLO pstart -- it read its own /proc/self),
        # else read here at registration (the member just contacted us,
        # so the pid is still overwhelmingly likely to be it)
        if pid_start is None and self.pid_is_local:
            pid_start = proc_start_time(pid)
        self.pid_start = pid_start
        self.registered_ms = now_ms
        self.last_contact_ms = now_ms
        self.exited = False

    def pid_gone(self) -> bool:
        """Local-pid death probe with pid-reuse protection: dead when the
        pid is gone, OR alive-but-not-ours (start time mismatch)."""
        if not self.pid_is_local:
            return False
        if not _pid_alive(self.pid):
            return True
        if self.pid_start is not None:
            cur = proc_start_time(self.pid)
            if cur is not None and cur != self.pid_start:
                return True  # pid recycled by an unrelated process
        return False


class ElasticSupervisor:
    """PS-side membership, death detection, and shard adoption orders.

    The :class:`~asyncframework_tpu_torch.parallel.ps_dcn.ParameterServer` calls
    :meth:`register` (HELLO), :meth:`touch` + :meth:`owns` (every PULL and
    PUSH), :meth:`orders_for` (PULL replies), and
    :meth:`live_worker_count` (cohort clamp).  ``check_once`` is the
    monitor scan, exposed for deterministic tests.
    """

    def __init__(self, num_workers: int, dead_after_s: float = 5.0,
                 check_interval_s: float = 0.5, boot_grace_s: float = 10.0,
                 clock: Optional[Clock] = None, adopt: bool = True,
                 lease_s: Optional[float] = None,
                 suspect_after_s: Optional[float] = None,
                 fence: Optional[bool] = None):
        #: ``adopt=False`` is the serving-frontend mode
        #: (serving/frontend.py): the same HELLO registration, pid-probe +
        #: silence death detection, and rejoin revival -- but the slots
        #: are predict replicas, not shard servers, so dead slots are
        #: simply taken out of rotation (no adoption planning, no
        #: unclaimed-slot handout, and no process-global recovery-counter
        #: bumps -- the serving plane keeps its own counters).
        self._adopt = bool(adopt)
        self.num_workers = int(num_workers)
        # the membership LEASE: granted at register (HELLO), renewed by
        # any op (touch).  ``lease_s`` names what ``dead_after_s`` always
        # was -- silence past it expires the lease and declares death;
        # when given it overrides dead_after_s outright.
        if lease_s is not None and float(lease_s) > 0:
            dead_after_s = float(lease_s)
        self.dead_after_ms = float(dead_after_s) * 1e3
        self.lease_ms = self.dead_after_ms
        # the SUSPECT threshold: silence past this (default: half the
        # lease) marks the member suspected -- surfaced in membership and
        # routing, but no replacement is launched until the lease itself
        # expires.  A partitioned-but-alive member spends the partition
        # here instead of being double-served by a hasty replacement.
        self.suspect_after_ms = (
            float(suspect_after_s) * 1e3
            if suspect_after_s is not None and float(suspect_after_s) > 0
            else self.dead_after_ms / 2.0
        )
        self.check_interval_s = float(check_interval_s)
        self.boot_grace_ms = float(boot_grace_s) * 1e3
        # epoch fencing gate: epochs are only MINTED (and counted) when
        # fencing is on -- a fence-off run must not report fencing
        # activity its wire never carried.  None = conf-derived.
        if fence is None:
            from asyncframework_tpu_torch.conf import FENCE_ENABLED, global_conf

            fence = bool(global_conf().get(FENCE_ENABLED))
        self.fence = bool(fence)
        self._clock = clock or SystemClock()
        # membership lock feeds the lock-order race detector when the
        # watchdog is armed (net/lockwatch.py named_lock); the
        # supervisor never does wire I/O under it, so watching it is
        # side-effect-free
        from asyncframework_tpu_torch.net import lockwatch as _lockwatch

        self._lock = _lockwatch.named_lock("supervisor.members")
        self._t0 = self._clock.now_ms()
        self._owner: Dict[int, Optional[str]] = {
            w: None for w in range(self.num_workers)
        }
        self._state: Dict[int, str] = {
            w: UNKNOWN for w in range(self.num_workers)
        }
        self._contact_ms: Dict[int, Optional[float]] = {
            w: None for w in range(self.num_workers)
        }
        self._procs: Dict[str, _ProcRecord] = {}
        # adopter -> {orphan wid: order-issued ms}.  The timestamp bounds
        # how long an unacked order may sit with one adopter before the
        # orphan returns to the re-plan pool (an adopter whose
        # shard_factory keeps failing, or a classic client that ignores
        # orders, must not strand the shard forever)
        self._pending: Dict[str, Dict[int, float]] = {}
        # fencing epochs, one per slot: bumped BEFORE any replacement is
        # launched for a dead member, so the replacement's minted epoch
        # strictly dominates anything the deposed incarnation ever
        # stamped (parallel/ps_dcn.py REJECT_FENCED admission)
        self._epochs: Dict[int, int] = {}
        # latency suspicion overlay (net/health.py feeds it): advisory --
        # an RTT-suspect member keeps renewing its lease, so it is never
        # killed on latency alone, but membership/routing see SUSPECT
        self._rtt_suspect: Dict[int, str] = {}
        self.workers_lost = 0
        self.shards_adopted = 0
        self.rejoins = 0
        self.releases = 0
        self.suspicions = 0
        self.lease_expiries = 0
        self.leases_granted = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set when the run completes: membership is frozen -- workers
        # legitimately go silent after DONE (evaluation phase, teardown)
        # and must not be declared dead / trigger pointless adoptions
        self._frozen = threading.Event()
        self._frozen_live_procs: Optional[List[str]] = None

    @classmethod
    def from_conf(cls, num_workers: int, conf=None) -> "ElasticSupervisor":
        from asyncframework_tpu_torch.conf import (
            ELASTIC_BOOT_GRACE_S,
            ELASTIC_CHECK_INTERVAL_S,
            ELASTIC_DEAD_AFTER_S,
            LEASE_S,
            SUSPECT_AFTER_S,
            global_conf,
        )

        conf = conf if conf is not None else global_conf()
        return cls(
            num_workers,
            dead_after_s=conf.get(ELASTIC_DEAD_AFTER_S),
            check_interval_s=conf.get(ELASTIC_CHECK_INTERVAL_S),
            boot_grace_s=conf.get(ELASTIC_BOOT_GRACE_S),
            lease_s=conf.get(LEASE_S) or None,
            suspect_after_s=conf.get(SUSPECT_AFTER_S) or None,
        )

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "ElasticSupervisor":
        with _active_lock:
            _active_sups.append(weakref.ref(self))
        self._thread = threading.Thread(
            target=self._run, name="elastic-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        with _active_lock:
            _active_sups[:] = [r for r in _active_sups
                               if r() is not None and r() is not self]
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            self.check_once()

    # ------------------------------------------------------------ membership
    def register(self, proc: str, wids: Sequence[int],
                 pid: Optional[int] = None, host: Optional[str] = None,
                 pid_start: Optional[float] = None,
                 mport: Optional[int] = None) -> None:
        """HELLO: ``proc`` claims ``wids`` and is GRANTED a lease (renewed
        by any op via :meth:`touch`; expiry past ``lease_s`` of silence
        declares death).  A claim over a wid someone else currently
        serves is a REJOIN -- the old server's surrogate loop is deposed
        (it learns via RELEASED on its next pull).  ``pid_start`` is the
        member's own /proc start time (pid-reuse protection); ``mport``
        its telemetry port (observer discovery)."""
        now = self._clock.now_ms()
        with self._lock:
            self._procs[proc] = _ProcRecord(proc, now, pid=pid, host=host,
                                            pid_start=pid_start,
                                            mport=mport)
            self.leases_granted += 1
            for wid in wids:
                wid = int(wid)
                if wid not in self._owner:
                    continue
                prev = self._owner.get(wid)
                rejoined = (prev not in (None, proc)
                            or self._state.get(wid) == DEAD)
                self._owner[wid] = proc
                if prev not in (None, proc):
                    self.releases += 1
                    if self._adopt:
                        bump_total("releases")
                    pend = self._pending.get(prev)
                    if pend is not None:
                        pend.pop(wid, None)
                if rejoined:
                    self.rejoins += 1
                    if self._adopt:
                        bump_total("rejoins")
                self._state[wid] = LIVE
                self._contact_ms[wid] = now
                # the claim supersedes any in-flight adoption order
                for pend in self._pending.values():
                    pend.pop(wid, None)

    def touch(self, wid: int, proc: Optional[str] = None) -> None:
        """Contact from ``proc`` serving ``wid`` (every PULL/PUSH): the
        lease renewal.  Clears silence-suspicion (the member answered);
        latency suspicion (:meth:`suspect`) survives contact by design --
        a gray member's whole signature is that it keeps answering."""
        now = self._clock.now_ms()
        with self._lock:
            if wid in self._state:
                self._contact_ms[wid] = now
                # contact from the CURRENT owner revives the slot (covers
                # the adopter's first pull for a dead wid); contact from a
                # deposed process must not resurrect it
                if (self._state[wid] != DEAD
                        or proc is None
                        or self._owner.get(wid) in (None, proc)):
                    self._state[wid] = LIVE
            if proc is not None:
                rec = self._procs.get(proc)
                if rec is None:
                    # implicit registration: a restarted PS rebuilds its
                    # membership from live traffic (workers never re-HELLO
                    # a server they do not know restarted)
                    rec = _ProcRecord(proc, now)
                    self._procs[proc] = rec
                rec.last_contact_ms = now
                rec.exited = False

    def owns(self, proc: Optional[str], wid: int) -> bool:
        """Is ``proc`` the current server of ``wid``?  Unowned wids are
        claimed on first contact (restart recovery); a claim against a
        dead/vanished owner succeeds; a claim against a live owner fails
        -- the caller answers RELEASED and the surrogate stands down."""
        if proc is None:
            return True  # unelastic client: no membership discipline
        now = self._clock.now_ms()
        with self._lock:
            if wid not in self._owner:
                return True
            owner = self._owner.get(wid)
            if owner is None or owner == proc:
                self._owner[wid] = proc
                return True
            rec = self._procs.get(owner)
            owner_dead = (
                rec is None
                or rec.exited
                or rec.pid_gone()
                or now - max(rec.last_contact_ms, rec.registered_ms)
                > self.dead_after_ms
            )
            if owner_dead:
                self._owner[wid] = proc
                if self._state.get(wid) == DEAD:
                    self._state[wid] = LIVE
                return True
            return False

    def orders_for(self, proc: Optional[str]) -> List[int]:
        """Orphan wids ``proc`` has been assigned to adopt.  Re-delivered
        on every pull until the adopter's first pull FOR the orphan lands
        (``ack_adoption`` below) -- adoption must survive a lost reply."""
        if proc is None:
            return []
        with self._lock:
            return sorted(self._pending.get(proc, ()))

    def ack_adoption(self, proc: Optional[str], wid: int) -> None:
        """The adopter is now serving ``wid`` (its first pull arrived)."""
        if proc is None:
            return
        with self._lock:
            pend = self._pending.get(proc)
            if pend is not None:
                pend.pop(wid, None)

    # ------------------------------------------------------------- suspicion
    def suspect(self, wid: int, reason: str = "rtt") -> None:
        """External suspicion input (gray-failure detection,
        net/health.py): mark ``wid`` SUSPECT without touching its lease.
        Advisory -- routing demotes it, membership surfaces it, but only
        lease expiry or process exit escalates to DEAD."""
        with self._lock:
            if wid not in self._state or self._state.get(wid) == DEAD:
                return
            if wid not in self._rtt_suspect:
                self._rtt_suspect[wid] = str(reason)
                self.suspicions += 1
                if self._adopt:
                    bump_total("suspicions")

    def unsuspect(self, wid: int) -> None:
        """The latency normalized: clear the external suspicion."""
        with self._lock:
            self._rtt_suspect.pop(wid, None)

    def state_of(self, wid: int) -> str:
        """The slot's effective state: DEAD dominates, then any
        suspicion (silence-based or latency-based), then the base
        state."""
        with self._lock:
            return self._state_of_locked(wid)

    def _state_of_locked(self, wid: int) -> str:
        base = self._state.get(wid, UNKNOWN)
        if base == DEAD:
            return DEAD
        if wid in self._rtt_suspect:
            return SUSPECT
        return base

    # ---------------------------------------------------------------- epochs
    def epoch_of(self, wid: int) -> int:
        """Fencing-epoch bumps minted for this slot (0 = never fenced).
        A replacement for slot ``wid`` runs at base_epoch + epoch_of(wid);
        see parallel/shardgroup.py / parallel/ps_dcn.py."""
        with self._lock:
            return self._epochs.get(int(wid), 0)

    def _live_procs_locked(self, now: float) -> List[str]:
        return [
            p for p, rec in self._procs.items()
            if not rec.exited
            and now - max(rec.last_contact_ms, rec.registered_ms)
            <= self.dead_after_ms
        ]

    def freeze(self) -> None:
        """The run is DONE: pin the live-process set and stop declaring
        deaths.  Post-done silence (evaluation, teardown) is normal."""
        now = self._clock.now_ms()
        with self._lock:
            if self._frozen_live_procs is None:
                self._frozen_live_procs = self._live_procs_locked(now)
        self._frozen.set()

    def live_proc_count(self) -> int:
        """Worker processes currently considered alive (frozen at DONE).
        Bounds how many end-of-run EVAL results can still arrive."""
        now = self._clock.now_ms()
        with self._lock:
            if self._frozen_live_procs is not None:
                return len(self._frozen_live_procs)
            return len(self._live_procs_locked(now))

    # ------------------------------------------------------------- liveness
    def live_worker_count(self) -> int:
        """Workers not currently declared dead (UNKNOWN counts live so the
        first waves are not artificially small)."""
        with self._lock:
            return sum(1 for s in self._state.values() if s != DEAD)

    def check_once(self) -> List[int]:
        """One monitor scan; returns newly-dead wids (test-friendly)."""
        if self._frozen.is_set():
            return []
        now = self._clock.now_ms()
        newly_dead: List[int] = []
        expired: List[int] = []
        with self._lock:
            # 1. process-exit detection (local pids only): immediate
            # death, no silence window.  pid_gone() also catches a
            # recycled pid -- alive, but not the process that registered.
            for rec in self._procs.values():
                if not rec.exited and rec.pid_gone():
                    rec.exited = True
            live_procs = self._live_procs_locked(now)
            # 2. per-worker death: owner exited, or the LEASE expired
            # (silence past the bound).  Silence past the suspect
            # threshold but inside the lease marks SUSPECT -- surfaced,
            # demoted in routing, but no replacement yet: a partitioned
            # member that heals inside its lease rejoins with nothing to
            # undo.
            for wid in range(self.num_workers):
                if self._state[wid] == DEAD:
                    continue
                owner = self._owner.get(wid)
                contact = self._contact_ms.get(wid)
                if owner is not None:
                    rec = self._procs.get(owner)
                    base = contact if contact is not None else (
                        rec.registered_ms if rec is not None else self._t0
                    )
                    exited = rec is not None and rec.exited
                    if exited or now - base > self.dead_after_ms:
                        newly_dead.append(wid)
                        if not exited:
                            expired.append(wid)
                    elif (self._state[wid] == LIVE
                          and now - base > self.suspect_after_ms):
                        self._state[wid] = SUSPECT
                        self.suspicions += 1
                        if self._adopt:
                            bump_total("suspicions")
                else:
                    # unclaimed slot: nobody ever served this shard.  After
                    # the boot grace (and once there IS someone to adopt
                    # it), hand it out rather than strand its data.  In
                    # serving mode (adopt=False) unclaimed slots are just
                    # unused registration capacity -- never "dead".
                    if (self._adopt and live_procs
                            and now - self._t0 > max(self.boot_grace_ms,
                                                     self.dead_after_ms)):
                        newly_dead.append(wid)
            for wid in newly_dead:
                self._state[wid] = DEAD
                self._rtt_suspect.pop(wid, None)
                self.workers_lost += 1
                if self.fence:
                    # mint the fencing epoch BEFORE any replacement
                    # exists: whatever the deposed incarnation stamped
                    # is now, by construction, a stale epoch its
                    # successor's admission rejects (REJECT_FENCED).
                    # The process-global epoch_bumps COUNTER is bumped
                    # only where a minted epoch actually reaches the
                    # wire (shardgroup.ShardGroup's fenced relaunch) --
                    # worker/replica slots keep their ledger here in
                    # membership() without inflating the metric.
                    self._epochs[wid] = self._epochs.get(wid, 0) + 1
                if wid in expired:
                    self.lease_expiries += 1
                if self._adopt:
                    bump_total("workers_lost")
                    if wid in expired:
                        bump_total("lease_expiries")
            # 3. (re-)plan adoption for every dead wid lacking a live,
            # FRESH pending adopter -- covers adopters that died
            # mid-adoption AND adopters that never act on an order (a
            # failing shard_factory, a classic client ignoring orders):
            # an order older than the expiry returns to the pool
            order_expiry_ms = 2.0 * self.dead_after_ms
            pending_live: Set[int] = set()
            for p, pend in self._pending.items():
                for w, issued in list(pend.items()):
                    if p in live_procs and now - issued <= order_expiry_ms:
                        pending_live.add(w)
                    else:
                        pend.pop(w)  # expired/dead adopter: replan below
            orphans = [
                wid for wid in range(self.num_workers)
                if self._state[wid] == DEAD and wid not in pending_live
            ]
            if orphans and live_procs and self._adopt:
                from asyncframework_tpu_torch.engine.recovery import (
                    plan_reassignment,
                )

                owned: Dict[str, int] = {p: 0 for p in live_procs}
                for wid, owner in self._owner.items():
                    if owner in owned and self._state[wid] != DEAD:
                        owned[owner] += 1
                plan = plan_reassignment(live_procs, orphans, load=owned)
                for wid, adopter in plan.moves.items():
                    self._owner[wid] = adopter
                    self._pending.setdefault(adopter, {})[wid] = now
                    self.shards_adopted += 1
                    bump_total("shards_adopted")
        for wid in newly_dead:
            # flight-recorder breadcrumb, outside the membership lock: a
            # post-mortem dump shows WHO this process declared dead and
            # when (no-op when no recorder is installed)
            _flight.note("member_dead", wid=int(wid),
                         adopt=bool(self._adopt))
        return newly_dead

    # ----------------------------------------------------------- diagnostics
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "workers_lost": self.workers_lost,
                "shards_adopted": self.shards_adopted,
                "rejoins": self.rejoins,
                "releases": self.releases,
                "suspicions": self.suspicions,
                "lease_expiries": self.lease_expiries,
                "leases_granted": self.leases_granted,
            }

    def proc_records(self) -> List[Dict]:
        """Per-registered-process view (observer discovery): token, pid,
        host, telemetry port, exit flag."""
        with self._lock:
            return [
                {"proc": rec.token, "pid": rec.pid, "host": rec.host,
                 "mport": rec.mport, "exited": rec.exited}
                for rec in self._procs.values()
            ]

    def membership(self) -> Dict[int, Dict]:
        """Per-worker view for the PS's wait_done diagnostic: effective
        state (suspicion overlaid), owner, silence, remaining lease, and
        the slot's fencing epoch."""
        now = self._clock.now_ms()
        with self._lock:
            out = {}
            for wid in range(self.num_workers):
                contact = self._contact_ms.get(wid)
                out[wid] = {
                    "state": self._state_of_locked(wid),
                    "owner": self._owner.get(wid),
                    "silence_ms": (
                        None if contact is None else round(now - contact, 1)
                    ),
                    "lease_left_ms": (
                        None if contact is None
                        else round(self.lease_ms - (now - contact), 1)
                    ),
                    "epoch": self._epochs.get(wid, 0),
                }
            return out

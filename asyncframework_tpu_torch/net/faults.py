"""Deterministic, schedule-driven network fault injection.

The DCN plane's chaos story was "kill -9 and hope": real, but neither
replayable nor precise.  This module is the network-layer sibling of
``engine/straggler.py``'s compute delays -- faults are *scheduled*, keyed
by ``(endpoint, op, nth-occurrence)``, and a run with the same schedule
and the same client-side op sequence fires the same faults at the same
protocol points, so a chaos result can be replayed bit-for-bit.

Fault kinds (where in the exchange they bite):

- ``connect_refused``  -- the dial itself fails (daemon not up / port
  blackholed).  Nothing was sent.
- ``cut_mid_frame``    -- the request frame is truncated on the wire and
  the connection dies.  The server never applied the op.
- ``stall_read``       -- the request was delivered (and applied!) but the
  reply never arrives; the client's read times out.
- ``drop_reply``       -- the request was delivered and applied; the reply
  is lost.  The classic duplicate-generator: a naive client re-sends.
- ``delay``            -- the op goes through, late: ``delay_ms`` plus
  seeded ``jitter_ms`` of added latency per matching op, for ``count``
  occurrences starting at the ``nth`` (0 = every one from there on).
  The slow-but-alive member -- the gray failure the suspicion state
  machine (parallel/supervisor.py) exists to catch.

``stall_read`` and ``drop_reply`` are the cases that make bare retry
UNSAFE and are exactly what ``net/session.py``'s dedup windows exist for.

**Partitions** are first-class, separate from one-shot events: a
:class:`PartitionEvent` blackholes every exchange with matching remote
endpoints for a scheduled window (``start_s``..``start_s + duration_s``
relative to injector install; ``duration_s=0`` holds until
:meth:`FaultInjector.heal_partitions`).  The drop is bidirectional at the
frame choke point -- dials refuse, sends die before any byte leaves, and
reads time out -- in whichever process the injector is installed; a
cross-process cut installs the complementary schedule on each side via
``async.net.fault.schedule``.  Unlike a kill, the partitioned peer keeps
running: it is the zombie the lease/epoch-fencing machinery
(parallel/supervisor.py, parallel/ps_dcn.py) must make harmless.

Hook points live in ``net/frame.py`` (:func:`connect`, :func:`send_msg`,
:func:`recv_msg`); installation is process-global (:func:`install` /
:func:`clear` / the :func:`injected` context manager), with
:func:`maybe_install_from_conf` for daemons configured via
``async.net.fault.schedule``.  Endpoint patterns: exact ``host:port``,
``*:port`` (any host), or ``*`` (any endpoint).
"""

from __future__ import annotations

import json
import random
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from asyncframework_tpu_torch.metrics import flightrec as _flight

CONNECT_REFUSED = "connect_refused"
CUT_MID_FRAME = "cut_mid_frame"
STALL_READ = "stall_read"
DROP_REPLY = "drop_reply"
DELAY = "delay"
#: pseudo-kind the partition hooks report in the fired journal
PARTITION = "partition"

KINDS = (CONNECT_REFUSED, CUT_MID_FRAME, STALL_READ, DROP_REPLY, DELAY)

#: the pseudo-op a ``connect_refused`` event matches (the dial has no header)
CONNECT_OP = "CONNECT"

_totals_lock = threading.Lock()
_faults_fired = 0


def faults_fired_total() -> int:
    """Process-wide count of injected faults (metrics/live UI)."""
    with _totals_lock:
        return _faults_fired


def reset_faults_fired_total() -> None:
    """Zero the process-wide counter (per-run isolation; see
    ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    global _faults_fired
    with _totals_lock:
        _faults_fired = 0


def _bump_fired() -> None:
    global _faults_fired
    with _totals_lock:
        _faults_fired += 1


def _endpoint_matches(pat: str, endpoint: str) -> bool:
    if pat == "*" or pat == endpoint:
        return True
    if pat.startswith("*:"):
        return endpoint.rsplit(":", 1)[-1] == pat[2:]
    return False


@dataclass
class FaultEvent:
    """One scheduled fault: fires on the ``nth`` matching occurrence of
    ``op`` toward ``endpoint`` (1-based; each event fires exactly once).

    ``op`` may be an exact op, ``*`` (any), or a ``|``-alternation such as
    ``"PUSH|PUSH_SAGA"`` -- one event covering a protocol family (the DCN
    ASAGA ops ride their own verbs so schedules can tell the two solvers'
    streams apart, but a schedule aimed at "any gradient push" should not
    need two events with independent counters).

    ``delay`` events are the exception to fires-exactly-once: they bite
    occurrences ``nth`` .. ``nth + count - 1`` (``count=0`` = every
    occurrence from ``nth`` on), adding ``delay_ms`` plus a seeded
    uniform ``jitter_ms`` of latency while letting the op through."""

    endpoint: str
    op: str
    nth: int
    kind: str
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    count: int = 1
    _count: int = field(default=0, repr=False)
    fired: bool = field(default=False, repr=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")
        if self.count < 0:
            raise ValueError("count must be >= 0 (0 = unbounded)")

    def matches(self, endpoint: str, op: str) -> bool:
        if self.op != "*" and op not in self.op.split("|"):
            return False
        return _endpoint_matches(self.endpoint, endpoint)


@dataclass
class PartitionEvent:
    """A scheduled network partition: every exchange with a remote
    endpoint matching any pattern in ``endpoints`` is dropped while the
    event is active -- from ``start_s`` after injector install until
    ``start_s + duration_s`` (``duration_s=0`` = until
    :meth:`FaultInjector.heal_partitions`).  The blackhole is
    bidirectional at the choke point: dials refuse, sends die before a
    byte leaves, reads time out."""

    endpoints: List[str]
    start_s: float = 0.0
    duration_s: float = 0.0
    healed: bool = field(default=False, repr=False)

    def matches(self, endpoint: str) -> bool:
        return any(_endpoint_matches(p, endpoint) for p in self.endpoints)

    def active(self, elapsed_s: float) -> bool:
        if self.healed or elapsed_s < self.start_s:
            return False
        if self.duration_s <= 0:
            return True
        return elapsed_s < self.start_s + self.duration_s


@dataclass
class FaultSchedule:
    """A replayable list of :class:`FaultEvent` + :class:`PartitionEvent`,
    plus the seed chaos runs hand to their retry policies (one number
    pins the whole run)."""

    events: List[FaultEvent] = field(default_factory=list)
    partitions: List[PartitionEvent] = field(default_factory=list)
    seed: int = 0

    def add(self, endpoint: str, op: str, nth: int, kind: str
            ) -> "FaultSchedule":
        self.events.append(FaultEvent(endpoint, op, nth, kind))
        return self

    def add_delay(self, endpoint: str, op: str, delay_ms: float,
                  jitter_ms: float = 0.0, nth: int = 1, count: int = 1
                  ) -> "FaultSchedule":
        self.events.append(FaultEvent(endpoint, op, nth, DELAY,
                                      delay_ms=float(delay_ms),
                                      jitter_ms=float(jitter_ms),
                                      count=int(count)))
        return self

    def add_partition(self, endpoints: Sequence[str], start_s: float = 0.0,
                      duration_s: float = 0.0) -> "FaultSchedule":
        self.partitions.append(PartitionEvent(
            [str(e) for e in endpoints], float(start_s), float(duration_s)
        ))
        return self

    def to_json(self) -> str:
        events = []
        for e in self.events:
            rec = {"endpoint": e.endpoint, "op": e.op,
                   "nth": e.nth, "kind": e.kind}
            if e.kind == DELAY:
                rec.update(delay_ms=e.delay_ms, jitter_ms=e.jitter_ms,
                           count=e.count)
            events.append(rec)
        out = {"seed": self.seed, "events": events}
        if self.partitions:
            out["partitions"] = [
                {"endpoints": list(p.endpoints), "start_s": p.start_s,
                 "duration_s": p.duration_s}
                for p in self.partitions
            ]
        return json.dumps(out)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        raw = json.loads(text)
        sched = cls(seed=int(raw.get("seed", 0)))
        for e in raw.get("events", []):
            if e.get("kind") == DELAY:
                sched.add_delay(e["endpoint"], e["op"],
                                float(e.get("delay_ms", 0.0)),
                                jitter_ms=float(e.get("jitter_ms", 0.0)),
                                nth=int(e.get("nth", 1)),
                                count=int(e.get("count", 1)))
            else:
                sched.add(e["endpoint"], e["op"], int(e["nth"]), e["kind"])
        for p in raw.get("partitions", []):
            sched.add_partition(p["endpoints"],
                                start_s=float(p.get("start_s", 0.0)),
                                duration_s=float(p.get("duration_s", 0.0)))
        return sched


class FaultInjector:
    """Evaluates a :class:`FaultSchedule` against the live op stream.

    Each event keeps its own occurrence counter, so matching is
    deterministic per (endpoint, op) stream regardless of what other
    endpoints are doing.  ``fired`` is the journal a replay asserts
    against."""

    #: fired-journal cap: a partition blackholing a retry storm must not
    #: grow the journal without bound (the counter keeps exact totals)
    JOURNAL_MAX = 4096

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._lock = threading.Lock()
        # id(sock) -> (weakref(sock), kind) for that socket's next recv;
        # the weakref guards against CPython id() reuse handing a stale
        # fault to an unrelated future socket
        self._armed: Dict[int, Tuple[weakref.ref, str]] = {}
        self.fired: List[Dict] = []
        # partition clock: event windows are relative to install time
        self._t0 = time.monotonic()
        # seeded per-event jitter chains for delay events: deterministic
        # given (schedule.seed, event index), independent across events
        self._jitter: Dict[int, random.Random] = {
            i: random.Random((int(schedule.seed) << 16) ^ i)
            for i, ev in enumerate(schedule.events) if ev.kind == DELAY
        }

    def _journal(self, rec: Dict) -> None:
        if len(self.fired) < self.JOURNAL_MAX:
            self.fired.append(rec)
        # flight-recorder breadcrumb (metrics/flightrec.py): a chaos
        # post-mortem shows which scheduled faults fired right before
        # the end (no-op when no recorder is installed; the record rides
        # as one field -- its own "kind" key is the FAULT kind)
        _flight.note("fault", event=dict(rec))

    # ------------------------------------------------------------- matching
    def _fire(self, endpoint: str, op: str) -> Optional[str]:
        """Count this occurrence against every live matching event; return
        the kind of the first event whose ``nth`` is reached."""
        with self._lock:
            hit: Optional[FaultEvent] = None
            for ev in self.schedule.events:
                if ev.fired or ev.kind == DELAY \
                        or not ev.matches(endpoint, op):
                    continue
                ev._count += 1
                if hit is None and ev._count == ev.nth:
                    ev.fired = True
                    hit = ev
            if hit is None:
                return None
            self._journal({"endpoint": endpoint, "op": op,
                           "nth": hit.nth, "kind": hit.kind})
        _bump_fired()
        return hit.kind

    def delay_for(self, endpoint: str, op: str) -> float:
        """Seconds of injected latency this (endpoint, op) occurrence owes
        across every matching ``delay`` event.  Counts the occurrence per
        event; the caller sleeps OUTSIDE the injector lock."""
        total_ms = 0.0
        with self._lock:
            for i, ev in enumerate(self.schedule.events):
                if ev.kind != DELAY or ev.fired \
                        or not ev.matches(endpoint, op):
                    continue
                ev._count += 1
                if ev._count < ev.nth:
                    continue
                if ev.count and ev._count >= ev.nth + ev.count - 1:
                    ev.fired = True  # last occurrence this event bites
                ms = ev.delay_ms
                if ev.jitter_ms > 0:
                    ms += self._jitter[i].uniform(0.0, ev.jitter_ms)
                total_ms += ms
                self._journal({"endpoint": endpoint, "op": op,
                               "nth": ev._count, "kind": DELAY,
                               "delay_ms": round(ms, 3)})
        if total_ms > 0:
            _bump_fired()
        return total_ms / 1e3

    # ----------------------------------------------------------- partitions
    def partition_active(self, endpoint: str) -> bool:
        """Is ``endpoint`` currently on the far side of a partition?"""
        elapsed = time.monotonic() - self._t0
        with self._lock:
            return any(p.active(elapsed) and p.matches(endpoint)
                       for p in self.schedule.partitions)

    def note_partition_drop(self, endpoint: str, where: str) -> None:
        """Journal + count one exchange the partition ate."""
        with self._lock:
            self._journal({"endpoint": endpoint, "op": where,
                           "kind": PARTITION})
        _bump_fired()

    def heal_partitions(self) -> None:
        """End every partition now (the heals-on-schedule path needs no
        call; this is the explicit heal for duration_s=0 events and for
        tests that gate the heal on an assertion)."""
        with self._lock:
            for p in self.schedule.partitions:
                p.healed = True

    # ----------------------------------------------------------- hook sites
    def check_connect(self, endpoint: str) -> None:
        if self.partition_active(endpoint):
            self.note_partition_drop(endpoint, CONNECT_OP)
            raise ConnectionRefusedError(
                f"fault-injected: partitioned from {endpoint}"
            )
        kind = self._fire(endpoint, CONNECT_OP)
        if kind == CONNECT_REFUSED:
            raise ConnectionRefusedError(
                f"fault-injected: connection refused to {endpoint}"
            )

    def check_send(self, endpoint: str, op: str) -> Optional[str]:
        dly = self.delay_for(endpoint, op)
        if dly > 0:
            time.sleep(dly)
        return self._fire(endpoint, op)

    def arm(self, sock, kind: str) -> None:
        with self._lock:
            self._armed[id(sock)] = (weakref.ref(sock), kind)

    def disarm(self, sock) -> Optional[str]:
        with self._lock:
            entry = self._armed.pop(id(sock), None)
        if entry is None:
            return None
        ref, kind = entry
        return kind if ref() is sock else None

    # -------------------------------------------------------------- reports
    def remaining(self) -> List[FaultEvent]:
        with self._lock:
            return [e for e in self.schedule.events if not e.fired]


_active_lock = threading.Lock()
_active: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _active


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or, with None, clear) the process's fault injector."""
    global _active
    with _active_lock:
        _active = injector
    return injector


def clear() -> None:
    install(None)


class injected:
    """``with faults.injected(schedule) as inj: ...`` -- scoped install."""

    def __init__(self, schedule: FaultSchedule):
        self.injector = FaultInjector(schedule)

    def __enter__(self) -> FaultInjector:
        install(self.injector)
        return self.injector

    def __exit__(self, *exc) -> None:
        clear()


def maybe_install_from_conf(conf=None) -> Optional[FaultInjector]:
    """Daemon entry points call this: when ``async.net.fault.schedule`` is
    set (inline JSON, or ``@/path/to/file``), install the injector so a
    subprocess chaos run needs no code changes -- just conf/env."""
    from asyncframework_tpu_torch.conf import (
        NET_FAULT_SCHEDULE,
        NET_FAULT_SEED,
        global_conf,
    )

    conf = conf if conf is not None else global_conf()
    text = str(conf.get(NET_FAULT_SCHEDULE) or "").strip()
    if not text:
        return None
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    sched = FaultSchedule.from_json(text)
    if "seed" not in json.loads(text):
        # a schedule without its own seed inherits the conf seed, so one
        # env var can re-pin a whole daemon fleet's chaos run
        sched.seed = int(conf.get(NET_FAULT_SEED))
    return install(FaultInjector(sched))


# ------------------------------------------------------------ net profiles
def wan_profile_schedule(seed: int) -> FaultSchedule:
    """The ``--net-profile wan`` preset (bin/chaos_sweep.py): every op
    pays 15 ms + U(0, 15) ms of seeded latency, and a handful of seeded
    loss events (dropped replies, mid-frame cuts) land across the run --
    a deterministic stand-in for a jittery lossy wide-area link.  Suites
    OPT IN by merging it into their own schedules
    (:func:`profile_schedule_from_env` + :func:`merge_schedules`; the
    fencing/partition suite does) -- exact-replay suites keep their
    pinned schedules, since a merged profile would break the byte-replay
    determinism they assert."""
    sched = FaultSchedule(seed=int(seed))
    sched.add_delay("*", "*", delay_ms=15.0, jitter_ms=15.0,
                    nth=1, count=0)
    rng = random.Random(int(seed) ^ 0x5A5A)
    for op in ("PUSH|PUSH_SAGA", "PULL|PULL_SAGA", "SUBSCRIBE"):
        sched.add("*", op, rng.randint(3, 30), DROP_REPLY)
        sched.add("*", op, rng.randint(3, 30), CUT_MID_FRAME)
    return sched


def profile_schedule_from_env(seed: int = 0) -> Optional[FaultSchedule]:
    """The net-profile preset selected via ``ASYNC_CHAOS_NET_PROFILE``
    (set by ``bin/chaos_sweep.py --net-profile``); None when unset.
    Chaos tests MERGE this into their own schedules (see
    :func:`merge_schedules`) so every seeded scenario also runs under the
    profile's latency/loss floor."""
    import os

    name = os.environ.get("ASYNC_CHAOS_NET_PROFILE", "").strip()
    if not name or name == "none":
        return None
    if name == "wan":
        return wan_profile_schedule(seed)
    raise ValueError(f"unknown net profile {name!r} (know: wan)")


def merge_schedules(base: FaultSchedule,
                    extra: Optional[FaultSchedule]) -> FaultSchedule:
    """``base`` with ``extra``'s events/partitions appended (fresh event
    objects -- counters never shared across injectors); base's seed
    wins."""
    if extra is None:
        return base
    merged = FaultSchedule.from_json(base.to_json())
    for e in FaultSchedule.from_json(extra.to_json()).events:
        merged.events.append(e)
    for p in extra.partitions:
        merged.add_partition(p.endpoints, p.start_s, p.duration_s)
    return merged

"""Cluster observer: central collector, run history, cross-role signals.

Per-process telemetry leaves every role an island: each process
serves its own ``/metrics`` + ``/api/status`` and forgets them at
exit.  The ASYNC paper's *history* pillar (arXiv:1907.08526) and the
delay-adaptive controller it motivates (ROADMAP item 2, per "Faster
Asynchronous SGD", arXiv:1601.04033) both assume someone can see the
WHOLE cluster's staleness/availability picture over time.  This module
is that someone:

- :class:`ClusterObserver` discovers every role -- static endpoints
  (conf ``async.observer.endpoints`` / CLI) and worker processes
  registered with any
  live ElasticSupervisor (HELLO now advertises the worker's metrics
  port) -- and scrapes each one's ``/api/status`` on an interval over
  the net/ retry plane (RetryPolicy + shared per-endpoint breakers:
  forty scrape failures against one dead role back off as a group).
- every scrape folds the role's numbers into a durable
  :class:`RunHistoryStore`: per-run, per-role compacted time series on
  disk (the ConvergenceHistory stride-compaction, so a series spans the
  whole run at bounded size), readable by ``metrics/history.py``, bench,
  and :func:`load_run` -- trajectories outlive processes AND runs.
- cross-role **derived signals** are recomputed per scrape and exposed
  as the ``observer.*`` series family (dynamic source + counter family
  in ``metrics/registry.py``): per-worker straggler scores vs the
  cohort median (compute / push-RTT / push-interval / staleness -- the
  controller's input surface), PS merge-queue depth vs push rate, and
  fleet-wide serving freshness lag.  Default SLO rules over them ride
  ``async.slo.rules`` (``fleet_stragglers`` / ``fleet_freshness`` /
  ``fleet_roles``).
- the collector **harvests crash flight-recorder dumps**
  (``metrics/flightrec.py``) from the configured directories into the
  run-history store, so a chaos SIGKILL produces a post-mortem instead
  of silence.

``python -m asyncframework_tpu_torch.metrics.observer`` is the CLI
(``async-mon``): it runs a collector, serves the fleet view on its own
``/api/status`` (the ``observer`` section via
``live.register_status_section``; ``python -m
asyncframework_tpu_torch.metrics.top --observer`` renders it), and
persists history until stopped.

A copy of the JAX package's ``metrics/observer.py``: either package's
observer scrapes either package's endpoints and harvests either's flight
dumps, and discovers the active sharded PS group's per-shard endpoints
(``parallel/shardgroup.py``) as there.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_totals_lock = threading.Lock()
_totals = {"scrapes": 0, "scrape_errors": 0, "harvests": 0,
           "harvest_stale_skipped": 0, "persists": 0,
           "stragglers_flagged": 0, "discovered": 0}


def _bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] += n


def observer_totals() -> Dict[str, int]:
    """Flat meta-counters (registry family ``observer``)."""
    with _totals_lock:
        return dict(_totals)


def reset_observer_totals() -> None:
    with _totals_lock:
        for k in _totals:
            _totals[k] = 0


@dataclass(frozen=True)
class RoleTarget:
    """One scrape target: a stable ``name`` (history key), its ``role``
    kind, and the base URL serving /api/status."""

    name: str
    role: str
    url: str


def parse_endpoints(text: str) -> List[RoleTarget]:
    """Parse the static-endpoint grammar: ``;``/``,``-separated
    ``name=role@host:port`` entries (``role@`` and ``name=`` optional;
    a bare ``host:port`` scrapes as role/name ``process``)."""
    out: List[RoleTarget] = []
    for raw in re.split(r"[;,]", text or ""):
        raw = raw.strip()
        if not raw:
            continue
        name, rest = (raw.split("=", 1) if "=" in raw else ("", raw))
        role, addr = (rest.split("@", 1) if "@" in rest else ("", rest))
        addr = addr.strip()
        if not addr.startswith("http"):
            addr = "http://" + addr
        name = name.strip() or role.strip() or "process"
        out.append(RoleTarget(name=name, role=role.strip() or "process",
                              url=addr.rstrip("/")))
    return out


def _safe_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "-" for c in name)


# --------------------------------------------------------------------------
# Durable run-history store
# --------------------------------------------------------------------------
class _CompactSeries:
    """One compacted series: the ConvergenceHistory stride discipline
    (at capacity drop every other point and double the acceptance
    stride) so the persisted series always spans the whole run."""

    __slots__ = ("capacity", "pts", "_stride", "_arrivals")

    def __init__(self, capacity: int):
        self.capacity = max(16, int(capacity))
        self.pts: List[List[float]] = []
        self._stride = 1
        self._arrivals = 0

    def add(self, t_s: float, v: float) -> None:
        k = self._arrivals
        self._arrivals += 1
        if k % self._stride != 0:
            return
        self.pts.append([t_s, v])
        if len(self.pts) >= self.capacity:
            del self.pts[1::2]
            self._stride *= 2


class RunHistoryStore:
    """Per-run, per-role compacted time series + harvested flight dumps,
    persisted under ``<root>/run-<run_id>/`` (``root=None`` keeps it
    in-memory only -- same API, nothing written)."""

    MAX_SERIES_PER_ROLE = 256
    SCHEMA = 1

    def __init__(self, root: Optional[str], run_id: str,
                 points: int = 512):
        self.root = str(root) if root else None
        self.run_id = str(run_id)
        self.points = max(16, int(points))
        self._lock = threading.Lock()
        self._roles: Dict[str, Dict[str, object]] = {}  # name -> meta
        self._series: Dict[str, Dict[str, _CompactSeries]] = {}
        self._flight: Dict[str, dict] = {}  # dump filename -> dump dict
        self._flight_persisted: Dict[str, object] = {}  # fname -> dumped_s
        # profile snapshots harvested next to the flight dumps (from a
        # dump's embedded "profile" key OR straight off a scraped
        # /api/status), keyed role-pid; same fresher-dumped_s re-harvest
        # and dirty-tracked persist discipline as the dumps themselves
        self._profile: Dict[str, dict] = {}
        self._profile_persisted: Dict[str, object] = {}
        self.started_s = time.time()
        self.series_dropped = 0
        self.persists = 0

    @property
    def run_dir(self) -> Optional[str]:
        if self.root is None:
            return None
        return os.path.join(self.root, f"run-{_safe_name(self.run_id)}")

    # ------------------------------------------------------------- recording
    def note_role(self, name: str, role: str, url: str) -> None:
        with self._lock:
            self._roles[name] = {"role": role, "url": url}

    def record(self, role_name: str, series: str, t_s: float,
               value: float) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        with self._lock:
            per = self._series.setdefault(role_name, {})
            s = per.get(series)
            if s is None:
                if len(per) >= self.MAX_SERIES_PER_ROLE:
                    self.series_dropped += 1
                    return
                s = per[series] = _CompactSeries(self.points)
            s.add(float(t_s), v)

    def harvest(self, dump: dict, source: str) -> bool:
        """Fold one flight-recorder dump in; returns True when it is new
        or newer than the copy already held (re-harvest on a fresher
        periodic overwrite of the same file)."""
        key = os.path.basename(str(source))
        with self._lock:
            prev = self._flight.get(key)
            if prev is not None and \
                    prev.get("dumped_s") == dump.get("dumped_s"):
                return False
            self._flight[key] = dump
        prof = dump.get("profile")
        if isinstance(prof, dict) and prof.get("zones"):
            self.harvest_profile(prof, source)
        return True

    def harvest_profile(self, snap: dict, source: str) -> bool:
        """Fold one profile snapshot in (from a flight dump's embedded
        ``profile`` key or a scraped ``/api/status`` section); keyed
        role-pid so a role's periodic snapshots overwrite in place;
        returns True when new or fresher (``dumped_s``)."""
        if not isinstance(snap, dict):
            return False
        key = f"{snap.get('role', '_')}-{snap.get('pid', 0)}"
        with self._lock:
            prev = self._profile.get(key)
            if prev is not None and \
                    prev.get("dumped_s") == snap.get("dumped_s"):
                return False
            self._profile[key] = snap
        return True

    # --------------------------------------------------------------- queries
    def roles(self) -> List[str]:
        with self._lock:
            return sorted(self._series.keys() | self._roles.keys())

    def series_of(self, role_name: str) -> Dict[str, List[List[float]]]:
        with self._lock:
            per = self._series.get(role_name, {})
            return {k: list(s.pts) for k, s in per.items()}

    def flight_dumps(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._flight)

    def profile_snapshots(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._profile)

    def summary(self) -> dict:
        with self._lock:
            return {
                "run_id": self.run_id,
                "run_dir": self.run_dir,
                "roles": {
                    n: {
                        **self._roles.get(n, {}),
                        "series": len(self._series.get(n, {})),
                    }
                    for n in sorted(self._series.keys()
                                    | self._roles.keys())
                },
                "flight_dumps": sorted(self._flight),
                "profile_snapshots": sorted(self._profile),
                "series_dropped": self.series_dropped,
                "persists": self.persists,
            }

    # ------------------------------------------------------------ persistence
    def _write_json(self, path: str, obj: dict) -> None:
        from asyncframework_tpu_torch.checkpoint import durable_replace

        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(obj, f, default=str)
        durable_replace(tmp, path)

    def persist(self) -> Optional[str]:
        """Write meta + per-role series + flight dumps under the run
        dir (atomic per file); returns the run dir (None when
        in-memory)."""
        rd = self.run_dir
        if rd is None:
            return None
        with self._lock:
            roles = dict(self._roles)
            series = {n: {k: list(s.pts) for k, s in per.items()}
                      for n, per in self._series.items()}
            # dirty tracking: only dumps whose harvested copy is fresher
            # than the last persisted one get re-written (a long chaos
            # run must not re-serialize + fsync every unchanged dump on
            # every persist cycle)
            flight = {
                f: d for f, d in self._flight.items()
                if self._flight_persisted.get(f) != d.get("dumped_s")
            }
            all_flight = sorted(self._flight)
            profile = {
                k: s for k, s in self._profile.items()
                if self._profile_persisted.get(k) != s.get("dumped_s")
            }
            all_profile = sorted(self._profile)
        os.makedirs(os.path.join(rd, "roles"), exist_ok=True)
        os.makedirs(os.path.join(rd, "flight"), exist_ok=True)
        os.makedirs(os.path.join(rd, "profile"), exist_ok=True)
        for name, per in series.items():
            self._write_json(
                os.path.join(rd, "roles", f"{_safe_name(name)}.json"),
                {"name": name, **roles.get(name, {}), "series": per},
            )
        for fname, dump in flight.items():
            self._write_json(
                os.path.join(rd, "flight", _safe_name(fname)), dump)
            # marked clean only AFTER the write landed: a failed cycle
            # (disk full -> OSError swallowed by the scrape loop) must
            # retry this dump next time, not skip it as persisted
            with self._lock:
                self._flight_persisted[fname] = dump.get("dumped_s")
        for key, snap in profile.items():
            self._write_json(
                os.path.join(rd, "profile", f"{_safe_name(key)}.json"),
                snap)
            with self._lock:
                self._profile_persisted[key] = snap.get("dumped_s")
        self._write_json(os.path.join(rd, "meta.json"), {
            "schema": self.SCHEMA,
            "run_id": self.run_id,
            "started_s": self.started_s,
            "persisted_s": time.time(),
            "roles": roles,
            "flight_dumps": all_flight,
            "profile_snapshots": all_profile,
            "series_dropped": self.series_dropped,
        })
        with self._lock:
            self.persists += 1  # completed cycles only
        _bump("persists")
        return rd


def load_run(run_dir: str) -> dict:
    """Read one persisted run back: ``{"meta", "roles": {name:
    {"series": ...}}, "flight": {fname: dump}}`` -- the reader bench,
    tests, and ad-hoc analysis share."""
    with open(os.path.join(run_dir, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    roles: Dict[str, dict] = {}
    roles_dir = os.path.join(run_dir, "roles")
    if os.path.isdir(roles_dir):
        for fn in sorted(os.listdir(roles_dir)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(roles_dir, fn), encoding="utf-8") as f:
                rec = json.load(f)
            roles[rec.get("name", fn[:-5])] = rec
    flight: Dict[str, dict] = {}
    fdir = os.path.join(run_dir, "flight")
    if os.path.isdir(fdir):
        for fn in sorted(os.listdir(fdir)):
            try:
                with open(os.path.join(fdir, fn), encoding="utf-8") as f:
                    flight[fn] = json.load(f)
            except (OSError, ValueError):
                continue  # a torn harvest must not hide the rest
    profile: Dict[str, dict] = {}
    pdir = os.path.join(run_dir, "profile")
    if os.path.isdir(pdir):
        for fn in sorted(os.listdir(pdir)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(pdir, fn), encoding="utf-8") as f:
                    profile[fn[:-5]] = json.load(f)
            except (OSError, ValueError):
                continue
    return {"meta": meta, "roles": roles, "flight": flight,
            "profile": profile}


def list_runs(root: str) -> List[str]:
    """Run directories under a history root (newest first by meta
    mtime; dirs without a readable meta.json are skipped)."""
    out: List[Tuple[float, str]] = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for n in names:
        rd = os.path.join(root, n)
        meta = os.path.join(rd, "meta.json")
        if n.startswith("run-") and os.path.isfile(meta):
            out.append((os.path.getmtime(meta), rd))
    return [rd for (_m, rd) in sorted(out, reverse=True)]


# --------------------------------------------------------------------------
# Derived signals
# --------------------------------------------------------------------------
#: straggler-score dimensions: per-worker value / cohort median, all
#: oriented so BIGGER = slower (intervals, latencies, staleness).  The
#: value is additive smoothing applied to BOTH sides of the ratio:
#: staleness is a small integer near zero on a healthy cohort, so raw
#: 3-vs-1 ratios would flag noise -- (v+2)/(median+2) needs a genuinely
#: large staleness to clear the factor, while latency dims (floats well
#: above zero) stay unsmoothed.
STRAGGLER_DIMS = {"interval_ms": 0.0, "staleness": 2.0, "rtt_ms": 0.0,
                  "compute_ms": 0.0}


def _median(vals: Sequence[float]) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None


def straggler_scores(wstats: Dict[object, dict],
                     factor: float = 2.5,
                     min_accepted: int = 10) -> Dict[str, dict]:
    """Per-worker straggler scores vs the cohort median.

    ``wstats`` is the PS's per-worker stats section (``ps_workers``):
    wid -> flat dims.  Score = max over :data:`STRAGGLER_DIMS` of
    ``worker_value / median(the OTHER workers' values)`` -- excluding
    self keeps the score meaningful in small cohorts (with 2 workers an
    inclusive median would cap every ratio below 2, so a 10x straggler
    could never flag).  A dim needs >= 2 workers reporting and a
    positive peer median to vote; ``flagged`` at >= ``factor``.

    Warm-up guard: a worker reporting an ``accepted`` count below
    ``min_accepted`` neither scores nor votes -- its EWMAs are one or
    two samples deep (boot staggering, the calibration pause), exactly
    the noise that flags the WRONG member while half the cohort is
    still importing jax.  Stats without an ``accepted`` key (synthetic
    fixtures) are always eligible.  Pure -- the tests drive it with
    synthetic cohorts."""
    def eligible(st) -> bool:
        if not isinstance(st, dict):
            return False
        acc = st.get("accepted")
        return acc is None or (isinstance(acc, (int, float))
                               and acc >= min_accepted)

    dims_present: Dict[str, Dict[str, float]] = {}
    for dim in STRAGGLER_DIMS:
        col = {}
        for wid, st in (wstats or {}).items():
            if not eligible(st):
                continue
            v = st.get(dim)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and v >= 0:
                col[str(wid)] = float(v)
        if len(col) >= 2:
            dims_present[dim] = col
    out: Dict[str, dict] = {}
    for wid in {str(w) for w in (wstats or {})}:
        ratios: Dict[str, float] = {}
        for dim, col in dims_present.items():
            if wid not in col:
                continue
            smooth = STRAGGLER_DIMS[dim]
            med = _median([v for w, v in col.items() if w != wid])
            if med is None or med + smooth <= 0:
                continue
            ratios[dim] = (col[wid] + smooth) / (med + smooth)
        score = max(ratios.values()) if ratios else None
        out[wid] = {
            "score": None if score is None else round(score, 3),
            "dims": {d: round(r, 3) for d, r in ratios.items()},
            "flagged": bool(score is not None and score >= factor),
        }
    return out


# --------------------------------------------------------------------------
# The collector
# --------------------------------------------------------------------------
class ClusterObserver:
    """Scrape loop + history store + derived-signal computation.

    Construction reads the ``async.observer.*`` conf defaults; every
    knob is overridable per instance (tests run sub-second intervals).
    ``flight_dirs`` are harvested each tick (plus once at stop)."""

    def __init__(self, targets: Sequence[RoleTarget] = (),
                 interval_s: Optional[float] = None,
                 history_dir: Optional[str] = None,
                 history_points: Optional[int] = None,
                 persist_s: Optional[float] = None,
                 straggler_factor: Optional[float] = None,
                 flight_dirs: Sequence[str] = (),
                 run_id: Optional[str] = None):
        from asyncframework_tpu_torch.conf import (
            OBSERVER_HISTORY_DIR,
            OBSERVER_HISTORY_POINTS,
            OBSERVER_INTERVAL_S,
            OBSERVER_PERSIST_S,
            OBSERVER_STRAGGLER_FACTOR,
            global_conf,
        )
        from asyncframework_tpu_torch.metrics.live import RUN_ID

        conf = global_conf()
        self.interval_s = (float(conf.get(OBSERVER_INTERVAL_S))
                           if interval_s is None else float(interval_s))
        self.persist_s = (float(conf.get(OBSERVER_PERSIST_S))
                          if persist_s is None else float(persist_s))
        self.straggler_factor = (
            float(conf.get(OBSERVER_STRAGGLER_FACTOR))
            if straggler_factor is None else float(straggler_factor))
        root = (str(conf.get(OBSERVER_HISTORY_DIR) or "").strip()
                if history_dir is None else str(history_dir))
        points = (int(conf.get(OBSERVER_HISTORY_POINTS))
                  if history_points is None else int(history_points))
        self.history = RunHistoryStore(root or None, run_id or RUN_ID,
                                       points=points)
        self.flight_dirs = [str(d) for d in flight_dirs if d]
        self._lock = threading.Lock()
        self._static: List[RoleTarget] = list(targets)
        self._discovered_names: set = set()
        self._target_state: Dict[str, dict] = {}
        self._last_status: Dict[str, dict] = {}
        self._derived: Dict[str, float] = {}
        self._stragglers: Dict[str, dict] = {}
        self._flagged: set = set()
        #: (primary role name, t_s, ps.accepted) of the last tick --
        #: push_rate only differences the SAME role's counter
        self._prev_accept: Optional[Tuple[str, float, float]] = None
        self._push_rate: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._source_fn: Optional[Callable] = None
        self._section_fn: Optional[Callable] = None

    # ------------------------------------------------------------- discovery
    def add_targets(self, targets: Sequence[RoleTarget]) -> None:
        with self._lock:
            known = {t.name for t in self._static}
            for t in targets:
                if t.name not in known:
                    self._static.append(t)
                    known.add(t.name)

    def _discover_shardgroup(self) -> List[RoleTarget]:
        """The active ShardGroup's per-shard telemetry endpoints (the
        controller pre-assigns each slot a metrics port, so a relaunched
        shard keeps its scrape URL)."""
        try:
            from asyncframework_tpu_torch.parallel import shardgroup

            group = shardgroup.active_group()
            if group is None:
                return []
            return [RoleTarget(name=n, role=r, url=u)
                    for (n, r, u) in group.telemetry_targets()]
        except Exception:  # noqa: BLE001 - a half-built group must not
            return []      # kill the scrape loop

    def _discover_supervisors(self) -> List[RoleTarget]:
        """Worker processes registered with any live ElasticSupervisor
        in this process: HELLO advertises the worker's telemetry port
        (``mport``), the supervisor records it, the observer scrapes
        it."""
        try:
            from asyncframework_tpu_torch.parallel import supervisor as sup_mod

            out: List[RoleTarget] = []
            seen = set()
            for sup in sup_mod.active_supervisors():
                for rec in sup.proc_records():
                    mport = rec.get("mport")
                    host = rec.get("host")
                    proc = rec.get("proc")
                    if not mport or not host or proc in seen:
                        continue
                    seen.add(proc)
                    out.append(RoleTarget(
                        name=f"worker-{proc}", role="worker",
                        url=f"http://{host}:{int(mport)}"))
            return out
        except Exception:  # noqa: BLE001 - discovery is best-effort
            return []

    def targets(self) -> List[RoleTarget]:
        """Static + discovered targets, deduped by name (static wins)."""
        with self._lock:
            out = list(self._static)
            known = set(self._discovered_names)
        seen = {t.name for t in out}
        fresh = []
        for t in self._discover_shardgroup() + self._discover_supervisors():
            if t.name not in seen:
                seen.add(t.name)
                out.append(t)
                if t.name not in known:
                    fresh.append(t.name)
        if fresh:
            # counted once per NAME, not once per tick: "discovered" is
            # how many roles discovery ever surfaced, not a tick rate
            with self._lock:
                new = [n for n in fresh
                       if n not in self._discovered_names]
                self._discovered_names.update(new)
            if new:
                _bump("discovered", len(new))
        return out

    # --------------------------------------------------------------- scraping
    def _fetch_status(self, target: RoleTarget) -> dict:
        """One /api/status fetch over the net/ retry plane (short
        policy; the scrape LOOP is the real retry, and the shared
        breaker keeps a dead role from stalling every tick)."""
        from asyncframework_tpu_torch.net.retry import RetryPolicy

        url = target.url.rstrip("/") + "/api/status"
        timeout = max(0.2, min(2.0, self.interval_s or 1.0))

        def get() -> dict:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return json.loads(resp.read().decode())

        policy = RetryPolicy(max_attempts=2, base_ms=20.0, max_ms=100.0,
                             attempt_timeout_s=timeout,
                             deadline_s=2 * timeout,
                             breaker_threshold=5, breaker_cooldown_s=2.0)
        return policy.call(get, endpoint=target.url)

    def _fold(self, target: RoleTarget, status: dict, t_s: float) -> None:
        hist = self.history
        hist.note_role(target.name, target.role, target.url)
        hist.record(target.name, "up", t_s, 1.0)
        # the per-process sampler already normalized everything into
        # series; its last-value map is the scrape surface
        last = ((status.get("timeseries") or {}).get("last") or {})
        for key, v in last.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                hist.record(target.name, key, t_s, v)
        # driver-dashboard scalars (the PS with a run listener)
        for key in ("updates_per_sec", "accepted", "dropped",
                    "model_version", "queue_depth", "max_staleness"):
            v = status.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                hist.record(target.name, f"run.{key}", t_s, v)
        # continuous-profiling section (async.prof.enabled roles):
        # harvest the snapshot next to the flight dumps so the zone
        # decomposition outlives the process even without a crash
        prof = status.get("profile")
        if isinstance(prof, dict) and prof.get("zones"):
            hist.harvest_profile(prof, f"scrape:{target.name}")

    def scrape_once(self) -> dict:
        """One pass over every target; returns per-target ok/error (the
        CLI prints it) and recomputes the derived signals."""
        t_s = time.time()
        results: Dict[str, dict] = {}
        current = self.targets()
        # prune DISCOVERED targets that discovery no longer returns (a
        # promotion handed the role a new port, a supervisor forgot a
        # member): their stale last-status must not keep feeding the
        # derived signals or the roles_up count.  Static targets stay --
        # the operator asked for them, DOWN is the honest answer there.
        names = {t.name for t in current}
        with self._lock:
            gone = [n for n in self._discovered_names if n not in names]
            for n in gone:
                self._discovered_names.discard(n)
                self._target_state.pop(n, None)
                self._last_status.pop(n, None)
        for target in current:
            try:
                status = self._fetch_status(target)
            except (OSError, ValueError) as e:
                _bump("scrape_errors")
                self.history.record(target.name, "up", t_s, 0.0)
                self.history.note_role(target.name, target.role,
                                       target.url)
                results[target.name] = {"ok": False,
                                        "error": f"{type(e).__name__}"}
                with self._lock:
                    st = self._target_state.setdefault(target.name, {})
                    st.update(role=target.role, url=target.url, up=False)
                    st["errors"] = st.get("errors", 0) + 1
                continue
            _bump("scrapes")
            self._fold(target, status, t_s)
            with self._lock:
                self._last_status[target.name] = status
                st = self._target_state.setdefault(target.name, {})
                st.update(role=target.role, url=target.url, up=True,
                          last_ok_s=t_s)
            results[target.name] = {"ok": True}
        self._recompute_derived(t_s)
        self.harvest_flight()
        return results

    # --------------------------------------------------------------- derived
    def _recompute_derived(self, t_s: float) -> None:
        with self._lock:
            states = dict(self._target_state)
            # derived signals read LIVE roles only: a dead role's final
            # scraped status must not keep owning primary selection,
            # push_rate, or the fleet_done gate after a failover (the
            # fleet view still shows the corpse's last numbers per
            # role; the cross-role signals follow the living)
            statuses = {n: s for n, s in self._last_status.items()
                        if states.get(n, {}).get("up")}
        derived: Dict[str, float] = {}
        up = sum(1 for st in states.values() if st.get("up"))
        derived["roles_up"] = float(up)
        derived["roles_down"] = float(len(states) - up)

        def series_last(status: dict, key: str) -> Optional[float]:
            v = ((status.get("timeseries") or {}).get("last")
                 or {}).get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
            return None

        # the primary PS view: the scraped role with the largest
        # ps.accepted owns the merge plane (secondaries/standbys report
        # their own ranges)
        primary: Optional[dict] = None
        primary_name: Optional[str] = None
        best = -1.0
        done = 0.0
        for name, status in statuses.items():
            acc = series_last(status, "ps.accepted")
            if acc is not None and acc > best:
                best, primary, primary_name = acc, status, name
        if primary is not None:
            acc = series_last(primary, "ps.accepted")
            qd = series_last(primary, "ps.queue_depth")
            if qd is not None:
                derived["merge_queue_depth"] = qd
            if series_last(primary, "ps.done"):
                done = 1.0
            # push_rate = d(ps.accepted)/dt of the SAME role across
            # ticks: when the argmax flips (close shard counts, a
            # failover to a lower-clock member) the baseline resets
            # instead of differencing two different counters into a
            # spurious spike.  Under the lock: scrape_once can run
            # concurrently (loop + bench's final manual scrape).
            if acc is not None:
                with self._lock:
                    prev = self._prev_accept
                    self._prev_accept = (primary_name, t_s, acc)
                    if prev is not None and prev[0] == primary_name \
                            and t_s > prev[1]:
                        self._push_rate = max(
                            0.0, (acc - prev[2]) / (t_s - prev[1]))
                    rate = self._push_rate
                if rate is not None:
                    derived["push_rate"] = round(rate, 3)
        derived["fleet_done"] = done
        # fleet freshness: the STALEST serving replica prices the fleet
        lags = [series_last(s, "serving.freshness_lag_ms")
                for s in statuses.values()]
        lags = [v for v in lags if v is not None]
        if lags:
            derived["freshness_lag_ms"] = max(lags)
        # per-worker straggler scores from whichever role carries the
        # PS's per-worker stats section (the primary's /api/status)
        wstats: Dict[str, dict] = {}
        for status in statuses.values():
            sec = status.get("ps_workers")
            if isinstance(sec, dict) and sec:
                wstats.update(sec)
        stragglers = straggler_scores(wstats, self.straggler_factor)
        scores = [s["score"] for s in stragglers.values()
                  if s.get("score") is not None]
        if scores:
            derived["straggler_score"] = max(scores)
        newly = {w for w, s in stragglers.items() if s["flagged"]}
        with self._lock:
            fresh = newly - self._flagged
            self._flagged |= newly
            self._stragglers = stragglers
            self._derived = derived
        if fresh:
            _bump("stragglers_flagged", len(fresh))
        # the derived signals are a role too: the controller reading
        # history wants observer.* next to every ps.* series
        for k, v in derived.items():
            self.history.record("observer", f"observer.{k}", t_s, v)

    def derived(self) -> Dict[str, float]:
        """The flat ``observer.*`` source dict (registered with the
        sampler; also what bench snapshots)."""
        with self._lock:
            return dict(self._derived)

    def stragglers(self) -> Dict[str, dict]:
        """The per-worker straggler table from the last recompute
        (wid -> score/flagged/dims) -- the adaptive controller's
        per-worker damp input (parallel/controller.py)."""
        with self._lock:
            return {w: dict(s) for w, s in self._stragglers.items()}

    # ---------------------------------------------------------------- flight
    #: how far before this collector's start a dump may have been
    #: written and still belong to ITS run: roles often boot (and flush)
    #: before the collector, but a dump idle since long before that is
    #: a previous run's leftover (dumps are never cleaned up -- a
    #: restarted collector against yesterday's --flight-dir must not
    #: attribute yesterday's crashes to today's run)
    FLIGHT_MAX_AGE_S = 120.0

    def harvest_flight(self) -> int:
        """Scan the flight dirs for dumps and fold new/fresher ones into
        the history store; returns how many were (re)harvested.  Dumps
        last written more than :data:`FLIGHT_MAX_AGE_S` before this
        collector started are skipped (counted) as stale leftovers."""
        from asyncframework_tpu_torch.metrics import flightrec

        cutoff = self.history.started_s - self.FLIGHT_MAX_AGE_S
        n = stale = 0
        for d in self.flight_dirs:
            for path in flightrec.scan_dumps(d):
                try:
                    dump = flightrec.load_dump(path)
                except (OSError, ValueError):
                    continue  # torn mid-write: the next flush completes it
                if float(dump.get("dumped_s") or 0) < cutoff:
                    stale += 1
                    continue
                if self.history.harvest(dump, source=path):
                    n += 1
        if n:
            _bump("harvests", n)
        if stale:
            _bump("harvest_stale_skipped", stale)
        return n

    # --------------------------------------------------------------- serving
    def fleet_snapshot(self) -> dict:
        """The ``observer`` /api/status section + async-top's fleet
        view: per-role liveness and key numbers, derived signals,
        straggler table, history summary."""
        with self._lock:
            states = {n: dict(st) for n, st in self._target_state.items()}
            statuses = dict(self._last_status)
            derived = dict(self._derived)
            stragglers = dict(self._stragglers)

        def series_last(status, key):
            v = ((status.get("timeseries") or {}).get("last")
                 or {}).get(key)
            return v if isinstance(v, (int, float)) else None

        roles = {}
        for name, st in sorted(states.items()):
            status = statuses.get(name) or {}
            roles[name] = {
                "role": st.get("role"),
                "url": st.get("url"),
                "up": bool(st.get("up")),
                "errors": st.get("errors", 0),
                "run_id": status.get("run_id"),
                "health": (status.get("health") or {}).get("state"),
                "accepted": series_last(status, "ps.accepted"),
                "staleness": series_last(status, "ps.max_staleness"),
                "qps": series_last(status, "serving.qps"),
                "freshness_lag_ms": series_last(
                    status, "serving.freshness_lag_ms"),
            }
            # compact zone-share row (async.prof.enabled roles): the
            # top sampled zones, enough for async-mon's fleet table
            # without dragging whole stack maps through every snapshot
            prof = status.get("profile")
            if isinstance(prof, dict) and isinstance(prof.get("zones"),
                                                     dict):
                top = sorted(
                    ((z, float((d or {}).get("share", 0.0)))
                     for z, d in prof["zones"].items()),
                    key=lambda kv: -kv[1])[:4]
                roles[name]["profile"] = {
                    "samples": prof.get("samples", 0),
                    "zones": {z: round(s, 4) for z, s in top if s > 0},
                }
        # adaptive control plane: whichever LIVE role serves a
        # ``control`` status section (the primary PS running the
        # AsyncController) contributes it to the fleet view, so
        # async-mon renders the current knob values next to the
        # stragglers that drive them.  Live roles only -- a SIGKILLed
        # primary's cached final status must not shadow its
        # replacement's board (the corpse-owns-the-fleet-view class
        # the derived signals were already hardened against)
        control = None
        for name, st in sorted(states.items()):
            if not st.get("up"):
                continue
            sec = (statuses.get(name) or {}).get("control")
            if isinstance(sec, dict) and sec:
                control = {"role": name, **sec}
                break
        out = {
            "interval_s": self.interval_s,
            "roles": roles,
            "derived": derived,
            "stragglers": stragglers,
            "straggler_factor": self.straggler_factor,
            "history": self.history.summary(),
            "totals": observer_totals(),
        }
        if control is not None:
            out["control"] = control
        return out

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "ClusterObserver":
        """Register the ``observer`` source + status section and start
        the scrape loop (interval <= 0: registration only)."""
        from asyncframework_tpu_torch.metrics import live, timeseries

        self._source_fn = self.derived
        timeseries.register_source("observer", self._source_fn)
        self._section_fn = self.fleet_snapshot
        live.register_status_section("observer", self._section_fn)
        timeseries.ensure_started()
        if self.interval_s <= 0:
            return self
        last_persist = [time.monotonic()]

        def loop() -> None:
            while not self._stop.wait(timeout=self.interval_s):
                try:
                    self.scrape_once()
                except Exception:  # noqa: BLE001 - one bad tick must not
                    pass           # end observation for good
                if (self.persist_s > 0 and
                        time.monotonic() - last_persist[0]
                        >= self.persist_s):
                    last_persist[0] = time.monotonic()
                    try:
                        self.history.persist()
                    except OSError:
                        pass  # a full disk must not kill the scrape loop

        self._thread = threading.Thread(
            target=loop, name="observer-scrape", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        from asyncframework_tpu_torch.metrics import live, timeseries

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._source_fn is not None:
            timeseries.unregister_source("observer", self._source_fn)
            self._source_fn = None
        if self._section_fn is not None:
            live.unregister_status_section("observer", self._section_fn)
            self._section_fn = None
        self.harvest_flight()
        try:
            self.history.persist()
        except OSError:
            pass


# --------------------------------------------------------------------------
# CLI (async-mon: python -m asyncframework_tpu_torch.metrics.observer)
# --------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    from asyncframework_tpu_torch.conf import OBSERVER_ENDPOINTS, global_conf

    p = argparse.ArgumentParser(
        "async-mon",
        description="cluster observer: scrape every role, persist run "
                    "history, derive fleet signals, harvest flight "
                    "recorder dumps",
    )
    p.add_argument("--endpoints", default=None,
                   help="';'-separated name=role@host:port targets "
                        "(default: conf async.observer.endpoints)")
    p.add_argument("--interval", type=float, default=None,
                   help="scrape period seconds (default: conf)")
    p.add_argument("--history-dir", default=None,
                   help="run-history root (default: conf "
                        "async.observer.history.dir; empty = memory "
                        "only)")
    p.add_argument("--flight-dir", action="append", default=[],
                   help="flight-recorder dump dir to harvest "
                        "(repeatable)")
    p.add_argument("--port", type=int, default=None,
                   help="serve this collector's own /api/status + "
                        "/metrics here (0 = ephemeral; default: conf "
                        "async.metrics.port gating)")
    p.add_argument("--once", action="store_true",
                   help="one scrape, print the fleet view, exit")
    args = p.parse_args(argv)

    text = (args.endpoints if args.endpoints is not None
            else str(global_conf().get(OBSERVER_ENDPOINTS)))
    obs = ClusterObserver(
        targets=parse_endpoints(text),
        interval_s=args.interval,
        history_dir=args.history_dir,
        flight_dirs=args.flight_dir,
    )
    if args.once:
        obs.scrape_once()
        from asyncframework_tpu_torch.metrics.top import render_fleet

        sys.stdout.write(render_fleet(obs.fleet_snapshot()))
        obs.history.persist()
        return 0
    from asyncframework_tpu_torch.metrics.live import LiveUIServer

    srv = None
    if args.port is not None:
        srv = LiveUIServer(None, port=args.port, host="0.0.0.0",
                           role="observer").start()
        print(f"async-mon: serving fleet view on port {srv.port}",
              flush=True)
    # SIGTERM (kubectl delete / rollout restart of the rendered
    # Deployment) must run the same graceful path as Ctrl-C: the final
    # flight harvest + history persist in obs.stop() is the whole point
    # of a durable collector
    stop_ev = threading.Event()
    try:
        import signal as _signal

        _signal.signal(_signal.SIGTERM, lambda *_a: stop_ev.set())
    except (ValueError, OSError):
        pass  # not the main thread (embedded use): Ctrl-C still works
    obs.start()
    try:
        while not stop_ev.wait(timeout=60.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        obs.stop()
        if srv is not None:
            srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

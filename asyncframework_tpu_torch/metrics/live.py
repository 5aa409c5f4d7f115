"""Live run dashboard: HTTP endpoint serving in-progress run state.

Parity: ``ui/SparkUI.scala:39`` -- the reference serves jobs / stages /
executors pages *during* a run from the listener-bus-fed AppStatusStore;
the post-hoc analog here is ``metrics/report.py`` + ``metrics/history.py``.
A long ASGD run is no longer a black box until it ends.

Design: a :class:`LiveStateListener` subscribes to the run's ListenerBus
(same events the event log gets) and folds them into one JSON-able snapshot
-- rounds, accepted/dropped, updates/s, staleness histogram, queue depth,
per-worker state, losses/moves/speculation.  A stdlib ThreadingHTTPServer
(daemon threads, ephemeral port support) serves:

- ``GET /api/status`` -- the snapshot (machine-readable; tests poll this)
- ``GET /``           -- a self-refreshing HTML view of the same snapshot

Zero dependencies, nothing on the hot path: the listener runs on the bus's
single drain thread; HTTP reads take the same lock only per request.

A copy of the JAX package's ``metrics/live.py``: one event log replayed
into either package's :class:`LiveStateListener` gives the same snapshot.
The section of a subsystem this package does not have yet is left out:
``shuffle`` (ROADMAP A9).
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from asyncframework_tpu_torch.metrics.bus import (
    Event,
    GradientMerged,
    Listener,
    ModelSnapshot,
    RoundSubmitted,
    ShardMoved,
    SpeculativeLaunch,
    TraceSpan,
    WorkerLost,
)
from asyncframework_tpu_torch.metrics.trace import Span, TraceAggregator

#: running servers by most-recent-first (tests and tools discover ephemeral
#: ports here; entries are removed on stop)
_ACTIVE: List["LiveUIServer"] = []
_ACTIVE_LOCK = threading.Lock()

#: process-wide run identity: stamped as the ``run_id`` label on every
#: /metrics sample and in /api/status, so a Prometheus scrape (or a human
#: comparing two dashboards) can tell process restarts apart
RUN_ID = f"{uuid.uuid4().hex[:8]}-{os.getpid()}"

#: dynamically registered /api/status sections (name -> zero-arg dict
#: provider): the generic hook subsystems use to surface themselves on
#: every dashboard page -- the PS registers ``ps_workers`` (per-worker
#: stats the observer's straggler scoring reads), the cluster observer
#: registers ``observer`` (the fleet view async-top renders).  Last
#: registration under a name wins; unregister is identity-gated like
#: the time-series sources.
_SECTIONS_LOCK = threading.Lock()
_STATUS_SECTIONS: Dict[str, Callable[[], Dict]] = {}


def register_status_section(name: str, fn: Callable[[], Dict]) -> None:
    with _SECTIONS_LOCK:
        _STATUS_SECTIONS[name] = fn


def unregister_status_section(name: str, fn=None) -> None:
    """Remove a section; with ``fn`` given, only if it is still the
    registered one (a stopped subsystem must not unhook its
    replacement)."""
    with _SECTIONS_LOCK:
        if fn is None or _STATUS_SECTIONS.get(name) is fn:
            _STATUS_SECTIONS.pop(name, None)


def telemetry_port() -> Optional[int]:
    """The port of this process's most recent live/telemetry server
    (None when nothing serves).  Workers advertise it on HELLO
    (``mport``) so supervisors -- and through them the cluster
    observer -- can discover per-role scrape endpoints."""
    servers = active_servers()
    return servers[0].port if servers else None


def _family_totals() -> "Dict[str, Dict[str, int]]":
    from asyncframework_tpu_torch.metrics import registry

    out: Dict[str, Dict[str, int]] = {}
    for name, fam in registry.families().items():
        try:
            out[name] = fam.totals()
        except Exception:  # noqa: BLE001 - one family must not 500 the
            out[name] = {}  # whole status endpoint
    return out


def _baseline_families() -> Dict[str, object]:
    """The registry families the live UI delta-baselines (per-run view);
    keys -> CounterFamily."""
    from asyncframework_tpu_torch.metrics import registry

    return {n: f for n, f in registry.families().items() if f.baseline}


def _serving_snapshot() -> Dict:
    from asyncframework_tpu_torch.serving.metrics import serving_snapshot

    return serving_snapshot()


def _lockwatch_totals() -> Dict:
    from asyncframework_tpu_torch.net import lockwatch

    return lockwatch.totals()


def _telemetry_sections() -> Dict[str, object]:
    """The process-global telemetry-plane sections shared by every
    /api/status (with or without a run listener): convergence curves +
    summary, SLO health, and the time-series store meta-view."""
    from asyncframework_tpu_torch.metrics import slo, timeseries

    conv = timeseries.convergence()
    try:
        health = slo.engine().health()
    except Exception as e:  # noqa: BLE001 - a typo'd async.slo.rules must
        # surface AS the health section, not 500 every dashboard page
        # fleet-wide while training runs fine
        health = {"state": "error", "rules": {},
                  "error": f"{type(e).__name__}: {e}"}
    out = {
        "convergence": {**conv.summary(), "curves": conv.curves()},
        "health": health,
        "timeseries": timeseries.store().summary(),
    }
    try:
        from asyncframework_tpu_torch.parallel import shardgroup

        group = shardgroup.active_group()
        if group is not None:
            # per-shard section (parallel/shardgroup.py): the process
            # hosting the shard-group controller shows its map + member
            # liveness on every dashboard page
            out["shards"] = group.status_section()
    except Exception:  # noqa: BLE001 - a half-torn-down group must not
        pass           # 500 every dashboard page
    with _SECTIONS_LOCK:
        sections = dict(_STATUS_SECTIONS)
    for name, fn in sections.items():
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 - one subsystem's section must
            pass           # not 500 every dashboard page
    return out


def process_status(role: str = "process") -> Dict[str, object]:
    """/api/status body for a process WITHOUT a run listener (workers,
    serving replicas/frontends, the master): raw counter-family totals
    plus the telemetry-plane sections."""
    return {
        "role": role,
        "run_id": RUN_ID,
        "pid": os.getpid(),
        "counters": _family_totals(),
        **_telemetry_sections(),
    }


def active_servers() -> List["LiveUIServer"]:
    with _ACTIVE_LOCK:
        return list(_ACTIVE)


def _delta(cur: Dict[str, int], base: Dict[str, int]) -> Dict[str, int]:
    """Per-run view of a process-global counter dict: subtract the values
    captured when THIS run's listener was built, so a second run in the
    same process does not inherit the first run's counts.  A key the
    baseline never saw passes through raw."""
    return {k: v - base.get(k, 0) for k, v in cur.items()}


class LiveStateListener(Listener):
    """Folds bus events into the dashboard snapshot (AppStatusStore role)."""

    STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)

    def __init__(self, num_workers: int):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.num_workers = num_workers
        self.rounds = 0
        self.accepted = 0
        self.dropped = 0
        self.model_version = 0
        self.workers_lost = 0
        self.shards_moved = 0
        self.speculative_launches = 0
        self.last_objective: Optional[float] = None
        self.staleness_hist = [0] * (len(self.STALENESS_BUCKETS) + 1)
        self.max_staleness = 0
        # per-worker: {state, merges, accepted, last_staleness, last_seen_ms}
        self.workers: Dict[int, Dict] = {
            w: {"state": "idle", "merges": 0, "accepted": 0,
                "last_staleness": None, "last_seen_ms": None}
            for w in range(num_workers)
        }
        self._queue_depth_fn: Optional[Callable[[], int]] = None
        # per-run trace view: TraceSpan events folded into this listener's
        # OWN aggregator (the process-global one keeps accumulating for
        # tools; the dashboard shows this run only)
        self._trace = TraceAggregator()
        # per-run delta baselines for the process-global counter panels: a
        # second run's dashboard must not inherit the first run's counts.
        # Registry-driven (metrics/registry.py): every baseline family
        # gets captured here by construction -- a family added to the
        # registry cannot be forgotten by this listener (the audit test
        # in tests/test_torch_telemetry.py checks the coverage).
        self._bases: Dict[str, Dict[str, int]] = {
            name: fam.totals()
            for name, fam in _baseline_families().items()
        }

    def register_queue_depth(self, fn: Callable[[], int]) -> None:
        self._queue_depth_fn = fn

    # ----------------------------------------------------------- bus events
    def on_event(self, event: Event) -> None:
        with self._lock:
            if isinstance(event, RoundSubmitted):
                # count events rather than trusting round_idx: async paths
                # post 1-based counters, sync paths 0-based loop indices
                self.rounds += 1
                self.model_version = event.model_version
                for wid in event.cohort:
                    if wid in self.workers:
                        self.workers[wid]["state"] = "running"
            elif isinstance(event, GradientMerged):
                if event.accepted:
                    self.accepted += 1
                else:
                    self.dropped += 1
                s = event.staleness
                self.max_staleness = max(self.max_staleness, s)
                import bisect

                # bisect_left: staleness == bucket bound belongs in "<=b"
                self.staleness_hist[
                    bisect.bisect_left(self.STALENESS_BUCKETS, s)
                ] += 1
                w = self.workers.get(event.worker_id)
                if w is not None:
                    w["state"] = "idle"
                    w["merges"] += 1
                    w["accepted"] += int(event.accepted)
                    w["last_staleness"] = s
                    w["last_seen_ms"] = event.time_ms
            elif isinstance(event, WorkerLost):
                self.workers_lost += 1
                w = self.workers.get(event.worker_id)
                if w is not None:
                    w["state"] = "lost"
            elif isinstance(event, ShardMoved):
                self.shards_moved += 1
            elif isinstance(event, SpeculativeLaunch):
                self.speculative_launches += 1
            elif isinstance(event, ModelSnapshot):
                self.last_objective = event.objective
            elif isinstance(event, TraceSpan):
                self._trace.add(Span(
                    stage=event.stage, trace_id=event.trace_id,
                    span_id=event.span_id, parent_id=event.parent_id,
                    worker_id=event.worker_id,
                    model_version=event.model_version,
                    start_ms=event.start_ms, dur_ms=event.dur_ms,
                    staleness=event.staleness,
                    staleness_ms=event.staleness_ms,
                    accepted=event.accepted,
                    bytes=getattr(event, "bytes", None),
                ))

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict:
        fams = _family_totals()  # one read per family: delta + raw agree
        # process-global, touches no listener state -- and it runs a full
        # SLO evaluation plus convergence-curve assembly, so gathering it
        # under self._lock would stall every bus event callback behind
        # each dashboard poll
        telemetry = _telemetry_sections()
        with self._lock:
            elapsed = time.monotonic() - self._t0
            buckets = [
                f"<={b}" for b in self.STALENESS_BUCKETS
            ] + [f">{self.STALENESS_BUCKETS[-1]}"]
            pl = fams["pipeline"]
            return {
                "run_id": RUN_ID,
                "elapsed_s": round(elapsed, 3),
                "rounds": self.rounds,
                "accepted": self.accepted,
                "dropped": self.dropped,
                "updates_per_sec": round(self.accepted / elapsed, 1)
                if elapsed > 0 else 0.0,
                "model_version": self.model_version,
                "queue_depth": (
                    self._queue_depth_fn() if self._queue_depth_fn else None
                ),
                "staleness": dict(zip(buckets, self.staleness_hist)),
                "max_staleness": self.max_staleness,
                "workers_lost": self.workers_lost,
                "shards_moved": self.shards_moved,
                "speculative_launches": self.speculative_launches,
                "last_objective": self.last_objective,
                "workers": {str(k): dict(v) for k, v in self.workers.items()},
                # (the JAX package's ``shuffle`` section comes with
                # data/spill.py, ROADMAP A9)
                # DCN robustness counters (net/): retries taken, breaker
                # trips, dedup hits, faults fired -- the failure-handling
                # subsystem's health at a glance (per-run delta)
                "net": dict(
                    _delta(fams["net"], self._bases["net"]),
                    # wire-bytes accounting (net/frame.py choke point):
                    # per-op sent/received frame bytes, per-run delta
                    bytes=_delta(fams["net_bytes"],
                                 self._bases["net_bytes"]),
                ),
                # elastic-plane counters (parallel/supervisor.py): workers
                # declared dead, shards adopted by survivors, rejoins,
                # surrogate releases, PS checkpoint resumes (per-run delta)
                "recovery": _delta(fams["recovery"],
                                   self._bases["recovery"]),
                # pipelined update-loop counters (parallel/ps_dcn.py):
                # prefetch hits/waits, stale-prefetch discards, async
                # pushes (per-run delta); inflight_max is a high-water
                # mark, shown raw
                "pipeline": dict(
                    _delta({k: v for k, v in pl.items()
                            if k != "inflight_max"},
                           self._bases["pipeline"]),
                    inflight_max=pl.get("inflight_max", 0),
                ),
                # serving-plane counters (serving/metrics.py): predicts,
                # failovers, unhealthy rejects, refresh shapes (per-run
                # delta of the flat counters) plus the derived views --
                # QPS over the delta'd window, predict-latency and
                # freshness-lag (versions + ms) percentiles, per-replica
                # breakdown -- shown raw (rings are reset-scoped, not
                # baseline-scoped)
                "serving": dict(
                    _delta(fams["serving"], self._bases["serving"]),
                    detail=_serving_snapshot(),
                ),
                # debug lock watchdog (net/lockwatch.py): socket-IO-under-
                # model-lock violations (the lock-free PULL claim; 0 =
                # holding) and hold-time stats, raw
                "lockwatch": _lockwatch_totals(),
                # distributed-trace section (metrics/trace.py): per-stage
                # latency p50/p95/p99 and staleness in versions AND ms,
                # folded from this run's TraceSpan events
                "trace": self._trace.snapshot(),
                # telemetry plane (metrics/timeseries.py + slo.py):
                # convergence curves + summary, SLO health with burn
                # durations, and the time-series store's meta-view (full
                # rings on /api/timeseries)
                **telemetry,
            }


_PAGE = """<!doctype html><html><head><title>async run</title>
<meta http-equiv="refresh" content="1">
<style>body{font-family:monospace;margin:2em;background:#111;color:#ddd}
table{border-collapse:collapse}td,th{border:1px solid #444;padding:4px 10px}
h1{font-size:1.2em}.k{color:#8cf}</style></head><body>
<h1>asyncframework-tpu &mdash; live run</h1><pre id="s">%s</pre>
</body></html>"""


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "AsyncLiveUI/1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _status(self) -> Dict:
        state = self.server.state_listener  # type: ignore[attr-defined]
        if state is not None:
            return state.snapshot()
        return process_status(
            role=self.server.role  # type: ignore[attr-defined]
        )

    def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
        if self.path.startswith("/api/status"):
            body = json.dumps(self._status()).encode()
            self._send(200, body, "application/json")
        elif self.path.startswith("/api/timeseries"):
            # the full bounded rings (async-top sparklines, ad-hoc
            # plotting); /api/status carries only the meta-view
            from asyncframework_tpu_torch.metrics import timeseries

            body = json.dumps(timeseries.store().dump()).encode()
            self._send(200, body, "application/json")
        elif self.path.startswith("/metrics"):
            # Prometheus text exposition (format 0.0.4), stamped with
            # this server's process labels
            from asyncframework_tpu_torch.metrics import prom

            body = prom.render(
                self.server.prom_labels  # type: ignore[attr-defined]
            ).encode()
            self._send(200, body, "text/plain; version=0.0.4")
        elif self.path == "/" or self.path.startswith("/index"):
            snap = json.dumps(self._status(), indent=2)
            self._send(200, (_PAGE % snap).encode(), "text/html")
        else:
            self._send(404, b"not found", "text/plain")

    def log_message(self, *a) -> None:  # quiet: no stderr per request
        pass


class LiveUIServer:
    """Threaded HTTP server around an optional :class:`LiveStateListener`.

    With ``state=None`` this is a bare **telemetry server**: /api/status
    serves the process-global counter/convergence/health view and
    /metrics the Prometheus exposition -- the per-process endpoint
    workers, serving replicas, frontends, and the master expose (see
    :func:`start_telemetry_from_conf`).  With a state listener it is the
    full live run dashboard, same endpoints included.

    ``port=0`` binds an ephemeral port (read it from ``.port`` after
    ``start``; also discoverable via :func:`active_servers`).
    ``role``/``labels`` become the Prometheus labels on every sample
    (plus ``run_id``, stamped automatically).
    """

    def __init__(self, state: Optional[LiveStateListener], port: int = 0,
                 host: str = "127.0.0.1", role: str = "driver",
                 labels: Optional[Dict[str, str]] = None):
        self.state = state
        self.role = role
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.state_listener = state  # type: ignore[attr-defined]
        self._httpd.role = role  # type: ignore[attr-defined]
        self._httpd.prom_labels = dict(  # type: ignore[attr-defined]
            {"role": role, "run_id": RUN_ID}, **(labels or {})
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "LiveUIServer":
        # the continuous-telemetry contract: any process serving
        # /metrics or a dashboard also samples its counters into the
        # time-series store (SLO windows need history, not points)
        from asyncframework_tpu_torch.metrics import timeseries

        timeseries.ensure_started()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="live-ui", daemon=True
        )
        self._thread.start()
        with _ACTIVE_LOCK:
            _ACTIVE.insert(0, self)
        return self

    def stop(self) -> None:
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def start_telemetry_from_conf(role: str, host: str = "0.0.0.0",
                              labels: Optional[Dict[str, str]] = None
                              ) -> Optional[LiveUIServer]:
    """Start this process's bare telemetry endpoint when conf asks.

    Reads ``async.metrics.port`` (-1 = off, the default; 0 = ephemeral):
    every daemon entry point (worker daemon, serving replica/frontend,
    master, cluster roles) calls this once at boot, so setting one conf
    key -- or the ``ASYNCTPU_ASYNC_METRICS_PORT`` env var the k8s
    manifests ship -- lights up /metrics and /api/status fleet-wide.

    The crash flight recorder and the continuous profiler ride the same
    choke point (``async.flight.dir`` / ``async.prof.enabled`` gate them
    independently of the port): every role that can serve telemetry also
    keeps its post-mortem ring and its profile plane, and a new daemon
    entry point cannot wire one without the others."""
    from asyncframework_tpu_torch.conf import METRICS_PORT, global_conf
    from asyncframework_tpu_torch.metrics import flightrec
    from asyncframework_tpu_torch.metrics import profiler as _profiler

    flightrec.install_from_conf(role)
    _profiler.install_from_conf(role)
    port = int(global_conf().get(METRICS_PORT))
    if port < 0:
        return None
    try:
        return LiveUIServer(None, port=port, host=host, role=role,
                            labels=labels).start()
    except OSError:
        # the port is taken -- e.g. a DCN executor inheriting its pod's
        # ASYNCTPU_ASYNC_METRICS_PORT while the worker daemon already
        # serves it.  Telemetry is best-effort fleet plumbing: the
        # process must come up either way.
        return None

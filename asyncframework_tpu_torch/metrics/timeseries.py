"""Continuous telemetry: bounded time-series store + convergence history.

The ASYNC paper's second pillar is *history* -- the runtime must record
how the computation evolved, not just where it is now.  Everything the
repo measured before this module (net bytes, recovery counters, trace
percentiles, serving lag) was point-in-time: ``/api/status`` answered
"what is the state this instant" and every number died with the run.
This module makes those signals *time series* that a controller (ROADMAP
item 3, delay-adaptive rates per arXiv:1601.04033), an SLO engine
(``metrics/slo.py``), a Prometheus scraper (``metrics/prom.py``), and a
terminal dashboard (``metrics/top.py``) can all read:

- :class:`TimeSeriesStore`: per-series bounded rings of ``(t_s, value)``
  samples with windowed aggregates (min/max/mean/last/percentiles) and
  counter **rate derivation** (``rate()``: per-second slope over a
  window, the updates/s and bytes/s view).
- a process-global **sampler thread** (:func:`ensure_started`) that
  every ``async.metrics.interval.s`` seconds walks the counter-family
  registry (``metrics/registry.py``) plus dynamically registered
  sources (the PS registers one; serving/trace/convergence sources are
  built in) and records each flat numeric as ``<family>.<key>``.
  Retention is bounded: ``async.metrics.retention`` samples per series
  (defaults: 512 samples x 1 s interval = ~8.5 min of history; RAM is
  O(series x retention) small floats).
- :class:`ConvergenceHistory`: the loss-vs-wallclock and loss-vs-version
  curves (ASAP, arXiv:1612.08608: error/latency trade-off curves are
  the right product of an approximate async engine).  Workers piggyback
  ``(version, loss, grad_norm)`` samples on PUSH headers (the ``cv``
  entry -- the same discipline as trace spans and pipeline counters,
  see ``parallel/ps_dcn.py``), the PS folds them here stamped with its
  run clock and the staleness it observed; in-process solvers fold
  their trajectory at close.  Bounded by stride compaction: at capacity
  every other point is dropped and the acceptance stride doubles, so
  the curve always spans the whole run at bounded memory.
- :class:`ConvergenceBuffer`: the worker-side bounded sample buffer
  whose unshipped tail rides the next PUSH/BYE header (merge-back on a
  terminally failed push, like every other piggyback).

Everything is lock-guarded, allocation-light, and OFF the hot path: the
sampler is one daemon thread; convergence sampling on workers is
conf-gated (``async.convergence.sample``, default 0 = off, flipped on
for ``async-cluster``) so default wires stay byte-identical.

A copy of the JAX package's ``metrics/timeseries.py``: a ``cv`` header
either package writes folds in the other, and a trajectory folded here
gives the same curves and summary as there.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, same rule as metrics/system.Histogram."""
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, max(0, math.ceil(q * n) - 1))]


class TimeSeriesStore:
    """Bounded per-series rings of ``(t_s, value)`` with windowed
    aggregates and counter-rate derivation.

    ``capacity`` bounds every series independently (oldest samples
    evict first, counted).  ``clock`` is injectable (ManualClock tests);
    times are the clock's ``now_ms() / 1e3``.
    """

    def __init__(self, capacity: int = 512, clock: Optional[Clock] = None):
        self.capacity = max(2, int(capacity))
        self._clock = clock or SystemClock()
        self._lock = threading.Lock()
        self._series: "OrderedDict[str, deque]" = OrderedDict()
        self.samples_recorded = 0
        self.evicted = 0

    def now_s(self) -> float:
        return self._clock.now_ms() / 1e3

    # ------------------------------------------------------------ recording
    def record(self, name: str, value: float,
               t_s: Optional[float] = None) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if t_s is None:
            t_s = self.now_s()
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = deque(maxlen=self.capacity)
            if len(ring) == ring.maxlen:
                self.evicted += 1
            ring.append((t_s, v))
            self.samples_recorded += 1

    def record_flat(self, prefix: str, values: Dict[str, object],
                    t_s: Optional[float] = None) -> None:
        """Record every numeric in a flat dict as ``<prefix>.<key>``."""
        if t_s is None:
            t_s = self.now_s()
        for k, v in values.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.record(f"{prefix}.{k}", v, t_s=t_s)

    # -------------------------------------------------------------- queries
    def names(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def series(self, name: str, window_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Samples of ``name``, oldest first, optionally restricted to
        the trailing ``window_s`` seconds."""
        with self._lock:
            ring = self._series.get(name)
            pts = list(ring) if ring is not None else []
        if window_s is not None and pts:
            cutoff = self.now_s() - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def last(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def window_agg(self, name: str, window_s: float) -> Dict[str, float]:
        """min/max/mean/last + nearest-rank percentiles over the
        trailing window.  ``{"count": 0}`` when no samples fall in it."""
        pts = self.series(name, window_s=window_s)
        if not pts:
            return {"count": 0}
        vals = sorted(v for (_t, v) in pts)
        return {
            "count": len(vals),
            "min": vals[0],
            "max": vals[-1],
            "mean": sum(vals) / len(vals),
            "last": pts[-1][1],
            "p50": _pct(vals, 0.50),
            "p95": _pct(vals, 0.95),
            "p99": _pct(vals, 0.99),
        }

    def rate(self, name: str, window_s: float) -> Optional[float]:
        """Per-second increase of a monotone counter over the trailing
        window: ``(last - first) / (t_last - t_first)``, clamped at 0 so
        a mid-window ``reset_totals()`` reads as a stall, not a negative
        rate.  None without >= 2 samples spanning > 0 time."""
        pts = self.series(name, window_s=window_s)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return max(0.0, (v1 - v0) / (t1 - t0))

    def summary(self) -> Dict[str, object]:
        """Compact meta-view for ``/api/status``: series count, sample
        count, and each series' last value (names only -- full rings are
        served by ``/api/timeseries``)."""
        with self._lock:
            names = list(self._series)
            last = {n: self._series[n][-1][1]
                    for n in names if self._series[n]}
            return {
                "series": len(names),
                "samples": self.samples_recorded,
                "evicted": self.evicted,
                "last": last,
            }

    def dump(self) -> Dict[str, List[List[float]]]:
        """Every series' full ring as JSON-able ``[[t_s, v], ...]``
        (bounded by construction; the ``/api/timeseries`` body)."""
        with self._lock:
            return {n: [[t, v] for (t, v) in ring]
                    for n, ring in self._series.items()}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self.samples_recorded = 0
            self.evicted = 0


# --------------------------------------------------------------------------
# Convergence history (loss-vs-wallclock / loss-vs-version curves)
# --------------------------------------------------------------------------
class ConvergenceHistory:
    """Bounded record of ``(wall_ms, version, loss, grad_norm,
    staleness)`` samples.

    Stride compaction keeps the FULL run span at bounded memory: when
    the list hits capacity, every other point is dropped and the
    acceptance stride doubles (sample k is kept iff k % stride == 0 by
    arrival order), so early and late history coexist -- a ring would
    forget the start of the run, which is exactly the part a
    loss-vs-wallclock curve needs.
    """

    def __init__(self, capacity: int = 2048):
        self.capacity = max(16, int(capacity))
        self._lock = threading.Lock()
        self._pts: List[Tuple[float, int, Optional[float],
                              Optional[float], Optional[int]]] = []
        self._stride = 1
        self._arrivals = 0
        self.samples = 0      # accepted into the history
        self.offered = 0      # offered (add calls)
        self.compactions = 0

    def add(self, wall_ms: float, version: int,
            loss: Optional[float] = None,
            grad_norm: Optional[float] = None,
            staleness: Optional[int] = None) -> None:
        try:
            wall_ms = float(wall_ms)
            version = int(version)
            loss = None if loss is None else float(loss)
            grad_norm = None if grad_norm is None else float(grad_norm)
            staleness = None if staleness is None else int(staleness)
        except (TypeError, ValueError):
            return
        if loss is not None and not math.isfinite(loss):
            loss = None  # diverged/NaN losses must not poison the curve
        with self._lock:
            self.offered += 1
            k = self._arrivals
            self._arrivals += 1
            if k % self._stride != 0:
                return
            self._pts.append((wall_ms, version, loss, grad_norm, staleness))
            self.samples += 1
            if len(self._pts) >= self.capacity:
                del self._pts[1::2]  # keep endpoints-ish, halve density
                self._stride *= 2
                self.compactions += 1

    def _sorted(self) -> List[Tuple]:
        return sorted(self._pts, key=lambda p: p[0])

    def curves(self, max_points: int = 160) -> Dict[str, List[List[float]]]:
        """JSON-able curves, downsampled to ``<= max_points`` each:
        ``loss_vs_wallclock`` [[t_ms, loss]], ``loss_vs_version``
        [[version, loss]], ``grad_norm`` [[t_ms, gnorm]],
        ``staleness`` [[t_ms, staleness]]."""
        with self._lock:
            pts = self._sorted()
        def thin(seq):
            if len(seq) <= max_points:
                return seq
            step = len(seq) / max_points
            return [seq[int(i * step)] for i in range(max_points)]
        loss_t = [[t, l] for (t, _v, l, _g, _s) in pts if l is not None]
        loss_v = [[v, l] for (_t, v, l, _g, _s) in pts if l is not None]
        gnorm = [[t, g] for (t, _v, _l, g, _s) in pts if g is not None]
        stale = [[t, float(s)] for (t, _v, _l, _g, s) in pts
                 if s is not None]
        return {
            "loss_vs_wallclock": thin(loss_t),
            "loss_vs_version": thin(loss_v),
            "grad_norm": thin(gnorm),
            "staleness": thin(stale),
        }

    def summary(self) -> Dict[str, object]:
        """The scalar view the SLO engine / bench / async-top read:
        sample counts, first/last/best loss, the trailing-half slope
        (loss units per second; negative = converging), and loss at
        25/50/100% of the observed wallclock."""
        with self._lock:
            pts = self._sorted()
        losses = [(t, l) for (t, _v, l, _g, _s) in pts if l is not None]
        out: Dict[str, object] = {
            "samples": self.samples,
            "offered": self.offered,
            "stride": self._stride,
            "compactions": self.compactions,
        }
        if not losses:
            return out
        out["first_loss"] = losses[0][1]
        out["last_loss"] = losses[-1][1]
        out["best_loss"] = min(l for (_t, l) in losses)
        out["span_ms"] = losses[-1][0] - losses[0][0]
        out["loss_at"] = loss_at_fractions(losses)
        out["slope_per_s"] = loss_slope(losses)
        return out

    def reset(self) -> None:
        with self._lock:
            self._pts.clear()
            self._stride = 1
            self._arrivals = 0
            self.samples = self.offered = self.compactions = 0


def loss_at_fractions(
    trajectory: Sequence[Tuple[float, float]],
    fractions: Sequence[float] = (0.25, 0.50, 1.0),
) -> Dict[str, Optional[float]]:
    """Loss at given fractions of the observed wallclock span, from a
    ``[(t_ms, loss), ...]`` curve (last sample at-or-before the cut; the
    bench telemetry block and ConvergenceHistory.summary share this)."""
    pts = sorted((float(t), float(l)) for (t, l) in trajectory
                 if l is not None and math.isfinite(float(l)))
    out: Dict[str, Optional[float]] = {}
    for f in fractions:
        key = f"{int(round(f * 100))}pct"
        if not pts:
            out[key] = None
            continue
        t0, t1 = pts[0][0], pts[-1][0]
        cut = t0 + (t1 - t0) * f
        best = None
        for (t, l) in pts:
            if t <= cut:
                best = l
            else:
                break
        out[key] = best if best is not None else pts[0][1]
    return out


def loss_slope(trajectory: Sequence[Tuple[float, float]]
               ) -> Optional[float]:
    """Least-squares slope of loss vs wallclock SECONDS over the
    trailing half of the curve (the convergence-rate signal async-top
    and the bench telemetry block report; negative = still improving,
    ~0 = plateaued)."""
    pts = sorted((float(t) / 1e3, float(l)) for (t, l) in trajectory
                 if l is not None and math.isfinite(float(l)))
    if len(pts) < 2:
        return None
    tail = pts[len(pts) // 2:]
    if len(tail) < 2:
        tail = pts[-2:]
    n = len(tail)
    mt = sum(t for (t, _l) in tail) / n
    ml = sum(l for (_t, l) in tail) / n
    den = sum((t - mt) ** 2 for (t, _l) in tail)
    if den <= 0:
        return None
    return sum((t - mt) * (l - ml) for (t, l) in tail) / den


def fold_trajectory(trajectory) -> None:
    """Fold a finished run's post-hoc trajectory (``[(wall_ms,
    objective), ...]``, the TrainResult shape) into the process-global
    convergence history -- the in-process solvers' analog of the DCN
    workers' PUSH-header piggyback.  Snapshot index stands in for the
    model version (in-process snapshots are taken on the printer-freq
    cadence, not per merge)."""
    conv = convergence()
    for i, (t_ms, obj) in enumerate(trajectory or ()):
        conv.add(t_ms, i, loss=obj)


class ConvergenceBuffer:
    """Worker-side bounded buffer of ``(version, loss, grad_norm)``
    samples awaiting shipment on a PUSH/BYE header (``cv`` entry) --
    the span/pipeline-counter piggyback discipline: ``take_wire`` drains
    the unshipped tail, ``merge_back`` restores a terminally failed
    push's samples so they ride the next attempt instead of vanishing."""

    MAX_WIRE = 32  # samples per header: bounds the piggyback bytes

    def __init__(self, capacity: int = 128):
        self._lock = threading.Lock()
        self._ring: "deque[list]" = deque(maxlen=max(4, int(capacity)))
        self.dropped = 0

    def add(self, version: int, loss: Optional[float],
            grad_norm: Optional[float]) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append([
                int(version),
                None if loss is None else round(float(loss), 8),
                None if grad_norm is None else round(float(grad_norm), 6),
            ])

    def take_wire(self) -> List[list]:
        with self._lock:
            out: List[list] = []
            while self._ring and len(out) < self.MAX_WIRE:
                out.append(self._ring.popleft())
            return out

    def merge_back(self, wire: List[list]) -> None:
        with self._lock:
            for item in reversed(wire):
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.appendleft(item)


# --------------------------------------------------------------------------
# Process-global store + sampler + convergence history
# --------------------------------------------------------------------------
_glock = threading.Lock()
_store: Optional[TimeSeriesStore] = None
_conv: Optional[ConvergenceHistory] = None
_sources: "OrderedDict[str, Callable[[], Dict[str, object]]]" = OrderedDict()
_sampler_thread: Optional[threading.Thread] = None
_sampler_stop = threading.Event()
_ticks = 0


def store() -> TimeSeriesStore:
    """The process-global time-series store (capacity from conf
    ``async.metrics.retention`` at first touch)."""
    global _store
    with _glock:
        if _store is None:
            from asyncframework_tpu_torch.conf import METRICS_RETENTION, global_conf

            _store = TimeSeriesStore(
                capacity=int(global_conf().get(METRICS_RETENTION))
            )
        return _store


def convergence() -> ConvergenceHistory:
    """The process-global convergence history (PS folds piggybacked
    worker samples here; in-process solvers fold their trajectory)."""
    global _conv
    with _glock:
        if _conv is None:
            _conv = ConvergenceHistory()
        return _conv


def register_source(name: str, fn: Callable[[], Dict[str, object]]) -> None:
    """Register a dynamic flat-dict source sampled every tick as
    ``<name>.<key>`` (the PS registers ``ps``; last registration under a
    name wins -- matching "the live PS owns the dashboard")."""
    with _glock:
        _sources[name] = fn


def unregister_source(name: str, fn=None) -> None:
    """Remove a source; with ``fn`` given, only if it is still the
    registered one (a stopped PS must not unhook its replacement)."""
    with _glock:
        if fn is None or _sources.get(name) is fn:
            _sources.pop(name, None)


def _builtin_sources() -> Dict[str, Callable[[], Dict[str, object]]]:
    """Always-on derived sources beside the registry counters: serving
    freshness/latency, trace stage percentiles, convergence scalars."""
    return {
        "serving": _serving_source,
        "trace": _trace_source,
        "convergence": _convergence_source,
    }


def _serving_source() -> Dict[str, object]:
    from asyncframework_tpu_torch.serving import metrics as smetrics

    snap = smetrics.serving_snapshot()
    out: Dict[str, object] = {}
    if "qps" in snap:
        out["qps"] = snap["qps"]
    fl = smetrics.freshness_lag_ms()
    if fl is not None:
        out["freshness_lag_ms"] = fl
    for key, stat in (("predict_ms", "p99"), ("lag_ms", "p95"),
                      ("lag_versions", "p95")):
        s = snap.get(key) or {}
        if s.get("count"):
            out[f"{key}_{stat}"] = s[stat]
    return out


def _trace_source() -> Dict[str, object]:
    from asyncframework_tpu_torch.metrics import trace as trace_mod

    snap = trace_mod.aggregator().snapshot()
    out: Dict[str, object] = {"spans": snap.get("spans", 0)}
    for stage, s in (snap.get("stages_ms") or {}).items():
        if s.get("count"):
            out[f"{stage}.p95_ms"] = s["p95"]
    sm = snap.get("staleness_ms") or {}
    if sm.get("count"):
        out["staleness_ms_p95"] = sm["p95"]
    sv = snap.get("staleness_versions") or {}
    if sv.get("count"):
        out["staleness_versions_p95"] = sv["p95"]
    return out


def _convergence_source() -> Dict[str, object]:
    s = convergence().summary()
    out: Dict[str, object] = {}
    if "last_loss" in s:
        out["loss"] = s["last_loss"]
    if s.get("slope_per_s") is not None:
        out["slope_per_s"] = s["slope_per_s"]
    return out


def sample_once(st: Optional[TimeSeriesStore] = None) -> None:
    """One sampling tick: registry counter families + dynamic sources
    into the store, then an SLO evaluation pass.  A failing source must
    not kill the sampler (same shield as MetricsSystem sinks)."""
    global _ticks
    from asyncframework_tpu_torch.metrics import registry

    st = st or store()
    t = st.now_s()
    for fam_name, fam in registry.families().items():
        try:
            st.record_flat(fam_name, fam.totals(), t_s=t)
        except Exception:  # noqa: BLE001 - one family (e.g. a lazy
            pass           # import failing in a lean process) must not
                           # kill the sampler thread for good
    with _glock:
        sources = dict(_builtin_sources(), **_sources)
    for name, fn in sources.items():
        try:
            st.record_flat(name, fn(), t_s=t)
        except Exception:  # noqa: BLE001 - telemetry must not crash
            pass
    _ticks += 1
    try:
        from asyncframework_tpu_torch.metrics import slo

        slo.engine().evaluate()
    except Exception:  # noqa: BLE001 - a bad rule set must not kill ticks
        pass


def ensure_started() -> None:
    """Start the process-global sampler thread (idempotent; daemon).
    Interval from conf ``async.metrics.interval.s`` at start time; an
    interval <= 0 disables sampling entirely."""
    global _sampler_thread
    from asyncframework_tpu_torch.conf import METRICS_INTERVAL_S, global_conf

    interval = float(global_conf().get(METRICS_INTERVAL_S))
    if interval <= 0:
        return
    with _glock:
        if _sampler_thread is not None and _sampler_thread.is_alive():
            return
        _sampler_stop.clear()

        def loop() -> None:
            while not _sampler_stop.wait(timeout=interval):
                sample_once()

        _sampler_thread = threading.Thread(
            target=loop, name="telemetry-sampler", daemon=True
        )
        _sampler_thread.start()


def stop_sampler() -> None:
    global _sampler_thread
    with _glock:
        t = _sampler_thread
        _sampler_thread = None
    _sampler_stop.set()
    if t is not None:
        t.join(timeout=5.0)


def sampler_running() -> bool:
    with _glock:
        return _sampler_thread is not None and _sampler_thread.is_alive()


# ------------------------------------------------- registry provider hooks
def timeseries_totals() -> Dict[str, int]:
    """Flat meta-counters (registry family ``timeseries``)."""
    st = store()
    with st._lock:
        return {
            "series": len(st._series),
            "samples": st.samples_recorded,
            "evicted": st.evicted,
            "ticks": _ticks,
        }


def reset_timeseries() -> None:
    global _ticks
    store().clear()
    _ticks = 0


def convergence_totals() -> Dict[str, int]:
    """Flat meta-counters (registry family ``convergence``)."""
    c = convergence()
    return {
        "samples": c.samples,
        "offered": c.offered,
        "compactions": c.compactions,
    }


def reset_convergence() -> None:
    convergence().reset()

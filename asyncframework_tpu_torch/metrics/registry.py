"""Counter-family registry: the ONE list of process-global counter dicts.

Before this existed, each observability subsystem (net retries, wire
bytes, elastic recovery, shuffle spill, pipelined-loop counters, serving
QPS, ...) exported its own module-level ``*_totals()`` /
``reset_*_totals()`` pair, and THREE consumers had to enumerate them by
hand: ``metrics.reset_totals()`` (per-run isolation),
``metrics/live.LiveStateListener`` (per-run delta baselines, so a second
run's dashboard does not inherit the first run's counts), and now the
time-series sampler (``metrics/timeseries.py``) and the Prometheus
exposition (``metrics/prom.py``).  A family added to one list but
forgotten in another only surfaced as a flaky "second run inherits
counts" bug.  This module is the fix: every family is declared ONCE
here, every consumer iterates :func:`families`, and a tier-1 audit test
(``tests/test_torch_telemetry.py``) introspects the package for stray
``*_totals`` providers that are not registered.

A family's ``totals`` must be a zero-arg callable returning a FLAT
``Dict[str, int|float]`` (the live UI's ``_delta`` machinery and the
Prometheus counter mapping both require flat numerics); ``reset`` zeroes
it.  ``high_water`` names keys that are maxima rather than monotone
counts -- per-run delta subtraction does not apply to them (the live UI
shows them raw, and the sampler's ``rate()`` is meaningless on them).
``baseline=False`` marks meta-families (the telemetry plane's own
counters) that the live UI does not delta-baseline.

Providers are referenced by (module, attr) strings and resolved lazily:
importing this registry must not import heavy modules.

A copy of the JAX package's ``metrics/registry.py``.  Each family points
at this package's own module, in the JAX package's order; the families of
subsystems this package does not have yet are left out and named in
:data:`UNPORTED_FAMILIES` with their ROADMAP item.
"""

from __future__ import annotations

import importlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class CounterFamily:
    """One process-global flat counter dict and its reset."""

    name: str
    module: str        # dotted module owning the provider functions
    totals_attr: str   # zero-arg callable -> Dict[str, int|float]
    reset_attr: str    # zero-arg callable zeroing the totals
    high_water: Tuple[str, ...] = ()
    baseline: bool = True  # live UI captures a per-run delta baseline
    doc: str = ""

    def _resolve(self, attr: str) -> Callable:
        return getattr(importlib.import_module(self.module), attr)

    def totals(self) -> Dict[str, float]:
        return self._resolve(self.totals_attr)()

    def reset(self) -> None:
        self._resolve(self.reset_attr)()


_FAMILIES: "OrderedDict[str, CounterFamily]" = OrderedDict()


def _register(fam: CounterFamily) -> None:
    _FAMILIES[fam.name] = fam


def families() -> "OrderedDict[str, CounterFamily]":
    return OrderedDict(_FAMILIES)


def totals(name: str) -> Dict[str, float]:
    return _FAMILIES[name].totals()


def all_totals() -> "OrderedDict[str, Dict[str, float]]":
    """Every family's flat totals, registration order (the sampler's and
    the Prometheus exposition's walk)."""
    return OrderedDict((n, f.totals()) for n, f in _FAMILIES.items())


def reset_all() -> None:
    """Zero every registered family (``metrics.reset_totals`` core)."""
    for fam in _FAMILIES.values():
        fam.reset()


#: the JAX package's families whose subsystems this package does not have
#: yet, each with the ROADMAP item that ports it
UNPORTED_FAMILIES: Dict[str, str] = OrderedDict((
    ("shuffle", "A9"),       # data/spill.py
))


# --------------------------------------------------------------------------
# The families.  Order is presentation order (live UI, /metrics).
# --------------------------------------------------------------------------
_register(CounterFamily(
    "net", "asyncframework_tpu_torch.net", "net_totals", "reset_net_totals",
    doc="DCN robustness: retries, breaker trips, dedup hits, faults "
        "fired (net/retry.py, net/session.py, net/faults.py).",
))
_register(CounterFamily(
    "net_bytes", "asyncframework_tpu_torch.net.frame",
    "bytes_totals", "reset_bytes_totals",
    doc="Per-op frame bytes sent/received at the net/frame.py choke "
        "point (also zeroed by reset_net_totals; resets are idempotent).",
))
_register(CounterFamily(
    "recovery", "asyncframework_tpu_torch.parallel.supervisor",
    "recovery_totals", "reset_recovery_totals",
    doc="Elastic plane: workers lost, shards adopted, rejoins, "
        "releases, PS resumes, plus the partition-tolerant membership "
        "counters -- suspicions, lease expiries, fencing-epoch bumps, "
        "fenced rejects (parallel/supervisor.py).",
))
_register(CounterFamily(
    "gray", "asyncframework_tpu_torch.net.health",
    "gray_totals", "reset_gray_totals",
    doc="Gray-failure detection: latency-suspicion transitions "
        "(net/health.py RttSuspector).",
))
_register(CounterFamily(
    "pipeline", "asyncframework_tpu_torch.parallel.ps_dcn",
    "pipeline_totals", "reset_pipeline_totals",
    high_water=("inflight_max",),
    doc="Pipelined update loop: prefetch hits/waits, stale discards, "
        "async pushes, push errors; inflight_max is a high-water mark.",
))
_register(CounterFamily(
    "serving", "asyncframework_tpu_torch.serving.metrics",
    "serving_totals", "reset_serving_totals",
    doc="Serving plane: predicts, failovers, unhealthy rejects, "
        "refresh shapes (serving/metrics.py).",
))
_register(CounterFamily(
    "relay", "asyncframework_tpu_torch.relaycast.metrics",
    "relay_totals", "reset_relay_totals",
    doc="Relaycast distribution plane: fetches served per shape, "
        "offers sent/received, parent fetches vs root fallbacks, "
        "re-homes, fenced hops, CRC rejects "
        "(asyncframework_tpu_torch/relaycast/).",
))
_register(CounterFamily(
    "codec", "asyncframework_tpu_torch.net.wirecodec",
    "codec_totals", "reset_codec_totals",
    doc="Wire codecs: quantized-gradient encodes/decodes and raw "
        "fallbacks, raw-vs-wire byte totals, snapshot-delta "
        "compression hits (net/wirecodec.py).",
))
_register(CounterFamily(
    "native", "asyncframework_tpu_torch.native_build",
    "native_totals", "reset_native_totals",
    doc="Native data plane: native vs Python codec dispatches per unit "
        "(native_calls.<unit>/python_calls.<unit>), wanted-but-missing "
        "fallbacks (python_fallbacks -- nonzero means the box is "
        "silently running the slow path), and the shm-ring transport's "
        "upgrades/refusals/degrades plus frame/byte flow "
        "(native_build.py, net/shmring.py).",
))
_register(CounterFamily(
    "shardgroup", "asyncframework_tpu_torch.parallel.shardgroup",
    "shard_totals", "reset_shard_totals",
    doc="Sharded PS group: shard deaths/restarts, fence epoch bumps, "
        "standby promotions/respawns, finish broadcasts, assembled "
        "pulls/pushes, map re-resolves, abandoned fan-out rounds "
        "(parallel/shardgroup.py).",
))
_register(CounterFamily(
    "replication", "asyncframework_tpu_torch.parallel.replication",
    "repl_totals", "reset_repl_totals",
    doc="Hot-standby replication: batches/items streamed, syncs, "
        "resyncs, reconnects, queue overflows, fenced streams "
        "(primary sender); appends applied, sync installs, promotions "
        "(standby applier) (parallel/replication.py).",
))
_register(CounterFamily(
    "control", "asyncframework_tpu_torch.parallel.controller",
    "control_totals", "reset_control_totals",
    doc="Adaptive asynchrony controller: decision ticks, knob changes "
        "(the controller_converged SLO watches their rate), bound "
        "clamps, oscillation-guard trips, stale CTRL installs refused "
        "(parallel/controller.py).",
))
_register(CounterFamily(
    "observer", "asyncframework_tpu_torch.metrics.observer",
    "observer_totals", "reset_observer_totals",
    doc="Cluster observer: scrapes, scrape errors, roles discovered, "
        "flight dumps harvested, history persists, stragglers flagged "
        "(metrics/observer.py).",
))
_register(CounterFamily(
    "flight", "asyncframework_tpu_torch.metrics.flightrec",
    "flight_totals", "reset_flight_totals",
    baseline=False,
    doc="Crash flight recorder meta-counters: events noted/dropped, "
        "cadence flushes, dumps written (metrics/flightrec.py).",
))
_register(CounterFamily(
    "profile", "asyncframework_tpu_torch.metrics.profiler",
    "profile_totals", "reset_profile_totals",
    baseline=False,
    doc="Continuous profiling plane: stack samples total and per zone "
        "(samples.<zone>), exact zone nanoseconds/calls "
        "(zone_ns.<zone>/zone_calls.<zone>), jit compile/dispatch "
        "count+ns, dropped distinct stacks, sampler errors "
        "(metrics/profiler.py).  Empty while async.prof.enabled=0.",
))
_register(CounterFamily(
    "convergence", "asyncframework_tpu_torch.metrics.timeseries",
    "convergence_totals", "reset_convergence",
    baseline=False,
    doc="Convergence telemetry meta-counters: samples folded, "
        "piggybacks received, compactions (metrics/timeseries.py).",
))
_register(CounterFamily(
    "timeseries", "asyncframework_tpu_torch.metrics.timeseries",
    "timeseries_totals", "reset_timeseries",
    baseline=False,
    doc="Time-series store meta-counters: samples recorded, series "
        "live, evictions (metrics/timeseries.py).",
))


# --------------------------------------------------------------------------
# Series-family declarations.  Every time-series key written anywhere
# must parse as ``family.metric`` with the family declared here: either
# a counter family above (the sampler records each one under its own
# name) or one of the DYNAMIC source families below (register_source
# callers).  The JAX package's ``bin/async-lint`` checks its copy
# statically; the runtime registration audit of this copy is in
# tests/test_torch_telemetry.py.
# --------------------------------------------------------------------------
#: dynamic register_source() families beside the counter families: the
#: PS core scalars, the shard-group controller, the always-on derived
#: sources (timeseries._builtin_sources), the cluster observer's
#: derived fleet signals, and the MetricsSystem queue-depth source.
DYNAMIC_SERIES_FAMILIES = (
    "ps", "ps_shards", "serving", "trace", "convergence", "observer",
    "queue",
)


def series_families() -> tuple:
    """Every declared series family name: counter families plus the
    dynamic source families (the metrics-series-family lint's table)."""
    return tuple(_FAMILIES) + DYNAMIC_SERIES_FAMILIES

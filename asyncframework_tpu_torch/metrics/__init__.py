"""Observability: event bus, event logging/replay, metrics registry+sinks.

Counterpart of ``asyncframework_tpu/metrics/``, each module a copy of the
JAX package's: the listener bus (``bus.py``), the JSONL event log and its
reader (``eventlog.py``), the polled metrics system with CSV/JSONL sinks
(``system.py``), lifecycle tracing (``trace.py``), the HTML report
(``report.py``), and the telemetry plane: the counter-family registry
(``registry.py``), the time-series store and convergence history
(``timeseries.py``), SLO rules (``slo.py``), the Prometheus exposition
(``prom.py``), the live UI and per-process endpoints (``live.py``), the
crash flight recorder (``flightrec.py``), the continuous profiler
(``profiler.py``), the cluster observer (``observer.py``), ``async-top``
(``top.py``) and the run-history index (``history.py``).  An event log,
a ``/metrics`` body, a flight dump or a ``cv`` sample written by either
package is read by the other.
"""

from asyncframework_tpu_torch.metrics.bus import (
    Event,
    GradientMerged,
    JobEnd,
    JobStart,
    Listener,
    ListenerBus,
    ModelSnapshot,
    RoundSubmitted,
    TaskEnd,
    TraceSpan,
    WorkerLost,
)
from asyncframework_tpu_torch.metrics.eventlog import EventLogReader, EventLogWriter
from asyncframework_tpu_torch.metrics.report import render_report
from asyncframework_tpu_torch.metrics.system import (
    Counter,
    CsvSink,
    Gauge,
    Histogram,
    JsonlSink,
    MetricsSystem,
)
from asyncframework_tpu_torch.metrics.timeseries import (
    ConvergenceHistory,
    TimeSeriesStore,
)
from asyncframework_tpu_torch.metrics.trace import (
    Span,
    TraceAggregator,
    TraceContext,
    TraceRecorder,
)


def reset_totals() -> None:
    """Zero EVERY process-global observability counter so back-to-back
    runs in one process -- tests, notebooks, long-lived daemons -- start
    from a clean slate instead of inheriting the previous run's counts.

    The counter families are enumerated by the one registry
    (``metrics/registry.py``) -- adding a family there wires it into this
    reset, the live UI's per-run delta baselines, the telemetry sampler,
    and the Prometheus exposition at once.  The trace aggregator and SLO
    rule states are not flat counter dicts, so they reset beside the
    registry walk."""
    from asyncframework_tpu_torch.metrics import registry as _registry
    from asyncframework_tpu_torch.metrics import slo as _slo
    from asyncframework_tpu_torch.metrics import trace as _trace

    _registry.reset_all()
    _trace.reset_aggregator()
    _slo.reset_engine()


__all__ = [
    "Event",
    "JobStart",
    "JobEnd",
    "TaskEnd",
    "RoundSubmitted",
    "GradientMerged",
    "ModelSnapshot",
    "WorkerLost",
    "Listener",
    "ListenerBus",
    "EventLogWriter",
    "EventLogReader",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsSystem",
    "CsvSink",
    "JsonlSink",
    "render_report",
    "TraceSpan",
    "Span",
    "TraceAggregator",
    "TraceContext",
    "TraceRecorder",
    "TimeSeriesStore",
    "ConvergenceHistory",
    "reset_totals",
]

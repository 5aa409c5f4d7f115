"""Observability: event bus, event logging/replay, metrics registry+sinks.

Counterpart of ``asyncframework_tpu/metrics/``, in the part the solvers'
run sinks need: the listener bus (``bus.py``), the JSONL event log and its
reader (``eventlog.py``), the polled metrics system with CSV/JSONL sinks
(``system.py``), lifecycle tracing (``trace.py``) and the HTML report
(``report.py``), each a copy of the JAX package's module.  An event log
written by either package is read by the other's reader.  The telemetry
plane (live UI, registry, SLOs, time series, Prometheus, flight recorder,
profiler, observer) is not ported yet (ROADMAP.md queue A).
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
from asyncframework_tpu_torch.metrics.trace import (
    Span,
    TraceAggregator,
    TraceContext,
    TraceRecorder,
)


def reset_totals() -> None:
    """Zero the process-global observability state this package has, so
    back-to-back runs in one process start clean: the trace aggregator.
    The JAX package also walks its counter-family registry and resets the
    SLO engine here; those modules come with the telemetry plane and join
    this reset then."""
    from asyncframework_tpu_torch.metrics import trace as _trace

    _trace.reset_aggregator()


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
    "reset_totals",
]

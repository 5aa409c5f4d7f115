"""Observability: event bus, event logging/replay, metrics registry+sinks.

Counterpart of ``asyncframework_tpu/metrics/``, in the part the solvers'
run sinks need: the listener bus (``bus.py``), the JSONL event log and its
reader (``eventlog.py``), the polled metrics system with CSV/JSONL sinks
(``system.py``), lifecycle tracing (``trace.py``) and the HTML report
(``report.py``), each a copy of the JAX package's module, and the hooks of the
flight recorder and profiler that the DCN plane calls (``flightrec.py``,
``profiler.py``; the recorders themselves come with ROADMAP A5b).  An event log written by either package is read by the
other's reader.  The rest of the telemetry plane (live UI, registry, SLOs,
time series, Prometheus, observer) is not ported yet (ROADMAP.md A5b).
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
    back-to-back runs in one process start clean: the trace aggregator and
    the counter families of the DCN plane (net, native, codec, recovery,
    pipeline).  The JAX package walks its counter-family registry and
    resets the SLO engine here; those modules come with the telemetry
    plane (ROADMAP A5b)."""
    from asyncframework_tpu_torch import native_build
    from asyncframework_tpu_torch.metrics import trace as _trace
    from asyncframework_tpu_torch.net import reset_net_totals, wirecodec
    from asyncframework_tpu_torch.parallel import ps_dcn, supervisor

    _trace.reset_aggregator()
    reset_net_totals()
    native_build.reset_native_totals()
    wirecodec.reset_codec_totals()
    supervisor.reset_recovery_totals()
    ps_dcn.reset_pipeline_totals()


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

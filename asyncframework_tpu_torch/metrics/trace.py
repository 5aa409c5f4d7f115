"""Distributed tracing for the async update loop.

The ASYNC paper's contribution (arXiv:1907.08526) is *bounded-staleness*
asynchrony; ASAP (arXiv:1612.08608) argues the quantity to tune against is
staleness **in time**, not versions.  Neither is measurable when the DCN
plane (PSClient -> ParameterServer over ``net/frame.py``) is a telemetry
black hole.  This module makes one update's life observable end to end:

- a **trace context** ``(trace_id, span_id, worker_id, model_version)``
  rides every frame as an optional ``tc`` header entry, stamped at the one
  framing choke point (``net/frame.send_msg`` consults the thread-local
  context installed here) -- so PULL/PUSH/PULL_SAGA/PUSH_SAGA, topic, and
  master ops are all covered without per-callsite plumbing;
- **lifecycle spans** decompose an update's wall-clock:

  ========== =======================================================
  stage      measured where
  ========== =======================================================
  pull.wait  PS: time the PULL sat in the partial-barrier wave gate
  pull.rtt   worker: whole PULL round trip (client-observed)
  compute    worker: gradient step dispatch + device->host readback
  push.wait  worker: encode/stamp time between compute and the wire
  push.rtt   worker: whole PUSH round trip (client-observed)
  merge.queue PS: PUSH decode + wait for the model lock
  merge.apply PS: time under the lock (tau filter + apply dispatch)
  ========== =======================================================

- workers record completed spans into a bounded **lock-light ring buffer**
  (sampled at ``async.trace.sample``, default 1/64, counter-based so the
  first update per worker is always sampled; rate 0 = off with zero wire
  bytes and zero hot-path work) and **piggyback** them on the next PUSH
  header -- exactly like the elastic plane piggybacks adoption orders on
  PULL replies -- so spans survive worker death;
- the PS folds its own server-side spans plus the piggybacked ones into
  the process-global :class:`TraceAggregator` (live UI ``trace`` section:
  per-stage p50/p95/p99 and staleness in versions AND milliseconds) and,
  when given a bus, posts them as ``TraceSpan`` events -> event log ->
  history server.

``bin/async-trace`` (this module's :func:`main`) replays an event log,
reconstructs per-update critical paths, prints a latency-decomposition
table plus a per-worker straggler report, and exports Chrome
``chrome://tracing`` JSON.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import uuid
from collections import OrderedDict, defaultdict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

# stage names, in canonical critical-path order
PULL_WAIT = "pull.wait"
PULL_RTT = "pull.rtt"
#: pipelined worker loop only (parallel/ps_dcn.py, async.pipeline.depth
#: >= 1): the update loop's RESIDUAL stall -- time the main loop blocked
#: waiting for its prefetched model or for in-flight push-queue space.
#: In the serial loop this time is pull.rtt + push.rtt on the critical
#: path; pipelining overlaps those with compute, and whatever stall is
#: left shows up here.
PIPELINE = "pipeline"
COMPUTE = "compute"
PUSH_WAIT = "push.wait"
PUSH_RTT = "push.rtt"
MERGE_QUEUE = "merge.queue"
MERGE_APPLY = "merge.apply"

STAGES = (PULL_WAIT, PULL_RTT, PIPELINE, COMPUTE, PUSH_WAIT, PUSH_RTT,
          MERGE_QUEUE, MERGE_APPLY)
#: stages recorded client-side (worker process) vs server-side (PS)
CLIENT_STAGES = (PULL_RTT, PIPELINE, COMPUTE, PUSH_WAIT, PUSH_RTT)
SERVER_STAGES = (PULL_WAIT, MERGE_QUEUE, MERGE_APPLY)
#: the minimum chain proving a cross-process trace survived the wire
CHAIN_STAGES = (PULL_RTT, COMPUTE, PUSH_RTT)


def now_ms() -> float:
    """Wall-clock epoch milliseconds: the one span time base.  Monotonic
    clocks do not compare across processes, and a trace IS cross-process."""
    return time.time() * 1e3


# One random prefix per process + an atomic counter: minting an id costs a
# counter bump and a format, not a uuid4 entropy syscall.  The hot path
# mints four ids per sampled update, and measured on the CPU test rig even
# single-digit microseconds per merge in the updater thread measurably
# shifts marginal-stability ASGD runs -- id minting must be near-free.
_ID_PREFIX = uuid.uuid4().hex[:8]
_ID_COUNTER = itertools.count(1)


def _new_id(n: int = 16) -> str:
    c = next(_ID_COUNTER)
    if n >= 16:
        return _ID_PREFIX + format(c & 0xFFFFFFFF, "08x")
    return _ID_PREFIX[:2] + format(c & 0xFFFFFF, "06x")


@dataclass
class Span:
    """One completed stage of a traced update (host-side record)."""

    stage: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    worker_id: int
    model_version: int
    start_ms: float
    dur_ms: float
    staleness: Optional[int] = None
    staleness_ms: Optional[float] = None
    accepted: Optional[bool] = None
    #: wire bytes of the RPC this span covers (pull.rtt/push.rtt: frame
    #: bytes both directions, counted at the net/frame.py choke point) --
    #: latency AND volume decompose per stage
    bytes: Optional[int] = None

    # wire format: short keys, Nones omitted -- spans ride PUSH headers
    _WIRE = (("s", "stage"), ("t", "trace_id"), ("i", "span_id"),
             ("p", "parent_id"), ("w", "worker_id"), ("v", "model_version"),
             ("b", "start_ms"), ("d", "dur_ms"), ("st", "staleness"),
             ("sm", "staleness_ms"), ("ac", "accepted"), ("by", "bytes"))

    def to_wire(self) -> dict:
        out = {}
        for short, name in self._WIRE:
            v = getattr(self, name)
            if v is not None:
                out[short] = v
        return out

    @classmethod
    def from_wire(cls, d: dict) -> "Span":
        kw = {name: d.get(short) for short, name in cls._WIRE}
        kw["stage"] = str(kw["stage"])
        kw["trace_id"] = str(kw["trace_id"])
        kw["span_id"] = str(kw.get("span_id") or _new_id(8))
        # `x or default` would eat legitimate zeros -- model_version 0 is
        # the PS's FIRST served clock, and the first update is exactly the
        # one counter-based sampling always traces
        for name, default in (("worker_id", 0), ("model_version", -1)):
            v = kw.get(name)
            kw[name] = default if v is None else int(v)
        for name in ("start_ms", "dur_ms"):
            v = kw.get(name)
            kw[name] = 0.0 if v is None else float(v)
        return cls(**kw)


class TraceContext:
    """The propagated identity of one traced update: ``trace_id`` pins the
    lifecycle, ``span_id`` is the client span covering the in-flight RPC
    (the server's parent), ``worker_id``/``model_version`` locate it."""

    __slots__ = ("trace_id", "span_id", "worker_id", "model_version")

    def __init__(self, trace_id: str, worker_id: int,
                 model_version: int = -1, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id or _new_id(8)
        self.worker_id = int(worker_id)
        self.model_version = int(model_version)

    def wire(self) -> list:
        return [self.trace_id, self.span_id, self.worker_id,
                self.model_version]

    @classmethod
    def from_wire(cls, tc: Sequence) -> Optional["TraceContext"]:
        try:
            return cls(str(tc[0]), int(tc[2]), int(tc[3]), str(tc[1]))
        except (IndexError, KeyError, TypeError, ValueError):
            # junk from the wire (wrong type, a dict, short list) must
            # never kill a connection handler -- KeyError included: a JSON
            # object's tc[0] raises it, not IndexError
            return None


# ------------------------------------------------------- ambient propagation
# Thread-local current context: net/frame.py's send_msg stamps every frame
# sent while one is installed.  With nothing installed the cost is one TLS
# getattr + branch, and frames are byte-identical to the pre-trace wire.
_tls = threading.local()


def set_current(ctx: Optional[TraceContext]) -> None:
    _tls.ctx = ctx


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def wire_header() -> Optional[list]:
    """The ``tc`` header value to stamp, or None (tracing off / untraced
    update).  Called by ``net/frame.send_msg`` on every frame."""
    ctx = getattr(_tls, "ctx", None)
    return None if ctx is None else ctx.wire()


# ------------------------------------------------------------- worker side
class UpdateTrace:
    """One sampled update's in-progress trace on the worker: collects its
    client-side spans and hands the ambient context to the RPCs."""

    __slots__ = ("ctx", "_sink", "spans")

    def __init__(self, ctx: TraceContext, sink: Callable[[Span], None]):
        self.ctx = ctx
        self._sink = sink
        self.spans: List[Span] = []

    def set_model_version(self, mv: int) -> None:
        """Learned from the pull reply; back-fills spans recorded before
        the version was known (pull.rtt itself)."""
        self.ctx.model_version = int(mv)
        for sp in self.spans:
            if sp.model_version < 0:
                sp.model_version = int(mv)

    def add(self, stage: str, start_ms: float, end_ms: float,
            **attrs) -> Span:
        sp = Span(
            stage=stage, trace_id=self.ctx.trace_id, span_id=_new_id(8),
            parent_id=None, worker_id=self.ctx.worker_id,
            model_version=self.ctx.model_version, start_ms=start_ms,
            dur_ms=max(0.0, end_ms - start_ms), **attrs,
        )
        self.spans.append(sp)
        self._sink(sp)
        return sp

    def rpc_begin(self, stage: str) -> tuple:
        """Mint the RPC span's id, install it as the wire span_id, install
        the ambient context; returns the token ``rpc_end`` needs."""
        span_id = _new_id(8)
        self.ctx.span_id = span_id
        set_current(self.ctx)
        return (stage, span_id, now_ms())

    def rpc_end(self, token: tuple, **attrs) -> Span:
        """Uninstall the ambient context and record the RPC span."""
        set_current(None)
        stage, span_id, t0 = token
        sp = Span(
            stage=stage, trace_id=self.ctx.trace_id, span_id=span_id,
            parent_id=None, worker_id=self.ctx.worker_id,
            model_version=self.ctx.model_version, start_ms=t0,
            dur_ms=max(0.0, now_ms() - t0), **attrs,
        )
        self.spans.append(sp)
        self._sink(sp)
        return sp


class TraceRecorder:
    """Per-process sampling decision + bounded ring of completed spans.

    ``sample_rate`` / ``capacity`` default from conf (``async.trace.sample``
    / ``async.trace.buffer``).  Sampling is counter-based per worker id --
    deterministic, and the FIRST update of every worker is always sampled
    when the rate is > 0, so even a short run yields a complete trace.
    With rate 0 (or a None recorder) the hot path does no tracing work at
    all and no wire bytes are added.
    """

    def __init__(self, sample_rate: Optional[float] = None,
                 capacity: Optional[int] = None,
                 sink: Optional[Callable[[Span], None]] = None):
        if sample_rate is None or capacity is None:
            from asyncframework_tpu_torch.conf import (
                TRACE_BUFFER,
                TRACE_SAMPLE,
                global_conf,
            )

            conf = global_conf()
            if sample_rate is None:
                sample_rate = float(conf.get(TRACE_SAMPLE))
            if capacity is None:
                capacity = int(conf.get(TRACE_BUFFER))
        rate = max(0.0, min(1.0, float(sample_rate)))
        self.sample_rate = rate
        self.interval = 0 if rate <= 0.0 else max(1, round(1.0 / rate))
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._ring: "deque[Span]" = deque(maxlen=self.capacity)
        self._sink = sink
        self.sampled = 0
        self.dropped_spans = 0
        self._ring_len_hw = 0

    @property
    def enabled(self) -> bool:
        return self.interval > 0

    def start_update(self, worker_id: int) -> Optional[UpdateTrace]:
        """The per-update sampling decision; None = not traced."""
        if self.interval == 0:
            return None
        with self._lock:
            n = self._counts.get(worker_id, 0)
            self._counts[worker_id] = n + 1
            if n % self.interval != 0:
                return None
            self.sampled += 1
        return UpdateTrace(
            TraceContext(_new_id(16), worker_id), self._record
        )

    def _record(self, span: Span) -> None:
        if self._sink is not None:
            self._sink(span)
            return
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped_spans += 1
            self._ring.append(span)

    def drain_wire(self, max_spans: int = 128) -> List[dict]:
        """Completed spans awaiting shipment, as wire dicts (the PUSH
        piggyback; also drained by BYE so a run's tail spans land).  A
        caller whose send terminally fails should :meth:`requeue` what it
        drained so the spans ride the next attempt instead of vanishing."""
        out: List[dict] = []
        with self._lock:
            while self._ring and len(out) < max_spans:
                out.append(self._ring.popleft().to_wire())
        return out

    def requeue(self, wire_spans: List[dict]) -> None:
        """Put drained-but-undelivered wire spans back at the FRONT of the
        ring (a push that spent its whole retry budget must not silently
        eat its piggyback -- those spans describe exactly the fault window
        a trace exists to explain).  Overflow evicts from the ring's other
        end, counted in ``dropped_spans``."""
        with self._lock:
            for d in reversed(wire_spans):
                try:
                    sp = Span.from_wire(d)
                except Exception:  # noqa: BLE001 - never raise on telemetry
                    continue
                if len(self._ring) == self._ring.maxlen:
                    self.dropped_spans += 1
                self._ring.appendleft(sp)


# ------------------------------------------------------------ aggregation
class TraceAggregator:
    """Folds spans into per-stage latency histograms + staleness (versions
    AND milliseconds) distributions; the ``trace`` section of the live UI
    and of ``bench.py --trace-jsonl`` is one :meth:`snapshot` of this."""

    def __init__(self, capacity: int = 4096):
        from asyncframework_tpu_torch.metrics.system import Histogram

        self._lock = threading.Lock()
        self._mk = lambda: Histogram(capacity)
        self._stages: Dict[str, "Histogram"] = {}
        self._stage_bytes: Dict[str, "Histogram"] = {}
        self._staleness_v = self._mk()
        self._staleness_ms = self._mk()
        self.spans_total = 0
        self.traces_seen: "OrderedDict[str, None]" = OrderedDict()

    def add(self, span: Span) -> None:
        with self._lock:
            self.spans_total += 1
            h = self._stages.get(span.stage)
            if h is None:
                h = self._stages[span.stage] = self._mk()
            h.update(span.dur_ms)
            if span.bytes is not None:
                hb = self._stage_bytes.get(span.stage)
                if hb is None:
                    hb = self._stage_bytes[span.stage] = self._mk()
                hb.update(float(span.bytes))
            if span.staleness is not None:
                self._staleness_v.update(float(span.staleness))
            if span.staleness_ms is not None:
                self._staleness_ms.update(float(span.staleness_ms))
            self.traces_seen[span.trace_id] = None
            while len(self.traces_seen) > 4096:
                self.traces_seen.popitem(last=False)

    def add_wire(self, spans: Sequence[dict]) -> List[Span]:
        out = []
        for d in spans:
            try:
                sp = Span.from_wire(d)
            except Exception:  # noqa: BLE001 - junk from the wire
                continue
            self.add(sp)
            out.append(sp)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            stages = {
                name: self._stages[name].snapshot()
                for name in STAGES if name in self._stages
            }
            # stages outside the canonical vocabulary still show up
            for name in self._stages:
                if name not in stages:
                    stages[name] = self._stages[name].snapshot()
            out = {
                "spans": self.spans_total,
                "traces": len(self.traces_seen),
                "stages_ms": stages,
                "staleness_versions": self._staleness_v.snapshot(),
                "staleness_ms": self._staleness_ms.snapshot(),
            }
            if self._stage_bytes:
                # wire-volume decomposition beside the latency one: rtt
                # spans carry their RPC's frame bytes (net/frame.py)
                out["stages_bytes"] = {
                    name: h.snapshot()
                    for name, h in self._stage_bytes.items()
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._stage_bytes.clear()
            self._staleness_v = self._mk()
            self._staleness_ms = self._mk()
            self.spans_total = 0
            self.traces_seen.clear()


_global_lock = threading.Lock()
_global_agg: Optional[TraceAggregator] = None


def aggregator() -> TraceAggregator:
    """The process-global aggregator (live UI / bench read it; the PS and
    RunInstruments write it)."""
    global _global_agg
    with _global_lock:
        if _global_agg is None:
            _global_agg = TraceAggregator()
        return _global_agg


def reset_aggregator() -> None:
    aggregator().reset()


def span_event(span: Span, time_ms: float) -> "object":
    """A :class:`~asyncframework_tpu_torch.metrics.bus.TraceSpan` bus event for a
    span (posting process supplies its run-relative ``time_ms``)."""
    from asyncframework_tpu_torch.metrics.bus import TraceSpan

    return TraceSpan(
        time_ms=time_ms, stage=span.stage, trace_id=span.trace_id,
        span_id=span.span_id, parent_id=span.parent_id,
        worker_id=span.worker_id, model_version=span.model_version,
        start_ms=span.start_ms, dur_ms=span.dur_ms,
        staleness=span.staleness, staleness_ms=span.staleness_ms,
        accepted=span.accepted, bytes=span.bytes,
    )


# ----------------------------------------------- reconstruction (async-trace)
def _pct(vals: List[float], q: float) -> float:
    """Nearest-rank percentile -- THE rule, shared with the live
    histograms so post-hoc decomposition never disagrees with the UI."""
    from asyncframework_tpu_torch.metrics.system import Histogram

    return Histogram._pct(vals, q)


def _stats(vals: List[float]) -> dict:
    vals = sorted(vals)
    n = len(vals)
    return {
        "count": n,
        "mean": sum(vals) / n,
        "p50": _pct(vals, 0.50),
        "p95": _pct(vals, 0.95),
        "p99": _pct(vals, 0.99),
        "max": vals[-1],
    }


def load_trace_events(event_log_path) -> tuple:
    """Replay an event log; returns (TraceSpan events, truncated_records)."""
    from asyncframework_tpu_torch.metrics.bus import TraceSpan
    from asyncframework_tpu_torch.metrics.eventlog import EventLogReader

    reader = EventLogReader(event_log_path)
    spans = [ev for ev in reader.replay(strict=False)
             if isinstance(ev, TraceSpan)]
    return spans, reader.truncated_records


def build_traces(spans) -> "OrderedDict[str, list]":
    """Group spans by trace_id, each ordered along the canonical critical
    path (stage order, then start time)."""
    order = {s: i for i, s in enumerate(STAGES)}
    by_trace: Dict[str, list] = defaultdict(list)
    for sp in spans:
        by_trace[sp.trace_id].append(sp)
    out: "OrderedDict[str, list]" = OrderedDict()
    for tid in sorted(by_trace,
                      key=lambda t: min(s.start_ms for s in by_trace[t])):
        out[tid] = sorted(
            by_trace[tid],
            key=lambda s: (order.get(s.stage, len(STAGES)), s.start_ms),
        )
    return out


def complete_traces(traces: "OrderedDict[str, list]") -> "OrderedDict[str, list]":
    """Traces whose span chain covers the full client critical path
    (pull.rtt -> compute -> push.rtt), i.e. survived the wire round trip."""
    out: "OrderedDict[str, list]" = OrderedDict()
    for tid, spans in traces.items():
        have = {s.stage for s in spans}
        if all(st in have for st in CHAIN_STAGES):
            out[tid] = spans
    return out


def decomposition(spans) -> dict:
    """Per-stage latency stats + staleness distributions from TraceSpan
    events (the post-hoc analog of TraceAggregator.snapshot)."""
    by_stage: Dict[str, List[float]] = defaultdict(list)
    by_bytes: Dict[str, List[float]] = defaultdict(list)
    stale_v: List[float] = []
    stale_ms: List[float] = []
    for sp in spans:
        by_stage[sp.stage].append(float(sp.dur_ms))
        b = getattr(sp, "bytes", None)
        if b is not None:
            by_bytes[sp.stage].append(float(b))
        if sp.staleness is not None:
            stale_v.append(float(sp.staleness))
        if sp.staleness_ms is not None:
            stale_ms.append(float(sp.staleness_ms))
    out = {
        "stages_ms": {
            st: _stats(by_stage[st])
            for st in STAGES if st in by_stage
        },
        "spans": len(spans),
    }
    for st in by_stage:
        if st not in out["stages_ms"]:
            out["stages_ms"][st] = _stats(by_stage[st])
    if by_bytes:
        # wire-volume decomposition beside the latency one: rtt spans
        # carry their RPC's frame bytes (net/frame.py choke point)
        out["stages_bytes"] = {
            st: _stats(v) for st, v in by_bytes.items()
        }
    if stale_v:
        out["staleness_versions"] = _stats(stale_v)
    if stale_ms:
        out["staleness_ms"] = _stats(stale_ms)
    return out


def straggler_report(spans) -> List[dict]:
    """Per-worker critical-path profile, slowest first: who is dragging the
    run, and in which stage."""
    by_worker: Dict[int, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for sp in spans:
        by_worker[sp.worker_id][sp.stage].append(float(sp.dur_ms))
    rows = []
    for wid, stages in by_worker.items():
        path_ms = sum(
            sum(v) / len(v) for st, v in stages.items()
            if st in CLIENT_STAGES
        )
        rows.append({
            "worker_id": wid,
            "spans": sum(len(v) for v in stages.values()),
            "critical_path_ms": path_ms,
            "mean_ms": {st: sum(v) / len(v) for st, v in stages.items()},
        })
    rows.sort(key=lambda r: -r["critical_path_ms"])
    if rows:
        med = sorted(r["critical_path_ms"] for r in rows)[len(rows) // 2]
        for r in rows:
            r["vs_median"] = (
                round(r["critical_path_ms"] / med, 2) if med > 0 else None
            )
    return rows


def chrome_trace(spans) -> dict:
    """Chrome ``chrome://tracing`` / Perfetto JSON: one complete ("X")
    event per span; pid = worker id, tid separates the worker's client
    stages from the PS-side stages of its updates."""
    events = []
    for sp in spans:
        client = sp.stage in CLIENT_STAGES
        args = {"trace_id": sp.trace_id, "model_version": sp.model_version}
        if sp.staleness is not None:
            args["staleness"] = sp.staleness
        if sp.staleness_ms is not None:
            args["staleness_ms"] = sp.staleness_ms
        if sp.accepted is not None:
            args["accepted"] = sp.accepted
        events.append({
            "name": sp.stage,
            "cat": "worker" if client else "ps",
            "ph": "X",
            "ts": sp.start_ms * 1e3,     # microseconds
            "dur": max(sp.dur_ms, 1e-3) * 1e3,
            "pid": int(sp.worker_id),
            "tid": 0 if client else 1,
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "asyncframework-tpu bin/async-trace"},
    }


def _fmt_table(headers: List[str], rows: List[List[object]]) -> str:
    cells = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    lines = []
    for j, row in enumerate(cells):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``bin/async-trace <event_log> [--chrome OUT.json] [--json]``."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="async-trace",
        description="Reconstruct per-update traces from an event log: "
        "latency decomposition, straggler report, Chrome tracing export.",
    )
    p.add_argument("event_log", help="JSONL(.gz) event log path")
    p.add_argument("--chrome", default=None, metavar="OUT",
                   help="write Chrome chrome://tracing JSON here")
    p.add_argument("--json", action="store_true",
                   help="print the machine-readable summary instead of "
                   "tables")
    args = p.parse_args(argv)

    spans, truncated = load_trace_events(args.event_log)
    traces = build_traces(spans)
    complete = complete_traces(traces)
    deco = decomposition(spans)
    stragglers = straggler_report(spans)
    summary = {
        "spans": len(spans),
        "traces": len(traces),
        "complete_traces": len(complete),
        "truncated_records": truncated,
        "decomposition": deco,
        "stragglers": stragglers,
    }
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(chrome_trace(spans), f)
        summary["chrome"] = args.chrome
    if args.json:
        print(json.dumps(summary, default=float))
        # same exit contract as table mode: a trace-less log (sampling
        # off / no event log attached) is a configuration error scripted
        # callers must be able to gate on
        return 0 if spans else 1
    print(f"event log: {args.event_log}")
    print(f"spans: {len(spans)}  traces: {len(traces)}  "
          f"complete chains: {len(complete)}"
          + (f"  truncated records skipped: {truncated}" if truncated
             else ""))
    if not spans:
        print("no TraceSpan events found (was async.trace.sample > 0 and "
              "an event log attached?)", file=sys.stderr)
        return 1
    print("\nlatency decomposition (ms):")
    rows = []
    for st, s in deco["stages_ms"].items():
        rows.append([st, s["count"], f"{s['p50']:.2f}", f"{s['p95']:.2f}",
                     f"{s['p99']:.2f}", f"{s['max']:.2f}",
                     f"{s['mean']:.2f}"])
    print(_fmt_table(["stage", "count", "p50", "p95", "p99", "max", "mean"],
                     rows))
    for key, label in (("staleness_versions", "staleness (versions)"),
                       ("staleness_ms", "staleness (ms)")):
        if key in deco:
            s = deco[key]
            print(f"\n{label}: p50={s['p50']:.2f} p95={s['p95']:.2f} "
                  f"p99={s['p99']:.2f} max={s['max']:.2f}")
    print("\nper-worker straggler report (slowest first):")
    rows = []
    for r in stragglers:
        m = r["mean_ms"]
        rows.append([
            r["worker_id"], r["spans"], f"{r['critical_path_ms']:.2f}",
            r.get("vs_median"),
            f"{m.get(COMPUTE, 0.0):.2f}", f"{m.get(PULL_RTT, 0.0):.2f}",
            f"{m.get(PUSH_RTT, 0.0):.2f}",
        ])
    print(_fmt_table(
        ["worker", "spans", "critical-path ms", "vs median",
         "compute", "pull.rtt", "push.rtt"], rows,
    ))
    if args.chrome:
        print(f"\nchrome tracing JSON: {args.chrome} "
              "(open via chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via bin/async-trace
    import sys

    sys.exit(main())

"""Prometheus text exposition (format 0.0.4) for every process.

One :func:`render` call produces the ``/metrics`` body from the same
sources the time-series sampler reads: the counter-family registry
(``async_<family>_<key>_total`` counters), the live derived sources
(serving freshness/latency, trace stage percentiles, convergence
scalars -- gauges), the SLO engine (``async_slo_state`` per rule:
0 = ok, 1 = pending, 2 = firing, -1 = no_data), and a process-identity
``async_process_info`` gauge.  Every sample carries the process labels
(``role``, ``run_id``, plus whatever the server adds -- ``wid`` on
workers) so a cluster scrape distinguishes PS / worker / replica /
frontend / master series without name collisions.

Metric-name hygiene: family keys are free-form internal strings
(``sent.PULL``, ``pull.rtt.p95_ms``); :func:`_metric_name` maps them to
``[a-zA-Z_][a-zA-Z0-9_]*`` deterministically.  :func:`parse_exposition`
is the strict reader the tier-1 tests (and anyone debugging a scrape)
use: it validates comment/sample line shape, label syntax, float
values, and TYPE declarations, returning ``{(name, labels): value}``.

A copy of the JAX package's ``metrics/prom.py``: each package's
exposition passes the other's parser.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+"
    r"(?P<value>[^\s]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _metric_name(*parts: str) -> str:
    out = "_".join(parts)
    out = re.sub(r"[^a-zA-Z0-9_]", "_", out)
    if not out or not re.match(r"[a-zA-Z_]", out[0]):
        out = "_" + out
    return out


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Writer:
    def __init__(self, labels: Dict[str, str]):
        self.labels = dict(labels)
        # the exposition format requires all lines of one metric to form
        # a single uninterrupted group, but callers interleave names
        # (e.g. the SLO loop emits state/value/fired per rule) -- so
        # samples buffer per metric and body() emits grouped, metrics in
        # first-seen order
        self._groups: Dict[str, List[str]] = {}
        self._order: List[str] = []

    def sample(self, name: str, value: float, mtype: str = "gauge",
               help_: str = "", extra: Optional[Dict[str, str]] = None
               ) -> None:
        if value is None:
            return
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        group = self._groups.get(name)
        if group is None:
            group = self._groups[name] = (
                [f"# HELP {name} {help_}"] if help_ else []
            )
            group.append(f"# TYPE {name} {mtype}")
            self._order.append(name)
        labels = dict(self.labels)
        if extra:
            labels.update(extra)
        # full precision: '%g' would quantize large counters (a 10 MB
        # byte counter to 6 significant digits), corrupting scrape-side
        # rate() deltas -- integral values print exact, floats via repr
        text = (str(int(v)) if v.is_integer() and abs(v) < 2**63
                else repr(v))
        group.append(f"{name}{_fmt_labels(labels)} {text}")

    def body(self) -> str:
        return "\n".join(line for name in self._order
                         for line in self._groups[name]) + "\n"


def render(labels: Optional[Dict[str, str]] = None) -> str:
    """The ``/metrics`` body for THIS process."""
    from asyncframework_tpu_torch.metrics import registry, slo, timeseries
    from asyncframework_tpu_torch.metrics import trace as trace_mod

    w = _Writer(labels or {})
    w.sample("async_process_info", 1.0, help_="process identity carrier "
             "(labels: role, run_id, ...)")

    fams = registry.families()
    for fam_name, fam in fams.items():
        try:
            tot = fam.totals()
        except Exception:  # noqa: BLE001 - one family must not kill /metrics
            continue
        for key, val in sorted(tot.items()):
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            if key in fam.high_water:
                w.sample(_metric_name("async", fam_name, key), val,
                         mtype="gauge", help_=f"{fam_name} high-water mark")
            else:
                w.sample(_metric_name("async", fam_name, key, "total"),
                         val, mtype="counter", help_=fam.doc or fam_name)

    # trace stage percentiles (latency decomposition as scrapeable gauges)
    snap = trace_mod.aggregator().snapshot()
    for stage, s in sorted((snap.get("stages_ms") or {}).items()):
        if not s.get("count"):
            continue
        for q in ("p50", "p95", "p99"):
            w.sample("async_trace_stage_ms", s[q], mtype="gauge",
                     help_="per-stage update-lifecycle latency (ms)",
                     extra={"stage": stage, "quantile": q})
    for key, metric in (("staleness_ms", "async_trace_staleness_ms"),
                        ("staleness_versions",
                         "async_trace_staleness_versions")):
        s = snap.get(key) or {}
        if s.get("count"):
            for q in ("p50", "p95", "p99"):
                w.sample(metric, s[q], mtype="gauge",
                         help_="gradient staleness distribution",
                         extra={"quantile": q})

    # serving derived gauges (freshness is THE serve SLO input)
    try:
        for key, val in sorted(timeseries._serving_source().items()):
            w.sample(_metric_name("async_serving", key), val,
                     mtype="gauge", help_="serving-plane derived gauge")
    except Exception:  # noqa: BLE001
        pass

    # convergence scalars
    conv = timeseries.convergence().summary()
    if "last_loss" in conv:
        w.sample("async_convergence_loss", conv["last_loss"],
                 mtype="gauge", help_="latest folded training loss")
    if conv.get("slope_per_s") is not None:
        w.sample("async_convergence_slope_per_s", conv["slope_per_s"],
                 mtype="gauge",
                 help_="trailing-half loss slope (units/s; negative = "
                       "converging)")

    # SLO states: 0 ok, 1 pending, 2 firing, -1 no_data
    code = {slo.OK: 0.0, slo.PENDING: 1.0, slo.FIRING: 2.0,
            slo.NO_DATA: -1.0}
    try:
        rules = slo.engine().evaluate()
    except Exception:  # noqa: BLE001 - a bad rule set must not kill /metrics
        rules = {}
    for name, r in sorted(rules.items()):
        w.sample("async_slo_state", code.get(r["state"], -1.0),
                 mtype="gauge",
                 help_="SLO rule state: 0 ok, 1 pending, 2 firing, "
                       "-1 no_data",
                 extra={"rule": name})
        if r.get("value") is not None:
            w.sample("async_slo_value", r["value"], mtype="gauge",
                     help_="SLO rule last aggregate value",
                     extra={"rule": name})
        w.sample("async_slo_fired_total", r.get("fired", 0),
                 mtype="counter", help_="times this rule entered firing",
                 extra={"rule": name})
    return w.body()


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                         ...]], float]:
    """Strict Prometheus text-format reader (the test-suite validator).

    Returns ``{(metric_name, sorted_label_items): value}``.  Raises
    ``ValueError`` on: malformed sample/comment lines, invalid metric or
    label names, unparseable float values, a sample whose metric was
    never TYPE-declared, or metric groups that are interleaved (the
    format requires all lines of one metric to be contiguous).
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    typed: set = set()
    closed: set = set()
    current: Optional[str] = None

    def enter_group(name: str, lineno: int) -> None:
        nonlocal current
        if name == current:
            return
        if name in closed:
            raise ValueError(
                f"line {lineno}: metric {name!r} reappears after its "
                f"group ended (interleaved groups)")
        if current is not None:
            closed.add(current)
        current = name

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            if not _NAME_OK.match(parts[2]):
                raise ValueError(
                    f"line {lineno}: bad metric name {parts[2]!r}")
            enter_group(parts[2], lineno)
            if parts[1] == "TYPE":
                if len(parts) != 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(f"line {lineno}: bad TYPE {line!r}")
                typed.add(parts[2])
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: bad sample line {line!r}")
        name = m.group("name")
        if name not in typed:
            raise ValueError(
                f"line {lineno}: sample for undeclared metric {name!r}")
        enter_group(name, lineno)
        raw_labels = m.group("labels") or ""
        labels: Dict[str, str] = {}
        if raw_labels.strip():
            matched = []
            for lm in _LABEL_RE.finditer(raw_labels):
                labels[lm.group(1)] = lm.group(2)
                matched.append(lm.group(0))
            # everything between the braces must be label pairs (modulo
            # separators) -- leftovers mean malformed label syntax
            stripped = re.sub(r"[,\s]", "", raw_labels)
            joined = len(re.sub(r"[,\s]", "", "".join(matched)))
            if joined != len(stripped):
                raise ValueError(
                    f"line {lineno}: bad label syntax {raw_labels!r}")
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad value {m.group('value')!r}")
        out[(name, tuple(sorted(labels.items())))] = value
    return out

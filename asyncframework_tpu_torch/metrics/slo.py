"""Declarative SLO engine over the time-series store.

Rules come from conf (``async.slo.rules``) in a small grammar, one rule
per ``;``-separated clause::

    <name>: <agg>(<series>) <op> <threshold> [over <window>s] [for <burn>s]
            [unless <series>]

- ``agg``: ``last | min | max | mean | p50 | p95 | p99 | count | rate``
  (``rate`` = per-second counter slope over the window, the updates/s
  floor's aggregate).
- ``series``: a store series name (``serving.freshness_lag_ms``,
  ``ps.accepted``, ``trace.staleness_ms_p95``, ...).
- ``op``: ``<  <=  >  >=``.
- ``over`` (default 30 s): the evaluation window.
- ``for`` (default 0 s): the burn duration -- the rule must be violated
  continuously this long before it FIRES (transient spikes stay
  ``pending``).
- ``unless`` (optional): a gate series -- while its LAST sample is
  truthy the rule is not applicable and reads ``no_data`` (clearing
  even a firing state: the gate is an explicit "this condition no
  longer applies" signal, unlike silence).  The registered default uses
  it so the updates/s floor stands down once ``ps.done`` goes to 1 --
  a finished run serving reads forever is healthy, not an outage.

Example (the registered default)::

    serve_freshness: p95(serving.freshness_lag_ms) < 2000 over 15s for 2s;
    predict_p99: max(serving.predict_ms_p99) < 500 over 30s for 5s;
    staleness_ms: max(trace.staleness_ms_p95) < 60000 over 30s for 5s;
    updates_floor: rate(ps.accepted) > 0.5 over 30s for 10s unless ps.done

Each rule is a tiny state machine: ``no_data`` (no samples in window;
never fires -- an idle process is not an outage, and a rule whose
subsystem never ran must not wedge the health red) -> ``ok`` ->
``pending`` (violating, burn accumulating) -> ``firing`` (violated for
>= ``for``); recovery returns it to ``ok`` and counts a transition.
``health()`` is the ``/api/status`` ``health`` section: per-rule state,
last value vs threshold, violation start, burn seconds, and
fired/recovered transition counts.

Evaluation is driven by the telemetry sampler (every tick) and on
demand by ``health()`` readers; both paths are cheap (a window scan per
rule) and lock-guarded.

A copy of the JAX package's ``metrics/slo.py``, with the same rule
grammar and default rule set (``async.slo.rules``); rules over series
of subsystems this package does not have yet read ``no_data``.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

AGGS = ("last", "min", "max", "mean", "p50", "p95", "p99", "count", "rate")
OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}

_RULE_RE = re.compile(
    r"^\s*(?P<name>[A-Za-z_][\w.-]*)\s*:\s*"
    r"(?P<agg>[a-z0-9]+)\s*\(\s*(?P<series>[\w.-]+)\s*\)\s*"
    r"(?P<op><=|>=|<|>)\s*(?P<threshold>-?\d+(?:\.\d+)?(?:e-?\d+)?)"
    r"(?:\s+over\s+(?P<window>\d+(?:\.\d+)?)\s*s)?"
    r"(?:\s+for\s+(?P<burn>\d+(?:\.\d+)?)\s*s)?"
    r"(?:\s+unless\s+(?P<unless>[\w.-]+))?\s*$",
    re.IGNORECASE,
)


@dataclass(frozen=True)
class SLORule:
    name: str
    agg: str
    series: str
    op: str
    threshold: float
    window_s: float = 30.0
    for_s: float = 0.0
    unless_series: Optional[str] = None

    def spec(self) -> str:
        out = (f"{self.name}: {self.agg}({self.series}) {self.op} "
               f"{self.threshold:g} over {self.window_s:g}s "
               f"for {self.for_s:g}s")
        if self.unless_series:
            out += f" unless {self.unless_series}"
        return out


def parse_rules(text: str) -> List[SLORule]:
    """Parse the conf rule string; raises ValueError naming the bad
    clause (a typo'd SLO must fail loudly at engine build, not silently
    never fire)."""
    rules: List[SLORule] = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        m = _RULE_RE.match(clause)
        if m is None:
            raise ValueError(f"unparseable SLO rule clause: {clause!r}")
        agg = m.group("agg").lower()
        if agg not in AGGS:
            raise ValueError(
                f"unknown aggregate {agg!r} in SLO rule {clause!r} "
                f"(have: {', '.join(AGGS)})"
            )
        rules.append(SLORule(
            name=m.group("name"),
            agg=agg,
            series=m.group("series"),
            op=m.group("op"),
            threshold=float(m.group("threshold")),
            window_s=float(m.group("window") or 30.0),
            for_s=float(m.group("burn") or 0.0),
            unless_series=m.group("unless"),
        ))
    names = [r.name for r in rules]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise ValueError(f"duplicate SLO rule names: {sorted(dup)}")
    return rules


OK, PENDING, FIRING, NO_DATA = "ok", "pending", "firing", "no_data"


@dataclass
class _RuleState:
    state: str = NO_DATA
    value: Optional[float] = None
    violating_since: Optional[float] = None  # monotonic s
    fired_count: int = 0
    recovered_count: int = 0
    last_change: Optional[float] = None


class SLOEngine:
    """Evaluates a rule set against a :class:`TimeSeriesStore`."""

    def __init__(self, rules: List[SLORule], store=None,
                 now_fn=time.monotonic):
        self.rules = list(rules)
        self._store = store
        self._now = now_fn
        self._lock = threading.Lock()
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }

    def _get_store(self):
        if self._store is not None:
            return self._store
        from asyncframework_tpu_torch.metrics import timeseries

        return timeseries.store()

    def _aggregate(self, rule: SLORule) -> Optional[float]:
        st = self._get_store()
        if rule.agg == "rate":
            return st.rate(rule.series, rule.window_s)
        agg = st.window_agg(rule.series, rule.window_s)
        if not agg.get("count"):
            return None
        if rule.agg == "count":
            return float(agg["count"])
        return float(agg[rule.agg])

    def evaluate(self) -> Dict[str, Dict]:
        """One evaluation pass over every rule; returns the health rule
        map (also cached for :meth:`health`)."""
        now = self._now()
        out: Dict[str, Dict] = {}
        for rule in self.rules:
            gated = False
            if rule.unless_series is not None:
                g = self._get_store().last(rule.unless_series)
                gated = bool(g)
            value = None if gated else self._aggregate(rule)
            with self._lock:
                rs = self._states[rule.name]
                rs.value = value
                if gated:
                    # explicit not-applicable signal (e.g. the run is
                    # DONE): stand down COMPLETELY -- unlike silence,
                    # the gate clears even a firing state
                    if rs.state != NO_DATA:
                        rs.state = NO_DATA
                        rs.last_change = now
                    rs.violating_since = None
                elif value is None:
                    # no samples: never fire on silence -- but a rule
                    # that WAS firing stays firing until data says
                    # otherwise (a dead subsystem must not auto-clear
                    # its own alarm by dying harder)
                    if rs.state != FIRING:
                        if rs.state != NO_DATA:
                            rs.state = NO_DATA
                            rs.last_change = now
                        rs.violating_since = None
                else:
                    violated = not OPS[rule.op](value, rule.threshold)
                    if violated:
                        if rs.violating_since is None:
                            rs.violating_since = now
                        burn = now - rs.violating_since
                        want = FIRING if burn >= rule.for_s else PENDING
                        if rs.state != want:
                            if want == FIRING:
                                rs.fired_count += 1
                            rs.state = want
                            rs.last_change = now
                    else:
                        if rs.state == FIRING:
                            rs.recovered_count += 1
                        if rs.state != OK:
                            rs.state = OK
                            rs.last_change = now
                        rs.violating_since = None
                out[rule.name] = self._rule_view(rule, rs, now)
        return out

    def _rule_view(self, rule: SLORule, rs: _RuleState, now: float) -> Dict:
        burn = (now - rs.violating_since
                if rs.violating_since is not None else 0.0)
        out = {
            "state": rs.state,
            "value": rs.value,
            "threshold": rule.threshold,
            "op": rule.op,
            "agg": rule.agg,
            "series": rule.series,
            "window_s": rule.window_s,
            "for_s": rule.for_s,
            "burn_s": round(burn, 3),
            "fired": rs.fired_count,
            "recovered": rs.recovered_count,
        }
        if rule.unless_series:
            out["unless"] = rule.unless_series
        return out

    def health(self) -> Dict[str, object]:
        """The ``/api/status`` ``health`` section: evaluate now, roll up
        the overall state (firing > pending > ok; pure-no_data = ok --
        an idle process is healthy)."""
        rules = self.evaluate()
        states = [r["state"] for r in rules.values()]
        if FIRING in states:
            overall = FIRING
        elif PENDING in states:
            overall = PENDING
        else:
            overall = OK
        return {
            "state": overall,
            "firing": sorted(n for n, r in rules.items()
                             if r["state"] == FIRING),
            "rules": rules,
        }

    def reset(self) -> None:
        with self._lock:
            self._states = {r.name: _RuleState() for r in self.rules}


# --------------------------------------------------------------- global
_glock = threading.Lock()
_engine: Optional[SLOEngine] = None


def engine() -> SLOEngine:
    """The process-global engine, built from conf ``async.slo.rules`` on
    first touch (rebuild after conf changes via :func:`reset_engine`)."""
    global _engine
    with _glock:
        if _engine is None:
            from asyncframework_tpu_torch.conf import SLO_RULES, global_conf

            _engine = SLOEngine(parse_rules(
                str(global_conf().get(SLO_RULES))
            ))
        return _engine


def reset_engine() -> None:
    """Drop the global engine so the next touch re-reads conf (tests,
    and ``metrics.reset_totals`` per-run isolation)."""
    global _engine
    with _glock:
        _engine = None


def bench_verdicts(updates_per_sec: Optional[float],
                   trajectory, extra_series=None) -> Dict[str, Dict]:
    """Static SLO verdicts for a finished benchmark run: evaluate the
    conf rule set against synthesized series -- ``ps.accepted`` rate =
    the run's updates/s, ``convergence.loss`` = the trajectory, plus
    any ``extra_series`` (name -> [(t_ms, value), ...]; the adaptive
    bench arm feeds ``control.changes`` so ``controller_converged`` is
    judged on the real decision trace) -- so BENCH_*.json records
    pass/violated per rule (rules whose series the run never produced
    report ``no_data``)."""
    from asyncframework_tpu_torch.conf import SLO_RULES, global_conf
    from asyncframework_tpu_torch.metrics.timeseries import TimeSeriesStore

    rules = parse_rules(str(global_conf().get(SLO_RULES)))
    st = TimeSeriesStore(capacity=4096)
    now = st.now_s()
    span_ms = float(trajectory[-1][0]) if trajectory else 0.0
    for pts in (extra_series or {}).values():
        if pts:
            span_ms = max(span_ms, float(pts[-1][0]))
    t0 = now - span_ms / 1e3
    if trajectory:
        for (t_ms, loss) in trajectory:
            st.record("convergence.loss", loss, t_s=t0 + float(t_ms) / 1e3)
    for name, pts in (extra_series or {}).items():
        for (t_ms, v) in pts:
            st.record(name, float(v), t_s=t0 + float(t_ms) / 1e3)
    extra_names = set(extra_series or ())
    eng = SLOEngine(rules, store=st)
    out: Dict[str, Dict] = {}
    for rule in eng.rules:
        if rule.series == "ps.accepted" and rule.agg == "rate":
            value: Optional[float] = updates_per_sec
        elif rule.agg == "rate" and rule.series in extra_names:
            # a rate rule over a synthesized counter keeps its DECLARED
            # window, anchored at run end: "the knob-change rate falls
            # below threshold within the burn window" is a claim about
            # the settled tail, not the whole-run average
            value = eng._aggregate(rule)
        else:
            # aggregate over the FULL synthesized span, not the rule's
            # live window (the run already happened)
            wide = SLORule(rule.name, rule.agg, rule.series, rule.op,
                           rule.threshold, window_s=1e9, for_s=0.0)
            value = eng._aggregate(wide)
        if value is None:
            out[rule.name] = {"state": NO_DATA, "value": None,
                              "threshold": rule.threshold}
        else:
            ok = OPS[rule.op](value, rule.threshold)
            out[rule.name] = {
                "state": OK if ok else "violated",
                "value": round(float(value), 6),
                "threshold": rule.threshold,
            }
    return out

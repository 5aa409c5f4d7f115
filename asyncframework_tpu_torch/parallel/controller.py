"""Adaptive asynchrony controller: close the loop from telemetry to knobs.

Counterpart of ``asyncframework_tpu/parallel/controller.py``, in the
PyTorch package: the same decisions from the same signals, and the same
CTRL payload on the wire, so a worker of either package follows a
controller of the other.  The performance-critical knobs (``b``,
``async.pipeline.depth``, ``async.push.merge``, step size) are actuated
from the run's own telemetry -- the ASYNC paper's *history* pillar
(staleness-aware updates, arXiv:1907.08526), with the delay-adaptive step
sizes of "Faster Asynchronous SGD" (arXiv:1601.04033) as the damping law.

One :class:`AsyncController` runs on the primary PS.  Every tick it
reads the observed signals and re-evaluates four knob targets:

- **step damping** (``async.step.size`` tunable): installs the bounded
  ``1/(1 + tau - free)`` law the PS drain applies per accepted push
  (exact and per-item -- the damp factor rides the merge kernel's mask
  slot, so dedup/replay semantics are untouched), plus per-worker extra
  damp factors for observer-flagged stragglers;
- **cohort size** (``async.bucket.ratio`` tunable): re-clamps the
  partial-barrier ``b`` between the declared floor/ceiling from the
  observed straggler spread, so one DELAYed worker stops gating every
  wave;
- **pipeline depth** (``async.pipeline.depth`` tunable): auto-sizes the
  live in-flight window from measured pull/push RTT vs compute time,
  nudged by the prefetch-hit and stall counters;
- **push-merge budget** (``async.push.merge`` tunable): resizes the
  fused-drain budget from merge-queue depth vs push rate (never past
  the compiled bound).

Decisions are guarded twice -- a relative HYSTERESIS dead-band plus a
per-knob cooldown, and an oscillation guard that freezes a knob whose
direction reverses too often -- then propagate through the existing
SETMAP/WELCOME control path as a CTRL payload next to the shard map and
epoch vector (fence-stamped: a deposed controller's decision is refused
by a promoted member).  With ``async.control.enabled`` off nothing here
runs and the wire is byte-identical to the knob being absent.

The controller may only actuate DECLARED tunables: every knob in
:data:`CONTROLLER_TUNABLES` must be a registered ``ConfigEntry`` with
``tunable=True`` and floor/ceiling bounds, and every ``_actuate`` call
names one -- the lint's ``conf-tunable`` rule
(``python -m asyncframework_tpu_torch.analysis.cli``) enforces both
statically (undeclaring a tunable or actuating an undeclared key fails
lint), and :meth:`AsyncController._actuate` enforces it at
runtime.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from asyncframework_tpu_torch.metrics import flightrec as _flight
from asyncframework_tpu_torch.utils.threads import guarded

#: the declared actuation surface: tunable conf key -> the CTRL wire
#: field the decision lands in.  the lint cross-checks every key here
#: (and every ``_actuate`` literal) against conf.py's tunable registry.
CONTROLLER_TUNABLES: Dict[str, str] = {
    "async.step.size": "damp",
    "async.bucket.ratio": "b",
    "async.pipeline.depth": "depth",
    "async.push.merge": "merge",
}

# ------------------------------------------------------------- counters
_TOTALS_LOCK = threading.Lock()
_TOTALS: Dict[str, int] = {}
_KEYS = ("ticks", "decisions", "changes", "clamps", "osc_trips",
         "stale_rejects", "wdamp_set")


def control_totals() -> Dict[str, int]:
    """Process-global controller counters (the ``control`` counter
    family): ticks run, decisions evaluated, knob CHANGES shipped (the
    ``controller_converged`` SLO watches their rate), targets clamped
    at a bound, oscillation-guard trips, stale CTRL installs refused,
    per-worker damp table updates."""
    with _TOTALS_LOCK:
        return {k: _TOTALS.get(k, 0) for k in _KEYS}


def reset_control_totals() -> None:
    with _TOTALS_LOCK:
        _TOTALS.clear()


def _bump(key: str, n: int = 1) -> None:
    with _TOTALS_LOCK:
        _TOTALS[key] = _TOTALS.get(key, 0) + n


# ------------------------------------------------------------ ctrl wire
def ctrl_seq(wire: Optional[dict]) -> Tuple[int, int]:
    """(epoch, seq) ordering key of a CTRL payload; (0, -1) for None."""
    if not wire:
        return (0, -1)
    return (int(wire.get("ep", 0) or 0), int(wire.get("seq", -1)))


class ControlSink:
    """Client-side CTRL receiver (one per worker process).

    The PS attaches the current CTRL payload to a PULL reply whenever
    the request's ``cs`` stamp is older than the newest decision;
    :meth:`install` folds it monotonically by (epoch, seq) -- a stale
    payload from a lagging shard can never roll a newer decision back.
    The pipelined worker loop reads :meth:`depth` each iteration to
    size its live in-flight window."""

    def __init__(self, wire: Optional[dict] = None):
        self._lock = threading.Lock()
        self._wire: Optional[dict] = None
        if wire:
            self.install(wire)

    def install(self, wire: dict) -> bool:
        with self._lock:
            if ctrl_seq(wire) <= ctrl_seq(self._wire):
                return False
            self._wire = dict(wire)
            return True

    @property
    def seq(self) -> int:
        with self._lock:
            return int((self._wire or {}).get("seq", -1))

    @property
    def stamp(self) -> list:
        """The installed decision stamp as ``[epoch, seq]`` -- what PULL
        requests carry as ``cs``.  Both halves matter: a restarted
        controller under a freshly minted epoch starts seq over, and a
        bare-seq compare would never re-deliver its decisions."""
        with self._lock:
            return [int((self._wire or {}).get("ep", 0) or 0),
                    int((self._wire or {}).get("seq", -1))]

    def depth(self, configured: int) -> int:
        """Effective pipeline depth: the controller's target clamped to
        [1, configured].  The loop SHAPE (serial vs pipelined) is chosen
        at worker start, so a 0/absent target keeps the configured
        depth and the controller never flips a loop serial<->pipelined
        mid-run."""
        with self._lock:
            d = int((self._wire or {}).get("depth", 0) or 0)
        if d <= 0:
            return configured
        return max(1, min(configured, d))

    def wire(self) -> Optional[dict]:
        with self._lock:
            return dict(self._wire) if self._wire else None


# ----------------------------------------------------------- controller
class _Knob:
    """Per-knob actuation state: current value, hysteresis/cooldown
    bookkeeping, and the oscillation guard (direction-reversal counting
    within a sliding freeze window)."""

    def __init__(self, name: str, value: float):
        self.name = name
        self.value = value
        self.last_change_t: Optional[float] = None
        self.last_dir = 0
        self.reversals: List[float] = []  # times of direction reversals
        self.frozen_until: Optional[float] = None
        self.changes = 0

    def frozen(self, now: float) -> bool:
        if self.frozen_until is None:
            return False
        if now >= self.frozen_until:
            self.frozen_until = None
            self.reversals.clear()
            self.last_dir = 0
            return False
        return True


class AsyncController:
    """The closed loop: signals -> decisions -> CTRL actuation.

    ``ps`` is the primary :class:`~asyncframework_tpu_torch.parallel.ps_dcn.
    ParameterServer` (decisions install locally via ``set_control``),
    ``group`` an optional ShardGroup (decisions re-SETMAP to every
    member, surviving shard relaunches and standby promotions),
    ``observer`` an optional ClusterObserver whose derived straggler
    scores refine the per-worker damp table.  ``now_fn`` makes every
    guard ManualClock-testable."""

    def __init__(self, ps, conf=None, group=None, observer=None,
                 now_fn: Callable[[], float] = time.monotonic):
        from asyncframework_tpu_torch.conf import (
            CONTROL_COOLDOWN_S,
            CONTROL_DAMP_FREE,
            CONTROL_HYSTERESIS,
            CONTROL_INTERVAL_S,
            CONTROL_OSC_FREEZE_S,
            CONTROL_OSC_REVERSALS,
            OBSERVER_STRAGGLER_FACTOR,
            global_conf,
            registry,
        )

        conf = conf if conf is not None else global_conf()
        self.ps = ps
        self.group = group
        self.observer = observer
        self._now = now_fn
        self.cfg = ps.cfg
        self.interval_s = float(conf.get(CONTROL_INTERVAL_S))
        self.hysteresis = max(0.0, float(conf.get(CONTROL_HYSTERESIS)))
        self.cooldown_s = max(0.0, float(conf.get(CONTROL_COOLDOWN_S)))
        self.osc_reversals = max(2, int(conf.get(CONTROL_OSC_REVERSALS)))
        self.osc_freeze_s = max(0.0, float(conf.get(CONTROL_OSC_FREEZE_S)))
        self.straggler_factor = max(
            1.0, float(conf.get(OBSERVER_STRAGGLER_FACTOR)))
        #: declared bounds, read off the tunable ConfigEntries -- the
        #: ONE place floor/ceiling live (the lint pins their presence)
        reg = registry()
        self._bounds: Dict[str, Tuple[float, float]] = {}
        for key in CONTROLLER_TUNABLES:
            entry = reg.get(key)
            if entry is None or not getattr(entry, "tunable", False) \
                    or entry.floor is None or entry.ceiling is None:
                raise ValueError(
                    f"controller tunable {key!r} is not a declared "
                    f"tunable ConfigEntry with floor/ceiling bounds")
            self._bounds[key] = (float(entry.floor), float(entry.ceiling))
        self.damp_floor = self._bounds["async.step.size"][0]
        # configured baselines: the ceilings actuation can restore to
        self.b_conf = max(1, int(self.cfg.bucket_threshold))
        # (the conf is the one source of the depth, as for the workers)
        from asyncframework_tpu_torch.conf import PIPELINE_DEPTH

        self.depth_conf = max(0, int(conf.get(PIPELINE_DEPTH)))
        # damping law constants (installed once, per-item application
        # happens in the PS drain): free staleness slack defaults to
        # P + depth + 2 -- steady-state async staleness is ~P-1 PLUS
        # the pipelined in-flight window, and damping the healthy
        # steady state just slows convergence at a fixed iteration
        # budget; only ABNORMAL delay should damp
        free = float(conf.get(CONTROL_DAMP_FREE))
        self.damp_free = (
            float(self.cfg.num_workers + self.depth_conf + 2)
            if free < 0 else free)
        self.merge_conf = max(1, int(getattr(ps, "_merge_max", 1)))
        # knob state (started at the configured/static values)
        now = self._now()
        self._knobs: Dict[str, _Knob] = {
            "b": _Knob("b", float(self.b_conf)),
            "depth": _Knob("depth", float(self.depth_conf)),
            "merge": _Knob("merge", float(self.merge_conf)),
            # guard state for the per-worker damp TABLE: value tracks
            # the table size; the cooldown/oscillation machinery is
            # what matters (a score hovering at the flag threshold must
            # not emit a decision per tick)
            "wdamp": _Knob("wdamp", 0.0),
        }
        self._wdamp: Dict[int, float] = {}
        self._seq = 0
        self._t0 = now
        self._queue_ewma: Optional[float] = None
        self._last_decision: Optional[Dict[str, object]] = None
        # bounded decision trace (decision_log; the flight recorder
        # gets per-change breadcrumbs too)
        self._decisions: List[Dict[str, object]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ts_source = None
        self._status_section = None

    # ------------------------------------------------------------ wiring
    def start(self) -> "AsyncController":
        """Install the initial CTRL (damping law active from tick 0),
        register the ``control`` telemetry source + status section, and
        start the decision loop."""
        self._install(reason="controller start")
        from asyncframework_tpu_torch.metrics import live as _live
        from asyncframework_tpu_torch.metrics import timeseries as _ts

        self._ts_source = self._telemetry_source
        _ts.register_source("control", self._ts_source)
        self._status_section = self.status
        _live.register_status_section("control", self._status_section)
        _ts.ensure_started()
        if self.interval_s > 0:
            self._thread = threading.Thread(
                target=guarded(self._loop), name="async-controller",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        from asyncframework_tpu_torch.metrics import live as _live
        from asyncframework_tpu_torch.metrics import timeseries as _ts

        if self._ts_source is not None:
            _ts.unregister_source("control", self._ts_source)
        if self._status_section is not None:
            _live.unregister_status_section("control",
                                            self._status_section)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 -- a bad tick must never
                pass           # kill the control loop; next tick retries

    # ----------------------------------------------------------- signals
    def _signals(self) -> Dict[str, object]:
        """One coherent read of the input surface: PS-local per-worker
        stats + scalars, process-global pipeline counters, and the
        observer's derived fleet signals when one is attached."""
        from asyncframework_tpu_torch.parallel import ps_dcn as _ps_mod

        sig: Dict[str, object] = {
            "workers": self.ps.worker_stats(),
            "ps": self.ps.control_signals(),
            "pipeline": _ps_mod.pipeline_totals(),
        }
        sup = getattr(self.ps, "supervisor", None)
        if sup is not None:
            # partition-tolerant membership: a SUSPECT worker
            # (missed lease renewal, gray-RTT outlier) is a straggler
            # the moment the supervisor says so -- no need to wait for
            # its inter-arrival EWMA to drift
            try:
                from asyncframework_tpu_torch.parallel import (
                    supervisor as _sup_mod,
                )

                sig["suspects"] = [
                    w for w, m in sup.membership().items()
                    if m.get("state") == _sup_mod.SUSPECT
                ]
            except Exception:  # noqa: BLE001 -- telemetry only
                pass
        if self.observer is not None:
            try:
                sig["observer"] = self.observer.derived()
                sig["stragglers"] = self.observer.stragglers()
            except Exception:  # noqa: BLE001 -- observer optional
                pass
        return sig

    @staticmethod
    def _median(vals: List[float]) -> Optional[float]:
        if not vals:
            return None
        import statistics

        return float(statistics.median(vals))

    # --------------------------------------------------------- decisions
    def tick(self) -> Dict[str, object]:
        """One decision pass: read signals, re-evaluate every knob
        target through hysteresis/cooldown/oscillation guards, install
        a new CTRL payload if anything changed.  Returns the decision
        record (what changed and why; empty ``changed`` = no-op tick)."""
        _bump("ticks")
        sig = self._signals()
        now = self._now()
        changed: List[Dict[str, object]] = []
        with self._lock:
            changed += self._decide_b(sig, now)
            changed += self._decide_depth(sig, now)
            changed += self._decide_merge(sig, now)
            changed += self._decide_wdamp(sig, now)
            record: Dict[str, object] = {
                "t": round(now - self._t0, 3),
                "changed": changed,
                "knobs": {n: k.value for n, k in self._knobs.items()},
            }
            if changed:
                self._last_decision = {
                    **changed[-1], "t": record["t"],
                }
                for c in changed:
                    self._decisions.append({**c, "t": record["t"]})
                del self._decisions[:-256]
        if changed:
            _bump("changes", len(changed))
            reason = "; ".join(str(c["reason"]) for c in changed)
            self._install(reason=reason)
            for c in changed:
                _flight.note("control", knob=c["knob"], frm=c["from"],
                             to=c["to"], reason=c["reason"])
        return record

    def _actuate(self, key: str, knob: _Knob, target: float, now: float,
                 reason: str, lo: float, hi: float,
                 band: Optional[float] = None
                 ) -> List[Dict[str, object]]:
        """The ONE choke point every knob change goes through: clamp to
        the declared bounds, apply the hysteresis dead-band and
        cooldown, run the oscillation guard, then commit.  ``key`` must
        name a declared tunable (the lint checks the literals at this
        call's sites; this check is the runtime backstop).

        ``band`` overrides the dead-band: multiplicative knobs (merge,
        depth) default to ``max(1, cur * hysteresis)`` so noise-scale
        drifts never actuate; the cohort passes ``band=1`` -- its
        signal (the straggler COUNT) is already quantized, and dropping
        exactly one straggler from the wave is the whole point."""
        if key not in CONTROLLER_TUNABLES:
            raise ValueError(f"actuating undeclared tunable {key!r}")
        _bump("decisions")
        clamped = min(max(target, lo), hi)
        if clamped != target:
            _bump("clamps")
        target = clamped
        cur = knob.value
        if target == cur:
            return []
        if band is None:
            band = max(1.0, abs(cur) * self.hysteresis)
        if abs(target - cur) < band:
            return []
        if knob.frozen(now):
            return []
        if (knob.last_change_t is not None
                and now - knob.last_change_t < self.cooldown_s):
            return []
        direction = 1 if target > cur else -1
        if knob.last_dir and direction != knob.last_dir:
            knob.reversals = [t for t in knob.reversals
                              if now - t <= self.osc_freeze_s]
            knob.reversals.append(now)
            if len(knob.reversals) >= self.osc_reversals:
                # flapping: the signals are pushing the knob back and
                # forth faster than its effects can settle -- freeze it
                knob.frozen_until = now + self.osc_freeze_s
                _bump("osc_trips")
                _flight.note("control", knob=knob.name, frozen=True,
                             reason="oscillation guard")
                return []
        knob.last_dir = direction
        knob.last_change_t = now
        knob.changes += 1
        knob.value = target
        return [{"knob": knob.name, "from": cur, "to": target,
                 "reason": reason}]

    def _decide_b(self, sig: Dict[str, object], now: float
                  ) -> List[Dict[str, object]]:
        """Cohort size from observed straggler spread: each worker whose
        push inter-arrival EWMA exceeds ``straggler_factor`` x the peer
        median (or whom the observer flags) stops being waited for --
        the wave threshold drops by one per straggler, clamped to the
        declared bounds, and recovers to the configured b when the
        spread closes."""
        ws: Dict[str, dict] = sig.get("workers") or {}
        ivs = {w: st.get("interval_ms") for w, st in ws.items()
               if st.get("interval_ms") is not None
               and st.get("accepted", 0) >= 3}
        flagged = set()
        # peer median EXCLUDING self (the observer's straggler stance):
        # a 2-worker cohort can still flag a 10x member, and one slow
        # worker cannot drag the whole cohort's median up to itself
        for w, iv in ivs.items():
            peers = [v for p, v in ivs.items() if p != w]
            med = self._median(peers)
            if med and med > 0 and iv / med >= self.straggler_factor:
                flagged.add(w)
        for w, s in (sig.get("stragglers") or {}).items():
            if s.get("flagged"):
                flagged.add(str(w))
        for w in sig.get("suspects") or ():
            flagged.add(str(w))
        p = max(1, int(self.cfg.num_workers))
        lo_f, hi_f = self._bounds["async.bucket.ratio"]
        lo = max(1.0, math.ceil(lo_f * p))
        hi = float(min(self.b_conf, max(1, math.floor(hi_f * p))))
        target = float(self.b_conf - len(flagged))
        reason = (f"{len(flagged)} straggler(s) {sorted(flagged)} "
                  f"excluded from the wave"
                  if flagged else "no straggler spread; restore conf b")
        return self._actuate("async.bucket.ratio", self._knobs["b"],
                             target, now, reason, lo, hi, band=1.0)

    def _decide_depth(self, sig: Dict[str, object], now: float
                      ) -> List[Dict[str, object]]:
        """Pipeline depth from measured RTT vs compute: the window must
        hold ~1 + rtt/compute in-flight updates to hide the round trips;
        the prefetch stall counters nudge the formula when reality
        disagrees (stalls = window too shallow)."""
        if self.depth_conf <= 0:
            return []  # serial loops: the shape was chosen at start
        ws: Dict[str, dict] = sig.get("workers") or {}
        rtts = [st["rtt_ms"] for st in ws.values()
                if st.get("rtt_ms") is not None]
        comps = [st["compute_ms"] for st in ws.values()
                 if st.get("compute_ms") is not None]
        rtt, comp = self._median(rtts), self._median(comps)
        if rtt is None or comp is None:
            return []  # no latency decomposition yet: keep the conf
        target = 1.0 + rtt / max(comp, 0.1)
        pl = sig.get("pipeline") or {}
        hits = int(pl.get("prefetch_hits", 0))
        waits = int(pl.get("prefetch_waits", 0))
        if hits + waits >= 16 and waits / (hits + waits) > 0.25:
            target += 1.0  # the prefetch keeps stalling: go deeper
        target = float(round(target))
        lo, hi = self._bounds["async.pipeline.depth"]
        hi = min(hi, float(self.depth_conf))
        return self._actuate(
            "async.pipeline.depth", self._knobs["depth"], target, now,
            f"rtt~{rtt:.1f}ms vs compute~{comp:.1f}ms "
            f"(stalls {waits}/{hits + waits})", lo, hi)

    def _decide_merge(self, sig: Dict[str, object], now: float
                      ) -> List[Dict[str, object]]:
        """Push-merge budget from merge-queue pressure: a backlog that
        keeps pace with the budget means the apply plane is the
        bottleneck -- widen the fused drain (fewer dispatches per
        push); an empty queue shrinks it back toward the single-push
        latency path.  EWMA-smoothed so one burst does not actuate."""
        ps_sig = sig.get("ps") or {}
        q = float(ps_sig.get("queue_depth", 0) or 0)
        a = 0.3
        self._queue_ewma = (q if self._queue_ewma is None
                            else a * q + (1 - a) * self._queue_ewma)
        qe = self._queue_ewma
        cur = self._knobs["merge"].value
        if qe >= 0.75 * cur:
            target = cur * 2.0
        elif qe <= 0.125 * cur:
            target = max(qe * 2.0, cur / 2.0)
        else:
            target = cur
        target = float(round(target))
        lo, hi = self._bounds["async.push.merge"]
        hi = min(hi, float(self.merge_conf))
        return self._actuate(
            "async.push.merge", self._knobs["merge"], target, now,
            f"merge queue ewma {qe:.2f} vs budget {cur:g}", lo, hi)

    def _decide_wdamp(self, sig: Dict[str, object], now: float
                      ) -> List[Dict[str, object]]:
        """Per-worker damp table from observer straggler scores: a
        flagged worker's pushes get an EXTRA bounded damp factor
        (1/score, floored at the step tunable's floor) on top of the
        per-item staleness law -- the observer sees dimensions the PS
        drain cannot (cross-role RTT, compute skew).  Cleared when the
        flag clears."""
        table: Dict[int, float] = {}
        for w, s in (sig.get("stragglers") or {}).items():
            score = s.get("score")
            if s.get("flagged") and score:
                try:
                    wid = int(w)
                except (TypeError, ValueError):
                    continue
                table[wid] = round(
                    max(self.damp_floor, 1.0 / float(score)), 4)
        if table == self._wdamp:
            return []
        # the table change rides the SAME guard machinery as the scalar
        # knobs (module contract: every decision is guarded) -- a score
        # hovering at the flag threshold must not emit a decision, a
        # group fan-out, and a CTRL re-delivery per tick
        knob = self._knobs["wdamp"]
        now_ = now
        if knob.frozen(now_):
            return []
        if (knob.last_change_t is not None
                and now_ - knob.last_change_t < self.cooldown_s):
            return []
        if set(table) == set(self._wdamp) and all(
                abs(table[w] - self._wdamp[w])
                <= self.hysteresis * max(self._wdamp[w], 1e-6)
                for w in table):
            return []  # same flagged set, factors within the dead-band
        direction = (1 if len(table) > len(self._wdamp)
                     else -1 if len(table) < len(self._wdamp)
                     else knob.last_dir or 1)
        if knob.last_dir and direction != knob.last_dir:
            knob.reversals = [t for t in knob.reversals
                              if now_ - t <= self.osc_freeze_s]
            knob.reversals.append(now_)
            if len(knob.reversals) >= self.osc_reversals:
                # the flag set is flapping (add/remove/add...): freeze
                # the table at its current value, exactly like a
                # flapping scalar knob
                knob.frozen_until = now_ + self.osc_freeze_s
                _bump("osc_trips")
                _flight.note("control", knob="wdamp", frozen=True,
                             reason="oscillation guard")
                return []
        knob.last_dir = direction
        knob.last_change_t = now_
        knob.changes += 1
        knob.value = float(len(table))
        prev, self._wdamp = self._wdamp, table
        _bump("wdamp_set")
        # the wdamp table rides the damp tunable's actuation surface
        # (it scales the same effective step the tau law scales)
        _bump("decisions")
        return [{"knob": "wdamp", "from": prev, "to": dict(table),
                 "reason": "observer straggler flags -> per-worker damp"}]

    # -------------------------------------------------------- actuation
    def ctrl_wire(self) -> dict:
        """The CTRL payload (JSON-able) the PS serves on WELCOME/PULL
        and the group SETMAPs to every member: monotone (ep, seq) stamp
        + the four knob decisions.  ``b``/``depth``/``merge`` of 0 mean
        "no override" (receivers keep their configured value)."""
        with self._lock:
            b = int(self._knobs["b"].value)
            depth = int(self._knobs["depth"].value)
            merge = int(self._knobs["merge"].value)
            wire = {
                "seq": self._seq,
                "ep": int(getattr(self.ps, "epoch", 0) or 0),
                # the per-item damping law: [coeff, floor, free_slack]
                "damp": [1.0, self.damp_floor, self.damp_free],
                "b": b if b != self.b_conf else 0,
                "depth": depth if depth != self.depth_conf else 0,
                "merge": merge if merge != self.merge_conf else 0,
            }
            if self._wdamp:
                wire["wdamp"] = {str(w): f
                                 for w, f in self._wdamp.items()}
            return wire

    def _install(self, reason: str) -> None:
        with self._lock:
            self._seq += 1
        wire = self.ctrl_wire()
        self.ps.set_control(wire)
        if self.group is not None:
            try:
                self.group.install_ctrl(wire)
            except Exception:  # noqa: BLE001 -- a dark member heals
                pass           # via the next SETMAP re-announce
        _flight.note("control", seq=wire["seq"], reason=reason)

    # ------------------------------------------------------- observability
    def _telemetry_source(self) -> Dict[str, float]:
        """Flat ``control.*`` gauges next to the counter family: the
        knob CURRENT values and guard state the dashboards and the
        convergence SLO read."""
        with self._lock:
            now = self._now()
            out = {
                "b": self._knobs["b"].value,
                "depth": self._knobs["depth"].value,
                "merge": self._knobs["merge"].value,
                "damp_floor": self.damp_floor,
                "damp_free": self.damp_free,
                "wdamp_workers": float(len(self._wdamp)),
                "seq": float(self._seq),
                "frozen": float(sum(
                    1 for k in self._knobs.values()
                    if k.frozen_until is not None
                    and now < k.frozen_until)),
            }
        return out

    def decision_log(self) -> List[Dict[str, object]]:
        """Every committed knob change this run (bounded at 256): the
        decision trace a run's report records."""
        with self._lock:
            return [dict(d) for d in self._decisions]

    def status(self) -> Dict[str, object]:
        """The ``control`` /api/status section (``metrics/top.py`` and the observer
        render it): current knob values vs configured, the last
        decision and its reason, and the oscillation-guard state."""
        with self._lock:
            now = self._now()
            configured = {"b": self.b_conf, "depth": self.depth_conf,
                          "merge": self.merge_conf, "wdamp": 0}
            knobs = {
                n: {
                    "value": k.value,
                    "configured": configured[n],
                    "changes": k.changes,
                    "frozen": bool(k.frozen_until is not None
                                   and now < k.frozen_until),
                }
                for n, k in self._knobs.items()
            }
            return {
                "enabled": True,
                "seq": self._seq,
                "knobs": knobs,
                "damp": {"floor": self.damp_floor,
                         "free": self.damp_free,
                         "wdamp": {str(w): f
                                   for w, f in self._wdamp.items()}},
                "last_decision": dict(self._last_decision)
                if self._last_decision else None,
                "totals": control_totals(),
            }

"""``async-top``: a terminal dashboard over ``/api/status``.

The live UI's HTML page needs a browser; this is the ssh-session view —
poll any process's status endpoint (driver dashboard, PS, worker,
serving replica/frontend, master — anything `metrics/live.py` serves)
and render throughput, per-stage latencies, the convergence curve and
its slope, serving QPS/freshness, and the SLO health board in place,
top(1)-style.

Usage::

    python -m asyncframework_tpu_torch.metrics.top http://HOST:PORT \
        [--interval 1.0] [--once] [--plain]

``--once`` renders a single frame and exits (what the tests drive);
``--plain`` skips the ANSI clear (pipe-friendly).  Rendering is PURE
(:func:`render_status`: status dict -> text), so tests feed it captured
snapshots without a server.

A copy of the JAX package's ``metrics/top.py``: it renders either
package's ``/api/status``.
"""

from __future__ import annotations

import json
import math
import sys
import time
import urllib.request
from typing import Dict, List, Optional

#: SLO state -> (glyph, ANSI color) for the health board
_STATE_GLYPH = {
    "ok": ("ok", "32"),        # green
    "pending": ("..", "33"),   # yellow
    "firing": ("!!", "31"),    # red
    "no_data": ("--", "90"),   # dim
}

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 48) -> str:
    """Downsample ``values`` to ``width`` block-character cells (the
    loss-curve-in-a-terminal view).  Degenerate spans render flat."""
    vals = [float(v) for v in values if v is not None
            and math.isfinite(float(v))]
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / span * (len(_SPARK) - 1)))]
        for v in vals
    )


def _fmt(v, nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != v:  # NaN
            return "nan"
        return f"{v:.{nd}f}" if abs(v) < 1e6 else f"{v:.3g}"
    return str(v)


def _color(text: str, code: str, plain: bool) -> str:
    return text if plain else f"\x1b[{code}m{text}\x1b[0m"


def render_status(status: Dict, plain: bool = True) -> str:
    """One dashboard frame from an ``/api/status`` body (pure)."""
    lines: List[str] = []
    role = status.get("role", "driver")
    head = [f"async-top  role={role}"]
    if status.get("run_id"):
        head.append(f"run={status['run_id']}")
    if status.get("elapsed_s") is not None:
        head.append(f"up={_fmt(status['elapsed_s'])}s")
    if status.get("updates_per_sec") is not None:
        head.append(f"{_fmt(status['updates_per_sec'])} upd/s")
    if status.get("accepted") is not None:
        head.append(f"acc={status['accepted']} drop="
                    f"{status.get('dropped', 0)}")
    if status.get("model_version") is not None:
        head.append(f"v={status['model_version']}")
    lines.append("  ".join(head))

    # ---- health board (the reason to look at this screen at 3am)
    health = status.get("health") or {}
    rules = health.get("rules") or {}
    if rules:
        overall = health.get("state", "ok")
        glyph, code = _STATE_GLYPH.get(overall, ("??", "0"))
        lines.append("")
        lines.append("SLO health: "
                     + _color(f"{overall.upper()} [{glyph}]", code, plain))
        for name in sorted(rules):
            r = rules[name]
            glyph, code = _STATE_GLYPH.get(r.get("state"), ("??", "0"))
            detail = (f"{r.get('agg')}({r.get('series')}) {r.get('op')} "
                      f"{_fmt(r.get('threshold'))}")
            val = _fmt(r.get("value"), 2)
            burn = (f" burn={_fmt(r.get('burn_s'))}s"
                    if r.get("burn_s") else "")
            fired = (f" fired×{r['fired']}" if r.get("fired") else "")
            lines.append(
                f"  {_color(glyph, code, plain)} {name:<18} {detail:<44} "
                f"value={val}{burn}{fired}"
            )

    # ---- convergence curve + slope
    conv = status.get("convergence") or {}
    curves = conv.get("curves") or {}
    lw = curves.get("loss_vs_wallclock") or []
    if lw or conv.get("samples"):
        lines.append("")
        slope = conv.get("slope_per_s")
        if slope is None:
            trend = "?"
        elif slope < 0:
            trend = "converging"
        elif slope > 0:
            trend = "diverging"  # the 3am trend this line exists for
        else:
            trend = "plateaued"
        lines.append(
            f"convergence: loss={_fmt(conv.get('last_loss'), 6)} "
            f"best={_fmt(conv.get('best_loss'), 6)} "
            f"slope={_fmt(slope, 6)}/s ({trend}) "
            f"samples={conv.get('samples', 0)}"
        )
        if lw:
            lines.append("  loss " + sparkline([p[1] for p in lw]))

    # ---- per-stage latency decomposition (trace section)
    trace = status.get("trace") or {}
    stages = trace.get("stages_ms") or {}
    shown = [(s, d) for s, d in sorted(stages.items()) if d.get("count")]
    if shown:
        lines.append("")
        lines.append(f"{'stage':<14}{'p50 ms':>10}{'p95 ms':>10}"
                     f"{'p99 ms':>10}{'count':>9}")
        for stage, d in shown:
            lines.append(
                f"{stage:<14}{_fmt(d.get('p50'), 2):>10}"
                f"{_fmt(d.get('p95'), 2):>10}{_fmt(d.get('p99'), 2):>10}"
                f"{d.get('count', 0):>9}"
            )
        sm = trace.get("staleness_ms") or {}
        if sm.get("count"):
            lines.append(f"staleness: p95={_fmt(sm.get('p95'))}ms "
                         f"max={_fmt(sm.get('max'))}ms")

    # ---- serving plane
    serving = status.get("serving") or {}
    detail = serving.get("detail") or serving  # driver vs bare process
    if detail.get("qps") or detail.get("predicts"):
        pm = detail.get("predict_ms") or {}
        lines.append("")
        lines.append(
            f"serving: qps={_fmt(detail.get('qps'))} "
            f"predict p50={_fmt(pm.get('p50'), 2)}ms "
            f"p99={_fmt(pm.get('p99'), 2)}ms "
            f"freshness={_fmt(detail.get('freshness_lag_ms'))}ms "
            f"failovers={detail.get('failovers', 0)}"
        )

    # ---- continuous profiling plane (compact zone-share row)
    prof = status.get("profile") or {}
    if prof.get("zones"):
        lines.append("")
        lines.append(render_profile_row(prof))

    # ---- native data plane (codec dispatches + shm transport)
    native = status.get("native") or {}
    if native:
        nc = sum(int(v) for k, v in native.items()
                 if k.startswith("native_calls."))
        pc = sum(int(v) for k, v in native.items()
                 if k.startswith("python_calls."))
        row = (f"native: calls={nc} python={pc} "
               f"fallbacks={native.get('python_fallbacks', 0)}")
        if native.get("shm_upgrades") or native.get("shm_upgrade_refused"):
            row += (f"  shm: up={native.get('shm_upgrades', 0)} "
                    f"refused={native.get('shm_upgrade_refused', 0)} "
                    f"degraded={native.get('shm_degrades', 0)} "
                    f"tx={_fmt(native.get('shm_bytes_sent', 0) / 1e6, 2)}MB "
                    f"rx={_fmt(native.get('shm_bytes_recv', 0) / 1e6, 2)}MB")
        lines.append("")
        lines.append(row)

    # ---- adaptive control plane
    control = status.get("control") or {}
    if control.get("knobs"):
        lines.append("")
        lines.append(render_control(control, plain=plain).rstrip("\n"))

    ts = status.get("timeseries") or {}
    if ts.get("series"):
        lines.append("")
        lines.append(f"timeseries: {ts['series']} series, "
                     f"{ts.get('samples', 0)} samples "
                     f"({ts.get('evicted', 0)} evicted)")
    return "\n".join(lines) + "\n"


def render_profile_row(section: Dict) -> str:
    """One compact zone-share line from a ``profile`` /api/status
    section (or the observer's per-role compact block): the top sampled
    zones by share, plus compile/dispatch accounting when present.
    Shared by async-top's per-role view and async-mon's fleet table."""
    zones = section.get("zones") or {}
    shares = []
    for z, d in zones.items():
        # a full snapshot carries {"share": ...} dicts; the observer's
        # compact per-role block carries bare share floats
        try:
            s = float(d.get("share", 0.0)) if isinstance(d, dict) \
                else float(d)
        except (TypeError, ValueError):
            continue
        if s > 0:
            shares.append((z, s))
    shares.sort(key=lambda kv: -kv[1])
    parts = [f"{z} {s * 100:.0f}%" for z, s in shares[:5]]
    head = (f"profile: samples={section.get('samples', 0)} "
            + ("  ".join(parts) if parts else "(no sampled zones)"))
    comp = section.get("compile") or {}
    if comp.get("count"):
        head += (f"  compile={comp['count']}"
                 f"/{float(comp.get('ns', 0)) / 1e6:.0f}ms")
    return head


def render_control(section: Dict, plain: bool = True) -> str:
    """The adaptive-control board from a ``control`` /api/status section
    (pure, like :func:`render_status`): current knob values vs their
    configured baselines, the last decision and its reason, and the
    oscillation-guard state.  Shared by async-top's per-role view and
    async-mon's fleet view."""
    lines: List[str] = []
    totals = section.get("totals") or {}
    head = (f"control: seq={section.get('seq', 0)} "
            f"changes={totals.get('changes', 0)} "
            f"clamps={totals.get('clamps', 0)} "
            f"osc_trips={totals.get('osc_trips', 0)}")
    if section.get("role"):
        head += f" via={section['role']}"
    lines.append(head)
    knobs = section.get("knobs") or {}
    if knobs:
        lines.append(f"  {'knob':<8}{'value':>8}{'conf':>8}"
                     f"{'changes':>9}  guard")
        for name in sorted(knobs):
            k = knobs[name]
            frozen = bool(k.get("frozen"))
            guard = (_color("FROZEN", "31", plain) if frozen else "ok")
            lines.append(
                f"  {name:<8}{_fmt(k.get('value'), 0):>8}"
                f"{_fmt(k.get('configured'), 0):>8}"
                f"{k.get('changes', 0):>9}  {guard}"
            )
    damp = section.get("damp") or {}
    if damp:
        wdamp = damp.get("wdamp") or {}
        extra = ("  wdamp " + " ".join(
            f"w{w}={_fmt(f, 2)}" for w, f in sorted(wdamp.items()))
            if wdamp else "")
        lines.append(f"  damp: floor={_fmt(damp.get('floor'), 2)} "
                     f"free={_fmt(damp.get('free'), 1)}{extra}")
    last = section.get("last_decision")
    if last:
        lines.append(
            f"  last: {last.get('knob')} "
            f"{_fmt(last.get('from'), 0)} -> {_fmt(last.get('to'), 0)} "
            f"({last.get('reason')}) at t={_fmt(last.get('t'))}s")
    return "\n".join(lines) + "\n"


def render_fleet(observer_section: Dict, plain: bool = True) -> str:
    """One fleet-dashboard frame from a collector's ``observer``
    /api/status section (pure, like :func:`render_status`): every
    discovered role's liveness + key numbers, the derived cross-role
    signals, and the straggler board."""
    lines: List[str] = []
    roles = observer_section.get("roles") or {}
    derived = observer_section.get("derived") or {}
    up = int(derived.get("roles_up", sum(
        1 for r in roles.values() if r.get("up"))))
    lines.append(f"async-mon  fleet view  roles={len(roles)} up={up}")

    if roles:
        lines.append("")
        lines.append(f"{'role':<22}{'kind':<10}{'up':<4}{'health':<9}"
                     f"{'accepted':>10}{'stale':>7}{'qps':>8}{'lag ms':>8}")
        for name in sorted(roles):
            r = roles[name]
            glyph, code = (("up", "32") if r.get("up")
                           else ("DOWN", "31"))
            lines.append(
                f"{name:<22}{str(r.get('role') or '-'):<10}"
                f"{_color(glyph, code, plain):<4} "
                f"{str(r.get('health') or '-'):<8}"
                f"{_fmt(r.get('accepted'), 0):>10}"
                f"{_fmt(r.get('staleness'), 0):>7}"
                f"{_fmt(r.get('qps')):>8}"
                f"{_fmt(r.get('freshness_lag_ms'), 0):>8}"
            )
            # compact zone-share row under profiling-enabled roles
            prof = r.get("profile") or {}
            if prof.get("zones"):
                lines.append("  " + render_profile_row(prof))

    if derived:
        lines.append("")
        lines.append(
            "derived: "
            f"push_rate={_fmt(derived.get('push_rate'))}/s "
            f"merge_q={_fmt(derived.get('merge_queue_depth'), 0)} "
            f"fleet_lag={_fmt(derived.get('freshness_lag_ms'), 0)}ms "
            f"straggler_max={_fmt(derived.get('straggler_score'), 2)} "
            f"done={int(derived.get('fleet_done', 0))}"
        )

    stragglers = observer_section.get("stragglers") or {}
    shown = [(w, s) for w, s in sorted(stragglers.items())
             if s.get("score") is not None]
    if shown:
        factor = observer_section.get("straggler_factor")
        lines.append("")
        lines.append(f"stragglers (score = worker/median, flag at "
                     f">={_fmt(factor)}):")
        for wid, s in shown:
            mark = (_color("<<", "31", plain) if s.get("flagged")
                    else "  ")
            dims = " ".join(f"{d}={_fmt(r, 2)}"
                            for d, r in sorted(
                                (s.get("dims") or {}).items()))
            lines.append(f"  w{wid:<4} score={_fmt(s['score'], 2):<7} "
                         f"{mark} {dims}")

    control = observer_section.get("control") or {}
    if control.get("knobs"):
        lines.append("")
        lines.append(render_control(control, plain=plain).rstrip("\n"))

    hist = observer_section.get("history") or {}
    if hist:
        nd = len(hist.get("flight_dumps") or [])
        np_ = len(hist.get("profile_snapshots") or [])
        lines.append("")
        lines.append(
            f"history: run={hist.get('run_id')} "
            f"roles={len(hist.get('roles') or {})} "
            f"flight_dumps={nd} "
            f"profiles={np_} "
            f"dir={hist.get('run_dir') or '(memory)'}"
        )
    return "\n".join(lines) + "\n"


def fetch_status(url: str, timeout_s: float = 5.0) -> Dict:
    if not url.startswith("http"):
        url = "http://" + url
    if not url.rstrip("/").endswith("/api/status"):
        url = url.rstrip("/") + "/api/status"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        "async-top", description="terminal dashboard over /api/status"
    )
    p.add_argument("url", nargs="?", default=None,
                   help="http://HOST:PORT (or HOST:PORT) of any "
                        "process serving /api/status")
    p.add_argument("--observer", default=None, metavar="ENDPOINT",
                   help="render the FLEET view from a cluster "
                        "observer's /api/status (async-mon): every "
                        "worker/shard/replica in one dashboard instead "
                        "of polling a single role")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    p.add_argument("--plain", action="store_true",
                   help="no ANSI colors / screen clears (pipe-friendly)")
    args = p.parse_args(argv)
    url = args.observer if args.observer is not None else args.url
    if url is None:
        p.error("need a URL (or --observer ENDPOINT)")
    while True:
        try:
            status = fetch_status(url)
            if args.observer is not None:
                section = status.get("observer")
                if not isinstance(section, dict):
                    frame = (f"async-top: {url} serves no 'observer' "
                             f"section (not an async-mon collector?)\n")
                else:
                    frame = render_fleet(section, plain=args.plain)
            else:
                frame = render_status(status, plain=args.plain)
        except (OSError, ValueError) as e:
            frame = f"async-top: {url} unreachable ({e})\n"
        if not args.plain:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(frame)
        sys.stdout.flush()
        if args.once:
            return 0
        try:
            time.sleep(max(0.1, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())

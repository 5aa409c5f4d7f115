"""Static HTML report rendered from an event log.

Parity: the reference's web UI + history server (``core/.../ui/`` 6.3k LoC of
jetty pages over ``AppStatusStore``, ``deploy/history/FsHistoryProvider``)
exist to answer "what did this run do" after the fact.  The port keeps
the capability but not the server: one self-contained HTML file generated
from the JSONL event log (``metrics/eventlog.py``), viewable anywhere,
zero running processes.  Inline SVG charts -- no JS dependencies, nothing to
install on a GPU host.
"""

from __future__ import annotations

import html
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from asyncframework_tpu_torch.metrics.bus import (
    GradientMerged,
    JobEnd,
    JobStart,
    ModelSnapshot,
    RoundSubmitted,
    TaskEnd,
    WorkerLost,
)
from asyncframework_tpu_torch.metrics.eventlog import EventLogReader


def _svg_line(points: List[Tuple[float, float]], width=640, height=200,
              label="") -> str:
    """Minimal inline-SVG line chart with axis annotations."""
    if len(points) < 2:
        return "<p><em>not enough data</em></p>"
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    pad = 30
    w, h = width - 2 * pad, height - 2 * pad

    def sx(x):
        return pad + (x - x0) / xr * w

    def sy(y):
        return pad + h - (y - y0) / yr * h

    path = " ".join(
        f"{'M' if i == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
        for i, (x, y) in enumerate(points)
    )
    return (
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" role="img">'
        f'<rect width="100%" height="100%" fill="#fafafa"/>'
        f'<path d="{path}" fill="none" stroke="#2563eb" stroke-width="1.5"/>'
        f'<text x="{pad}" y="14" font-size="11">{html.escape(label)}</text>'
        f'<text x="{pad}" y="{height - 6}" font-size="10">{x0:.4g}</text>'
        f'<text x="{width - pad}" y="{height - 6}" font-size="10" '
        f'text-anchor="end">{x1:.4g}</text>'
        f'<text x="4" y="{pad + 8}" font-size="10">{y1:.4g}</text>'
        f'<text x="4" y="{height - pad}" font-size="10">{y0:.4g}</text>'
        f"</svg>"
    )


def _table(headers: List[str], rows: List[List[object]]) -> str:
    head = "".join(f"<th>{html.escape(str(hd))}</th>" for hd in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in row) + "</tr>"
        for row in rows
    )
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


def render_report(
    event_log_path: Union[str, Path],
    out_path: Optional[Union[str, Path]] = None,
    title: str = "asyncframework-tpu run report",
    events: Optional[list] = None,
) -> str:
    """Build the HTML report; optionally write it to ``out_path``.

    Sections: run summary, objective-vs-iteration curve, staleness
    histogram, per-worker task table, failures.  ``events`` (pre-replayed)
    skips re-reading the log -- the history index scans once and reuses
    the same pass here.
    """
    reader = EventLogReader(event_log_path)
    merges: List[GradientMerged] = []
    snaps: List[ModelSnapshot] = []
    tasks: List[TaskEnd] = []
    lost: List[WorkerLost] = []
    jobs = 0
    job_fail = 0
    rounds = 0
    for ev in (events if events is not None else reader.replay()):
        if isinstance(ev, GradientMerged):
            merges.append(ev)
        elif isinstance(ev, ModelSnapshot):
            snaps.append(ev)
        elif isinstance(ev, TaskEnd):
            tasks.append(ev)
        elif isinstance(ev, WorkerLost):
            lost.append(ev)
        elif isinstance(ev, JobStart):
            jobs += 1
        elif isinstance(ev, JobEnd):
            job_fail += 0 if ev.succeeded else 1
        elif isinstance(ev, RoundSubmitted):
            rounds += 1

    accepted = sum(1 for m in merges if m.accepted)
    dropped = len(merges) - accepted
    max_stale = max((m.staleness for m in merges), default=0)

    per_worker: Dict[int, List[TaskEnd]] = defaultdict(list)
    for t in tasks:
        per_worker[t.worker_id].append(t)
    worker_rows = []
    for wid in sorted(per_worker):
        ts = per_worker[wid]
        ok = [t for t in ts if t.succeeded]
        avg = sum(t.run_ms for t in ok) / len(ok) if ok else 0.0
        worker_rows.append(
            [wid, len(ts), len(ts) - len(ok), f"{avg:.1f}"]
        )

    # staleness histogram as a bar-ish line chart over sorted counts
    stale_counts: Dict[int, int] = defaultdict(int)
    for m in merges:
        stale_counts[m.staleness] += 1
    stale_points = [(float(k), float(v)) for k, v in sorted(stale_counts.items())]

    obj_points = [(float(s.iteration), float(s.objective)) for s in snaps]

    summary_rows = [
        ["jobs", jobs],
        ["rounds submitted", rounds],
        ["gradients merged", len(merges)],
        ["accepted / dropped", f"{accepted} / {dropped}"],
        ["max staleness", max_stale],
        ["failed jobs", job_fail],
        ["workers lost", len(lost)],
    ]
    # raw strings here: _table escapes every cell exactly once
    failure_rows = [[l.worker_id, l.reason] for l in lost] + [
        [t.worker_id, t.error or ""] for t in tasks if not t.succeeded
    ]

    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        "<style>body{font:14px system-ui;margin:2em;max-width:72em}"
        "table{border-collapse:collapse;margin:1em 0}"
        "td,th{border:1px solid #ddd;padding:4px 10px;text-align:right}"
        "th{background:#f3f4f6}h2{margin-top:1.6em}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        "<h2>Summary</h2>",
        _table(["metric", "value"], summary_rows),
        "<h2>Objective vs iteration</h2>",
        _svg_line(obj_points, label="objective"),
        "<h2>Staleness distribution</h2>",
        _svg_line(stale_points, label="merge count by staleness"),
        "<h2>Workers</h2>",
        _table(["worker", "tasks", "failures", "avg run ms"], worker_rows),
    ]
    if failure_rows:
        parts += ["<h2>Failures</h2>",
                  _table(["worker", "error"], failure_rows)]
    parts.append("</body></html>")
    doc = "".join(parts)
    if out_path is not None:
        Path(out_path).write_text(doc, encoding="utf-8")
    return doc

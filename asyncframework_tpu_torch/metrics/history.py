"""History server: render every event log in a directory to browsable HTML.

Parity: ``deploy/history/FsHistoryProvider.scala`` -- the reference's
history server watches a log directory and serves past applications' UIs.
The TPU build keeps the capability without the daemon: one command scans
the directory, renders a per-run report (``metrics/report.py``) for every
JSONL(.gz) event log, and writes an ``index.html`` linking them with
summary rows -- a static history "server" viewable from any file browser.

CLI: ``python -m asyncframework_tpu_torch.metrics.history <log_dir>
[out_dir]`` (defaults ``out_dir = <log_dir>/history``).

A copy of the JAX package's ``metrics/history.py``: it indexes event
logs and observer run directories written by either package.
"""

from __future__ import annotations

import html
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple, Union

from asyncframework_tpu_torch.metrics.bus import GradientMerged, JobStart
from asyncframework_tpu_torch.metrics.eventlog import EventLogReader
from asyncframework_tpu_torch.metrics.report import render_report

_LOG_SUFFIXES = (".jsonl", ".jsonl.gz")


def _is_event_log(p: Path) -> bool:
    name = p.name
    return any(name.endswith(sfx) for sfx in _LOG_SUFFIXES)


def _scan(path: Path):
    """ONE tolerant replay: (events, merges, jobs, truncated) -- the same
    pass feeds both the index row and the report render.  A torn record
    (crash mid-write) is skipped and counted (``strict=False``); only a
    file that yields nothing readable at all is flagged unreadable."""
    events = []
    merges = jobs = 0
    reader = EventLogReader(path)
    try:
        for ev in reader.replay(strict=False):
            events.append(ev)
            if isinstance(ev, GradientMerged):
                merges += 1
            elif isinstance(ev, JobStart):
                jobs += 1
    except Exception:
        return None, -1, -1, 0  # foreign/binary file: listed, unreadable
    if not events:
        return None, -1, -1, reader.truncated_records
    return events, merges, jobs, reader.truncated_records


def build_history(
    log_dir: Union[str, Path],
    out_dir: Optional[Union[str, Path]] = None,
) -> Path:
    """Render all event logs under ``log_dir``; returns the index path."""
    log_dir = Path(log_dir)
    if not log_dir.is_dir():
        raise ValueError(f"{log_dir} is not a directory")
    out_dir = Path(out_dir) if out_dir is not None else log_dir / "history"
    out_dir.mkdir(parents=True, exist_ok=True)

    logs = sorted(
        (p for p in log_dir.iterdir() if _is_event_log(p)),
        key=lambda p: p.stat().st_mtime,
        reverse=True,
    )
    rows: List[str] = []
    for p in logs:
        stem = p.name
        for sfx in _LOG_SUFFIXES:
            if stem.endswith(sfx):
                stem = stem[: -len(sfx)]
                break
        # report name from the FULL filename: "run.jsonl" and
        # "run.jsonl.gz" must not collide, and "index.jsonl" must not
        # render onto the index itself
        report_name = f"{p.name}.html"
        events, merges, jobs, truncated = _scan(p)
        if events is not None:
            try:
                render_report(
                    p, out_dir / report_name, title=f"run: {stem}",
                    events=events,
                )
            except Exception:
                # schema-drifted field VALUES can pass replay but break
                # the render; one bad log must not abort the whole index
                events = None
        if events is not None:
            link = f'<a href="{html.escape(report_name)}">{html.escape(stem)}</a>'
            status = f"{merges} updates, {jobs} jobs"
            if truncated:
                # crash-mid-write forensics: the run died with a torn tail
                status += f", {truncated} truncated record(s) skipped"
        else:
            link = html.escape(stem)
            status = "unreadable"
        mtime = time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(p.stat().st_mtime)
        )
        rows.append(
            f"<tr><td>{link}</td><td>{mtime}</td><td>{status}</td></tr>"
        )

    observer_rows = _observer_rows(log_dir)
    observer_html = ""
    if observer_rows:
        observer_html = (
            "<h1>Observer run history "
            f"({len(observer_rows)} runs)</h1>"
            "<table><thead><tr><th>run</th><th>roles</th>"
            "<th>flight dumps</th><th>profiles</th>"
            "<th>persisted</th></tr></thead>"
            "<tbody>" + "".join(observer_rows) + "</tbody></table>"
        )
    index = out_dir / "index.html"
    index.write_text(
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>asyncframework-tpu history</title>"
        "<style>body{font-family:sans-serif;margin:2em}"
        "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
        "padding:4px 10px}</style></head><body>"
        f"<h1>Run history ({len(logs)} logs)</h1>"
        "<table><thead><tr><th>run</th><th>modified</th><th>summary</th>"
        "</tr></thead><tbody>" + "".join(rows) + "</tbody></table>"
        + observer_html
        + "</body></html>"
    )
    return index


def _observer_rows(log_dir: Path) -> List[str]:
    """Index rows for cluster-observer run-history dirs under
    ``log_dir`` (metrics/observer.py RunHistoryStore layout:
    ``run-<id>/meta.json`` + per-role series + harvested flight
    dumps) -- the same directory can hold event logs AND observer
    history; both get indexed."""
    from asyncframework_tpu_torch.metrics import observer as observer_mod

    rows: List[str] = []
    for run_dir in observer_mod.list_runs(str(log_dir)):
        try:
            run = observer_mod.load_run(run_dir)
        except (OSError, ValueError):
            rows.append(
                f"<tr><td>{html.escape(Path(run_dir).name)}</td>"
                f"<td colspan='4'>unreadable</td></tr>"
            )
            continue
        meta = run.get("meta") or {}
        roles = run.get("roles") or {}
        role_bits = ", ".join(
            f"{html.escape(str(n))} ({len((r or {}).get('series') or {})} "
            f"series)"
            for n, r in sorted(roles.items())
        ) or "-"
        persisted = meta.get("persisted_s")
        when = (
            time.strftime("%Y-%m-%d %H:%M:%S",
                          time.localtime(float(persisted)))
            if persisted else "-"
        )
        rows.append(
            f"<tr><td>{html.escape(str(meta.get('run_id', '?')))}</td>"
            f"<td>{role_bits}</td>"
            f"<td>{len(run.get('flight') or {})}</td>"
            f"<td>{_profile_cell(run)}</td>"
            f"<td>{when}</td></tr>"
        )
    return rows


def _profile_cell(run: dict) -> str:
    """Profile-snapshot column: count plus each snapshot's top zone
    (``python -m asyncframework_tpu_torch.metrics.profiler <run_dir>``
    renders the full table)."""
    profile = run.get("profile") or {}
    if not profile:
        return "-"
    bits = []
    for key, snap in sorted(profile.items()):
        zones = (snap or {}).get("zones") or {}
        top = max(zones.items(),
                  key=lambda kv: float((kv[1] or {}).get("share", 0.0)),
                  default=None)
        bits.append(
            html.escape(key)
            + (f" ({html.escape(top[0])})" if top else ""))
    return f"{len(profile)}: " + ", ".join(bits)


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not 1 <= len(argv) <= 2:
        print("usage: async-history <log_dir> [out_dir]", file=sys.stderr)
        return 2
    index = build_history(*argv)
    print(index)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""JSONL event logging and replay (history-server analog).

Parity: ``EventLoggingListener`` (``scheduler/EventLoggingListener.scala:55``)
writes one JSON object per line per event; the history server's
``FsHistoryProvider`` replays the file to rebuild application state.  Here
:class:`EventLogWriter` is a bus listener streaming events to a JSONL file and
:class:`EventLogReader` replays a file back into typed events and summary
statistics (the ``AppStatusStore`` role, trimmed to this framework's event
vocabulary: rounds, merges, staleness distribution, worker health).
"""

from __future__ import annotations

import gzip
import json
import threading
from dataclasses import asdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

from asyncframework_tpu_torch.metrics.bus import EVENT_TYPES, Event, Listener


def _open_log(path: Path, mode: str):
    """``.gz`` paths route through the zlib codec (the reference compresses
    event logs with its native lz4/zstd codecs --
    ``io/CompressionCodec.scala``; CPython's zlib is the native codec here)."""
    if path.suffix == ".gz":
        return gzip.open(path, mode + "t", encoding="utf-8")
    return path.open(mode, buffering=1 if "w" in mode else -1)


class EventLogWriter(Listener):
    """Streams every bus event to a JSONL file (``.gz`` = compressed);
    one line per event."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = _open_log(self.path, "w")
        self._lock = threading.Lock()
        self._closed = False

    def on_event(self, event: Event) -> None:
        rec = {"event": type(event).__name__, **asdict(event)}
        line = json.dumps(rec, separators=(",", ":"), default=_jsonable)
        with self._lock:
            if not self._closed:
                self._f.write(line + "\n")
                # flush per event: the log is a crash-forensics artifact, and
                # the gzip stream would otherwise buffer everything to close()
                self._f.flush()

    # per-type hooks all route to on_event for the writer
    def __getattr__(self, name: str):
        if name.startswith("on_"):
            return self.on_event
        raise AttributeError(name)

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()


def _jsonable(o):
    if isinstance(o, (tuple, set)):
        return list(o)
    return str(o)


class EventLogReader:
    """Replays a JSONL event log into typed events + summary statistics.

    After a replay (or :meth:`summary`), ``truncated_records`` counts the
    torn records that were skipped in tolerant mode -- the kill -9 world's
    crash-mid-write forensics: a writer SIGKILLed between ``write`` and
    ``flush`` leaves a partial final line (or a gzip stream without its end
    marker), and the whole valid prefix must still replay.
    """

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.truncated_records = 0

    def _lines(self, f) -> Iterator[str]:
        """Line iteration tolerating a crash-torn tail: a writer that died
        before close() leaves a gzip stream without its end marker; every
        fully-flushed line before the tear still replays."""
        try:
            yield from f
        except EOFError:
            self.truncated_records += 1
            return

    def replay(self, strict: bool = True) -> Iterator[Event]:
        """Yield events; with ``strict=False`` a torn record (crash
        mid-write) is skipped and counted in ``truncated_records`` instead
        of raising -- the history server's inspect-a-dead-run case."""
        self.truncated_records = 0
        with _open_log(self.path, "r") as f:
            for line in self._lines(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if strict:
                        raise
                    # torn record: skip-and-count; the flush-per-event
                    # writer can only tear the final line, but counting
                    # (rather than stopping) also survives a foreign tool
                    # concatenating logs
                    self.truncated_records += 1
                    continue
                name = rec.pop("event", None)
                cls = EVENT_TYPES.get(name)
                if cls is None:
                    continue  # unknown event type: forward-compat skip
                fields = {
                    k: (tuple(v) if isinstance(v, list) else v)
                    for k, v in rec.items()
                }
                try:
                    yield cls(**fields)
                except TypeError:
                    continue  # schema drift: skip unreadable record

    def summary(self) -> Dict[str, object]:
        """History-server style aggregate view of one run's log."""
        from asyncframework_tpu_torch.metrics.bus import (
            GradientMerged,
            JobEnd,
            ModelSnapshot,
            RoundSubmitted,
            TaskEnd,
            WorkerLost,
        )

        n_rounds = 0
        merges = 0
        accepted = 0
        staleness: List[int] = []
        task_ms: List[float] = []
        failures = 0
        lost: List[int] = []
        trajectory: List[tuple] = []
        for ev in self.replay(strict=False):
            if isinstance(ev, RoundSubmitted):
                n_rounds += 1
            elif isinstance(ev, GradientMerged):
                merges += 1
                accepted += int(ev.accepted)
                staleness.append(ev.staleness)
            elif isinstance(ev, TaskEnd):
                task_ms.append(ev.run_ms)
                failures += int(not ev.succeeded)
            elif isinstance(ev, JobEnd):
                failures += int(not ev.succeeded)
            elif isinstance(ev, WorkerLost):
                lost.append(ev.worker_id)
            elif isinstance(ev, ModelSnapshot):
                trajectory.append((ev.time_ms, ev.objective))
        out: Dict[str, object] = {
            "rounds": n_rounds,
            "merges": merges,
            "accepted": accepted,
            "dropped_stale": merges - accepted,
            "workers_lost": lost,
            "task_failures": failures,
            "trajectory": trajectory,
            # torn records skipped by the tolerant replay (crash mid-write)
            "truncated_records": self.truncated_records,
        }
        if staleness:
            from asyncframework_tpu_torch.metrics.system import Histogram

            s = sorted(staleness)
            out["staleness"] = {
                "max": s[-1],
                "mean": sum(s) / len(s),
                # nearest-rank, same rule as Histogram.snapshot (the old
                # int(q*n) indexing reported max as p95 for small logs)
                "p50": Histogram._pct(s, 0.50),
                "p95": Histogram._pct(s, 0.95),
            }
        if task_ms:
            from asyncframework_tpu_torch.metrics.system import Histogram

            t = sorted(task_ms)
            out["task_ms"] = {
                "mean": sum(t) / len(t),
                "p50": Histogram._pct(t, 0.50),
                "max": t[-1],
            }
        return out

"""Crash flight recorder: a bounded event ring that survives SIGKILL.

Every observability surface this repo built so far dies with its
process: ``/api/status`` stops answering, the time-series store is heap
memory, and a chaos ``kill -9`` leaves nothing but the supervisor's
"member dead" counter.  The flight recorder is the post-mortem path:
each role keeps a bounded in-memory ring of recent events -- data-plane
notes (pushes acked, merge batches drained), membership transitions,
fired fault-schedule events, and per-flush counter deltas -- and writes
it to ``<dir>/flight-<role>-<pid>.json``:

- **on a cadence** (``async.flight.flush.s``): an atomic overwrite via
  ``checkpoint.durable_replace``, so an *uncatchable* SIGKILL leaves a
  dump at most one flush stale;
- **on catchable fatal signals** (SIGTERM/SIGINT, chained to any prior
  handler) and **at interpreter exit** (atexit): a final synchronous
  dump stamped with its reason.

The cluster observer (``metrics/observer.py``) harvests these files
into the durable run-history store, so "worker 3 was SIGKILLed" comes
with the last thing worker 3 did instead of silence.

Cost discipline: recording is one deque append under a short lock;
:func:`note` is a no-op returning immediately when no recorder is
installed (the default -- ``async.flight.dir`` empty), so instrumented
hot paths pay one global read.  Dumps serialize a snapshot taken under
the lock but write the file outside it.

A copy of the JAX package's ``metrics/flightrec.py``: a dump either
package writes is read by the other's :func:`load_dump` and harvested by
either observer.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_lock = threading.Lock()
_recorder: Optional["FlightRecorder"] = None

_totals_lock = threading.Lock()
_totals = {"flushes": 0, "dumps": 0, "dump_errors": 0}


def _bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] += n


def flight_totals() -> Dict[str, int]:
    """Flat meta-counters (registry family ``flight``).  ``notes`` and
    ``dropped`` read the installed recorder's own ring ledgers (the
    ring already counts both exactly) -- the hot-path note() pays ONE
    lock, never a second process-global bump per event."""
    with _totals_lock:
        out = dict(_totals)
    rec = _recorder
    if rec is not None:
        with rec._ring_lock:
            out["notes"] = rec._seq
            out["dropped"] = rec._dropped
    else:
        out["notes"] = out["dropped"] = 0
    return out


def reset_flight_totals() -> None:
    with _totals_lock:
        for k in _totals:
            _totals[k] = 0
    rec = _recorder
    if rec is not None:
        # per-run isolation, same contract as every registry family:
        # the note/drop ledgers restart (the ring contents stay -- a
        # post-mortem must not lose its events to a counter reset)
        with rec._ring_lock:
            rec._seq = 0
            rec._dropped = 0


def recorder() -> Optional["FlightRecorder"]:
    with _lock:
        return _recorder


def note(kind: str, **fields) -> None:
    """Record one event into the installed recorder; no-op when none is
    installed (the common case -- callers need no gating of their own)."""
    rec = _recorder  # racy read by design: a torn install drops one note
    if rec is not None:
        rec.note(kind, **fields)


class FlightRecorder:
    """One process's bounded event ring + its dump/flush machinery."""

    SCHEMA = 1

    def __init__(self, role: str, dump_dir: str, capacity: int = 256,
                 flush_s: float = 0.5):
        self.role = str(role)
        self.dump_dir = str(dump_dir)
        self.capacity = max(8, int(capacity))
        self.flush_s = float(flush_s)
        self._ring_lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        self._seq = 0
        self._dropped = 0
        self._started_s = time.time()
        self._last_counters: Dict[str, Dict[str, float]] = {}
        self._stop = threading.Event()
        self._flush_thread: Optional[threading.Thread] = None
        self._prev_handlers: Dict[int, object] = {}

    # -------------------------------------------------------------- recording
    def note(self, kind: str, **fields) -> None:
        ev = {"t": time.time(), "kind": str(kind)}
        ev.update(fields)
        with self._ring_lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(ev)
            self._seq += 1

    def _counters_delta_event(self) -> None:
        """One per-flush event holding every non-zero counter-family
        delta since the previous flush (the "what moved" view a
        post-mortem reads next to the last data-plane notes)."""
        from asyncframework_tpu_torch.metrics import registry

        delta: Dict[str, float] = {}
        cur: Dict[str, Dict[str, float]] = {}
        for name, fam in registry.families().items():
            if name == "flight":
                continue  # our own meta-counters move on every flush --
                          # including them would make each flush generate
                          # the next flush's "delta" forever
            try:
                tot = fam.totals()
            except Exception:  # noqa: BLE001 - a lean process missing one
                continue       # family must not lose its whole dump
            cur[name] = tot
            prev = self._last_counters.get(name, {})
            for k, v in tot.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                d = v - prev.get(k, 0)
                if d:
                    delta[f"{name}.{k}"] = d
        self._last_counters = cur
        if delta:
            self.note("counters", delta=delta)

    # ----------------------------------------------------------------- dumps
    def dump_path(self) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in self.role)
        return os.path.join(self.dump_dir,
                            f"flight-{safe}-{os.getpid()}.json")

    def snapshot(self, reason: str) -> dict:
        from asyncframework_tpu_torch.metrics.live import RUN_ID

        with self._ring_lock:
            events = list(self._ring)
            seq, dropped = self._seq, self._dropped
        # the profile post-mortem: one fresh snapshot per dump, so even
        # a SIGKILL leaves the zone decomposition at most one flush
        # stale (None while async.prof never ran -- key omitted, old
        # dump shape preserved)
        try:
            from asyncframework_tpu_torch.metrics import profiler as _profiler
            prof = _profiler.last_snapshot()
        except Exception:
            prof = None
        out = {
            "schema": self.SCHEMA,
            "role": self.role,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "run_id": RUN_ID,
            "started_s": self._started_s,
            "dumped_s": time.time(),
            "reason": reason,
            "seq": seq,
            "dropped": dropped,
            "events": events,
            "counters": dict(self._last_counters),
        }
        if prof is not None:
            out["profile"] = prof
        return out

    def dump(self, reason: str = "periodic") -> Optional[str]:
        """Write the ring to disk atomically; returns the path (None on
        error -- a dying process must not die harder over its own
        post-mortem)."""
        from asyncframework_tpu_torch.checkpoint import durable_replace

        snap = self.snapshot(reason)
        path = self.dump_path()
        tmp = path + ".tmp"
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(snap, f, default=str)
            durable_replace(tmp, path)
        except OSError:
            _bump("dump_errors")
            return None
        _bump("dumps")
        return path

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "FlightRecorder":
        if self.flush_s > 0:
            def loop() -> None:
                while not self._stop.wait(timeout=self.flush_s):
                    self._counters_delta_event()
                    self.dump("periodic")
                    _bump("flushes")

            self._flush_thread = threading.Thread(
                target=loop, name="flight-flush", daemon=True
            )
            self._flush_thread.start()
        self._install_signal_hooks()
        import atexit

        atexit.register(self._atexit_dump)
        return self

    def _install_signal_hooks(self) -> None:
        """Final dump on catchable fatal signals, chained to whatever
        handler was installed before (a shard child's SIGTERM event,
        the default exit).  Best-effort: handlers only install from the
        main thread; elsewhere the cadence dump is the cover."""
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.getsignal(signum)

                def handler(num, frm, _prev=prev):
                    self.dump(f"signal:{num}")
                    if callable(_prev):
                        _prev(num, frm)
                    elif _prev != signal.SIG_IGN:
                        # SIG_DFL -- or None (a non-Python handler we
                        # cannot call back): either way the signal must
                        # still be FATAL, not swallowed by the dump hook
                        signal.signal(num, signal.SIG_DFL)
                        os.kill(os.getpid(), num)

                signal.signal(signum, handler)
                self._prev_handlers[signum] = prev
            except (ValueError, OSError):
                # not the main thread, or an unsupported platform signal
                pass

    def _atexit_dump(self) -> None:
        if not self._stop.is_set():
            exc = sys.exc_info()[0]
            self.dump("exception-exit" if exc is not None else "exit")

    def stop(self, final_dump: bool = True) -> None:
        if final_dump:
            self._counters_delta_event()
            self.dump("stop")
        self._stop.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=5.0)
        for signum, prev in self._prev_handlers.items():
            try:
                signal.signal(signum, prev)  # type: ignore[arg-type]
            except (ValueError, TypeError, OSError):
                pass
        self._prev_handlers.clear()


def install(role: str, dump_dir: str, capacity: int = 256,
            flush_s: float = 0.5) -> FlightRecorder:
    """Install (and start) the process-global recorder; idempotent per
    process -- a second install for a different role keeps the first
    (one process, one post-mortem identity)."""
    global _recorder
    with _lock:
        if _recorder is not None:
            return _recorder
        rec = FlightRecorder(role, dump_dir, capacity=capacity,
                             flush_s=flush_s)
        _recorder = rec
    rec.start()
    return rec


def install_from_conf(role: str) -> Optional[FlightRecorder]:
    """Conf-gated install (``async.flight.dir`` empty = off): the one
    call every daemon entry point makes, riding
    ``live.start_telemetry_from_conf`` so new roles cannot forget it."""
    from asyncframework_tpu_torch.conf import (
        FLIGHT_DIR,
        FLIGHT_EVENTS,
        FLIGHT_FLUSH_S,
        global_conf,
    )

    conf = global_conf()
    dump_dir = str(conf.get(FLIGHT_DIR) or "").strip()
    if not dump_dir:
        return None
    return install(role, dump_dir,
                   capacity=int(conf.get(FLIGHT_EVENTS)),
                   flush_s=float(conf.get(FLIGHT_FLUSH_S)))


def uninstall(final_dump: bool = False) -> None:
    """Drop the process-global recorder (tests)."""
    global _recorder
    with _lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.stop(final_dump=final_dump)


def load_dump(path: str) -> dict:
    """Read one dump file back (the harvest/test reader); raises on a
    torn/foreign file -- callers decide how tolerant to be."""
    with open(path, "r", encoding="utf-8") as f:
        out = json.load(f)
    if not isinstance(out, dict) or "events" not in out:
        raise ValueError(f"{path}: not a flight-recorder dump")
    return out


def scan_dumps(dump_dir: str) -> List[str]:
    """All dump files under ``dump_dir`` (sorted; missing dir = [])."""
    try:
        names = os.listdir(dump_dir)
    except OSError:
        return []
    return sorted(
        os.path.join(dump_dir, n) for n in names
        if n.startswith("flight-") and n.endswith(".json")
    )

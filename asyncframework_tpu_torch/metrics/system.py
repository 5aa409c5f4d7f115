"""Metrics registry with periodic sink reporting.

Parity: the Dropwizard-based ``MetricsSystem``
(``metrics/MetricsSystem.scala:70``) with sources (named gauge providers) and
sinks (Console/CSV/... -- ``core/.../metrics/sink/``) polled on an interval.
Here: :class:`Counter` / :class:`Gauge` / :class:`Histogram` instruments in a
registry, callable sources for on-demand gauges, and Console/CSV/JSONL sinks
driven by an injectable :class:`Clock` so tests use virtual time.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

from asyncframework_tpu_torch.utils.clock import Clock, SystemClock


class Counter:
    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    def __init__(self, initial: float = 0.0) -> None:
        self._v = initial
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Bounded reservoir histogram (keeps the most recent ``capacity``)."""

    def __init__(self, capacity: int = 4096) -> None:
        self._vals: "deque[float]" = deque(maxlen=capacity)
        self._capacity = capacity
        self._lock = threading.Lock()
        self.count = 0

    def update(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self._vals.append(v)  # deque(maxlen) evicts the oldest in O(1)

    @staticmethod
    def _pct(vals: List[float], q: float) -> float:
        """Nearest-rank percentile: the smallest value whose cumulative
        share is >= q.  The old ``int(q * n)`` indexing returned the MAX
        for p95 at any n <= 20 (int(0.95 * 20) == 19) -- every small-n
        histogram overstated its tail."""
        import math

        n = len(vals)
        return vals[min(n - 1, max(0, math.ceil(q * n) - 1))]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._vals)
        if not vals:
            return {"count": 0}
        n = len(vals)
        return {
            "count": self.count,
            "min": vals[0],
            "max": vals[-1],
            "mean": sum(vals) / n,
            "p50": self._pct(vals, 0.50),
            "p95": self._pct(vals, 0.95),
            "p99": self._pct(vals, 0.99),
        }


class Sink:
    def report(self, time_ms: float, values: Dict[str, object]) -> None:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - default
        pass


class ConsoleSink(Sink):
    def __init__(self, out=None):
        import sys

        self._out = out or sys.stderr

    def report(self, time_ms: float, values: Dict[str, object]) -> None:
        print(f"[metrics t={time_ms:.0f}ms] {values}", file=self._out)


class CsvSink(Sink):
    """One CSV per run; columns fixed at first report (late keys ignored)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("w", buffering=1)
        self._cols: Optional[List[str]] = None

    def report(self, time_ms: float, values: Dict[str, object]) -> None:
        flat = _flatten(values)
        if self._cols is None:
            self._cols = ["time_ms"] + sorted(flat)
            self._f.write(",".join(self._cols) + "\n")
        row = [f"{time_ms:.1f}"] + [
            str(flat.get(c, "")) for c in self._cols[1:]
        ]
        self._f.write(",".join(row) + "\n")

    def close(self) -> None:
        self._f.close()


class JsonlSink(Sink):
    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("w", buffering=1)

    def report(self, time_ms: float, values: Dict[str, object]) -> None:
        self._f.write(
            json.dumps({"time_ms": time_ms, **values}, default=str) + "\n"
        )

    def close(self) -> None:
        self._f.close()


def _flatten(values: Dict[str, object], prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in values.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


class MetricsSystem:
    """Registry + polling loop.

    Instruments are registered under dotted names; sources are callables
    returning a dict (evaluated at report time).  ``start(period_s)`` spawns
    the polling thread; with a :class:`ManualClock` the loop ticks only when
    the test advances time (streaming-suite determinism parity).
    """

    def __init__(self, clock: Optional[Clock] = None):
        self._clock = clock or SystemClock()
        self._instruments: Dict[str, object] = {}
        self._sources: Dict[str, Callable[[], Dict[str, object]]] = {}
        self._sinks: List[Sink] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._register(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._register(name, Histogram)

    def _register(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls()
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}"
                )
            return inst

    def register_source(
        self, name: str, fn: Callable[[], Dict[str, object]]
    ) -> None:
        with self._lock:
            self._sources[name] = fn

    def add_sink(self, sink: Sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def collect(self) -> Dict[str, object]:
        with self._lock:
            instruments = dict(self._instruments)
            sources = dict(self._sources)
        out: Dict[str, object] = {}
        for name, inst in instruments.items():
            if isinstance(inst, Histogram):
                out[name] = inst.snapshot()
            else:
                out[name] = inst.value  # type: ignore[union-attr]
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 - source must not kill report
                out[name] = f"<error: {e!r}>"
        return out

    def report(self) -> Dict[str, object]:
        values = self.collect()
        t = self._clock.now_ms()
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink.report(t, values)
            except Exception:  # noqa: BLE001 - one sink must not kill the rest
                # mirrors the source-collection shield above; a dead sink
                # must not terminate the polling thread
                pass
        return values

    def start(self, period_s: float = 10.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                if self._clock.wait_for(self._stop, period_s):
                    return  # interrupted by stop(), not a tick
                self.report()

        self._thread = threading.Thread(
            target=loop, name="metrics-system", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            sink.close()

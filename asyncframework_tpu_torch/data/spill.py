"""Bounded-memory shuffle routing with disk spill.

Parity (studied, not copied): ``core/.../shuffle/sort/SortShuffleManager.
scala:69`` spills sorted runs to disk when the shuffle's execution-memory
grant is exhausted, and ``memory/UnifiedMemoryManager.scala:47`` accounts
the bytes.  The TPU build's host shuffle (data/pairs.py) routes per-key
entries through the driver; before this module it held every routed group
in Python dicts with no bound -- a 10^8-pair shuffle OOMed the driver
silently.

Design: a :class:`SpillingRouter` buffers routed entries per target
partition, estimates their host bytes incrementally, and when the
configured bound (``async.shuffle.spill.bytes``) is exceeded writes the
whole buffer as one pickled RUN file and clears it.  Reading a partition
replays its slice of every run in write order, then the in-memory tail --
insertion order is preserved exactly as the unbounded dict preserved it,
so results are bit-identical with or without spilling.  Cumulative
counters (records, spills, bytes) feed the live UI's shuffle panel and
``DistributedDataset``-level assertions in tests.

A copy of the JAX package's ``data/spill.py``: the runs are pickles of
host entries, and the counters are the ``shuffle`` counter family
(``metrics/registry.py``).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: process-wide cumulative counters (UnifiedMemoryManager's accounting
#: role, trimmed to observability); read by metrics/live.py
_TOTALS_LOCK = threading.Lock()
_TOTALS = {
    "shuffles": 0,
    "records_routed": 0,
    "spill_count": 0,
    "bytes_spilled": 0,
    "bytes_in_memory_peak": 0,
}


def shuffle_totals() -> Dict[str, int]:
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def reset_shuffle_totals() -> None:
    """Zero the process-wide counters (per-run isolation; see
    ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    with _TOTALS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0


_reset_totals = reset_shuffle_totals  # historical test-suite alias


def _estimate_bytes(kv: Tuple[Any, Any]) -> int:
    """Cheap per-entry host-memory estimate: shallow sizes + container
    overhead.  Deliberately approximate -- the bound is a safety rail, not
    an allocator."""
    k, v = kv
    est = 64 + sys.getsizeof(k)
    est += v.nbytes if hasattr(v, "nbytes") else sys.getsizeof(v)
    return est


class SpillingRouter:
    """Driver-side routing buffer with a memory bound and disk runs.

    ``memory_bytes <= 0`` disables spilling (the pre-existing unbounded
    behavior).  Spill files live in a private temp dir and are removed by
    :meth:`close` (or interpreter exit via the tempdir finalizer).
    """

    def __init__(self, num_partitions: int, memory_bytes: int,
                 label: str = "shuffle"):
        self.p = num_partitions
        self.bound = int(memory_bytes)
        self.label = label
        self._buf: Dict[int, List[Tuple[Any, Any]]] = {
            i: [] for i in range(num_partitions)
        }
        self._est = 0
        self._est_peak = 0
        # each run = per-partition pickled segments + an offset index, so a
        # partition read seeks straight to its slice (a whole-dict pickle
        # would cost O(p x spilled bytes) deserialization across readers)
        self._runs: List[Tuple[str, Dict[int, Tuple[int, int]]]] = []
        self._tmp: Optional[tempfile.TemporaryDirectory] = None
        self.records = 0
        self.spill_count = 0
        self.bytes_spilled = 0
        with _TOTALS_LOCK:
            _TOTALS["shuffles"] += 1

    # ------------------------------------------------------------- writing
    def add(self, pid: int, kv: Tuple[Any, Any]) -> None:
        self._buf[pid].append(kv)
        self.records += 1
        self._est += _estimate_bytes(kv)
        if self._est > self._est_peak:
            self._est_peak = self._est
        if self.bound > 0 and self._est >= self.bound:
            self._spill()

    def _spill(self) -> None:
        if self._tmp is None:
            self._tmp = tempfile.TemporaryDirectory(
                prefix=f"asynctpu-{self.label}-"
            )
        path = os.path.join(
            self._tmp.name, f"run-{len(self._runs):04d}.pkl"
        )
        index: Dict[int, Tuple[int, int]] = {}
        off = 0
        with open(path, "wb") as f:
            for pid in range(self.p):
                if not self._buf[pid]:
                    continue
                blob = pickle.dumps(
                    self._buf[pid], protocol=pickle.HIGHEST_PROTOCOL
                )
                f.write(blob)
                index[pid] = (off, len(blob))
                off += len(blob)
        self._runs.append((path, index))
        self.spill_count += 1
        self.bytes_spilled += off
        self._buf = {i: [] for i in range(self.p)}
        self._est = 0

    # ------------------------------------------------------------- reading
    def partition(self, pid: int) -> Iterator[Tuple[Any, Any]]:
        """Entries routed to ``pid`` in original insertion order (runs in
        write order, then the in-memory tail).  Reads only this
        partition's segments -- seek + bounded read per run."""
        for path, index in self._runs:
            seg = index.get(pid)
            if seg is None:
                continue
            off, length = seg
            with open(path, "rb") as f:
                f.seek(off)
                yield from pickle.loads(f.read(length))
        yield from self._buf[pid]

    def partition_list(self, pid: int) -> List[Tuple[Any, Any]]:
        return list(self.partition(pid))

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        with _TOTALS_LOCK:
            _TOTALS["records_routed"] += self.records
            _TOTALS["spill_count"] += self.spill_count
            _TOTALS["bytes_spilled"] += self.bytes_spilled
            _TOTALS["bytes_in_memory_peak"] = max(
                _TOTALS["bytes_in_memory_peak"], self._est_peak
            )
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
        self._runs = []

    def __enter__(self) -> "SpillingRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def configured_spill_bytes() -> int:
    """The process-global shuffle memory bound (0 = unbounded)."""
    from asyncframework_tpu_torch.conf import SHUFFLE_SPILL_BYTES, global_conf

    return int(global_conf().get(SHUFFLE_SPILL_BYTES))

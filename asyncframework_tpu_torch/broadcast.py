"""Versioned model distribution: the broadcast layer.

Counterpart of ``asyncframework_tpu/broadcast.py``.  Parity:
``broadcast/TorrentBroadcast.scala:57`` (the driver broadcasts a fresh model
snapshot each round) and ``broadcast/ASYNCbroadcast.scala:12-46`` (a
version id a worker can point at an **older** model -- the stale-read
experiment).

Device mapping: "broadcast" is a host-to-device copy of the host snapshot
of ``w``, issued with ``non_blocking=True`` from pinned memory when the
target is a GPU, so the host thread returns while the copy proceeds.  The
store keeps the last ``max_live_versions`` snapshots:

- ``store.publish(w)``                       = ``sc.broadcast(w)``
- ``store.value(device)``                    = ``bc.value`` (latest)
- ``store.value(device, version=v)``         = ``ASYNCbroadcast.value(index)``
- eviction of old versions                   = ``Broadcast.destroy``
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from asyncframework_tpu_torch.utils.devices import canonical


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    return host.to(device, non_blocking=host.is_pinned())


class VersionedModelStore:
    def __init__(self, max_live_versions: int = 4):
        if max_live_versions < 1:
            raise ValueError("max_live_versions must be >= 1")
        self._max_live = max_live_versions
        self._lock = threading.Lock()
        self._next_version = 0
        # version -> (host snapshot, {device -> device tensor})
        self._versions: "OrderedDict[int, tuple]" = OrderedDict()

    # ---------------------------------------------------------------- publish
    def publish(self, w, devices=None) -> int:
        """Snapshot ``w`` (numpy or tensor) as a new version and start its
        copies to ``devices``."""
        host = torch.tensor(np.asarray(w, dtype=np.float32))  # a private copy
        if torch.cuda.is_available():
            host = host.pin_memory()
        with self._lock:
            v = self._next_version
            self._next_version += 1
            buffers: Dict[torch.device, torch.Tensor] = {}
            for dev in devices or ():
                dev = canonical(dev)
                if dev not in buffers:
                    buffers[dev] = _to_device(host, dev)
            self._versions[v] = (host, buffers)
            while len(self._versions) > self._max_live:
                self._versions.popitem(last=False)  # evict oldest
            return v

    # ------------------------------------------------------------------ reads
    def latest_version(self) -> int:
        with self._lock:
            if not self._versions:
                raise KeyError("no version published yet")
            return next(reversed(self._versions))

    def value(self, device=None, version: Optional[int] = None):
        """Device tensor (or host numpy snapshot when ``device`` is None) of
        a version; ``version=None`` reads the latest.  Raises ``KeyError``
        for evicted or unknown versions."""
        with self._lock:
            v = version if version is not None else (
                next(reversed(self._versions)) if self._versions else None
            )
            if v is None or v not in self._versions:
                raise KeyError(f"model version {v} not live")
            host, buffers = self._versions[v]
            if device is None:
                return host.numpy()
            device = canonical(device)
            buf = buffers.get(device)
        if buf is not None:
            return buf
        # lazy fan-out: first read from a device not in the publish set
        buf = _to_device(host, device)
        with self._lock:
            if v in self._versions:
                self._versions[v][1][device] = buf
        return buf

    def live_versions(self):
        with self._lock:
            return list(self._versions.keys())

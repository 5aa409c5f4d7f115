"""Relaycast-plane counters (metrics/registry.py ``relay`` family).

Process-global flat monotone counters, the same shape as every other
observability module: nodes and sources bump them, ``relay_totals()``
feeds the live UI / sampler / Prometheus exposition through the central
registry, and ``reset_relay_totals()`` rides ``metrics.reset_totals``
for per-run isolation.
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_totals: Dict[str, int] = {}


def bump(key: str, n: int = 1) -> None:
    """Monotone relay counter (fetches_served, fetch_nm/fetch_xdelta/
    fetch_full, fetch_bytes_out, offers_sent, offers_received,
    offers_stale, parent_fetches, parent_bytes_in, root_fallbacks,
    rehomes, fenced_hops, crc_rejects, stale_epoch_rejects,
    children_dropped)."""
    with _lock:
        _totals[key] = _totals.get(key, 0) + n


def relay_totals() -> Dict[str, int]:
    with _lock:
        return dict(_totals)


def reset_relay_totals() -> None:
    with _lock:
        _totals.clear()

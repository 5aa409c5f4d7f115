"""Shared network robustness layer for the DCN control + data plane.

One framing (``frame``), one retry/backoff policy with circuit breakers
(``retry``), exactly-once-applied client sessions with server-side dedup
windows (``session``), and deterministic schedule-driven fault injection
(``faults``).  The parameter server, the streaming topic server, and all
three standalone deploy daemons route through this package -- failure
handling is a subsystem here, not folklore at call sites.
"""

from __future__ import annotations

from typing import Dict

from asyncframework_tpu_torch.net.retry import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
    RetryError,
    RetryPolicy,
)
from asyncframework_tpu_torch.net.session import (  # noqa: F401
    ClientSession,
    DedupWindow,
)


def net_totals() -> Dict[str, int]:
    """Process-wide robustness counters (surfaced in the live UI next to
    the shuffle totals): retries taken, give-ups, breaker trips, dedup
    hits, faults fired."""
    from asyncframework_tpu_torch.net import faults, retry, session

    out = dict(retry.retry_totals())
    out["dedup_hits"] = session.dedup_hits_total()
    out["faults_fired"] = faults.faults_fired_total()
    return out


def reset_net_totals() -> None:
    """Zero every process-wide net counter (retries/giveups/breaker trips,
    dedup hits, faults fired, wire-byte totals) so back-to-back runs in
    one process start from a clean slate.  Breaker *state* is left alone
    -- see ``retry.reset_breakers`` for that."""
    from asyncframework_tpu_torch.net import faults, frame, lockwatch, retry, session

    retry.reset_retry_totals()
    session.reset_dedup_hits_total()
    faults.reset_faults_fired_total()
    frame.reset_bytes_totals()
    lockwatch.reset_totals()

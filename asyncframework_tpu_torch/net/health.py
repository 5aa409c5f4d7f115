"""Gray-failure detection: per-endpoint op-RTT EWMA vs the cohort.

Crash failures announce themselves (a dead pid, a refused dial, silence
past the lease).  *Gray* failures do not: the member answers every probe,
renews its lease on every op, and is still useless -- a wedged disk, a
half-dead NIC, a CPU-starved pod.  The classic signature is relative
latency: the member's op round trips drift to a multiple of its cohort's
while everything else about it looks alive.

:class:`RttSuspector` is that detector, deliberately tiny: callers feed
it every op RTT they already measure (the ShardGroup's liveness probes,
the ServingFrontend's predict round trips), it keeps one EWMA per
endpoint, and an endpoint becomes **suspect** when its EWMA exceeds
``async.gray.rtt.factor`` times the median EWMA of its cohort peers (and
the ``async.gray.rtt.min.ms`` floor -- micro-jitter on a fast local
cohort is not a gray failure).  Suspicion is comparative by design: with
no peers to compare against it never fires (a uniformly slow link is a
deployment property, not a member failure).

Suspicion feeds the same membership state machine as silence
(``parallel/supervisor.py`` SUSPECT state): the member is demoted in
routing (frontend rotation, shard-probe reporting) and surfaced in
membership/metrics, but never *killed* on latency alone -- only lease
expiry or process exit escalates to DEAD.  That split is the point:
partitions and stragglers heal; a false kill plus a checkpoint-restored
replacement is a split brain.
"""

from __future__ import annotations

import statistics
import threading
from typing import Dict, Optional, Set

_totals_lock = threading.Lock()
_totals: Dict[str, int] = {}


def gray_totals() -> Dict[str, int]:
    """Process-global gray-failure counters: ``suspicions`` (endpoint
    transitions into latency-suspect), ``recoveries`` (transitions back
    out)."""
    with _totals_lock:
        return dict(_totals)


def reset_gray_totals() -> None:
    """Zero the process-global counters (per-run isolation; see
    ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    with _totals_lock:
        _totals.clear()


def _bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] = _totals.get(key, 0) + n


class RttSuspector:
    """Per-endpoint RTT EWMA with cohort-relative suspicion.

    ``observe(endpoint, ms)`` folds one measured round trip and returns
    whether the endpoint is suspect NOW; ``is_suspect``/``suspects`` read
    the current verdicts without folding.  Thread-safe; one instance per
    cohort (the comparison set is "every endpoint this instance has
    seen")."""

    def __init__(self, factor: Optional[float] = None,
                 min_ms: Optional[float] = None, alpha: float = 0.25,
                 min_samples: int = 5, ttl_s: float = 30.0):
        if factor is None or min_ms is None:
            from asyncframework_tpu_torch.conf import (
                GRAY_RTT_FACTOR,
                GRAY_RTT_MIN_MS,
                global_conf,
            )

            conf = global_conf()
            factor = factor if factor is not None \
                else conf.get(GRAY_RTT_FACTOR)
            min_ms = min_ms if min_ms is not None \
                else conf.get(GRAY_RTT_MIN_MS)
        self.factor = float(factor)
        self.min_ms = float(min_ms)
        self.alpha = float(alpha)
        self.min_samples = max(1, int(min_samples))
        # suspicion TTL: a verdict is only as fresh as its observations.
        # Routing demotes suspects, which can starve them of the very
        # traffic that would clear them (the frontend's predicts only
        # measure replicas that answer) -- so a suspicion older than
        # ``ttl_s`` without a new observation EXPIRES and the endpoint
        # re-earns its verdict from fresh samples.  Probe-driven callers
        # (the ShardGroup, which measures every member every tick) never
        # hit the TTL; traffic-driven callers need it for recovery.
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._ewma: Dict[str, float] = {}
        self._n: Dict[str, int] = {}
        self._last_obs: Dict[str, float] = {}
        self._suspect: Set[str] = set()

    @staticmethod
    def _now() -> float:
        import time

        return time.monotonic()

    def observe(self, endpoint: str, ms: float) -> bool:
        """Fold one RTT; returns True iff ``endpoint`` is suspect now."""
        ms = max(0.0, float(ms))
        with self._lock:
            prev = self._ewma.get(endpoint)
            self._ewma[endpoint] = (
                ms if prev is None
                else prev + self.alpha * (ms - prev)
            )
            self._n[endpoint] = self._n.get(endpoint, 0) + 1
            self._last_obs[endpoint] = self._now()
            return self._judge_locked(endpoint)

    def _expire_locked(self, endpoint: str) -> None:
        """Drop a suspicion whose observations went stale (the endpoint
        is starved of traffic BECAUSE it is demoted): it re-earns its
        verdict from fresh samples."""
        if endpoint not in self._suspect or self.ttl_s <= 0:
            return
        last = self._last_obs.get(endpoint)
        if last is not None and self._now() - last > self.ttl_s:
            self._suspect.discard(endpoint)
            self._ewma.pop(endpoint, None)
            self._n.pop(endpoint, None)
            _bump("recoveries")

    def _cohort_median_locked(self, endpoint: str) -> Optional[float]:
        peers = [
            v for e, v in self._ewma.items()
            if e != endpoint and self._n.get(e, 0) >= self.min_samples
        ]
        return statistics.median(peers) if peers else None

    def _judge_locked(self, endpoint: str) -> bool:
        was = endpoint in self._suspect
        sus = False
        if self._n.get(endpoint, 0) >= self.min_samples:
            med = self._cohort_median_locked(endpoint)
            if med is not None:
                threshold = max(self.min_ms, self.factor * med)
                sus = self._ewma[endpoint] > threshold
        if sus and not was:
            self._suspect.add(endpoint)
            _bump("suspicions")
        elif was and not sus:
            self._suspect.discard(endpoint)
            _bump("recoveries")
        return sus

    def is_suspect(self, endpoint: str) -> bool:
        with self._lock:
            self._expire_locked(endpoint)
            return endpoint in self._suspect

    def suspects(self) -> Set[str]:
        with self._lock:
            for e in list(self._suspect):
                self._expire_locked(e)
            return set(self._suspect)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-endpoint {ewma_ms, samples, suspect} (status pages)."""
        with self._lock:
            return {
                e: {"ewma_ms": round(v, 3),
                    "samples": self._n.get(e, 0),
                    "suspect": e in self._suspect}
                for e, v in self._ewma.items()
            }

    def forget(self, endpoint: str) -> None:
        """Drop an endpoint (a deregistered replica, a remapped shard)."""
        with self._lock:
            self._ewma.pop(endpoint, None)
            self._n.pop(endpoint, None)
            self._last_obs.pop(endpoint, None)
            self._suspect.discard(endpoint)

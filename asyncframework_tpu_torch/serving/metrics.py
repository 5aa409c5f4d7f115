"""Serving-plane counters and latency/freshness accounting.

Process-global like every other observability module (net counters,
recovery totals, pipeline totals): the ServingFrontend and any in-process
ModelReplica bump these, ``serving_totals()`` feeds the live UI's per-run
delta machinery (flat ints only), ``serving_snapshot()`` adds the derived
views -- predict latency p50/p95/p99, freshness lag in versions AND ms,
per-replica breakdown -- and ``reset_serving_totals()`` is wired into
``asyncframework_tpu_torch.metrics.reset_totals`` so a second serve run in one
process starts from zero instead of inheriting the first run's QPS/lag
totals (the same per-run-isolation contract as the
net/recovery counters).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from asyncframework_tpu_torch.metrics.system import Histogram

_lock = threading.Lock()
_totals: Dict[str, int] = {}
#: per-replica flat views: endpoint -> {predicts, errors, lag_versions,
#: lag_ms, ts} (last-observed values; counts monotone)
_replicas: Dict[str, Dict[str, float]] = {}
_predict_ms = Histogram(capacity=4096)
_lag_versions = Histogram(capacity=4096)
_lag_ms = Histogram(capacity=4096)
#: monotonic time of the first/last observed predict (per-process QPS)
_t_first: Optional[float] = None
_t_last: Optional[float] = None
#: monotonic time + observed lag of the last SUCCESSFUL predict: the
#: freshness-lag SLO input (metrics/slo.py).  While predicts keep
#: succeeding this tracks the served lag; when every replica is down the
#: last success recedes into the past and the derived value grows.
_t_last_ok: Optional[float] = None
_last_ok_lag_ms: float = 0.0


def bump(key: str, n: int = 1) -> None:
    """Monotone serving counter (predicts, predict_errors [whole request
    failed], attempt_errors [one replica RPC failed], failovers,
    unhealthy_rejects, refreshes, refresh_nm/xdelta/full,
    refresh_fallbacks, refresh_errors, replica_predicts,
    replicas_registered)."""
    with _lock:
        _totals[key] = _totals.get(key, 0) + n


def observe_predict(endpoint: str, dur_ms: float, lag_versions: int,
                    lag_ms: float, ts: int, ok: bool = True) -> None:
    """One answered (or failed) PREDICT against ``endpoint``: latency and
    the freshness lag the reply was served at."""
    global _t_first, _t_last, _t_last_ok, _last_ok_lag_ms
    now = time.monotonic()
    with _lock:
        if ok:
            _t_last_ok = now
            _last_ok_lag_ms = float(lag_ms)
        _totals["predicts"] = _totals.get("predicts", 0) + int(ok)
        if not ok:
            # per-ATTEMPT failure (one replica, one RPC); requests that
            # ultimately fail after every failover bump predict_errors
            _totals["attempt_errors"] = _totals.get("attempt_errors", 0) + 1
        rep = _replicas.setdefault(endpoint, {"predicts": 0, "errors": 0})
        if ok:
            rep["predicts"] += 1
            rep["lag_versions"] = int(lag_versions)
            rep["lag_ms"] = round(float(lag_ms), 3)
            rep["ts"] = int(ts)
        else:
            rep["errors"] += 1
        if _t_first is None:
            _t_first = now
        _t_last = now
    if ok:
        _predict_ms.update(float(dur_ms))
        _lag_versions.update(float(lag_versions))
        _lag_ms.update(float(lag_ms))


def note_attempt() -> None:
    """A PREDICT attempt reached the serving plane without producing a
    servable answer (e.g. every replica rejected it UNHEALTHY): advances
    the demand clock :func:`freshness_lag_ms` grows against.  RPC-level
    failures take the same clock via ``observe_predict(ok=False)``."""
    global _t_first, _t_last
    now = time.monotonic()
    with _lock:
        if _t_first is None:
            _t_first = now
        _t_last = now


def freshness_lag_ms() -> Optional[float]:
    """The serve-freshness SLO signal: the model-content lag observed at
    the last successful predict, grown by how far the last predict
    ATTEMPT (ok or failed) has receded past it.  While traffic is being
    answered this tracks the true served lag; when attempts keep failing
    (replicas dead or all UNHEALTHY) the value grows with the failing
    demand -- exactly the "reads are going stale" condition a freshness
    SLO exists to catch.  A traffic lull with healthy replicas holds the
    last observed lag instead of growing (nobody is being served stale
    when nobody is reading), and None until the first successful predict
    (an idle frontend is not an outage)."""
    with _lock:
        if _t_last_ok is None:
            return None
        ref = _t_last_ok if _t_last is None else max(_t_last, _t_last_ok)
        return round(_last_ok_lag_ms + (ref - _t_last_ok) * 1e3, 3)


def serving_totals() -> Dict[str, int]:
    """Flat monotone counters (live-UI ``_delta`` compatible)."""
    with _lock:
        return dict(_totals)


def serving_snapshot() -> Dict:
    """The dashboard view: totals + derived latency/lag percentiles, QPS
    over the observed predict window, and the per-replica breakdown."""
    with _lock:
        totals = dict(_totals)
        replicas = {e: dict(v) for e, v in _replicas.items()}
        window = ((_t_last - _t_first)
                  if _t_first is not None and _t_last is not None else 0.0)
    n = totals.get("predicts", 0)
    return {
        **totals,
        "qps": round(n / window, 1) if window > 0 else float(n),
        "freshness_lag_ms": freshness_lag_ms(),
        "predict_ms": _predict_ms.snapshot(),
        "lag_versions": _lag_versions.snapshot(),
        "lag_ms": _lag_ms.snapshot(),
        "replicas": replicas,
    }


def reset_serving_totals() -> None:
    """Zero every serving counter, ring, and per-replica view (per-run
    isolation; see ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    global _predict_ms, _lag_versions, _lag_ms, _t_first, _t_last
    global _t_last_ok, _last_ok_lag_ms
    with _lock:
        _totals.clear()
        _replicas.clear()
        _t_first = _t_last = None
        _t_last_ok = None
        _last_ok_lag_ms = 0.0
    _predict_ms = Histogram(capacity=4096)
    _lag_versions = Histogram(capacity=4096)
    _lag_ms = Histogram(capacity=4096)

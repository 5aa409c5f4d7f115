"""The serving tier: snapshot-subscribing predict replicas with
freshness-lag SLOs.

A copy of the JAX package's ``serving/``.  :class:`ModelReplica`
subscribes to the ParameterServer's versioned snapshots over the
``net/`` plane (delta-mode ``have=`` pulls on a background refresh loop,
CRC-gated, full-pull fallback), holds the current model on the device
behind an atomic swap, and answers PREDICT RPCs while training
continues; :class:`ServingFrontend` registers replicas (HELLO, the
membership machinery of ``parallel/supervisor.py`` in ``adopt=False``
mode) and round-robins client requests with retry/circuit-breaker
failover, so a SIGKILLed replica mid-load degrades to a failover, never
an outage.  Every reply carries its freshness lag (PS clock minus served
version, in versions and ms); replicas past the
``async.serve.max.staleness.ms`` SLO answer UNHEALTHY and the frontend
routes around them.  The wire is the JAX package's, byte for byte: a
replica, frontend or relay node of either package works with a PS,
frontend or node of the other.

Knobs: ``async.serve.*`` (conf.py).  Entry point: ``python -m
asyncframework_tpu_torch.serving.cli replica|frontend``.  A replica's
model lives on ``cuda`` unless the caller gives a device (or the CLI runs
under ``ASYNCTPU_FORCE_CPU=1``).
"""

from asyncframework_tpu_torch.serving.frontend import PredictError, ServingFrontend
from asyncframework_tpu_torch.serving.metrics import (
    reset_serving_totals,
    serving_snapshot,
    serving_totals,
)
from asyncframework_tpu_torch.serving.replica import ModelReplica

__all__ = [
    "ModelReplica",
    "ServingFrontend",
    "PredictError",
    "serving_totals",
    "serving_snapshot",
    "reset_serving_totals",
]

"""Carry model state and data across from the JAX package.

The two packages share no code, so tests and tools that run both on the
same state pass it as numpy: the JAX package's model and per-worker shards,
taken out with ``np.asarray``, become the port's tensors here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.utils.devices import resolve_devices


def model_from_reference(w: np.ndarray, k: int, device=None):
    """``(w, k)`` as the port's device state: an f32 ``(d,)`` model and the
    f32 0-d iteration counter the appliers advance in place."""
    dev = resolve_devices(None if device is None else [device])[0]
    w_t = torch.tensor(np.asarray(w, np.float32), device=dev)
    k_t = torch.tensor(float(k), dtype=torch.float32, device=dev)
    return w_t, k_t


def dataset_from_reference(
    shards: Sequence[Tuple[np.ndarray, np.ndarray]],
    devices: Optional[Sequence] = None,
    dtype: Optional[torch.dtype] = None,
) -> ShardedDataset:
    """A port dataset holding the JAX package's shards, worker by worker
    (``[(np.asarray(s.X), np.asarray(s.y)) for s in ds.shards.values()]``).
    bf16 shards arrive as f32 numpy (exact) and are stored back in
    ``dtype``."""
    d = int(shards[0][0].shape[1])
    return ShardedDataset.from_shards(shards, d, devices, dtype)

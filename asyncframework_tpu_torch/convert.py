"""Carry model state and data across from the JAX package.

The two packages share no code, so tests and tools that run both on the
same state pass it as numpy: the JAX package's model and per-worker shards,
taken out with ``np.asarray``, become the port's tensors here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
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


def sparse_dataset_from_reference(
    shards: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    d: int,
    devices: Optional[Sequence] = None,
    row_perm: Optional[np.ndarray] = None,
) -> SparseShardedDataset:
    """A port dataset holding a JAX ``SparseShardedDataset``'s padded-ELL
    shards, worker by worker (``[(np.asarray(s.cols), np.asarray(s.vals),
    np.asarray(s.y)) for s in ds.shards.values()]``, with ``d = ds.d`` and
    ``row_perm = ds.row_perm``)."""
    return SparseShardedDataset.from_shards(shards, d, devices, row_perm)


def saga_state_from_reference(
    w: np.ndarray,
    alpha_slices: Mapping[int, np.ndarray],
    alpha_bar: np.ndarray,
    k: int,
    devices: Sequence,
) -> Tuple[torch.Tensor, Dict[int, torch.Tensor], torch.Tensor, int]:
    """ASAGA state of the JAX package as the port's: ``(w, alpha, alpha_bar,
    k)`` with ``w`` and ``alpha_bar`` f32 ``(d,)`` tensors on ``devices[0]``
    and worker ``wid``'s history slice on ``devices[wid % len(devices)]``
    (the solvers' placement), so both packages start from the same table
    (e.g. ``res.extras["alpha"]`` of a JAX run), dense or sparse alike."""
    devs = resolve_devices(devices)
    alpha = {
        int(wid): torch.tensor(np.asarray(a, np.float32),
                               device=devs[int(wid) % len(devs)])
        for wid, a in alpha_slices.items()
    }
    w_t = torch.tensor(np.asarray(w, np.float32), device=devs[0])
    ab_t = torch.tensor(np.asarray(alpha_bar, np.float32), device=devs[0])
    return w_t, alpha, ab_t, int(k)

"""Device-memory budget planning before a run commits shards to a device.

Counterpart of ``asyncframework_tpu/utils/hbm.py``, trimmed to what
``solvers.base.check_hbm_plan`` needs.  The budget of a CUDA device is its
total memory (``torch.cuda.get_device_properties``); a CPU device is
planned against the host's physical memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def nbytes(shape: Sequence[int], dtype=np.float32) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def device_memory_bytes(device) -> int:
    """Total memory of ``device``: the card's for CUDA, the host's for CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


@dataclass(frozen=True)
class ShardPlan:
    """Outcome of a plan: per-device residency estimate."""

    bytes_per_device: int
    budget_bytes: int
    fits: bool
    utilization: float

    def require_fits(self) -> "ShardPlan":
        if not self.fits:
            raise MemoryError(
                f"planned shard residency {self.bytes_per_device / 1e9:.2f} GB "
                f"exceeds the {self.budget_bytes / 1e9:.2f} GB device budget"
            )
        return self


def _plan(total: int, budget: int, headroom: float) -> ShardPlan:
    usable = int(budget * headroom)
    return ShardPlan(
        bytes_per_device=int(total),
        budget_bytes=usable,
        fits=total <= usable,
        utilization=total / usable if usable else float("inf"),
    )


def shard_tensors(shard):
    """The tensors a shard holds: ``(cols, vals, y)`` for a padded-ELL
    sparse shard, ``(X, y)`` for a dense one."""
    if hasattr(shard, "cols"):
        return shard.cols, shard.vals, shard.y
    return shard.X, shard.y


def dataset_residency_bytes(ds) -> Dict[torch.device, int]:
    """Actual per-device bytes of an already-placed sharded dataset (dense
    or sparse)."""
    per_dev: Dict[torch.device, int] = {}
    for wid in range(ds.num_workers):
        s = ds.shard(wid)
        per_dev[s.device] = per_dev.get(s.device, 0) + sum(
            t.numel() * t.element_size() for t in shard_tensors(s)
        )
    return per_dev


def plan_for_run(
    ds_or_shape,
    num_workers: int,
    num_devices: int,
    device,
    model_versions: int = 2,
    budget_bytes: Optional[int] = None,
    headroom: float = 0.85,
    history_table: bool = False,
) -> ShardPlan:
    """Placement plan for one training run.

    ``ds_or_shape`` is either a *placed* dataset, dense or sparse (actual
    residency measured from its shards) or an ``(n, d)`` tuple for f32 host data not yet placed
    (planned from shapes: workers sharing a device stack their shards).
    ``model_versions`` live copies of ``w`` are added, and with
    ``history_table`` ASAGA's history slices (one f32 per sample, stacked
    like the shards); ``headroom`` keeps a share of the budget for scratch
    and the caching allocator.
    """
    if num_devices < 1 or num_workers < 1:
        raise ValueError("num_workers and num_devices must be >= 1")
    budget = budget_bytes if budget_bytes is not None else device_memory_bytes(device)
    if isinstance(ds_or_shape, tuple):
        n, d = ds_or_shape
        rows = -(-n // num_workers)
        worst = -(-num_workers // num_devices) * nbytes((rows, d + 1))
    else:
        d = ds_or_shape.d
        per_dev = dataset_residency_bytes(ds_or_shape)
        worst = max(per_dev.values()) if per_dev else 0
    total = worst + model_versions * nbytes((d,))
    if history_table:
        n = ds_or_shape[0] if isinstance(ds_or_shape, tuple) else ds_or_shape.n
        total += -(-num_workers // num_devices) * nbytes((-(-n // num_workers),))
    return _plan(total, budget, headroom)

"""Device-resident sharded dataset.

Counterpart of ``asyncframework_tpu/data/sharded.py``.  Rows are split into
``num_workers`` contiguous balanced shards (``repartition`` parity), each
placed once in its worker's device memory (the ``cache()``); the global row
index of local row ``j`` in shard ``p`` is ``partition_cum[p] + j``
(``zipWithIndex`` parity).  Several logical workers may share one device:
the worker is the unit of asynchrony, the device the unit of compute.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ops.gradients import mm_f32
from asyncframework_tpu_torch.ops.sampling import fold_in
from asyncframework_tpu_torch.utils.devices import resolve_devices

#: domain separation of the data stream from the solvers' per-worker mask
#: streams, which are ``fold_in(seed, wid)`` ("DATA")
_DATA_DOMAIN = 0x44415441


def balanced_sizes(n: int, num_workers: int) -> List[int]:
    """Contiguous balanced split, sizes differ by <=1 (repartition parity)."""
    if num_workers < 1 or num_workers > n:
        raise ValueError(f"num_workers={num_workers} invalid for n={n}")
    return [
        n // num_workers + (1 if i < n % num_workers else 0)
        for i in range(num_workers)
    ]


@dataclass
class Shard:
    worker_id: int
    X: torch.Tensor  # (n_p, d) on the worker's device
    y: torch.Tensor  # (n_p,) f32
    start: int       # global index of row 0 (partitionCumList parity)
    size: int

    @property
    def device(self) -> torch.device:
        return self.X.device


class ShardedDataset:
    """Immutable row-sharded (X, y) resident on devices.

    ``ShardedDataset(X, y, num_workers, devices, dtype)`` shards host
    arrays; ``devices=None`` means every CUDA device and raises without
    one.  ``dtype=torch.bfloat16`` stores X in bf16 (labels stay f32).
    """

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray,
        num_workers: int,
        devices: Optional[Sequence] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        n = X.shape[0]
        if y.shape[0] != n:
            raise ValueError(f"X has {n} rows but y has {y.shape[0]}")
        cum = np.concatenate([[0], np.cumsum(balanced_sizes(n, num_workers))])
        parts = [(X[lo:hi], y[lo:hi]) for lo, hi in zip(cum[:-1], cum[1:])]
        self._place(parts, X.shape[1], devices, dtype)
        self._host_X = X
        self._host_y = y

    @classmethod
    def from_shards(
        cls,
        shards: Sequence[Tuple[np.ndarray, np.ndarray]],
        d: int,
        devices: Optional[Sequence] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> "ShardedDataset":
        """A dataset from per-worker host ``(X_p, y_p)`` shards, in worker
        order (e.g. another package's shards taken out as numpy)."""
        obj = cls.__new__(cls)
        obj._place(list(shards), d, devices, dtype)
        obj._host_X = obj._host_y = None
        return obj

    def _place(self, parts, d: int, devices, dtype) -> None:
        devs = resolve_devices(devices)
        sizes = [int(Xp.shape[0]) for Xp, _ in parts]
        self.n = sum(sizes)
        self.d = d
        self.num_workers = len(parts)
        self.partition_cum: List[int] = [0] + [int(c) for c in np.cumsum(sizes)]
        self.shards: Dict[int, Shard] = {}
        for w, (Xp, yp) in enumerate(parts):
            dev = devs[w % len(devs)]
            # torch.tensor copies: a shard never aliases the caller's array
            Xs = torch.tensor(np.asarray(Xp, np.float32), device=dev)
            if dtype is not None:
                Xs = Xs.to(dtype)  # cast on device: bf16 storage
            ys = torch.tensor(np.asarray(yp, np.float32), device=dev)
            self.shards[w] = Shard(
                worker_id=w, X=Xs, y=ys,
                start=self.partition_cum[w], size=sizes[w],
            )

    @classmethod
    def generate_on_device(
        cls,
        n: int,
        d: int,
        num_workers: int,
        devices: Optional[Sequence] = None,
        seed: int = 42,
        noise: float = 0.01,
        dtype: torch.dtype = torch.float32,
    ) -> "ShardedDataset":
        """Synthesize a planted least-squares problem directly in device
        memory: rows ~ N(0, I/d) drawn in ``dtype`` on each shard's device
        (a bf16 shard never exists in f32), labels ``X w_true + noise * e``
        computed from the stored rows with f32 accumulation (``mm_f32``),
        so the planted noise floor stays ``noise**2``.  No host copy exists
        (:meth:`global_arrays` raises)."""
        devs = resolve_devices(devices)
        obj = cls.__new__(cls)
        sizes = balanced_sizes(n, num_workers)
        obj.n, obj.d, obj.num_workers = n, d, num_workers
        obj.partition_cum = [0] + [int(c) for c in np.cumsum(sizes)]
        root = fold_in(seed, _DATA_DOMAIN)
        gen = torch.Generator(device=devs[0])
        gen.manual_seed(fold_in(root, 2**30))
        w_true = torch.randn(d, generator=gen, device=devs[0])
        obj.shards = {}
        for w in range(num_workers):
            dev = devs[w % len(devs)]
            gen = torch.Generator(device=dev)
            gen.manual_seed(fold_in(root, w))
            Xp = torch.randn(sizes[w], d, generator=gen, device=dev, dtype=dtype)
            Xp /= math.sqrt(d)
            yp = mm_f32(Xp, w_true.to(dev)) + noise * torch.randn(
                sizes[w], generator=gen, device=dev
            )
            obj.shards[w] = Shard(
                worker_id=w, X=Xp, y=yp,
                start=obj.partition_cum[w], size=sizes[w],
            )
        obj._host_X = obj._host_y = None
        return obj

    # ------------------------------------------------------------------ views
    def shard(self, worker_id: int) -> Shard:
        return self.shards[worker_id]

    def partition_sizes(self) -> Dict[int, int]:
        """Parity: the drivers' ``partitonInfo`` balance check."""
        return {w: s.size for w, s in self.shards.items()}

    def global_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the arrays the dataset was built from."""
        if self._host_X is None:
            raise ValueError(
                "dataset has no host copy (generated on device or built "
                "from shards); use the per-shard device tensors instead"
            )
        return self._host_X, self._host_y

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ShardedDataset(n={self.n}, d={self.d}, "
            f"workers={self.num_workers})"
        )

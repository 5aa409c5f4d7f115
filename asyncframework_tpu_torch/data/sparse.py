"""Sparse (rcv1-class) device-resident sharded dataset in padded ELL.

Counterpart of ``asyncframework_tpu/data/sparse.py``.  The reference loads
rcv1_full.binary (47,236 features, ~0.16% dense) through
``MLUtils.loadLibSVMFile`` into sparse vectors and runs the same ASGD/ASAGA
recipes on it.  Densifying rcv1 is out of the question (697k x 47k f32 is
131 GB), so each shard is stored as **padded ELL**: per-row fixed-width
``cols (n_p, K)`` int32 / ``vals (n_p, K)`` f32, ``K`` the shard's largest
row nnz rounded up to a multiple of 8; padding entries are ``col=0,
val=0`` and contribute exactly zero to every product.  The worker step
(``ops/sparse_grad.py``) then needs no ragged shapes:

- residual: ``r_i = sum_k vals[i,k] * w[cols[i,k]] - y_i`` (a gather);
- gradient: ``g[c] = sum of vals[i,k] * coeff_i over cols[i,k] == c`` (a
  deterministic segment sum).

Only the ``(d,)`` gradient is dense, which the updater needs dense anyway.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.data.sharded import balanced_sizes
from asyncframework_tpu_torch.ops.sampling import fold_in
from asyncframework_tpu_torch.utils.devices import resolve_devices

#: domain separation of the sparse data stream ("SPRS")
_SPARSE_DOMAIN = 0x53505253


def _round_up(k: int, mult: int = 8) -> int:
    return max(mult, ((k + mult - 1) // mult) * mult)


@dataclass
class SparseShard:
    worker_id: int
    cols: torch.Tensor  # (n_p, K) int32, padded with 0
    vals: torch.Tensor  # (n_p, K) f32, padded with 0.0
    y: torch.Tensor     # (n_p,) f32
    start: int
    size: int

    @property
    def device(self) -> torch.device:
        return self.vals.device


class SparseShardedDataset:
    """Immutable row-sharded CSR data in padded-ELL device residency.

    ``SparseShardedDataset(indptr, indices, values, y, d, num_workers,
    devices)`` packs host CSR triplets; ``devices=None`` means every CUDA
    device and raises without one.
    """

    is_sparse = True

    #: warn when a shard's padded footprint exceeds its true nnz by this
    #: factor AND the max/mean row-nnz ratio exceeds SKEW_RATIO_WARN -- one
    #: dense outlier row multiplies the whole shard's memory under padded ELL
    PAD_OVERHEAD_WARN = 4.0
    SKEW_RATIO_WARN = 8.0

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        values: np.ndarray,
        y: np.ndarray,
        d: int,
        num_workers: int,
        devices: Optional[Sequence] = None,
        nnz_partition: bool = False,
    ):
        """``nnz_partition=True`` assigns rows to shards in row-nnz-sorted
        order (a stable permutation, recorded in ``row_perm``) so each
        shard's pad width tracks its own densest row instead of the global
        outlier -- the skew guard's fix.  ``start``/``partition_cum`` then
        index the permuted order, and shard ``j``'s original row id is
        ``row_perm[start + j]``.  Without it, a skewed matrix still loads
        but emits a warning (see :meth:`skew_report`).  Column indices
        outside ``[0, d)`` raise ``ValueError``: the kernels index the
        model with them."""
        n = len(indptr) - 1
        if y.shape[0] != n:
            raise ValueError(f"indptr implies {n} rows but y has {y.shape[0]}")
        devs = resolve_devices(devices)
        self.n, self.d, self.num_workers = n, int(d), num_workers
        sizes = balanced_sizes(n, num_workers)
        cum = np.concatenate([[0], np.cumsum(sizes)])
        self.partition_cum: List[int] = [int(c) for c in cum]
        self.shards: Dict[int, SparseShard] = {}
        indptr = np.asarray(indptr, np.int64)
        used = np.asarray(indices[:indptr[-1]])
        if used.size and (used.min() < 0 or used.max() >= self.d):
            raise ValueError(
                f"column indices span [{used.min()}, {used.max()}], outside "
                f"[0, {self.d})"
            )
        all_nnz = indptr[1:] - indptr[:-1]
        if nnz_partition:
            self.row_perm = np.argsort(all_nnz, kind="stable")
        else:
            self.row_perm = np.arange(n)
        y = np.asarray(y, np.float32)
        for w in range(num_workers):
            lo, hi = self.partition_cum[w], self.partition_cum[w + 1]
            rows = self.row_perm[lo:hi]
            row_nnz = all_nnz[rows]
            K = _round_up(int(row_nnz.max()) if len(row_nnz) else 1)
            size = hi - lo
            cols = np.zeros((size, K), np.int32)
            vals = np.zeros((size, K), np.float32)
            # vectorised CSR -> ELL packing: the shard's j-th nonzero comes
            # from source position indptr[row]+slot and lands at (row, slot)
            total = int(row_nnz.sum())
            if total > 0:
                dst_rows = np.repeat(np.arange(size), row_nnz)
                slots = np.arange(total) - np.repeat(
                    np.cumsum(row_nnz) - row_nnz, row_nnz
                )
                src = np.repeat(indptr[rows], row_nnz) + slots
                cols[dst_rows, slots] = indices[src]
                vals[dst_rows, slots] = values[src]
            self.shards[w] = self._shard(w, cols, vals, y[rows],
                                         devs[w % len(devs)])
        # the guard only suggests nnz_partition when it is off; with it on,
        # residual padding is inherent and re-warning would be noise
        if not nnz_partition:
            self._maybe_warn_skew(all_nnz)

    def _shard(self, w, cols, vals, y, dev) -> SparseShard:
        # torch.tensor copies: a shard never aliases the caller's arrays
        return SparseShard(
            worker_id=w,
            cols=torch.tensor(np.asarray(cols, np.int32), device=dev),
            vals=torch.tensor(np.asarray(vals, np.float32), device=dev),
            y=torch.tensor(np.asarray(y, np.float32), device=dev),
            start=self.partition_cum[w],
            size=int(len(y)),
        )

    @classmethod
    def from_shards(
        cls,
        shards: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        d: int,
        devices: Optional[Sequence] = None,
        row_perm: Optional[np.ndarray] = None,
    ) -> "SparseShardedDataset":
        """A dataset from per-worker host ``(cols, vals, y)`` padded-ELL
        shards, in worker order (e.g. another package's shards taken out as
        numpy); ``row_perm`` defaults to the identity."""
        devs = resolve_devices(devices)
        obj = cls.__new__(cls)
        sizes = [int(len(y)) for _c, _v, y in shards]
        obj.n, obj.d, obj.num_workers = sum(sizes), int(d), len(shards)
        obj.partition_cum = [0] + [int(c) for c in np.cumsum(sizes)]
        obj.row_perm = (np.arange(obj.n) if row_perm is None
                        else np.asarray(row_perm))
        obj.shards = {
            w: obj._shard(w, cols, vals, y, devs[w % len(devs)])
            for w, (cols, vals, y) in enumerate(shards)
        }
        return obj

    @classmethod
    def generate_on_device(
        cls,
        n: int,
        d: int,
        nnz_per_row: int,
        num_workers: int,
        devices: Optional[Sequence] = None,
        seed: int = 42,
        noise: float = 0.01,
    ) -> "SparseShardedDataset":
        """Synthesize a planted rcv1-shaped sparse problem directly in
        device memory.

        Each row has ``nnz_per_row`` entries at uniform random columns with
        values N(0, 1/nnz), so ``E[x x^T] = I/d`` -- the same conditioning
        as the dense generator.  Labels are ``x . w* + noise * e``, computed
        on the device.  Rows are padded to a multiple of 8 like the CSR
        path; padding slots carry ``col=0, val=0``.  Drawn from
        ``torch.Generator``s: the recipe of the JAX package, not its bits.
        """
        devs = resolve_devices(devices)
        obj = cls.__new__(cls)
        sizes = balanced_sizes(n, num_workers)
        obj.n, obj.d, obj.num_workers = n, int(d), num_workers
        obj.partition_cum = [0] + [int(c) for c in np.cumsum(sizes)]
        obj.row_perm = np.arange(n)
        nnz = int(nnz_per_row)
        K = _round_up(nnz)
        root = fold_in(seed, _SPARSE_DOMAIN)
        gen = torch.Generator(device=devs[0])
        gen.manual_seed(fold_in(root, 2**30))
        w_true = torch.randn(d, generator=gen, device=devs[0])
        obj.shards = {}
        for w in range(num_workers):
            dev = devs[w % len(devs)]
            gen = torch.Generator(device=dev)
            gen.manual_seed(fold_in(root, w))
            cols = torch.randint(0, d, (sizes[w], K), generator=gen,
                                 device=dev, dtype=torch.int32)
            vals = torch.randn(sizes[w], K, generator=gen, device=dev)
            vals /= math.sqrt(float(nnz))
            cols[:, nnz:] = 0
            vals[:, nnz:] = 0.0
            wt = w_true.to(dev)
            yp = (vals * wt[cols.long()]).sum(dim=1) + noise * torch.randn(
                sizes[w], generator=gen, device=dev
            )
            obj.shards[w] = SparseShard(
                worker_id=w, cols=cols, vals=vals, y=yp,
                start=obj.partition_cum[w], size=sizes[w],
            )
        return obj

    # ----------------------------------------------------------- skew guard
    def skew_report(self) -> Dict[str, float]:
        """Padding-cost accounting: the true nnz, what padded ELL actually
        occupies, and the worst per-shard max/mean row-nnz ratio (row nnz
        counted on each shard's device)."""
        true_nnz = 0
        padded = 0
        worst_ratio = 0.0
        for s in self.shards.values():
            row_nnz = (s.vals != 0).sum(dim=1)
            true_nnz += int(row_nnz.sum())
            padded += s.vals.numel()
            mean = max(float(row_nnz.double().mean()), 1e-9)
            worst_ratio = max(worst_ratio, float(row_nnz.max()) / mean)
        return {
            "nnz": true_nnz,
            "padded_nnz": padded,
            "pad_overhead": padded / max(true_nnz, 1),
            "worst_shard_skew": worst_ratio,
        }

    def _maybe_warn_skew(self, all_nnz: np.ndarray) -> None:
        """Real rcv1-class data is skewed: one dense row pads the whole
        shard to its width.  Computed from the host CSR's row counts."""
        padded = self.padded_nnz()
        true_nnz = max(int(all_nnz.sum()), 1)
        overhead = padded / true_nnz
        mean = max(float(all_nnz.mean()), 1e-9)
        skew = float(all_nnz.max()) / mean
        if overhead > self.PAD_OVERHEAD_WARN and skew > self.SKEW_RATIO_WARN:
            warnings.warn(
                f"padded-ELL overhead {overhead:.1f}x true nnz (max/mean "
                f"row nnz = {skew:.1f}): a few dense rows are inflating "
                f"every shard's pad width; rebuild with nnz_partition=True "
                f"to bound padding per shard",
                RuntimeWarning,
                stacklevel=3,
            )

    # ------------------------------------------------------------------ views
    def shard(self, worker_id: int) -> SparseShard:
        return self.shards[worker_id]

    def partition_sizes(self) -> Dict[int, int]:
        return {w: s.size for w, s in self.shards.items()}

    def nnz(self) -> int:
        """True non-padding entries across all shards (padding occupies
        memory too: see :meth:`padded_nnz`)."""
        return sum(int((s.vals != 0).sum()) for s in self.shards.values())

    def padded_nnz(self) -> int:
        return sum(s.vals.numel() for s in self.shards.values())

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"SparseShardedDataset(n={self.n}, d={self.d}, "
            f"workers={self.num_workers})"
        )


def densify(ds: SparseShardedDataset) -> Tuple[np.ndarray, np.ndarray]:
    """Small-fixture helper (tests): padded ELL -> dense host ``(X, y)``.

    Rows come back in shard order (the dataset's own ordering): under
    ``nnz_partition`` that is the permuted order, with original row ids in
    ``ds.row_perm``."""
    X = np.zeros((ds.n, ds.d), np.float32)
    ys = []
    for w in range(ds.num_workers):
        s = ds.shard(w)
        cols = s.cols.cpu().numpy()
        vals = s.vals.cpu().numpy()
        rows = np.repeat(np.arange(s.start, s.start + s.size), cols.shape[1])
        # unbuffered accumulate: fancy += would drop duplicate indices
        # (padding shares col 0 with real entries)
        np.add.at(X, (rows, cols.ravel()), vals.ravel())
        ys.append(s.y.cpu().numpy())
    return X, np.concatenate(ys)

"""Distributed matrices: RowMatrix, IndexedRowMatrix, CoordinateMatrix,
BlockMatrix.

Counterpart of ``asyncframework_tpu/ml/linalg_distributed.py`` (parity:
``mllib/.../linalg/distributed/RowMatrix.scala`` -- computeGramianMatrix,
computeSVD :493, computeCovariance, computeColumnSummaryStatistics,
columnSimilarities, tallSkinnyQR -- ``IndexedRowMatrix.scala``,
``CoordinateMatrix.scala``, ``BlockMatrix.scala``):

- a ``RowMatrix`` holds its rows as one tensor; with a mesh every
  aggregate is one product a rank over its row block (``shard_batch``),
  folded in rank order over the mesh's axis, and a product's result is
  gathered back on the first rank's device;
- ``tall_skinny_qr`` is the two-stage TSQR: a QR of each rank's block,
  then one QR of the stacked R factors, and ``Q = Q_local Q2_p``;
- ``BlockMatrix`` keeps a grid of dense blocks placed round-robin over
  devices; ``multiply`` is the blocked SUMMA loop, a product a term.

Without a mesh or a device a matrix lives on the CUDA device (raises
without one).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.ml.decomposition import (
    PCA,
    _blocks,
    _gram_and_mean,
    _rows_times,
    svd as _svd,
)
from asyncframework_tpu_torch.ml.stat import ColStats, col_stats, on_device
from asyncframework_tpu_torch.utils.devices import resolve_devices


def _signed_qr(A: torch.Tensor):
    """QR with R's diagonal made non-negative (deterministic factors)."""
    q, r = torch.linalg.qr(A)
    diag = torch.diag(r)
    sign = torch.sign(torch.where(diag == 0, torch.ones_like(diag), diag))
    return q * sign[None, :], r * sign[:, None]


class RowMatrix:
    """A row-oriented distributed matrix; rows split over ``mesh``'s
    ``axis`` when one is given, else on ``device``."""

    def __init__(self, X, mesh=None, axis: str = "dp", device=None):
        if mesh is not None and device is None:
            device = mesh.devices[mesh.local_ranks()[0]]
        self.X = on_device(X, device)
        if self.X.ndim != 2:
            raise ValueError("RowMatrix requires a 2-d array")
        self.mesh = mesh
        self.axis = axis

    # ------------------------------------------------------------ shape
    def num_rows(self) -> int:
        return int(self.X.shape[0])

    def num_cols(self) -> int:
        return int(self.X.shape[1])

    # ------------------------------------------------------ aggregates
    def compute_gramian(self) -> torch.Tensor:
        """A^T A, folded over the mesh (computeGramianMatrix)."""
        return _gram_and_mean(self.X, self.mesh, self.axis,
                              self.X.device)[1]

    def compute_column_summary_statistics(self) -> ColStats:
        return col_stats(self.X, self.mesh, self.axis, self.X.device)

    def compute_covariance(self) -> torch.Tensor:
        n, gram, colsum = _gram_and_mean(self.X, self.mesh, self.axis,
                                         self.X.device)
        mean = colsum / n
        return (gram - n * torch.outer(mean, mean)) / max(n - 1, 1)

    def compute_svd(self, k: int, compute_u: bool = True,
                    rcond: float = 1e-3):
        """Truncated SVD via the gram matrix (RowMatrix.computeSVD:493)."""
        return _svd(self.X, k, self.mesh, self.axis, compute_u=compute_u,
                    rcond=rcond, device=self.X.device)

    def compute_principal_components(self, k: int) -> np.ndarray:
        return PCA(k).fit(self.X, self.mesh, self.axis,
                          self.X.device).components

    # ------------------------------------------------------------ products
    def multiply(self, B) -> "RowMatrix":
        """A @ B with B (d, m) on every rank; the result keeps the mesh."""
        Bt = on_device(B, self.X.device)
        return RowMatrix(_rows_times(self.X, Bt, self.mesh, self.axis,
                                     self.X.device),
                         self.mesh, self.axis, self.X.device)

    def column_similarities(self) -> torch.Tensor:
        """Cosine similarity between columns; the exact upper-triangular
        (i < j) matrix, zero elsewhere (columnSimilarities parity)."""
        gram = self.compute_gramian()
        norms = torch.sqrt(torch.clamp_min(torch.diag(gram), 1e-30))
        sims = gram / torch.outer(norms, norms)
        return torch.triu(sims, diagonal=1)

    def tall_skinny_qr(self) -> Tuple["RowMatrix", torch.Tensor]:
        """TSQR: A = Q R with Q a RowMatrix, R (d, d) upper-triangular
        with a non-negative diagonal.

        Stage 1 QR-factors each rank's row block; stage 2 factors the P
        stacked R factors ((P d, d)); ``Q = Q_local @ Q2_p``, one more
        product a rank."""
        d = self.num_cols()
        if self.num_rows() < d:
            raise ValueError("tallSkinnyQR requires n >= d")
        parts = self.mesh.shape[self.axis] if self.mesh is not None else 1
        if self.mesh is None or self.X.shape[0] // parts < d:
            # no mesh, or fewer local rows than columns (a local QR would
            # be rank-starved): one factorization of every row
            q, r = _signed_qr(self.X)
            return RowMatrix(q, self.mesh, self.axis, self.X.device), r
        dev = self.X.device
        blocks = _blocks(self.X, self.mesh, self.axis)
        seen, local_qs, rs = set(), [], []
        for r_, b in enumerate(blocks):
            i = self.mesh.coords(r_)[self.axis]
            if b is None or i in seen:
                continue
            seen.add(i)
            q1, r1 = torch.linalg.qr(b)
            local_qs.append(q1)
            rs.append(r1.to(dev))
        q2, R = _signed_qr(torch.cat(rs))
        Q = torch.cat([(q1 @ q2[i * d:(i + 1) * d].to(q1.device)).to(dev)
                       for i, q1 in enumerate(local_qs)])
        return RowMatrix(Q, self.mesh, self.axis, dev), R


class IndexedRowMatrix:
    """Rows tagged with long indices (IndexedRowMatrix.scala parity)."""

    def __init__(self, indices, X, mesh=None, axis: str = "dp",
                 device=None):
        self.indices = np.asarray(indices, np.int64)
        if mesh is not None and device is None:
            device = mesh.devices[mesh.local_ranks()[0]]
        self.X = on_device(X, device)
        if self.indices.shape[0] != self.X.shape[0]:
            raise ValueError("one index per row required")
        self.mesh = mesh
        self.axis = axis

    def num_rows(self) -> int:
        return int(self.indices.max()) + 1 if self.indices.size else 0

    def num_cols(self) -> int:
        return int(self.X.shape[1])

    def to_row_matrix(self) -> RowMatrix:
        return RowMatrix(self.X, self.mesh, self.axis, self.X.device)

    def to_coordinate_matrix(self) -> "CoordinateMatrix":
        Xh = self.X.cpu().numpy()
        r, c = np.nonzero(Xh)
        return CoordinateMatrix(
            self.indices[r], c.astype(np.int64), Xh[r, c],
            shape=(self.num_rows(), self.num_cols()), device=self.X.device,
        )

    def compute_svd(self, k: int, compute_u: bool = True):
        return self.to_row_matrix().compute_svd(k, compute_u=compute_u)

    def multiply(self, B) -> "IndexedRowMatrix":
        return IndexedRowMatrix(
            self.indices, self.to_row_matrix().multiply(B).X,
            self.mesh, self.axis, self.X.device,
        )


class CoordinateMatrix:
    """COO-format distributed matrix (CoordinateMatrix.scala parity)."""

    def __init__(self, rows, cols, values, shape: Tuple[int, int],
                 device=None):
        self.rows = np.asarray(rows, np.int64)
        self.cols = np.asarray(cols, np.int64)
        self.values = np.asarray(values, np.float32)
        if not (self.rows.shape == self.cols.shape == self.values.shape):
            raise ValueError("rows/cols/values must align")
        self.shape = (int(shape[0]), int(shape[1]))
        self.device = resolve_devices(None if device is None
                                      else [device])[0]

    def num_rows(self) -> int:
        return self.shape[0]

    def num_cols(self) -> int:
        return self.shape[1]

    def transpose(self) -> "CoordinateMatrix":
        return CoordinateMatrix(
            self.cols, self.rows, self.values,
            (self.shape[1], self.shape[0]), self.device,
        )

    def to_local(self) -> torch.Tensor:
        """Densify on the device: one accumulating scatter (duplicate
        entries sum, the reference's toBlockMatrix behavior)."""
        dense = torch.zeros(self.shape, dtype=torch.float32,
                            device=self.device)
        index = (torch.from_numpy(self.rows).to(self.device),
                 torch.from_numpy(self.cols).to(self.device))
        return dense.index_put_(index,
                                torch.from_numpy(self.values).to(self.device),
                                accumulate=True)

    def to_row_matrix(self, mesh=None, axis: str = "dp") -> RowMatrix:
        return RowMatrix(self.to_local(), mesh, axis, self.device)

    def to_indexed_row_matrix(self) -> IndexedRowMatrix:
        return IndexedRowMatrix(np.arange(self.shape[0]), self.to_local(),
                                device=self.device)

    def to_block_matrix(self, block_size: int = 1024) -> "BlockMatrix":
        return BlockMatrix.from_dense(self.to_local(), block_size=block_size,
                                      devices=[self.device])


class BlockMatrix:
    """Grid of dense blocks, each on a device (round-robin).

    ``multiply`` is the blocked SUMMA loop: C[i,j] = sum_k A[i,k] B[k,j],
    one product a term (BlockMatrix.scala multiply parity; the reference's
    simulateMultiply and shuffle plan become device placement)."""

    def __init__(
        self,
        blocks: Dict[Tuple[int, int], torch.Tensor],
        shape: Tuple[int, int],
        block_size: int,
    ):
        self.blocks = blocks
        self.shape = (int(shape[0]), int(shape[1]))
        self.block_size = int(block_size)
        self.grid = (
            -(-self.shape[0] // self.block_size),
            -(-self.shape[1] // self.block_size),
        )

    @classmethod
    def from_dense(cls, A, block_size: int = 1024,
                   devices=None) -> "BlockMatrix":
        """``devices`` defaults to every CUDA device (raises without
        one)."""
        devs = resolve_devices(devices)
        A = on_device(A, devs[0])
        n, m = A.shape
        gr = -(-n // block_size)
        gc = -(-m // block_size)
        blocks: Dict[Tuple[int, int], torch.Tensor] = {}
        for i in range(gr):
            for j in range(gc):
                blk = A[
                    i * block_size: min((i + 1) * block_size, n),
                    j * block_size: min((j + 1) * block_size, m),
                ]
                dev = devs[(i * gc + j) % len(devs)]
                blocks[(i, j)] = blk.to(dev).contiguous()
        return cls(blocks, (n, m), block_size)

    def to_local(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        bs = self.block_size
        for (i, j), blk in self.blocks.items():
            b = blk.cpu().numpy()
            out[i * bs: i * bs + b.shape[0], j * bs: j * bs + b.shape[1]] = b
        return out

    def transpose(self) -> "BlockMatrix":
        return BlockMatrix(
            {(j, i): blk.T for (i, j), blk in self.blocks.items()},
            (self.shape[1], self.shape[0]),
            self.block_size,
        )

    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        if self.shape != other.shape or self.block_size != other.block_size:
            raise ValueError("add requires identical shape and block size")
        out = {}
        for key in set(self.blocks) | set(other.blocks):
            a = self.blocks.get(key)
            b = other.blocks.get(key)
            if a is not None and b is not None:
                out[key] = a + b.to(a.device)
            else:
                out[key] = a if a is not None else b
        return BlockMatrix(out, self.shape, self.block_size)

    def multiply(self, other: "BlockMatrix") -> "BlockMatrix":
        if self.shape[1] != other.shape[0]:
            raise ValueError(
                f"inner dims mismatch: {self.shape} x {other.shape}"
            )
        if self.block_size != other.block_size:
            raise ValueError("multiply requires matching block size")
        gr, gk = self.grid
        _, gc = other.grid
        out: Dict[Tuple[int, int], torch.Tensor] = {}
        for i in range(gr):
            for j in range(gc):
                acc = None
                for k in range(gk):
                    a = self.blocks.get((i, k))
                    b = other.blocks.get((k, j))
                    if a is None or b is None:
                        continue
                    # the term on A's block's device; C[i,j] accumulates
                    # on its first term's
                    term = a @ b.to(a.device)
                    acc = term if acc is None else acc + term.to(acc.device)
                if acc is not None:
                    out[(i, j)] = acc
        return BlockMatrix(out, (self.shape[0], other.shape[1]),
                           self.block_size)

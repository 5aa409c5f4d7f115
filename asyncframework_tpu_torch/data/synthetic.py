"""Synthetic dataset generators shaped like the reference's workloads.

Counterpart of ``asyncframework_tpu/data/synthetic.py`` (a copy: numpy
only, so both packages make the same arrays from the same seed).  The
reference benchmarks on mnist8m.scale (8.1M x 784), epsilon (400k x 2000,
dense) and rcv1_full.binary (~697k x 47,236, ~0.16% dense); without the
files, tests and tools use these seeded stand-ins of the same shapes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_regression(
    n: int, d: int, seed: int = 42, noise: float = 0.01, dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense least-squares problem: returns (X, y, w_true)."""
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(dtype) / np.sqrt(d)
    w_true = rs.normal(size=(d,)).astype(dtype)
    y = (X @ w_true + noise * rs.normal(size=(n,))).astype(dtype)
    return X, y, w_true


def make_classification(
    n: int, d: int, seed: int = 42, dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary {0,1} logistic problem: returns (X, y, w_true)."""
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(dtype) / np.sqrt(d)
    w_true = rs.normal(size=(d,)).astype(dtype)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rs.random(n) < p).astype(dtype)
    return X, y, w_true


def make_sparse_regression(
    n: int, d: int, density: float = 0.002, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """rcv1-like sparse problem in CSR triplets: (indptr, indices, values, y)."""
    rs = np.random.default_rng(seed)
    nnz_per_row = max(1, int(density * d))
    indptr = np.arange(0, (n + 1) * nnz_per_row, nnz_per_row, dtype=np.int32)
    indices = np.empty(n * nnz_per_row, np.int32)
    for i in range(n):
        indices[i * nnz_per_row : (i + 1) * nnz_per_row] = rs.choice(
            d, nnz_per_row, replace=False
        )
    values = rs.normal(size=n * nnz_per_row).astype(np.float32)
    w_true = rs.normal(size=(d,)).astype(np.float32)
    y = np.empty(n, np.float32)
    for i in range(n):
        cols = indices[indptr[i] : indptr[i + 1]]
        vals = values[indptr[i] : indptr[i + 1]]
        y[i] = vals @ w_true[cols]
    return indptr, indices, values, y

"""LibSVM-format data loading (pure Python and numpy).

Counterpart of ``asyncframework_tpu/data/libsvm.py`` (``MLUtils.loadLibSVMFile``
parity: lines of ``label idx:val idx:val ...`` with 1-based indices, the
input format of every reference experiment: mnist8m.scale, epsilon, rcv1).
A copy of its line parsers and loaders; the C++ fast path for dense loads
(``native/libsvm_parser.cc``) is not ported yet, so :func:`load_libsvm`
always parses in Python.  The sparse path (``as_sparse`` in the reference's
terms: :func:`load_libsvm_sparse`) never used it.

Dense output is ``(X, y)`` float32; sparse output is CSR triplets
``(indptr, indices, values, y)`` for
:class:`~asyncframework_tpu_torch.data.sparse.SparseShardedDataset`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def parse_libsvm_lines(
    lines, num_features: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an iterable of LibSVM text lines to dense ``(X, y)``."""
    labels = []
    rows = []  # list of (idx_array, val_array)
    max_idx = 0
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        idxs = np.empty(len(parts) - 1, np.int64)
        vals = np.empty(len(parts) - 1, np.float32)
        for j, tok in enumerate(parts[1:]):
            k, v = tok.split(":")
            idxs[j] = int(k)
            vals[j] = float(v)
        if len(idxs) and idxs[-1] > max_idx:
            max_idx = int(idxs[-1])
        rows.append((idxs, vals))
    d = num_features if num_features is not None else max_idx
    X = np.zeros((len(rows), d), np.float32)
    for i, (idxs, vals) in enumerate(rows):
        X[i, idxs - 1] = vals  # libsvm indices are 1-based
    return X, np.asarray(labels, np.float32)


def parse_libsvm_lines_sparse(
    lines, num_features: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse LibSVM text to CSR triplets ``(indptr, indices, values, y)``
    with 0-based ``indices`` -- the rcv1-class path that must never densify
    (47k-dim rcv1 would be 131 GB dense)."""
    labels = []
    indptr = [0]
    indices: list = []
    values: list = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        for tok in parts[1:]:
            k, v = tok.split(":")
            ki = int(k)
            if ki < 1 or (num_features is not None and ki > num_features):
                # must fail here: the kernels index the model with these
                raise ValueError(
                    f"libsvm feature index {ki} out of range "
                    f"[1, {num_features}]"
                )
            indices.append(ki - 1)  # libsvm is 1-based
            values.append(float(v))
        indptr.append(len(indices))
    return (
        np.asarray(indptr, np.int64),
        np.asarray(indices, np.int32),
        np.asarray(values, np.float32),
        np.asarray(labels, np.float32),
    )


def load_libsvm_sparse(
    path: str, num_features: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load a LibSVM file as CSR triplets (see
    :func:`parse_libsvm_lines_sparse`)."""
    with open(path, "r") as f:
        return parse_libsvm_lines_sparse(f, num_features)


def load_libsvm(
    path: str, num_features: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Load a LibSVM file to dense ``(X, y)``."""
    with open(path, "r") as f:
        return parse_libsvm_lines(f, num_features)

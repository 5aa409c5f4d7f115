"""LibSVM-format data loading.

Counterpart of ``asyncframework_tpu/data/libsvm.py`` (``MLUtils.loadLibSVMFile``
parity: lines of ``label idx:val idx:val ...`` with 1-based indices, the
input format of every reference experiment: mnist8m.scale, epsilon, rcv1).
A copy of its line parsers and loaders, and of its two dense paths:

- the C++ parser (``native/libsvm_parser.cc``), built from source by
  ``native_build.py`` into ``_build/native/`` at first use and loaded with
  ctypes: one pass over the file's bytes into the dense row-major matrix;
- the line parser (:func:`parse_libsvm_lines`), its one fallback and its
  oracle.  Each dense load counts which ran (``native_calls.libsvm`` or
  ``python_calls.libsvm`` in ``native_build.native_totals()``), and a load
  that wanted the C++ parser but had no library counts a
  ``python_fallbacks`` too, as the wire's codecs do.

The sparse path (:func:`load_libsvm_sparse`) always parses in Python, as
the reference's does.  Dense output is ``(X, y)`` float32; sparse output is
CSR triplets ``(indptr, indices, values, y)`` for
:class:`~asyncframework_tpu_torch.data.sparse.SparseShardedDataset`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from asyncframework_tpu_torch import native_build

#: native symbol -> pure-Python twin (native-oracle lint contract).
#: Both native symbols serve one dense-load fast path whose single
#: fallback is the line parser.
NATIVE_ORACLES = {
    "parse_libsvm_dense": "parse_libsvm_lines",
    "count_lines": "parse_libsvm_lines",
}

_NATIVE = None
_NATIVE_LOCK = threading.Lock()


def _native_lib():
    """The C++ parser built from ``native/libsvm_parser.cc`` into the
    port's build directory (never the ``native/*.so`` beside the source);
    None when it cannot be built or loaded."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is not None:
            return _NATIVE or None
        path = native_build.ensure_built("libsvm_parser")
        if path is None:
            _NATIVE = False
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _NATIVE = False
            return None
        lib.parse_libsvm_dense.restype = ctypes.c_longlong
        lib.parse_libsvm_dense.argtypes = [
            ctypes.c_char_p,   # buffer
            ctypes.c_longlong, # buffer len
            ctypes.c_longlong, # num features
            ctypes.POINTER(ctypes.c_float),  # X out (rows*d)
            ctypes.POINTER(ctypes.c_float),  # y out (rows)
            ctypes.c_longlong, # max rows
        ]
        lib.count_lines.restype = ctypes.c_longlong
        lib.count_lines.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        _NATIVE = lib
        return lib


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
    path: str,
    num_features: Optional[int] = None,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load a LibSVM file to dense ``(X, y)``; through the C++ parser when
    ``use_native`` and ``num_features`` are given (it cannot infer ``d``),
    else, or without its library (counted), through the line parser."""
    want = use_native and num_features is not None
    lib = _native_lib() if want else None
    if lib is not None:
        with open(path, "rb") as f:
            buf = f.read()
        n_rows = lib.count_lines(buf, len(buf))
        X = np.zeros((n_rows, num_features), np.float32)
        y = np.zeros((n_rows,), np.float32)
        parsed = lib.parse_libsvm_dense(
            buf,
            len(buf),
            num_features,
            X.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_rows,
        )
        native_build.bump_native("native_calls.libsvm")
        if parsed < 0:
            raise ValueError(f"native libsvm parse failed with code {parsed}")
        return X[:parsed], y[:parsed]
    if want:
        native_build.bump_native("python_fallbacks")
    native_build.bump_native("python_calls.libsvm")
    with open(path, "r") as f:
        return parse_libsvm_lines(f, num_features)

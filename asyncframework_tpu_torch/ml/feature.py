"""Feature transforms.

Counterpart of ``asyncframework_tpu/ml/feature.py`` (parity: MLlib
``feature/`` -- ``StandardScaler``, ``Normalizer``, ``MinMaxScaler``,
``HashingTF``, ``IDF``, ``ElementwiseProduct``, ``ChiSqSelector``).  The
scalers' fit statistics are the port's ``col_stats`` (one pass on a
device); every transform is elementwise on the device and hands the next
stage a tensor.  ``HashingTF`` hashes tokens on the host with
``data/pairs.py``'s ``portable_hash``, as the reference does, and lands
the count matrix on the device in one accumulating ``index_put_``;
``ChiSqSelector`` builds its small contingency tables on the host and
tests each with ``chi_sq_test_matrix``.

Every transformer and selector takes ``device`` (the CUDA device by
default; raises without one): its fit and transform run there, and a
transform returns a tensor on it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from asyncframework_tpu_torch.data.pairs import portable_hash
from asyncframework_tpu_torch.ml.stat import (
    chi_sq_test_matrix,
    col_stats,
    on_device,
)
from asyncframework_tpu_torch.utils.devices import resolve_devices


def host_array(X) -> np.ndarray:
    """``X`` (host array or tensor) as a numpy array on the host."""
    return X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


class StandardScaler:
    """(x - mean) / std per column; either part optional (MLlib flags)."""

    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 device=None):
        self.with_mean = with_mean
        self.with_std = with_std
        self.device = device
        self.mean_: Optional[np.ndarray] = None
        self.std_: Optional[np.ndarray] = None

    def fit(self, X) -> "StandardScaler":
        s = col_stats(X, device=self.device)
        self.mean_ = np.asarray(s.mean)
        # MLlib uses the corrected sample std
        self.std_ = np.sqrt(np.asarray(s.variance))
        return self

    def transform(self, X) -> torch.Tensor:
        if self.mean_ is None:
            raise RuntimeError("fit() before transform()")
        X = on_device(X, self.device)
        if self.with_mean:
            X = X - on_device(self.mean_, X.device)
        if self.with_std:
            X = X / on_device(np.where(self.std_ > 0, self.std_, 1.0),
                              X.device)
        return X

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)


class MinMaxScaler:
    """Scale columns to [lo, hi] from fitted per-column min/max."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0, device=None):
        if hi <= lo:
            raise ValueError("hi must exceed lo")
        self.lo = lo
        self.hi = hi
        self.device = device
        self.min_: Optional[np.ndarray] = None
        self.max_: Optional[np.ndarray] = None

    def fit(self, X) -> "MinMaxScaler":
        s = col_stats(X, device=self.device)
        self.min_ = np.asarray(s.min)
        self.max_ = np.asarray(s.max)
        return self

    def transform(self, X) -> torch.Tensor:
        if self.min_ is None:
            raise RuntimeError("fit() before transform()")
        X = on_device(X, self.device)
        rng = on_device(self.max_ - self.min_, X.device)
        unit = (X - on_device(self.min_, X.device)) / torch.where(
            rng > 0, rng, 1.0)
        # constant columns land mid-range, like MLlib
        unit = torch.where(rng > 0, unit, 0.5)
        return unit * (self.hi - self.lo) + self.lo

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)


class Normalizer:
    """Scale each row to unit p-norm (p in {1, 2, inf}); zero rows pass."""

    def __init__(self, p: float = 2.0, device=None):
        if p not in (1.0, 2.0, float("inf")):
            raise ValueError("p must be 1, 2, or inf")
        self.p = p
        self.device = device

    def transform(self, X) -> torch.Tensor:
        X = on_device(X, self.device)
        if self.p == 1.0:
            n = torch.sum(torch.abs(X), dim=1, keepdim=True)
        elif self.p == 2.0:
            n = torch.sqrt(torch.sum(X * X, dim=1, keepdim=True))
        else:
            n = torch.amax(torch.abs(X), dim=1, keepdim=True)
        return X / torch.where(n > 0, n, 1.0)


class HashingTF:
    """Term-frequency vectors by the hashing trick.

    Parity: ``mllib/.../feature/HashingTF.scala`` -- term -> bucket via a
    stable hash mod ``num_features``; a document's vector counts bucket
    hits.  Tokens hash on the host, each distinct string once a
    ``transform`` (other keys every time: keys of two types that compare
    equal may hash apart); the count matrix is one accumulating
    ``index_put_`` on ``device``.  Its counts are integers, exact in f32
    below 2^24.  After a ``transform``, ``last_run`` holds its token count
    and the seconds the host hashing took.
    """

    def __init__(self, num_features: int = 1 << 10, device=None):
        if num_features < 1:
            raise ValueError("num_features must be >= 1")
        self.num_features = num_features
        self.device = device
        self.last_run: dict = {}

    def indices(self, doc) -> np.ndarray:
        return np.asarray(
            [portable_hash(t) % self.num_features for t in doc], np.int32
        )

    def transform(self, docs) -> torch.Tensor:
        """docs: iterable of token iterables -> (n_docs, num_features)."""
        docs = [d if hasattr(d, "__len__") else list(d) for d in docs]
        dev = resolve_devices(None if self.device is None
                              else [self.device])[0]
        out = torch.zeros((len(docs), self.num_features), dtype=torch.float32,
                          device=dev)
        if not docs:
            # empty corpora flow through (filter-then-vectorize pipelines)
            return out
        buckets: dict = {}
        nf = self.num_features

        def bucket(t) -> int:
            if type(t) is not str:
                return portable_hash(t) % nf
            b = buckets.get(t)
            if b is None:
                b = buckets[t] = portable_hash(t) % nf
            return b

        t0 = time.perf_counter()
        cols = np.fromiter((bucket(t) for doc in docs for t in doc),
                           np.int64)
        self.last_run = {"tokens": len(cols),
                         "host_hash_s": time.perf_counter() - t0}
        rows = np.repeat(np.arange(len(docs)),
                         [len(doc) for doc in docs])
        out.index_put_((torch.from_numpy(rows).to(dev),
                        torch.from_numpy(cols).to(dev)),
                       torch.ones(len(cols), dtype=torch.float32, device=dev),
                       accumulate=True)
        return out


class IDFModel:
    def __init__(self, idf: torch.Tensor):
        self.idf = idf

    def transform(self, tf) -> torch.Tensor:
        return on_device(tf, self.idf.device) * self.idf[None, :]


class IDF:
    """Inverse document frequency (``mllib/.../feature/IDF.scala``):
    ``idf = log((n_docs + 1) / (df + 1))`` with ``min_doc_freq`` zeroing
    rare terms, fit as one device reduction over the TF matrix."""

    def __init__(self, min_doc_freq: int = 0, device=None):
        self.min_doc_freq = min_doc_freq
        self.device = device

    def fit(self, tf) -> IDFModel:
        tf = on_device(tf, self.device)
        n = tf.shape[0]
        df = torch.sum(tf > 0, dim=0).to(torch.float32)
        idf = torch.log((n + 1.0) / (df + 1.0))
        if self.min_doc_freq > 0:
            idf = torch.where(df >= self.min_doc_freq, idf, 0.0)
        return IDFModel(idf)


class ElementwiseProduct:
    """Hadamard scaling by a fixed weight vector.

    Parity: ``mllib/src/main/scala/org/apache/spark/mllib/feature/
    ElementwiseProduct.scala`` -- one broadcasted multiply on device.
    """

    def __init__(self, scaling_vector, device=None):
        self.scaling_vector = on_device(
            np.asarray(host_array(scaling_vector), np.float32), device)

    def transform(self, X) -> torch.Tensor:
        X = on_device(X, self.scaling_vector.device)
        w = self.scaling_vector
        return X * (w[None, :] if X.ndim == 2 else w)


class ChiSqSelectorModel:
    def __init__(self, selected: np.ndarray, device=None):
        self.selected = np.asarray(selected, np.int64)  # sorted feature ids
        self.device = device

    def transform(self, X) -> torch.Tensor:
        X = on_device(X, self.device)
        idx = torch.from_numpy(self.selected).to(X.device)
        return X[:, idx] if X.ndim == 2 else X[idx]


class ChiSqSelector:
    """Chi-squared feature selection for categorical features.

    Parity: ``mllib/src/main/scala/org/apache/spark/mllib/feature/
    ChiSqSelector.scala`` -- ranks features by the chi-squared test of
    independence against the label and keeps ``num_top_features`` (the
    reference's default selector type); selected indices are sorted so
    transformed columns keep their relative order.

    Contingency tables are tiny (distinct feature values x labels) and are
    built host-side; the chi-squared statistic itself is
    ``chi_sq_test_matrix`` on ``device``, which the fitted model's
    transform uses too.
    """

    def __init__(self, num_top_features: int = 50, device=None):
        if num_top_features < 1:
            raise ValueError("num_top_features must be >= 1")
        self.num_top_features = num_top_features
        self.device = device

    def fit(self, X, y) -> ChiSqSelectorModel:
        X = host_array(X)
        y = host_array(y)
        labels, li = np.unique(y, return_inverse=True)
        # rank by p-value, not raw statistic: features with different numbers
        # of distinct values have different degrees of freedom, and the
        # reference sorts (p-value, index) ascending (ChiSqSelector.scala)
        pvals = np.empty(X.shape[1])
        for j in range(X.shape[1]):
            vals, vi = np.unique(X[:, j], return_inverse=True)
            cont = np.zeros((len(vals), len(labels)), np.float64)
            np.add.at(cont, (vi, li), 1.0)
            pvals[j] = chi_sq_test_matrix(cont, device=self.device).p_value
        k = min(self.num_top_features, pvals.shape[0])
        top = np.argsort(pvals, kind="stable")[:k]
        return ChiSqSelectorModel(np.sort(top), device=self.device)

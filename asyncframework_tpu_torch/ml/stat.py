"""Column statistics, correlation, hypothesis tests and kernel density.

Counterpart of ``asyncframework_tpu/ml/stat.py`` (parity: MLlib ``stat/``
-- ``Statistics.colStats``' ``MultivariateStatisticalSummary``,
``Statistics.corr`` (Pearson, Spearman), ``ChiSqTest``,
``KolmogorovSmirnovTest``, ``KernelDensity``).  The column moments are one
pass a rank, folded over a mesh in rank order (the JAX package's ``psum``
and ``pmax``); Pearson is one centred Gram product and the density grid one
broadcast, on the device.  The host-side parts (Spearman's tie-averaged
ranks, the KS statistic and its series, the chi-square survival function)
are the JAX package's numpy code; the survival function is scipy's
``gammaincc`` in f64.

Every function that computes on a device takes ``device`` (the CUDA
device by default; raises without one) or a ``mesh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from asyncframework_tpu_torch.ops.collectives import psum_over_mesh
from asyncframework_tpu_torch.parallel.mesh import shard_batch
from asyncframework_tpu_torch.utils.devices import resolve_devices


def on_device(a, device, dtype=torch.float32) -> torch.Tensor:
    """``a`` (host array or tensor) as a ``dtype`` tensor on ``device``
    (the CUDA device when None; raises without one); a tensor already
    there is not copied."""
    dev = resolve_devices(None if device is None else [device])[0]
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype)


@dataclass(frozen=True)
class ColStats:
    """MultivariateStatisticalSummary parity (corrected sample variance)."""

    count: int
    mean: np.ndarray
    variance: np.ndarray
    num_nonzeros: np.ndarray
    max: np.ndarray
    min: np.ndarray


def _moments(X: torch.Tensor):
    return (torch.tensor(X.shape[0], device=X.device), X.sum(dim=0),
            (X * X).sum(dim=0), (X != 0).sum(dim=0), X.amax(dim=0),
            X.amin(dim=0))


def _fold(parts, mesh, op):
    """Rank-order fold of per-rank tensors with ``op`` (``torch.maximum``
    or ``torch.minimum``) onto the first local rank's device; across
    processes, then one ``all_reduce``."""
    local = mesh.local_ranks()
    dev = parts[local[0]].device
    acc = parts[local[0]]
    for r in local[1:]:
        acc = op(acc, parts[r].to(dev))
    if mesh.spans_processes():
        import torch.distributed as dist

        acc = acc.clone()
        dist.all_reduce(acc, op=(dist.ReduceOp.MAX if op is torch.maximum
                                 else dist.ReduceOp.MIN))
    return acc


def col_stats(X, mesh=None, axis: str = "dp", device=None) -> ColStats:
    """Column summary of ``X`` (n, d); with ``mesh``, X's rows split over
    ``axis`` (n must divide by its size) and the moments are folded over
    the ranks; else one pass on ``device``."""
    if mesh is None:
        n, s1, s2, nnz, mx, mn = _moments(on_device(X, device))
    else:
        Xt = (X.float() if isinstance(X, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(X, np.float32)))
        blocks = shard_batch(mesh, Xt, axis=axis)
        parts = [None if b is None else _moments(b) for b in blocks]
        home = mesh.local_ranks()[0]

        def column(k):
            return [None if p is None else p[k] for p in parts]

        n, s1, s2, nnz = (psum_over_mesh(column(k), mesh, axis)[home]
                          for k in range(4))
        mx = _fold(column(4), mesh, torch.maximum)
        mn = _fold(column(5), mesh, torch.minimum)
    n = int(n)
    mean = s1.cpu().numpy() / n
    # corrected sample variance from the moments
    var = (s2.cpu().numpy() - n * mean**2) / max(n - 1, 1)
    return ColStats(
        count=n,
        mean=mean,
        variance=np.maximum(var, 0.0),
        num_nonzeros=nnz.cpu().numpy(),
        max=mx.cpu().numpy(),
        min=mn.cpu().numpy(),
    )


def _pearson(X: torch.Tensor) -> torch.Tensor:
    Xc = X - X.mean(dim=0)
    cov = Xc.T @ Xc
    sd = torch.sqrt(torch.diag(cov))
    denom = torch.outer(sd, sd)
    return torch.where(denom > 0, cov / denom, torch.zeros_like(cov))


def _average_ranks(col: np.ndarray) -> np.ndarray:
    """Average ranks with tie handling (Spearman's requirement)."""
    order = np.argsort(col, kind="stable")
    ranks = np.empty(len(col), np.float64)
    sorted_vals = col[order]
    i = 0
    while i < len(col):
        j = i
        while j + 1 < len(col) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def corr(X, method: str = "pearson", device=None) -> np.ndarray:
    """(d, d) correlation matrix of the columns of ``X``.

    Pearson is one centred Gram product on ``device``; Spearman ranks on
    the host (tie-averaged ranks are data-dependent control flow), then
    takes Pearson of the ranks on ``device``, as the reference computes
    it."""
    if method == "pearson":
        return _pearson(on_device(X, device)).cpu().numpy()
    if method == "spearman":
        Xh = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
        R = np.column_stack(
            [_average_ranks(Xh[:, j]) for j in range(Xh.shape[1])]
        )
        return _pearson(on_device(R, device)).cpu().numpy()
    raise ValueError(f"unknown correlation method {method!r}")


@dataclass(frozen=True)
class ChiSqTestResult:
    """Parity: ``mllib/.../stat/test/ChiSqTest.scala`` result fields."""

    statistic: float
    degrees_of_freedom: int
    p_value: float
    method: str = "pearson"


def _chi2_sf(x: float, df: int) -> float:
    """Chi-square survival function = regularized UPPER incomplete gamma
    (gammaincc directly: ``1 - gammainc`` would lose every significant
    digit once p drops below float epsilon)."""
    from scipy.special import gammaincc

    if x <= 0:
        return 1.0
    return float(gammaincc(df / 2.0, x / 2.0))


def chi_sq_test(observed, expected=None, device=None) -> ChiSqTestResult:
    """Pearson goodness-of-fit test of an observed frequency vector against
    ``expected`` (uniform when omitted), like ``Statistics.chiSqTest(vec)``."""
    obs = on_device(observed, device)
    if obs.ndim != 1:
        raise ValueError("observed must be 1-d; use chi_sq_test_matrix")
    n = obs.shape[0]
    if expected is None:
        exp = torch.full((n,), 1.0, device=obs.device) * (torch.sum(obs) / n)
    else:
        exp = on_device(expected, obs.device)
        # scale expected to the observed total (reference semantics)
        exp = exp * (torch.sum(obs) / torch.sum(exp))
    if bool(torch.any(exp <= 0)):
        # the reference's ChiSqTest raises on non-positive expected
        # frequencies; silent inf/nan would poison downstream comparisons
        raise ValueError("chi_sq_test: expected frequencies must be > 0")
    stat = float(torch.sum((obs - exp) ** 2 / exp))
    df = int(n - 1)
    return ChiSqTestResult(stat, df, _chi2_sf(stat, df))


def chi_sq_test_matrix(counts, device=None) -> ChiSqTestResult:
    """Pearson independence test on a contingency matrix, like
    ``Statistics.chiSqTest(Matrix)``: expected = outer(row, col) / total."""
    m = on_device(counts, device)
    if m.ndim != 2:
        raise ValueError("counts must be a 2-d contingency matrix")
    total = torch.sum(m)
    exp = torch.outer(torch.sum(m, dim=1), torch.sum(m, dim=0)) / total
    if bool(torch.any(exp <= 0)):
        raise ValueError(
            "chi_sq_test_matrix: every row and column must have a "
            "positive total (empty rows/columns make the test undefined)"
        )
    stat = float(torch.sum((m - exp) ** 2 / exp))
    df = int((m.shape[0] - 1) * (m.shape[1] - 1))
    return ChiSqTestResult(stat, df, _chi2_sf(stat, df))


@dataclass(frozen=True)
class KSTestResult:
    """``Statistics.kolmogorovSmirnovTest`` result fields."""

    statistic: float
    p_value: float
    null_hypothesis: str = "sample follows the theoretical distribution"


def ks_test(sample, cdf="norm", *params) -> KSTestResult:
    """One-sample two-sided Kolmogorov-Smirnov test, on the host.

    Parity: ``mllib/.../stat/test/KolmogorovSmirnovTest.scala`` -- D is the
    max deviation between the empirical CDF and the theoretical one
    ('norm' with optional (mean, std), or any callable CDF); the p-value
    uses the asymptotic Kolmogorov series like the reference's commons-math.
    """
    if isinstance(sample, torch.Tensor):
        sample = sample.cpu().numpy()
    x = np.sort(np.asarray(sample, np.float64))
    n = len(x)
    if n == 0:
        raise ValueError("empty sample")
    if callable(cdf):
        f = np.asarray(cdf(x), np.float64)
    elif cdf == "norm":
        mu = params[0] if len(params) > 0 else 0.0
        sd = params[1] if len(params) > 1 else 1.0
        # float64: the statistic is a max of CDF deviations, and float32
        # CDF rounding would cap its accuracy around 1e-7
        erf = np.frompyfunc(math.erf, 1, 1)
        z = (x - mu) / (sd * math.sqrt(2.0))
        f = 0.5 * (1.0 + erf(z).astype(np.float64))
    else:
        raise ValueError("cdf must be 'norm' or a callable")
    ecdf_hi = np.arange(1, n + 1) / n
    ecdf_lo = np.arange(0, n) / n
    d = float(max(np.max(ecdf_hi - f), np.max(f - ecdf_lo)))
    # asymptotic Kolmogorov distribution: Q(sqrt(n) d)
    t = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d
    s = 0.0
    for j in range(1, 101):
        s += 2.0 * (-1.0) ** (j - 1) * np.exp(-2.0 * j * j * t * t)
    return KSTestResult(statistic=d, p_value=float(min(max(s, 0.0), 1.0)))


class KernelDensity:
    """Gaussian kernel density estimation.

    Parity: ``mllib/.../stat/KernelDensity.scala`` -- the density at each
    query point is the mean of normal kernels centred at the samples; the
    (samples x points) kernel grid is one broadcast on ``device``, reduced
    along the sample axis."""

    def __init__(self, bandwidth: float = 1.0, device=None):
        if bandwidth <= 0:
            raise ValueError("bandwidth must be > 0")
        self.bandwidth = float(bandwidth)
        self.device = device
        self._samples: Optional[torch.Tensor] = None

    def set_sample(self, samples) -> "KernelDensity":
        self._samples = on_device(samples, self.device).ravel()
        return self

    def estimate(self, points) -> np.ndarray:
        if self._samples is None:
            raise ValueError("call set_sample first")
        pts = on_device(points, self._samples.device).ravel()
        h = self.bandwidth
        z = (pts[None, :] - self._samples[:, None]) / h
        k = torch.exp(-0.5 * z * z) / (h * math.sqrt(2.0 * math.pi))
        return k.mean(dim=0).cpu().numpy()

"""Isotonic regression by pool-adjacent-violators.

A copy of ``asyncframework_tpu/ml/isotonic.py``, which is numpy only
(parity: ``mllib/src/main/scala/org/apache/spark/mllib/regression/
IsotonicRegression.scala`` -- weighted PAVA producing a monotone step
function; prediction interpolates linearly between boundaries like the
reference's ``predict``).

Host-side by design: PAVA is an inherently sequential pointer-merge over
sorted data (the reference parallelizes only the per-partition pre-pass);
fitting n points is O(n) after the sort.  The JAX package's isotonic tests
run on this copy (``tests/test_torch_ml_breadth.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class IsotonicRegressionModel:
    boundaries: np.ndarray   # ascending feature values
    predictions: np.ndarray  # monotone fitted values at the boundaries
    increasing: bool

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        b, p = self.boundaries, self.predictions
        out = np.interp(x, b, p)  # clamps at the ends, like the reference
        return out


class IsotonicRegression:
    def __init__(self, increasing: bool = True):
        self.increasing = increasing

    def fit(self, x, y, weights=None) -> IsotonicRegressionModel:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        w = np.ones_like(y) if weights is None else np.asarray(
            weights, np.float64
        )
        if np.any(w <= 0):
            raise ValueError("weights must be positive")
        order = np.argsort(x, kind="stable")
        xs, ys, ws = x[order], y[order], w[order]
        # pool tied x first (weighted mean), like Spark/sklearn -- PAVA over
        # raw ties would emit duplicate boundaries with different values,
        # which is not a function of x
        ux, starts = np.unique(xs, return_index=True)
        bounds = np.append(starts, len(xs))
        pooled_w = np.asarray(
            [ws[a:b].sum() for a, b in zip(bounds[:-1], bounds[1:])]
        )
        pooled_y = np.asarray([
            (ys[a:b] * ws[a:b]).sum() / wsum
            for a, b, wsum in zip(bounds[:-1], bounds[1:], pooled_w)
        ])
        xs, ys, ws = ux, pooled_y, pooled_w
        if not self.increasing:
            ys = -ys
        # weighted PAVA over blocks (value, weight, count)
        vals: list = []
        wts: list = []
        cnts: list = []
        for yi, wi in zip(ys, ws):
            vals.append(yi)
            wts.append(wi)
            cnts.append(1)
            while len(vals) > 1 and vals[-2] >= vals[-1]:
                wv = wts[-2] + wts[-1]
                vals[-2] = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / wv
                wts[-2] = wv
                cnts[-2] += cnts[-1]
                vals.pop()
                wts.pop()
                cnts.pop()
        # compress to boundaries: first/last x of each constant block
        b: list = []
        p: list = []
        i = 0
        for v, c in zip(
            (vals if self.increasing else [-v for v in vals]), cnts
        ):
            b.append(xs[i])
            p.append(v)
            if c > 1:
                b.append(xs[i + c - 1])
                p.append(v)
            i += c
        return IsotonicRegressionModel(
            boundaries=np.asarray(b), predictions=np.asarray(p),
            increasing=self.increasing,
        )

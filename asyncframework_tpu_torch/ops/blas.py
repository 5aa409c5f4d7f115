"""Level-1 BLAS surface used by the driver-side updater loop.

Counterpart of ``asyncframework_tpu/ops/blas.py`` (parity:
``mllib/.../BLASUtil.scala:6-19``, ``axpyOp``/``dotOp``/``scalOp``
returning the mutated vector).  A writable numpy buffer is mutated in
place, as there; a tensor takes the place of a jax array and gets a new
tensor back, never a write into the old one (an old model handle is an
old model version, as in JAX).
"""

from __future__ import annotations

import numpy as np
import torch


def _axpy_numpy(a: float, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    if a == 1.0:
        np.add(y, x, out=y)
    else:
        # y += a*x without an extra temporary beyond the scaled buffer
        y += np.multiply(x, a)
    return y


def axpy_op(a: float, x, y):
    """``BLASUtil.axpyOp`` -- y := a*x + y, returned.

    Mutates ``y`` in place when it is a writable numpy buffer; out of place
    for a read-only view (``tensor.numpy()`` of a read-only source) and for
    a tensor."""
    if isinstance(y, np.ndarray):
        xn = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        if not y.flags.writeable:
            return y + np.multiply(xn, a)
        return _axpy_numpy(float(a), np.asarray(xn), y)
    return y + a * x


def dot_op(x, y) -> float:
    """``BLASUtil.dotOp`` -- always a Python float (a tensor on a card is
    read back, like the reference's blocking driver-side dot)."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return float(torch.dot(x, y))
    xn = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    yn = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
    return float(np.dot(np.asarray(xn), np.asarray(yn)))


def scal_op(a: float, x):
    """``BLASUtil.scalOp`` -- x := a*x, returned.

    In place for writable numpy buffers, out of place otherwise."""
    if isinstance(x, np.ndarray):
        if not x.flags.writeable:
            return x * a
        x *= a
        return x
    return x * a

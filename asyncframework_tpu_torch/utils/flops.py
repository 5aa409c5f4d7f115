"""Achieved-FLOP/s and MFU accounting.

The reference never reports compute efficiency (its metric is wall-clock to
target loss); the port records it so a run carries an absolute number:
solvers count the flops of every worker gradient they merge, and a caller
divides by elapsed time and the card's peak.

Flop model (counted, not estimated): a dense worker step is two matrix-vector
products over the summed rows -- residual ``X @ w`` and gradient
``X^T @ (mask*r)`` -- i.e. ``4 * n_p * d`` flops (2 per multiply-add).  A
sparse (padded-ELL) step is the gather/scatter pair at ``4 * n_p * K``.  The
trajectory evaluation runs outside the timed region and is not counted.

Peak table: dense bf16 tensor-core peak per card (NVIDIA's data sheets, SXM
parts, without sparsity; the usual MFU denominator), at the card's full
power limit.  The worker step moves about one byte per flop, so its MFU is
small by nature: HBM bytes are its roofline, not this peak.
"""

from __future__ import annotations

from typing import Optional

#: dense bf16 tensor-core peak FLOP/s by device-name substring
_PEAK_BF16 = (
    ("h200", 989e12),
    ("h100", 989e12),
)


def chip_peak_flops(device) -> Optional[float]:
    """bf16 dense peak of a ``torch.device``; None for a CPU or a card not in
    the table (MFU is then reported null)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for tag, peak in _PEAK_BF16:
        if tag in kind:
            return peak
    return None


def dense_task_flops(n_rows: int, d: int) -> float:
    """Flops of one dense worker gradient over ``n_rows`` summed rows."""
    return 4.0 * n_rows * d


def sparse_task_flops(n_rows: int, k_padded: int) -> float:
    """Flops of one padded-ELL worker gradient (gather + scatter lanes)."""
    return 4.0 * n_rows * k_padded


def mfu(total_flops: float, elapsed_s: float, device) -> Optional[float]:
    """Model FLOP utilization in [0, 1]; None when the peak is unknown."""
    peak = chip_peak_flops(device)
    if peak is None or elapsed_s <= 0:
        return None
    return total_flops / elapsed_s / peak

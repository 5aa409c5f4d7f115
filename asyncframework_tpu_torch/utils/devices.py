"""Device resolution for the port's entry points.

Entry points default to every visible CUDA device and never fall back to
the CPU silently: without a GPU the caller must ask for the CPU with
``devices=[torch.device("cpu")]``, as the tests do.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch


def canonical(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in, so it
    compares equal to ``Tensor.device`` (``cuda`` means the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """``devices`` as a list of ``torch.device``; None means all CUDA
    devices, and raises ``RuntimeError`` when there are none."""
    if devices is not None:
        out = [canonical(d) for d in devices]
        if not out:
            raise ValueError("devices must not be empty")
        return out
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass "
            "devices=[torch.device('cpu')] to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_scope(device: torch.device):
    """Make ``device`` current on this thread (CUDA only), so launches and
    allocations of a block of work go to that card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def fence(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

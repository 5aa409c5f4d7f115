"""Argument checks the kernels' wrappers share."""

from __future__ import annotations

import torch


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(device, kernel: str) -> bool:
    """True for a CUDA tensor's device (launch the kernel), False for a
    CPU one (plain version); raises for anything else, and for a CUDA
    tensor without CUDA."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda tensors, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{kernel} got a CUDA tensor but CUDA is unavailable")
    return True

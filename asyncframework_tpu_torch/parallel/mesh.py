"""Device meshes for sequence parallelism.

Counterpart of the part of ``asyncframework_tpu/parallel/mesh.py`` that
``parallel/ring.py`` needs: ``make_mesh`` over a list of devices with named
axes.  The first axis holds every device and any further axis has size 1,
as in the JAX package's default layout.

A device may repeat: ``devices=[torch.device("cuda", 0)] * 4`` gives four
ranks on one card (the ring then runs at P = 4 with every "transfer" a
no-op), and ``[torch.device("cpu")] * 8`` gives the tests' eight-rank mesh,
the counterpart of the eight virtual CPU devices the JAX tests run on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from asyncframework_tpu_torch.utils.devices import resolve_devices


class Mesh:
    """Named axes over a list of devices (the first axis spans them all)."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Tuple[str, ...]):
        if not axis_names:
            raise ValueError("a mesh needs at least one axis name")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must be distinct: {axis_names}")
        self.devices: List[torch.device] = list(devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {
            name: (len(self.devices) if i == 0 else 1)
            for i, name in enumerate(self.axis_names)
        }

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of the ranks along ``axis``, in rank order."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {self.axis_names})")
        return self.devices[: self.shape[axis]]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mesh({self.shape}, devices={self.devices})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("sp",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device; raises ``RuntimeError`` without one).  Asking for more
    devices than the list holds raises ``ValueError``."""
    devs = resolve_devices(devices)
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"n_devices must be at least 1, got {n_devices}")
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available"
            )
        devs = devs[:n_devices]
    return Mesh(devs, tuple(axis_names))

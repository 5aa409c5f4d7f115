"""Sequence parallelism: device meshes, ring and Ulysses attention."""

from asyncframework_tpu_torch.parallel.mesh import Mesh, make_mesh
from asyncframework_tpu_torch.parallel.ring import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "reference_attention",
    "ring_attention",
    "ulysses_attention",
]

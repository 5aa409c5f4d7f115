"""Device meshes and their placement helpers, ring and Ulysses attention;
the process group (``multihost``), the DCN plane and its shard groups live
in their own modules."""

from asyncframework_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pad_and_shard,
    pad_and_shard_2d,
    shard_batch,
)
from asyncframework_tpu_torch.parallel.ring import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "pad_and_shard",
    "pad_and_shard_2d",
    "reference_attention",
    "ring_attention",
    "shard_batch",
    "ulysses_attention",
]

"""Seeded per-worker sampling.

Counterpart of ``asyncframework_tpu/ops/sampling.py`` and of the solvers'
per-worker key chains ``fold_in(PRNGKey(seed), wid)``
(``asyncframework_tpu/solvers/asgd.py:166-176``).  Each (seed, stream)
pair gets its own ``torch.Generator`` on the shard's device, so masks are
drawn on the device with no host round trip.  The bits differ from JAX's
threefry draws; tests that compare the two packages inject the same mask
or index list into both instead of comparing draws.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``(seed, data)`` -- distinct streams for
    distinct pairs, like ``jax.random.fold_in``."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def worker_generator(seed: int, worker_id: int, device) -> torch.Generator:
    """The worker's mask generator on ``device``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(fold_in(seed, worker_id))
    return gen


def bernoulli_mask(gen: torch.Generator, n: int, rate: float) -> torch.Tensor:
    """Boolean ``(n,)`` mask, each entry True with probability ``rate``
    (``r.nextDouble() < b`` parity), drawn on the generator's device."""
    return torch.rand(n, generator=gen, device=gen.device) < rate

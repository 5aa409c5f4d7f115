"""Random dataset generators (RandomRDDs parity).

Parity: ``mllib/src/main/scala/org/apache/spark/mllib/random/
RandomRDDs.scala`` -- uniform/normal/poisson/exponential/gamma/log-normal
scalar and vector generators partitioned across the cluster.

Counterpart of ``asyncframework_tpu/data/random.py``: one draw per
generator from a ``torch.Generator`` seeded with ``seed`` on the entry
device (``device``, else the scheduler's first device, else the card;
raises without one unless ``ASYNCTPU_FORCE_CPU`` asks for the CPU), then
the host values are partitioned into a :class:`DistributedDataset` so the
full dataset op surface (map/filter/reduce/pair ops) applies.  The values
are reproducible per seed and device but are not the JAX package's
threefry draws (ROADMAP C2).  The engine-dataset layer is host-resident
by design (see ``data/dataset.py``); device-resident sharded generation
lives in ``ShardedDataset.generate_on_device``.
"""

from __future__ import annotations

from typing import Optional

import torch

from asyncframework_tpu_torch.data.dataset import DistributedDataset
from asyncframework_tpu_torch.utils.devices import entry_devices


def _draw(sampler, scheduler, n: int, d: Optional[int], seed: int,
          num_partitions: Optional[int], device=None):
    if device is None:
        device = entry_devices(getattr(scheduler, "devices", None))[0]
    else:
        device = entry_devices([device])[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (n,) if d is None else (n, d)
    values = sampler(gen, shape, device).float().cpu().numpy()
    data = [float(v) for v in values] if d is None else list(values)
    return DistributedDataset.from_list(
        scheduler, data, num_partitions=num_partitions
    )


def _uniform(gen, shape, dev):
    return torch.rand(shape, generator=gen, device=dev)


def _normal(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev)


def uniform_dataset(scheduler, n, num_partitions=None, seed=0, device=None):
    """U[0, 1) scalars (``RandomRDDs.uniformRDD``)."""
    return _draw(_uniform, scheduler, n, None, seed, num_partitions, device)


def normal_dataset(scheduler, n, num_partitions=None, seed=0, device=None):
    """Standard normal scalars (``RandomRDDs.normalRDD``)."""
    return _draw(_normal, scheduler, n, None, seed, num_partitions, device)


def poisson_dataset(scheduler, n, mean, num_partitions=None, seed=0,
                    device=None):
    """Poisson(mean) scalars (``RandomRDDs.poissonRDD``)."""
    return _draw(
        lambda g, s, dev: torch.poisson(
            torch.full(s, float(mean), device=dev), generator=g),
        scheduler, n, None, seed, num_partitions, device,
    )


def exponential_dataset(scheduler, n, mean, num_partitions=None, seed=0,
                        device=None):
    """Exponential(mean) scalars (``RandomRDDs.exponentialRDD``)."""
    return _draw(
        lambda g, s, dev: torch.empty(s, device=dev).exponential_(
            1.0, generator=g) * mean,
        scheduler, n, None, seed, num_partitions, device,
    )


def gamma_dataset(scheduler, n, shape, scale, num_partitions=None, seed=0,
                  device=None):
    """Gamma(shape, scale) scalars (``RandomRDDs.gammaRDD``)."""
    return _draw(
        lambda g, s, dev: torch._standard_gamma(
            torch.full(s, float(shape), device=dev), generator=g) * scale,
        scheduler, n, None, seed, num_partitions, device,
    )


def log_normal_dataset(scheduler, n, mean, std, num_partitions=None, seed=0,
                       device=None):
    """Log-normal scalars (``RandomRDDs.logNormalRDD``)."""
    return _draw(
        lambda g, s, dev: torch.exp(mean + std * _normal(g, s, dev)),
        scheduler, n, None, seed, num_partitions, device,
    )


def uniform_vector_dataset(scheduler, n, d, num_partitions=None, seed=0,
                           device=None):
    """U[0, 1) row vectors (``RandomRDDs.uniformVectorRDD``)."""
    return _draw(_uniform, scheduler, n, d, seed, num_partitions, device)


def normal_vector_dataset(scheduler, n, d, num_partitions=None, seed=0,
                          device=None):
    """Standard normal row vectors (``RandomRDDs.normalVectorRDD``)."""
    return _draw(_normal, scheduler, n, d, seed, num_partitions, device)

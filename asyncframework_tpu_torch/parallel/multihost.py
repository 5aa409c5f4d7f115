"""Multi-process group bring-up on ``torch.distributed``.

Counterpart of ``asyncframework_tpu/parallel/multihost.py`` (parity: the
reference's standalone Master/Worker registration,
``deploy/master/Master.scala:41``, ``deploy/worker/Worker.scala:43``).
Where the JAX package initializes ``jax.distributed`` so that
``jax.devices()`` spans hosts, the port initializes a
``torch.distributed`` process group and builds meshes whose ranks span its
processes (:func:`global_mesh`; ``parallel/mesh.py``'s ``process_of``).

- The backend is NCCL for CUDA devices and gloo when the caller asks for
  the CPU (``devices=[torch.device("cpu")] * k``); there is no switch
  between them.  The devices default to every CUDA device and raise
  without one.
- Single-process use is a no-op (:func:`ensure_initialized` returns
  False), so every call site works unchanged on one host.

Nothing on a machine tells a program of a cluster: the coordinator's
``host:port``, the process count and this process's id come from the
arguments or from ``ASYNCTPU_COORDINATOR`` / ``ASYNCTPU_NUM_PROCESSES`` /
``ASYNCTPU_PROCESS_ID``; ``auto=True`` reads a launcher's environment
instead (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch

from asyncframework_tpu_torch.utils.devices import resolve_devices

_initialized = False
_local_devices: List[torch.device] = []


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """True when a process group is up (ours, or a launcher's)."""
    dist = _dist()
    return _initialized or (dist.is_available() and dist.is_initialized())


def backend_for(devices: Sequence[torch.device]) -> str:
    """``nccl`` for CUDA devices, ``gloo`` for the CPU; a mixed list is
    refused."""
    kinds = {torch.device(d).type for d in devices}
    if kinds == {"cuda"}:
        return "nccl"
    if kinds == {"cpu"}:
        return "gloo"
    raise ValueError(f"one process group cannot serve devices of kinds "
                     f"{sorted(kinds)}")


def ensure_initialized(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    devices: Optional[Sequence] = None,
    timeout_s: float = 300.0,
) -> bool:
    """Initialize a ``torch.distributed`` process group when multi-process
    arguments or environment are present.

    Resolution order: explicit arguments, then ``ASYNCTPU_COORDINATOR``
    (``host:port``) / ``ASYNCTPU_NUM_PROCESSES`` / ``ASYNCTPU_PROCESS_ID``.
    With neither, a single-process no-op unless ``auto=True`` (the
    launcher's ``env://`` variables, an explicit opt-in).  One process is
    also a no-op.  ``devices`` are this process's devices (default: every
    CUDA device); they choose the backend.  ``timeout_s`` bounds the
    rendezvous and every collective.  Returns True when running
    multi-process.  Idempotent, also after a launcher's own
    ``init_process_group``."""
    global _initialized, _local_devices
    dist = _dist()
    if _initialized or (dist.is_available() and dist.is_initialized()):
        if not _local_devices:
            _local_devices = resolve_devices(devices)
        _initialized = True
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "ASYNCTPU_COORDINATOR")
    env_np = os.environ.get("ASYNCTPU_NUM_PROCESSES")
    env_pid = os.environ.get("ASYNCTPU_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None)
    if coordinator_address is None and num_processes is None and not auto:
        return False  # single-process: nothing to do
    if num_processes is not None and num_processes <= 1:
        # an explicit 1-process "cluster" is just a single process
        return False
    local = resolve_devices(devices)
    backend = backend_for(local)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the process "
                             "count and this process's id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    _local_devices = local
    _initialized = True
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Tear the process group down (a no-op without one)."""
    global _initialized, _local_devices
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _local_devices = []


def process_info() -> Tuple[int, int]:
    """``(process_id, process_count)`` -- ``(0, 1)`` when single-process."""
    if not is_initialized():
        return 0, 1
    dist = _dist()
    return dist.get_rank(), dist.get_world_size()


def local_devices() -> List[torch.device]:
    """This process's devices (the group's, or every CUDA device)."""
    return list(_local_devices) if _local_devices else resolve_devices(None)


def device_count() -> int:
    """Devices of every process: the process count times this process's
    (every process holds as many; :func:`sync_hosts` checks it)."""
    return process_info()[1] * len(local_devices())


def sync_hosts(name: str = "barrier") -> None:
    """Block until every process reaches this point.

    Built from an all-reduce (no process can read its result before every
    process contributed), which also checks the device count: each
    process adds its device count and a 1, and the sums must be
    :func:`device_count` and the process count."""
    if not is_initialized():
        return
    dist = _dist()
    devs = local_devices()
    t = torch.tensor([float(len(devs)), 1.0], device=devs[0])
    dist.all_reduce(t)
    got_devices, got_procs = int(t[0].item()), int(t[1].item())
    _pid, pc = process_info()
    if got_procs != pc or got_devices != device_count():
        raise RuntimeError(
            f"{name}: barrier saw {got_devices} devices over {got_procs} "
            f"processes, expected {device_count()} over {pc}")


def global_mesh(axis_names=("dp",), axis_sizes=None):
    """A mesh over every device of every process, process-major (the
    ranks of process 0 first); defaults to one data-parallel axis."""
    from asyncframework_tpu_torch.parallel.mesh import Mesh

    pid, pc = process_info()
    devs = local_devices()
    k = len(devs)
    return Mesh(devs * pc, tuple(axis_names), axis_sizes,
                process_of=[r // k for r in range(k * pc)],
                process_index=pid)

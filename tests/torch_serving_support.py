"""Shared pieces of the port's serving and relaycast test files.

The JAX package's serving and relaycast suites construct their parameter
servers and replicas without a device (JAX's default device is the CPU in
the test session) and launch ``python -m asyncframework_tpu.serving.cli``
processes.  The port's entry points default to the card and never fall
back, so the suites run on the port through CPU-defaulting subclasses,
and their subprocesses through a ``subprocess`` stand-in that launches the
port's CLI instead (``ASYNCTPU_FORCE_CPU=1``, which the reference cases
set, puts it on the CPU).
"""

import functools
import subprocess
import types

import torch

from asyncframework_tpu import conf as j_conf
from asyncframework_tpu.metrics import reset_totals as j_reset_totals
from asyncframework_tpu.metrics import timeseries as j_ts
from asyncframework_tpu.net import faults as j_faults
from asyncframework_tpu.net.retry import reset_breakers as j_breakers

from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.serving import replica as t_rep

CPU = torch.device("cpu")
JAX_SERVE_CLI = "asyncframework_tpu.serving.cli"
PORT_SERVE_CLI = "asyncframework_tpu_torch.serving.cli"


def _cpu_unless_torch(device):
    return device if isinstance(device, (torch.device, str)) else CPU


class CPUParameterServer(t_ps.ParameterServer):
    """The port's PS on the CPU unless a torch device is given (the
    reference cases construct it with a JAX device)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=_cpu_unless_torch(device), **kwargs)


class CPUModelReplica(t_rep.ModelReplica):
    """The port's replica on the CPU unless a torch device is given."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=_cpu_unless_torch(device), **kwargs)


def _module(src, name, **over):
    mod = types.ModuleType(name)
    mod.__dict__.update({k: v for k, v in vars(src).items()
                         if not k.startswith("__")})
    mod.__dict__.update(over)
    return mod


port_ps = _module(t_ps, "port_ps_dcn_on_cpu",
                  ParameterServer=CPUParameterServer)
cpu_serve_replica = functools.partial(t_rep.serve_replica, device=CPU)
#: stands in for ``asyncframework_tpu.serving.replica`` where a reference
#: case imports ``ModelReplica`` lazily
port_replica = _module(t_rep, "port_replica_on_cpu",
                       ModelReplica=CPUModelReplica,
                       serve_replica=cpu_serve_replica)


def clean_jax_package() -> None:
    """Leave the JAX package's process-global state as a fresh process has
    it: the cases across the packages start its parameter servers (whose
    start runs its telemetry sampler) and bump its counters, and later
    tests in the same worker compare its state with the port's."""
    j_ts.stop_sampler()
    j_reset_totals()
    j_breakers()
    j_faults.clear()
    j_conf.set_global_conf(None)


def _port_argv(argv):
    return [PORT_SERVE_CLI if a == JAX_SERVE_CLI else a for a in argv]


class _PortPopen(subprocess.Popen):
    """``subprocess.Popen`` that runs the port's serving CLI where the
    reference case names the JAX package's."""

    def __init__(self, args, *rest, **kwargs):
        super().__init__(_port_argv(list(args)), *rest, **kwargs)


#: the ``subprocess`` module a reference case sees while it runs on the port
port_subprocess = _module(subprocess, "port_subprocess", Popen=_PortPopen)

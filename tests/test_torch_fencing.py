"""Epoch fencing, leases and partitions on the port, against the JAX
package's own fencing suite and across the packages.

- The JAX package's cases (``tests/test_fencing.py``) run here a second
  time with the modules they test swapped for the port's copies (the
  reference module's globals by monkeypatch; its lazy import of
  ``data.sharded`` by aliasing the JAX module name to the port's):
  partition and delay faults (``net/faults.py``), leases and suspicion
  (``parallel/supervisor.py``, ``net/health.py``), the pid-reuse probe,
  the socket deadlines (``net/retry.py``), the fencing protocol on the PS
  and its clients, fenced sharded groups, and the acceptance run: a real
  3-shard port ``ShardGroup`` on the CPU partitioned past lease expiry,
  fenced and relaunched, trained by two worker processes of the JAX
  package (``tests/ps_dcn_child.py``), watching shard 1's clock through
  SUBSCRIBE.
- Across the packages: a port client against a fenced JAX-package PS and
  a JAX-package client against a fenced port PS (stale ops self-heal,
  the zombie refuses); with fencing off neither package's frames carry
  ``ep``; a fenced checkpoint of either package resumes in the other
  under a bumped epoch.
"""

import sys
import types

import numpy as np
import pytest
import torch

import test_fencing as ref_fence
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch.net import faults as t_faults
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net import health as t_health
from asyncframework_tpu_torch.net import reset_net_totals as t_reset_net
from asyncframework_tpu_torch.net import retry as t_retry
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.parallel import shardgroup as t_sg
from asyncframework_tpu_torch.parallel import supervisor as t_sup
from asyncframework_tpu_torch.solvers import SolverConfig
from asyncframework_tpu_torch.utils.clock import ManualClock

pytestmark = pytest.mark.fence

CPU = torch.device("cpu")


class _CPUParameterServer(t_ps.ParameterServer):
    """The port's PS on the CPU unless a device is given (the reference
    cases construct it without one; the port's default is the card)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=CPU if device is None else device,
                         **kwargs)


#: the port's ps_dcn as the reference cases see it
port_ps = types.ModuleType("port_ps_dcn_on_cpu")
port_ps.__dict__.update({k: v for k, v in vars(t_ps).items()
                         if not k.startswith("__")})
port_ps.ParameterServer = _CPUParameterServer


class _CPUShardGroup(t_sg.ShardGroup):
    """The port's shard group with its children on the CPU."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)


port_sg = types.ModuleType("port_shardgroup_on_cpu")
port_sg.__dict__.update({k: v for k, v in vars(t_sg).items()
                         if not k.startswith("__")})
port_sg.ShardGroup = _CPUShardGroup


def _port_cfg(**kw):
    """``tests/test_fencing.py::make_cfg`` on the port's SolverConfig."""
    defaults = dict(
        num_workers=2, num_iterations=60, gamma=0.5, taw=2**31 - 1,
        batch_rate=0.3, bucket_ratio=0.0, printer_freq=20, seed=42,
        calibration_iters=5, run_timeout_s=60.0,
    )
    defaults.update(kw)
    return SolverConfig(**defaults)


@pytest.fixture()
def devices8():
    """The reference cases' JAX device list, as the port's CPU devices."""
    return [CPU] * 8


def _clean():
    t_faults.clear()
    t_reset_net()
    t_retry.reset_breakers()
    t_sg.reset_shard_totals()
    t_sup.reset_recovery_totals()
    t_health.reset_gray_totals()


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    """Point the reference module's globals at the port's copies, alias
    its lazy ``data.sharded`` import, and leave the port's process-global
    state clean (the reference's own clean-state fixture, on the port)."""
    monkeypatch.setitem(sys.modules, "asyncframework_tpu.data.sharded",
                        sys.modules["asyncframework_tpu_torch.data.sharded"])
    for name, value in dict(
            AsyncConf=t_conf.AsyncConf,
            set_global_conf=t_conf.set_global_conf, faults=t_faults,
            frame=t_frame, health=t_health, reset_net_totals=t_reset_net,
            RetryError=t_retry.RetryError, RetryPolicy=t_retry.RetryPolicy,
            remaining_deadline_s=t_retry.remaining_deadline_s,
            reset_breakers=t_retry.reset_breakers, ps_dcn=port_ps,
            sg=port_sg, sup_mod=t_sup, SolverConfig=SolverConfig,
            ManualClock=ManualClock, make_cfg=_port_cfg).items():
        monkeypatch.setattr(ref_fence, name, value)
    _clean()
    t_conf.set_global_conf(t_conf.AsyncConf())
    yield
    _clean()
    t_conf.set_global_conf(None)


# ------------------------------------- tests/test_fencing.py on the port
class TestPartitionDelayFaultsOnThePort(ref_fence.TestPartitionDelayFaults):
    pass


class TestLeaseSuspicionOnThePort(ref_fence.TestLeaseSuspicion):
    pass


class TestPidReuseProbeOnThePort(ref_fence.TestPidReuseProbe):
    pass


class TestSocketDeadlineOnThePort(ref_fence.TestSocketDeadline):
    pass


class TestEpochFencingOnThePort(ref_fence.TestEpochFencing):
    pass


class TestShardedFencingOnThePort(ref_fence.TestShardedFencing):
    pass


class TestPartitionFenceRelaunchOnThePort(
        ref_fence.TestPartitionFenceRelaunch):
    """The acceptance run: the port's 3-shard group of real processes on
    the CPU, the JAX package's worker processes."""

    def test_partition_shard_fence_and_relaunch(self, tmp_path):
        super().test_partition_shard_fence_and_relaunch(tmp_path)


# ------------------------------------------------------ across the packages
def _jax_ps(cfg_kw=None, **kw):
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    defaults = dict(num_workers=2, num_iterations=60, gamma=0.5,
                    taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                    printer_freq=20, seed=42, calibration_iters=5,
                    run_timeout_s=60.0)
    defaults.update(cfg_kw or {})
    return j_ps.ParameterServer(JConfig(**defaults), 6, 64, port=0,
                                **kw).start()


@pytest.mark.parametrize("server", ["jax", "port"])
def test_stamped_epochs_are_honoured_across_the_packages(server):
    """Either package's client against the other's fenced PS: a stale
    pull self-heals, a stale push drops and the next is admitted, and a
    client ahead of the server meets a zombie that refuses it."""
    if server == "jax":
        ps = _jax_ps(epoch=2)
        client = t_ps.PSClient
        fenced_error = t_ps.FencedError
    else:
        ps = _CPUParameterServer(_port_cfg(), 6, 64, port=0, epoch=2).start()
        client = j_ps.PSClient
        fenced_error = j_ps.FencedError
    try:
        cl = client("127.0.0.1", ps.port, epoch=1)
        assert cl.pull(0) is not None
        assert cl.epoch == 2 and cl.fenced_replies == 1
        cl2 = client("127.0.0.1", ps.port, epoch=1)
        assert cl2.push(0, 0, np.zeros(6, np.float32)) == (False, False)
        acc, _done = cl2.push(0, 0, np.ones(6, np.float32))
        assert acc and ps.accepted == 1
        assert ps.fenced_rejects == 2
        ahead = client("127.0.0.1", ps.port, epoch=3)
        with pytest.raises(fenced_error):
            ahead.pull(0)
        # the zombie now refuses its own epoch too
        with pytest.raises(fenced_error):
            cl.pull(0)
        for c in (cl, cl2, ahead):
            c.bye()
    finally:
        ps.stop()


@pytest.mark.parametrize("server", ["jax", "port"])
def test_fence_off_frames_carry_no_ep_across_the_packages(server,
                                                          monkeypatch):
    """Fencing off on both sides: no frame either way holds an ``ep``
    key (every send site of both packages' PS modules is recorded)."""
    from asyncframework_tpu.net import frame as j_frame

    seen = []

    def spy(real):
        def send(sock, header, *a, **k):
            seen.append(dict(header))
            return real(sock, header, *a, **k)
        return send

    for mod, attr in ((t_ps, "_send_msg"), (j_ps, "_send_msg"),
                      (t_frame, "send_msg"), (j_frame, "send_msg"),
                      (t_frame, "send_msg_vectored"),
                      (j_frame, "send_msg_vectored")):
        monkeypatch.setattr(mod, attr, spy(getattr(mod, attr)))
    if server == "jax":
        ps = _jax_ps()
        cl = t_ps.PSClient("127.0.0.1", ps.port)
    else:
        ps = _CPUParameterServer(_port_cfg(), 6, 64, port=0).start()
        cl = j_ps.PSClient("127.0.0.1", ps.port)
    try:
        assert ps.epoch == 0
        cl.hello("p", [0])
        ts, _w, _a, _c = cl.pull(0)
        cl.push(0, ts, np.ones(6, np.float32))
        cl.bye()
    finally:
        ps.stop()
    ops = {h.get("op") for h in seen}
    assert {"HELLO", "WELCOME", "PULL", "MODEL", "PUSH"} <= ops, ops
    assert not any("ep" in h or "epoch" in h or "epochs" in h for h in seen)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fenced_checkpoints_resume_across_the_packages(tmp_path, writer):
    """A fenced PS checkpoint of either package resumes in the other: the
    restored incarnation runs one epoch above the saved one, with the
    model and clock of the save."""
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    path = str(tmp_path / "ps.npz")
    jcfg = JConfig(num_workers=2, num_iterations=60, gamma=0.5,
                   taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                   printer_freq=20, seed=42, calibration_iters=5,
                   run_timeout_s=60.0)
    if writer == "jax":
        a = j_ps.ParameterServer(jcfg, 6, 64, port=0, epoch=3,
                                 checkpoint_path=path).start()
    else:
        a = _CPUParameterServer(_port_cfg(), 6, 64, port=0, epoch=3,
                                checkpoint_path=path).start()
    cl = (t_ps if writer == "jax" else j_ps).PSClient(
        "127.0.0.1", a.port, epoch=3)
    for _ in range(3):
        ts, _w, _x, _y = cl.pull(0)
        cl.push(0, ts, np.full(6, 0.5, np.float32))
    cl.bye()
    a.save_checkpoint()
    w_saved = np.array(a._w, np.float32)
    a.stop()
    if writer == "jax":
        b = _CPUParameterServer(_port_cfg(), 6, 64, port=0, epoch=1,
                                checkpoint_path=path)
    else:
        b = j_ps.ParameterServer(jcfg, 6, 64, port=0, epoch=1,
                                 checkpoint_path=path)
    try:
        assert b.epoch == 4
        assert b._clock == 3 and b.accepted == 3
        np.testing.assert_array_equal(np.array(b._w, np.float32), w_saved)
    finally:
        b.stop()

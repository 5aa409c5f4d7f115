"""Sharded PS groups with shard failover on the port, against the JAX
package's own shard-group suite and across the packages.

- The JAX package's cases (``tests/test_shardgroup.py``: the conf
  install, shard ranges and the map, ``shards=1`` byte-identical to the
  conf unset, sharded runs with their version vectors and per-shard
  staleness, the ``shardgroup`` telemetry and SLO rule, the restart
  double-spawn guard, and the acceptance run: SIGKILL one shard of a real
  3-shard port ``ShardGroup`` on the CPU, trained by two worker processes
  of the JAX package, ``tests/ps_dcn_child.py``) run here a second time
  with the modules they test swapped for the port's copies (the reference
  module's globals by monkeypatch; its lazy imports by aliasing the JAX
  module names to the port's), the serving tier's ``ShardedSubscriber``
  cases included.  Left out: the k8s rendering (ROADMAP A8) and the
  primary-kill soak run (``soak``).  The acceptance run watches shard 1's
  clock through SUBSCRIBE.
- Across the packages: a port worker process trains against a JAX-package
  group and a JAX-package worker against a port group; the port group's
  assembled model is byte-equal to one port PS fed the same pushes, and
  equal to the JAX-package group's fed the same pushes within the apply's
  last bit (ROADMAP C1), with the same clocks; per-shard checkpoints of
  either group resume in the other (``convert.shard_checkpoints``).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import asyncframework_tpu.serving  # noqa: F401  (before the aliases)
import test_shardgroup as ref_sg
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu.parallel import shardgroup as j_sg
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch import convert
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.metrics import live as t_live
from asyncframework_tpu_torch.metrics import prom as t_prom
from asyncframework_tpu_torch.metrics import slo as t_slo
from asyncframework_tpu_torch.metrics import timeseries as t_ts
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net import reset_net_totals as t_reset_net
from asyncframework_tpu_torch.net.retry import reset_breakers as t_breakers
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.parallel import shardgroup as t_sg
from asyncframework_tpu_torch.solvers import SolverConfig
from asyncframework_tpu_torch.utils import clock as t_clock
from torch_serving_support import port_replica

pytestmark = pytest.mark.shard

CPU = torch.device("cpu")


class _CPUParameterServer(t_ps.ParameterServer):
    """The port's PS on the CPU unless a device is given."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=CPU if device is None else device,
                         **kwargs)


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

#: the JAX package's module names whose lazy imports inside the reference
#: cases resolve to the port's copies while a port case runs
ALIASES = {
    "asyncframework_tpu.metrics.slo": t_slo,
    "asyncframework_tpu.metrics.timeseries": t_ts,
    "asyncframework_tpu.metrics.live": t_live,
    "asyncframework_tpu.metrics.prom": t_prom,
    "asyncframework_tpu.utils.clock": t_clock,
    "asyncframework_tpu.serving.replica": port_replica,
}


@pytest.fixture()
def devices8():
    """The reference cases' JAX device list, as the port's CPU devices."""
    return [CPU] * 8


def _clean():
    t_reset_net()
    t_sg.reset_shard_totals()
    t_breakers()


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    for name, mod in ALIASES.items():
        monkeypatch.setitem(sys.modules, name, mod)
    for name, value in dict(
            conf_mod=t_conf, AsyncConf=t_conf.AsyncConf,
            global_conf=t_conf.global_conf,
            set_global_conf=t_conf.set_global_conf,
            ShardedDataset=ShardedDataset, frame=t_frame,
            reset_net_totals=t_reset_net, reset_breakers=t_breakers,
            ps_dcn=port_ps, sg=port_sg, SolverConfig=SolverConfig).items():
        monkeypatch.setattr(ref_sg, name, value)
    _clean()
    t_conf.set_global_conf(t_conf.AsyncConf())
    yield
    _clean()
    t_conf.set_global_conf(None)


# ----------------------------------- tests/test_shardgroup.py on the port
class TestGlobalConfInstallOnThePort(ref_sg.TestGlobalConfInstall):
    pass


class TestShardRangesOnThePort(ref_sg.TestShardRanges):
    pass


class TestShardMapOnThePort(ref_sg.TestShardMap):
    pass


class TestShardsOneIsClassicOnThePort(ref_sg.TestShardsOneIsClassic):
    pass


class TestShardedRunOnThePort(ref_sg.TestShardedRun):
    pass


class TestTelemetryAndSLOOnThePort(ref_sg.TestTelemetryAndSLO):
    def test_registry_has_shardgroup_family(self):
        """The reference case on the port's registry."""
        from asyncframework_tpu_torch.metrics import registry, reset_totals

        assert "shardgroup" in registry.families()
        assert "shardgroup" not in registry.UNPORTED_FAMILIES
        t_sg._bump("sharded_pulls")
        reset_totals()
        assert t_sg.shard_totals() == {}


class TestRestartDoubleSpawnGuardOnThePort(
        ref_sg.TestRestartDoubleSpawnGuard):
    pass


class TestShardedSubscriberOnThePort(ref_sg.TestShardedSubscriber):
    """The serving tier's per-range subscription: the assembled model
    byte-equal to a direct pull, a dark range priced and named, and a port
    replica resolving the group and serving it (the reference's lazy
    ``ModelReplica`` import aliased to the port's, on the CPU)."""


class TestKillShardMidRunOnThePort(ref_sg.TestKillShardMidRun):
    """The acceptance run: the port's 3-shard group of real processes on
    the CPU, the JAX package's worker processes."""

    # the primary-kill run stays a soak run (not twinned)
    test_sigkill_primary_shard = None


# ------------------------------------------------------ across the packages
NW, N, D = 4, 1024, 23


def _cfg(pkg, **kw):
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    base = dict(num_workers=NW, num_iterations=120, gamma=1.2,
                taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.5,
                printer_freq=40, seed=42, calibration_iters=10,
                run_timeout_s=120.0)
    base.update(kw)
    return (JConfig if pkg == "jax" else SolverConfig)(**base)


def _data(pkg):
    """The same draw as both packages' datasets (port generator, seed 7)."""
    ds = ShardedDataset.generate_on_device(N, D, NW, [CPU], seed=7,
                                           noise=0.01)
    if pkg == "port":
        return ds
    return convert_to_jax(ds)


def convert_to_jax(ds):
    import jax

    from asyncframework_tpu.data.sharded import ShardedDataset as JDataset

    X = np.concatenate([ds.shard(w).X.numpy() for w in range(NW)])
    y = np.concatenate([ds.shard(w).y.numpy() for w in range(NW)])
    return JDataset(X, y, NW, devices=[jax.devices("cpu")[0]])


def _group(pkg, cfg, shards, checkpoint_dir=None):
    if pkg == "jax":
        import jax

        return j_sg.launch_inprocess_group(
            cfg, D, N, shards, device=jax.devices("cpu")[0],
            checkpoint_dir=checkpoint_dir)
    return t_sg.launch_inprocess_group(cfg, D, N, shards, device=CPU,
                                       checkpoint_dir=checkpoint_dir)


@pytest.mark.parametrize("server,worker", [("jax", "port"),
                                           ("port", "jax")])
def test_workers_of_one_package_train_against_the_others_group(server,
                                                                worker):
    """A worker process of either package resolves the other's 3-shard
    group at HELLO (map and fencing epochs), trains it to its budget with
    every shard counting every push once, and its evaluation of the
    assembled snapshots falls below 1/10 of the objective at w = 0."""
    set_conf = (t_conf.set_global_conf if server == "port"
                else __import__("asyncframework_tpu.conf", fromlist=["x"])
                .set_global_conf)
    conf_cls = (t_conf.AsyncConf if server == "port"
                else __import__("asyncframework_tpu.conf", fromlist=["x"])
                .AsyncConf)
    set_conf(conf_cls({"async.fence.enabled": True}))
    try:
        ps_list, smap = _group(server, _cfg(server), 3)
    finally:
        set_conf(None)
    try:
        assert [p.epoch for p in ps_list] == [1, 1, 1]
        ds = _data(worker)
        shards = {w: ds.shard(w) for w in range(NW)}
        run = (t_ps if worker == "port" else j_ps).run_worker_process
        counts = run("127.0.0.1", ps_list[0].port, list(range(NW)), shards,
                     _cfg(worker), D, N, eval_wid=0, deadline_s=120.0)
        primary = ps_list[0]
        assert primary.wait_done(timeout_s=10.0)
        assert primary.accepted == 120
        assert sum(counts.values()) >= 120
        for ps in ps_list:
            pushes = sum(ps.pushes_by_wid.values())
            assert pushes == ps.accepted + ps.dropped
            assert ps.dedup_hits == 0 and ps.fenced_rejects == 0
        for ps in ps_list[1:]:
            assert ps.accepted >= primary.accepted
        total = primary.collect_eval(num_worker_procs=1, timeout_s=30.0)
        assert total is not None and total[-1] < total[0] * 0.1
    finally:
        for ps in ps_list:
            ps.stop()


def _feed(smap, grads, shard_client):
    """One client, serial: pull, push the next fixed gradient, repeat;
    returns the version vectors it pulled."""
    cl = shard_client(smap)
    seen = []
    for g in grads:
        ts, _w, _a, _c = cl.pull(0)
        seen.append(ts)
        cl.push(0, ts, g)
    cl.bye()
    return seen


def test_assembled_model_equals_a_single_ps_and_the_jax_group():
    """The same 30 fixed gradients, pushed by one serial client: the
    port's 3-shard group assembles a model byte-equal to one port PS fed
    them, and equal to the JAX-package group's within the apply's last
    bit (XLA's reciprocal square root, ROADMAP C1), with equal version
    vectors and clocks."""
    rs = np.random.default_rng(5)
    grads = [rs.normal(size=D).astype(np.float32) for _ in range(30)]
    kw = dict(num_workers=1, num_iterations=10**6, bucket_ratio=0.0,
              calibration_iters=10**9)
    t_list, t_map = _group("port", _cfg("port", **kw), 3)
    j_list, j_map = _group("jax", _cfg("jax", **kw), 3)
    single = _CPUParameterServer(_cfg("port", **kw), D, N, port=0).start()
    try:
        t_seen = _feed(t_map, grads, t_sg.ShardedPSClient)
        j_seen = _feed(j_map, grads, t_sg.ShardedPSClient)
        cl = t_ps.PSClient("127.0.0.1", single.port)
        for g in grads:
            ts, _w, _a, _c = cl.pull(0)
            cl.push(0, ts, g)
        cl.bye()
        t_w = np.concatenate([np.array(p._w, np.float32) for p in t_list])
        j_w = np.concatenate([np.array(p._w, np.float32) for p in j_list])
        assert t_w.tobytes() == np.array(single._w, np.float32).tobytes()
        assert t_seen == j_seen and len(t_seen[0]) == 3
        assert [p._clock for p in t_list] == [p._clock for p in j_list] \
            == [30, 30, 30]
        np.testing.assert_allclose(t_w, j_w, rtol=0,
                                   atol=1e-6 * float(np.abs(j_w).max()))
    finally:
        for p in t_list + j_list + [single]:
            p.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_per_shard_checkpoints_resume_in_the_other_package(tmp_path,
                                                           writer):
    """A fenced 3-shard group of either package checkpoints each range
    (``ps_shard{i}.npz``); ``convert.shard_checkpoints`` reads them, and
    the other package's group resumes every range from its file: same
    model and clock, one epoch above the saved one."""
    from asyncframework_tpu import conf as j_conf

    reader = "port" if writer == "jax" else "jax"
    kw = dict(num_workers=1, num_iterations=10**6, bucket_ratio=0.0,
              calibration_iters=10**9)
    rs = np.random.default_rng(9)
    grads = [rs.normal(size=D).astype(np.float32) for _ in range(12)]
    mods = {"jax": j_conf, "port": t_conf}
    mods[writer].set_global_conf(
        mods[writer].AsyncConf({"async.fence.enabled": True}))
    try:
        a_list, a_map = _group(writer, _cfg(writer, **kw), 3,
                               checkpoint_dir=str(tmp_path))
    finally:
        mods[writer].set_global_conf(None)
    try:
        _feed(a_map, grads, t_sg.ShardedPSClient)
        for p in a_list:
            p.save_checkpoint()
        saved = np.concatenate([np.array(p._w, np.float32) for p in a_list])
    finally:
        for p in a_list:
            p.stop()
    shards = convert.shard_checkpoints(str(tmp_path))
    assert sorted(shards) == [0, 1, 2]
    assert all(meta["epoch"] == 1 and meta["clock"] == 12
               for meta, _arrays in shards.values())
    w, clocks, epochs = convert.assembled_ps_model(str(tmp_path))
    assert w.tobytes() == saved.tobytes()
    assert clocks == [12, 12, 12] and epochs == [1, 1, 1]
    mods[reader].set_global_conf(
        mods[reader].AsyncConf({"async.fence.enabled": True}))
    try:
        b_list, _b_map = _group(reader, _cfg(reader, **kw), 3,
                                checkpoint_dir=str(tmp_path))
    finally:
        mods[reader].set_global_conf(None)
    try:
        assert [p.epoch for p in b_list] == [2, 2, 2]
        assert [p._clock for p in b_list] == [12, 12, 12]
        back = np.concatenate([np.array(p._w, np.float32) for p in b_list])
        assert back.tobytes() == saved.tobytes()
    finally:
        for p in b_list:
            p.stop()


def test_refused_parts_of_the_group_name_their_items():
    """What stays refused: a sharded ASAGA group (ValueError, as in the
    JAX package).  The warm standbys, the CTRL fan-out and the serving
    tier's ``ShardedSubscriber`` are ported: their constructors and
    ``install_ctrl`` refuse nothing, and a subscriber over a group builds
    one stock delta-mode client a range, under each range's epoch."""
    cfg = _cfg("port")
    for group in (t_sg.ShardGroup(cfg, D, N, 2, standbys=1),
                  t_sg.ShardGroup(cfg, D, N, 2,
                                  conf_overlays={"async.ps.standby": 1})):
        assert group.standbys == 1 and group.standbys_wire() == [None, None]
        group.stop()
    group = t_sg.ShardGroup(cfg, D, N, 2)
    group.install_ctrl({"seq": 1, "ep": 0})
    assert group._ctrl == {"seq": 1, "ep": 0}
    group.stop()
    t_sg.CtrlFanout(None).stop()
    ps_list, smap = t_sg.launch_inprocess_group(cfg, D, N, 2, device=CPU)
    try:
        sub = t_sg.ShardedSubscriber(smap, epochs=[3, 4])
        assert [type(c) for c in sub.clients] == [t_ps.PSClient] * 2
        assert [(c.port, c.epoch, c.pull_mode) for c in sub.clients] == [
            (p.port, e, "delta") for p, e in zip(ps_list, (3, 4))]
        assert sub.stale_ranges(1.0) == [0, 1]
        assert sub.oldest_ok_age_ms() is None
        ts, w, clock, k, _age, done = sub.subscribe()
        assert (ts, clock, k, done) == (0, 0, 0, False)
        assert w.shape == (D,) and sub.changed_since_last
        sub.bye()
    finally:
        for ps in ps_list:
            ps.stop()
    with pytest.raises(ValueError, match="asgd"):
        t_sg.ShardGroup(cfg, D, N, 2, algo="asaga")
    with pytest.raises(ValueError, match="asgd"):
        t_sg.launch_inprocess_group(cfg, D, N, 2, device=CPU, algo="asaga")


def test_ps_child_runs_a_fenced_group_with_a_shard_kill(tmp_path):
    """``tools/ps_child.py``'s sharded ``ps`` role and ``tools/dcn.py``'s
    gates on the CPU (the card's kernel-launch gates aside): a fenced
    3-shard group of processes, two worker processes, shard 1 SIGKILLed at
    150 accepted and relaunched once from its checkpoint under epoch 2,
    every shard counting each push once, the objective band held."""
    from asyncframework_tpu_torch.tools import dcn

    kill = (1, 150)
    env = dcn.shard_env(3, True, kill, 50, str(tmp_path))
    env["PS_STDERR_DIR"] = str(tmp_path)
    ps, workers = dcn.launch("small", "asgd", 400, device="cpu",
                             timeout_s=300.0, env=env)
    rec = dcn.summarize_sharded("small", 400, ps, workers, kill)
    failed = {k for k, v in rec["gates"].items() if not v}
    # no kernel on the CPU: the launch gates are the card's
    assert failed <= {"one_launch_a_gradient", "staged_route"}, failed
    assert rec["kill"]["epoch_before"] == 1
    assert rec["per_shard"][1]["epoch"] == 2
    assert rec["per_shard"][1]["restarts"] == 1
    assert [m["epoch"] for m in rec["per_shard"]] == [1, 2, 1]
    assert {"ps_shard0.npz", "ps_shard1.npz", "ps_shard2.npz"} <= set(
        os.listdir(tmp_path))

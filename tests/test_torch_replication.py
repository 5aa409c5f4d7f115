"""The hot standby, replication and promotion on the port, against the JAX
package's own replication suite and across the packages.

- The JAX package's cases (``tests/test_replication.py``: a standby
  bootstrapped by REPL_SYNC and fed REPL_APPENDs is its primary's state
  exactly, the stream's clock-compare idempotence and its re-bootstrap
  after a blip, fence-stamped promotion and the stale-PROMOTE refusal,
  exactly-once replay against the replicated dedup window, the sharded
  client following a promoted endpoint, the protocol rows, SLO rule,
  counter family and standby telemetry, and the acceptance runs: a real
  3-shard port ``ShardGroup`` with warm standbys on the CPU, trained by
  two worker processes of the JAX package (``tests/ps_dcn_child.py``),
  whose shard-1 primary is SIGKILLed or partitioned and PROMOTED over)
  run here a second time with the modules they test swapped for the
  port's copies (the reference module's globals by monkeypatch; its lazy
  imports by aliasing the JAX module names to the port's), the serving
  tier's ``ShardedSubscriber`` following two simultaneous promotions
  included.  Left out, naming ROADMAP A8:
  ``test_k8s_renders_standby_pods`` (the k8s manifests).
- Across the packages: a JAX-package standby mirrors a port primary and a
  port standby mirrors a JAX-package primary (same clock, ledgers and
  dedup window; the models equal within the apply's last bit, ROADMAP
  C1); SUBSCRIBE of either package's client against the other's primary
  and standby, with every reply shape (FULL, NOT_MODIFIED, XDELTA); a
  port worker with ``async.trace.sample`` 0 sends PUSH headers with no
  span, as a JAX-package worker does (ROADMAP C8).
"""

import sys
import time
import types

import numpy as np
import pytest
import torch

import test_replication as ref_repl
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.metrics import slo as t_slo
from asyncframework_tpu_torch.net import faults as t_faults
from asyncframework_tpu_torch.net import protocol as t_protocol
from asyncframework_tpu_torch.net import reset_net_totals as t_reset_net
from asyncframework_tpu_torch.net.retry import reset_breakers as t_breakers
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.parallel import replication as t_repl
from asyncframework_tpu_torch.parallel import shardgroup as t_sg
from asyncframework_tpu_torch.solvers import SolverConfig

pytestmark = pytest.mark.repl

CPU = torch.device("cpu")


class _CPUParameterServer(t_ps.ParameterServer):
    """The port's PS on the CPU unless a torch device is given (the
    reference cases construct it without one, or with a JAX device)."""

    def __init__(self, *args, device=None, **kwargs):
        if not isinstance(device, (torch.device, str)):
            device = CPU
        super().__init__(*args, device=device, **kwargs)


port_ps = types.ModuleType("port_ps_dcn_on_cpu")
port_ps.__dict__.update({k: v for k, v in vars(t_ps).items()
                         if not k.startswith("__")})
port_ps.ParameterServer = _CPUParameterServer


class _CPUShardGroup(t_sg.ShardGroup):
    """The port's shard group with its children on the CPU."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)


def _cpu_inprocess_group(*args, **kwargs):
    kwargs["device"] = CPU
    return t_sg.launch_inprocess_group(*args, **kwargs)


port_sg = types.ModuleType("port_shardgroup_on_cpu")
port_sg.__dict__.update({k: v for k, v in vars(t_sg).items()
                         if not k.startswith("__")})
port_sg.ShardGroup = _CPUShardGroup
port_sg.launch_inprocess_group = _cpu_inprocess_group

#: the JAX package's module names whose lazy imports inside the reference
#: cases resolve to the port's copies while a port case runs
ALIASES = {
    "asyncframework_tpu.metrics.slo": t_slo,
}


def _clean():
    t_reset_net()
    t_sg.reset_shard_totals()
    t_repl.reset_repl_totals()
    t_breakers()
    t_faults.clear()


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    for name, mod in ALIASES.items():
        monkeypatch.setitem(sys.modules, name, mod)
    for name, value in dict(
            conf_mod=t_conf, AsyncConf=t_conf.AsyncConf,
            set_global_conf=t_conf.set_global_conf, faults=t_faults,
            reset_net_totals=t_reset_net, reset_breakers=t_breakers,
            ps_dcn=port_ps, repl_mod=t_repl, sg=port_sg,
            SolverConfig=SolverConfig).items():
        monkeypatch.setattr(ref_repl, name, value)
    _clean()
    t_conf.set_global_conf(t_conf.AsyncConf({"async.fence.enabled": True}))
    yield
    _clean()
    t_conf.set_global_conf(None)


# ---------------------------------- tests/test_replication.py on the port
class TestMirrorOnThePort(ref_repl.TestMirror):
    pass


class TestPromotionOnThePort(ref_repl.TestPromotion):
    pass


class TestSurfacesOnThePort(ref_repl.TestSurfaces):
    # the k8s manifests: ROADMAP A8
    test_k8s_renders_standby_pods = None

    def test_protocol_rows_declare_obligations(self):
        """The reference case on the port's protocol table (imported by
        name: ``from asyncframework_tpu.net import protocol`` reads the
        JAX package's attribute once that module is loaded)."""
        tbl = t_protocol.table()
        assert tbl["REPL_APPEND"].mutating
        assert not tbl["REPL_APPEND"].dedup_gated  # clock-compare idem.
        assert tbl["REPL_APPEND"].fence_stamped
        assert tbl["REPL_SYNC"].fence_stamped
        assert tbl["PROMOTE"].mutating
        assert not tbl["PROMOTE"].fence_stamped  # it RAISES the epoch

    def test_registry_has_replication_family(self):
        """The reference case on the port's registry."""
        from asyncframework_tpu_torch.metrics import registry, reset_totals

        assert "replication" in registry.families()
        assert "replication" not in registry.UNPORTED_FAMILIES
        t_repl.bump("batches_streamed")
        reset_totals()
        assert t_repl.repl_totals() == {}


def _connected(pid: int, port: int) -> bool:
    """Whether process ``pid`` holds an established TCP connection to
    ``127.0.0.1:port`` (``/proc/net/tcp`` and the process's fds)."""
    import os

    inodes = set()
    try:
        with open("/proc/net/tcp") as f:
            next(f)
            for line in f:
                cols = line.split()
                if cols[3] == "01" and int(cols[2].split(":")[1], 16) == port:
                    inodes.add(cols[9])
        fds = os.listdir(f"/proc/{pid}/fd")
    except (OSError, StopIteration):
        return False
    for fd in fds:
        try:
            link = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if link.startswith("socket:[") and link[8:-1] in inodes:
            return True
    return False


def start_together(procs, port: int, timeout_s: float = 120.0) -> None:
    """Hold the worker processes ``procs`` at the PS's door until all of
    them are there: each one that connects to ``port`` first is stopped
    (SIGSTOP; nothing supervises the workers) until the last connects,
    then all continue.  A worker child's interpreter and JAX start-up can
    outlast a whole run under load; started together, every one of them
    takes part (the runs' coverage assertions need all of them)."""
    import os
    import signal

    waiting = list(procs)
    stopped = []
    deadline = time.monotonic() + timeout_s
    try:
        while waiting and time.monotonic() < deadline:
            for p in list(waiting):
                if p.poll() is not None or _connected(p.pid, port):
                    waiting.remove(p)
                    if waiting and p.poll() is None:
                        os.kill(p.pid, signal.SIGSTOP)
                        stopped.append(p)
            time.sleep(0.01)
    finally:
        for p in stopped:
            if p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)


class _TogetherWorkers:
    """The reference cases' ``_worker``, with the two worker processes
    started together (:func:`start_together`) once both are launched."""

    def _worker(self, port, wpid, tmp, *args, **kwargs):
        p = super()._worker(port, wpid, tmp, *args, **kwargs)
        launched = self.__dict__.setdefault("_launched", [])
        launched.append(p)
        if len(launched) == 2:
            start_together(launched, int(port))
            launched.clear()
        return p


class TestFailoverAcceptanceOnThePort(_TogetherWorkers,
                                      ref_repl.TestFailoverAcceptance):
    """The acceptance runs: the port's 3-shard group of real processes
    with warm standbys on the CPU, the JAX package's worker processes
    (started together, :func:`start_together`)."""


# ------------------------------------------------------ across the packages
D, N = 8, 64


def _cfg(pkg, **kw):
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    base = dict(num_workers=2, num_iterations=10**6, gamma=1.0,
                taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                printer_freq=10, seed=42, calibration_iters=10**9,
                run_timeout_s=120.0)
    base.update(kw)
    return (JConfig if pkg == "jax" else SolverConfig)(**base)


def _ps(pkg, d=D, **kw):
    """A started PS of either package on the CPU (fencing on, as the
    standby plane runs it)."""
    from asyncframework_tpu import conf as j_conf

    if pkg == "jax":
        import jax

        j_conf.set_global_conf(j_conf.AsyncConf({"async.fence.enabled":
                                                 True}))
        try:
            return j_ps.ParameterServer(_cfg("jax"), d, N, port=0,
                                        device=jax.devices("cpu")[0],
                                        **kw).start()
        finally:
            j_conf.set_global_conf(None)
    return t_ps.ParameterServer(_cfg("port"), d, N, port=0, device=CPU,
                                **kw).start()


def _client(pkg):
    return (j_ps if pkg == "jax" else t_ps).PSClient


def _host_w(ps):
    return np.array(ps._w, np.float32)


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.parametrize("primary,standby", [("port", "jax"),
                                             ("jax", "port")])
def test_a_standby_of_either_package_mirrors_the_others_primary(primary,
                                                                standby):
    """REPL_SYNC and REPL_APPEND are the same bytes in both packages: the
    standby of one follows the primary of the other through 25 pushes
    and a re-bootstrap, with the same clock, k, ledgers, snapshot count
    and replicated dedup window, and the same model within the apply's
    last bit (XLA's reciprocal square root, ROADMAP C1)."""
    prim = _ps(primary)
    sb = _ps(standby, standby=True)
    try:
        prim.attach_standby("127.0.0.1", sb.port)
        cl = _client(primary)("127.0.0.1", prim.port)
        rng = np.random.default_rng(3)
        for _ in range(25):
            ts, _w, _a, _c = cl.pull(0)
            cl.push(0, ts, rng.normal(size=D).astype(np.float32))
        _wait(lambda: sb._clock >= prim._clock and prim.repl.synced
              and prim.repl.acked_clock >= prim._clock, 15.0,
              "the standby to catch up")
        assert (sb._clock, sb._k, sb.accepted, sb.dropped) == (
            prim._clock, prim._k, prim.accepted, prim.dropped) == (
            25, 25, 25, 0)
        assert sb.accepted_by_wid == prim.accepted_by_wid
        assert len(sb._snapshots) == len(prim._snapshots)
        state = sb._dedup.state()["sessions"]
        assert len(state[cl.session.sid]) == 25
        w_p, w_s = _host_w(prim), _host_w(sb)
        np.testing.assert_allclose(w_s, w_p, rtol=0,
                                   atol=1e-6 * float(np.abs(w_p).max()))
        # the standby serves the read plane: SUBSCRIBE by the primary's
        # package sees the standby's clock
        got = _client(primary)("127.0.0.1", sb.port).subscribe(0)
        assert got[2] == prim._clock
        cl.bye()
    finally:
        prim.stop()
        sb.stop()


@pytest.mark.parametrize("primary,standby", [("port", "jax"),
                                             ("jax", "port")])
def test_a_standby_of_either_package_mirrors_damped_pushes(primary,
                                                           standby):
    """Under an installed CTRL whose free slack is 0, every push at
    staleness >= 1 is damped: the primary decides each item's factor and
    ships it in REPL_APPEND, and the other package's standby applies it
    through its own damped apply.  The standby's model equals the
    primary's within the apply's last bit (ROADMAP C1), and is bit-equal
    to a second primary of the standby's package fed the same pushes
    under the same CTRL -- so both packages decide the same damps and
    apply them through the same expression."""
    prim = _ps(primary)
    sb = _ps(standby, standby=True)
    twin = _ps(standby)
    cls = []
    try:
        prim.attach_standby("127.0.0.1", sb.port)
        for ps in (prim, twin):
            assert ps.set_control({"seq": 1, "ep": ps.epoch or 0,
                                   "damp": [1.0, 0.1, 0.0]})
        cls = [_client(primary)("127.0.0.1", prim.port),
               _client(standby)("127.0.0.1", twin.port)]
        rng = np.random.default_rng(5)
        grads = rng.normal(size=(20, D)).astype(np.float32)
        for cl in cls:
            ts0, _w, _a, _c = cl.pull(0)
            for g in grads:
                # against the first basis: staleness climbs 0, 1, ..., 19
                cl.push(0, ts0, g.copy())
        assert prim.max_staleness == twin.max_staleness == 19
        port = prim if primary == "port" else twin
        assert port.damped_applies == 19
        _wait(lambda: sb._clock >= prim._clock and prim.repl.synced
              and prim.repl.acked_clock >= prim._clock, 15.0,
              "the standby to catch up")
        assert sb._clock == twin._clock == prim._clock == 20
        assert sb._k == twin._k == prim._k == 20
        w_p, w_s, w_t = _host_w(prim), _host_w(sb), _host_w(twin)
        np.testing.assert_allclose(w_s, w_p, rtol=0,
                                   atol=1e-6 * float(np.abs(w_p).max()))
        assert w_s.tobytes() == w_t.tobytes()
        for cl in cls:
            cl.bye()
        cls = []
    finally:
        for cl in cls:
            cl.bye()
        prim.stop()
        sb.stop()
        twin.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_subscribe_across_the_packages_every_reply_shape(server):
    """The other package's ``PSClient.subscribe`` against a primary and
    its standby: FULL, then NOT_MODIFIED, then XDELTA after a one-entry
    push, each equal to the model; the standby answers too, with the
    primary's bytes at the same clock."""
    client = "jax" if server == "port" else "port"
    d = 256
    prim = _ps(server, d=d)
    sb = _ps(server, d=d, standby=True)
    try:
        prim.attach_standby("127.0.0.1", sb.port)
        pusher = _client(server)("127.0.0.1", prim.port)
        g = np.zeros(d, np.float32)
        g[5] = 1.0
        ts, _w, _a, _c = pusher.pull(0)
        pusher.push(0, ts, g)
        sub = _client(client)("127.0.0.1", prim.port, pull_mode="delta")
        first = sub.subscribe(0)
        again = sub.subscribe(0)
        ts, _w, _a, _c = pusher.pull(0)
        pusher.push(0, ts, 2 * g)
        third = sub.subscribe(0)
        assert prim.subscribe_replies == {"full": 1, "nm": 1, "xdelta": 1}
        assert (first[0], again[0], third[0]) == (1, 1, 2)
        assert third[2] == 2 and third[3] == 2 and third[5] is False
        np.testing.assert_array_equal(first[1], again[1])
        assert third[1].tobytes() == _host_w(prim).tobytes()
        _wait(lambda: sb._clock >= prim._clock, 15.0,
              "the standby to catch up")
        from_sb = _client(client)("127.0.0.1", sb.port,
                                  pull_mode="delta")
        got = from_sb.subscribe(0)
        assert got is not None and got[2] == prim._clock
        assert got[1].tobytes() == third[1].tobytes()
        assert from_sb.subscribe(0)[0] == got[0]
        assert sb.subscribe_replies["full"] == 1
        assert sb.subscribe_replies["nm"] == 1
        for c in (pusher, sub, from_sb):
            c.bye()
    finally:
        prim.stop()
        sb.stop()


NW, NT = 2, 2048


def _worker_run(pkg, ps, sample):
    """One in-process worker process of package ``pkg`` (two logical
    workers) against ``ps``, with ``async.trace.sample`` set in its
    package's conf when ``sample`` is not None."""
    from asyncframework_tpu import conf as j_conf

    cfg = _cfg(pkg, num_workers=NW, num_iterations=40, bucket_ratio=0.0,
               printer_freq=20)
    if pkg == "jax":
        import jax

        from asyncframework_tpu.data.sharded import ShardedDataset as JDS

        rs = np.random.default_rng(7)
        X = rs.normal(size=(NT, 16)).astype(np.float32)
        y = (X @ rs.normal(size=16)).astype(np.float32)
        ds = JDS(X, y, NW, devices=[jax.devices("cpu")[0]])
        conf_mod, run = j_conf, j_ps.run_worker_process
    else:
        ds = ShardedDataset.generate_on_device(NT, 16, NW, [CPU], seed=7,
                                               noise=0.01)
        conf_mod, run = t_conf, t_ps.run_worker_process
    conf = conf_mod.AsyncConf()
    if sample is not None:
        conf.set("async.trace.sample", sample)
    conf_mod.set_global_conf(conf)
    try:
        return run("127.0.0.1", ps.port, list(range(NW)),
                   {w: ds.shard(w) for w in range(NW)}, cfg, 16, NT,
                   deadline_s=120.0)
    finally:
        conf_mod.set_global_conf(None)


@pytest.mark.parametrize("worker", ["port", "jax"])
@pytest.mark.parametrize("sample", [0.0, None])
def test_port_worker_honours_trace_sample_zero(worker, sample):
    """ROADMAP C8: with ``async.trace.sample`` 0 a worker of either
    package sends PUSH headers with no span (no ``tc``, no ``spans``);
    with the key unset (1/64) both trace their first update."""
    t_conf.set_global_conf(None)
    ps = t_ps.ParameterServer(
        SolverConfig(num_workers=NW, num_iterations=40, gamma=0.5,
                     taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                     printer_freq=20, seed=42, calibration_iters=10**9,
                     run_timeout_s=120.0),
        16, NT, device=CPU, port=0)
    headers = []
    orig = ps._handle_push

    def record(conn, header, payload):
        headers.append(dict(header))
        return orig(conn, header, payload)

    ps._handle_push = record
    ps.start()
    try:
        _worker_run(worker, ps, sample)
        assert ps.wait_done(timeout_s=30.0)
    finally:
        ps.stop()
    assert len(headers) >= 40
    traced = [h for h in headers if "tc" in h or "spans" in h]
    if sample == 0.0:
        assert traced == []
    else:
        assert traced


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_promoted_standby_checkpoints_resume_in_the_other_package(
        tmp_path, writer):
    """A promoted standby of either package checkpoints its range beside
    the primary's file (``ps_shard1.standby1.npz``); ``convert`` picks it
    over the deposed primary's older image by its (epoch, clock), and the
    other package's PS resumes from it: same model and clock, one epoch
    above the promoted one."""
    from asyncframework_tpu import conf as j_conf

    from asyncframework_tpu_torch import convert

    reader = "port" if writer == "jax" else "jax"
    prim_path = str(tmp_path / "ps_shard1.npz")
    sb_path = str(tmp_path / "ps_shard1.standby1.npz")
    prim = _ps(writer, checkpoint_path=prim_path)
    sb = _ps(writer, standby=True, checkpoint_path=sb_path)
    try:
        prim.attach_standby("127.0.0.1", sb.port)
        cl = _client(writer)("127.0.0.1", prim.port)
        rng = np.random.default_rng(4)
        for i in range(12):
            ts, _w, _a, _c = cl.pull(0)
            cl.push(0, ts, rng.normal(size=D).astype(np.float32))
            if i == 4:
                prim.save_checkpoint()  # the deposed primary's last save
        _wait(lambda: sb._clock >= 12 and prim.repl.synced, 15.0,
              "the standby to catch up")
        cl.bye()
        rep = t_sg._oneshot("127.0.0.1", sb.port,
                            {"op": "PROMOTE", "epoch": 2}, 5.0)
        assert rep["op"] == "ACK" and sb.promoted
        sb.save_checkpoint()
        saved = _host_w(sb)
    finally:
        prim.stop()
        sb.stop()
    shards = convert.shard_checkpoints(str(tmp_path))
    meta, arrays = shards[1]
    assert (meta["epoch"], meta["clock"]) == (2, 12)
    assert arrays["w"].tobytes() == saved.tobytes()
    if reader == "jax":
        import jax

        j_conf.set_global_conf(j_conf.AsyncConf({"async.fence.enabled":
                                                 True}))
        try:
            back = j_ps.ParameterServer(_cfg("jax"), D, N, port=0,
                                        device=jax.devices("cpu")[0],
                                        checkpoint_path=sb_path)
        finally:
            j_conf.set_global_conf(None)
    else:
        back = t_ps.ParameterServer(_cfg("port"), D, N, port=0, device=CPU,
                                    checkpoint_path=sb_path)
    try:
        assert back.epoch == 3 and back._clock == 12
        assert _host_w(back).tobytes() == saved.tobytes()
    finally:
        back.stop()


def test_a_sync_racing_a_snapshot_build_never_stays_published():
    """A standby's REPL_SYNC install landing between a lock-free snapshot
    build's generation check and its store (the window a SUBSCRIBE reader
    meets when a late-spawned standby syncs at the end of a run, with no
    later append to invalidate it): the stale snapshot must not stay
    published -- the next read serves the installed model at its clock."""
    import io
    import json

    prim = _ps("port")
    cl = t_ps.PSClient("127.0.0.1", prim.port)
    rng = np.random.default_rng(6)
    for _ in range(10):
        ts, _w, _a, _c = cl.pull(0)
        cl.push(0, ts, rng.normal(size=D).astype(np.float32))
    cl.bye()
    with prim._lock:
        state = prim._checkpoint_state()
    buf = io.BytesIO()
    np.savez(buf, __meta__=json.dumps(state["meta"]), **state["arrays"])

    class _RacingStandby(t_ps.ParameterServer):
        """Runs ``race`` right before a snapshot is stored."""

        race = None

        def __setattr__(self, name, value):
            race = self.__dict__.get("race")
            if name == "_snap" and value is not None and race is not None:
                self.__dict__["race"] = None
                race()
            super().__setattr__(name, value)

    sb = _RacingStandby(_cfg("port"), D, N, port=0, device=CPU,
                        standby=True).start()
    try:
        def install():
            with np.load(io.BytesIO(buf.getvalue()),
                         allow_pickle=False) as z:
                with sb._lock:
                    sb._install_state(z, json.loads(str(z["__meta__"])))

        sb.__dict__["race"] = install
        stale = sb._model_snap()  # built from the pre-install basis
        assert stale.ts == 0 and sb._clock == 10
        snap = sb._model_snap()
        assert snap.ts == 10
        assert snap.w_host.tobytes() == _host_w(prim).tobytes()
        got = t_ps.PSClient("127.0.0.1", sb.port).subscribe(0)
        assert got[0] == got[2] == 10
        assert got[1].tobytes() == _host_w(prim).tobytes()
    finally:
        prim.stop()
        sb.stop()


def test_mirror_check_waits_for_the_standby_to_serve_the_synced_version():
    """``tools/ps_child.py::mirror_check`` on a standby whose REPL_SYNC
    install races the check's first SUBSCRIBE: that reply pairs the
    installed clock with the version its build began from (ts 0, the
    zero model), as the serving core allows.  The check reads again until
    the standby serves the primary's version, and reports it bit-equal --
    it does not judge the racing reply."""
    import io
    import json

    from asyncframework_tpu_torch.tools import ps_child

    prim = _ps("port")
    cl = t_ps.PSClient("127.0.0.1", prim.port)
    rng = np.random.default_rng(7)
    for _ in range(10):
        ts, _w, _a, _c = cl.pull(0)
        cl.push(0, ts, rng.normal(size=D).astype(np.float32))
    cl.bye()
    with prim._lock:
        state = prim._checkpoint_state()
    buf = io.BytesIO()
    np.savez(buf, __meta__=json.dumps(state["meta"]), **state["arrays"])

    class _RacingStandby(t_ps.ParameterServer):
        """Installs the sync right before its first snapshot is stored."""

        race = None

        def __setattr__(self, name, value):
            race = self.__dict__.get("race")
            if name == "_snap" and value is not None and race is not None:
                self.__dict__["race"] = None
                race()
            super().__setattr__(name, value)

    sb = _RacingStandby(_cfg("port"), D, N, port=0, device=CPU,
                        standby=True).start()
    replies = []

    class _Group:
        """The two members the check reads, as a ShardGroup names them."""

        smap = types.SimpleNamespace(entries=[("127.0.0.1", prim.port)])

        @staticmethod
        def standbys_wire():
            return [("127.0.0.1", sb.port)]

    real_subscribe = t_ps.PSClient.subscribe

    def recorded(client, *args, **kwargs):
        got = real_subscribe(client, *args, **kwargs)
        replies.append((client.port, got[0], got[2]))
        return got

    try:
        def install():
            with np.load(io.BytesIO(buf.getvalue()),
                         allow_pickle=False) as z:
                with sb._lock:
                    sb._install_state(z, json.loads(str(z["__meta__"])))

        sb.__dict__["race"] = install
        t_ps.PSClient.subscribe = recorded
        out = ps_child.mirror_check(_Group, 1, timeout_s=10.0)
    finally:
        t_ps.PSClient.subscribe = real_subscribe
        prim.stop()
        sb.stop()
    # the racing reply: the synced clock beside the pre-sync version
    assert (sb.port, 0, 10) in replies
    assert out == [{"shard": 0, "primary_clock": 10, "standby_clock": 10,
                    "primary_ts": 10, "standby_ts": 10,
                    "max_abs_diff": 0.0, "equal": True}]

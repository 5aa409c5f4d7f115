"""The adaptive controller and the damped apply on the port, against the
JAX package's own controller suite and across the packages.

- The JAX package's cases (``tests/test_controller.py``: the damping law,
  the damped merge bit-equal to the damped serial apply, the decision
  units with their hysteresis, cooldown and oscillation guard driven by an
  injected clock, CTRL propagation over WELCOME, PULL and SETMAP,
  monotone and fence-stamped, the damped pushes mirrored to a standby
  exactly, control off byte-identical to the key unset, the tunables,
  family, SLO rule, status section and fan-out, and the acceptance run: a
  3-shard port group with warm standbys and an in-process port primary
  under the port's controller, two worker processes of the JAX package,
  one DELAYed, and a mid-run promotion) run here a second time with the
  modules they test swapped for the port's copies (the reference module's
  globals by monkeypatch; its lazy imports by aliasing the JAX module
  names to the port's).  Cases whose bodies build JAX arrays or JAX
  devices are rewritten for the port beside it, under the same name.
  Left out, naming ROADMAP A8: ``test_k8s_primary_shard_pod_enables_control``
  (the k8s manifests).
- The reference ``FakePS`` carries the configured pipeline depth on its
  ``cfg``; the port reads the depth from the conf only (as its workers
  do), so the twin's ``manual_controller`` hands the fake's depth to the
  controller through the conf it is given.
- Across the packages: both packages' controllers, fed the same signal
  sequence on injected clocks, make the same decisions in the same order
  and install the same CTRL payloads; a JAX-package worker under a port
  controller installs the port's CTRL (its PULLs carry the decision's
  ``cs`` stamp, and a new decision mid-run), and a port worker under a
  JAX-package controller does the same.
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import test_controller as ref_ctl
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.metrics import live as t_live
from asyncframework_tpu_torch.metrics import slo as t_slo
from asyncframework_tpu_torch.metrics import top as t_top
from asyncframework_tpu_torch.net import faults as t_faults
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net import reset_net_totals as t_reset_net
from asyncframework_tpu_torch.net.retry import reset_breakers as t_breakers
from asyncframework_tpu_torch.ops import steps as t_steps
from asyncframework_tpu_torch.parallel import controller as t_ctrl
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.parallel import shardgroup as t_sg
from asyncframework_tpu_torch.parallel import supervisor as t_sup
from asyncframework_tpu_torch.solvers import SolverConfig
from asyncframework_tpu_torch.utils.clock import ManualClock

pytestmark = pytest.mark.ctrl

CPU = torch.device("cpu")


class _CPUParameterServer(t_ps.ParameterServer):
    """The port's PS on the CPU unless a torch device is given (the
    reference cases pass a JAX device, or none)."""

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


port_sg = types.ModuleType("port_shardgroup_on_cpu")
port_sg.__dict__.update({k: v for k, v in vars(t_sg).items()
                         if not k.startswith("__")})
port_sg.ShardGroup = _CPUShardGroup


def _port_make_cfg(**kw):
    """``tests/test_controller.py::make_cfg`` on the port's SolverConfig
    (which has no ``pipeline_depth``: the conf is its one source)."""
    kw.pop("pipeline_depth", None)
    defaults = dict(
        num_workers=4, num_iterations=60, gamma=1.2, taw=2**31 - 1,
        batch_rate=0.3, bucket_ratio=0.5, printer_freq=20, seed=42,
        calibration_iters=10**9, run_timeout_s=120.0,
    )
    defaults.update(kw)
    return SolverConfig(**defaults)


class _PortFakePS(ref_ctl.FakePS):
    """The reference test double; its configured pipeline depth is kept
    beside the cfg for :func:`_port_manual_controller`."""

    def __init__(self, num_workers=8, bucket_ratio=1.0, pipeline_depth=0,
                 merge_max=8, epoch=0):
        super().__init__(num_workers=num_workers, bucket_ratio=bucket_ratio,
                         pipeline_depth=pipeline_depth, merge_max=merge_max,
                         epoch=epoch)
        self.pipeline_depth = pipeline_depth


def _port_manual_controller(ps, **kw):
    clk = ManualClock()
    conf = t_conf.AsyncConf().set("async.pipeline.depth",
                                  getattr(ps, "pipeline_depth", 0))
    ctl = t_ctrl.AsyncController(ps, conf=conf,
                                 now_fn=lambda: clk.now_ms() / 1e3, **kw)
    return ctl, clk


#: the JAX package's module names whose lazy imports inside the reference
#: cases resolve to the port's copies while a port case runs
ALIASES = {
    "asyncframework_tpu.metrics.slo": t_slo,
}


def _clean():
    t_reset_net()
    t_breakers()
    t_ctrl.reset_control_totals()
    t_sg.reset_shard_totals()
    t_faults.clear()


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    for name, mod in ALIASES.items():
        monkeypatch.setitem(sys.modules, name, mod)
    for name, value in dict(
            conf_mod=t_conf, AsyncConf=t_conf.AsyncConf,
            set_global_conf=t_conf.set_global_conf,
            render_control=t_top.render_control,
            render_fleet=t_top.render_fleet,
            render_status=t_top.render_status, faults=t_faults,
            frame=t_frame, reset_net_totals=t_reset_net,
            reset_breakers=t_breakers, ctrl_mod=t_ctrl, ps_dcn=port_ps,
            sg=port_sg, CONTROLLER_TUNABLES=t_ctrl.CONTROLLER_TUNABLES,
            AsyncController=t_ctrl.AsyncController,
            ControlSink=t_ctrl.ControlSink, ctrl_seq=t_ctrl.ctrl_seq,
            SolverConfig=SolverConfig, ManualClock=ManualClock,
            make_cfg=_port_make_cfg, FakePS=_PortFakePS,
            manual_controller=_port_manual_controller).items():
        monkeypatch.setattr(ref_ctl, name, value)
    _clean()
    t_conf.set_global_conf(t_conf.AsyncConf())
    yield
    _clean()
    t_conf.set_global_conf(None)


# ----------------------------------- tests/test_controller.py on the port
class TestDampLawOnThePort(ref_ctl.TestDampLaw):
    pass


class TestKernelExactnessOnThePort(ref_ctl.TestKernelExactness):
    def test_damped_merge_bit_identical_to_damped_serial(self):
        """The reference case on the port's functions: the merge at
        damps ``[1.0, 0.37, 0.1, 0.85]`` is bit-equal to four serial
        damped applies."""
        w0, G = self._mats(ref_ctl.CHAOS_SEED)
        damps = np.array([1.0, 0.37, 0.1, 0.85], np.float32)
        merge = t_steps.make_asgd_apply_merge(1.2, 0.3, 64, 4)
        serial = t_steps.make_asgd_apply_damped(1.2, 0.3, 64, 4)
        wm, km = merge(torch.from_numpy(w0), torch.from_numpy(G),
                       torch.from_numpy(damps), torch.tensor(0.0))
        ws, ks = torch.from_numpy(w0), torch.tensor(0.0)
        for j in range(self.M):
            ws, ks = serial(ws, torch.from_numpy(G[j]), ks,
                            np.float32(damps[j]))
        assert wm.numpy().tobytes() == ws.numpy().tobytes()
        assert float(km) == float(ks) == 4.0

    def test_damp_one_bit_identical_to_legacy_kernel(self):
        """The reference case on the port's functions: damp 1.0 in every
        slot is bit-equal to serial ``make_asgd_apply``."""
        w0, G = self._mats(ref_ctl.CHAOS_SEED + 1)
        merge = t_steps.make_asgd_apply_merge(1.2, 0.3, 64, 4)
        legacy = t_steps.make_asgd_apply(1.2, 0.3, 64, 4)
        wm, _ = merge(torch.from_numpy(w0), torch.from_numpy(G),
                      torch.ones(self.M), torch.tensor(0.0))
        wl, kl = torch.from_numpy(w0), torch.tensor(0.0)
        for j in range(self.M):
            wl, kl = legacy(wl, torch.from_numpy(G[j]), kl)
        assert wm.numpy().tobytes() == wl.numpy().tobytes()


@pytest.mark.parametrize("k0", [0.0, 37.0])
def test_damped_applies_agree_with_the_jax_package(k0):
    """The same ``(w, G, damps, k)`` through both packages: the port's
    damped merge and its serial damped applies agree with the JAX
    package's ``make_asgd_apply_merge`` and ``make_asgd_apply_damped``
    within the apply's last bit (XLA's reciprocal square root, ROADMAP
    C1), slot by slot, and advance ``k`` alike.  The port's own
    bit-equality of merge and serial apply is checked above; this holds
    both against an expression the port does not share."""
    from asyncframework_tpu.ops import steps as j_steps

    gamma, br, n, P, d, m = 1.2, 0.3, 64, 4, 96, 8
    rs = np.random.default_rng(ref_ctl.CHAOS_SEED + 2)
    w0 = rs.normal(size=d).astype(np.float32)
    G = rs.normal(size=(m, d)).astype(np.float32)
    damps = rs.uniform(0.05, 1.0, size=m).astype(np.float32)
    damps[2] = 1.0
    tol = lambda ref: 1e-6 * float(np.abs(ref).max())  # noqa: E731

    tw, tk = t_steps.make_asgd_apply_merge(gamma, br, n, P)(
        torch.from_numpy(w0), torch.from_numpy(G), torch.from_numpy(damps),
        torch.tensor(k0))
    jw, jk = j_steps.make_asgd_apply_merge(gamma, br, n, P)(
        w0, G, damps, np.float32(k0))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=tol(np.asarray(jw)))
    assert float(tk) == float(jk) == k0 + m

    t_serial = t_steps.make_asgd_apply_damped(gamma, br, n, P)
    j_serial = j_steps.make_asgd_apply_damped(gamma, br, n, P)
    ts_w, ts_k = torch.from_numpy(w0), torch.tensor(k0)
    js_w, js_k = np.array(w0), np.float32(k0)
    for j in range(m):
        ts_w, ts_k = t_serial(ts_w, torch.from_numpy(G[j]), ts_k,
                              np.float32(damps[j]))
        # the JAX apply donates g and k: hand it fresh copies
        js_w, js_k = j_serial(js_w, np.array(G[j]), np.float32(js_k),
                              np.float32(damps[j]))
        np.testing.assert_allclose(ts_w.numpy(), np.asarray(js_w), rtol=0,
                                   atol=tol(np.asarray(js_w)))
    assert float(ts_k) == float(js_k) == k0 + m
    assert ts_w.numpy().tobytes() == tw.numpy().tobytes()
    # a damp below 1 really moves the step: the undamped model differs
    und, _ = t_steps.make_asgd_apply_merge(gamma, br, n, P)(
        torch.from_numpy(w0), torch.from_numpy(G), torch.ones(m),
        torch.tensor(k0))
    assert not torch.equal(und, tw)


class TestDecisionUnitsOnThePort(ref_ctl.TestDecisionUnits):
    pass


class TestCtrlPropagationOnThePort(ref_ctl.TestCtrlPropagation):
    pass


def _wire_quiet(timeout_s: float = 10.0) -> None:
    """Wait, up to ``timeout_s``, until no PS connection handler of this
    process is alive: the frame-byte totals are process-wide, and a
    handler of an earlier server still answering its last request (a
    stopped PS leaves them to drain) counts its reply into whatever run
    is being measured."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not any(t.name.startswith("ps-conn-") and t.is_alive()
                   for t in threading.enumerate()):
            return
        time.sleep(0.02)


class TestControlOffIsClassicOnThePort(ref_ctl.TestControlOffIsClassic):
    def test_enabled0_conf_set_matches_unset_byte_identical(self):
        """The reference case with the port's dataset on the CPU: per-op
        frame-byte totals, counts and the merge ledger equal with
        ``async.control.enabled=0`` and with the key unset.  Each run is
        measured between quiet wires (:func:`_wire_quiet`)."""
        results = []
        for control_conf in (None, "0"):
            conf = (t_conf.AsyncConf().set("async.pull.mode", "full")
                    .set("async.trace.sample", 0.0))
            if control_conf is not None:
                conf.set("async.control.enabled", control_conf)
            t_conf.set_global_conf(conf)
            _wire_quiet()
            t_reset_net()
            cfg = _port_make_cfg(num_workers=1, num_iterations=40,
                                 bucket_ratio=0.0)
            ds = ShardedDataset.generate_on_device(
                512, 16, 1, [CPU], seed=11, noise=0.01)
            ps = _CPUParameterServer(cfg, 16, 512, port=0).start()
            try:
                counts = t_ps.run_worker_process(
                    "127.0.0.1", ps.port, [0], {0: ds.shard(0)}, cfg,
                    16, 512, deadline_s=120.0)
                assert ps.wait_done(timeout_s=10.0)
            finally:
                ps.stop()
            _wire_quiet()
            results.append({
                "accepted": ps.accepted, "dropped": ps.dropped,
                "max_staleness": ps.max_staleness, "clock": ps._clock,
                "counts": dict(counts),
                "bytes": t_frame.bytes_totals(),
            })
        unset, off = results
        assert unset["accepted"] == off["accepted"] == 40
        assert unset == off, (unset, off)


class TestSurfacesOnThePort(ref_ctl.TestSurfaces):
    # the k8s manifests: ROADMAP A8
    test_k8s_primary_shard_pod_enables_control = None

    def test_registry_has_control_family(self):
        """The reference case on the port's registry."""
        from asyncframework_tpu_torch.metrics import registry

        fams = registry.families()
        assert "control" in fams
        assert "control" not in registry.UNPORTED_FAMILIES
        tot = fams["control"].totals()
        assert "changes" in tot and "osc_trips" in tot
        assert "control" in registry.series_families()

    def test_controller_status_section_registered(self):
        """The reference case with the port's ``metrics.live`` imported by
        name (``from asyncframework_tpu.metrics import live`` reads the
        JAX package's attribute once that module is loaded)."""
        ps = _CPUParameterServer(_port_make_cfg(), 8, 64, port=0)
        ctl = t_ctrl.AsyncController(ps, conf=t_conf.AsyncConf()).start()
        try:
            status = t_live.process_status("driver")
            assert status["control"]["enabled"] is True
            assert status["control"]["seq"] >= 1
            assert ps.ctrl is not None  # start() installed the law
        finally:
            ctl.stop()
            ps.stop()
            status = t_live.process_status("driver")
            assert "control" not in status


class _BringUpSupervisor(t_sup.ElasticSupervisor):
    """The port's elastic supervisor with a boot grace that covers the
    worker processes' bring-up: a logical worker no process has claimed
    yet is handed to a live process only after ``boot_grace_s`` (10 s by
    default), and a JAX-package worker child's interpreter, data and
    first compile can take longer than that on a loaded host -- its
    shards then go to the other process, which serves all 8 behind its
    PUSH delay and misses the run's budget."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("boot_grace_s", 120.0)  # the workers' deadline
        super().__init__(*args, **kwargs)


def _stable_free_port(host: str = "127.0.0.1") -> int:
    """A free port below the ephemeral range (``ip_local_port_range``
    starts at 32768 by default)."""
    import random
    import socket

    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("0.0.0.0", port))  # free on every interface
            except OSError:
                continue
        return port
    return t_frame.free_port(host)


stable_port_frame = types.ModuleType("port_frame_stable_ports")
stable_port_frame.__dict__.update({k: v for k, v in vars(t_frame).items()
                                   if not k.startswith("__")})
stable_port_frame.free_port = _stable_free_port

bring_up_sup = types.ModuleType("port_supervisor_bring_up")
bring_up_sup.__dict__.update({k: v for k, v in vars(t_sup).items()
                              if not k.startswith("__")})
bring_up_sup.ElasticSupervisor = _BringUpSupervisor


class TestWanDelayAcceptanceOnThePort(ref_ctl.TestWanDelayAcceptance):
    """The acceptance run: the port's in-process primary and controller
    and its 2-shard child group with warm standbys on the CPU, the JAX
    package's worker processes (one DELAYed).  Its primary runs an
    elastic supervisor, so its workers are not held at the door
    (``tests/test_torch_replication.py::start_together``: a stopped
    worker would be declared dead); the supervisor waits for their
    bring-up instead (:class:`_BringUpSupervisor`)."""

    def test_controller_on_heterogeneous_cluster_with_promotion(
            self, tmp_path, monkeypatch):
        # the reference case's elastic supervisor, the port's
        monkeypatch.setitem(sys.modules,
                            "asyncframework_tpu.parallel.supervisor",
                            bring_up_sup)
        # its primary's port is reserved, released, then bound: taken
        # below the ephemeral range, where no other process's port-0
        # bind can take it in between
        monkeypatch.setattr(ref_ctl, "frame", stable_port_frame)
        super().test_controller_on_heterogeneous_cluster_with_promotion(
            tmp_path)


# ------------------------------------------------------ across the packages
class _Observer:
    def __init__(self):
        self.table = {}

    def derived(self):
        return {}

    def stragglers(self):
        return dict(self.table)


def _controller(pkg, depth):
    """A controller of package ``pkg`` over the reference's test double
    (both packages' controllers read the same surface of it)."""
    from asyncframework_tpu import conf as j_conf
    from asyncframework_tpu.parallel import controller as j_ctrl

    conf_mod, ctrl_mod = ((j_conf, j_ctrl) if pkg == "jax"
                          else (t_conf, t_ctrl))
    ps = _PortFakePS(num_workers=8, bucket_ratio=1.0, epoch=1)
    obs = _Observer()
    clk = ManualClock()
    ctl = ctrl_mod.AsyncController(
        ps, conf=conf_mod.AsyncConf().set("async.pipeline.depth", depth),
        observer=obs, now_fn=lambda: clk.now_ms() / 1e3)
    return ps, obs, clk, ctl


def _signal_script(seed):
    """A seeded sequence of (advance_ms, worker stats, queue depth,
    observer table): stragglers appear and clear, latencies drift,
    the merge queue fills and drains."""
    rs = np.random.default_rng(seed)
    script = []
    for t in range(60):
        stats = {}
        for w in range(8):
            iv = float(rs.uniform(8.0, 12.0))
            if w in (3, 5) and 15 <= t < 35:
                iv *= float(rs.uniform(8.0, 40.0))
            stats[str(w)] = {"accepted": 50 + t, "interval_ms": iv,
                             "rtt_ms": float(rs.uniform(5.0, 60.0)),
                             "compute_ms": float(rs.uniform(5.0, 15.0))}
        queue = float(rs.choice([0.0, 0.0, 1.0, 6.0, 20.0]))
        table = ({"6": {"score": float(rs.uniform(2.5, 6.0)),
                        "flagged": True}} if 20 <= t < 45 else {})
        script.append((int(rs.choice([400, 1500, 3000, 6000])), stats,
                       queue, table))
    return script


@pytest.mark.parametrize("seed", [3, 11])
def test_both_packages_controllers_decide_alike(seed):
    """The same signal sequence on injected clocks: every tick's decision
    record, the committed decision log, the CTRL payloads installed and
    the control counters are equal between the packages."""
    from asyncframework_tpu.parallel import controller as j_ctrl

    runs = {}
    for pkg in ("jax", "port"):
        (j_ctrl if pkg == "jax" else t_ctrl).reset_control_totals()
        ps, obs, clk, ctl = _controller(pkg, depth=4)
        ctl._install("start")
        ticks = []
        for adv, stats, queue, table in _signal_script(seed):
            clk.advance(adv)
            ps.wstats = stats
            ps.signals["queue_depth"] = queue
            obs.table = table
            ticks.append(ctl.tick())
        runs[pkg] = (ticks, ctl.decision_log(), ps.installed,
                     (j_ctrl if pkg == "jax" else t_ctrl).control_totals())
    assert runs["jax"] == runs["port"]
    ticks, log, installed, totals = runs["port"]
    assert totals["changes"] >= 3 and len(installed) >= 3
    knobs = {d["knob"] for d in log}
    assert "b" in knobs and "wdamp" in knobs and len(knobs) >= 3


def _recording_ps(pkg, cfg_kw):
    """A started PS of either package on the CPU that records the ``cs``
    stamp of every PULL it serves."""
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    if pkg == "jax":
        import jax

        ps = j_ps.ParameterServer(JConfig(**cfg_kw), 16, 2048, port=0,
                                  device=jax.devices("cpu")[0])
    else:
        ps = t_ps.ParameterServer(SolverConfig(**cfg_kw), 16, 2048, port=0,
                                  device=CPU)
    stamps = []
    orig = ps._handle_pull

    def record(conn, header):
        stamps.append(header.get("cs"))
        return orig(conn, header)

    ps._handle_pull = record
    return ps, stamps


@pytest.mark.parametrize("server,worker", [("port", "jax"),
                                           ("jax", "port")])
def test_a_worker_of_either_package_installs_the_others_ctrl(server,
                                                             worker):
    """A controlled PS of one package serves CTRL on WELCOME; the other
    package's worker process builds its control sink from it, stamps
    every PULL with the decision it holds, and installs a new decision
    the PS hands out mid-run (its later PULLs carry the new stamp)."""
    from asyncframework_tpu import conf as j_conf
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    nw, iters = 2, 160
    cfg_kw = dict(num_workers=nw, num_iterations=iters, gamma=0.5,
                  taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                  printer_freq=40, seed=42, calibration_iters=10**9,
                  run_timeout_s=120.0)
    ps, stamps = _recording_ps(server, cfg_kw)
    ps.set_control({"seq": 1, "ep": 0, "damp": [1.0, 0.05, 100.0],
                    "b": 0, "depth": 0, "merge": 0})
    ps.start()
    stop = threading.Event()

    def second_decision():
        while not stop.is_set() and ps.accepted < iters // 3:
            time.sleep(0.005)
        ps.set_control({"seq": 2, "ep": 0, "damp": [1.0, 0.05, 100.0],
                        "b": 0, "depth": 0, "merge": 0})

    bump = threading.Thread(target=second_decision, daemon=True)
    bump.start()
    try:
        if worker == "jax":
            import jax

            from asyncframework_tpu.data.sharded import (
                ShardedDataset as JDS,
            )

            rs = np.random.default_rng(7)
            X = rs.normal(size=(2048, 16)).astype(np.float32)
            y = (X @ rs.normal(size=16)).astype(np.float32)
            ds = JDS(X, y, nw, devices=[jax.devices("cpu")[0]])
            cfg, run = JConfig(**cfg_kw), j_ps.run_worker_process
            j_conf.set_global_conf(j_conf.AsyncConf())
        else:
            ds = ShardedDataset.generate_on_device(2048, 16, nw, [CPU],
                                                   seed=7, noise=0.01)
            cfg, run = SolverConfig(**cfg_kw), t_ps.run_worker_process
        counts = run("127.0.0.1", ps.port, list(range(nw)),
                     {w: ds.shard(w) for w in range(nw)}, cfg, 16, 2048,
                     deadline_s=120.0)
        assert ps.wait_done(timeout_s=30.0)
    finally:
        stop.set()
        bump.join(timeout=10.0)
        ps.stop()
        j_conf.set_global_conf(None)
    assert sum(counts.values()) >= iters and ps.accepted == iters
    seen = [tuple(s) for s in stamps if s is not None]
    # every PULL of the controlled worker carried a stamp
    assert len(seen) == len(stamps) > 0
    assert seen[0] == (0, 1)
    # the mid-run decision reached the worker: its later PULLs stamp
    # seq 2 (a PULL already in flight at the install may still carry 1)
    assert (0, 2) in seen and seen[-1] == (0, 2)


@pytest.mark.parametrize("control", ["off", "on"])
def test_replies_are_byte_identical_to_the_jax_packages(control):
    """One JAX-package client drives the same HELLO, PULL/PUSH rounds and
    BYE against a port PS and a JAX-package PS: every reply it receives
    (WELCOME, MODEL, ACK) is the same number of bytes per op from both,
    with control off (no CTRL key anywhere: the classic wire) and with
    the same CTRL installed on both (the MODEL replies carry it)."""
    import jax

    from asyncframework_tpu.net import frame as j_frame
    from asyncframework_tpu.solvers import SolverConfig as JConfig

    kw = dict(num_workers=1, num_iterations=10**6, gamma=0.5,
              taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
              printer_freq=10**6, seed=42, calibration_iters=10**9,
              run_timeout_s=60.0)
    wire = {"seq": 1, "ep": 0, "damp": [1.0, 0.1, 2.0], "b": 0,
            "depth": 0, "merge": 0}
    rs = np.random.default_rng(8)
    grads = [rs.normal(size=8).astype(np.float32) for _ in range(6)]
    replies = {}
    for server in ("port", "jax"):
        if server == "port":
            ps = t_ps.ParameterServer(SolverConfig(**kw), 8, 64, port=0,
                                      device=CPU)
        else:
            ps = j_ps.ParameterServer(JConfig(**kw), 8, 64, port=0,
                                      device=jax.devices("cpu")[0])
        if control == "on":
            ps.set_control(dict(wire))
        ps.start()
        try:
            j_frame.reset_bytes_totals()
            cl = j_ps.PSClient("127.0.0.1", ps.port)
            welcome = cl.hello("bytes-probe", [0], pid=1)
            for g in grads:
                ts, _w, _a, _c = cl.pull(0)
                cl.push(0, ts, g)
            cl.bye()
            totals = j_frame.bytes_totals()
        finally:
            ps.stop()
        replies[server] = (sorted(welcome), {
            op: totals.get(f"recv.{op}", 0)
            for op in ("WELCOME", "MODEL", "ACK")})
    assert replies["port"] == replies["jax"]
    keys, by_op = replies["port"]
    assert ("ctrl" in keys) == (control == "on")
    assert all(by_op.values())

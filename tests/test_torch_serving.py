"""The port's serving tier against the JAX package's own serving suite and
across the packages.

- The JAX package's cases (``tests/test_serving.py``: the predict step, a
  replica's refresh byte-exact to a direct pull with NM/XDELTA/FULL and
  the CRC fallback, the freshness lag and the staleness SLO, chaos on
  SUBSCRIBE and PREDICT, the SIGKILL-mid-load acceptance with two real
  replica processes, the frontend's rotation, registration, reclaim and
  re-HELLO, and the serving counters) run here a second time with the
  modules they test swapped for the port's copies on the CPU (the
  reference module's globals by monkeypatch; its replica processes are the
  port's ``serving.cli`` under ``ASYNCTPU_FORCE_CPU=1``).
- Across the packages: a port replica serves a JAX-package PS's model and
  a JAX-package replica a port PS's, byte for byte; a port frontend fails
  over between JAX-package replicas and a JAX-package frontend between
  port replicas; PREDICT agrees with the JAX package's
  ``make_predict_step`` on the same rows (least squares within rtol 1e-5
  of the batch's largest score, the accumulation order differing;
  logistic within atol 1e-6), through every power-of-two bucket a replica
  pads to.
- No fallback: ``serving.cli replica`` without a card and without
  ``ASYNCTPU_FORCE_CPU=1`` exits non-zero before binding, and a replica
  built with no device raises where there is no card.

The card's cases (the refresh-against-PREDICT race, a replica process's
PREDICT against the CPU's) are in ``tests/test_torch_cuda.py``, which runs
on the card's machine, where there is no JAX.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import asyncframework_tpu.serving  # noqa: F401  (before any alias below)
import test_serving as ref_srv
from torch_procs import kill_and_reap, readline_within
from asyncframework_tpu.ops import steps as j_steps
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu.serving import frontend as j_frontend
from asyncframework_tpu.serving import replica as j_replica
from asyncframework_tpu.solvers import SolverConfig as JConfig
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.metrics import live as t_live
from asyncframework_tpu_torch.metrics import reset_totals as t_reset_totals
from asyncframework_tpu_torch.metrics import timeseries as t_ts
from asyncframework_tpu_torch.net import faults as t_faults
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net.retry import reset_breakers as t_breakers
from asyncframework_tpu_torch.ops import steps as t_steps
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.serving import PredictError, ServingFrontend
from asyncframework_tpu_torch.serving import metrics as t_smetrics
from asyncframework_tpu_torch.serving import replica as t_rep
from asyncframework_tpu_torch.solvers import SolverConfig
from torch_serving_support import (
    CPU,
    CPUModelReplica,
    cpu_serve_replica,
    port_ps,
    port_replica,
    clean_jax_package,
    port_subprocess,
)

pytestmark = pytest.mark.serve

REPO = Path(__file__).parent.parent


@pytest.fixture()
def devices8():
    """The reference cases' JAX device list, as the port's CPU devices."""
    return [CPU] * 8


def _clean():
    t_ts.stop_sampler()
    t_reset_totals()
    t_breakers()
    t_faults.clear()


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    """Point the reference module's globals at the port's copies and leave
    the port's process-global serving state clean."""
    monkeypatch.setitem(sys.modules, "asyncframework_tpu.serving.replica",
                        port_replica)
    for name, value in dict(
            set_global_conf=t_conf.set_global_conf,
            ShardedDataset=ShardedDataset, reset_totals=t_reset_totals,
            LiveStateListener=t_live.LiveStateListener, _frame=t_frame,
            faults=t_faults, CUT_MID_FRAME=t_faults.CUT_MID_FRAME,
            DROP_REPLY=t_faults.DROP_REPLY,
            FaultSchedule=t_faults.FaultSchedule,
            reset_breakers=t_breakers, steps=t_steps, ps_dcn=port_ps,
            ModelReplica=CPUModelReplica, PredictError=PredictError,
            ServingFrontend=ServingFrontend,
            serve_replica=cpu_serve_replica, smetrics=t_smetrics,
            SolverConfig=SolverConfig,
            subprocess=port_subprocess).items():
        monkeypatch.setattr(ref_srv, name, value)
    _clean()
    yield
    _clean()
    clean_jax_package()
    t_conf.set_global_conf(None)


# --------------------------------------- tests/test_serving.py on the port
class TestPredictStepOnThePort(ref_srv.TestPredictStep):
    pass


class TestReplicaRefreshOnThePort(ref_srv.TestReplicaRefresh):
    pass


class TestFreshnessLagOnThePort(ref_srv.TestFreshnessLag):
    pass


class TestServingChaosOnThePort(ref_srv.TestServingChaos):
    pass


class TestKillNineAcceptanceOnThePort(ref_srv.TestKillNineAcceptance):
    pass


class TestFrontendOnThePort(ref_srv.TestFrontend):
    pass


class TestServingCountersOnThePort(ref_srv.TestServingCounters):
    pass


# ------------------------------------------------------ across the packages
def _cfg(pkg, **kw):
    kw = dict(dict(num_workers=2, num_iterations=10_000, gamma=1.2,
                   taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                   printer_freq=10, seed=42, calibration_iters=4,
                   run_timeout_s=60.0), **kw)
    return (JConfig if pkg == "jax" else SolverConfig)(**kw)


def _start_ps(pkg, d=16, n=256):
    if pkg == "jax":
        return j_ps.ParameterServer(_cfg("jax"), d, n, port=0).start()
    return t_ps.ParameterServer(_cfg("port"), d, n, device=CPU,
                                port=0).start()


def _replica(pkg, port, rid=0, **kw):
    kw.setdefault("refresh_interval_s", 999.0)
    if pkg == "jax":
        return j_replica.ModelReplica("127.0.0.1", port, rid=rid,
                                      host="127.0.0.1", **kw).start()
    return t_rep.ModelReplica("127.0.0.1", port, rid=rid, host="127.0.0.1",
                              device=CPU, **kw).start()


def _frontend(pkg, endpoints, **kw):
    cls = (j_frontend.ServingFrontend if pkg == "jax" else ServingFrontend)
    return cls(endpoints, **kw).start()


def _push(cl, d, rng, scale=0.1):
    ts, _w, _avg, _cal = cl.pull(0)
    cl.push(0, ts, (scale * rng.normal(size=d)).astype(np.float32))


def _predict_raw(port, X):
    sock = t_frame.connect(("127.0.0.1", port))
    try:
        t_frame.send_msg(sock, {"op": "PREDICT", "n": X.shape[0]},
                         np.ascontiguousarray(X, np.float32).tobytes())
        return t_frame.recv_msg(sock)
    finally:
        sock.close()


@pytest.mark.parametrize("ps_pkg,rep_pkg", [("jax", "port"),
                                            ("port", "jax")])
def test_replica_serves_the_other_packages_ps_byte_exactly(ps_pkg, rep_pkg):
    """A replica of one package subscribes to the other's PS: after every
    version (FULL, then XDELTA/FULL, then NOT_MODIFIED) it serves the
    bytes a direct SUBSCRIBE of the PS's own package returns, and its
    PREDICT is that model's product."""
    d = 16
    rng = np.random.default_rng(3)
    ps = _start_ps(ps_pkg, d=d)
    rep = None
    try:
        client_mod = j_ps if ps_pkg == "jax" else t_ps
        pusher = client_mod.PSClient("127.0.0.1", ps.port, pull_mode="full")
        rep = _replica(rep_pkg, ps.port)
        for _ in range(4):
            _push(pusher, d, rng)
            assert rep.refresh_once()
            direct = client_mod.PSClient("127.0.0.1", ps.port,
                                         pull_mode="delta").subscribe(9)
            assert rep._served.ts == direct[0] == ps._clock
            assert rep._served.w_host.tobytes() == direct[1].tobytes()
        assert rep.refresh_once()  # unchanged: NOT_MODIFIED
        assert rep._client.pull_wenc["nm"] >= 1
        X = rng.normal(size=(5, d)).astype(np.float32)
        hdr, payload = _predict_raw(rep.port, X)
        assert hdr["op"] == "PREDICTION" and hdr["ts"] == ps._clock
        want = X.astype(np.float64) @ direct[1].astype(np.float64)
        scale = np.abs(X).astype(np.float64) @ np.abs(direct[1])
        assert np.all(np.abs(np.frombuffer(payload, np.float32) - want)
                      <= 1e-5 * scale)
        pusher.bye()
    finally:
        if rep is not None:
            rep.stop()
        ps.stop()


@pytest.mark.parametrize("fe_pkg,rep_pkg", [("port", "jax"),
                                            ("jax", "port")])
def test_frontend_fails_over_the_other_packages_replicas(fe_pkg, rep_pkg):
    """A frontend of one package round-robins two replicas of the other,
    then keeps answering from the survivor once one is stopped."""
    d = 16
    rng = np.random.default_rng(4)
    ps = _start_ps("port", d=d)
    reps, fe = [], None
    try:
        pusher = t_ps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        _push(pusher, d, rng)
        reps = [_replica(rep_pkg, ps.port, rid=r) for r in range(2)]
        assert all(r.refresh_once() for r in reps)
        fe = _frontend(fe_pkg, [("127.0.0.1", r.port) for r in reps],
                       deadline_s=2.0)
        X = rng.normal(size=(3, d)).astype(np.float32)
        w = reps[0]._served.w_host
        seen = set()
        for _ in range(4):
            y, meta = fe.predict_ex(X)
            np.testing.assert_allclose(y, X @ w, rtol=1e-5, atol=1e-6)
            seen.add(meta["endpoint"])
        assert len(seen) == 2
        reps[0].stop()
        for _ in range(4):
            y, meta = fe.predict_ex(X)
            np.testing.assert_allclose(y, X @ w, rtol=1e-5, atol=1e-6)
            assert meta["endpoint"].endswith(str(reps[1].port))
        pusher.bye()
    finally:
        if fe is not None:
            fe.stop()
        for r in reps:
            r.stop()
        ps.stop()


@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_predict_matches_the_jax_packages_step(loss):
    """The predict step against the JAX package's on the same rows, and a
    port replica's PREDICT through each power-of-two bucket it pads to
    (1, 3, 17, 64 and 256 rows) against the same step."""
    rs = np.random.default_rng(5)
    d = 24
    w = rs.normal(size=d).astype(np.float32)

    def close(got, want):
        # least squares: rtol 1e-5 of the batch's largest score (a row
        # whose terms cancel has no relative digits to keep); logistic:
        # atol 1e-6 on the probabilities
        if loss == "least_squares":
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
        else:
            np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)

    j_step, t_step = (j_steps.make_predict_step(loss),
                      t_steps.make_predict_step(loss))
    for n in (1, 3, 17, 64, 256):
        X = rs.normal(size=(n, d)).astype(np.float32)
        want = np.asarray(j_step(X, w))
        got = t_step(torch.from_numpy(X), torch.from_numpy(w)).numpy()
        close(got, want)
    ps = _start_ps("port", d=d)
    rep = None
    try:
        cl = t_ps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        _push(cl, d, rs, scale=1.0)
        rep = _replica("port", ps.port, loss=loss)
        assert rep.refresh_once()
        w_srv = rep._served.w_host
        for n in (1, 3, 17, 64, 256):
            X = rs.normal(size=(n, d)).astype(np.float32)
            hdr, payload = _predict_raw(rep.port, X)
            assert hdr["op"] == "PREDICTION" and hdr["n"] == n
            close(np.frombuffer(payload, np.float32),
                  np.asarray(j_step(X, w_srv)))
        cl.bye()
    finally:
        if rep is not None:
            rep.stop()
        ps.stop()


def test_replica_without_a_device_raises_where_there_is_no_card():
    """The entry points never fall back to the CPU: a replica built with
    no device takes the card, and raises where there is none (before it
    binds anything)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rep.ModelReplica("127.0.0.1", 1, rid=0, host="127.0.0.1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rep.serve_replica("127.0.0.1:1", host="127.0.0.1",
                            announce=lambda *a, **k: None)


def test_cli_replica_without_a_card_or_force_cpu_exits_nonzero():
    """``serving.cli replica`` on a machine without a card and without
    ``ASYNCTPU_FORCE_CPU=1`` raises before binding (no JSON line), while
    the frontend, which holds no model, starts; with the variable the
    replica starts on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "ASYNCTPU_FORCE_CPU"}
    env["PYTHONPATH"] = str(REPO)
    cmd = [sys.executable, "-m", "asyncframework_tpu_torch.serving.cli",
           "replica", "--ps", "127.0.0.1:1", "--host", "127.0.0.1"]
    res = subprocess.run(cmd, env=env, cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr and "ASYNCTPU_FORCE_CPU" in \
        res.stderr
    for argv, force in ((cmd, "1"),
                        (cmd[:3] + ["frontend", "--host", "127.0.0.1"], None)):
        penv = dict(env, ASYNCTPU_FORCE_CPU=force) if force else env
        proc = subprocess.Popen(argv, env=penv, cwd=str(REPO),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        try:
            line = json.loads(readline_within(proc))
            assert line["role"] == argv[3] and line["port"] > 0
            assert line["pid"] == proc.pid
        finally:
            kill_and_reap(proc)


def test_replica_status_names_its_device_and_reuses_it_only_when_unchanged():
    """STATUS names the served model's device; an unchanged version keeps
    the published tensor, a new version gets a new one (a published
    tensor is never written in place)."""
    d = 8
    rng = np.random.default_rng(6)
    ps = _start_ps("port", d=d)
    rep = None
    try:
        cl = t_ps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        _push(cl, d, rng)
        rep = _replica("port", ps.port)
        assert rep.refresh_once()
        first = rep._served
        before = first.w_dev.clone()
        assert rep.status()["device"] == "cpu"
        assert rep.refresh_once()
        assert rep._served.w_dev is first.w_dev
        _push(cl, d, rng)
        assert rep.refresh_once()
        assert rep._served.w_dev is not first.w_dev
        assert torch.equal(first.w_dev, before)
        assert rep._served.w_dev.data_ptr() != first.w_dev.data_ptr()
        cl.bye()
    finally:
        if rep is not None:
            rep.stop()
        ps.stop()


def test_sum_collision_does_not_reuse_the_device_tensor():
    """Against a shard group ``ts`` is a sum of versions and two vectors
    can sum equal: the replica reuses its device tensor only when the
    subscriber says nothing changed."""
    d = 8
    rng = np.random.default_rng(7)
    ps = _start_ps("port", d=d)
    rep = None
    try:
        cl = t_ps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        _push(cl, d, rng)
        rep = _replica("port", ps.port)
        assert rep.refresh_once()
        first = rep._served
        # the same ts, but the subscriber reports a changed vector
        rep._client.changed_since_last = True
        assert rep.refresh_once()
        assert rep._served.ts == first.ts
        assert rep._served.w_dev is not first.w_dev
        rep._client.changed_since_last = False
        second = rep._served
        assert rep.refresh_once()
        assert rep._served.w_dev is second.w_dev
        cl.bye()
    finally:
        if rep is not None:
            rep.stop()
        ps.stop()


def test_serving_counters_and_sections_match_the_jax_packages():
    """The same predicts observed by both packages' serving metrics give
    the same flat totals and snapshot keys, and the live UI's ``serving``
    section is there in the port."""
    from asyncframework_tpu.metrics import reset_totals as j_reset_totals
    from asyncframework_tpu.serving import metrics as j_smetrics

    j_reset_totals()
    try:
        for mod in (t_smetrics, j_smetrics):
            mod.observe_predict("r:1", 2.0, 1, 30.0, 5)
            mod.observe_predict("r:1", 0.0, 0, 0.0, 0, ok=False)
            mod.bump("failovers")
            mod.note_attempt()
        assert t_smetrics.serving_totals() == j_smetrics.serving_totals()
        assert set(t_smetrics.serving_snapshot()) == \
            set(j_smetrics.serving_snapshot())
        snap = t_live.LiveStateListener(1).snapshot()
        assert "serving" in snap and "detail" in snap["serving"]
    finally:
        j_reset_totals()


def test_kill_nine_across_the_packages_keeps_answering():
    """Two replica processes of the JAX package behind the port's
    frontend: one is SIGKILLed mid-load, every request is answered."""
    import signal

    d = 16
    rng = np.random.default_rng(8)
    ps = _start_ps("port", d=d)
    fe, procs = None, []
    try:
        fe = ServingFrontend(deadline_s=3.0).serve(port=0, host="127.0.0.1")
        env = dict(os.environ, JAX_PLATFORMS="cpu", ASYNCTPU_FORCE_CPU="1",
                   PYTHONPATH=str(REPO),
                   ASYNCTPU_ASYNC_SERVE_REFRESH_INTERVAL_S="0.02")
        for rid in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "asyncframework_tpu.serving.cli",
                 "replica", "--ps", f"127.0.0.1:{ps.port}", "--host",
                 "127.0.0.1", "--rid", str(rid), "--frontend",
                 f"127.0.0.1:{fe.port}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
                cwd=str(REPO), text=True))
        deadline = time.monotonic() + 90.0
        while fe.replica_count() < 2:
            assert time.monotonic() < deadline, "replicas never registered"
            time.sleep(0.1)
        pusher = t_ps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        X = rng.normal(size=(4, d)).astype(np.float32)
        for i in range(40):
            if i == 15:
                os.kill(procs[0].pid, signal.SIGKILL)
            if i % 10 == 0:
                _push(pusher, d, rng, scale=0.05)
            y, _meta = fe.predict_ex(X)  # must never raise
            assert y.shape == (4,)
        assert t_smetrics.serving_totals().get("failovers", 0) >= 1
        pusher.bye()
    finally:
        if fe is not None:
            fe.stop()
        for p in procs:
            kill_and_reap(p)
        ps.stop()


# ------------------------------- chip_smoke.py phase 16's harness, on the CPU
#: the training run's gates that only the card can pass (no kernel here)
CARD_ONLY = {"one_launch_a_gradient", "staged_route"}


def _failed(rec, prefix):
    return {k[len(prefix):] if k.startswith(prefix) else k
            for k, v in rec["gates"].items() if not v}


def test_serve_arm_on_the_cpu():
    """``tools/serve.py``'s serve arm at the small deployment: replica
    processes behind this process's frontend while one PS process and two
    worker processes train, replica 1 SIGKILLed halfway; every request
    answered with a failover counted, the survivor serving the final
    model, its predictions within rtol 1e-5 of the float64 product."""
    from asyncframework_tpu_torch.tools import serve

    rec = serve.serve_arm(device="cpu", config="small", updates=300)
    assert _failed(rec, "train.") <= CARD_ONLY, (
        rec["gates"], rec["served_ts"], rec["final_reply_ts"],
        rec["final_ts"], rec["final_bytes_since_ts"], rec["done_ts"])
    assert rec["errors"] == 0 and rec["failovers"] > 0
    assert rec["replica_status"][0]["device"] == "cpu"
    assert set(rec["rows_seen"]) == {"1", "3", "16", "17", "64", "256"}
    assert sum(rec["replica_status"][0]["refresh_wenc"].values()) > 0
    assert sum(rec["ps_subscribe_replies"].values()) > 0


def test_sharded_arm_on_the_cpu():
    """The sharded arm: a replica in this process resolves a fenced
    2-shard group of processes and serves the concatenated final shards."""
    from asyncframework_tpu_torch.tools import serve

    rec = serve.sharded_arm(device="cpu", config="small", updates=300)
    # each secondary's counts are read after its last apply (ROADMAP C13),
    # so no_range_short holds here as on the card
    assert _failed(rec, "group.") <= CARD_ONLY, rec["gates"]
    assert all(v for k, v in rec["gates"].items()
               if not k.startswith("group."))
    assert [tuple(r[:2]) for r in rec["ranges"]] == [(0, 12), (12, 24)]


@pytest.mark.parametrize("shards", [1, 2])
def test_replica_serves_applies_that_land_after_done(shards):
    """A DONE reply can precede the run's last model: a PS sets DONE in
    its drain before it applies the batch that reached the budget, and a
    secondary shard learns DONE from FINISH but still applies the pushes
    in flight to it.  The port's replica goes on polling after DONE until
    the PS (every range of a group) has gone, and serves the last version
    (the JAX package's replica stops at the first DONE); it stays healthy
    after the PS has gone.  Here a push pulled before FINISH lands after
    it, on the PS or on the group's secondary."""
    from asyncframework_tpu_torch.parallel import shardgroup as t_sg

    d, n = 16, 256
    rng = np.random.default_rng(9)
    if shards == 1:
        ps_list = [_start_ps("port", d=d, n=n)]
        entries = [("127.0.0.1", ps_list[0].port, 0, d)]
        pusher = t_ps.PSClient("127.0.0.1", ps_list[0].port,
                               pull_mode="full")
    else:
        cfg = _cfg("port", num_workers=1, num_iterations=2)
        ps_list, smap = t_sg.launch_inprocess_group(cfg, d, n, shards,
                                                    device=CPU)
        entries = smap.entries
        pusher = t_sg.ShardedPSClient(smap)
    rep = None
    try:
        rep = t_rep.ModelReplica("127.0.0.1", ps_list[0].port, rid=0,
                                 host="127.0.0.1", device=CPU,
                                 refresh_interval_s=0.02,
                                 max_stale_ms=200.0).start()
        for _ in range(2):
            ts, _w, _a, _c = pusher.pull(0)
            pusher.push(0, ts, rng.normal(size=d).astype(np.float32))
        _h, late_port, lo, hi = entries[-1]
        late = t_ps.PSClient("127.0.0.1", late_port, pull_mode="full")
        late_ts, _w, _a, _c = late.pull(0)
        for _h, p, _lo, _hi in entries:
            t_sg.finish_endpoint("127.0.0.1", p)
        done_ts = 2 * shards
        deadline = time.monotonic() + 10.0
        while not (rep._served is not None and rep._served.done
                   and rep._served.ts == done_ts):
            assert time.monotonic() < deadline, "never served DONE"
            time.sleep(0.01)
        late.push(0, late_ts, rng.normal(size=hi - lo).astype(np.float32))
        late.bye()
        want = np.concatenate([
            t_ps.PSClient("127.0.0.1", ps.port, pull_mode="delta")
            .subscribe(9)[1] for ps in ps_list])
        deadline = time.monotonic() + 10.0
        while rep._served.ts != done_ts + 1:
            assert time.monotonic() < deadline, "the late apply was missed"
            time.sleep(0.01)
        assert rep._served.w_host.tobytes() == want.tobytes()
        assert rep._refresh_thread.is_alive()
        for ps in ps_list:
            ps.stop()
        rep._refresh_thread.join(timeout=20.0)
        assert not rep._refresh_thread.is_alive()
        time.sleep(0.3)  # past max_stale_ms: DONE keeps it healthy
        assert rep.healthy()
        hdr, _payload = _predict_raw(rep.port, np.ones((2, d), np.float32))
        assert hdr["op"] == "PREDICTION" and hdr["ts"] == done_ts + 1
    finally:
        if rep is not None:
            rep.stop()
        for ps in ps_list:
            ps.stop()

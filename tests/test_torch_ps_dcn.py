"""The port's DCN parameter-server plane against the JAX package's.

Both packages run in this session on the CPU and speak one wire, so the
tests mix them: a port worker process against the JAX package's
``ParameterServer`` and the JAX package's ``run_worker_process`` against
the port's, each run held to ``accepted == num_iterations``, exactly-once
delivery (every push the workers sent is counted once, as accepted or
dropped, and no retry was applied twice) and convergence, at
``tests/test_ps_dcn.py``'s recipe (4,096 x 24, 8 workers).  Then ASAGA's
trajectory against the JAX package's (one logical worker, so the run is
serial and both PSes draw the same rows with numpy), the port's twins of
``tests/test_ps_dcn.py`` and ``tests/test_dataplane.py``, checkpoints
across the packages, the merge drain, and the refused (and lifted)
switches.

Waits are on events, joins and the PS's own state, with deadlines; no
test sleeps a fixed time to let another thread get somewhere.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from asyncframework_tpu.data.sharded import ShardedDataset as JDataset
from asyncframework_tpu.ops import steps as jsteps
from asyncframework_tpu.parallel import ps_dcn as jps
from asyncframework_tpu.solvers import SolverConfig as JConfig
from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
from asyncframework_tpu_torch.convert import ps_checkpoint
from asyncframework_tpu_torch.data.sharded import ShardedDataset as TDataset
from asyncframework_tpu_torch.ops import steps as tsteps
from asyncframework_tpu_torch.parallel import ps_dcn as tps
from asyncframework_tpu_torch.parallel import shardgroup as tshard
from asyncframework_tpu_torch.solvers import SolverConfig as TConfig
from torch_procs import readline_within

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NW = 4_096, 24, 8


def _kw(**over):
    kw = dict(num_workers=NW, num_iterations=300, gamma=1.2,
              taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.5,
              printer_freq=50, seed=42, calibration_iters=20,
              run_timeout_s=120.0)
    kw.update(over)
    return kw


@pytest.fixture(autouse=True)
def conf():
    """A fresh port conf for each test (the wire's knobs are read from the
    process conf only), removed after it."""
    c = AsyncConf()
    set_global_conf(c)
    yield c
    set_global_conf(None)


def _data(n=N, d=D, seed=11):
    """Unit-norm rows and a planted model (numpy, for both packages)."""
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = (X @ rs.normal(size=d).astype(np.float32)
         + 0.01 * rs.normal(size=n)).astype(np.float32)
    return X, y


def _jax_cpu():
    return jax.devices("cpu")[0]


def _run(ps, run_worker, shards, cfg, algo, d=D, n=N, eval_wid=0):
    """Workers against a started PS; returns (counts, traj, record)."""
    counts = run_worker("127.0.0.1", ps.port, sorted(shards), shards, cfg,
                        d, n, eval_wid=eval_wid, deadline_s=120.0, algo=algo)
    done = ps.wait_done(timeout_s=30.0)
    total = (ps.collect_eval(num_worker_procs=1, timeout_s=30.0)
             if eval_wid is not None else None)
    ps.stop()
    assert done, str(done)
    traj = None if total is None else np.asarray(total) / n
    return counts, traj


def _exactly_once(ps, counts, iterations):
    """Every gradient a worker pushed reached the PS once: the PS counted
    as many pushes as were sent, each accepted or dropped, no retry was
    answered from the dedup window, and the run stopped at its budget."""
    pushes = sum(ps.pushes_by_wid.values())
    assert ps.accepted == iterations
    assert pushes == sum(counts.values())
    assert pushes == ps.accepted + ps.dropped + ps.membership_rejects
    assert ps.dedup_hits == 0


# ------------------------------------------------------- across packages
@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_port_workers_against_the_jax_parameter_server(algo):
    X, y = _data()
    gamma = 1.2 if algo == "asgd" else 0.3
    ps = jps.ParameterServer(JConfig(**_kw(gamma=gamma)), D, N,
                             device=_jax_cpu(), port=0, algo=algo).start()
    ds = TDataset(X, y, NW, devices=[CPU])
    counts, traj = _run(ps, tps.run_worker_process,
                        {w: ds.shard(w) for w in range(NW)},
                        TConfig(**_kw(gamma=gamma)), algo)
    _exactly_once(ps, counts, 300)
    assert traj[-1] < traj[0] * 0.05, traj


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_jax_workers_against_the_port_parameter_server(algo):
    X, y = _data()
    gamma = 1.2 if algo == "asgd" else 0.3
    ps = tps.ParameterServer(TConfig(**_kw(gamma=gamma)), D, N, device=CPU,
                             port=0, algo=algo).start()
    ds = JDataset(X, y, NW, devices=[_jax_cpu()])
    counts, traj = _run(ps, jps.run_worker_process,
                        {w: ds.shard(w) for w in range(NW)},
                        JConfig(**_kw(gamma=gamma)), algo)
    _exactly_once(ps, counts, 300)
    assert traj[-1] < traj[0] * 0.05, traj


@pytest.mark.parametrize("sparse", [False, True])
def test_asaga_trajectory_matches_the_jax_package(sparse):
    """One logical worker, cohort threshold 1, taw infinite, the serial
    loop: each package's PS draws the worker's rows from
    ``default_rng([seed, wid])``, so both runs see the same samples and
    apply the same updates in the same order.  Tolerance: every snapshot
    of ``w`` within 1e-4 of the largest entry (f32 contractions summed in
    two orders, carried through 120 updates)."""
    kw = _kw(num_workers=1, num_iterations=120, gamma=0.2, bucket_ratio=0.0,
             printer_freq=10, batch_rate=0.1)
    if sparse:
        from asyncframework_tpu.data.sparse import SparseShardedDataset as JS
        from asyncframework_tpu_torch.data import make_sparse_regression
        from asyncframework_tpu_torch.data.sparse import (
            SparseShardedDataset as TS,
        )

        n, d = 1_024, 64
        csr = make_sparse_regression(n, d, 0.1, seed=3)
        jds = JS(*csr, d, 1, devices=[_jax_cpu()])
        tds = TS(*csr, d, 1, devices=[CPU])
        kw["gamma"] = 1.0
    else:
        n, d = 1_024, D
        X, y = _data(n, d, seed=4)
        jds = JDataset(X, y, 1, devices=[_jax_cpu()])
        tds = TDataset(X, y, 1, devices=[CPU])
    snaps = []
    for pkg_ps, run, ds, Cfg, dev in (
            (jps, jps.run_worker_process, jds, JConfig, _jax_cpu()),
            (tps, tps.run_worker_process, tds, TConfig, CPU)):
        cfg = Cfg(**kw)
        ps = pkg_ps.ParameterServer(cfg, d, n, device=dev, port=0,
                                    algo="asaga").start()
        run("127.0.0.1", ps.port, [0], {0: ds.shard(0)}, cfg, d, n,
            deadline_s=120.0, algo="asaga")
        assert ps.wait_done(timeout_s=30.0)
        times, W = ps.snapshot_stack()
        table = np.array(ps._table[0])
        ps.stop()
        assert ps.accepted == 120 and ps.dropped == 0
        snaps.append((W, table))
    (jW, jtab), (tW, ttab) = snaps
    assert jW.shape == tW.shape == (120 // 10 + 2, d)
    scale = float(np.abs(jW).max())
    np.testing.assert_allclose(tW, jW, rtol=0, atol=1e-4 * scale)
    # the same rows were sampled and committed: the history tables hold
    # values at the same rows
    np.testing.assert_array_equal(ttab != 0, jtab != 0)
    np.testing.assert_allclose(ttab, jtab, rtol=0,
                               atol=1e-4 * float(np.abs(jtab).max()))


# ------------------------------------------ twins of tests/test_ps_dcn.py
def _port_ps(cfg, d=D, n=N, **kw):
    return tps.ParameterServer(cfg, d, n, device=CPU, port=0, **kw).start()


def _port_ds(n=N, d=D):
    return TDataset.generate_on_device(n, d, NW, devices=[CPU], seed=11,
                                       noise=0.01)


def test_taw_zero_drops_under_overlap():
    cfg = TConfig(**_kw(taw=0, num_iterations=150))
    ds = _port_ds(2_048, 16)
    ps = _port_ps(cfg, 16, 2_048)
    counts, _ = _run(ps, tps.run_worker_process,
                     {w: ds.shard(w) for w in range(NW)}, cfg, "asgd", 16,
                     2_048, eval_wid=None)
    _exactly_once(ps, counts, 150)
    # 8 concurrent pullers against tau=0: overlap shows up as drops
    # unless no overlap ever happened (then max_staleness stayed 0)
    assert ps.dropped > 0 or ps.max_staleness == 0


def test_cohort_wave_serves_threshold_together():
    """bucket_ratio waves: with threshold 4, the first 3 pullers wait in
    the gate until the 4th arrives, then all 4 are served the same version
    in ONE wave.  The clients are dialed first and the 3 pulls start at a
    barrier, so all 4 arrive well inside the gate's 1 s starvation
    release (which would serve a degraded cohort as a second wave)."""
    cfg = TConfig(**_kw(bucket_ratio=0.5, num_iterations=10))
    ps = _port_ps(cfg, 8, 800)
    clients = [tps.PSClient("127.0.0.1", ps.port) for _ in range(4)]
    served = {}
    lock = threading.Lock()
    start = threading.Barrier(3)

    def puller(wid, barrier=None):
        if barrier is not None:
            barrier.wait(timeout=30)
        got = clients[wid].pull(wid)
        with lock:
            served[wid] = got[0]

    try:
        threads = [threading.Thread(target=puller, args=(w, start))
                   for w in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with ps._wave_cv:
                if len(ps._waiting) == 3:
                    break
        with ps._wave_cv:
            assert len(ps._waiting) == 3 and ps._wave_id == 0
        t4 = threading.Thread(target=puller, args=(3,))
        t4.start()
        for t in threads + [t4]:
            t.join(timeout=10)
            assert not t.is_alive()
        assert sorted(served) == [0, 1, 2, 3]
        assert len(set(served.values())) == 1
        assert ps._wave_id == 1  # one wave served all four
    finally:
        for cl in clients:
            cl.bye()
        ps.stop()


@pytest.mark.parametrize("algo,gamma", [("asgd", 76.8), ("asaga", 20.0)])
def test_sparse_dcn_converges_on_a_small_wire(algo, gamma):
    """rcv1-class shards over the wire: sparse worker steps (S1's plain
    versions here) and (idx, val) push encoding, well under the dense
    ``d * 4`` bytes a push."""
    from asyncframework_tpu_torch.data.sparse import SparseShardedDataset

    n, d = 4_096, 8_192  # d >> touched columns: the sparse encoding wins
    cfg = TConfig(**_kw(gamma=gamma, num_iterations=500))
    ds = SparseShardedDataset.generate_on_device(n, d, 4, NW, devices=[CPU],
                                                 seed=7, noise=0.01)
    ps = _port_ps(cfg, d, n, algo=algo)
    counts, traj = _run(ps, tps.run_worker_process,
                        {w: ds.shard(w) for w in range(NW)}, cfg, algo, d, n)
    _exactly_once(ps, counts, 500)
    pushes = ps.accepted + ps.dropped
    assert ps.push_bytes < pushes * d * 4 / 4
    assert traj[-1] < traj[0] * 0.05, traj


def test_run_survives_a_killed_worker_group_mid_run():
    """5 of 8 workers push until they die mid-run (sockets dropped, no
    goodbye), leaving 3 survivors -- fewer than the cohort threshold of
    4 -- so completion also proves the starvation release."""
    cfg = TConfig(**_kw(num_iterations=60, printer_freq=20))
    ds = _port_ds()
    ps = _port_ps(cfg)
    participated = threading.Event()
    kill = threading.Event()
    pushes = {"n": 0}

    def doomed():
        clients = {wid: tps.PSClient("127.0.0.1", ps.port)
                   for wid in range(3, 8)}
        try:
            while not kill.is_set():
                for wid, c in clients.items():
                    got = c.pull(wid)
                    if got is None or kill.is_set():
                        return
                    c.push(wid, got[0], np.zeros(D, np.float32))
                    pushes["n"] += 1
                    if pushes["n"] >= 5:
                        participated.set()
        except (ConnectionError, OSError):
            return
        finally:
            for c in clients.values():
                if c.sock is not None:
                    c.sock.close()  # abrupt death, no BYE

    counts = {}
    t_doomed = threading.Thread(target=doomed, daemon=True)
    t_surv = threading.Thread(target=lambda: counts.update(
        tps.run_worker_process("127.0.0.1", ps.port, [0, 1, 2],
                               {w: ds.shard(w) for w in range(3)}, cfg, D,
                               N, deadline_s=120.0)), daemon=True)
    t_doomed.start()
    t_surv.start()
    assert participated.wait(timeout=60), "the doomed group never pushed"
    kill.set()
    t_doomed.join(timeout=30)
    t_surv.join(timeout=120)
    done = ps.wait_done(timeout_s=30.0)
    ps.stop()
    assert done and not t_surv.is_alive()
    assert ps.accepted == 60
    assert sum(counts.values()) > 0


def _child_env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, PS_CONFIG="small",
               PS_DEVICE="cpu")
    env.pop("JAX_PLATFORMS", None)
    env.update({k: str(v) for k, v in kw.items()})
    return env


CHILD = [sys.executable, "-m", "asyncframework_tpu_torch.tools.ps_child"]


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_kill9_ps_midrun_restart_resumes_and_converges(algo, tmp_path,
                                                      conf):
    """The PS process is killed with SIGKILL after its first checkpoint,
    restarted from it on the same port, and the workers (in this process)
    ride it out: the run completes, resumed past the checkpoint, and its
    trajectory spans both lives."""
    ckpt = str(tmp_path / "ps.npz")
    gamma = 0.3 if algo == "asaga" else 1.2
    conf.set("async.pipeline.depth", 0)
    env = _child_env(PS_ROLE="ps", PS_ALGO=algo, PS_NUM_WORKER_PROCS=1,
                     PS_CHECKPOINT=ckpt, PS_GAMMA=gamma,
                     ASYNCTPU_ASYNC_PIPELINE_DEPTH=0)
    first = subprocess.Popen(CHILD, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    restarted = None
    try:
        port = json.loads(readline_within(first))["port"]
        cfg = TConfig(**_kw(num_iterations=400, gamma=gamma,
                            run_timeout_s=240.0))
        ds = _port_ds()
        counts = {}
        t_w = threading.Thread(target=lambda: counts.update(
            tps.run_worker_process("127.0.0.1", port, list(range(NW)),
                                   {w: ds.shard(w) for w in range(NW)}, cfg,
                                   D, N, eval_wid=0, deadline_s=240.0,
                                   algo=algo)), daemon=True)
        t_w.start()
        deadline = time.monotonic() + 120
        while not os.path.exists(ckpt) and time.monotonic() < deadline:
            t_w.join(timeout=0.02)
        assert os.path.exists(ckpt), "no checkpoint was ever written"
        first.send_signal(signal.SIGKILL)
        first.wait(timeout=10)
        restarted = subprocess.Popen(CHILD, env=dict(env, PS_BIND_PORT=str(
            port)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        assert json.loads(readline_within(restarted))["port"] == port
        t_w.join(timeout=240)
        assert not t_w.is_alive(), "workers never finished after the restart"
        out, err = restarted.communicate(timeout=120)
        assert restarted.returncode == 0, err[-2000:]
        res = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in (first, restarted):
            if p is not None and p.poll() is None:
                p.kill()
    assert res["done"] is True and res["accepted"] == 400
    assert res["resumed_from"] is not None and res["resumed_from"] >= 50
    traj = res["trajectory"]
    assert len(traj) >= 400 // 50
    assert traj[-1][1] < traj[0][1] * 0.05, traj


def test_two_worker_processes_converge():
    """A PS process and two worker processes (``tools/ps_child.py``) on
    the cluster path's defaults -- delta pulls, pipeline depth 2, the
    native codecs and the shm ring -- converge with every push counted
    once, and no codec fell back to Python."""
    env = _child_env(PS_ALGO="asgd", PS_NUM_WORKER_PROCS=2)
    ps = subprocess.Popen(CHILD, env=dict(env, PS_ROLE="ps"),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    workers = []
    try:
        port = json.loads(readline_within(ps))["port"]
        workers = [subprocess.Popen(
            CHILD, env=dict(env, PS_ROLE="worker", PS_PORT=str(port),
                            PS_WORKER_ID=str(i)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        outs = []
        for w in workers:
            out, err = w.communicate(timeout=180)
            assert w.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
        out, err = ps.communicate(timeout=180)
        assert ps.returncode == 0, err[-2000:]
        res = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in [ps, *workers]:
            if p.poll() is None:
                p.kill()
    assert res["done"] and res["accepted"] == 400
    # every push the pipelined senders put on the wire was acknowledged
    # once and counted once; a worker may compute one gradient that it
    # never sends (the run was done before its window had room)
    assert res["pushes"] == res["pipeline"]["pushes_async"]
    assert res["pushes"] == res["accepted"] + res["dropped"]
    gradients = sum(o["gradients"] for o in outs)
    assert res["pushes"] <= gradients <= res["pushes"] + NW
    assert res["dedup_hits"] == 0
    assert res["pull_replies"]["nm"] + res["pull_replies"]["xdelta"] > 0
    assert res["pipeline"].get("pushes_async", 0) > 0
    for rec in [res, *outs]:
        assert rec["native"].get("python_fallbacks", 0) == 0
        assert rec["native"].get("shm_upgrades", 0) > 0
    traj = res["trajectory"]
    assert traj[-1][1] < traj[0][1] * 0.05, traj


# --------------------------------------- twins of tests/test_dataplane.py
def _dataplane_ps(conf, delta_versions=None):
    cfg = TConfig(**_kw(num_iterations=1_000, bucket_ratio=0.0))
    conf.set("async.pull.mode", "delta")
    if delta_versions is not None:
        conf.set("async.pull.delta.versions", delta_versions)
    return _port_ps(cfg, 16, 256)


def _push_once(cl, wid, d=16, scale=1.0):
    ts, _w, _avg, _cal = cl.pull(wid)
    cl.push(wid, ts, np.full(d, scale, np.float32))


def test_delta_pull_reconstructs_full_pull_bytes(conf):
    ps = _dataplane_ps(conf)
    try:
        full_cl = tps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        delta_cl = tps.PSClient("127.0.0.1", ps.port, pull_mode="delta")
        rng = np.random.default_rng(5)
        for step in range(12):
            for _ in range(int(rng.integers(0, 3))):
                _push_once(full_cl, 0, scale=float(rng.normal()))
            ts_f, w_f, _, _ = full_cl.pull(0)
            ts_d, w_d, _, _ = delta_cl.pull(1)
            assert ts_f == ts_d
            assert w_f.tobytes() == w_d.tobytes(), step
        assert delta_cl.pull_wenc["nm"] + delta_cl.pull_wenc["xdelta"] > 0
        assert delta_cl.delta_fallbacks == 0
        # an unchanged version costs no model bytes
        before = delta_cl.pull_model_bytes
        delta_cl.pull(1)
        assert delta_cl.pull_wenc["nm"] >= 1
        assert delta_cl.pull_model_bytes == before
        full_cl.bye()
        delta_cl.bye()
    finally:
        ps.stop()


def test_evicted_basis_is_served_full_not_wrong(conf):
    ps = _dataplane_ps(conf, delta_versions=1)
    try:
        cl = tps.PSClient("127.0.0.1", ps.port, pull_mode="delta")
        mover = tps.PSClient("127.0.0.1", ps.port, pull_mode="full")
        cl.pull(0)
        for _ in range(3):  # the basis version ages out of the cache
            _push_once(mover, 1)
        _ts, w, _, _ = cl.pull(0)
        _ts, ref_w, _, _ = mover.pull(1)
        assert w.tobytes() == ref_w.tobytes()
        assert cl.pull_wenc["full"] == 2  # the first pull + the cache miss
        assert cl.delta_fallbacks == 0
        cl.bye()
        mover.bye()
    finally:
        ps.stop()


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_fused_drain_is_bit_identical_to_serial_applies(algo, conf):
    """Two PSes fed one push sequence, one draining it through the merge
    queue in one batch and one a push at a time, end with the same model
    bits and the same ledgers."""
    d, n = 16, 256
    rng = np.random.default_rng(9)
    grads = [rng.normal(size=d).astype(np.float32) for _ in range(6)]

    def run(push_merge):
        cfg = TConfig(**_kw(num_iterations=100, gamma=0.3))
        conf.set("async.push.merge", push_merge)
        ps = _port_ps(cfg, d, n, algo=algo)
        try:
            for j, g in enumerate(grads):
                wid = j % 2
                diff = None
                if algo == "asaga":
                    ps._table.setdefault(wid, np.zeros(8, np.float32))
                    ps._pending_idx[wid] = np.array([j % 8])
                    diff = np.array([float(j)], np.float32)
                ps._merge_q.append(tps._PendingPush(
                    wid, 0, g, diff, {"op": "PUSH"}, g.nbytes, None, 0.0))
                if algo == "asaga" or push_merge == 1:
                    with ps._lock:  # ASAGA holds one pending sample a wid
                        ps._drain_merge_locked()
            with ps._lock:
                while ps._merge_q:
                    ps._drain_merge_locked()
            ab = ps._ab.numpy().tobytes() if algo == "asaga" else b""
            return (ps._w.numpy().tobytes(), ab, ps.accepted, ps.dropped,
                    ps._clock, ps.merge_batch_max)
        finally:
            ps.stop()

    serial, fused = run(1), run(8)
    assert fused[:5] == serial[:5]
    assert serial[5] == 1
    if algo == "asgd":
        assert fused[5] == len(grads)


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_merge_functions_fold_slots_like_serial_applies(algo):
    """``make_*_apply_merge`` at m slots equals m applies of itself at
    m = 1 bit for bit, padding slots (mask 0) changing nothing, and
    agrees with the JAX package's merge (XLA rewrites ``gamma/sqrt`` as a
    reciprocal square root: 1e-6 of the largest entry, ROADMAP C1)."""
    gamma, br, n, P, d = 1.2, 0.3, 4_096, 8, 96
    rs = np.random.default_rng(1)
    G = rs.normal(size=(6, d)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    w0 = rs.normal(size=d).astype(np.float32)
    ab0 = rs.normal(size=d).astype(np.float32)
    one = torch.ones(1)
    if algo == "asgd":
        merge = tsteps.make_asgd_apply_merge(gamma, br, n, P)
        w, k = merge(torch.tensor(w0), torch.tensor(G), torch.tensor(mask),
                     torch.tensor(5.0))
        ws, ks = torch.tensor(w0), torch.tensor(5.0)
        for j in range(6):
            if mask[j] > 0:
                ws, ks = merge(ws, torch.tensor(G[j:j + 1]), one, ks)
        assert w.numpy().tobytes() == ws.numpy().tobytes()
        assert float(k) == float(ks) == 9.0
        jw, _jk = jsteps.make_asgd_apply_merge(gamma, br, n, P)(
            w0, G, mask, np.float32(5.0))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6 * float(np.abs(jw).max()))
    else:
        merge = tsteps.make_saga_apply_merge(gamma, br, n, P)
        w, ab = merge(torch.tensor(w0), torch.tensor(ab0), torch.tensor(G),
                      torch.tensor(mask))
        ws, abs_ = torch.tensor(w0), torch.tensor(ab0)
        for j in range(6):
            if mask[j] > 0:
                ws, abs_ = merge(ws, abs_, torch.tensor(G[j:j + 1]), one)
        assert w.numpy().tobytes() == ws.numpy().tobytes()
        assert ab.numpy().tobytes() == abs_.numpy().tobytes()
        jw, jab = jsteps.make_saga_apply_merge(gamma, br, n, P)(
            w0, ab0, G, mask)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6 * float(np.abs(jw).max()))
        np.testing.assert_allclose(ab.numpy(), np.asarray(jab), rtol=0,
                                   atol=1e-6 * float(np.abs(jab).max()))


def test_pipelined_transfer_on_the_cpu_copies():
    stage, readback = tsteps.make_pipelined_transfer(CPU)
    h = np.arange(5, dtype=np.float32)
    t = stage(h)
    h[0] = 99.0  # the staged tensor is a copy
    assert t.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    r = readback(t * 2)
    assert r.tolist() == [0.0, 2.0, 4.0, 6.0, 8.0]


# ---------------------------------------------- checkpoints across packages
@pytest.mark.parametrize("algo", ["asgd", "asaga"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_ps_checkpoint_resumes_in_the_other_package(algo, direction,
                                                    tmp_path, conf):
    """A PS checkpoint written by one package (model, step counter,
    ledgers, ASAGA's history table and numpy sampling streams) resumes in
    the other: the state reads back bit-equal and the run finishes from
    where it stopped."""
    ckpt = str(tmp_path / "ps.npz")
    X, y = _data()
    gamma = 1.2 if algo == "asgd" else 0.3
    first, second = ((tps, jps) if direction == "port_to_jax"
                     else (jps, tps))
    conf.set("async.pipeline.depth", 0)

    def make(pkg, iters):
        Cfg = TConfig if pkg is tps else JConfig
        dev = CPU if pkg is tps else _jax_cpu()
        cfg = Cfg(**_kw(num_iterations=iters, gamma=gamma))
        if pkg is jps:
            cfg.pipeline_depth = 0
        ps = pkg.ParameterServer(cfg, D, N, device=dev, port=0, algo=algo,
                                 checkpoint_path=ckpt).start()
        if pkg is tps:
            ds = TDataset(X, y, NW, devices=[CPU])
        else:
            ds = JDataset(X, y, NW, devices=[_jax_cpu()])
        return ps, cfg, {w: ds.shard(w) for w in range(NW)}

    ps, cfg, shards = make(first, 100)
    first.run_worker_process("127.0.0.1", ps.port, list(range(NW)), shards,
                             cfg, D, N, deadline_s=120.0, algo=algo)
    assert ps.wait_done(timeout_s=30.0)
    # the writer thread's last save ends before the final one starts (the
    # JAX package's PS lets the two share a temporary file)
    ps.stop()
    ps._ckpt_thread.join(timeout=30)
    assert not ps._ckpt_thread.is_alive()
    ps.save_checkpoint()
    meta, saved = ps_checkpoint(ckpt)
    assert meta["k"] == 100
    assert set(saved) >= {"w", "snap_stack"} | (
        {"ab", *(f"table_{w}" for w in range(NW))} if algo == "asaga"
        else set())

    ps2, cfg2, shards2 = make(second, 200)
    assert ps2.resumed_from_k == 100 and ps2.accepted == 100
    np.testing.assert_array_equal(np.asarray(ps2._w), saved["w"])
    assert float(np.asarray(ps2._k_dev)) == 100.0
    if algo == "asaga":
        np.testing.assert_array_equal(np.asarray(ps2._ab), saved["ab"])
        for wid in range(NW):
            np.testing.assert_array_equal(ps2._table[wid],
                                          saved[f"table_{wid}"])
            assert (ps2._rngs[wid].bit_generator.state
                    == meta["rng_states"][str(wid)])
    second.run_worker_process("127.0.0.1", ps2.port, list(range(NW)),
                              shards2, cfg2, D, N, eval_wid=0,
                              deadline_s=120.0, algo=algo)
    assert ps2.wait_done(timeout_s=30.0)
    total = ps2.collect_eval(num_worker_procs=1, timeout_s=30.0)
    ps2.stop()
    assert ps2.accepted == 200
    traj = np.asarray(total) / N
    assert traj[-1] < traj[0] * 0.05, traj


def test_concurrent_checkpoint_saves_never_collide(tmp_path):
    """The writer thread and explicit saves may overlap: each save is
    whole, and none finds its temporary file taken by another."""
    ckpt = str(tmp_path / "ps.npz")
    ps = tps.ParameterServer(TConfig(**_kw()), D, N, device=CPU, port=0,
                             checkpoint_path=ckpt)
    errors = []

    def saver():
        try:
            for _ in range(20):
                ps.save_checkpoint()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=saver) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        ps.stop()
    assert not errors, errors
    meta, saved = ps_checkpoint(ckpt)
    assert meta["k"] == 0 and saved["w"].shape == (D,)


# ---------------------------------------------------------- refused switches
@pytest.mark.parametrize("kwargs", [
    {"standby": True},
    {"standby": True, "epoch": 2,
     "shard_map": [["127.0.0.1", 1, 0, 12], ["127.0.0.1", 2, 12, 24]]},
])
def test_refused_ps_switches_name_their_roadmap_item(kwargs):
    """The hot standby is no longer refused (ROADMAP A6b.3 is ported),
    also on a fenced shard of a group: the standby itself refuses the
    training plane -- a PULL or PUSH against it meets ``ERR standby``,
    surfaced to the client as a dead endpoint -- and answers SHARDMAP
    as a standby."""
    ps = tps.ParameterServer(TConfig(**_kw()), D, N, device=CPU, port=0,
                             **kwargs).start()
    try:
        assert ps._standby and not ps.promoted
        cl = tps.PSClient("127.0.0.1", ps.port, epoch=ps.epoch)
        with pytest.raises(ConnectionError):
            cl.pull(0)
        hdr = tshard._oneshot("127.0.0.1", ps.port, {"op": "SHARDMAP"},
                              timeout_s=5.0)
        assert hdr["standby"] is True
    finally:
        ps.stop()


def test_refused_methods_and_client_switches_name_their_roadmap_item():
    """``set_control``, ``attach_standby``, a client's ``ctrl_sink`` and
    SUBSCRIBE run now (ROADMAP A6b.3-5), and so does a SUBSCRIBE that
    registers a relaycast child (``rport``): from either package's
    client it is answered with the model, registers the subscriber as a
    child of the root offer path, and the child is offered each new
    version."""
    from asyncframework_tpu_torch.parallel.controller import ControlSink

    ps = _port_ps(TConfig(**_kw()))
    try:
        assert ps.set_control({"seq": 1, "ep": 0, "b": 2})
        assert ps.ctrl["seq"] == 1 and ps._ctrl_b == 2
        ps.attach_standby("127.0.0.1", 1)
        assert ps.repl is not None and not ps.repl.synced
        ps.set_standby_map(None)
        assert ps.repl is None
        sink = ControlSink({"seq": 1, "ep": 0})
        ccl = tps.PSClient("127.0.0.1", ps.port, ctrl_sink=sink)
        assert ccl.ctrl_sink is sink
        ccl.bye()
        # convergence samples ride the client's headers now: a buffered
        # sample leaves with the BYE and folds once on the PS
        from asyncframework_tpu_torch.metrics import timeseries

        timeseries.convergence().reset()
        buf = timeseries.ConvergenceBuffer()
        buf.add(3, 0.5, 1.0)
        cvc = tps.PSClient("127.0.0.1", ps.port, cv_buf=buf)
        cvc.bye()
        assert timeseries.convergence().offered == 1
        assert buf.take_wire() == []
        timeseries.convergence().reset()
        cl = tps.PSClient("127.0.0.1", ps.port)
        ts, w, clock, k, age_ms, done = cl.subscribe(0)
        assert (ts, clock, k, done) == (0, 0, 0, False)
        assert w.shape == (D,) and age_ms == 0.0
        jcl = jps.PSClient("127.0.0.1", ps.port)
        assert jcl.subscribe(0)[0] == 0
        from asyncframework_tpu.relaycast import RelayNode as JNode
        from asyncframework_tpu_torch.relaycast import RelayNode as TNode

        nodes = [TNode(rid=0, port=0).start(), JNode(rid=1, port=0).start()]
        try:
            for client, node in zip((cl, jcl), nodes):
                got = client.subscribe(0, extra={"rport": node.port})
                assert got[0] == 0 and got[1].shape == (D,)
            assert sorted(ps._relay_registry.children()) == sorted(
                ("127.0.0.1", n.port) for n in nodes)
            # a new version is offered to both children
            pusher = tps.PSClient("127.0.0.1", ps.port, pull_mode="full")
            ts, _w, _a, _c = pusher.pull(0)
            pusher.push(0, ts, np.ones(D, np.float32))
            deadline = time.monotonic() + 10.0
            # the PS counts an offer once the child has ACKed it
            while (min(n.offers_in for n in nodes) < 1
                   or ps.relay_offers < 2):
                assert time.monotonic() < deadline, "no RELAY_OFFER"
                time.sleep(0.01)
            pusher.bye()
        finally:
            for node in nodes:
                node.stop()
        cl.bye()
        jcl.bye()
    finally:
        ps.stop()


#: the cluster path's conf switches that the PS and its workers refused
#: until their ROADMAP item was ported, each set to 2 (above its off
#: value, and truthy for the flags): ``async.ui.port`` is the cluster
#: CLI's dashboard (A8's entry points), which neither the PS nor a worker
#: reads, as in the JAX package
REFUSED_CONF = [("async.ui.port", "A8")]


def test_mesh_conf_is_taken_by_the_ps_and_the_workers(conf):
    """``async.mesh.devices`` (refused until the mesh plane was ported)
    starts a PS and runs a worker process's gradients over its mesh
    (``tests/test_torch_meshgrad.py`` holds the plane)."""
    conf.set("async.mesh.devices", 2)
    cfg = TConfig(**_kw(num_iterations=60))
    ps = _port_ps(cfg)
    ds = _port_ds()
    tps.reset_mesh_counts()
    counts, _traj = _run(ps, lambda *a, **k: tps.run_worker_process(
        *a, devices=[CPU] * 2, **k), {w: ds.shard(w) for w in range(NW)},
        cfg, "asgd", eval_wid=None)
    _exactly_once(ps, counts, 60)
    assert tps.mesh_counts()["ranks"] == 2


def test_convergence_sample_conf_runs_on_the_workers(conf):
    """``async.convergence.sample`` (refused until the telemetry plane was
    ported) runs: every 4th update of each logical worker takes a
    sample, counted where it is taken, and the PS's convergence history
    holds every one."""
    from asyncframework_tpu_torch.metrics import timeseries

    timeseries.convergence().reset()
    tps.reset_conv_samples_taken()
    conf.set("async.convergence.sample", 4)
    cfg = TConfig(**_kw(num_iterations=120))
    ps = _port_ps(cfg)
    ds = _port_ds()
    counts, _traj = _run(ps, tps.run_worker_process,
                         {w: ds.shard(w) for w in range(NW)}, cfg, "asgd",
                         eval_wid=None)
    _exactly_once(ps, counts, 120)
    summary = timeseries.convergence().summary()
    assert summary["offered"] == tps.conv_samples_taken() \
        == sum(c // 4 for c in counts.values()) > 0
    assert summary["best_loss"] < summary["first_loss"]
    timeseries.convergence().reset()


def test_convergence_sample_conf_is_taken_by_the_ps(conf):
    """The PS no longer refuses ``async.convergence.sample``: it starts,
    registers its ``ps`` time-series source and unhooks it at stop."""
    from asyncframework_tpu_torch.metrics import timeseries

    conf.set("async.convergence.sample", 2)
    conf.set("async.metrics.interval.s", 0)
    ps = _port_ps(TConfig(**_kw()))
    try:
        st = timeseries.TimeSeriesStore(capacity=8)
        timeseries.sample_once(st)
        assert st.last("ps.accepted") == 0.0
    finally:
        ps.stop()
    st2 = timeseries.TimeSeriesStore(capacity=8)
    timeseries.sample_once(st2)
    assert st2.last("ps.accepted") is None


@pytest.mark.parametrize("conf_key,item", REFUSED_CONF)
def test_refused_worker_switches_name_their_roadmap_item(conf_key, item,
                                                         conf):
    """No longer refused (ROADMAP ``item`` is ported): a worker process
    with the switch set trains the run to its budget, exactly once."""
    conf.set(conf_key, 2)
    cfg = TConfig(**_kw(num_iterations=60))
    ps = _port_ps(cfg)
    ds = _port_ds()
    counts, _traj = _run(ps, tps.run_worker_process,
                         {w: ds.shard(w) for w in range(NW)}, cfg, "asgd",
                         eval_wid=None)
    _exactly_once(ps, counts, 60)


@pytest.mark.parametrize("conf_key,item", REFUSED_CONF)
def test_refused_conf_switches_on_the_ps(conf_key, item, conf):
    """No longer refused (ROADMAP ``item`` is ported): the PS builds and
    serves with the switch set, and binds no port for it (the dashboard
    is the cluster CLI's, ``tests/test_torch_cli.py``)."""
    from asyncframework_tpu_torch.metrics import live

    conf.set(conf_key, 2)
    before = list(live.active_servers())
    ps = tps.ParameterServer(TConfig(**_kw()), D, N, device=CPU).start()
    try:
        assert ps.port > 0
        assert list(live.active_servers()) == before
    finally:
        ps.stop()


@pytest.mark.parametrize("role", ["ps", "worker"])
def test_ps_child_refuses_a_sharded_cluster_before_its_data(role):
    """A sharded cluster with a switch the role runner refuses (the
    cluster's dashboard, ``ASYNCTPU_ASYNC_UI_PORT=0``, beside
    ``ASYNCTPU_ASYNC_PS_SHARDS=4`` and ``ASYNCTPU_ASYNC_PS_STANDBY=1``)
    fails at once, pointing at the CLI that serves it, and prints no
    port and no result (the sharded group with its standbys runs:
    tests/test_torch_replication.py)."""
    env = _child_env(PS_ROLE=role, PS_ALGO="asgd", PS_NUM_WORKER_PROCS=1,
                     PS_PORT=1, PS_WORKER_ID=0, ASYNCTPU_ASYNC_PS_SHARDS=4,
                     ASYNCTPU_ASYNC_PS_STANDBY=1, ASYNCTPU_ASYNC_UI_PORT=0)
    out = subprocess.run(CHILD, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert ("async.ui.port" in out.stderr
            and "python -m asyncframework_tpu_torch.cli" in out.stderr)
    assert out.stdout == ""


def test_ps_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tps.ParameterServer(TConfig(**_kw()), D, N)

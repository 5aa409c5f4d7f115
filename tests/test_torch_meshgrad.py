"""The port's mesh gradient plane against the JAX package's.

Twins of ``tests/test_meshgrad.py``: the clamp of ``make_mesh``, the two
DCN worker mesh steps (``ops/steps.py``), ``async.mesh.devices=0`` byte
identity, mesh runs on the serial and pipelined loops, convergence samples
and PUSH chaos, then port mesh workers against the JAX package's PS and
JAX-package mesh workers against the port's.  The JAX package runs on its
8 virtual CPU devices, the port on ``[cpu] * 8``.

Masks are made with numpy and injected into both packages
(``jax.random.bernoulli`` and the port's ``ops.steps.bernoulli_mask``
replaced for the call).  The port's mesh step must equal its own rank
fold at tolerance 0 (the same B1 plain version at the block shape, the
partials added in rank order); against the JAX package's mesh step it
holds to rtol 5e-5, atol 5e-4, the ASAGA ``g`` to 5e-4 (f32 products
summed in two libraries' orders).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asyncframework_tpu.conf import AsyncConf as JConf
from asyncframework_tpu.conf import set_global_conf as jset_global_conf
from asyncframework_tpu.data.sharded import ShardedDataset as JDataset
from asyncframework_tpu.ops import steps as jsteps
from asyncframework_tpu.parallel import ps_dcn as jps
from asyncframework_tpu.parallel.mesh import make_mesh as jmake_mesh
from asyncframework_tpu.parallel.mesh import pad_and_shard as jpad_and_shard
from asyncframework_tpu.solvers import SolverConfig as JConfig
from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
from asyncframework_tpu_torch.data.sharded import ShardedDataset as TDataset
from asyncframework_tpu_torch.net import faults, frame, reset_net_totals
from asyncframework_tpu_torch.net.faults import DROP_REPLY, FaultSchedule
from asyncframework_tpu_torch.ops import steps as tsteps
from asyncframework_tpu_torch.ops.gradients import (
    least_squares_grad_sum,
    logistic_grad_sum,
)
from asyncframework_tpu_torch.ops.sampling import (
    bernoulli_mask,
    worker_generator,
)
from asyncframework_tpu_torch.parallel import ps_dcn as tps
from asyncframework_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pad_and_shard,
    pad_and_shard_2d,
    shard_batch,
)
from asyncframework_tpu_torch.solvers import SolverConfig as TConfig

pytestmark = pytest.mark.mesh

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


def make_cfg(Config=TConfig, **kw):
    defaults = dict(
        num_workers=2, num_iterations=60, gamma=1.2, taw=2**31 - 1,
        batch_rate=0.3, bucket_ratio=0.0, printer_freq=20, seed=42,
        calibration_iters=8, run_timeout_s=120.0,
    )
    defaults.update(kw)
    return Config(**defaults)


@pytest.fixture(autouse=True)
def _clean_state():
    tps.reset_pipeline_totals()
    tps.reset_mesh_counts()
    reset_net_totals()
    faults.clear()
    yield
    tps.reset_pipeline_totals()
    tps.reset_mesh_counts()
    reset_net_totals()
    faults.clear()
    set_global_conf(None)
    jset_global_conf(None)


def run_dcn(cfg, conf, nw=None, n=1024, d=16, seed=11, algo="asgd",
            devices=CPU8):
    """One in-process port PS and a port worker process under ``conf``."""
    nw = nw if nw is not None else cfg.num_workers
    set_global_conf(conf)
    ds = TDataset.generate_on_device(n, d, nw, devices=[CPU], seed=seed,
                                     noise=0.01)
    ps = tps.ParameterServer(cfg, d, n, device=CPU, port=0,
                             algo=algo).start()
    try:
        shards = {w: ds.shard(w) for w in range(nw)}
        counts = tps.run_worker_process(
            "127.0.0.1", ps.port, list(range(nw)), shards, cfg, d, n,
            deadline_s=120.0, algo=algo, devices=devices,
        )
        done = ps.wait_done(timeout_s=10.0)
        return ps, counts, done
    finally:
        ps.stop()


def _problem(n=1024, d=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    return X, y, w


def _inject(monkeypatch, mask_bool):
    """Both packages' draws return ``mask_bool`` (numpy, the padded
    length) for the calls of the test."""
    def jax_bernoulli(key, p, shape):
        assert tuple(shape) == mask_bool.shape
        return jnp.asarray(mask_bool)

    def port_bernoulli(gen, n, rate):
        assert n == mask_bool.shape[0]
        return torch.from_numpy(mask_bool.copy())

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(tsteps, "bernoulli_mask", port_bernoulli)


# ------------------------------------------------------------- the mesh
class TestMakeMeshClamp:
    def test_default_still_raises_on_overask(self):
        with pytest.raises(ValueError, match="devices are available"):
            make_mesh(9, devices=CPU8)

    def test_clamp_logs_and_degrades(self, caplog):
        with caplog.at_level(logging.WARNING,
                             logger="asyncframework_tpu_torch.parallel.mesh"):
            mesh = make_mesh(13, devices=CPU8, clamp=True)
        assert mesh.size == 8 and mesh.shape == {"dp": 8}
        assert any("clamping" in r.message for r in caplog.records)


def test_two_axis_mesh_layout_is_row_major():
    mesh = make_mesh(8, axis_names=("dp", "md"), axis_sizes=(4, 2),
                     devices=CPU8)
    assert mesh.shape == {"dp": 4, "md": 2}
    assert [mesh.coords(r) for r in (0, 1, 2, 7)] == [
        {"dp": 0, "md": 0}, {"dp": 0, "md": 1}, {"dp": 1, "md": 0},
        {"dp": 3, "md": 1}]
    assert mesh.rank(dp=2, md=1) == 5
    assert mesh.local_ranks() == list(range(8))
    with pytest.raises(ValueError, match="do not hold"):
        Mesh(CPU8, ("dp", "md"), (3, 2))


def test_placement_helpers_split_rows_and_features():
    """``shard_batch`` splits rows over dp (each block replicated over
    md), ``pad_and_shard`` pads rows and masks them out, and
    ``pad_and_shard_2d`` also pads and splits the features, ``w`` by
    feature block; the blocks reassemble the padded inputs."""
    X, y, w = _problem(n=10, d=5, seed=2)
    mesh = make_mesh(4, devices=[CPU] * 4)
    Xs, ys, vs, n = pad_and_shard(mesh, X, y)
    assert n == 10 and len(Xs) == 4 and Xs[0].shape == (3, 5)
    np.testing.assert_array_equal(torch.cat(Xs).numpy()[:10], X)
    np.testing.assert_array_equal(torch.cat(vs).numpy(),
                                  [1.0] * 10 + [0.0] * 2)
    # an unpadded tensor on the rank's device is split into views
    Xt = torch.from_numpy(X[:8].copy())
    blocks = shard_batch(mesh, Xt)
    assert blocks[1].data_ptr() == Xt[2].data_ptr()
    m2 = make_mesh(4, axis_names=("dp", "md"), axis_sizes=(2, 2),
                   devices=[CPU] * 4)
    Xs2, ys2, vs2, ws2, d = pad_and_shard_2d(m2, X, y, w)
    assert d == 5 and Xs2[0].shape == (5, 3) and ws2[1].shape == (3,)
    np.testing.assert_array_equal(
        torch.cat([torch.cat([Xs2[0], Xs2[1]], 1),
                   torch.cat([Xs2[2], Xs2[3]], 1)]).numpy()[:, :5], X)
    np.testing.assert_array_equal(torch.cat([ws2[0], ws2[1]]).numpy()[:5], w)
    assert torch.equal(ws2[0], ws2[2]) and torch.equal(ys2[2], ys2[3])


# -------------------------------------------------------- step numerics
def _fold(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class TestMeshStepNumerics:
    @pytest.mark.parametrize("n_dev", [2, 8])
    @pytest.mark.parametrize("loss", ["least_squares", "logistic"])
    def test_asgd_mesh_step_equals_its_rank_fold_and_the_jax_step(
            self, devices8, monkeypatch, n_dev, loss):
        """Tolerance 0 against the port's own rank fold (the same masked
        gradient at each block shape, added in rank order); against the
        JAX package's mesh step on the same mask within rtol 5e-5, atol
        5e-4; and the fold is the full-batch gradient up to f32
        reassociation."""
        X, y, w = _problem()
        if loss == "logistic":
            y = (y > 0).astype(np.float32)
        n = X.shape[0]
        mask = np.random.default_rng(7).random(n) < 0.3
        _inject(monkeypatch, mask)
        mesh = make_mesh(n_dev, devices=CPU8[:n_dev])
        Xs, ys, vs, _n = pad_and_shard(mesh, X, y)
        step = tsteps.make_mesh_asgd_worker_step(0.3, mesh, loss)
        g = step(Xs, ys, vs, torch.from_numpy(w),
                 worker_generator(42, 7, CPU))
        grad_sum = (least_squares_grad_sum if loss == "least_squares"
                    else logistic_grad_sum)
        blk = n // n_dev
        mf = torch.from_numpy(mask.astype(np.float32))
        parts = [grad_sum(torch.from_numpy(X[p * blk:(p + 1) * blk]),
                          torch.from_numpy(y[p * blk:(p + 1) * blk]),
                          torch.from_numpy(w), mf[p * blk:(p + 1) * blk])
                 for p in range(n_dev)]
        assert torch.equal(g, _fold(parts))  # tolerance 0
        jmesh = jmake_mesh(n_dev, devices=devices8[:n_dev])
        jXs, jys, jvs, _ = jpad_and_shard(jmesh, X, y)
        jstep = jsteps.make_mesh_asgd_worker_step(0.3, jmesh, loss)
        jg, _key = jstep(jXs, jys, jvs, jnp.asarray(w),
                         jax.random.PRNGKey(3))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=5e-5,
                                   atol=5e-4)
        g_full = grad_sum(torch.from_numpy(X), torch.from_numpy(y),
                          torch.from_numpy(w), mf)
        np.testing.assert_allclose(g.numpy(), g_full.numpy(), rtol=5e-5,
                                   atol=5e-4)

    def test_padded_shard_masks_its_padding_like_the_jax_step(
            self, devices8, monkeypatch):
        """1,001 rows over 8 ranks: the draw covers the padded length
        (1,008) and padding rows never count, as in the JAX package."""
        X, y, w = _problem(n=1001, d=24, seed=5)
        mask = np.random.default_rng(9).random(1008) < 0.5
        mask[1001:] = True  # padding rows drawn in must still count 0
        _inject(monkeypatch, mask)
        mesh = make_mesh(8, devices=CPU8)
        Xs, ys, vs, n = pad_and_shard(mesh, X, y)
        assert n == 1001 and Xs[0].shape[0] == 126
        g = tsteps.make_mesh_asgd_worker_step(0.5, mesh)(
            Xs, ys, vs, torch.from_numpy(w), worker_generator(1, 0, CPU))
        jmesh = jmake_mesh(8, devices=devices8)
        jXs, jys, jvs, _ = jpad_and_shard(jmesh, X, y)
        jg, _ = jsteps.make_mesh_asgd_worker_step(0.5, jmesh)(
            jXs, jys, jvs, jnp.asarray(w), jax.random.PRNGKey(0))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=5e-5,
                                   atol=5e-4)
        want = X.T @ (mask[:1001] * (X @ w - y))
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-5, atol=5e-4)

    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_unpadded_draw_is_the_single_device_steps(self, n_dev):
        """Without injection: the mesh step's one draw over the unpadded
        length is the single-device step's mask, and the generator
        advances as that step's does (tolerance 0 against the fold over
        that mask)."""
        X, y, w = _problem(n=512, d=16, seed=9)
        mesh = make_mesh(n_dev, devices=CPU8[:n_dev])
        Xs, ys, vs, _n = pad_and_shard(mesh, X, y)
        gen, ref_gen = worker_generator(42, 3, CPU), worker_generator(42, 3,
                                                                      CPU)
        g = tsteps.make_mesh_asgd_worker_step(0.2, mesh)(
            Xs, ys, vs, torch.from_numpy(w), gen)
        mask = bernoulli_mask(ref_gen, 512, 0.2).float()
        blk = 512 // n_dev
        parts = [least_squares_grad_sum(
            torch.from_numpy(X[p * blk:(p + 1) * blk]),
            torch.from_numpy(y[p * blk:(p + 1) * blk]), torch.from_numpy(w),
            mask[p * blk:(p + 1) * blk]) for p in range(n_dev)]
        assert torch.equal(g, _fold(parts))
        assert torch.equal(gen.get_state(), ref_gen.get_state())
        # the single-device step draws the same numbers
        single = worker_generator(42, 3, CPU)
        tsteps.make_asgd_worker_step(0.2)(
            torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
            single)
        assert torch.equal(gen.get_state(), single.get_state())

    def test_saga_mesh_step_matches_single_device_and_the_jax_step(
            self, devices8):
        """Candidate scalars EXACT against the port's single-device step
        (one owner per slot; the fold adds zeros); the gradient within
        5e-4; against the JAX package's mesh step: ``diff`` within rtol
        5e-5, atol 5e-4 and ``g`` within 5e-4."""
        X, y, w = _problem(n=1024, d=32, seed=3)
        n = X.shape[0]
        rng = np.random.default_rng(5)
        cap = 160
        idx = np.sort(rng.choice(n, cap, replace=False)).astype(np.int64)
        alpha = rng.standard_normal(cap).astype(np.float32)
        n_valid = 130
        mesh = make_mesh(8, devices=CPU8)
        Xs, ys, _vs, _n = pad_and_shard(mesh, X, y)
        g, diff = tsteps.make_mesh_saga_dcn_worker_step(mesh)(
            Xs, ys, torch.from_numpy(w), torch.from_numpy(idx),
            torch.from_numpy(alpha), n_valid)
        g_ref, diff_ref = tsteps.make_saga_dcn_worker_step()(
            torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
            torch.from_numpy(idx), torch.from_numpy(alpha), n_valid)
        assert torch.equal(diff, diff_ref)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=5e-4,
                                   atol=5e-4)
        assert not np.any(diff.numpy()[n_valid:])
        jmesh = jmake_mesh(8, devices=devices8)
        jXs, jys, _jvs, _ = jpad_and_shard(jmesh, X, y)
        jg, jdiff = jsteps.make_mesh_saga_dcn_worker_step(jmesh)(
            jXs, jys, jnp.asarray(w), jnp.asarray(idx.astype(np.int32)),
            jnp.asarray(alpha), np.int32(n_valid))
        np.testing.assert_allclose(diff.numpy(), np.asarray(jdiff),
                                   rtol=5e-5, atol=5e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=5e-4,
                                   atol=5e-4)

    def test_mesh_step_sampling_is_device_count_invariant(self):
        X, y, w = _problem(n=512, d=16, seed=9)
        outs = []
        for n_dev in (2, 8):
            mesh = make_mesh(n_dev, devices=CPU8[:n_dev])
            Xs, ys, vs, _n = pad_and_shard(mesh, X, y)
            g = tsteps.make_mesh_asgd_worker_step(0.2, mesh)(
                Xs, ys, vs, torch.from_numpy(w), worker_generator(1, 0, CPU))
            outs.append(g.numpy())
        np.testing.assert_allclose(outs[0], outs[1], rtol=5e-5, atol=5e-4)


# ------------------------------------------------- knob=0 byte identity
def test_devices0_conf_set_matches_unset_byte_identical():
    """``async.mesh.devices=0`` is byte-identical on the wire and
    step-identical to the knob being absent, under a fixed seed."""
    results = []
    for mesh_conf in (None, "0"):
        conf = (AsyncConf().set("async.pull.mode", "full")
                .set("async.trace.sample", 0.0))
        if mesh_conf is not None:
            conf.set("async.mesh.devices", mesh_conf)
        reset_net_totals()
        cfg = make_cfg(num_workers=1, num_iterations=40,
                       calibration_iters=10**9)
        ps, counts, done = run_dcn(cfg, conf, nw=1)
        assert done, "run did not finish"
        results.append({
            "accepted": ps.accepted, "dropped": ps.dropped,
            "max_staleness": ps.max_staleness, "clock": ps._clock,
            "pull_replies": dict(ps.pull_replies),
            "bytes": frame.bytes_totals(), "mesh": tps.mesh_counts(),
        })
    unset, zero = results
    assert unset["accepted"] == zero["accepted"] == 40
    for key in ("dropped", "max_staleness", "clock", "pull_replies",
                "bytes"):
        assert unset[key] == zero[key], (key, unset[key], zero[key])
    assert unset["mesh"] == zero["mesh"] == {}


# ------------------------------------------------------------ mesh runs
class TestMeshRuns:
    def test_serial_mesh_run_full_coverage(self):
        conf = (AsyncConf().set("async.mesh.devices", 8)
                .set("async.trace.sample", 0.0))
        cfg = make_cfg(num_workers=4, num_iterations=160, bucket_ratio=0.5)
        ps, counts, done = run_dcn(cfg, conf, nw=4, d=32)
        assert done and ps.accepted == 160
        for w in range(4):
            assert ps.accepted_by_wid.get(w, 0) > 0, ps.accepted_by_wid
        _times, W = ps.snapshot_stack()
        assert np.all(np.isfinite(W[-1]))
        mt = tps.mesh_counts()
        # one placement a wid; every gradient (and one warm-up) a mesh step
        assert mt["ranks"] == 8 and mt["placements"] == 4
        assert mt["steps"] == sum(counts.values()) + 1

    def test_solver_config_mesh_devices_wins_over_the_conf(self):
        conf = AsyncConf().set("async.trace.sample", 0.0)
        cfg = make_cfg(num_workers=2, num_iterations=40, mesh_devices=4)
        ps, counts, done = run_dcn(cfg, conf, nw=2)
        assert done and ps.accepted == 40
        assert tps.mesh_counts()["ranks"] == 4

    def test_asaga_mesh_run_full_coverage(self):
        conf = (AsyncConf().set("async.mesh.devices", 8)
                .set("async.trace.sample", 0.0))
        cfg = make_cfg(num_workers=2, num_iterations=60, gamma=0.5)
        ps, counts, done = run_dcn(cfg, conf, nw=2, n=512, d=12,
                                   algo="asaga")
        assert done and ps.accepted == 60
        for w in range(2):
            assert ps.accepted_by_wid.get(w, 0) > 0, ps.accepted_by_wid
        assert tps.mesh_counts()["steps"] == sum(counts.values()) + 1

    def test_overask_clamps_and_still_completes(self, caplog):
        conf = (AsyncConf().set("async.mesh.devices", 64)
                .set("async.trace.sample", 0.0))
        cfg = make_cfg(num_workers=2, num_iterations=50)
        with caplog.at_level(logging.WARNING,
                             logger="asyncframework_tpu_torch.parallel.mesh"):
            ps, counts, done = run_dcn(cfg, conf, nw=2)
        assert done and ps.accepted == 50
        assert tps.mesh_counts()["ranks"] == 8
        assert any("clamping" in r.message for r in caplog.records)

    def test_one_device_list_degrades_to_the_single_device_step(self,
                                                               caplog):
        conf = (AsyncConf().set("async.mesh.devices", 4)
                .set("async.trace.sample", 0.0))
        cfg = make_cfg(num_workers=2, num_iterations=40)
        with caplog.at_level(logging.WARNING):
            ps, counts, done = run_dcn(cfg, conf, nw=2, devices=[CPU])
        assert done and ps.accepted == 40
        assert "steps" not in tps.mesh_counts()
        assert any("single-device step" in r.message for r in caplog.records)

    def test_pipelined_mesh_run_full_coverage(self):
        conf = (AsyncConf().set("async.pull.mode", "delta")
                .set("async.pipeline.depth", 2)
                .set("async.mesh.devices", 8)
                .set("async.trace.sample", 0.0))
        cfg = make_cfg(num_workers=4, num_iterations=200, bucket_ratio=0.5)
        ps, counts, done = run_dcn(cfg, conf, nw=4, d=32)
        assert done, "pipelined mesh run did not finish"
        assert ps.accepted == 200
        for w in range(4):
            assert ps.accepted_by_wid.get(w, 0) > 0, ps.accepted_by_wid
        pl = tps.pipeline_totals()
        assert pl.get("pushes_async", 0) >= 200
        assert (pl.get("prefetch_hits", 0)
                + pl.get("prefetch_waits", 0)) >= 200
        assert tps.mesh_counts()["steps"] == sum(counts.values()) + 1


def test_conv_samples_fold_with_mesh_on():
    """The convergence sample evaluates the shard on its own device with
    the model the mesh step read: a mesh run with sampling on folds a
    non-empty, finite history."""
    from asyncframework_tpu_torch.metrics import timeseries as ts_mod

    ts_mod.convergence().reset()
    tps.reset_conv_samples_taken()
    conf = (AsyncConf().set("async.mesh.devices", 8)
            .set("async.convergence.sample", 5)
            .set("async.trace.sample", 0.0))
    cfg = make_cfg(num_workers=2, num_iterations=60)
    try:
        ps, counts, done = run_dcn(cfg, conf, nw=2, d=32)
        assert done and ps.accepted == 60
        summary = ts_mod.convergence().summary()
        assert summary["offered"] == tps.conv_samples_taken() == sum(
            c // 5 for c in counts.values()) > 0
        curves = ts_mod.convergence().curves()
        pts = curves.get("loss_vs_version") or curves.get(
            next(iter(curves), ""), [])
        assert pts and all(np.isfinite(p[1]) for p in pts)
    finally:
        ts_mod.convergence().reset()


def test_push_drop_reply_exactly_once_with_mesh_worker():
    """Seeded drop_reply on PUSH against a mesh worker: the retried push
    is answered from the dedup window, never re-applied."""
    conf = (AsyncConf().set("async.mesh.devices", 8)
            .set("async.trace.sample", 0.0))
    set_global_conf(conf)
    n, d, nw = 1024, 16, 2
    cfg = make_cfg(num_workers=nw, num_iterations=80)
    ds = TDataset.generate_on_device(n, d, nw, devices=[CPU], seed=11,
                                     noise=0.01)
    ps = tps.ParameterServer(cfg, d, n, device=CPU, port=0).start()
    ep = f"127.0.0.1:{ps.port}"
    sched = (FaultSchedule(seed=13)
             .add(ep, "PUSH", 4, DROP_REPLY)
             .add(ep, "PUSH", 11, DROP_REPLY)
             .add(ep, "PUSH", 17, DROP_REPLY))
    try:
        with faults.injected(sched) as inj:
            shards = {w: ds.shard(w) for w in range(nw)}
            counts = tps.run_worker_process(
                "127.0.0.1", ps.port, list(range(nw)), shards, cfg, d, n,
                deadline_s=120.0, devices=CPU8,
            )
            done = ps.wait_done(timeout_s=10.0)
            assert done, "mesh chaos run did not finish"
            assert ps.accepted == 80
            assert ps._clock <= sum(counts.values()), (ps._clock, counts)
            assert ps.dedup_hits >= 1
            assert inj.remaining() == [], "all faults must fire"
    finally:
        ps.stop()


# ------------------------------------------------------ across packages
N, D, NW = 4_096, 24, 4


def _data(seed=11):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(N, D)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = (X @ rs.normal(size=D).astype(np.float32)
         + 0.01 * rs.normal(size=N)).astype(np.float32)
    return X, y


def _cross_kw(algo):
    return dict(num_workers=NW, num_iterations=200,
                gamma=1.2 if algo == "asgd" else 0.3, batch_rate=0.3,
                bucket_ratio=0.5, printer_freq=50, calibration_iters=20)


def _finish(ps, counts, n_iter):
    done = ps.wait_done(timeout_s=30.0)
    total = ps.collect_eval(num_worker_procs=1, timeout_s=30.0)
    ps.stop()
    assert done, str(done)
    pushes = sum(ps.pushes_by_wid.values())
    assert ps.accepted == n_iter
    assert pushes == sum(counts.values()) == ps.accepted + ps.dropped
    assert ps.dedup_hits == 0
    traj = np.asarray(total) / N
    assert traj[-1] < traj[0] * 0.05, traj


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_port_mesh_workers_against_the_jax_parameter_server(algo):
    X, y = _data()
    set_global_conf(AsyncConf().set("async.mesh.devices", 8)
                    .set("async.trace.sample", 0.0))
    ps = jps.ParameterServer(make_cfg(JConfig, **_cross_kw(algo)), D, N,
                             device=jax.devices("cpu")[0], port=0,
                             algo=algo).start()
    ds = TDataset(X, y, NW, devices=[CPU])
    counts = tps.run_worker_process(
        "127.0.0.1", ps.port, list(range(NW)),
        {w: ds.shard(w) for w in range(NW)},
        make_cfg(TConfig, **_cross_kw(algo)), D, N, eval_wid=0,
        deadline_s=120.0, algo=algo, devices=CPU8)
    assert tps.mesh_counts()["steps"] == sum(counts.values()) + 1
    _finish(ps, counts, 200)


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_jax_mesh_workers_against_the_port_parameter_server(algo,
                                                           devices8):
    X, y = _data()
    jset_global_conf(JConf().set("async.mesh.devices", 8)
                     .set("async.trace.sample", 0.0))
    ps = tps.ParameterServer(make_cfg(TConfig, **_cross_kw(algo)), D, N,
                             device=CPU, port=0, algo=algo).start()
    ds = JDataset(X, y, NW, devices=[devices8[0]])
    counts = jps.run_worker_process(
        "127.0.0.1", ps.port, list(range(NW)),
        {w: ds.shard(w) for w in range(NW)},
        make_cfg(JConfig, **_cross_kw(algo)), D, N, eval_wid=0,
        deadline_s=120.0, algo=algo)
    _finish(ps, counts, 200)

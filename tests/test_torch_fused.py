"""The port's ``run_fused`` (the device-resident accept loop) against the
JAX package's, on the CPU.

Round parity: one fused round of each package from the same state, with
the same samples.  ``jax.random.bernoulli`` is replaced through
``monkeypatch`` by a function that returns the round's numpy-made masks in
worker order (one reference factory a round, ``rounds_per_call=1``, so each
round traces anew); the port's round gets the same masks through its
sample half (``ops.steps.bernoulli_mask`` replaced the same way).  Nothing
in the JAX package is edited.

Tolerances, each with its reason:

- exact: the iteration counter ``k`` (an f32 advanced by ``nw`` a round)
  and every history entry a round did not sample;
- ``rtol=1e-5`` relative to max|.| for ``w``, ``alpha_bar`` and the
  committed history scalars: every round holds contractions (the worker
  gradient ``X^T (...)``, the residual, ``lr @ G``) whose sums run in
  another order in each package; the elementwise steps around them (the
  ``gamma / sqrt(k/nw + 1)`` schedule, ASAGA's fold) differ at most in the
  last bit (ROADMAP C1).

The whole-run tests mirror the JAX package's ``tests/test_fused.py``:
convergence to the engine's band, the accounting, the guards, determinism
per seed and ASAGA's ``alpha_bar`` invariant, and that every snapshot is
its own round's model (no aliasing of the chunk's snapshot buffer).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asyncframework_tpu.data.sharded import ShardedDataset as JaxSharded
from asyncframework_tpu.ops import steps as jsteps
from asyncframework_tpu.solvers import ASAGA as JaxASAGA
from asyncframework_tpu.solvers import ASGD as JaxASGD
from asyncframework_tpu.solvers import SolverConfig as JaxConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
from asyncframework_tpu_torch.ops import steps as tsteps
from asyncframework_tpu_torch.ops.sampling import worker_generator
from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig
from asyncframework_tpu_torch.solvers.base import (
    FusedRounds,
    fused_chunks,
    run_fused_plan,
)

CPU = torch.device("cpu")
NW, ROWS, D = 4, 100, 32        # workers, rows a shard, dense width
SP_D, SP_K = 48, 6              # sparse width, padded row width
ROUNDS = 3

# one case a form: solver, shards, Bernoulli rate, loss, step size
FORMS = {
    "asgd_compacted_least_squares": ("asgd", False, 0.3, "least_squares", 0.5),
    "asgd_compacted_logistic": ("asgd", False, 0.3, "logistic", 2.0),
    "asgd_full_least_squares": ("asgd", False, 0.7, "least_squares", 0.5),
    "asgd_full_logistic": ("asgd", False, 0.7, "logistic", 2.0),
    "asgd_sparse": ("asgd", True, 0.3, "least_squares", 2.0),
    "asaga_dense": ("asaga", False, 0.3, "least_squares", 0.2),
    "asaga_sparse": ("asaga", True, 0.3, "least_squares", 0.5),
}


def _shards(sparse, loss, seed=0):
    """``NW`` shards as numpy: ``(X, y)`` dense or ``(cols, vals, y)``
    padded ELL (2 to ``SP_K`` distinct columns a row, zero padding)."""
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(NW):
        if sparse:
            cols = np.zeros((ROWS, SP_K), np.int32)
            vals = np.zeros((ROWS, SP_K), np.float32)
            for i in range(ROWS):
                k = rs.integers(2, SP_K + 1)
                cols[i, :k] = rs.choice(SP_D, size=k, replace=False)
                vals[i, :k] = rs.normal(size=k) / np.sqrt(k)
            out.append((cols, vals, rs.normal(size=ROWS).astype(np.float32)))
            continue
        X = (rs.normal(size=(ROWS, D)) / np.sqrt(D)).astype(np.float32)
        z = X @ rs.normal(size=D).astype(np.float32)
        y = (z > 0) if loss == "logistic" else z + 0.01 * rs.normal(size=ROWS)
        out.append((X, y.astype(np.float32)))
    return out


def _masks(rate, seed=1):
    rs = np.random.default_rng(seed)
    return [[rs.random(ROWS) < rate for _ in range(NW)] for _ in range(ROUNDS)]


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5,
        atol=1e-5 * float(np.abs(want).max(initial=1e-30)))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_round_matches_jax_with_injected_masks(form, monkeypatch):
    solver, sparse, rate, loss, gamma = FORMS[form]
    shards = _shards(sparse, loss)
    masks = _masks(rate)
    n = NW * ROWS
    d = SP_D if sparse else D
    sparse_d = SP_D if sparse else None
    jshards = [tuple(jnp.asarray(a) for a in s) for s in shards]
    tshards = [tuple(torch.from_numpy(a) for a in s) for s in shards]

    # the reference pops worker i's mask at its i-th traced draw of a round
    # (a body traced twice sees the same masks again)
    jax_round = {"masks": None, "draws": 0}

    def jax_bernoulli(key, p, shape):
        m = jax_round["masks"][jax_round["draws"] % NW]
        jax_round["draws"] += 1
        assert m.shape == tuple(shape) and p == rate
        return jnp.asarray(m)

    port_queue = []

    def port_bernoulli(gen, n_rows, p):
        m = port_queue.pop(0)
        assert m.shape == (n_rows,) and p == rate
        return torch.from_numpy(m)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(tsteps, "bernoulli_mask", port_bernoulli)

    gens = [worker_generator(42, i, CPU) for i in range(NW)]
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(42), i)
                      for i in range(NW)])
    if solver == "asgd":
        round_fn = tsteps.make_fused_asgd_rounds(
            gamma, rate, n, tshards, gens, loss=loss, sparse_d=sparse_d)
        jstate = (jnp.zeros(d, jnp.float32), jnp.float32(0.0))
        tstate = (torch.zeros(d), torch.zeros(()))
    else:
        round_fn = tsteps.make_fused_saga_rounds(
            gamma, rate, n, tshards, gens, sparse_d=sparse_d)
        zeros = tuple(jnp.zeros(ROWS, jnp.float32) for _ in range(NW))
        jstate = (jnp.zeros(d, jnp.float32), jnp.zeros(d, jnp.float32), zeros)
        tstate = (torch.zeros(d), torch.zeros(d),
                  *(torch.zeros(ROWS) for _ in range(NW)))
    for r in range(ROUNDS):
        jax_round.update(masks=masks[r], draws=0)
        port_queue.extend(masks[r])
        if solver == "asgd":
            rr = jsteps.make_fused_asgd_rounds(
                gamma, rate, n, jshards, loss=loss, rounds_per_call=1,
                sparse_d=sparse_d)
            jw, jk, keys, snap = rr(*jstate, keys)
            jstate = (jw, jk)
            before = tstate
            tstate = round_fn(*tstate)
            np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(jk))
            assert float(tstate[1]) == NW * (r + 1)
        else:
            rr = jsteps.make_fused_saga_rounds(
                gamma, rate, n, jshards, rounds_per_call=1, sparse_d=sparse_d)
            jw, jab, jalphas, keys, snap = rr(*jstate, keys)
            jstate = (jw, jab, jalphas)
            before = tstate
            tstate = round_fn(*tstate)
            _close(tstate[1], jab)
            for i, (a, ja) in enumerate(zip(tstate[2:], jalphas)):
                _close(a, ja)
                # a row the round did not sample keeps its scalar exactly
                kept = ~masks[r][i]
                np.testing.assert_array_equal(a.numpy()[kept],
                                              before[2 + i].numpy()[kept])
        assert jax_round["draws"] >= NW and jax_round["draws"] % NW == 0
        assert not port_queue
        _close(tstate[0], jw)
        np.testing.assert_array_equal(np.asarray(snap[0]), np.asarray(jw))
        # a round writes new tensors and never its inputs
        assert all(a is not b for a, b in zip(tstate, before))
        assert float(np.abs(np.asarray(jw)).max()) > 0


def test_sparse_fused_rejects_logistic():
    with pytest.raises(ValueError, match="least_squares"):
        tsteps.make_fused_asgd_rounds(1.0, 0.3, 100, [(None, None, None)],
                                      [None], loss="logistic", sparse_d=16)
    with pytest.raises(ValueError, match="unknown loss"):
        tsteps.make_fused_asgd_rounds(1.0, 0.3, 100, [(None, None)], [None],
                                      loss="hinge")


# ------------------------------------------------------------ whole runs
def make_cfg(**kw):
    defaults = dict(
        num_workers=8, num_iterations=400, gamma=1.2, taw=2**31 - 1,
        batch_rate=0.3, bucket_ratio=1.0, printer_freq=50, seed=42,
        calibration_iters=10, run_timeout_s=120.0,
    )
    defaults.update(kw)
    return defaults


@pytest.fixture(scope="module")
def planted():
    return ShardedDataset.generate_on_device(4096, 24, 8, devices=[CPU],
                                             seed=11, noise=0.01)


@pytest.fixture(scope="module")
def sparse_planted():
    return SparseShardedDataset.generate_on_device(
        4096, 512, 12, 8, devices=[CPU], seed=9, noise=0.01)


def _run(cls, ds, mode="run_fused", **kw):
    return getattr(cls(ds, None, SolverConfig(**make_cfg(**kw)),
                       devices=[CPU]), mode)()


class TestFusedASGD:
    def test_converges_to_same_band_as_engine(self, planted):
        fused = _run(ASGD, planted)
        engine = _run(ASGD, planted, "run")
        f_first, f_last = fused.trajectory[0][1], fused.trajectory[-1][1]
        e_last = engine.trajectory[-1][1]
        assert f_last < f_first * 0.05, fused.trajectory[-3:]
        assert f_last < max(e_last * 3.0, 1e-8), (f_last, e_last)

    def test_accounting_matches_the_jax_package(self, planted, devices8):
        res = _run(ASGD, planted, num_iterations=160)
        assert res.accepted >= 160
        assert res.rounds == -(-160 // 8)
        assert res.dropped == 0
        assert res.extras["fused"] is True
        assert res.extras["graph_replays"] == 0  # the CPU runs eagerly
        assert res.total_flops > 0 and res.updates_per_sec > 0
        assert res.max_staleness == 7 and res.avg_delay_ms == 0.0
        assert res.waiting_time_ms == {}
        ts = [t for t, _ in res.trajectory]
        assert all(a <= b for a, b in zip(ts, ts[1:]))
        # the JAX package's run on the same shapes: the same counts, the
        # same snapshot points (20 rounds: a chunk of 16 and one of 4)
        jds = JaxSharded.generate_on_device(4096, 24, 8,
                                            devices=[devices8[0]] * 8,
                                            seed=11, noise=0.01)
        ref = JaxASGD(jds, None, JaxConfig(**make_cfg(num_iterations=160)),
                      devices=[devices8[0]]).run_fused()
        for key in ("accepted", "rounds", "dropped", "max_staleness",
                    "total_flops"):
            assert getattr(res, key) == getattr(ref, key), key
        assert len(res.trajectory) == len(ref.trajectory) == 6
        assert res.extras["rounds_per_call"] == ref.extras["rounds_per_call"]

    def test_guards(self, planted):
        with pytest.raises(ValueError, match="taw"):
            _run(ASGD, planted, taw=0)
        with pytest.raises(ValueError, match="straggler"):
            _run(ASGD, planted, coeff=1.0)

    def test_finite_taw_admitted_when_filter_cannot_fire(self, planted):
        """The reference's recipe (``tests/test_fused.py:66-76``): ASGD
        taw=64 >= nw-1=7, so the fused wave's staleness never exceeds the
        bound and the filter cannot fire; the fused run lands in the
        engine band for the same recipe."""
        fused = _run(ASGD, planted, taw=64, num_iterations=240)
        engine = _run(ASGD, planted, "run", taw=64, num_iterations=240)
        assert fused.accepted >= 240
        assert fused.trajectory[-1][1] < max(engine.trajectory[-1][1] * 3.0,
                                             1e-8)

    def test_sparse_fused_matches_engine_band(self, sparse_planted):
        fused = _run(ASGD, sparse_planted, gamma=0.05 * 512)
        engine = _run(ASGD, sparse_planted, "run", gamma=0.05 * 512)
        f_first, f_last = fused.trajectory[0][1], fused.trajectory[-1][1]
        assert f_last < f_first * 0.1, fused.trajectory[-3:]
        assert f_last < max(engine.trajectory[-1][1] * 3.0, 1e-8)
        assert fused.extras["fused"] is True

    def test_deterministic_per_seed(self, planted):
        a = _run(ASGD, planted, num_iterations=80)
        b = _run(ASGD, planted, num_iterations=80)
        c = _run(ASGD, planted, num_iterations=80, seed=43)
        assert np.array_equal(a.final_w, b.final_w)
        assert not np.array_equal(a.final_w, c.final_w)


class TestFusedASAGA:
    @staticmethod
    def _table_mean(ds, res, sparse):
        acc = np.zeros(ds.d, np.float64)
        for wid, a in res.extras["alpha"].items():
            shard = ds.shard(wid)
            if sparse:
                np.add.at(acc, shard.cols.numpy().ravel(),
                          (shard.vals.numpy() * a[:, None]).ravel())
            else:
                acc += shard.X.numpy().astype(np.float64).T @ a
        assert any(np.any(a != 0) for a in res.extras["alpha"].values())
        return acc / ds.n

    def test_matches_engine_band_and_history_invariant(self, planted):
        fused = _run(ASAGA, planted, gamma=0.35, num_iterations=320)
        engine = _run(ASAGA, planted, "run", gamma=0.35, num_iterations=320)
        f_first, f_last = fused.trajectory[0][1], fused.trajectory[-1][1]
        assert f_last < f_first * 0.05, fused.trajectory[-3:]
        assert f_last < max(engine.trajectory[-1][1] * 3.0, 1e-8)
        assert fused.extras["fused"] is True
        np.testing.assert_allclose(fused.extras["alpha_bar"],
                                   self._table_mean(planted, fused, False),
                                   rtol=2e-3, atol=2e-5)

    def test_sparse_fused_asaga_matches_engine_band(self, sparse_planted):
        fused = _run(ASAGA, sparse_planted, gamma=1.5)
        engine = _run(ASAGA, sparse_planted, "run", gamma=1.5)
        f_first, f_last = fused.trajectory[0][1], fused.trajectory[-1][1]
        assert f_last < f_first * 0.2, fused.trajectory[-3:]
        assert f_last < max(engine.trajectory[-1][1] * 3.0, 1e-8)
        np.testing.assert_allclose(
            fused.extras["alpha_bar"],
            self._table_mean(sparse_planted, fused, True),
            rtol=5e-3, atol=5e-5)

    def test_guards(self, planted):
        with pytest.raises(ValueError, match="num_iterations"):
            _run(ASAGA, planted, gamma=0.35, taw=64, num_iterations=320)
        with pytest.raises(ValueError, match="straggler"):
            _run(ASAGA, planted, gamma=0.35, coeff=2.0)

    def test_accounting_matches_the_jax_package(self, planted, devices8):
        res = _run(ASAGA, planted, gamma=0.35, num_iterations=100)
        jds = JaxSharded.generate_on_device(4096, 24, 8,
                                            devices=[devices8[0]] * 8,
                                            seed=11, noise=0.01)
        ref = JaxASAGA(jds, None,
                       JaxConfig(**make_cfg(gamma=0.35, num_iterations=100)),
                       devices=[devices8[0]]).run_fused()
        for key in ("accepted", "rounds", "dropped", "max_staleness",
                    "total_flops"):
            assert getattr(res, key) == getattr(ref, key), key
        assert len(res.trajectory) == len(ref.trajectory)
        assert sorted(res.extras["alpha"]) == sorted(ref.extras["alpha"])
        assert res.extras["alpha_bar"].shape == ref.extras["alpha_bar"].shape


# ----------------------------------------------------- chunks, snapshots
def test_snapshots_are_each_rounds_model():
    """Every snapshot holds its own round's model: 37 rounds in chunks of
    16, 16 and 5, one snapshot a round, each a copy out of the chunk's
    buffer (a replayed graph overwrites it)."""
    fused = FusedRounds(lambda w, k: (w + 1.0, k + 1.0),
                        (torch.zeros(3), torch.zeros(())), ())
    plan = fused_chunks(fused, 37)
    assert [c.rounds for c in plan] == [16, 16, 5]
    assert plan[0] is plan[1]  # one chunk, run twice
    fused = FusedRounds(fused.round_fn, (torch.zeros(3), torch.zeros(())), ())
    snapshots, _, done, replays = run_fused_plan(fused, 37, nw=1,
                                                 printer_freq=1)
    assert done == 37 and replays == 0
    assert [float(w[0]) for _, w in snapshots] == [float(r)
                                                   for r in range(38)]
    assert float(fused.carry[1]) == 37.0
    # every fourth round at printer_freq 8 over 2 workers
    fused = FusedRounds(fused.round_fn, (torch.zeros(3), torch.zeros(())), ())
    snapshots, *_ = run_fused_plan(fused, 37, nw=2, printer_freq=8)
    assert [float(w[0]) for _, w in snapshots] == [
        0.0, 1, 5, 9, 13, 17, 21, 25, 29, 33, 37]


def test_run_fused_snapshots_differ_round_to_round(planted):
    """A snapshot every round of a real run: each round moves the model,
    so no two snapshots before the final one share an objective."""
    res = _run(ASGD, planted, num_iterations=160, printer_freq=8)
    objs = [o for _, o in res.trajectory]
    assert len(objs) == 1 + 20 + 1
    assert len(set(objs[:-1])) == len(objs) - 1
    assert objs[-1] == objs[-2]  # the final model is the last round's

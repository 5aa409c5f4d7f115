"""Checkpoint and resume in the port, against the JAX package, on the CPU.

``checkpoint.py`` is copied into the port; its scenarios from
``tests/test_checkpoint.py`` run on both packages (parametrized ``pkg``).
Then the solvers: ASGD and ASAGA ``run()`` resume where a checkpoint
stopped (model, counter, clock, history table, every worker's
``torch.Generator``), refuse a checkpoint of another run, and treat a
completed run as done.  The model state (``w``, ``k``, ``clock``,
``alpha``, ``alpha_bar``, ``meta``) crosses between the packages in both
directions; the port refuses a checkpoint without ``worker_gens`` rather
than reseed its workers.
"""

import importlib
import os
import threading

import numpy as np
import pytest
import torch

from asyncframework_tpu.data import make_regression

PKGS = ["asyncframework_tpu", "asyncframework_tpu_torch"]
CPU = [torch.device("cpu")]


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------- the file layer
@pytest.mark.parametrize("pkg", PKGS)
def test_nested_state_round_trips(pkg, tmp_path):
    ck = mod(pkg, "checkpoint")
    state = {
        "w": np.arange(8, dtype=np.float32), "k": 17, "clock": 42,
        "gamma": 0.25, "name": "asgd", "flag": True, "nothing": None,
        "worker_keys": {0: np.array([1, 2], np.uint32),
                        3: np.array([5, 6], np.uint32)},
        "pair": (1, 2.5), "lst": [np.ones(3, np.float32), "x"],
    }
    ck.save_checkpoint(tmp_path / "ck", state)
    out = ck.load_checkpoint(tmp_path / "ck")
    np.testing.assert_array_equal(out["w"], state["w"])
    assert (out["k"], out["clock"], out["gamma"], out["name"]) == (
        17, 42, 0.25, "asgd")
    assert out["flag"] is True and out["nothing"] is None
    assert set(out["worker_keys"]) == {0, 3}
    np.testing.assert_array_equal(out["worker_keys"][3],
                                  state["worker_keys"][3])
    assert out["pair"] == (1, 2.5)
    np.testing.assert_array_equal(out["lst"][0], state["lst"][0])


@pytest.mark.parametrize("pkg", PKGS)
def test_device_arrays_fetched_to_host(pkg, tmp_path):
    ck = mod(pkg, "checkpoint")
    if pkg.endswith("torch"):
        arr = torch.arange(4.0)
        state = {"w": arr, "gen": torch.Generator().manual_seed(3).get_state()}
    else:
        import jax.numpy as jnp

        state = {"w": jnp.arange(4.0)}
    ck.save_checkpoint(tmp_path / "ck", state)
    out = ck.load_checkpoint(tmp_path / "ck")
    assert isinstance(out["w"], np.ndarray)
    np.testing.assert_allclose(out["w"], [0, 1, 2, 3])
    if "gen" in state:
        assert out["gen"].dtype == np.uint8
        np.testing.assert_array_equal(out["gen"], state["gen"].numpy())
    with pytest.raises(ValueError):
        ck.save_checkpoint(tmp_path / "bad", {"a/b": 1})


@pytest.mark.parametrize("pkg", PKGS)
def test_manager_save_restore_latest_gc_and_overwrite(pkg, tmp_path):
    CM = mod(pkg, "checkpoint").CheckpointManager
    mgr = CM(tmp_path / "a", max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest_or_none() is None
    for step in (10, 20, 30):
        mgr.save(step, {"w": np.full(4, step, np.float32), "k": step})
    assert mgr.all_steps() == [20, 30]
    assert mgr.restore()["k"] == 30 and mgr.restore(step=20)["k"] == 20
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=10)
    same = CM(tmp_path / "b")
    same.save(5, {"k": 5, "v": 1})
    same.save(5, {"k": 5, "v": 2})
    assert same.restore(step=5)["v"] == 2 and same.all_steps() == [5]


@pytest.mark.parametrize("pkg", PKGS)
def test_manager_sweeps_only_dead_writers_tmp_files(pkg, tmp_path):
    CM = mod(pkg, "checkpoint").CheckpointManager
    mgr = CM(tmp_path)
    (tmp_path / ".tmp-99-99999999.npz").touch()  # a dead pid's orphan
    live = tmp_path / f".tmp-7-{os.getppid()}.npz"  # a live writer's
    live.touch()
    assert mgr.latest_step() is None
    mgr.save(1, {"k": 1})
    assert not (tmp_path / ".tmp-99-99999999.npz").exists()
    assert live.exists() and mgr.all_steps() == [1]


@pytest.mark.parametrize("writer", PKGS)
def test_a_checkpoint_file_reads_in_the_other_package(writer, tmp_path):
    state = {"w": np.linspace(-1, 1, 16).astype(np.float32), "k": 7,
             "clock": 9, "alpha": {0: np.ones(3, np.float32),
                                   1: np.zeros(2, np.float32)},
             "meta": {"solver": "asaga", "num_workers": 2, "d": 16, "n": 5}}
    mod(writer, "checkpoint").CheckpointManager(tmp_path).save(7, state)
    for reader in PKGS:
        out = mod(reader, "checkpoint").CheckpointManager(tmp_path).restore()
        np.testing.assert_array_equal(out["w"], state["w"])
        assert (out["k"], out["clock"], out["meta"]) == (7, 9, state["meta"])
        assert set(out["alpha"]) == {0, 1}
        np.testing.assert_array_equal(out["alpha"][0], state["alpha"][0])


# ---------------------------------------------------------- the solvers
@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_regression(2048, 32, seed=3)
    return X, y


def resume_cfg(pkg, tmp_path, iters, **kw):
    base = dict(num_workers=8, num_iterations=iters, gamma=1.0,
                batch_rate=0.3, bucket_ratio=0.5, printer_freq=50, seed=42,
                calibration_iters=10, run_timeout_s=120.0,
                checkpoint_dir=str(tmp_path / "ckpts"), checkpoint_freq=25)
    base.update(kw)
    return mod(pkg, "solvers").SolverConfig(**base)


def port(kind):
    return getattr(mod("asyncframework_tpu_torch", "solvers"), kind)


def test_generator_states_round_trip_the_stream():
    from asyncframework_tpu_torch.ops.sampling import worker_generator
    from asyncframework_tpu_torch.solvers.base import (generator_states,
                                                       restore_generators)

    gens = {w: worker_generator(42, w, torch.device("cpu")) for w in range(3)}
    locks = {w: threading.Lock() for w in gens}
    for g in gens.values():
        torch.rand(5, generator=g)
    saved = generator_states(gens, locks)
    want = {w: torch.rand(7, generator=g) for w, g in gens.items()}
    fresh = {w: worker_generator(0, w, torch.device("cpu")) for w in gens}
    restore_generators(fresh, saved)
    for w, g in fresh.items():
        assert torch.equal(torch.rand(7, generator=g), want[w])
    with pytest.raises(ValueError, match="workers"):
        restore_generators({0: fresh[0]}, saved)


def test_asgd_resumes_from_saved_step(problem, tmp_path):
    """``tests/test_checkpoint.py::test_asgd_resumes_from_saved_step`` on
    the port: 100 updates, then a second run continues to 200."""
    from asyncframework_tpu_torch.checkpoint import CheckpointManager

    X, y = problem
    pkg = "asyncframework_tpu_torch"
    res1 = port("ASGD")(X, y, resume_cfg(pkg, tmp_path, 100), devices=CPU).run()
    assert res1.accepted == 100 and res1.extras["resumed_from"] == 0
    mgr = CheckpointManager(tmp_path / "ckpts")
    assert mgr.latest_step() == 100
    ck = mgr.restore()
    np.testing.assert_array_equal(ck["w"], res1.final_w)
    assert set(ck["worker_gens"]) == set(range(8))
    assert ck["meta"] == {"solver": "asgd", "num_workers": 8, "d": 32,
                          "n": 2048}
    res2 = port("ASGD")(X, y, resume_cfg(pkg, tmp_path, 200), devices=CPU).run()
    assert res2.accepted == 100 and res2.extras["resumed_from"] == 100
    assert CheckpointManager(tmp_path / "ckpts").latest_step() == 200
    # the resumed run starts at the checkpoint's model, evaluated the same
    assert res2.trajectory[0][1] == pytest.approx(
        res1.trajectory[-1][1], rel=1e-6)
    assert res2.trajectory[-1][1] < res1.trajectory[0][1]


def test_incompatible_resume_rejected(problem, tmp_path):
    X, y = problem
    pkg = "asyncframework_tpu_torch"
    port("ASGD")(X[:1024], y[:1024], resume_cfg(pkg, tmp_path, 30),
                 devices=CPU).run()
    with pytest.raises(ValueError, match="num_workers"):
        port("ASGD")(X[:1024], y[:1024],
                     resume_cfg(pkg, tmp_path, 60, num_workers=4),
                     devices=CPU).run()
    with pytest.raises(ValueError, match="n="):
        port("ASGD")(X[:512], y[:512], resume_cfg(pkg, tmp_path, 60),
                     devices=CPU).run()
    with pytest.raises(ValueError, match="solver"):
        port("ASAGA")(X[:1024], y[:1024],
                      resume_cfg(pkg, tmp_path, 60, gamma=0.5),
                      devices=CPU).run()


def test_asgd_resume_noop_when_complete(problem, tmp_path):
    X, y = problem
    pkg = "asyncframework_tpu_torch"
    first = port("ASGD")(X, y, resume_cfg(pkg, tmp_path, 60), devices=CPU).run()
    res = port("ASGD")(X, y, resume_cfg(pkg, tmp_path, 60), devices=CPU).run()
    assert res.accepted == 0  # already at the target iteration count
    np.testing.assert_array_equal(res.final_w, first.final_w)


def test_batched_drain_checkpoints_across_boundary(problem, tmp_path):
    """``should_save_range``: a batched drain that jumps over k = 100 or
    200 still saves (``tests/test_wiring.py``'s scenario)."""
    from asyncframework_tpu_torch.checkpoint import CheckpointManager

    X, y = problem
    cfg = resume_cfg("asyncframework_tpu_torch", tmp_path, 250, gamma=0.5,
                     drain_batch=8, checkpoint_freq=100,
                     checkpoint_dir=str(tmp_path / "ck"))
    res = port("ASGD")(X, y, cfg, devices=CPU).run()
    assert res.accepted == 250
    saved = CheckpointManager(tmp_path / "ck").all_steps()
    assert len(saved) >= 2
    assert any(100 <= s < 200 for s in saved) and any(200 <= s for s in saved)
    assert res.extras["checkpoint_saves"] >= 3  # two boundaries + the final


def test_asaga_resumes_with_history_table(problem, tmp_path):
    """The table, ``alpha_bar`` and the model come back bit-equal: a run
    resumed at its own budget changes nothing, and a longer one starts at
    the checkpoint's model."""
    from asyncframework_tpu_torch.checkpoint import CheckpointManager

    X, y = problem
    pkg = "asyncframework_tpu_torch"
    res1 = port("ASAGA")(X, y, resume_cfg(pkg, tmp_path, 80, gamma=0.5),
                         devices=CPU).run()
    assert res1.accepted == 80
    ck = CheckpointManager(tmp_path / "ckpts").restore()
    assert ck["k"] == 80 and set(ck["alpha"]) == set(range(8))
    assert sum(a.size for a in ck["alpha"].values()) == 2048
    assert any(np.any(a != 0) for a in ck["alpha"].values())
    same = port("ASAGA")(X, y, resume_cfg(pkg, tmp_path, 80, gamma=0.5),
                         devices=CPU).run()
    assert same.accepted == 0
    np.testing.assert_array_equal(same.extras["alpha_bar"], ck["alpha_bar"])
    for wid, a in ck["alpha"].items():
        np.testing.assert_array_equal(same.extras["alpha"][wid], a)
    res2 = port("ASAGA")(X, y, resume_cfg(pkg, tmp_path, 160, gamma=0.5),
                         devices=CPU).run()
    assert res2.accepted == 80
    assert res2.trajectory[0][1] == pytest.approx(
        res1.trajectory[-1][1], rel=1e-6)
    assert CheckpointManager(tmp_path / "ckpts").latest_step() == 160


def test_sparse_asaga_resumes_with_history_table(tmp_path):
    from asyncframework_tpu_torch.checkpoint import CheckpointManager
    from asyncframework_tpu_torch.data import (SparseShardedDataset,
                                               make_sparse_regression)

    ds = SparseShardedDataset(*make_sparse_regression(1024, 64, 0.1, seed=2),
                              64, 8, devices=CPU)
    pkg = "asyncframework_tpu_torch"
    res1 = port("ASAGA")(ds, None, resume_cfg(pkg, tmp_path, 60, gamma=0.05),
                         devices=CPU).run()
    ck = CheckpointManager(tmp_path / "ckpts").restore()
    assert ck["meta"]["d"] == 64 and ck["k"] == 60
    same = port("ASAGA")(ds, None, resume_cfg(pkg, tmp_path, 60, gamma=0.05),
                         devices=CPU).run()
    assert same.accepted == 0
    np.testing.assert_array_equal(same.extras["alpha_bar"], ck["alpha_bar"])
    for wid, a in ck["alpha"].items():
        np.testing.assert_array_equal(same.extras["alpha"][wid], a)
    np.testing.assert_array_equal(same.final_w, res1.final_w)


# ------------------------------------------- model state across the packages
def test_jax_checkpoint_model_state_resumes_the_port(problem, tmp_path,
                                                     devices8):
    """A JAX package ASAGA checkpoint: the port's resume refuses it as it
    is (no ``worker_gens``: the port never reseeds silently); its model
    state with the port's generator states resumes the port at the JAX
    run's final model and table."""
    from asyncframework_tpu.solvers import ASAGA as JaxASAGA
    from asyncframework_tpu_torch.checkpoint import CheckpointManager
    from asyncframework_tpu_torch.convert import with_worker_generators

    X, y = problem
    jcfg = resume_cfg("asyncframework_tpu", tmp_path, 50, gamma=0.5)
    ref = JaxASAGA(X, y, jcfg, devices=devices8).run()
    pcfg = resume_cfg("asyncframework_tpu_torch", tmp_path, 50, gamma=0.5)
    with pytest.raises(ValueError, match="worker_gens"):
        port("ASAGA")(X, y, pcfg, devices=CPU).run()
    mgr = CheckpointManager(tmp_path / "ckpts")
    ck = mgr.restore()
    assert ck["k"] == 50 and "worker_keys" in ck
    mgr.save(50, with_worker_generators(ck, 42, 8, "cpu"))
    same = port("ASAGA")(X, y, pcfg, devices=CPU).run()
    assert same.accepted == 0
    np.testing.assert_array_equal(same.final_w, ref.final_w)
    np.testing.assert_array_equal(same.extras["alpha_bar"],
                                  ref.extras["alpha_bar"])
    for wid in range(8):
        np.testing.assert_array_equal(same.extras["alpha"][wid],
                                      ref.extras["alpha"][wid])
    np.testing.assert_allclose(same.trajectory[0][1], ref.trajectory[-1][1],
                               rtol=1e-5)


def test_port_checkpoint_model_state_resumes_the_jax_package(problem,
                                                             tmp_path,
                                                             devices8):
    """The other way: a port ASAGA checkpoint reads in the JAX package,
    and its model state with the JAX package's keys resumes a JAX run at
    the port's final model and table."""
    import jax

    from asyncframework_tpu.checkpoint import CheckpointManager as JaxCM
    from asyncframework_tpu.solvers import ASAGA as JaxASAGA
    from asyncframework_tpu_torch.convert import model_state

    X, y = problem
    pcfg = resume_cfg("asyncframework_tpu_torch", tmp_path, 50, gamma=0.5)
    res = port("ASAGA")(X, y, pcfg, devices=CPU).run()
    mgr = JaxCM(tmp_path / "ckpts")
    ck = mgr.restore()
    assert ck["meta"] == {"solver": "asaga", "num_workers": 8, "d": 32,
                          "n": 2048}
    np.testing.assert_array_equal(ck["w"], res.final_w)
    keys = {w: np.asarray(jax.random.fold_in(jax.random.PRNGKey(42), w))
            for w in range(8)}
    assert set(model_state(ck)) == {"w", "k", "clock", "alpha", "alpha_bar",
                                    "meta"}
    mgr.save(50, {**model_state(ck), "worker_keys": keys})
    jcfg = resume_cfg("asyncframework_tpu", tmp_path, 50, gamma=0.5)
    same = JaxASAGA(X, y, jcfg, devices=devices8).run()
    assert same.accepted == 0
    np.testing.assert_array_equal(same.final_w, res.final_w)
    np.testing.assert_array_equal(same.extras["alpha_bar"],
                                  res.extras["alpha_bar"])
    np.testing.assert_allclose(same.trajectory[0][1], res.trajectory[-1][1],
                               rtol=1e-5)

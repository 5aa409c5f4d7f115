"""The port's local cluster launcher (``asyncframework_tpu_torch/cluster.py``)
and its multi-process CLI roles, against the JAX package's, on the CPU.

- The local-cluster cases of ``tests/test_multihost.py``
  (``TestLocalClusterLauncher``, ``TestClusterASGDMode``) run here a
  second time on the port's launcher (their lazy
  ``asyncframework_tpu.cluster`` import aliased to the port's module, the
  CPU asked for with ``ASYNCTPU_FORCE_CPU=1``).  The JAX package gates its
  SPMD cases on its CPU backend's multi-process support; the port's SPMD
  runs on gloo, which every torch build carries, so nothing is gated.
- Mixed clusters: process 0 runs one package's CLI as the PS, processes
  1-2 the other's as workers, over ``--sparse`` synthetic data (numpy, the
  same rows in both); each run ends at its budget with every gradient
  counted once (the serial loop: gradients = accepted + dropped).
- A ``--checkpoint-dir`` written by the JAX package's cluster resumes in
  the port's, and the port's in the JAX package's.
- No silent CPU: without a card and without ``ASYNCTPU_FORCE_CPU`` the
  launcher raises before it starts a process; ``platform="cpu"`` asks.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_multihost as ref_mh
from asyncframework_tpu_torch import cluster as t_cluster
from asyncframework_tpu_torch.net.frame import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a small sparse recipe (4,096 x 24, 6 nonzeros a row, 8 workers)
SPARSE = ["synthetic", "x", "24", "4096", "8", "{iters}", "0.5",
          "2147483647", "0.3", "0.5", "50", "0", "42", "--sparse",
          "--sparse-density", "0.25"]


@pytest.fixture(autouse=True)
def _port_launcher(monkeypatch):
    monkeypatch.setenv("ASYNCTPU_FORCE_CPU", "1")
    monkeypatch.setitem(sys.modules, "asyncframework_tpu.cluster", t_cluster)
    monkeypatch.setattr(ref_mh, "_require_cpu_spmd", lambda: None)
    yield


# ------------------------------ tests/test_multihost.py's launcher cases
class TestLocalClusterLauncherOnThePort(ref_mh.TestLocalClusterLauncher):
    pass


class TestClusterASGDModeOnThePort(ref_mh.TestClusterASGDMode):
    pass


# ------------------------------------------------------------- mixed runs
def _spawn(packages, argv, timeout_s=240.0):
    """One CLI process a package of ``packages`` (process 0 first), joined
    by the bring-up env on the CPU; returns each one's (rc, stdout,
    stderr), every process waited for or killed."""
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for pid, pkg in enumerate(packages):
        env = dict(os.environ, PYTHONPATH=REPO, ASYNCTPU_FORCE_CPU="1",
                   JAX_PLATFORMS="cpu", ASYNCTPU_COORDINATOR=coord,
                   ASYNCTPU_NUM_PROCESSES=str(len(packages)),
                   ASYNCTPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli", *argv], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO))
    out = [None] * len(procs)

    def drain(i, p):
        try:
            out[i] = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            out[i] = p.communicate(timeout=30)

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 60)
        assert not t.is_alive(), "a CLI process outlived its kill"
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, out)]


def _records(results):
    recs = []
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        recs.append(json.loads(out.strip().splitlines()[-1]))
    return recs


JAX, PORT = "asyncframework_tpu", "asyncframework_tpu_torch"


@pytest.mark.parametrize("ps_pkg,worker_pkg", [
    (JAX, PORT),
    pytest.param(PORT, JAX, marks=pytest.mark.slow),
])
def test_mixed_cluster_runs_to_its_budget_exactly_once(ps_pkg, worker_pkg):
    iters = 300
    argv = ["--quiet", "asgd",
            *[a.format(iters=iters) for a in SPARSE],
            "--conf", "async.pipeline.depth=0"]
    ps, *workers = _records(_spawn([ps_pkg, worker_pkg, worker_pkg], argv))
    assert ps["driver"] == "asgd-dcn-ps" and ps["done"] is True
    assert ps["accepted"] == iters
    assert [w["driver"] for w in workers] == ["asgd-dcn-worker"] * 2
    assert sum(w["gradients"] for w in workers) == (ps["accepted"]
                                                    + ps["dropped"])
    assert ps["recovery"]["workers_lost"] == 0
    assert np.isfinite(ps["final_objective"])
    assert ps["final_objective"] < 0.05


def _cluster(pkg, iters, ckpt):
    argv = ["asgd", *[a.format(iters=iters) for a in SPARSE],
            "--checkpoint-dir", str(ckpt)]
    ps, _w = _records(_spawn([pkg, pkg], argv))
    return ps


def test_checkpoint_dir_resumes_across_the_packages(tmp_path):
    """JAX writes at 150, the port resumes there and writes at 300, the
    JAX package resumes there: each resumed run starts at its
    predecessor's final objective (the same data: numpy rows)."""
    first = _cluster(JAX, 150, tmp_path)
    assert first["resumed_from"] is None and first["accepted"] == 150
    second = _cluster(PORT, 300, tmp_path)
    third = _cluster(JAX, 450, tmp_path)
    for run, prev, k in ((second, first, 150), (third, second, 300)):
        assert run["resumed_from"] == k
        assert run["accepted"] == k + 150
        assert np.isfinite(run["final_objective"])
        assert run["final_objective"] < 0.05
    assert sorted(os.listdir(tmp_path)) == ["ps_asgd.npz"]


# ---------------------------------------------------------- no silent CPU
def test_the_launcher_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.delenv("ASYNCTPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(t_cluster.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="ASYNCTPU_FORCE_CPU=1"):
        t_cluster.launch_local_cluster(2, ["asgd"])
    with pytest.raises(RuntimeError, match="platform='cpu'"):
        t_cluster.main(["2", "--", "asgd"])
    assert spawned == []


def test_platform_cpu_asks_for_the_cpu(monkeypatch):
    monkeypatch.delenv("ASYNCTPU_FORCE_CPU", raising=False)
    rc, out = t_cluster.launch_local_cluster(
        1, ["--quiet", "asgd", *[a.format(iters=40) for a in SPARSE]],
        platform="cpu", timeout_s=120.0)
    assert rc == 0
    summary = json.loads(out[-1])
    assert summary["driver"] == "asgd" and summary["accepted"] == 40

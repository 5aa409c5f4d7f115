"""The port's multi-process bring-up on ``torch.distributed`` (gloo).

Twin of ``tests/test_multihost.py``: OS processes on localhost join one
process group through ``parallel/multihost.py`` (the coordinator's
``host:port``, the process count and each process's id from the
``ASYNCTPU_*`` environment), fence on the host barrier (an all-reduce
that also checks the device count), and sum across the process boundary;
then ``MiniBatchSGD`` over a global mesh of 2 processes x 2 CPU ranks
agrees with one process's 4-rank mesh to rtol 1e-4.  The 4-process runs
are ``slow``, as the reference's are.  Each spawned group gets a free
port of its own and a timeout of its own (the rendezvous and every
collective, and the wait for the children), so nothing hangs under
``-n 6``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asyncframework_tpu_torch.parallel import make_mesh, multihost
from asyncframework_tpu_torch.solvers import MiniBatchSGD

CHILD = Path(__file__).parent / "torch_multihost_child.py"
CPU = torch.device("cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_group(n: int, ranks: int = 2, train: bool = False,
                 timeout: float = 120.0):
    """Boot ``n`` processes of one gloo group running the child and return
    their JSON records; every child is waited for or killed."""
    port = free_port()
    procs = []
    try:
        for pid in range(n):
            env = dict(os.environ,
                       ASYNCTPU_COORDINATOR=f"127.0.0.1:{port}",
                       ASYNCTPU_NUM_PROCESSES=str(n),
                       ASYNCTPU_PROCESS_ID=str(pid), MH_RANKS=str(ranks),
                       MH_TIMEOUT_S=str(timeout / 2))
            procs.append(subprocess.Popen(
                [sys.executable, str(CHILD)] + (["train"] if train else []),
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        results = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"child failed:\n{out}\n{err[-3000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _check_bringup(results, n: int, ranks: int = 2):
    by_pid = {r["pid"]: r for r in results}
    assert set(by_pid) == set(range(n))
    for r in results:
        assert r["active"] is True
        assert r["pc"] == n
        assert r["backend"] == "gloo"
        assert r["devices"] == ranks * n
        assert r["mesh_size"] == ranks * n
        assert r["local_ranks"] == list(range(r["pid"] * ranks,
                                              (r["pid"] + 1) * ranks))
        assert r["sum"] == float(n * (n + 1) // 2)


def test_two_process_bringup_barrier_and_sum():
    _check_bringup(_spawn_group(2), 2)


@pytest.mark.slow
def test_four_process_bringup_barrier_and_sum():
    _check_bringup(_spawn_group(4), 4)


def _local_run(ranks: int):
    import torch_multihost_child as child

    X, y = child.problem()
    return MiniBatchSGD(**child.SGD).run(
        X, y, mesh=make_mesh(ranks, devices=[CPU] * ranks))


def _check_training(results, n: int, ranks: int):
    for r in results:
        assert r["active"] and r["pc"] == n and r["mesh_size"] == n * ranks
    for r in results[1:]:
        np.testing.assert_array_equal(results[0]["w"], r["w"])
    w_local, losses, _ = _local_run(n * ranks)
    np.testing.assert_allclose(results[0]["w"], w_local, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(results[0]["final_loss"], float(losses[-1]),
                               rtol=1e-4)


def test_two_process_training_matches_one_process_mesh():
    """2 processes x 2 ranks: each process places only its row blocks of
    the same global arrays, draws its dp indices' masks, folds its ranks
    and all-reduces across; the model matches one process's 4-rank mesh
    (the same masks: one generator a dp index)."""
    _check_training(_spawn_group(2, ranks=2, train=True), 2, 2)


@pytest.mark.slow
def test_four_process_training_matches_one_process_mesh():
    _check_training(_spawn_group(4, ranks=2, train=True), 4, 2)


# ------------------------------------------------------- single process
def test_single_process_is_a_noop(monkeypatch):
    for key in ("ASYNCTPU_COORDINATOR", "ASYNCTPU_NUM_PROCESSES",
                "ASYNCTPU_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.ensure_initialized(devices=[CPU]) is False
    assert multihost.ensure_initialized(num_processes=1,
                                        devices=[CPU]) is False
    assert not multihost.is_initialized()
    assert multihost.process_info() == (0, 1)
    multihost.sync_hosts("solo")  # nothing to fence
    mesh = multihost.global_mesh() if torch.cuda.is_available() else None
    assert mesh is None or mesh.local_ranks() == list(range(mesh.size))


def test_backend_follows_the_devices():
    assert multihost.backend_for([CPU, CPU]) == "gloo"
    assert multihost.backend_for([torch.device("cuda", 0)]) == "nccl"
    with pytest.raises(ValueError, match="kinds"):
        multihost.backend_for([CPU, torch.device("cuda", 0)])


def test_coordinator_needs_count_and_id(monkeypatch):
    for key in ("ASYNCTPU_NUM_PROCESSES", "ASYNCTPU_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="process count"):
        multihost.ensure_initialized(coordinator_address="127.0.0.1:1",
                                     devices=[CPU])
    assert not multihost.is_initialized()


def test_devices_default_to_the_card_and_never_fall_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    monkeypatch.setenv("ASYNCTPU_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("ASYNCTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("ASYNCTPU_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.ensure_initialized()
    assert not multihost.is_initialized()


def test_global_mesh_spans_processes_in_process_order():
    from asyncframework_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([CPU] * 6, ("dp",), process_of=[0, 0, 1, 1, 2, 2],
                process_index=1)
    assert mesh.local_ranks() == [2, 3] and mesh.spans_processes()

"""Guards of the PyTorch port: no JAX, no reference imports, no silent CPU.

The port (``asyncframework_tpu_torch``) and ``chip_smoke.py`` must import
neither ``jax`` nor anything of ``asyncframework_tpu``; its entry points
default to CUDA and raise without a GPU; a CUDA tensor never reaches the
plain version of a kernel.  The import checks run in a subprocess, so the
JAX this test session already imported cannot hide an import.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "asyncframework_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "asyncframework_tpu")


def _port_sources():
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_build", "__"))]
        for fn in filenames:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_package_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "asyncframework_tpu"):
            raise ImportError("blocked: " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "asyncframework_tpu"):
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
import asyncframework_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the read path's packages are among them (serving, relaycast)
for sub_pkg in ("serving.replica", "serving.frontend", "serving.cli",
                "relaycast.node", "relaycast.source", "relaycast.offers"):
    assert pkg.__name__ + "." + sub_pkg in names, sub_pkg
import runpy
runpy.run_path({os.path.join(REPO, "chip_smoke.py")!r}, run_name="imported")
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd="/")
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("module", ["parallel.controller",
                                    "parallel.replication"])
def test_standby_and_controller_modules_import_with_jax_blocked(module):
    """The hot standby's stream and the adaptive controller import (with
    everything they reach) with ``jax`` and ``asyncframework_tpu``
    blocked, in a fresh interpreter."""
    code = f"""
import importlib, sys
sys.path.insert(0, {REPO!r})

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "asyncframework_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
mod = importlib.import_module("asyncframework_tpu_torch.{module}")
print(sorted(m for m in sys.modules if m.startswith("asyncframework_tpu_torch")
             and "{module}" in m))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd="/")
    assert proc.returncode == 0, proc.stderr
    assert f"asyncframework_tpu_torch.{module}" in proc.stdout


def test_no_jax_or_reference_import_in_the_source():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(path, n) for n in names if _forbidden(n)]
    assert not offenders


ENTRY_MODULES = ("cli", "cluster", "deploy.__init__", "deploy.client",
                 "deploy.leader", "deploy.master", "deploy.worker",
                 "serving.__init__", "serving.cli", "relaycast.__init__")


@pytest.mark.parametrize("module", ["cli", "cluster", "deploy.master",
                                    "deploy.worker", "serving.cli"])
def test_command_line_entry_points_run_with_jax_blocked(module):
    """The AST scan above reads the CLI, the launcher and every deploy
    module; each command runs as ``python -m`` (``--help``) in a fresh
    interpreter with ``jax`` and ``asyncframework_tpu`` blocked."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for mod in ENTRY_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod
    code = f"""
import runpy, sys
sys.path.insert(0, {REPO!r})

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "asyncframework_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["{module}", "--help"]
try:
    runpy.run_module("asyncframework_tpu_torch.{module}", run_name="__main__")
except SystemExit:
    pass
print("ran", sorted(m for m in sys.modules if m.split(".")[0] == "jax"))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd="/")
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ran []")


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    import numpy as np

    from asyncframework_tpu_torch.data import ShardedDataset
    from asyncframework_tpu_torch.solvers import ASGD, SolverConfig

    X = np.zeros((16, 4), np.float32)
    y = np.zeros(16, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDataset(X, y, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDataset.generate_on_device(16, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ASGD(X, y, SolverConfig(num_workers=2))
    ds = ShardedDataset(X, y, 2, devices=[torch.device("cpu")])
    assert ds.shard(1).device == torch.device("cpu")


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would launch")
    from asyncframework_tpu_torch.ops import masked_grad as mg

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(mg, "masked_grad_reference", plain)

    def fake(t):
        return torch.Tensor._make_subclass(_CudaTyped, t)

    X, y, w = fake(torch.ones(6, 3)), fake(torch.ones(6)), fake(torch.ones(3))
    assert X.device.type == "cuda"
    before = mg.masked_grad.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        mg.masked_grad(X, y, w)
    assert mg.masked_grad.launches == before


def test_long_context_and_asaga_entry_points_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    import numpy as np

    from asyncframework_tpu_torch.parallel import make_mesh
    from asyncframework_tpu_torch.solvers import ASAGA, SolverConfig
    from asyncframework_tpu_torch.tools import ring_attention_demo

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ring_attention_demo.main(t=16, h=1, d=4)
    X = np.zeros((16, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ASAGA(X, np.zeros(16, np.float32), SolverConfig(num_workers=2))
    assert make_mesh(2, devices=[torch.device("cpu")] * 2).shape == {"dp": 2}


@pytest.mark.parametrize("kernel", ["chunk_attention", "saga_grad", "xt_coeff",
                                    "ell_residual", "segment_sum",
                                    "compacted_grad", "grad_sum",
                                    "saga_slots_grad",
                                    "sparse_saga_slots_grad"])
def test_new_wrappers_never_hand_a_cuda_tensor_to_the_plain_version(
        kernel, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would launch")
    from asyncframework_tpu_torch.ops import chunk_attention as ca
    from asyncframework_tpu_torch.ops import masked_grad as mg
    from asyncframework_tpu_torch.ops import sparse_grad as sg

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for mod, name in ((ca, "chunk_attention_reference"),
                      (mg, "saga_grad_reference"),
                      (mg, "xt_coeff_reference"),
                      (mg, "saga_slots_grad_reference"),
                      (sg, "ell_residual_plain"),
                      (sg, "segment_sum_plain"),
                      (sg, "compacted_grad_plain"),
                      (sg, "grad_sum_plain")):
        monkeypatch.setattr(mod, name, plain)

    def fake(t):
        return torch.Tensor._make_subclass(_CudaTyped, t)

    def counts():
        return (ca.chunk_attention.launches, mg.masked_grad.launches,
                mg.saga_slots_grad.launches,
                sg.ell_residual.launches, sg.segment_sum.launches,
                sg.compacted_grad.launches, sg.grad_sum.launches,
                sg.saga_slots_grad.launches)

    before = counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        if kernel == "chunk_attention":
            q = fake(torch.ones(1, 8, 2, 4))
            ca.chunk_attention(q, q, q)
        elif kernel == "saga_grad":
            X, v6, v3 = fake(torch.ones(6, 3)), fake(torch.ones(6)), fake(torch.ones(3))
            mg.saga_grad(X, v6, v3, v6, v6)
        elif kernel == "xt_coeff":
            mg.xt_coeff(fake(torch.ones(6, 3)), fake(torch.ones(6)))
        elif kernel == "saga_slots_grad":
            X, v6, v3 = fake(torch.ones(6, 3)), fake(torch.ones(6)), fake(torch.ones(3))
            idx, v4 = fake(torch.arange(4)), fake(torch.ones(4))
            mg.saga_slots_grad(X, v6, v3, idx, v4, v4)
        elif kernel == "ell_residual":
            cols = fake(torch.zeros(6, 8, dtype=torch.int32))
            vals, y = fake(torch.ones(6, 8)), fake(torch.ones(6))
            sg.ell_residual(cols, vals, y, fake(torch.ones(3)))
        elif kernel == "segment_sum":
            keys = fake(torch.zeros(48, dtype=torch.int32))
            perm = fake(torch.arange(48))
            sg.segment_sum(keys, perm, fake(torch.ones(6, 8)),
                           fake(torch.ones(6)), 3)
        else:
            cols = fake(torch.zeros(6, 8, dtype=torch.int32))
            vals, y = fake(torch.ones(6, 8)), fake(torch.ones(6))
            if kernel == "compacted_grad":
                sg.compacted_grad(cols, vals, y, fake(torch.ones(3)),
                                  alpha=y)
            elif kernel == "sparse_saga_slots_grad":
                idx, v4 = fake(torch.arange(4)), fake(torch.ones(4))
                sg.saga_slots_grad(cols, vals, y, fake(torch.ones(3)), idx,
                                   v4, v4)
            else:
                sg.grad_sum(cols, vals, y, 3)
    assert counts() == before


def test_sparse_entry_points_refuse_the_cpu():
    """The sparse dataset and the solvers on it default to CUDA and raise
    without a card; asked for the CPU, they run the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    import numpy as np

    from asyncframework_tpu_torch.data import (SparseShardedDataset,
                                               make_sparse_regression)
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig

    csr = make_sparse_regression(16, 8, 0.25, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseShardedDataset(*csr, 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseShardedDataset.generate_on_device(16, 8, 2, 2)
    ds = SparseShardedDataset(*csr, 8, 2, devices=[torch.device("cpu")])
    assert ds.shard(1).device == torch.device("cpu")
    for solver in (ASGD, ASAGA):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver(ds, None, SolverConfig(num_workers=2))
    assert np.isfinite(ASGD(ds, None, SolverConfig(
        num_workers=2, num_iterations=2, printer_freq=1),
        devices=[torch.device("cpu")]).run_sync().final_w).all()


def test_the_dcn_plane_is_scanned():
    """The DCN plane's modules (the parameter server, the wire copies,
    their native gateway, the conf and the supervisor) are among the
    sources both guards above read."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("parallel/ps_dcn.py", "parallel/supervisor.py",
                "native_build.py", "conf.py", "tools/ps_child.py",
                "metrics/flightrec.py", "metrics/profiler.py",
                "utils/threads.py", "net/__init__.py", "net/frame.py",
                "net/wirecodec.py", "net/wiredelta.py", "net/shmring.py",
                "net/retry.py", "net/session.py", "net/faults.py",
                "net/lockwatch.py", "net/health.py", "net/protocol.py"):
        assert rel in scanned, rel


def test_the_lint_and_the_shard_group_are_scanned():
    """The lint (``analysis/*``) and the sharded PS group are among the
    sources both guards above read."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("analysis/__init__.py", "analysis/allowlist.py",
                "analysis/cli.py", "analysis/core.py",
                "analysis/rules_conf.py", "analysis/rules_locks.py",
                "analysis/rules_metrics.py", "analysis/rules_native.py",
                "analysis/rules_protocol.py", "analysis/rules_threads.py",
                "parallel/shardgroup.py", "convert.py", "tools/dcn.py"):
        assert rel in scanned, rel


def test_the_ml_library_is_scanned():
    """Every module of the ML library (``ml/*``) is among the sources both
    guards above read."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("ml/__init__.py", "ml/gradient.py", "ml/updater.py",
                "ml/optimization.py", "ml/models.py", "ml/stat.py",
                "ml/decomposition.py", "ml/linalg_distributed.py",
                "ml/clustering.py", "ml/recommendation.py",
                "ml/word2vec.py", "ml/lda.py", "tools/ml.py"):
        assert rel in scanned, rel


def test_ml_estimators_refuse_the_cpu():
    """Without a card every estimator raises unless it is given a CPU mesh
    or device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    import numpy as np

    from asyncframework_tpu_torch import ml

    X = np.ones((16, 4), np.float32)
    y = np.zeros(16, np.float32)
    refused = [
        lambda: ml.GradientDescent().optimize(X, y),
        lambda: ml.LBFGS().optimize(X, y),
        lambda: ml.LogisticRegression().fit(X, y),
        lambda: ml.LinearSVM().fit(X, y),
        lambda: ml.SoftmaxRegression().fit(X, np.zeros(16, np.int64)),
        lambda: ml.KMeans(2).fit(X),
        lambda: ml.BisectingKMeans(2).fit(X),
        lambda: ml.StreamingKMeans(2),
        lambda: ml.PowerIterationClustering(2).fit_predict(np.ones((4, 4))),
        lambda: ml.col_stats(X),
        lambda: ml.corr(X),
        lambda: ml.chi_sq_test([1.0, 2.0]),
        lambda: ml.KernelDensity().set_sample(y),
        lambda: ml.PCA(2).fit(X),
        lambda: ml.svd(X, 2),
        lambda: ml.RowMatrix(X),
        lambda: ml.CoordinateMatrix([0], [0], [1.0], (1, 1)),
        lambda: ml.BlockMatrix.from_dense(X),
        lambda: ml.ALS(rank=2).fit(X),
        lambda: ml.Word2Vec().fit([["a", "b", "a", "b"]]),
        lambda: ml.LDA(2).fit(X),
    ]
    for fn in refused:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    from asyncframework_tpu_torch.parallel import make_mesh

    cpu = torch.device("cpu")
    assert ml.col_stats(X, device=cpu).count == 16
    assert ml.KMeans(2).fit(X, make_mesh(1, devices=[cpu])).k == 2

"""The port's submit CLI (``asyncframework_tpu_torch/cli.py``) and its dense
LibSVM loader against the JAX package's, on the CPU.

- ``tests/test_cli.py`` runs here a second time with its ``cli`` swapped
  for the port's (``ASYNCTPU_FORCE_CPU=1``: the port's CLI takes the CPU
  only when asked, here as 8 ranks, the count ``XLA_FLAGS`` gives the JAX
  package's tests), and the LibSVM cases of ``tests/test_native.py`` with
  its loader functions swapped for the port's.
- The same LibSVM file through both CLIs: the loaded arrays are equal,
  ``asgd-sync`` and ``sgd-mllib`` at b = 1.0 agree (rtol 1e-6 and 1e-4),
  and the summaries carry the same keys and as many trajectory lines.
- Each bad recipe raises the same ``SystemExit`` text in both CLIs, and
  each ``CONF_TO_FIELD`` key sets the same ``SolverConfig`` field in both
  (the solver class replaced by one that captures its config).
- The native parser: built from source into the port's build directory
  (never the checked-in ``native/libsvm_parser.so``), bit-equal to the
  line parser, and each dense load counted by the path it took, a load
  without the library as a ``python_fallbacks``.
- No silent CPU: without a card and without ``ASYNCTPU_FORCE_CPU`` the
  CLI raises, saying how to ask for the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_cli as ref_cli
import test_native as ref_native
from asyncframework_tpu import cli as j_cli
from asyncframework_tpu import conf as j_conf
from asyncframework_tpu.data import libsvm as j_libsvm
from asyncframework_tpu_torch import cli as t_cli
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch import native_build as t_native_build
from asyncframework_tpu_torch.data import libsvm as t_libsvm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
recipe = ref_cli.recipe


@pytest.fixture(autouse=True)
def _cpu_and_fresh_conf(monkeypatch):
    """The port's CLI on the CPU (asked for), both packages' process conf
    reset after each test (the CLIs install their overlays)."""
    monkeypatch.setenv("ASYNCTPU_FORCE_CPU", "1")
    yield
    t_conf.set_global_conf(None)
    j_conf.set_global_conf(None)


def write_libsvm(path, X, y):
    with open(path, "w") as fh:
        for i in range(X.shape[0]):
            feats = " ".join(f"{j + 1}:{X[i, j]:.6f}"
                             for j in range(X.shape[1]) if X[i, j] != 0)
            fh.write(f"{y[i]:.6f} {feats}\n")


@pytest.fixture()
def libsvm_file(tmp_path):
    """A 512 x 12 least-squares problem as a LibSVM file (numpy, seeded)."""
    rs = np.random.default_rng(5)
    X = rs.normal(size=(512, 12)).astype(np.float32) / np.sqrt(12)
    X[rs.random(size=X.shape) < 0.2] = 0.0
    y = (X @ rs.normal(size=12).astype(np.float32)).astype(np.float32)
    write_libsvm(tmp_path / "p.libsvm", X, y)
    return tmp_path, "p.libsvm"


def run_both(capsys, argv):
    """``argv`` through the JAX package's CLI, then the port's: each one's
    summary and trajectory lines."""
    out = []
    for cli in (j_cli, t_cli):
        assert cli.main(list(argv)) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        out.append((json.loads(lines[-1]), lines[:-1]))
    return out


# ----------------------------------------- tests/test_cli.py on the port
@pytest.fixture(autouse=True)
def _port_cli(monkeypatch):
    monkeypatch.setattr(ref_cli, "cli", t_cli)
    yield


class TestDriversOnThePort(ref_cli.TestDrivers):
    pass


class TestObservabilityFlagsOnThePort(ref_cli.TestObservabilityFlags):
    pass


# ------------------------------ tests/test_native.py's LibSVM cases, port
@pytest.fixture(autouse=True)
def _port_loader(monkeypatch):
    for name, value in (("_native_lib", t_libsvm._native_lib),
                        ("load_libsvm", t_libsvm.load_libsvm),
                        ("parse_libsvm_lines", t_libsvm.parse_libsvm_lines)):
        monkeypatch.setattr(ref_native, name, value)
    yield


class TestLibsvmParserOnThePort(ref_native.TestLibsvmParser):
    pass


def test_native_parser_is_built_from_source_into_the_port():
    lib = t_libsvm._native_lib()
    assert lib is not None
    assert lib._name == t_native_build.ensure_built("libsvm_parser")
    assert lib._name.startswith(t_native_build.BUILD_DIR)
    assert not lib._name.endswith(os.path.join("native", "libsvm_parser.so"))


def test_native_parse_is_bit_equal_to_the_line_parser(tmp_path):
    rs = np.random.default_rng(3)
    X = rs.normal(size=(300, 40)).astype(np.float32)
    X[rs.random(size=X.shape) < 0.3] = 0.0
    y = rs.normal(size=300).astype(np.float32)
    ref_native.write_libsvm(tmp_path / "b.libsvm", X, y)
    Xn, yn = t_libsvm.load_libsvm(str(tmp_path / "b.libsvm"), 40)
    Xp, yp = t_libsvm.load_libsvm(str(tmp_path / "b.libsvm"), 40,
                                  use_native=False)
    assert np.array_equal(Xn, Xp) and np.array_equal(yn, yp)


def test_each_dense_load_counts_its_path_and_a_fallback(tmp_path,
                                                        monkeypatch):
    p = tmp_path / "c.libsvm"
    p.write_text("1 1:0.5 3:2\n-1 2:1.5\n")
    t_native_build.reset_native_totals()
    t_libsvm.load_libsvm(str(p), 3)
    t_libsvm.load_libsvm(str(p), 3, use_native=False)
    t_libsvm.load_libsvm(str(p))  # no d: the line parser, not a fallback
    totals = t_native_build.native_totals()
    assert totals == {"native_calls.libsvm": 1, "python_calls.libsvm": 2}
    monkeypatch.setattr(t_libsvm, "_native_lib", lambda: None)
    X, y = t_libsvm.load_libsvm(str(p), 3)
    assert X.shape == (2, 3) and y.tolist() == [1.0, -1.0]
    totals = t_native_build.native_totals()
    assert totals["python_fallbacks"] == 1
    assert totals["python_calls.libsvm"] == 3
    t_native_build.reset_native_totals()


# ----------------------------------------- one file through both CLIs
def test_both_loaders_give_equal_arrays(libsvm_file):
    path = os.path.join(*libsvm_file)
    for a, b in zip(j_libsvm.load_libsvm(path, 12),
                    t_libsvm.load_libsvm(path, 12)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(j_libsvm.load_libsvm_sparse(path, 12),
                    t_libsvm.load_libsvm_sparse(path, 12)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_asgd_sync_agrees_across_the_packages(capsys, libsvm_file):
    """b = 1.0: every round is the full gradient of every shard, so the
    two packages run the same arithmetic (C1 measured 6e-8)."""
    d, f = libsvm_file
    (js, jt), (ts, tt) = run_both(capsys, recipe(
        "asgd-sync", path=str(d), file=f, d=12, N=512, iters=20, gamma=0.5,
        b=1.0, pfreq=5))
    assert set(js) == set(ts)
    assert len(jt) == len(tt) > 2
    np.testing.assert_allclose(ts["final_objective"], js["final_objective"],
                               rtol=1e-6)
    objs = [[float(line.strip("()").split(",")[1]) for line in t]
            for t in (jt, tt)]
    np.testing.assert_allclose(objs[1], objs[0], rtol=1e-6)
    assert ts["accepted"] == js["accepted"] == 20 * 8


def test_sgd_mllib_agrees_across_the_packages(capsys, libsvm_file):
    """b = 1.0 on 8 ranks in both (the JAX package's 8 virtual CPU
    devices, the port's 8 CPU ranks): the same iterations, summed in
    another order."""
    d, f = libsvm_file
    (js, jt), (ts, tt) = run_both(capsys, recipe(
        "sgd-mllib", path=str(d), file=f, d=12, N=512, iters=30, gamma=0.5,
        b=1.0, pfreq=10))
    assert set(js) == set(ts)
    assert len(jt) == len(tt) == 30
    assert ts["iterations"] == js["iterations"] == 30
    np.testing.assert_allclose(ts["final_objective"], js["final_objective"],
                               rtol=1e-4)


@pytest.mark.parametrize("driver", ["asgd", "asaga-fused"])
def test_summary_keys_and_trajectory_lines_match(capsys, libsvm_file,
                                                 driver):
    d, f = libsvm_file
    (js, jt), (ts, tt) = run_both(capsys, recipe(
        driver, path=str(d), file=f, d=12, N=512, iters=32, gamma=0.3,
        pfreq=8))
    assert set(js) == set(ts)
    assert len(jt) == len(tt) > 0
    assert ts["accepted"] >= 32 and js["accepted"] >= 32


# --------------------------------------------------- guards and overlays
BAD_RECIPES = {
    "unknown_driver": recipe("SparkNotADriver"),
    "missing_file": recipe("asgd", path="/nonexistent-dir", file="x.libsvm"),
    "fused_checkpoint": recipe("asgd-fused", extra=("--checkpoint-dir", "c")),
    "sync_checkpoint": recipe("asaga-sync", extra=("--checkpoint-dir", "c")),
    "mllib_checkpoint": recipe("sgd-mllib", extra=("--checkpoint-dir", "c")),
    "report_without_log": recipe("asgd", extra=("--report", "r.html")),
    "stale_read_sync": recipe("asgd-sync", extra=("--stale-read", "1")),
    "fused_speculation": recipe("asgd-fused", extra=("--speculation",)),
    "fused_allocation": recipe("asaga-fused",
                               extra=("--dynamic-allocation",)),
    "fused_ui": recipe("asgd-fused", extra=("--ui-port", "0")),
    "fused_metrics_csv": recipe("asgd-fused", extra=("--metrics-csv", "m")),
    "asgd_fused_taw": recipe("asgd-fused", taw=3),
    "asgd_fused_taw_overlay": recipe("asgd-fused",
                                     extra=("--conf", "async.taw=2")),
    "asaga_fused_taw": recipe("asaga-fused", taw=10, iters=40),
    "fused_coeff": recipe("asgd-fused", coeff=0.5),
    "mllib_sparse": recipe("sgd-mllib", extra=("--sparse",)),
    "conf_without_equals": recipe("asgd", extra=("--conf", "async.taw")),
}


@pytest.mark.parametrize("name", sorted(BAD_RECIPES))
def test_bad_recipes_raise_the_same_text(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    texts = []
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(list(BAD_RECIPES[name]))
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert texts[0]


def test_unknown_conf_key_is_refused_alike():
    """The refusal lists each package's registry, so the text is the same
    up to the list; the port's registry is the JAX package's less the
    modules it has not ported."""
    texts = []
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(recipe("asgd", extra=("--conf", "async.no.such=1")))
        texts.append(str(e.value))
    head = "--conf: unknown key 'async.no.such'; registered keys: "
    assert all(t.startswith(head) for t in texts)
    assert set(texts[1][len(head):].split(", ")) <= set(
        texts[0][len(head):].split(", "))


class _Captured(Exception):
    def __init__(self, cfg):
        super().__init__("captured")
        self.cfg = cfg


class _CaptureSolver:
    def __init__(self, X, y, cfg, devices=None):
        raise _Captured(cfg)


def _overlay_value(key):
    kind = t_conf.registry()[key].value_type
    if key == "async.pull.mode":
        return "full", "full"
    if key == "async.codec.push":
        return "fp16", "fp16"
    return {int: ("3", 3), float: ("0.375", 0.375)}[kind]


def test_the_field_tables_are_the_same():
    assert t_cli.CONF_TO_FIELD == j_cli.CONF_TO_FIELD
    assert t_cli.DRIVER_ALIASES == j_cli.DRIVER_ALIASES
    assert [(n, t) for n, t, _d in t_cli.POSITIONAL] == [
        (n, t) for n, t, _d in j_cli.POSITIONAL]
    for key in t_cli.CONF_TO_FIELD:
        je, te = j_conf.registry()[key], t_conf.registry()[key]
        assert (je.default, je.value_type) == (te.default, te.value_type)


@pytest.mark.parametrize("key", sorted(j_cli.CONF_TO_FIELD))
def test_each_conf_overlay_sets_the_same_field(key, libsvm_file,
                                              monkeypatch):
    import asyncframework_tpu.solvers as j_solvers
    import asyncframework_tpu_torch.solvers as t_solvers

    field = t_cli.CONF_TO_FIELD[key]
    text, want = _overlay_value(key)
    d, f = libsvm_file
    got = []
    for cli, solvers in ((j_cli, j_solvers), (t_cli, t_solvers)):
        monkeypatch.setattr(solvers, "ASGD", _CaptureSolver)
        with pytest.raises(_Captured) as e:
            cli.main(recipe("asgd", path=str(d), file=f, d=12, N=512,
                            extra=("--conf", f"{key}={text}")))
        got.append(getattr(e.value.cfg, field))
    assert got[0] == got[1] == want


# ---------------------------------------------------------- no silent CPU
def test_the_cli_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.delenv("ASYNCTPU_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="ASYNCTPU_FORCE_CPU=1"):
        t_cli.main(recipe("asgd", iters=5))
    with pytest.raises(RuntimeError, match="ASYNCTPU_FORCE_CPU=1"):
        t_cli.resolve_cli_devices()


def test_the_cli_process_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is the GPU")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ASYNCTPU_FORCE_CPU", None)
    proc = subprocess.run(
        [sys.executable, "-m", "asyncframework_tpu_torch.cli",
         *recipe("asgd", iters=5, extra=("--quiet",))],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode != 0
    assert "ASYNCTPU_FORCE_CPU=1" in proc.stderr
    assert proc.stdout == ""


def test_cpu_ranks_follow_the_jax_packages_device_count(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS",
                       "--foo --xla_force_host_platform_device_count=3")
    assert t_cli.resolve_cli_devices() == [torch.device("cpu")] * 3
    assert t_cli.resolve_cli_devices(2) == [torch.device("cpu")] * 2
    monkeypatch.delenv("XLA_FLAGS")
    assert t_cli.cpu_ranks() == 1

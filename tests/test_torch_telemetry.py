"""The port's telemetry plane against the JAX package's own tests and
against the JAX package's modules.

- The JAX package's unit tests of its telemetry plane
  (``tests/test_telemetry.py``: the time-series store, the convergence
  history, SLO rules and their state machine, the Prometheus exposition,
  the registry audit, the sampler, the HTTP endpoints, ``async-top``),
  its profiler (``tests/test_profiler.py``) and its observer and flight
  recorder (``tests/test_observer.py``) run here a second time, with the
  modules they test swapped for the port's copies: the reference modules'
  globals by monkeypatch, their lazy imports by aliasing the JAX module
  names to the port's in ``sys.modules`` for the test's duration.  The
  serving plane's cases run too: the freshness-lag signal, and the
  acceptance runs (a JAX-package PS child process, ``tests/ps_dcn_child.py``,
  trained by the port's workers in this process while a port replica and
  a port frontend process serve ``/metrics``; the serve-freshness SLO
  firing across a SIGKILL of a port replica process and recovering).  The
  cases left out need what the port does not have yet: ``bench.py``'s
  profile block (the port's benchmark is A2b's), the k8s manifests (A8),
  and the multi-process chaos run of the JAX package's cluster.  A case
  whose body names a JAX-only path (a classifier row, a JAX device) is
  rewritten for the port beside it, under the same name.
- Across the packages: one event log replayed into both packages'
  ``LiveStateListener`` gives equal snapshots and the same sections less
  the unported ones; each package's ``/metrics`` passes the other's
  strict parser; ``fold_trajectory`` gives equal convergence summaries and
  curves; convergence samples cross the wire both ways with exactly-once
  delivery; each package's observer scrapes the other's endpoint; the
  port's counter families plus ``UNPORTED_FAMILIES`` are the JAX
  package's, in order; a flight dump of either is read by the other.
- The port's own parts: the profiler's classifier rows for the port's
  kernel wrappers and ``/torch/``, ``memory_gauges`` never creating a
  CUDA context, the step factories unwrapped with no profiler installed
  (identity) and counted with one, and a ``ui_port=0`` ASGD ``run()``
  served and gated as ``chip_smoke.py``'s telemetry phase gates it
  (``tools/telemetry.py``).

Ports are ephemeral; sampler intervals are 0.05 s or more.
"""

import json
import sys

import numpy as np
import pytest
import torch

import test_observer as ref_obs
import test_profiler as ref_prof
import test_telemetry as ref_tel
from asyncframework_tpu import conf as j_conf
from asyncframework_tpu.data.sharded import ShardedDataset as JDataset
from asyncframework_tpu.metrics import eventlog as j_eventlog
from asyncframework_tpu.metrics import flightrec as j_flightrec
from asyncframework_tpu.metrics import live as j_live
from asyncframework_tpu.metrics import observer as j_observer
from asyncframework_tpu.metrics import prom as j_prom
from asyncframework_tpu.metrics import registry as j_registry
from asyncframework_tpu.metrics import reset_totals as j_reset_totals
from asyncframework_tpu.metrics import timeseries as j_ts
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu.solvers import SolverConfig as JConfig
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch.data.sharded import ShardedDataset as TDataset
from asyncframework_tpu_torch.metrics import eventlog as t_eventlog
from asyncframework_tpu_torch.metrics import flightrec as t_flightrec
from asyncframework_tpu_torch.metrics import live as t_live
from asyncframework_tpu_torch.metrics import observer as t_observer
from asyncframework_tpu_torch.metrics import profiler as t_profiler
from asyncframework_tpu_torch.metrics import prom as t_prom
from asyncframework_tpu_torch.metrics import registry as t_registry
from asyncframework_tpu_torch.metrics import reset_totals as t_reset_totals
from asyncframework_tpu_torch.metrics import slo as t_slo
from asyncframework_tpu_torch.metrics import timeseries as t_ts
from asyncframework_tpu_torch.metrics import top as t_top
from asyncframework_tpu_torch.net import faults as t_faults
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net import reset_net_totals as t_reset_net
from asyncframework_tpu_torch.net import wirecodec as t_wirecodec
from asyncframework_tpu_torch.net import wiredelta as t_wiredelta
from asyncframework_tpu_torch.net.retry import reset_breakers as t_breakers
from asyncframework_tpu_torch.ops import steps as t_steps
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.parallel import shardgroup as t_sg
from asyncframework_tpu_torch.parallel import supervisor as t_sup
from asyncframework_tpu_torch.serving import ServingFrontend as TFrontend
from asyncframework_tpu_torch.serving import metrics as t_smetrics
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.utils.clock import ManualClock
from torch_serving_support import port_subprocess

CPU = torch.device("cpu")

#: the JAX package's module names whose lazy imports inside the reference
#: tests resolve to the port's copies while a port case runs
ALIASES = {
    "asyncframework_tpu.metrics.live": t_live,
    "asyncframework_tpu.metrics.observer": t_observer,
    "asyncframework_tpu.metrics.top": t_top,
    "asyncframework_tpu.metrics.registry": t_registry,
    "asyncframework_tpu.metrics.timeseries": t_ts,
    "asyncframework_tpu.metrics.slo": t_slo,
    "asyncframework_tpu.data.sharded": sys.modules[
        "asyncframework_tpu_torch.data.sharded"],
}


def _port_cfg(**kw):
    """``tests/test_telemetry.py::make_cfg`` on the port's SolverConfig."""
    defaults = dict(
        num_workers=8, num_iterations=300, gamma=1.2, taw=2**31 - 1,
        batch_rate=0.3, bucket_ratio=0.5, printer_freq=50, seed=42,
        calibration_iters=20, run_timeout_s=120.0,
    )
    defaults.update(kw)
    return SolverConfig(**defaults)


@pytest.fixture()
def devices8():
    """The reference cases' JAX device list, as the port's CPU devices."""
    return [CPU] * 8


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    """Point the reference test modules' globals at the port's copies and
    alias their lazy imports; leave the port's telemetry state clean."""
    for name, mod in ALIASES.items():
        monkeypatch.setitem(sys.modules, name, mod)
    conf_globals = dict(AsyncConf=t_conf.AsyncConf,
                        global_conf=t_conf.global_conf,
                        set_global_conf=t_conf.set_global_conf)
    for name, value in dict(
            conf_globals, registry=t_registry, reset_totals=t_reset_totals,
            slo=t_slo, prom=t_prom, ts=t_ts, top=t_top,
            LiveStateListener=t_live.LiveStateListener,
            LiveUIServer=t_live.LiveUIServer,
            start_telemetry_from_conf=t_live.start_telemetry_from_conf,
            faults=t_faults, reset_breakers=t_breakers, ps_dcn=t_ps,
            make_cfg=_port_cfg, ManualClock=ManualClock,
            ShardedDataset=TDataset, ServingFrontend=TFrontend,
            smetrics=t_smetrics, subprocess=port_subprocess).items():
        monkeypatch.setattr(ref_tel, name, value)
    for name, value in dict(
            AsyncConf=t_conf.AsyncConf, set_global_conf=t_conf.set_global_conf,
            flightrec=t_flightrec, profiler=t_profiler,
            reset_totals=t_reset_totals, frame=t_frame,
            wirecodec=t_wirecodec, wiredelta=t_wiredelta,
            reset_net_totals=t_reset_net).items():
        monkeypatch.setattr(ref_prof, name, value)
    for name, value in dict(
            conf_mod=t_conf, AsyncConf=t_conf.AsyncConf,
            set_global_conf=t_conf.set_global_conf, flightrec=t_flightrec,
            live=t_live, observer=t_observer, timeseries=t_ts,
            LiveUIServer=t_live.LiveUIServer,
            ClusterObserver=t_observer.ClusterObserver,
            RoleTarget=t_observer.RoleTarget,
            RunHistoryStore=t_observer.RunHistoryStore,
            parse_endpoints=t_observer.parse_endpoints,
            straggler_scores=t_observer.straggler_scores,
            render_fleet=t_top.render_fleet, faults=t_faults,
            reset_net_totals=t_reset_net, reset_breakers=t_breakers,
            ps_dcn=t_ps, sup_mod=t_sup, sg=t_sg,
            SolverConfig=SolverConfig).items():
        monkeypatch.setattr(ref_obs, name, value)
    _clean()
    yield
    _clean()


def _clean():
    """The union of the reference modules' clean-state fixtures, on the
    port (the telemetry state is process-global)."""
    t_ts.stop_sampler()
    t_profiler.uninstall()
    t_profiler._last_final = None
    t_flightrec.uninstall()
    t_conf.set_global_conf(None)
    t_reset_totals()
    t_breakers()
    t_faults.clear()


@pytest.fixture()
def _telemetry_conf():
    """``tests/test_telemetry.py``'s fresh installed conf."""
    t_conf.set_global_conf(t_conf.AsyncConf())


@pytest.fixture()
def _profiler_conf():
    """``tests/test_profiler.py``'s conf: the sampler thread off."""
    c = t_conf.AsyncConf()
    c.set("async.metrics.interval.s", 0)
    t_conf.set_global_conf(c)


@pytest.fixture()
def _observer_conf():
    """``tests/test_observer.py``'s conf: the sampler at 0.25 s."""
    c = t_conf.AsyncConf()
    c.set("async.metrics.interval.s", 0.25)
    t_conf.set_global_conf(c)


# ------------------------------------- tests/test_telemetry.py on the port
@pytest.mark.usefixtures("_telemetry_conf")
class TestTimeSeriesStoreOnThePort(ref_tel.TestTimeSeriesStore):
    pass


@pytest.mark.usefixtures("_telemetry_conf")
class TestConvergenceHistoryOnThePort(ref_tel.TestConvergenceHistory):
    pass


@pytest.mark.usefixtures("_telemetry_conf")
class TestSLORulesOnThePort(ref_tel.TestSLORules):
    def test_default_conf_rule_set_parses(self):
        rules = t_slo.parse_rules(
            str(t_conf.global_conf().get(t_conf.SLO_RULES)))
        by_name = {r.name: r for r in rules}
        assert {"serve_freshness", "predict_p99", "staleness_ms",
                "updates_floor"} <= set(by_name)
        assert by_name["updates_floor"].unless_series == "ps.done"


@pytest.mark.usefixtures("_telemetry_conf")
class TestSLOStateMachineOnThePort(ref_tel.TestSLOStateMachine):
    pass


@pytest.mark.usefixtures("_telemetry_conf")
class TestFreshnessLagSignalOnThePort(ref_tel.TestFreshnessLagSignal):
    pass


@pytest.mark.usefixtures("_telemetry_conf")
class TestPromExpositionOnThePort(ref_tel.TestPromExposition):
    def test_render_passes_strict_parser_with_labels(self):
        """The reference case (its serving counters and gauges included),
        and the pipeline family beside them."""
        super().test_render_passes_strict_parser_with_labels()
        t_ps._pl_fold({"prefetch_hits": 4})
        parsed = t_prom.parse_exposition(
            t_prom.render({"role": "test", "run_id": "rid1"}))
        assert any(name.startswith("async_pipeline_") and
                   name.endswith("_total") for (name, _l) in parsed)
        assert any(name.startswith("async_serving_") and
                   not name.endswith("_total") for (name, _l) in parsed)


#: providers outside the port's registry, with the reason (the reference's
#: exemptions, on the port's modules)
AUDIT_EXEMPT = {
    ("asyncframework_tpu_torch.metrics.registry", "all_totals"),
    ("asyncframework_tpu_torch.net.retry", "retry_totals"),
}


@pytest.mark.usefixtures("_telemetry_conf")
class TestRegistryAuditOnThePort(ref_tel.TestRegistryAudit):
    def test_every_totals_provider_is_registered_or_exempt(self):
        """The reference's audit over the port's package: every public
        module-level ``*_totals`` provider is a registered family or an
        exemption."""
        import importlib
        import pkgutil

        import asyncframework_tpu_torch

        registered = {id(f._resolve(f.totals_attr))
                      for f in t_registry.families().values()}
        exempt = {id(getattr(importlib.import_module(m), a))
                  for m, a in AUDIT_EXEMPT}
        strays = []
        for info in pkgutil.walk_packages(
                asyncframework_tpu_torch.__path__,
                prefix="asyncframework_tpu_torch."):
            mod = importlib.import_module(info.name)
            for attr in dir(mod):
                if (attr.startswith("_") or attr.startswith("reset")
                        or not attr.endswith("_totals")):
                    continue
                fn = getattr(mod, attr)
                if callable(fn) and id(fn) not in registered | exempt:
                    strays.append((info.name, attr))
        assert not strays, strays


@pytest.mark.usefixtures("_telemetry_conf")
class TestSamplerOnThePort(ref_tel.TestSampler):
    pass


@pytest.mark.usefixtures("_telemetry_conf")
class TestTelemetryEndpointsOnThePort(ref_tel.TestTelemetryEndpoints):
    pass


@pytest.mark.usefixtures("_telemetry_conf")
class TestAsyncTopOnThePort(ref_tel.TestAsyncTop):
    pass


# -------------------------------------- tests/test_profiler.py on the port
@pytest.mark.usefixtures("_profiler_conf")
class TestZoneTableOnThePort(ref_prof.TestZoneTable):
    @pytest.mark.parametrize("filename,func,zone", [
        ("/x/asyncframework_tpu_torch/net/wiredelta.py", "crc", "wire.crc"),
        ("/x/asyncframework_tpu_torch/net/wiredelta.py", "encode",
         "wire.xor"),
        ("/x/asyncframework_tpu_torch/net/wirecodec.py", "encode_grad",
         "wire.quantize"),
        ("/x/asyncframework_tpu_torch/net/wirecodec.py",
         "compress_model_part", "wire.compress"),
        ("/x/asyncframework_tpu_torch/net/frame.py", "recv_exact",
         "wire.decode"),
        ("/x/asyncframework_tpu_torch/net/frame.py", "_send_frame",
         "wire.encode"),
        ("/x/asyncframework_tpu_torch/parallel/ps_dcn.py",
         "_drain_merge_locked", "merge.drain"),
        ("/usr/lib/python3.11/json/encoder.py", "iterencode", "serde"),
        # the port's rows: its kernel wrappers and torch itself
        ("/x/asyncframework_tpu_torch/ops/masked_grad.py", "masked_grad",
         "kernel.dispatch"),
        ("/x/asyncframework_tpu_torch/ops/sparse_grad.py", "compacted_grad",
         "kernel.dispatch"),
        ("/x/asyncframework_tpu_torch/ops/chunk_attention.py",
         "chunk_attention", "kernel.dispatch"),
        ("/site-packages/torch/_tensor.py", "__sub__", "kernel.dispatch"),
        # the JAX package's rows claim nothing here
        ("/site-packages/jax/_src/api.py", "cache_miss", "gil.other"),
        ("/x/asyncframework_tpu/net/frame.py", "_send_frame", "gil.other"),
    ])
    def test_classify_single_frame_stacks(self, filename, func, zone):
        assert t_profiler.classify_stack([(filename, func)]) == zone

    def test_innermost_claimed_frame_wins(self):
        stack = [
            ("/x/asyncframework_tpu_torch/net/wiredelta.py", "crc"),
            ("/x/asyncframework_tpu_torch/net/wiredelta.py", "decode"),
            ("/x/asyncframework_tpu_torch/parallel/ps_dcn.py",
             "_handle_pull"),
        ]
        assert t_profiler.classify_stack(stack) == "wire.crc"
        stack2 = [("/x/myapp/helper.py", "pack"),
                  ("/x/asyncframework_tpu_torch/net/frame.py", "_send_frame")]
        assert t_profiler.classify_stack(stack2) == "wire.encode"


@pytest.mark.usefixtures("_profiler_conf")
class TestOffPathOnThePort(ref_prof.TestOffPath):
    pass


@pytest.mark.usefixtures("_profiler_conf")
class TestExactCollectorsOnThePort(ref_prof.TestExactCollectors):
    pass


@pytest.mark.usefixtures("_profiler_conf")
class TestProfilerSamplerOnThePort(ref_prof.TestSampler):
    pass


@pytest.mark.usefixtures("_profiler_conf")
class TestStatusAndFlightOnThePort(ref_prof.TestStatusAndFlight):
    pass


@pytest.mark.usefixtures("_profiler_conf")
class TestProfilerCLIOnThePort(ref_prof.TestCLI):
    # drives bench.py's profile block: the port's benchmark is ROADMAP A2's
    test_bench_profile_block_never_dark_and_xcheck = None


# -------------------------------------- tests/test_observer.py on the port
@pytest.mark.usefixtures("_observer_conf")
class TestParseEndpointsOnThePort(ref_obs.TestParseEndpoints):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestStragglerScoresOnThePort(ref_obs.TestStragglerScores):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestDefaultFleetRulesOnThePort(ref_obs.TestDefaultFleetRules):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestRunHistoryStoreOnThePort(ref_obs.TestRunHistoryStore):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestFlightRecorderOnThePort(ref_obs.TestFlightRecorder):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestStatusSectionsOnThePort(ref_obs.TestStatusSections):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestDiscoveryOnThePort(ref_obs.TestDiscovery):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestRenderFleetOnThePort(ref_obs.TestRenderFleet):
    pass


@pytest.mark.usefixtures("_observer_conf")
class TestCollectorInProcessOnThePort(ref_obs.TestCollectorInProcess):
    pass


# ----------------------- tests/test_telemetry.py's acceptance runs, ported
@pytest.mark.usefixtures("_telemetry_conf")
class TestAcceptanceOnThePort(ref_tel.TestAcceptance):
    """The JAX package's PS child process trained by the port's workers in
    this process, with the port's replica and frontend processes (their
    ``/metrics`` parsed strictly); the serve-freshness SLO across a
    SIGKILL of a port replica process behind the port's frontend."""


# ------------------------------------------------------ across the packages
def test_registry_families_are_the_jax_packages_in_order():
    port = list(t_registry.families())
    jax_fams = list(j_registry.families())
    assert set(port) | set(t_registry.UNPORTED_FAMILIES) == set(jax_fams)
    assert not set(port) & set(t_registry.UNPORTED_FAMILIES)
    assert [f for f in jax_fams if f not in t_registry.UNPORTED_FAMILIES] \
        == port
    # the shuffle family came with data/spill.py: no family is left out
    assert dict(t_registry.UNPORTED_FAMILIES) == {}
    assert port == jax_fams
    assert {"serving", "relay", "shuffle"} <= set(port)
    assert t_registry.DYNAMIC_SERIES_FAMILIES \
        == j_registry.DYNAMIC_SERIES_FAMILIES


def test_each_packages_exposition_passes_the_others_parser():
    for ps_mod in (t_ps, j_ps):
        ps_mod._pl_fold({"prefetch_hits": 3, "inflight_max": 2})
    t_ts.convergence().add(10.0, 1, loss=0.5, grad_norm=2.0)
    j_ts.convergence().add(10.0, 1, loss=0.5, grad_norm=2.0)
    try:
        port_body = t_prom.render({"role": "ps", "run_id": "r"})
        jax_body = j_prom.render({"role": "ps", "run_id": "r"})
        assert j_prom.parse_exposition(port_body)
        assert t_prom.parse_exposition(jax_body)
        port_names = {n for (n, _l) in t_prom.parse_exposition(port_body)}
        jax_names = {n for (n, _l) in j_prom.parse_exposition(jax_body)}
        # the port's metrics are the JAX package's, less the unported
        # families'
        assert port_names <= jax_names
        unported = [n for n in jax_names - port_names
                    if not any(n.startswith(f"async_{f}_")
                               for f in t_registry.UNPORTED_FAMILIES)]
        assert unported == [], unported
    finally:
        j_reset_totals()


def test_fold_trajectory_gives_equal_convergence_in_both_packages():
    rs = np.random.default_rng(3)
    traj = [(float(t), float(v)) for t, v in
            zip(np.cumsum(rs.uniform(5, 50, size=300)),
                np.exp(-np.linspace(0, 4, 300)) + 0.01 * rs.random(300))]
    traj[7] = (traj[7][0], float("nan"))  # a diverged sample is dropped
    j_ts.reset_convergence()
    t_ts.fold_trajectory(traj)
    j_ts.fold_trajectory(traj)
    try:
        assert t_ts.convergence().summary() == j_ts.convergence().summary()
        assert t_ts.convergence().curves() == j_ts.convergence().curves()
        assert t_ts.convergence().curves(max_points=40) \
            == j_ts.convergence().curves(max_points=40)
    finally:
        j_ts.reset_convergence()


#: snapshot fields that read the wall clock or the process
WALL_CLOCK = ("elapsed_s", "updates_per_sec", "run_id")
#: the JAX package's sections of subsystems the port does not have yet
#: (none since the shuffle section came with data/spill.py)
UNPORTED_SECTIONS = set()


def _event_log(tmp_path):
    """A port ASGD ``run()`` on the CPU with an event log and tracing."""
    rs = np.random.default_rng(0)
    X = rs.normal(size=(2_048, 16)).astype(np.float32)
    y = (X @ rs.normal(size=16)).astype(np.float32)
    path = str(tmp_path / "run.jsonl")
    cfg = SolverConfig(num_workers=4, num_iterations=120, gamma=0.5,
                       batch_rate=0.3, printer_freq=20, seed=1,
                       event_log=path, trace_sample=0.5)
    res = ASGD(X, y, cfg, devices=[CPU]).run()
    return path, res


def _replayed(live_mod, reader_cls, path, nw):
    state = live_mod.LiveStateListener(nw)
    for ev in reader_cls(path).replay():
        state.on_event(ev)
    return state.snapshot()


def _drop(snap):
    out = {k: v for k, v in snap.items()
           if k not in WALL_CLOCK and k not in UNPORTED_SECTIONS}
    return json.loads(json.dumps(out))


def test_live_state_from_one_event_log_is_equal_in_both_packages(tmp_path):
    path, res = _event_log(tmp_path)
    t_reset_totals()
    j_reset_totals()
    try:
        port = _replayed(t_live, t_eventlog.EventLogReader, path, 4)
        jax_snap = _replayed(j_live, j_eventlog.EventLogReader, path, 4)
        assert port["accepted"] == res.accepted == jax_snap["accepted"]
        assert port["trace"]["spans"] > 0
        # the sections: the JAX package's, less the unported subsystems'
        assert set(port) == set(jax_snap) - UNPORTED_SECTIONS
        assert "shuffle" in port
        assert _drop(port) == _drop(jax_snap)
    finally:
        j_reset_totals()


def test_process_status_sections_are_the_jax_packages():
    port = t_live.process_status("worker")
    jax_status = j_live.process_status("worker")
    assert set(port) == set(jax_status)
    assert set(port["counters"]) == (set(jax_status["counters"])
                                     - set(t_registry.UNPORTED_FAMILIES))


def test_flight_dumps_cross_the_packages(tmp_path):
    rec = t_flightrec.FlightRecorder("port", str(tmp_path / "p"),
                                     capacity=8, flush_s=0.0)
    rec.note("push", wid=1, n=3)
    data = j_flightrec.load_dump(rec.dump("manual"))
    assert data["role"] == "port" and data["events"][-1]["n"] == 3
    jrec = j_flightrec.FlightRecorder("jax", str(tmp_path / "j"),
                                      capacity=8, flush_s=0.0)
    jrec.note("push", wid=2, n=5)
    data = t_flightrec.load_dump(jrec.dump("manual"))
    assert data["role"] == "jax" and data["events"][-1]["n"] == 5


@pytest.mark.parametrize("direction", ["port_scrapes_jax", "jax_scrapes_port"])
def test_each_observer_scrapes_the_other_packages_endpoint(direction):
    j_conf.set_global_conf(j_conf.AsyncConf().set("async.metrics.interval.s",
                                                  0))
    t_conf.set_global_conf(t_conf.AsyncConf().set("async.metrics.interval.s",
                                                  0))
    t_ps._pl_fold({"prefetch_hits": 7})
    server_live, obs_mod = ((j_live, t_observer)
                            if direction == "port_scrapes_jax"
                            else (t_live, j_observer))
    srv = server_live.LiveUIServer(None, port=0, role="ps").start()
    try:
        obs = obs_mod.ClusterObserver(
            targets=[obs_mod.RoleTarget("ps", "ps",
                                        f"http://127.0.0.1:{srv.port}")],
            interval_s=0.0, history_dir="")
        res = obs.scrape_once()
        assert res["ps"]["ok"] is True
        snap = obs.fleet_snapshot()
        assert snap["roles"]["ps"]["up"]
        assert snap["derived"]["roles_up"] == 1.0
    finally:
        srv.stop()
        j_ts.stop_sampler()
        j_conf.set_global_conf(None)
        j_reset_totals()


# -------------------------------------------- convergence on the wire
N, D, NW = 4_096, 24, 8


def _data():
    rs = np.random.default_rng(11)
    X = rs.normal(size=(N, D)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = (X @ rs.normal(size=D).astype(np.float32)
         + 0.01 * rs.normal(size=N)).astype(np.float32)
    return X, y


def _kw(**over):
    kw = dict(num_workers=NW, num_iterations=160, gamma=1.2, taw=2**31 - 1,
              batch_rate=0.3, bucket_ratio=0.5, printer_freq=40, seed=42,
              calibration_iters=20, run_timeout_s=120.0)
    kw.update(over)
    return kw


def _exactly_once(ps, counts, iterations):
    pushes = sum(ps.pushes_by_wid.values())
    assert ps.accepted == iterations
    assert pushes == sum(counts.values())
    assert pushes == ps.accepted + ps.dropped + ps.membership_rejects
    assert ps.dedup_hits == 0


@pytest.mark.parametrize("direction", ["jax_workers_port_ps",
                                       "port_workers_jax_ps"])
def test_convergence_samples_cross_the_wire(direction):
    """Workers of one package with ``async.convergence.sample=4`` against
    the other's PS: the PS's convergence history holds every sample (a
    sample every 4th update of each logical worker), and every push is
    delivered once."""
    import jax

    X, y = _data()
    j_conf.set_global_conf(j_conf.AsyncConf().set("async.convergence.sample",
                                                  4))
    t_conf.set_global_conf(t_conf.AsyncConf().set("async.convergence.sample",
                                                  4))
    t_ts.convergence().reset()
    j_ts.convergence().reset()
    try:
        if direction == "jax_workers_port_ps":
            ps = t_ps.ParameterServer(SolverConfig(**_kw()), D, N,
                                      device=CPU, port=0).start()
            ds = JDataset(X, y, NW, devices=jax.devices("cpu")[:1])
            run_worker, cfg, conv = (j_ps.run_worker_process,
                                     JConfig(**_kw()), t_ts.convergence())
        else:
            ps = j_ps.ParameterServer(JConfig(**_kw()), D, N,
                                      device=jax.devices("cpu")[0],
                                      port=0).start()
            ds = TDataset(X, y, NW, devices=[CPU])
            run_worker, cfg, conv = (t_ps.run_worker_process,
                                     SolverConfig(**_kw()),
                                     j_ts.convergence())
        counts = run_worker("127.0.0.1", ps.port, list(range(NW)),
                            {w: ds.shard(w) for w in range(NW)}, cfg, D, N,
                            eval_wid=None, deadline_s=120.0)
        assert ps.wait_done(timeout_s=30.0)
        ps.stop()
        _exactly_once(ps, counts, 160)
        samples = sum(c // 4 for c in counts.values())
        summary = conv.summary()
        assert summary["offered"] == summary["samples"] == samples > 0
        assert summary["best_loss"] < summary["first_loss"]
        assert conv.curves()["staleness"]  # stamped with the PS's clock
    finally:
        j_ts.stop_sampler()  # the JAX PS started its sampler thread
        j_conf.set_global_conf(None)
        t_ts.convergence().reset()
        j_ts.convergence().reset()


def test_sampling_off_keeps_the_wire_byte_identical():
    """With ``async.convergence.sample`` at 0 a push header carries no
    ``cv`` entry: the same push encodes to the same bytes as a client
    built without a buffer."""
    t_conf.set_global_conf(t_conf.AsyncConf())
    ps = t_ps.ParameterServer(SolverConfig(**_kw()), D, N, device=CPU,
                              port=0).start()
    try:
        g = np.arange(D, dtype=np.float32)
        plain = t_ps.PSClient("127.0.0.1", ps.port)
        buffered = t_ps.PSClient("127.0.0.1", ps.port,
                                 cv_buf=t_ts.ConvergenceBuffer())
        h0, p0, *_ = plain._encode_push(0, 3, g, False, None, None)
        h1, p1, *_ = buffered._encode_push(0, 3, g, False, None, None)
        assert "cv" not in h1 and h0 == h1 and p0 == p1
        buffered.cv_buf.add(3, 0.5, 1.0)
        h2, _p2, *_rest = buffered._encode_push(0, 3, g, False, None, None)
        assert h2["cv"] == [[3, 0.5, 1.0]]
        plain.bye()
        buffered.bye()
    finally:
        ps.stop()


# ---------------------------------------------------------- the port's own
def test_wrap_dispatch_leaves_the_step_factories_unwrapped_when_off():
    assert t_profiler.active() is None
    apply = t_steps.make_asgd_apply(1.0, 0.1, 100, 2)
    assert not hasattr(apply, "__wrapped__")
    step = t_steps.make_asgd_worker_step(0.3)
    assert not hasattr(step.grad, "__wrapped__")

    def fn(x):
        return x
    assert t_profiler.wrap_dispatch(fn, "kernel.dispatch", "s") is fn


def test_memory_gauges_never_create_a_cuda_context():
    mem = t_profiler.memory_gauges()
    assert mem["host_rss_bytes"] > 0
    if not torch.cuda.is_initialized():
        assert "device_bytes_in_use" not in mem
    assert torch.cuda.is_initialized() is False or torch.cuda.is_available()


def test_profiled_steps_count_compile_then_dispatch():
    t_profiler.install("t-steps", hz=0)
    rs = np.random.default_rng(0)
    X = torch.tensor(rs.normal(size=(64, 8)), dtype=torch.float32)
    y = torch.tensor(rs.normal(size=64), dtype=torch.float32)
    step = t_steps.make_asgd_worker_step(0.7)
    gen = torch.Generator().manual_seed(1)
    w = torch.zeros(8)
    for _ in range(3):
        step(X, y, w, gen)
    step.grad(X, y, w, *step.sample(gen, 64))
    labels = t_profiler.active().snapshot()["dispatch"]["labels"]
    assert labels["asgd_worker_step"] == {"compile": 1, "dispatch": 3}


def test_asgd_run_serves_the_live_ui_and_passes_the_telemetry_gates(tmp_path):
    """``chip_smoke.py``'s telemetry phase on the CPU at a small size: two
    runs, telemetry off then on, each gated (``tools/telemetry.py``)."""
    from asyncframework_tpu_torch.tools import telemetry

    ds = TDataset.generate_on_device(4_096, 24, 8, [CPU], seed=7, noise=0.01)
    base = dict(num_workers=8, gamma=1.2, taw=2**31 - 1, batch_rate=0.3,
                bucket_ratio=0.5, printer_freq=50, seed=42)
    off = telemetry.asgd_run(ds, CPU, base, 1_200, False,
                             str(tmp_path / "f0"))
    on = telemetry.asgd_run(ds, CPU, base, 1_200, True,
                            str(tmp_path / "f1"))
    assert off["ok"], off["gates"]
    assert on["ok"], on["gates"]
    assert on["ui_port"] > 0 and on["gets"] > 0
    assert on["queue_depth_every_100"]
    zones = {row[0] for row in on["profile"]["zones"]}
    assert "kernel.dispatch" in zones
    assert t_profiler.active() is None and not t_live.active_servers()


@pytest.mark.parametrize("solver", ["asgd", "asaga"])
@pytest.mark.parametrize("mode", ["run", "run_sync"])
def test_ui_port_serves_every_entry_with_a_listener(solver, mode):
    """``ui_port=0`` on ASGD and ASAGA ``run()`` and ``run_sync()``: the
    run serves its dashboard on an ephemeral port, reported in the
    extras, every endpoint answers, and the server stops at the end."""
    from asyncframework_tpu_torch.solvers import ASAGA
    from asyncframework_tpu_torch.tools import telemetry

    rs = np.random.default_rng(2)
    X = rs.normal(size=(1_024, 12)).astype(np.float32)
    y = (X @ rs.normal(size=12)).astype(np.float32)
    cfg = SolverConfig(num_workers=4, num_iterations=40, gamma=0.3,
                       batch_rate=0.5, printer_freq=10, seed=3, ui_port=0)
    cls = ASGD if solver == "asgd" else ASAGA
    with telemetry.Poller(period_s=0.05) as poller:
        res = getattr(cls(X, y, cfg, devices=[CPU]), mode)()
    assert res.extras["ui_port"] > 0
    assert (res.rounds if mode == "run_sync" else res.accepted) == 40
    # the last status, taken once the bus drained, rides the extras
    status = res.extras["ui_status"]
    assert status["accepted"] == res.accepted
    assert all(c == 200 for _p, c in poller.answers)
    assert not poller.parse_errors
    assert not t_live.active_servers()

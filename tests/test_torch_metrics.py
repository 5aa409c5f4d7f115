"""The port's run sinks against the JAX package's, on the CPU.

``metrics/{bus,eventlog,system,trace,report}.py`` are copied into the port
(it may not import the JAX package).  Each unit scenario of
``tests/test_metrics.py`` and ``tests/test_trace.py`` that needs no
``net``/``ps_dcn`` runs here on both packages (parametrized ``pkg``), so a
copy that drifts fails beside its original.  Then the sinks as the
solvers drive them: an event log, CSV/JSONL metrics and lifecycle spans
from real port runs (dense and padded-ELL), and event logs crossing
between the packages in both directions -- the same events serialize to
the same bytes, and each package reads and renders the other's log.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from asyncframework_tpu.data import make_regression

PKGS = ["asyncframework_tpu", "asyncframework_tpu_torch"]
CPU = [torch.device("cpu")]


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def recorder(bus_mod):
    class Recorder(bus_mod.Listener):
        def __init__(self):
            self.events = []
            self.merges = []

        def on_event(self, event):
            self.events.append(event)

        def on_gradient_merged(self, event):
            self.merges.append(event)
            self.events.append(event)

    return Recorder()


# ----------------------------------------------------------------- the bus
@pytest.mark.parametrize("pkg", PKGS)
def test_bus_sync_delivery_and_typed_hooks(pkg):
    b = mod(pkg, "metrics.bus")
    bus = b.ListenerBus()
    rec = recorder(b)
    bus.add_listener(rec)
    bus.post(b.JobStart(time_ms=1.0, job_id=0, worker_ids=(0, 1)))
    bus.post(b.GradientMerged(time_ms=2.0, worker_id=1, staleness=3,
                              accepted=True, iteration=7))
    assert len(rec.events) == 2
    assert len(rec.merges) == 1 and rec.merges[0].staleness == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_bus_async_dispatch_and_stop(pkg):
    b = mod(pkg, "metrics.bus")
    bus = b.ListenerBus()
    rec = recorder(b)
    bus.add_listener(rec)
    bus.start()
    for i in range(100):
        bus.post(b.TaskEnd(time_ms=float(i), job_id=0, worker_id=i % 4,
                           attempt=0, run_ms=1.0, succeeded=True))
    bus.stop()
    assert len(rec.events) == 100 and bus.dropped_events == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_bus_drops_when_full_without_blocking(pkg):
    b = mod(pkg, "metrics.bus")
    bus = b.ListenerBus(capacity=4)
    release = threading.Event()

    class Slow(b.Listener):
        def on_event(self, event):
            release.wait(timeout=5.0)

    bus.add_listener(Slow())
    bus.start()
    for i in range(50):
        bus.post(b.JobEnd(time_ms=float(i), job_id=i, succeeded=True))
    assert bus.dropped_events > 0
    release.set()
    bus.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_listener_does_not_kill_bus(pkg):
    b = mod(pkg, "metrics.bus")
    bus = b.ListenerBus()

    class Bad(b.Listener):
        def on_event(self, event):
            raise RuntimeError("boom")

    rec = recorder(b)
    bus.add_listener(Bad())
    bus.add_listener(rec)
    bus.post(b.JobEnd(time_ms=0.0, job_id=1, succeeded=True))
    assert len(rec.events) == 1


# -------------------------------------------------------------- event log
def _events(b):
    return [
        b.RoundSubmitted(time_ms=1.0, round_idx=0, cohort=(0, 1, 2),
                         model_version=1),
        b.GradientMerged(time_ms=2.0, worker_id=0, staleness=0,
                         accepted=True, iteration=1, batch_size=64),
        b.GradientMerged(time_ms=3.0, worker_id=1, staleness=5,
                         accepted=False, iteration=1, batch_size=64),
        b.TaskEnd(time_ms=4.0, job_id=0, worker_id=2, attempt=0,
                  run_ms=12.5, succeeded=True),
        b.WorkerLost(time_ms=5.0, worker_id=3, reason="heartbeat timeout"),
        b.ShardMoved(time_ms=5.5, shard_id=3, new_owner=4, device="cpu"),
        b.SpeculativeLaunch(time_ms=5.7, job_id=9, worker_id=2),
        b.TraceSpan(time_ms=5.9, stage="compute", trace_id="t" * 16,
                    span_id="s1", parent_id=None, worker_id=2,
                    model_version=3, start_ms=1.0, dur_ms=2.5,
                    staleness=None, staleness_ms=None, accepted=None),
        b.ModelSnapshot(time_ms=6.0, iteration=1, objective=0.5),
    ]


@pytest.mark.parametrize("pkg", PKGS)
def test_eventlog_roundtrip(pkg, tmp_path):
    b, el = mod(pkg, "metrics.bus"), mod(pkg, "metrics.eventlog")
    log = tmp_path / "run" / "events.jsonl"
    writer = el.EventLogWriter(log)
    bus = b.ListenerBus()
    bus.add_listener(writer)
    events = _events(b)
    for ev in events:
        bus.post(ev)
    writer.close()
    assert list(el.EventLogReader(log).replay()) == events


@pytest.mark.parametrize("pkg", PKGS)
def test_eventlog_gzip_roundtrip_and_crash_without_close(pkg, tmp_path):
    import gzip

    b, el = mod(pkg, "metrics.bus"), mod(pkg, "metrics.eventlog")
    log = tmp_path / "events.jsonl.gz"
    writer = el.EventLogWriter(log)
    events = [b.ModelSnapshot(time_ms=float(i), iteration=i,
                              objective=1.0 / (i + 1)) for i in range(50)]
    for ev in events:
        writer.on_event(ev)
    # before close (a crashed writer): every flushed event replays
    assert list(el.EventLogReader(log).replay()) == events
    writer.close()
    with gzip.open(log) as f:
        assert len(f.read().splitlines()) == 50
    assert list(el.EventLogReader(log).replay()) == events


@pytest.mark.parametrize("pkg", PKGS)
def test_eventlog_summary(pkg, tmp_path):
    b, el = mod(pkg, "metrics.bus"), mod(pkg, "metrics.eventlog")
    log = tmp_path / "events.jsonl"
    writer = el.EventLogWriter(log)
    writer.on_event(b.RoundSubmitted(time_ms=0.0, round_idx=0, cohort=(0, 1),
                                     model_version=1))
    for i in range(10):
        writer.on_event(b.GradientMerged(
            time_ms=float(i), worker_id=i % 2, staleness=i % 4,
            accepted=(i % 4) <= 2, iteration=i))
    writer.on_event(b.ModelSnapshot(time_ms=10.0, iteration=10,
                                    objective=0.25))
    writer.close()
    s = el.EventLogReader(log).summary()
    assert (s["rounds"], s["merges"], s["accepted"], s["dropped_stale"]) == (
        1, 10, 8, 2)
    assert s["staleness"]["max"] == 3
    assert s["trajectory"] == [(10.0, 0.25)]


@pytest.mark.parametrize("pkg", PKGS)
def test_eventlog_skips_unknown_corrupt_and_torn(pkg, tmp_path):
    b, el = mod(pkg, "metrics.bus"), mod(pkg, "metrics.eventlog")
    log = tmp_path / "events.jsonl"
    log.write_text(
        '{"event":"JobEnd","time_ms":1.0,"job_id":0,"succeeded":true}\n'
        '{"event":"FutureEventType","time_ms":2.0,"x":1}\n'
        '{"event":"JobEnd","time_ms":3.0,"bad_field":true}\n'
        "\n"
        '{"event":"JobEnd","time_ms":4.0,"job_id":1,"succeeded":false}\n'
    )
    assert [e.job_id for e in el.EventLogReader(log).replay()] == [0, 1]
    torn = tmp_path / "torn.jsonl"
    wr = el.EventLogWriter(torn)
    for i in range(5):
        wr.on_event(b.GradientMerged(time_ms=float(i), worker_id=i % 2,
                                     staleness=i, accepted=True, iteration=i))
    wr.close()
    data = torn.read_bytes()
    torn.write_bytes(data[: len(data) - 20])  # cut inside the last record
    reader = el.EventLogReader(torn)
    assert len(list(reader.replay(strict=False))) == 4
    assert reader.truncated_records == 1
    with pytest.raises(json.JSONDecodeError):
        list(el.EventLogReader(torn).replay(strict=True))
    assert el.EventLogReader(torn).summary()["truncated_records"] == 1


# --------------------------------------------------------- metrics system
@pytest.mark.parametrize("pkg", PKGS)
def test_metrics_registry_collect_and_isolated_errors(pkg):
    sm = mod(pkg, "metrics.system")
    ms = sm.MetricsSystem()
    c = ms.counter("updates.accepted")
    g = ms.gauge("queue.depth")
    h = ms.histogram("staleness")
    c.inc(5)
    g.set(3.0)
    for v in range(100):
        h.update(float(v % 10))
    ms.register_source("engine", lambda: {"workers": 8})

    def bad():
        raise ValueError("nope")

    ms.register_source("bad", bad)
    out = ms.collect()
    assert out["updates.accepted"] == 5 and out["queue.depth"] == 3.0
    assert out["staleness"]["count"] == 100 and out["staleness"]["max"] == 9.0
    assert out["engine"] == {"workers": 8}
    assert "error" in str(out["bad"])
    assert ms.counter("updates.accepted") is c
    with pytest.raises(TypeError):
        ms.gauge("updates.accepted")


@pytest.mark.parametrize("pkg", PKGS)
def test_sinks_csv_jsonl(pkg, tmp_path):
    sm = mod(pkg, "metrics.system")
    ms = sm.MetricsSystem()
    ms.counter("a").inc(1)
    ms.gauge("b.c").set(2.5)
    ms.add_sink(sm.CsvSink(tmp_path / "m.csv"))
    ms.add_sink(sm.JsonlSink(tmp_path / "m.jsonl"))
    ms.report()
    ms.counter("a").inc(1)
    ms.report()
    ms.stop()
    lines = (tmp_path / "m.csv").read_text().strip().splitlines()
    assert lines[0].startswith("time_ms") and "a" in lines[0]
    assert len(lines) == 3
    recs = [json.loads(x) for x in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[0]["a"] == 1 and recs[1]["a"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_polling_loop_with_manual_clock(pkg):
    sm = mod(pkg, "metrics.system")
    clock = mod(pkg, "utils.clock").ManualClock()
    ms = sm.MetricsSystem(clock=clock)
    ms.counter("ticks").inc()
    seen = []

    class Capture:
        def report(self, t, values):
            seen.append((t, dict(values)))

        def close(self):
            pass

    ms.add_sink(Capture())
    ms.start(period_s=1.0)
    for _ in range(3):
        time.sleep(0.05)
        clock.advance(1000.0)
    deadline = time.monotonic() + 5
    while len(seen) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    ms.stop()
    assert len(seen) >= 3


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_nearest_rank_percentiles(pkg):
    H = mod(pkg, "metrics.system").Histogram
    h = H()
    for v in range(1, 21):
        h.update(float(v))
    snap = h.snapshot()
    assert (snap["p50"], snap["p95"], snap["p99"], snap["max"]) == (
        10.0, 19.0, 20.0, 20.0)
    one = H()
    one.update(7.0)
    assert one.snapshot()["p50"] == one.snapshot()["p99"] == 7.0
    assert H._pct([1.0, 2.0, 3.0, 4.0], 0.5) == 2.0
    assert H._pct([1.0, 2.0, 3.0, 4.0], 0.75) == 3.0
    assert H._pct([1.0, 2.0, 3.0, 4.0], 0.76) == 4.0


# ------------------------------------------------------------------ trace
@pytest.mark.parametrize("pkg", PKGS)
def test_trace_sampling_ring_and_requeue(pkg):
    trace = mod(pkg, "metrics.trace")
    off = trace.TraceRecorder(sample_rate=0.0, capacity=16)
    assert not off.enabled and off.start_update(0) is None
    rec = trace.TraceRecorder(sample_rate=0.25, capacity=64)
    hits = [rec.start_update(0) is not None for _ in range(8)]
    assert hits == [True, False, False, False, True, False, False, False]
    assert rec.start_update(7) is not None
    ring = trace.TraceRecorder(sample_rate=1.0, capacity=4)
    for _ in range(10):
        ring.start_update(0).add(trace.COMPUTE, 0.0, 1.0)
    assert ring.dropped_spans == 6
    drained = ring.drain_wire()
    assert len(drained) == 4 and ring.drain_wire() == []
    ring.requeue(drained)
    assert ring.drain_wire() == drained


def test_trace_recorder_defaults_are_the_jax_packages():
    """The port has no conf registry: its recorder's defaults are the JAX
    package's conf defaults."""
    from asyncframework_tpu.metrics.trace import TraceRecorder as JaxRec
    from asyncframework_tpu_torch.metrics.trace import TraceRecorder

    a, b = JaxRec(), TraceRecorder()
    assert (a.sample_rate, a.capacity, a.interval) == (
        b.sample_rate, b.capacity, b.interval)


@pytest.mark.parametrize("pkg", PKGS)
def test_run_instruments_emit_lifecycle_spans_and_reset(pkg, tmp_path):
    inst_mod = mod(pkg, "solvers.instrumentation")
    trace = mod(pkg, "metrics.trace")
    cfg = mod(pkg, "solvers").SolverConfig(
        num_workers=2, trace_sample=1.0, event_log=str(tmp_path / "sp.jsonl"))
    mod(pkg, "metrics").reset_totals()
    inst = inst_mod.RunInstruments(cfg, 2)
    inst.on_gradient_merged(0, staleness=2, accepted=True, iteration=7,
                            task_ms=3.0, queue_ms=1.0, apply_ms=0.5)
    inst.close()
    spans, _ = trace.load_trace_events(tmp_path / "sp.jsonl")
    assert {s.stage for s in spans} == {trace.COMPUTE, trace.MERGE_QUEUE,
                                        trace.MERGE_APPLY}
    (apply_span,) = [s for s in spans if s.stage == trace.MERGE_APPLY]
    assert apply_span.staleness == 2 and apply_span.accepted is True
    assert apply_span.staleness_ms == pytest.approx(4.0)
    assert apply_span.model_version == 7
    assert len({s.trace_id for s in spans}) == 1
    assert trace.aggregator().spans_total == 3
    mod(pkg, "metrics").reset_totals()
    assert trace.aggregator().spans_total == 0


def test_live_ui_serves_on_an_ephemeral_port_and_close_frees_it():
    """``ui_port=0`` serves the live UI on an ephemeral port, reported in
    the extras; ``close()`` stops the server and frees the port.  A
    negative port is off, as in the JAX package."""
    import socket
    import urllib.request

    from asyncframework_tpu_torch.solvers import SolverConfig
    from asyncframework_tpu_torch.solvers.instrumentation import RunInstruments

    inst = RunInstruments(SolverConfig(ui_port=0), 2)
    port = inst.extras()["ui_port"]
    assert port > 0
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/status",
                                timeout=5) as r:
        assert r.status == 200
        assert json.loads(r.read())["accepted"] == 0
    inst.close()
    with socket.socket() as s:  # no listener holds the port any more
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
    off = RunInstruments(SolverConfig(ui_port=-1), 2)
    assert "ui_port" not in off.extras()
    off.close()


# ------------------------------------------- event logs across the packages
def test_the_same_events_serialize_to_the_same_bytes(tmp_path):
    """Every event type's dataclass fields serialize identically, so a
    log's lines do not say which package wrote them."""
    jb = mod("asyncframework_tpu", "metrics.bus")
    pb = mod("asyncframework_tpu_torch", "metrics.bus")
    assert sorted(jb.EVENT_TYPES) == sorted(pb.EVENT_TYPES)
    for pkg, b in (("asyncframework_tpu", jb), ("asyncframework_tpu_torch", pb)):
        wr = mod(pkg, "metrics.eventlog").EventLogWriter(tmp_path / f"{pkg}.jsonl")
        for ev in _events(b):
            wr.on_event(ev)
        wr.close()
    assert (tmp_path / "asyncframework_tpu.jsonl").read_bytes() == (
        tmp_path / "asyncframework_tpu_torch.jsonl").read_bytes()


def _run_cfg(pkg, **kw):
    base = dict(num_workers=8, num_iterations=120, gamma=0.5,
                batch_rate=0.3, bucket_ratio=0.5, printer_freq=40, seed=42,
                calibration_iters=10, run_timeout_s=120.0,
                metrics_period_s=0.2)
    base.update(kw)
    return mod(pkg, "solvers").SolverConfig(**base)


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_regression(2048, 32, seed=3)
    return X, y


@pytest.mark.parametrize("writer", PKGS)
def test_event_log_crosses_between_the_packages(writer, problem, tmp_path,
                                                devices8):
    """A run's event log written by one package is read, summarized and
    rendered by the other's ``EventLogReader`` and ``render_report``."""
    X, y = problem
    log = tmp_path / "run.jsonl"
    cfg = _run_cfg(writer, event_log=str(log), trace_sample=0.25)
    kw = dict(devices=CPU) if writer.endswith("torch") else dict(
        devices=devices8)
    res = mod(writer, "solvers").ASGD(X, y, cfg, **kw).run()
    assert res.accepted == 120
    for reader in PKGS:
        s = mod(reader, "metrics.eventlog").EventLogReader(log).summary()
        assert s["accepted"] == 120 and s["rounds"] > 0
        assert len(s["trajectory"]) == len(res.trajectory)
        spans, torn = mod(reader, "metrics.trace").load_trace_events(log)
        assert torn == 0 and {sp.stage for sp in spans} == {
            "compute", "merge.queue", "merge.apply"}
        html = mod(reader, "metrics.report").render_report(
            log, tmp_path / f"{reader}.html")
        assert "Summary" in html and "Staleness" in html


# ------------------------------------------------- the sinks of port runs
def test_asgd_run_emits_event_log_and_metrics(problem, tmp_path):
    """``tests/test_wiring.py::TestEventLogWiring`` on the port."""
    from asyncframework_tpu_torch.metrics import EventLogReader, render_report
    from asyncframework_tpu_torch.solvers import ASGD

    X, y = problem
    log, csv, jl = (tmp_path / "run.jsonl", tmp_path / "m.csv",
                    tmp_path / "m.jsonl")
    cfg = _run_cfg("asyncframework_tpu_torch", num_iterations=200,
                   event_log=str(log), metrics_csv=str(csv),
                   metrics_jsonl=str(jl))
    res = ASGD(X, y, cfg, devices=CPU).run()
    assert res.accepted == 200
    summary = EventLogReader(log).summary()
    assert summary["rounds"] > 0 and summary["merges"] >= 200
    assert summary["accepted"] == 200
    assert len(summary["trajectory"]) == len(res.trajectory)
    lines = csv.read_text().strip().splitlines()
    assert len(lines) >= 2 and "updates.accepted" in lines[0]
    last = json.loads(jl.read_text().strip().splitlines()[-1])
    assert last["updates.accepted"] == 200
    assert last["staleness"]["count"] == summary["merges"]
    # the event log's largest merge staleness is the largest among the
    # merges the run applied, as the run's own metrics recorded them
    # (``res.max_staleness`` is the workers' last reported staleness,
    # which no merge may have carried)
    assert summary["staleness"]["max"] == last["staleness"]["max"]
    html = render_report(log, tmp_path / "report.html")
    assert "Summary" in html and (tmp_path / "report.html").exists()


def test_asaga_run_emits_gzip_event_log(problem, tmp_path):
    from asyncframework_tpu_torch.metrics import EventLogReader
    from asyncframework_tpu_torch.solvers import ASAGA

    X, y = problem
    log = tmp_path / "saga.jsonl.gz"
    cfg = _run_cfg("asyncframework_tpu_torch", num_iterations=100,
                   gamma=0.05, event_log=str(log))
    res = ASAGA(X, y, cfg, devices=CPU).run()
    assert res.accepted == 100
    summary = EventLogReader(log).summary()
    assert summary["accepted"] == 100 and summary["rounds"] > 0


def test_asgd_run_traced_end_to_end(problem, tmp_path):
    from asyncframework_tpu_torch.metrics import trace
    from asyncframework_tpu_torch.solvers import ASGD

    X, y = problem
    log = tmp_path / "asgd.jsonl"
    cfg = _run_cfg("asyncframework_tpu_torch", num_workers=4,
                   num_iterations=40, event_log=str(log), trace_sample=1.0,
                   heartbeat=False)
    res = ASGD(X, y, cfg, devices=CPU).run()
    assert res.accepted == 40
    spans, _ = trace.load_trace_events(log)
    applies = [s for s in spans if s.stage == trace.MERGE_APPLY]
    assert {trace.COMPUTE, trace.MERGE_QUEUE} <= {s.stage for s in spans}
    assert len(applies) >= 40
    assert all(s.staleness is not None and s.staleness_ms is not None
               for s in applies)


def _run_with_kills(X, y, cfg, kills):
    """An async ASGD run on the port with executor 3 killed ``kills``
    times mid-run (``tests/test_wiring.py``'s fault-tolerance scenario)."""
    from asyncframework_tpu_torch.solvers import ASGD

    solver = ASGD(X, y, cfg, devices=CPU)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("res", solver.run()))
    t.start()
    try:
        deadline = time.monotonic() + 30
        while not hasattr(solver, "scheduler") and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hasattr(solver, "scheduler"), "run never started"
        pool = solver.scheduler.pool
        for _ in range(kills):
            time.sleep(0.1)  # let some rounds flow
            # kill it mid-task: an idle dead executor is replaced by the
            # scheduler at its next submit, before any heartbeat scan
            ex = pool.executors[3]
            while not ex.busy and t.is_alive():
                time.sleep(0.0005)
            ex.kill()
            # the next kill waits for the heartbeat's replacement
            while pool.executors[3] is ex and t.is_alive():
                time.sleep(0.01)
    finally:
        t.join(timeout=120)
    assert not t.is_alive(), "run did not finish"
    return out["res"]


@pytest.mark.parametrize("kills", [1, 2], ids=["replaced", "rehomed"])
def test_executor_deaths_reach_the_event_log(kills, problem, tmp_path):
    """A killed executor is replaced mid-run (and, killed twice, its shard
    re-homed); the run completes and converges, and the event log holds
    each ``WorkerLost`` (and the ``ShardMoved``)."""
    from asyncframework_tpu_torch.metrics import EventLogReader
    from asyncframework_tpu_torch.metrics.bus import ShardMoved

    X, y = problem
    log = tmp_path / "kill.jsonl"
    iters = 1200 if kills == 1 else 3000
    cfg = _run_cfg("asyncframework_tpu_torch", num_iterations=iters,
                   event_log=str(log), heartbeat_timeout_ms=200.0,
                   heartbeat_interval_s=0.05,
                   max_slot_failures=99 if kills == 1 else 2)
    res = _run_with_kills(X, y, cfg, kills)
    assert res.accepted == iters
    assert res.extras.get("workers_lost", 0) >= kills
    summary = EventLogReader(log).summary()
    assert 3 in summary["workers_lost"]
    assert res.trajectory[-1][1] < res.trajectory[0][1]
    if kills == 2:
        assert res.extras.get("shards_moved", 0) >= 1
        moves = [e for e in EventLogReader(log).replay()
                 if isinstance(e, ShardMoved)]
        assert [e.shard_id for e in moves] == [3] * len(moves)

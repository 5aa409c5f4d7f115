"""The telemetry plane on a run: the live UI, the profiler, the flight
recorder and the DCN plane's convergence samples, with their gates.

``chip_smoke.py``'s telemetry phase runs both functions on the card at full
width; both take any device, so they rehearse on the CPU at a small size.

- :func:`asgd_telemetry`: ASGD ``run()`` four times on one deployment,
  telemetry off, on, on, off.  "On" is the process's telemetry started from
  the conf (``metrics/live.py::start_telemetry_from_conf("driver")`` with
  the profiler on, a flight-dump directory and the sampler at 0.25 s),
  ``ui_port=0`` and a poller thread that GETs ``/api/status``, ``/metrics``,
  ``/api/timeseries`` and ``/`` every 0.5 s while the run's server is up;
  the run's last status, taken when its bus has drained, is in its
  result's ``extras["ui_status"]``.  Gates: every GET answered 200; every
  ``/metrics`` body passed the strict parser; the last status holds the
  result's ``accepted`` and a staleness histogram that sums to its merges;
  the profile shows ``asgd_worker_step`` compiled once with compiles plus
  dispatches equal to the B1 launches of the run (on the CPU: its tasks
  and warm-ups); on a CUDA device, ``device_bytes_in_use`` grown by at
  least the resident shards since before the dataset was made; a flight
  dump exists after the recorder is uninstalled; and the objective below
  1/10 of its value at w = 0 in every run.
- :func:`dcn_ab` (``python3 -m asyncframework_tpu_torch.tools.telemetry``):
  the DCN run's telemetry switches apart, in turns in one call -- rcv1
  ASGD (1,200 updates) with nothing on, with convergence samples alone,
  with the per-process endpoints alone, and with both -- the order
  reversed every other round; one JSON line a run.
- :func:`dcn_telemetry`: one multi-process DCN run (``tools/dcn.py``) with
  ``async.convergence.sample`` and ``async.metrics.port=0`` in every
  process.  Gates: those of ``tools/dcn.py``; each worker process's
  ``ell_residual`` launches equal its convergence samples plus its
  evaluation's (one a snapshot a served shard), with no plain call; the
  samples each worker process counted where it took them are one every
  ``conv_every``-th update of each logical worker; the PS's convergence
  history holds every sample the workers took; its best
  sampled loss below 0.1x and its last below 0.3x the objective at w = 0
  (the JAX package's bands, ``tests/test_sparse.py:214-219``); and every
  process's ``/metrics`` answered 200 and parsed.
"""

from __future__ import annotations

import argparse
import json
import sys
import os
import threading
import urllib.request
from typing import List, Optional

import numpy as np

from asyncframework_tpu_torch.conf import AsyncConf, global_conf
from asyncframework_tpu_torch.conf import set_global_conf
from asyncframework_tpu_torch.metrics import flightrec, live, profiler, prom
from asyncframework_tpu_torch.metrics import reset_totals, timeseries
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.tools import runs

#: the poller's period and the sampler's interval while telemetry is on
POLL_S = 0.5
SAMPLE_S = 0.25
#: the endpoints the poller reads (``/``: the HTML page)
ENDPOINTS = ("/api/status", "/metrics", "/api/timeseries", "/")


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


class Poller:
    """GETs the run's live UI every ``period_s`` while one serves (the
    first server in ``live.active_servers()`` with a run listener).  Every
    answer is kept as ``(path, status)``; a ``/metrics`` body that the
    strict parser refuses is kept in ``parse_errors``.  A GET that fails
    because the run stopped its server meanwhile (the server has left
    ``live.active_servers()`` by the time the failure is seen) ends that
    round of reads and is counted in ``after_stop``; any other failure is
    kept as an answer.  The run's last status is its result's
    ``extras["ui_status"]``."""

    def __init__(self, period_s: float = POLL_S):
        self.period_s = period_s
        self.answers: List[tuple] = []
        self.parse_errors: List[str] = []
        self.after_stop = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _read(self, srv) -> None:
        for path in ENDPOINTS:
            try:
                status, body = _get(srv.port, path)
            except Exception as e:  # noqa: BLE001 - kept as a failed GET
                if srv not in live.active_servers():
                    self.after_stop += 1
                    return
                self.answers.append((path, f"{type(e).__name__}: {e}"))
                continue
            self.answers.append((path, status))
            if path == "/metrics":
                try:
                    prom.parse_exposition(body)
                except ValueError as e:
                    self.parse_errors.append(str(e))
            elif path.startswith("/api/"):
                json.loads(body)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            for srv in live.active_servers():
                if srv.state is not None:
                    self._read(srv)
                    break

    def __enter__(self) -> "Poller":
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-poller", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def queue_over_time(dump: dict, every: int) -> List[list]:
    """The ``queue.depth`` series at every ``every`` accepted updates:
    ``[k, depth]`` at the first sampler tick whose ``queue.accepted`` is
    at least k (the two series are sampled at the same ticks)."""
    depth = dump.get("queue.depth") or []
    accepted = dump.get("queue.accepted") or []
    out, k = [], every
    for (_t, acc), (_t2, dep) in zip(accepted, depth):
        while acc >= k:
            out.append([k, dep])
            k += every
    return out


def resident_bytes(ds) -> int:
    return sum(t.numel() * t.element_size()
               for w in range(ds.num_workers)
               for t in (ds.shard(w).X, ds.shard(w).y))


def device_bytes_in_use() -> int:
    """The allocator's live bytes on the current device, as the profiler
    reads them (0 before CUDA is up)."""
    return int(profiler.memory_gauges().get("device_bytes_in_use", 0))


def asgd_run(ds, device, base: dict, updates: int, on: bool,
             flight_dir: str, bytes_before: Optional[int] = None) -> dict:
    """One ASGD ``run()`` with telemetry ``on`` or off; its record, with
    the gates of an "on" run under ``gates``.  ``bytes_before``: the
    device's :func:`device_bytes_in_use` before ``ds`` was made; on a CUDA
    device the profile's reading must exceed it by ``ds``'s shards."""
    before = global_conf()
    conf = AsyncConf()
    set_global_conf(conf)
    poller = srv = None
    try:
        reset_totals()
        if on:
            conf.set("async.prof.enabled", 1)
            conf.set("async.flight.dir", flight_dir)
            conf.set("async.metrics.interval.s", SAMPLE_S)
            # the flight recorder and the profiler; an endpoint only where
            # the environment sets async.metrics.port
            srv = live.start_telemetry_from_conf("driver")
        cfg = SolverConfig(num_iterations=updates,
                           ui_port=0 if on else None, **base)
        runs.zero_counts()
        solver = ASGD(ds, None, cfg, devices=[device])
        if on:
            with Poller() as poller:
                res = solver.run()
        else:
            res = solver.run()
        launches = runs.counts()
        tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
        rec = {
            "telemetry": "on" if on else "off", "accepted": res.accepted,
            "dropped": res.dropped, "updates_per_sec": res.updates_per_sec,
            "elapsed_s": res.elapsed_s, "max_staleness": res.max_staleness,
            "objective_at_w0": res.trajectory[0][1],
            "final_objective": res.final_objective,
            "finite": bool(np.isfinite(res.final_w).all()),
            "tasks_run": tasks, "launches": launches,
            "ui_port": res.extras.get("ui_port"),
        }
        gates = {"budget": res.accepted == updates,
                 "finite": rec["finite"],
                 "below_0.1x": rec["final_objective"]
                 < rec["objective_at_w0"] / 10}
        if on:
            snap = profiler.uninstall()
            flightrec.uninstall(final_dump=True)
            timeseries.stop_sampler()
            rec.update(_on_record(poller, snap, flight_dir, res, launches,
                                  ds, device, tasks, bytes_before))
            gates.update(rec.pop("gates"))
        rec["gates"] = gates
        rec["ok"] = all(gates.values())
        return rec
    finally:
        if srv is not None:
            srv.stop()
        profiler.uninstall()
        flightrec.uninstall()
        timeseries.stop_sampler()
        set_global_conf(before)


def _on_record(poller: Poller, snap: dict, flight_dir: str, res, launches,
               ds, device, res_tasks: int,
               bytes_before: Optional[int]) -> dict:
    warmups = len({tuple(ds.shard(w).X.shape) for w in range(ds.num_workers)})
    status = res.extras.get("ui_status") or {}
    hist = status.get("staleness") or {}
    merges = status.get("accepted", -1) + status.get("dropped", 0)
    label = ((snap or {}).get("dispatch", {}).get("labels", {})
             .get("asgd_worker_step", {}))
    mem = (snap or {}).get("memory", {})
    # the sampler's rings as /api/timeseries serves them; the run's
    # ``queue`` source left the sampler when the run closed
    dump = timeseries.store().dump()
    depth = [v for _t, v in dump.get("queue.depth") or []]
    codes = [code for _p, code in poller.answers]
    rec = {
        "gets": len(codes),
        "gets_after_stop": poller.after_stop,
        "gets_by_path": {p: sum(1 for q, _c in poller.answers if q == p)
                         for p in ENDPOINTS},
        "final_status_accepted": status.get("accepted"),
        "staleness_hist": hist,
        "profile": {
            "samples": (snap or {}).get("samples"),
            "compile": (snap or {}).get("compile"),
            "dispatch_count": (snap or {}).get("dispatch", {}).get("count"),
            "labels": (snap or {}).get("dispatch", {}).get("labels"),
            "zones": [list(r) for r in profiler.zone_table(snap or {})],
            "memory": mem,
        },
        "flight_dumps": [os.path.basename(p)
                         for p in flightrec.scan_dumps(flight_dir)],
        "queue_depth_max": max(depth) if depth else None,
        "queue_depth_samples": len(depth),
        "queue_depth_every_100": queue_over_time(dump, 100),
        "resident_bytes": resident_bytes(ds),
        "device_bytes_before": bytes_before,
    }
    gates = {
        "all_gets_200": bool(codes) and all(c == 200 for c in codes),
        "every_endpoint_read": all(rec["gets_by_path"][p] > 0
                                   for p in ENDPOINTS),
        "metrics_parse": not poller.parse_errors,
        "status_accepted": status.get("accepted") == res.accepted,
        "staleness_hist_sums_to_merges":
            sum(hist.values()) == merges == res.accepted + res.dropped,
        "worker_step_compiled_once": label.get("compile") == 1,
        # each call is one B1 launch on the card; on the CPU each is a
        # task or a warm-up (one a distinct shard shape)
        "worker_step_calls_are_tasks":
            label.get("compile", 0) + label.get("dispatch", 0)
            == (launches["masked_grad"] if device.type == "cuda"
                else res_tasks + warmups) > 0,
        "flight_dump": bool(rec["flight_dumps"]),
        "queue_series": bool(depth),
    }
    if device.type == "cuda":
        # the reading is process-wide: what it gained since before the
        # dataset was made must hold the resident shards
        gates["device_bytes_in_use"] = (
            bytes_before is not None
            and mem.get("device_bytes_in_use", 0) - bytes_before
            >= rec["resident_bytes"])
    rec["gates"] = gates
    return rec


def asgd_telemetry(ds, device, base: dict, updates: int, dirpath: str,
                   bytes_before: Optional[int] = None) -> List[dict]:
    """ASGD ``run()`` with telemetry off, on, on, off (``base``: the
    solver's settings besides the budget; ``bytes_before`` as in
    :func:`asgd_run`); one record a run."""
    recs = []
    for i, on in enumerate((False, True, True, False)):
        flight_dir = os.path.join(dirpath, f"flight{i}")
        rec = asgd_run(ds, device, base, updates, on, flight_dir,
                       bytes_before)
        rec["order"] = i
        recs.append(rec)
    return recs


def dcn_telemetry(config: str, algo: str, iters: int, conv_every: int,
                  device: str = "cuda", nprocs: int = 2) -> dict:
    """One PS process and ``nprocs`` worker processes with convergence
    samples every ``conv_every`` updates of each logical worker and a
    telemetry endpoint in every process; the record of ``tools/dcn.py``
    with the telemetry gates added."""
    from asyncframework_tpu_torch.tools import dcn

    env = {"ASYNCTPU_ASYNC_CONVERGENCE_SAMPLE": str(conv_every),
           "ASYNCTPU_ASYNC_METRICS_PORT": "0"}
    ps, workers = dcn.launch(config, algo, iters, device=device,
                             nprocs=nprocs, env=env)
    rec = dcn.summarize(config, algo, iters, ps, workers)
    snapshots = len(ps["trajectory"] or [])
    samples = [w["conv_samples"] for w in workers]
    conv = ps["convergence"]
    obj0 = rec["objective_at_w0"]
    rec.update({
        "conv_sample": conv_every,
        "conv_samples": samples,
        "ps_convergence": conv,
        "samples_per_accepted_update": conv.get("offered", 0)
        / max(ps["accepted"], 1),
        "ell_residual_launches": [w["launches"]["ell_residual"]
                                  for w in workers],
        "telemetry": {"ps": ps["telemetry"],
                      "workers": [w["telemetry"] for w in workers]},
    })
    gates = rec["gates"]
    gates["one_residual_launch_a_sample"] = all(
        w["launches"]["ell_residual"]
        == w["conv_samples"] + snapshots * len(w["wids"])
        and not w["launches"]["ell_residual_plain"] for w in workers)
    gates["a_sample_every_nth_update"] = all(
        w["conv_samples"] == sum(c // conv_every for c in w["counts"].values())
        for w in workers)
    gates["ps_holds_every_sample"] = (conv.get("offered") == sum(samples)
                                      == conv.get("samples") > 0)
    gates["sampled_best_below_0.1x"] = (
        obj0 is not None and conv.get("best_loss", np.inf) < 0.1 * obj0)
    gates["sampled_last_below_0.3x"] = (
        obj0 is not None and conv.get("last_loss", np.inf) < 0.3 * obj0)
    gates["metrics_endpoints"] = all(
        t is not None and t["metrics_status"] == 200
        and t["metrics_samples"] > 0 and t["status_status"] == 200
        for t in [ps["telemetry"], *[w["telemetry"] for w in workers]])
    rec["ok"] = all(gates.values())
    return rec


#: the switches of :func:`dcn_ab`'s arms, as environment of every process
DCN_ARMS = {
    "off": {},
    "sample": {"ASYNCTPU_ASYNC_CONVERGENCE_SAMPLE": "10"},
    "endpoints": {"ASYNCTPU_ASYNC_METRICS_PORT": "0"},
    "sample+endpoints": {"ASYNCTPU_ASYNC_CONVERGENCE_SAMPLE": "10",
                         "ASYNCTPU_ASYNC_METRICS_PORT": "0"},
}


def dcn_ab(arms, rounds: int, config: str = "rcv1", iters: int = 1_200,
           device: str = "cuda"):
    """Each arm of :data:`DCN_ARMS` once a round, the order reversed every
    other round; yields one record a run (the ``tools/dcn.py`` record's
    throughput, wire and gate fields)."""
    from asyncframework_tpu_torch.tools import dcn

    for r in range(rounds):
        for arm in (arms if r % 2 == 0 else arms[::-1]):
            ps, workers = dcn.launch(config, "asgd", iters, device=device,
                                     env=DCN_ARMS[arm])
            rec = dcn.summarize(config, "asgd", iters, ps, workers)
            yield {
                "arm": arm, "round": r, "config": config,
                "updates_per_sec": rec["updates_per_sec"],
                "elapsed_s": rec["elapsed_s"],
                "tasks_per_accepted_update": rec["tasks_per_accepted_update"],
                "wire_bytes_per_update": rec["wire_bytes_per_update"],
                "max_staleness": rec["max_staleness"],
                "conv_samples": [w["conv_samples"] for w in workers],
                "ps_samples": ps["convergence"].get("offered"),
                "worker_launches": rec["worker_launches"],
                "ok": rec["ok"],
            }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=dcn_ab.__doc__.split(";")[0])
    ap.add_argument("--arms", default=",".join(DCN_ARMS),
                    help="comma-separated arms of DCN_ARMS")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("telemetry: no CUDA device", file=sys.stderr)
        return 2
    from asyncframework_tpu_torch.ops import _build
    from asyncframework_tpu_torch.tools import dcn

    _build.build_all()  # once, before the processes that load them start
    dcn.build_natives()
    ok = True
    for rec in dcn_ab(args.arms.split(","), args.rounds):
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""How often the solvers pass ``chip_smoke.py``'s convergence gates.

    python3 -m asyncframework_tpu_torch.tools.asgd_gate \
        [--runs N] [--routes staged,tiled] [--entry run|run_fused]
    python3 -m asyncframework_tpu_torch.tools.asgd_gate --config rcv1 \
        [--runs N] [--saga-gamma G] [--drain-batch M] [--entry run|run_fused]
    python3 -m asyncframework_tpu_torch.tools.asgd_gate --config file \
        [--runs N] [--shape N,D] [--gammas G,...] [--on cuda,cpu]

``--config epsilon`` (the default) generates ``chip_smoke.py``'s phase-3
deployment once on the card (epsilon, 400,000 x 2,000 f32, 8 workers,
b = 0.1, gamma 100, no staleness bound, noise 0.01, seed 7), then runs
``ASGD.run()`` to 1,000 accepted
updates ``--runs`` times for each route of the masked-gradient kernel, the
routes in turns (pinned with ``ops.masked_grad.pinned_route``).  Prints one
JSON line a run (its final objective, the least objective of its
trajectory and at which point, the trajectory, updates/s, the largest
staleness as the run counts it and the staleness at apply (updates
between the version a task read and the update its result became), the
worker tasks it ran, the launches on each route) and one line a route:
the finals' min, median and max, and how many runs ended at or above the
gate (1/10 of the objective at w = 0, as phase 3 asks).

``--config rcv1`` generates the rcv1 deployment once on the card
(``tools/rcv1.py``: 697,641 x 47,236 padded ELL, 8 workers) and runs
``chip_smoke.py``'s sparse phase ``--runs`` times: ASGD ``run()`` (1,200
updates, its updater draining up to ``--drain-batch`` results a wake,
default ``tools.rcv1.DRAIN_BATCH``) and ``run_sync()``, ASAGA ``run()``
and ``run_sync()`` at ``--saga-gamma`` (default ``tools.rcv1.SAGA_GAMMA``).  One JSON line a
solver run (its gates, trajectory, updates/s, tasks per accepted update,
kernel S1's launches, the staleness at apply) and one summary line: each
gate's pass count over the runs.

``--config file`` makes the rows of ``chip_smoke.py``'s LibSVM-file arm
(:func:`file_arrays`, ``--shape``, default 2,048 x 2,000) and runs, on
each device of ``--on`` (the card and the CPU, one dataset each), for each
gamma of ``--gammas`` and seed 42 + run: ``ASGD.run()`` to 1,000 updates
with one result a wake (the reference's loop; on the card once on each
route of the masked-gradient kernel, pinned), ``run()`` draining up to
``--drain-batch`` results a wake, and ``run_sync()`` for 125 rounds (1,000
tasks).  One JSON line a run, as ``--config epsilon``'s plus the mean
staleness at apply and the tasks a wake the updater drained.

``--entry run_fused`` runs the fused loop in place of the engine: on
epsilon ``ASGD.run_fused()`` (the same 1,000-update budget and gate), on
rcv1 ``tools/rcv1.py::fused_phase`` (ASGD and ASAGA ``run_fused()``).  Its
staleness is at most ``num_workers - 1`` by construction, so no staleness
at apply is recorded.

Every line carries the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
from collections import defaultdict, deque

import numpy as np
import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.solvers import asaga as asaga_module
from asyncframework_tpu_torch.solvers import asgd as asgd_module
from asyncframework_tpu_torch.solvers.instrumentation import RunInstruments
from asyncframework_tpu_torch.tools import rcv1


class ApplyStaleness(RunInstruments):
    """The run's hooks, recording for each accepted result the updates
    applied between the model version its task read and the update it
    became (its staleness at apply).  The run's own staleness is taken
    when the worker finishes, on the results clock, and misses the results
    that wait in the queue for the updater.  Every instance is kept in
    ``made``, one a run, in the order of the runs."""

    made: list = []

    def __init__(self, cfg, num_workers):
        super().__init__(cfg, num_workers)
        self.versions = defaultdict(deque)  # worker -> versions, oldest first
        self.at_apply = []
        ApplyStaleness.made.append(self)

    def on_round_submitted(self, round_idx, cohort, model_version):
        for wid in cohort:
            self.versions[wid].append(model_version)

    def on_gradient_merged(self, worker_id, staleness, accepted, iteration,
                           **timings):
        queue = self.versions[worker_id]
        version = queue.popleft() if queue else None
        if accepted and version is not None:
            self.at_apply.append(iteration - version)


@contextlib.contextmanager
def apply_staleness():
    """ASGD and ASAGA runs inside the block use :class:`ApplyStaleness`
    hooks."""
    before = RunInstruments
    ApplyStaleness.made.clear()
    for module in (asgd_module, asaga_module):
        module.RunInstruments = ApplyStaleness
    try:
        yield
    finally:
        for module in (asgd_module, asaga_module):
            module.RunInstruments = before


def quantiles(xs):
    xs = sorted(xs)
    return {"p50": xs[len(xs) // 2], "p90": xs[len(xs) * 9 // 10],
            "max": xs[-1], "mean": sum(xs) / len(xs)} if xs else None


def file_arrays(n: int, d: int, seed: int = 15):
    """``chip_smoke.py``'s LibSVM-file rows: ``X`` N(0, 1/d) f32, a N(0, 1)
    model and 0.01 noise, from numpy's generator at ``seed``."""
    rs = np.random.default_rng(seed)
    X = rs.standard_normal((n, d), dtype=np.float32) / np.float32(
        np.sqrt(d))
    w = rs.standard_normal(d).astype(np.float32)
    y = (X @ w + 0.01 * rs.standard_normal(n).astype(np.float32)).astype(
        np.float32)
    return X, y


def file_gates(runs: int, shape, gammas, drain_batch: int, card: str,
               devices) -> None:
    """``--config file``: the file arm's recipe (8 workers, b = 0.1, no
    staleness bound, bucket ratio 0.7) on each device, as the module's
    docstring says."""
    X, y = file_arrays(*shape)
    for dev in devices:
        ds = ShardedDataset(X, y, 8, [dev])
        variants = [("run", r, 1) for r in (
            ("tiled", "staged") if dev.type == "cuda" else (None,))]
        variants += [("run", None, drain_batch), ("run_sync", None, 1)]
        for k in range(runs):
            for gamma in gammas:
                for entry, route, drain in variants:
                    sync = entry == "run_sync"
                    cfg = SolverConfig(
                        num_workers=8, num_iterations=125 if sync else 1000,
                        gamma=gamma, taw=2**31 - 1, batch_rate=0.1,
                        bucket_ratio=0.7, printer_freq=5 if sync else 25,
                        seed=42 + k, drain_batch=drain)
                    before = (mg.masked_grad.launches_staged,
                              mg.masked_grad.launches_tiled)
                    solver = ASGD(ds, None, cfg, devices=[dev])
                    pin = (mg.pinned_route(route) if route is not None
                           else contextlib.nullcontext())
                    with pin, apply_staleness():
                        r = getattr(solver, entry)()
                    at_apply = ApplyStaleness.made[-1].at_apply
                    tasks = sum(m.succeeded
                                for m in solver.scheduler.pool.all_metrics())
                    objs = [obj for _, obj in r.trajectory]
                    print(json.dumps({
                        "phase": "file", "card": card, "device": str(dev),
                        "shape": list(shape), "gamma": gamma, "seed": 42 + k,
                        "entry": entry, "route": route, "drain_batch": drain,
                        "final_x": r.final_objective / objs[0],
                        "min_x": min(objs) / objs[0],
                        "objective_at_w0": objs[0],
                        "updates_per_sec": r.updates_per_sec,
                        "max_staleness": r.max_staleness,
                        "accepted": r.accepted, "tasks_run": tasks,
                        "staleness_at_apply": quantiles(at_apply),
                        "staleness_at_apply_first_100": quantiles(
                            at_apply[:100]),
                        "staleness_at_apply_last_100": quantiles(
                            at_apply[-100:]),
                        "launches_staged":
                            mg.masked_grad.launches_staged - before[0],
                        "launches_tiled":
                            mg.masked_grad.launches_tiled - before[1],
                        "trajectory_x": [round(o / objs[0], 4)
                                         for o in objs],
                    }), flush=True)


def rcv1_gates(runs: int, saga_gamma: float, drain_batch: int, card: str,
               dev, entry: str = "run") -> None:
    """``--config rcv1``: the sparse phase (``entry`` ``run``) or its
    fused runs (``run_fused``) ``runs`` times on one dataset."""
    ds = rcv1.dataset(dev)
    print(json.dumps({"phase": "dataset", "card": card, **rcv1.describe(ds)}),
          flush=True)
    passes = defaultdict(int)
    for k in range(runs):
        with apply_staleness():
            records = (rcv1.fused_phase(ds, dev, saga_gamma)
                       if entry == "run_fused"
                       else rcv1.phase(ds, dev, saga_gamma, drain_batch))
        hooks = ApplyStaleness.made if entry == "run" else [None] * len(records)
        for rec, hook in zip(records, hooks):
            at_apply = hook.at_apply if hook is not None else []
            rec.update({
                "phase": "run", "card": card, "run": k,
                "staleness_at_apply": quantiles(at_apply),
                "staleness_at_apply_first_100": quantiles(at_apply[:100]),
                "staleness_at_apply_last_100": quantiles(at_apply[-100:]),
            })
            print(json.dumps(rec), flush=True)
            for gate, ok in rec["gates"].items():
                passes[f"{rec['solver']}.{rec['mode']}.{gate}"] += int(ok)
    print(json.dumps({"phase": "summary", "card": card, "runs": runs,
                      "entry": entry, "saga_gamma": saga_gamma,
                      "drain_batch": drain_batch, "passes": dict(passes)}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("epsilon", "rcv1", "file"),
                    default="epsilon")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--routes", default="staged,tiled")
    ap.add_argument("--saga-gamma", type=float, default=rcv1.SAGA_GAMMA)
    ap.add_argument("--drain-batch", type=int, default=rcv1.DRAIN_BATCH)
    ap.add_argument("--entry", choices=("run", "run_fused"), default="run")
    ap.add_argument("--shape", default="2048,2000")
    ap.add_argument("--gammas", default="100,50,25")
    ap.add_argument("--on", default="cuda,cpu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("asgd_gate: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.config == "file":
        file_gates(args.runs, tuple(int(v) for v in args.shape.split(",")),
                   [float(g) for g in args.gammas.split(",")],
                   args.drain_batch, card,
                   [torch.device(v, 0) if v == "cuda" else torch.device(v)
                    for v in args.on.split(",")])
        return
    if args.config == "rcv1":
        rcv1_gates(args.runs, args.saga_gamma, args.drain_batch, card, dev,
                   args.entry)
        return
    routes = args.routes.split(",")
    ds = ShardedDataset.generate_on_device(400_000, 2_000, 8, [dev], seed=7,
                                           noise=0.01)
    cfg = SolverConfig(num_workers=8, num_iterations=1000, gamma=100.0,
                       taw=2**31 - 1, batch_rate=0.1, bucket_ratio=0.7,
                       printer_freq=25, seed=42)
    finals = {route: [] for route in routes}
    gate = None
    for k in range(args.runs):
        for route in routes:
            before = mg.masked_grad.launches_staged, mg.masked_grad.launches_tiled
            solver = ASGD(ds, None, cfg, devices=[dev])
            with mg.pinned_route(route), apply_staleness():
                r = getattr(solver, args.entry)()
            fused = args.entry == "run_fused"
            at_apply = [] if fused else ApplyStaleness.made[-1].at_apply
            tasks = (r.accepted if fused else sum(
                m.succeeded for m in solver.scheduler.pool.all_metrics()))
            objs = [obj for _, obj in r.trajectory]
            gate = objs[0] / 10
            low = min(range(len(objs)), key=objs.__getitem__)
            finals[route].append(r.final_objective)
            print(json.dumps({
                "phase": "run", "card": card, "route": route, "run": k,
                "entry": args.entry,
                "final": r.final_objective, "objective_at_w0": objs[0],
                "min": objs[low], "min_at_point": low,
                "points": len(objs), "over_gate": r.final_objective >= gate,
                "updates_per_sec": r.updates_per_sec,
                "max_staleness": r.max_staleness, "accepted": r.accepted,
                "dropped": r.dropped, "tasks_run": tasks,
                "staleness_at_apply": quantiles(at_apply),
                "staleness_at_apply_first_100": quantiles(at_apply[:100]),
                "staleness_at_apply_last_100": quantiles(at_apply[-100:]),
                "launches_staged": mg.masked_grad.launches_staged - before[0],
                "launches_tiled": mg.masked_grad.launches_tiled - before[1],
                "trajectory": [round(o, 4) for o in objs],
            }), flush=True)
    for route, fs in finals.items():
        print(json.dumps({
            "phase": "summary", "card": card, "route": route,
            "runs": len(fs), "gate": gate, "final_min": min(fs),
            "final_median": statistics.median(fs), "final_max": max(fs),
            "over_gate": sum(f >= gate for f in fs),
        }), flush=True)


if __name__ == "__main__":
    main()

"""How often ASGD ``run()`` passes ``chip_smoke.py``'s convergence gate.

    python3 -m asyncframework_tpu_torch.tools.asgd_gate \
        [--runs N] [--routes staged,tiled]

Generates ``chip_smoke.py``'s phase-3 deployment once on the card
(epsilon, 400,000 x 2,000 f32, 8 workers, b = 0.1, gamma 100, no staleness
bound, noise 0.01, seed 7), then runs ``ASGD.run()`` to 1,000 accepted
updates ``--runs`` times for each route of the masked-gradient kernel, the
routes in turns (pinned with ``ops.masked_grad.pinned_route``).  Prints one
JSON line a run (its final objective, the least objective of its
trajectory and at which point, the trajectory, updates/s, the largest
staleness as the run counts it and the staleness at apply (updates
between the version a task read and the update its result became), the
worker tasks it ran, the launches on each route) and one line a route: the
finals'
min, median and max, and how many runs ended at or above the gate (1/10 of
the objective at w = 0, as phase 3 asks).  Every line carries the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
from collections import defaultdict, deque

import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.solvers import asgd as asgd_module
from asyncframework_tpu_torch.solvers.instrumentation import RunInstruments


class ApplyStaleness(RunInstruments):
    """The run's hooks, recording for each accepted result the updates
    applied between the model version its task read and the update it
    became (its staleness at apply).  The run's own staleness is taken
    when the worker finishes, on the results clock, and misses the results
    that wait in the queue for the updater."""

    last = None

    def __init__(self, cfg, num_workers):
        super().__init__(cfg, num_workers)
        self.versions = defaultdict(deque)  # worker -> versions, oldest first
        self.at_apply = []
        ApplyStaleness.last = self

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
    """ASGD runs inside the block use :class:`ApplyStaleness` hooks."""
    before, asgd_module.RunInstruments = asgd_module.RunInstruments, ApplyStaleness
    try:
        yield
    finally:
        asgd_module.RunInstruments = before


def quantiles(xs):
    xs = sorted(xs)
    return {"p50": xs[len(xs) // 2], "p90": xs[len(xs) * 9 // 10],
            "max": xs[-1]} if xs else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--routes", default="staged,tiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("asgd_gate: no CUDA device")
    routes = args.routes.split(",")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
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
                r = solver.run()
            at_apply = ApplyStaleness.last.at_apply
            tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
            objs = [obj for _, obj in r.trajectory]
            gate = objs[0] / 10
            low = min(range(len(objs)), key=objs.__getitem__)
            finals[route].append(r.final_objective)
            print(json.dumps({
                "phase": "run", "card": card, "route": route, "run": k,
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

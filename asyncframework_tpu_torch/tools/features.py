"""Every ``run()`` switch at once on a deployment, and what each one leaves.

The switches of ``SolverConfig`` that ``run()`` takes beyond the bare loop:
checkpoint and resume, speculation, dynamic allocation, the event log,
CSV/JSONL metrics and lifecycle tracing.  ``chip_smoke.py``'s features
phase runs :func:`asgd_features` on the epsilon deployment and
:func:`asaga_resume` on rcv1's, on the card; both take any device, so
they rehearse on the CPU at a small size.

- :func:`asgd_features`: ASGD ``run()`` with every switch off, the same
  run with every switch on (stragglers injected, ``coeff > 0``, so the
  speculation monitor has copies to launch), then a second ``run()`` to
  twice the budget that resumes from the checkpoint.  Each run's kernel
  launches are set to 0 just before it and read just after
  (``tools/runs.py``).
- :func:`asaga_resume`: ASAGA ``run()`` with checkpoints, a run at the same
  budget that restores and changes nothing (its history table and
  ``alpha_bar`` read back bit-equal to the checkpoint's), then a run to
  twice the budget from the checkpoint.
- :func:`sinks_report`: each sink file's bytes, parsed with the port's
  readers (``EventLogReader``, ``render_report``; ``csv``, ``json``), and
  the trace spans per stage.
"""

from __future__ import annotations

import csv
import json
import os
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from asyncframework_tpu_torch.checkpoint import CheckpointManager
from asyncframework_tpu_torch.metrics import EventLogReader, render_report
from asyncframework_tpu_torch.metrics import trace
from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig
from asyncframework_tpu_torch.tools import runs

#: stages the in-process solvers trace (metrics/trace.py)
STAGES = (trace.COMPUTE, trace.MERGE_QUEUE, trace.MERGE_APPLY)
#: two evaluations of one model: f32 sums over a shard in another order
OBJECTIVE_RTOL = 1e-5


def switches(dirpath: str, tag: str, checkpoint_freq: int, **kw) -> dict:
    """Every ``run()`` switch on, its files under ``dirpath`` (the sinks
    named by ``tag``, the checkpoints shared by every run of a deployment).
    ``kw`` sets the speculation and allocation knobs."""
    return dict(
        checkpoint_dir=os.path.join(dirpath, "ckpt"),
        checkpoint_freq=checkpoint_freq,
        event_log=os.path.join(dirpath, f"{tag}.jsonl"),
        metrics_csv=os.path.join(dirpath, f"{tag}.csv"),
        metrics_jsonl=os.path.join(dirpath, f"{tag}.metrics.jsonl"),
        metrics_period_s=0.5,
        trace_sample=1.0 / 16.0,
        speculation=True,
        dynamic_allocation=True,
        **kw,
    )


def sinks_report(cfg: SolverConfig, dirpath: str, accepted: int) -> dict:
    """The sinks of one run: bytes of each file, each parsed, the event log
    summarized and rendered, the spans per stage.  Raises where a file is
    empty or does not parse, or the log does not hold the run."""
    files = {"event_log": cfg.event_log, "metrics_csv": cfg.metrics_csv,
             "metrics_jsonl": cfg.metrics_jsonl}
    out = {"bytes": {k: os.path.getsize(p) for k, p in files.items()}}
    if not all(out["bytes"].values()):
        raise RuntimeError(f"an empty sink file: {out['bytes']}")
    summary = EventLogReader(cfg.event_log).summary()
    with open(cfg.metrics_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    with open(cfg.metrics_jsonl) as f:
        samples = [json.loads(line) for line in f if line.strip()]
    html = render_report(cfg.event_log,
                         os.path.join(dirpath, "report.html"))
    spans, torn = trace.load_trace_events(cfg.event_log)
    out.update(
        event_log_accepted=summary["accepted"],
        event_log_merges=summary["merges"],
        event_log_truncated=summary["truncated_records"],
        csv_rows=len(rows), jsonl_samples=len(samples),
        jsonl_accepted=samples[-1].get("updates.accepted") if samples else None,
        report_bytes=len(html.encode()),
        spans=dict(Counter(s.stage for s in spans)),
        traces=len({s.trace_id for s in spans}),
    )
    ok = (summary["accepted"] == accepted and not torn and rows and samples
          and out["jsonl_accepted"] == accepted and "Summary" in html
          and all(out["spans"].get(s, 0) > 0 for s in STAGES))
    if not ok:
        raise RuntimeError(f"the sinks do not hold the run: {out}")
    return out


def _run(solver_cls, ds, cfg, device) -> Tuple[object, dict]:
    """One ``run()``, its kernel launches counted from 0 (read just after)
    and the task bodies the executors ran."""
    runs.zero_counts()
    solver = solver_cls(ds, None, cfg, devices=[device])
    res = solver.run()
    launches = runs.counts()
    tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    rec = {
        "accepted": res.accepted, "dropped": res.dropped,
        "rounds": res.rounds, "updates_per_sec": res.updates_per_sec,
        "elapsed_s": res.elapsed_s, "max_staleness": res.max_staleness,
        "objective_first": res.trajectory[0][1],
        "final_objective": res.final_objective,
        "finite": bool(np.isfinite(res.final_w).all()),
        "tasks_run": tasks, "launches": launches,
        "extras": {k: v for k, v in res.extras.items()
                   if k not in ("alpha", "alpha_bar")},
    }
    return res, rec


def same_objective(a: float, b: float) -> bool:
    """One model's objective from two evaluations: each stacks a run's
    snapshots, and the stack's size may change the contraction's summation
    order (``OBJECTIVE_RTOL``)."""
    return abs(a - b) <= OBJECTIVE_RTOL * abs(b)


def add_launches(total: Dict[str, int], rec: dict) -> None:
    for key, count in rec["launches"].items():
        total[key] = total.get(key, 0) + count


def asgd_features(ds, device, base: dict, updates: int, dirpath: str,
                  coeff: float, spec_min_ms: float) -> List[dict]:
    """ASGD ``run()`` off, on, then resumed to ``2 * updates``, each record
    with its gates and ``ok``; raises where a sink does not hold its run.
    ``base``: the solver's settings besides the budget, the switches and
    ``coeff``."""
    off_cfg = SolverConfig(num_iterations=updates, coeff=coeff, **base)
    knobs = dict(speculation_quantile=0.5, speculation_min_ms=spec_min_ms)
    on_cfg = SolverConfig(num_iterations=updates, coeff=coeff, **base,
                          **switches(dirpath, "asgd_on", updates // 4,
                                     **knobs))
    resume_cfg = SolverConfig(num_iterations=2 * updates, coeff=coeff,
                              **base, **switches(dirpath, "asgd_resumed",
                                                 updates // 4, **knobs))
    _, off = _run(ASGD, ds, off_cfg, device)
    res_on, on = _run(ASGD, ds, on_cfg, device)
    ck = CheckpointManager(on_cfg.checkpoint_dir)
    on["checkpoint_steps"] = ck.all_steps()
    on["checkpoint_bytes"] = os.path.getsize(ck.step_path(updates))
    on["sinks"] = sinks_report(on_cfg, dirpath, updates)
    _, resumed = _run(ASGD, ds, resume_cfg, device)
    resumed["sinks"] = sinks_report(resume_cfg, dirpath, updates)
    obj_w0 = on["objective_first"]  # the switched-on run starts at w = 0
    on["gates"] = {
        "budget": on["accepted"] == updates,
        "speculated": on["extras"]["speculated"] > 0,
        "checkpoints": updates in on["checkpoint_steps"],
        "finite": on["finite"],
    }
    resumed["gates"] = {
        "resumed_k0": resumed["extras"]["resumed_from"] == updates,
        "budget": resumed["accepted"] == updates,
        # the resumed run starts at the checkpoint's model
        "starts_at_checkpoint": same_objective(resumed["objective_first"],
                                               res_on.final_objective),
        "below_0.1x": resumed["final_objective"] < obj_w0 / 10,
        "finite": resumed["finite"],
    }
    off["gates"] = {"budget": off["accepted"] == updates,
                    "finite": off["finite"]}
    recs = []
    for name, rec in (("off", off), ("on", on), ("resumed", resumed)):
        forms = rec["launches"]
        rec["gates"]["through_b1_staged"] = (
            forms["masked_grad_staged"] == forms["masked_grad"]
            >= rec["tasks_run"] > 0)
        rec.update(solver="ASGD", mode="run", switches=name,
                   objective_at_w0=obj_w0, ok=all(rec["gates"].values()))
        recs.append(rec)
    return recs


def table_restored(res, ck) -> bool:
    """``alpha_bar`` and every history slice of a run that restored and
    applied nothing, read back from its devices, bit-equal to the
    checkpoint's."""
    return bool(
        np.array_equal(res.extras["alpha_bar"], ck["alpha_bar"])
        and set(res.extras["alpha"]) == set(ck["alpha"])
        and all(np.array_equal(res.extras["alpha"][w], a)
                for w, a in ck["alpha"].items()))


def asaga_resume(ds, device, base: dict, updates: int,
                 dirpath: str) -> List[dict]:
    """ASAGA ``run()`` with checkpoints every ``updates // 3``; a run at the
    same budget that restores and applies nothing (its history table and
    ``alpha_bar`` bit-equal to the checkpoint's, :func:`table_restored`);
    then a run to ``2 * updates`` from the checkpoint, below the objective
    at w = 0 at its end (the JAX package's ASAGA gate).  Raises nothing:
    each record carries its gates and ``ok``."""
    def cfg(iters, tag):
        return SolverConfig(num_iterations=iters, **base,
                            checkpoint_dir=os.path.join(dirpath, "saga_ckpt"),
                            checkpoint_freq=max(1, updates // 3),
                            event_log=os.path.join(dirpath, f"{tag}.jsonl"))

    res1, first = _run(ASAGA, ds, cfg(updates, "saga1"), device)
    ck = CheckpointManager(os.path.join(dirpath, "saga_ckpt")).restore()
    first["checkpoint_bytes"] = os.path.getsize(
        CheckpointManager(os.path.join(dirpath, "saga_ckpt")).step_path(
            updates))
    res_same, same = _run(ASAGA, ds, cfg(updates, "saga_restore"), device)
    _, resumed = _run(ASAGA, ds, cfg(2 * updates, "saga2"), device)
    obj_w0 = first["objective_first"]
    first["gates"] = {"budget": first["accepted"] == updates,
                      "finite": first["finite"]}
    same["gates"] = {"no_update": same["accepted"] == 0,
                     "table_restored_bit_equal": table_restored(res_same, ck)}
    resumed["gates"] = {
        "resumed_k0": resumed["extras"]["resumed_from"] == updates,
        "budget": resumed["accepted"] == updates,
        "starts_at_checkpoint": same_objective(resumed["objective_first"],
                                               res1.final_objective),
        "below_w0": resumed["final_objective"] < obj_w0,
        "finite": resumed["finite"],
    }
    recs = []
    for name, rec in (("first", first), ("restore", same),
                      ("resumed", resumed)):
        rec.update(solver="ASAGA", mode="run", step=name,
                   objective_at_w0=obj_w0, ok=all(rec["gates"].values()))
        recs.append(rec)
    return recs

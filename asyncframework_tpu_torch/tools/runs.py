"""Solver runs with the kernels' launch counts, for ``chip_smoke.py`` and the
tools.

- :func:`run_one`: one ``run()``, ``run_sync()`` or ``run_fused()`` with every
  kernel wrapper's count set to 0 just before it and read just after; one
  record with updates/s, the objective, the time to ``bench.py``'s target
  (``TARGET_FRACTION = 0.001`` of the objective at w = 0, attributed by the
  fenced throughput as ``bench.py:565-576`` does for its ``fused`` arm) and
  the device memory live at its start and at its peak.
- On the fused path a wrapper counts a launch when it is enqueued: once in
  the eager warm-up and once in the capture of each of the two graphs
  (the chunk and the remainder), never in a replay.  So the record gives
  ``launches_on_path`` as the launches captured a round times the rounds
  run (captured per graph x replays), and checks that the raw count is
  exactly the warm-up's and the capture's.
- :func:`graph_check`: one chunk of a solver's fused rounds captured as a
  CUDA graph and replayed, against the same chunk run eagerly from the
  same state and generator states.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.solvers.base import (
    CHUNK_ROUNDS,
    RoundChunk,
    capture_chunks,
)

TARGET_FRACTION = 0.001  # bench.py:69
#: the kernel forms a worker task launches (one a task on every path)
TASK_FORMS = ("masked_grad", "masked_grad_staged", "masked_grad_tiled",
              "saga_grad", "compacted_grad")


def counts() -> dict:
    """Every kernel wrapper's launch count, and the calls of B1's and S1's
    plain versions."""
    return {"masked_grad": mg.masked_grad.launches,
            "masked_grad_staged": mg.masked_grad.launches_staged,
            "masked_grad_tiled": mg.masked_grad.launches_tiled,
            "saga_grad": mg.saga_grad.launches,
            "saga_slots_grad": mg.saga_slots_grad.launches,
            "xt_coeff": mg.xt_coeff.launches,
            "compacted_grad": sg.compacted_grad.launches,
            "sparse_saga_slots_grad": sg.saga_slots_grad.launches,
            "grad_sum": sg.grad_sum.launches,
            "ell_residual": sg.ell_residual.launches,
            "segment_sum": sg.segment_sum.launches,
            "compacted_grad_plain": sg.compacted_grad_plain.calls,
            "grad_sum_plain": sg.grad_sum_plain.calls,
            "ell_residual_plain": sg.ell_residual_plain.calls,
            "segment_sum_plain": sg.segment_sum_plain.calls,
            "masked_grad_plain": mg.masked_grad_reference.calls,
            "saga_grad_plain": mg.saga_grad_reference.calls,
            "saga_slots_grad_plain": mg.saga_slots_grad_reference.calls,
            "xt_coeff_plain": mg.xt_coeff_reference.calls}


def b1_forms(c: dict) -> dict:
    """B1's launches in ``counts()`` ``c`` by form: ``masked_grad`` counts
    every form, so the full masked form is what the other forms leave."""
    others = ("saga_grad", "saga_slots_grad", "xt_coeff")
    return {"full": c["masked_grad"] - sum(c[f] for f in others),
            **{f: c[f] for f in others}}


def zero_counts() -> None:
    for fn in (mg.masked_grad, mg.saga_grad, mg.saga_slots_grad,
               mg.xt_coeff, sg.compacted_grad, sg.saga_slots_grad,
               sg.grad_sum, sg.ell_residual, sg.segment_sum):
        fn.launches = 0
    mg.masked_grad.launches_staged = 0
    mg.masked_grad.launches_tiled = 0
    for fn in (sg.compacted_grad_plain, sg.grad_sum_plain,
               sg.ell_residual_plain, sg.segment_sum_plain,
               mg.masked_grad_reference, mg.saga_grad_reference,
               mg.saga_slots_grad_reference, mg.xt_coeff_reference):
        fn.calls = 0


def target_hit(res, printer_freq: int):
    """``(k_hit, t_hit_s)``: the first snapshot at or below
    ``TARGET_FRACTION`` of the objective at w = 0, its update count taken
    as ``index * printer_freq`` and its time as ``k_hit * elapsed /
    accepted``, as ``bench.py`` computes both; None where not reached."""
    target = res.trajectory[0][1] * TARGET_FRACTION
    for i, (_t, obj) in enumerate(res.trajectory):
        if obj <= target:
            k_hit = max(i * max(printer_freq, 1), 1)
            return k_hit, k_hit * res.elapsed_s / max(res.accepted, 1)
    return None, None


def _on_path(raw: dict, rounds: int) -> dict:
    """The task forms' launches on a fused run's path: each graph's
    launches a round times the rounds replayed.  The raw count holds the
    eager warm-up and the capture of the chunk and the remainder, so it
    must be exactly twice their rounds times the launches a round."""
    chunk = min(CHUNK_ROUNDS, rounds)
    graph_rounds = chunk + rounds % chunk
    out = {}
    for form in TASK_FORMS:
        per_round, left = divmod(raw[form], 2 * graph_rounds)
        if left:
            raise RuntimeError(
                f"{form}: {raw[form]} launches in warm-up and capture, not a "
                f"multiple of the {2 * graph_rounds} rounds they ran")
        out[form] = per_round * rounds
    return out


def run_one(solver_cls, mode: str, ds, cfg, device):
    """One solver run (``mode``: ``run``, ``run_sync`` or ``run_fused``)
    with every count set to 0 just before it and read just after; returns
    ``(result, record)``."""
    t0 = time.monotonic()
    solver = solver_cls(ds, None, cfg, devices=[device])
    cuda = device.type == "cuda"
    if cuda:
        # earlier runs' garbage (their threads hold reference cycles) is
        # collected, so the peak is this run's over what is live before it
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    at_start = torch.cuda.memory_allocated(device) if cuda else None
    zero_counts()
    res = getattr(solver, mode)()
    raw = counts()
    fused = mode == "run_fused"
    tasks = (res.accepted if fused else
             sum(m.succeeded for m in solver.scheduler.pool.all_metrics()))
    on_path = (_on_path(raw, res.rounds) if fused
               else {form: raw[form] for form in TASK_FORMS})
    objs = [obj for _, obj in res.trajectory]
    k_hit, t_hit = target_hit(res, cfg.printer_freq)
    launched = sum(on_path[f] for f in ("masked_grad", "compacted_grad"))
    rec = {
        "solver": solver_cls.__name__, "mode": mode, "gamma": cfg.gamma,
        "batch_rate": cfg.batch_rate, "workers": cfg.num_workers,
        "drain_batch": cfg.drain_batch if mode == "run" else 1,
        "accepted": res.accepted, "dropped": res.dropped,
        "rounds": res.rounds, "budget": cfg.num_iterations,
        "updates_per_sec": res.updates_per_sec,
        "rounds_per_sec": res.rounds / res.elapsed_s if res.elapsed_s else 0.0,
        "elapsed_s": res.elapsed_s, "tasks_run": tasks,
        "tasks_per_accepted_update": tasks / max(res.accepted, 1),
        "max_staleness": res.max_staleness,
        "objective_at_w0": objs[0], "best_objective": min(objs),
        "final_objective": objs[-1],
        "finite": bool(np.isfinite(res.final_w).all()),
        "k_hit": k_hit, "t_hit_s": t_hit,
        "launches": raw, "launches_on_path": on_path,
        "kernel_launches_per_accepted_update":
            launched / max(res.accepted, 1),
        "memory_at_start_bytes": at_start,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else None),
        "wall_s": time.monotonic() - t0,
        "trajectory": [float(f"{o:.6g}") for o in objs],
    }
    if fused:
        replays = res.extras["graph_replays"]
        rec.update({
            "graph_replays": replays,
            "graph_launches_per_accepted_update":
                replays / max(res.accepted, 1),
            "rounds_per_graph": res.extras["rounds_per_call"],
        })
    return res, rec


def graph_check(solver, rounds: int = CHUNK_ROUNDS) -> dict:
    """``rounds`` rounds of ``solver.fused_rounds()`` captured as one CUDA
    graph (warm-up and capture as ``run_fused`` does them) and replayed
    once, against the same rounds run eagerly from the same state and the
    same generator states: the state buffers and every snapshot row must
    be bit-equal.  Also whether warm-up and capture left each generator as
    it was, and whether the replay advanced it.  Raises where the capture
    fails."""
    fused = solver.fused_rounds()
    chunk = RoundChunk(fused, rounds)
    before = [gen.get_state() for gen in fused.generators]
    zero_counts()
    t0 = time.monotonic()
    capture_chunks(fused, [chunk])
    capture_s = time.monotonic() - t0
    raw = counts()
    restored = all(torch.equal(gen.get_state(), s)
                   for gen, s in zip(fused.generators, before))
    start = [t.clone() for t in fused.carry]
    chunk.run_eager()
    eager = [t.clone() for t in (*fused.carry, chunk.snap)]
    eager_states = [gen.get_state() for gen in fused.generators]
    for buf, old in zip(fused.carry, start):
        buf.copy_(old)
    for gen, state in zip(fused.generators, before):
        gen.set_state(state)
    chunk()
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b))
             for a, b in zip(eager, (*fused.carry, chunk.snap))]
    # a replay advances each generator as far as the eager rounds do
    advanced = all(torch.equal(gen.get_state(), s) and not torch.equal(s, b)
                   for gen, s, b in zip(fused.generators, eager_states,
                                        before))
    return {
        "rounds": rounds, "captures": True, "capture_s": capture_s,
        "launches_warm_and_capture": {k: v for k, v in raw.items() if v},
        "generators_restored": restored,
        "generators_advanced_as_eager": advanced,
        "replay_bit_equal": all(equal),
        "state_bit_equal": equal[:-1], "snapshots_bit_equal": equal[-1],
        "rounds_moved_model": bool((chunk.snap[0] != chunk.snap[-1]).any()),
        "ok": all(equal) and restored and advanced,
    }

"""Kernel S1's fused launch on one GPU: where a launch's time goes.

    python3 -m asyncframework_tpu_torch.tools.probe_sparse_grad \
        [--cases s_rcv1_task,s_k8] [--calls N]

For each case (``chip_smoke.py``'s phase-2 S1 shapes, built the same way
from seed 0), runs ``sparse_grad.compacted_grad`` with
``record_timeline``: every block stamps ``%globaltimer`` at each phase
boundary of the one cooperative launch (the residual; on the local route
the top-digit scan and scatter and the buckets, three grid barriers; on
the global route each sort pass's histogram, scan and scatter, the column
counts and the segment sums, six barriers at two passes), and the route
it took.  Prints one JSON line a case: the
event-timed call (median of ``--calls``, each after a 128 MB L2 flush and
a sleep kernel queued ahead, as ``chip_smoke.py`` times it) and, for each
span between two stamps, the median over calls of the time from the last
block's stamp at one boundary to the last block's at the next (us): the
critical path, which sums to the kernel's body.
Every line carries the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.ops.steps import compact_mask

SLEEP_CYCLES = 2_000_000
L2_FLUSH_BYTES = 128 << 20

# (name, shard rows, K, live a row, d, rate or None, slots, column law):
# chip_smoke.py's S1_CASES
CASES = {
    "s_rcv1_task": (87_205, 80, 75, 47_236, 0.05, 4_752, "uniform"),
    "s_rcv1_shard": (87_205, 80, 75, 47_236, None, None, "uniform"),
    "s_no_valid": (87_205, 80, 75, 47_236, 0.0, 4_752, "uniform"),
    "s_d1": (87_205, 80, 75, 1, 0.05, 4_752, "uniform"),
    "s_one_column": (87_205, 80, 75, 47_236, 0.05, 4_752, "one"),
    "s_k8": (87_205, 8, 8, 47_236, 0.05, 4_752, "uniform"),
    "s_rcv1_skewed": (87_205, 80, 75, 47_236, 0.05, 4_752, "zipf"),
}


def span_names(passes: int, local: bool):
    """The spans between the kernel's stamps, in order, on its route."""
    names = ["residual", "barrier"]
    if local:
        return names + ["scan_top", "barrier", "scatter_top", "barrier",
                        "buckets"]
    for p in range(passes):
        if p:
            names += [f"hist{p}" + ("+columns" if p == 1 else ""), "barrier"]
        names += [f"scan{p}" + ("+counts" if p == 0 else ""), "barrier",
                  ("columns+" if p == 0 and passes == 1 else "")
                  + f"scatter{p}", "barrier"]
    return names + ["segments"]


# stamps 24-27 of block 0's thread 0 in its last row batch: before the rows
# are staged, staged, the residuals summed (the w gathers), the entries'
# keys and products written and counted
DETAIL = (24, ("stage", "gather_sum", "emit"))


def problem(rows, K, nnz, d, rate, cap, law, dev, gen):
    if law == "one":
        cols = torch.full((rows, K), d // 2, device=dev, dtype=torch.int32)
    elif law == "zipf":
        rank = torch.arange(1, d + 1, device=dev, dtype=torch.float32)
        draw = torch.multinomial(1.0 / rank, rows * K, replacement=True,
                                 generator=gen)
        ids = torch.randperm(d, device=dev, generator=gen)
        cols = ids[draw].reshape(rows, K).to(torch.int32)
    else:
        cols = torch.randint(0, d, (rows, K), device=dev, generator=gen,
                             dtype=torch.int32)
    vals = torch.randn(rows, K, device=dev, generator=gen) / math.sqrt(nnz)
    cols[:, nnz:] = 0
    vals[:, nnz:] = 0.0
    y = torch.randn(rows, device=dev, generator=gen)
    w = torch.randn(d, device=dev, generator=gen)
    if rate is None:
        return cols, vals, y, w, None, None
    sel = torch.rand(rows, device=dev, generator=gen) < rate
    valid, idx = compact_mask(sel, cap)
    return cols, vals, y, w, idx, valid


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--calls", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_sparse_grad: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name in args.cases.split(","):
        probe(name, args.calls, card, dev, flush, gen)


def probe(name, calls, card, dev, flush, gen):
    """One case's JSON line."""
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, K, nnz, d, rate, cap, law = CASES[name]
    cols, vals, y, w, idx, valid = problem(rows, K, nnz, d, rate, cap,
                                           law, dev, gen)
    m = rows if idx is None else cap
    plan = sg.launch_plan(m, K, d)
    stamps = torch.zeros(blocks, sg.STAMPS, dtype=torch.int64, device=dev)
    with sg.record_timeline(stamps):
        sg.compacted_grad(cols, vals, y, w, idx, valid, d)
    local = bool(stamps[0, sg.ROUTE_STAMP])
    names = span_names(plan.passes, local)
    spans, times = [[] for _ in names], []
    detail = [[] for _ in DETAIL[1]]
    for _ in range(calls):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with sg.record_timeline(stamps):
            start.record()
            sg.compacted_grad(cols, vals, y, w, idx, valid, d)
            end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
        last = stamps[:, :len(names) + 1].max(0).values.cpu()
        for i in range(len(names)):
            spans[i].append(float(last[i + 1] - last[i]) / 1e3)
        b0 = stamps[0, DETAIL[0]:DETAIL[0] + len(DETAIL[1]) + 1].cpu()
        for i in range(len(DETAIL[1])):
            detail[i].append(float(b0[i + 1] - b0[i]) / 1e3)
    med = [sorted(s)[len(s) // 2] for s in spans]
    print(json.dumps({
        "case": name, "card": card, "plan": plan._asdict(),
        "route": "local" if local else "global",
        "call_us": sorted(times)[len(times) // 2],
        "spans_us": dict(zip([f"{i}:{n}" for i, n in enumerate(names)],
                             med)),
        "sum_of_spans_us": sum(med),
        "block0_last_batch_us": dict(zip(
            DETAIL[1], [sorted(x)[len(x) // 2] for x in detail])),
    }), flush=True)

if __name__ == "__main__":
    main()

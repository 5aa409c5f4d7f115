"""Where the time goes on the port's main path, on one GPU.

    python3 -m asyncframework_tpu_torch.tools.profile_asgd \
        [--config epsilon|rcv1|mnist8m] [--entry run,run_fused] [--updates N]

Generates the epsilon deployment on the card (400,000 x 2,000 f32, 8
workers, b = 0.1, gamma 100), the rcv1 one (``tools/rcv1.py``: 697,641 x
47,236 padded ELL, b = 0.05, bench.py's recipe) or the mnist8m one
(8,100,000 x 784 bf16, b = 0.1, gamma 39.2, bench.py's recipe), then, for
each entry point named (in one process, on one dataset):

- ``run``: ``ASGD.run()`` (1,000 updates; rcv1 1,200) once without the
  profiler and once under ``torch.profiler``: the device-busy share of the
  profiled call (summed kernel time over its wall time, warm-up and
  trajectory evaluation included -- one stream, so kernels do not
  overlap), device kernel launches and worker tasks per accepted update;
- ``run_fused``: ``ASGD.run_fused()`` (5,000 updates; rcv1 1,200) once
  without the profiler, then the same rounds' chunks captured
  (``solvers/base.py::fused_chunks``) and only their timed loop
  (``replay_chunks`` and the final fence) under the profiler: the
  device-busy share of that window, device kernels per accepted update,
  and the host's ``cudaGraphLaunch`` and kernel-launch calls per accepted
  update.

One JSON line an entry point: updates/s unprofiled and profiled, the host
API calls per accepted update, the kernels and host-side operators that
took the most time.  With ``--config rcv1`` the ``run`` line also names
kernel S1's launches (its wrappers' counts over the profiled run, the fused
kernel's launches per task in the trace) and the share of device time in
sort and memset launches.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.solvers import ASGD, SolverConfig
from asyncframework_tpu_torch.solvers.base import fused_chunks, replay_chunks
from asyncframework_tpu_torch.tools import rcv1

# host API calls that enqueue device work
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel",
                "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC",
                "cudaMemcpyAsync", "cudaMemsetAsync")
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def deployment(config: str, dev):
    """``(dataset, config(updates) -> SolverConfig, run updates, fused
    updates)`` of one deployment."""
    if config == "rcv1":
        return (rcv1.dataset(dev),
                lambda n: rcv1.config(n, rcv1.ASGD_GAMMA),
                rcv1.ASGD_UPDATES, rcv1.ASGD_UPDATES)
    if config == "mnist8m":
        ds = ShardedDataset.generate_on_device(
            8_100_000, 784, 8, [dev], seed=7, noise=0.01,
            dtype=torch.bfloat16)
        gamma, freq = 39.2, 25
    else:
        ds = ShardedDataset.generate_on_device(400_000, 2_000, 8, [dev],
                                               seed=7, noise=0.01)
        gamma, freq = 100.0, 25
    return (ds, lambda n: SolverConfig(
        num_workers=8, num_iterations=n, gamma=gamma, taw=2**31 - 1,
        batch_rate=0.1, bucket_ratio=0.7, printer_freq=freq, seed=42,
        calibration_iters=100), 1_000, 5_000)


def kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def summary(prof, wall_s: float, accepted: int) -> dict:
    """Device-busy share over ``wall_s``, launches per accepted update,
    the top kernels and host operators of one profiled window."""
    kernels = kernel_events(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    averages = prof.key_averages()
    host = sorted((e for e in averages if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    calls = {e.key: e.count for e in averages if e.key in LAUNCH_CALLS}
    per = max(accepted, 1)
    return {
        "wall_s_profiled": wall_s,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_launches_per_update": len(kernels) / per,
        "host_calls_per_update": {k: v / per for k, v in sorted(calls.items())},
        "top_host_ops": [
            {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "count": e.count}
            for e in host
        ],
        "top_kernels": [
            {"name": name[:80], "device_ms": t / 1e3, "count": c}
            for name, (t, c) in top
        ],
    }


def profile_run(ds, cfg, dev, config: str) -> dict:
    plain = ASGD(ds, None, cfg, devices=[dev]).run()
    solver = ASGD(ds, None, cfg, devices=[dev])
    s1 = (sg.compacted_grad, sg.grad_sum, sg.ell_residual, sg.segment_sum)
    s1_before = [fn.launches for fn in s1]
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.monotonic()
        res = solver.run()
        wall_s = time.monotonic() - t0
    tasks = sum(m.succeeded for m in solver.scheduler.pool.all_metrics())
    out = {"updates_per_sec": plain.updates_per_sec,
           "updates_per_sec_profiled": res.updates_per_sec,
           "accepted": res.accepted, "tasks_run": tasks,
           "tasks_per_accepted_update": tasks / max(res.accepted, 1),
           **summary(prof, wall_s, res.accepted)}
    if config == "rcv1":
        kernels = kernel_events(prof)
        sort_memset = [e for e in kernels
                       if any(w in e.name.lower()
                              for w in ("sort", "radix", "memset"))]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        out.update({
            "s1_launches": {fn.__name__: fn.launches - b
                            for fn, b in zip(s1, s1_before)},
            "s1_fused_launches_per_task": sum(
                1 for e in kernels if "sparse_task_kernel" in e.name)
            / max(tasks, 1),
            "sort_memset_launches": len(sort_memset),
            "sort_memset_device_share": sum(
                e.time_range.elapsed_us() for e in sort_memset)
            / max(busy_us, 1e-9),
            "sort_memset_names": sorted({e.name[:60] for e in sort_memset}),
        })
    return out


def profile_fused(ds, cfg, dev) -> dict:
    plain = ASGD(ds, None, cfg, devices=[dev]).run_fused()
    solver = ASGD(ds, None, cfg, devices=[dev])
    nw = cfg.num_workers
    total_rounds = max(1, -(-cfg.num_iterations // nw))
    plan = fused_chunks(solver.fused_rounds(), total_rounds)
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.monotonic()
        _, _, rounds, replays = replay_chunks(plan, nw, cfg.printer_freq)
        torch.cuda.synchronize(dev)
        wall_s = time.monotonic() - t0
    accepted = rounds * nw
    return {"updates_per_sec": plain.updates_per_sec,
            "updates_per_sec_profiled": accepted / wall_s,
            "accepted": accepted, "graph_replays": replays,
            "rounds_per_graph": plan[0].rounds,
            "final_objective": plain.final_objective,
            "objective_at_w0": plain.trajectory[0][1],
            **summary(prof, wall_s, accepted)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("epsilon", "rcv1", "mnist8m"),
                    default="epsilon")
    ap.add_argument("--entry", default="run",
                    help="comma-separated: run, run_fused")
    ap.add_argument("--updates", type=int, default=None)
    args = ap.parse_args()
    entries = args.entry.split(",")
    if set(entries) - {"run", "run_fused"}:
        raise SystemExit(f"profile_asgd: unknown entry in {args.entry!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_asgd: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ds, config, run_updates, fused_updates = deployment(args.config, dev)
    for entry in entries:
        updates = args.updates or (run_updates if entry == "run"
                                   else fused_updates)
        cfg = config(updates)
        out = (profile_run(ds, cfg, dev, args.config) if entry == "run"
               else profile_fused(ds, cfg, dev))
        print(json.dumps({"card": card, "config": args.config,
                          "entry": entry, "updates": updates, **out}),
              flush=True)


if __name__ == "__main__":
    main()

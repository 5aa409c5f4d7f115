"""The submit CLI: drop-in experiment recipes with the reference's arguments.

Counterpart of ``asyncframework_tpu/cli.py``: the same recipes, flags,
guards, output and wire, on PyTorch.  Each reference driver takes 13
positional args (``SparkASGDThread.scala:28-48``; example submit in
``README.md:46``)::

    <path> <file> <d> <N> <numPart> <numIter> <gamma> <taw> <batchRate>
    <bucketRatio> <printerFreq> <coeff> <seed>

Here the same recipe is::

    python -m asyncframework_tpu_torch.cli SparkASGDThread \\
        /data mnist8m.scale 784 8100000 64 16000 1.5625e-3 20000000 \\
        0.01 0.7 200 -1 42

Driver names accept both the reference class names (``SparkASGDThread``,
``SparkASGDSync``, ``SparkASAGAThread``, ``SparkASAGASync``,
``SparkSGDMLLIB``) and short forms (``asgd``, ``asgd-sync``, ``asaga``,
``asaga-sync``, ``sgd-mllib``), plus the fused fast paths ``asgd-fused`` /
``asaga-fused`` (recipes whose tau filter provably never fires, run as
CUDA-graph chunks of rounds -- asgd: taw >= numPart-1; asaga: taw >=
numIter; single-process, no runtime flags -- see ``ASGD.run_fused``).
``--conf key=value`` overlays any registered
:class:`~asyncframework_tpu_torch.conf.ConfigEntry` (CLI > conf file > env
> default precedence, like ``spark-submit --conf``).

Data: ``<path>/<file>`` is a LibSVM file loaded with ``d`` features; the
special path ``synthetic`` generates an ``N x d`` planted least-squares
problem directly in device memory instead (``--sparse``: a CSR problem
from the seed, packed onto the device as padded ELL).

Devices: every CUDA device, or the first N with ``--devices N``.  Without
a card the CLI raises; ``ASYNCTPU_FORCE_CPU=1`` (the JAX package's name
for its CPU rig) asks for the CPU, as K ranks of it, K being the
``--xla_force_host_platform_device_count`` of ``XLA_FLAGS`` (the JAX
package's virtual CPU device count, so one environment gives both CLIs
the same ranks; 1 when unset).  Only ``sgd-mllib`` builds a mesh over the
ranks; the async drivers place their shards on them.

Output: the loss trajectory is printed as ``(ms, objective)`` pairs exactly
like the drivers' final loop (``SparkASGDThread.scala:386-401``), followed by
one JSON summary line (machine-readable; consumed by bench harnesses).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional

from asyncframework_tpu_torch.conf import AsyncConf, registry

# registered ConfigEntry key -> SolverConfig field, for --conf overlays
CONF_TO_FIELD: Dict[str, str] = {
    "async.num.workers": "num_workers",
    "async.num.iterations": "num_iterations",
    "async.step.size": "gamma",
    "async.taw": "taw",
    "async.batch.rate": "batch_rate",
    "async.bucket.ratio": "bucket_ratio",
    "async.printer.freq": "printer_freq",
    "async.delay.coeff": "coeff",
    "async.seed": "seed",
    # engine knobs (spark.speculation / dynamicAllocation analogs)
    "async.drain.batch": "drain_batch",
    "async.speculation.quantile": "speculation_quantile",
    "async.speculation.multiplier": "speculation_multiplier",
    "async.speculation.min.ms": "speculation_min_ms",
    "async.allocation.max.extra": "allocation_max_extra",
    "async.allocation.backlog.threshold": "allocation_backlog_threshold",
    "async.allocation.idle.timeout.s": "allocation_idle_timeout_s",
    "async.heartbeat.timeout.ms": "heartbeat_timeout_ms",
    "async.max.slot.failures": "max_slot_failures",
    "async.broadcast.versions": "max_live_versions",
    "async.ui.port": "ui_port",
    "async.trace.sample": "trace_sample",
    # DCN data-plane knobs (parallel/ps_dcn.py)
    "async.pull.mode": "pull_mode",
    "async.push.merge": "push_merge",
    "async.codec.push": "push_codec",
    "async.pipeline.depth": "pipeline_depth",
    "async.mesh.devices": "mesh_devices",
    # telemetry plane (metrics/timeseries.py)
    "async.convergence.sample": "conv_sample",
}

DRIVER_ALIASES: Dict[str, str] = {
    "sparkasgdthread": "asgd",
    "asgd": "asgd",
    "sparkasgdsync": "asgd-sync",
    "asgd-sync": "asgd-sync",
    "sparkasagathread": "asaga",
    "asaga": "asaga",
    "sparkasagasync": "asaga-sync",
    "asaga-sync": "asaga-sync",
    "sparksgdmllib": "sgd-mllib",
    "sgd-mllib": "sgd-mllib",
    # the fused fast path (taw=inf recipes; see ASGD.run_fused)
    "asgd-fused": "asgd-fused",
    "asaga-fused": "asaga-fused",
}

POSITIONAL = [
    ("path", str, "data directory, or 'synthetic'"),
    ("file", str, "LibSVM file name (ignored for synthetic)"),
    ("d", int, "number of features (columns)"),
    ("N", int, "number of rows"),
    ("num_partitions", int, "number of workers/partitions"),
    ("num_iterations", int, "iterations (accepted updates)"),
    ("gamma", float, "step size"),
    ("taw", int, "staleness bound tau"),
    ("batch_rate", float, "Bernoulli batch rate b"),
    ("bucket_ratio", float, "cohort availability threshold"),
    ("printer_freq", int, "trajectory snapshot period"),
    ("coeff", float, "delay intensity (-1 = cloud long-tail)"),
    ("seed", int, "root PRNG seed"),
]

#: the multi-process cluster path's defaults (:func:`run_async_cluster`),
#: each set only where neither ``--conf`` nor the environment holds a
#: value.  The data plane: version-gated delta pulls, the pipelined update
#: loop (prefetched pulls, at most 2 unacked pushes), the native wire
#: codecs and the shared-memory ring for colocated role pairs; an explicit
#: ``--conf async.pull.mode=full`` / ``async.pipeline.depth=0`` /
#: ``async.native.enabled=false`` / ``async.shm.enabled=false`` restores
#: the legacy path.
DATA_PLANE_DEFAULTS: Dict[str, object] = {
    "async.pull.mode": "delta",
    "async.pipeline.depth": 2,
    "async.native.enabled": True,
    "async.shm.enabled": True,
}
#: ... and beside it: a convergence sample every 16th update of each
#: logical worker, epoch fencing, and the adaptive asynchrony controller
#: on the primary PS (``async.convergence.sample=0``,
#: ``async.fence.enabled=false``, ``async.control.enabled=false`` turn
#: each off).
CLUSTER_DEFAULTS: Dict[str, object] = {
    **DATA_PLANE_DEFAULTS,
    "async.convergence.sample": 16,
    "async.fence.enabled": True,
    "async.control.enabled": True,
}

FORCE_CPU_ENV = "ASYNCTPU_FORCE_CPU"
_CPU_COUNT_FLAG = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def apply_defaults(conf: AsyncConf, defaults: Dict[str, object]) -> None:
    """Set each of ``defaults`` on ``conf`` where it holds no value."""
    for key, value in defaults.items():
        if not conf.contains(key):
            conf.set(key, value)


def cpu_ranks() -> int:
    """The CPU ranks a process asked for the CPU runs on: ``XLA_FLAGS``'s
    ``--xla_force_host_platform_device_count`` (the count the JAX package
    gets from the same environment), else 1."""
    m = _CPU_COUNT_FLAG.search(os.environ.get("XLA_FLAGS", ""))
    return max(1, int(m.group(1))) if m else 1


def resolve_cli_devices(limit: Optional[int] = None):
    """The run's devices: every CUDA device, or, with
    ``ASYNCTPU_FORCE_CPU`` set, :func:`cpu_ranks` ranks of the CPU; the
    first ``limit`` of them when given.  Without a card and without the
    variable it raises, never falling back to the CPU."""
    import torch

    from asyncframework_tpu_torch.utils.devices import resolve_devices

    if os.environ.get(FORCE_CPU_ENV):
        devices = [torch.device("cpu")] * cpu_ranks()
    else:
        try:
            devices = resolve_devices(None)
        except RuntimeError as e:
            raise RuntimeError(
                f"{e}; the CLI runs on the CPU with {FORCE_CPU_ENV}=1") from e
    if limit is not None:
        devices = devices[:limit]
    return devices


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="async-submit",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("driver", help="driver class (SparkASGDThread/asgd, ...)")
    for name, typ, doc in POSITIONAL:
        p.add_argument(name, type=typ, help=doc)
    p.add_argument("--conf", action="append", default=[], metavar="K=V",
                   help="config overlay (repeatable)")
    p.add_argument("--loss", default="least_squares",
                   choices=["least_squares", "logistic"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-freq", type=int, default=0)
    p.add_argument("--output", default=None,
                   help="write the trajectory as CSV to this path")
    p.add_argument("--devices", type=int, default=None,
                   help="use only the first N devices")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the per-snapshot trajectory lines")
    p.add_argument("--master", default=None,
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="submit to a standalone master daemon (first addr "
                        "primary, rest standbys) instead of running locally "
                        "-- spark-submit --master parity")
    p.add_argument("--processes", type=int, default=1,
                   help="executor processes for a --master submission")
    p.add_argument("--supervise", action="store_true",
                   help="worker daemons restart failed executors "
                        "(spark-submit --supervise parity; --master only)")
    p.add_argument("--no-wait", action="store_true",
                   help="return after submission without waiting for a "
                        "terminal state (cluster deploy-mode)")
    p.add_argument("--wait-timeout", type=float, default=600.0,
                   help="--master wait budget in seconds")
    p.add_argument("--event-log", default=None,
                   help="write a JSONL event log (.gz = compressed) of the run")
    p.add_argument("--report", default=None,
                   help="render an HTML run report to this path "
                        "(requires --event-log)")
    p.add_argument("--metrics-csv", default=None,
                   help="periodic metrics samples as CSV")
    p.add_argument("--ui-port", type=int, default=None, metavar="PORT",
                   help="serve a live run dashboard on this HTTP port "
                        "during the run (0 = ephemeral; SparkUI parity)")
    p.add_argument("--trace-sample", type=float, default=None,
                   metavar="RATE",
                   help="distributed-trace sampling rate per update "
                        "lifecycle (1 = every update, 0 = off; default "
                        "async.trace.sample = 1/64).  Spans land in the "
                        "event log / live UI")
    p.add_argument("--speculation", action="store_true",
                   help="launch speculative copies of straggling tasks")
    p.add_argument("--dynamic-allocation", action="store_true",
                   help="scale slot capacity with task backlog (sibling "
                        "executors added/retired, ExecutorAllocationManager "
                        "parity)")
    p.add_argument("--stale-read", type=int, default=None, metavar="OFFSET",
                   help="ASYNCbroadcast experiment: workers read model "
                        "version (latest - OFFSET) from the versioned store")
    p.add_argument("--no-heartbeat", action="store_true",
                   help="disable executor liveness monitoring")
    p.add_argument("--sparse", action="store_true",
                   help="rcv1-class path: keep data sparse on device "
                        "(padded-ELL shards; never densified)")
    p.add_argument("--sparse-density", type=float, default=0.002,
                   help="row density for synthetic --sparse data")
    return p


def parse_conf_overlays(pairs: List[str]) -> AsyncConf:
    conf = AsyncConf()
    known = registry()
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--conf expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        k = k.strip()
        if k not in known:
            raise SystemExit(
                f"--conf: unknown key {k!r}; registered keys: "
                + ", ".join(sorted(known))
            )
        conf.set(k, v.strip())
    # make the overlays visible to components that resolve conf defaults
    # themselves (the DCN plane's knobs)
    from asyncframework_tpu_torch.conf import set_global_conf

    set_global_conf(conf)
    return conf


def load_data(args, cfg, devices, need_host: bool = False):
    """Resolve (X, y) or a device-resident dataset per the recipe.

    Sharding follows the post-overlay ``cfg`` (worker count / seed may have
    been changed by ``--conf``).  ``need_host=True`` (the mllib baseline)
    forces host arrays even for synthetic data -- it shards the *global*
    arrays over the mesh itself.
    """
    from asyncframework_tpu_torch.data.sharded import ShardedDataset

    if getattr(args, "sparse", False):
        if need_host:
            raise SystemExit(
                "--sparse is not supported by the sgd-mllib SPMD baseline "
                "(it shards dense global arrays); use asgd/asaga drivers"
            )
        from asyncframework_tpu_torch.data.sparse import SparseShardedDataset

        if args.path == "synthetic":
            from asyncframework_tpu_torch.data.synthetic import (
                make_sparse_regression,
            )

            indptr, indices, values, y = make_sparse_regression(
                args.N, args.d, density=args.sparse_density, seed=cfg.seed
            )
        else:
            path = os.path.join(args.path, args.file)
            if not os.path.exists(path):
                raise SystemExit(f"no such data file: {path}")
            from asyncframework_tpu_torch.data.libsvm import load_libsvm_sparse

            indptr, indices, values, y = load_libsvm_sparse(path, args.d)
            if args.N and len(indptr) - 1 > args.N:
                indptr = indptr[: args.N + 1]
                indices = indices[: indptr[-1]]
                values = values[: indptr[-1]]
                y = y[: args.N]
        ds = SparseShardedDataset(
            indptr, indices, values, y, args.d, cfg.num_workers, devices
        )
        return ds, None

    if args.path == "synthetic":
        if need_host:
            from asyncframework_tpu_torch.data import make_regression

            X, y, _ = make_regression(args.N, args.d, seed=cfg.seed)
            return X, y
        ds = ShardedDataset.generate_on_device(
            args.N, args.d, cfg.num_workers, devices=devices,
            seed=cfg.seed,
        )
        return ds, None
    path = os.path.join(args.path, args.file)
    if not os.path.exists(path):
        raise SystemExit(f"no such data file: {path}")
    from asyncframework_tpu_torch.data.libsvm import load_libsvm

    X, y = load_libsvm(path, num_features=args.d)
    if args.N and X.shape[0] > args.N:
        X, y = X[: args.N], y[: args.N]
    return X, y


def run_driver(args, conf: AsyncConf) -> Dict[str, object]:
    from asyncframework_tpu_torch.parallel import multihost
    from asyncframework_tpu_torch.solvers import (
        ASAGA,
        ASGD,
        MiniBatchSGD,
        SolverConfig,
    )

    driver = DRIVER_ALIASES.get(args.driver.lower())
    if driver is None:
        raise SystemExit(
            f"unknown driver {args.driver!r}; one of "
            f"{sorted(set(DRIVER_ALIASES.values()))} (or reference class names)"
        )
    # Multi-host: the SPMD sgd-mllib driver joins a torch.distributed
    # process group and a global mesh; the ASYNC drivers instead run the
    # DCN parameter server (parallel/ps_dcn.py): process 0 IS the PS (the
    # driver IS the server -- now across the process boundary), processes
    # 1..N-1 push tau-stamped gradients over the coordinator address's TCP
    # channel.
    if os.environ.get("ASYNCTPU_COORDINATOR") and driver in ("asgd", "asaga"):
        nproc = int(os.environ.get("ASYNCTPU_NUM_PROCESSES", "1"))
        if nproc > 1:
            return run_async_cluster(args, conf, algo=driver)
        # a 1-process placement (e.g. a master-scheduled single-executor
        # app) is just a normal single-process run; DCN mode needs peers.
        # ensure_initialized below also no-ops for nproc <= 1.
    devices = resolve_cli_devices(args.devices)
    if multihost.ensure_initialized(devices=devices) and driver != "sgd-mllib":
        raise SystemExit(
            "multi-process runs support the SPMD sgd-mllib driver (global "
            "mesh) and the DCN parameter-server asgd/asaga drivers; the "
            "sync and fused drivers run single-process"
        )

    # drivers without the async engine runtime (no updater thread, no
    # executor pool): one predicate, every runtime-flag guard below uses it
    no_runtime = (
        driver.endswith("-sync") or driver.endswith("-fused")
        or driver == "sgd-mllib"
    )
    fused = driver.endswith("-fused")
    if args.checkpoint_dir and no_runtime:
        raise SystemExit(
            "--checkpoint-dir is supported by the async engine drivers "
            "only (asgd, asaga); sync/fused/sgd-mllib runs do not "
            "checkpoint"
        )

    if args.report and not args.event_log:
        raise SystemExit("--report requires --event-log (it renders the log)")
    if args.stale_read is not None and no_runtime:
        raise SystemExit(
            "--stale-read applies to the async engine drivers only"
        )
    if fused:
        # flag guards use raw args (overlays cannot change flags)
        for flag, name in (
            (args.speculation, "--speculation"),
            (args.dynamic_allocation, "--dynamic-allocation"),
            (args.ui_port is not None, "--ui-port"),
            (args.metrics_csv, "--metrics-csv"),
        ):
            if flag:
                raise SystemExit(
                    f"{name} needs the async engine runtime; the fused "
                    "drivers run a closed on-device loop -- use asgd/asaga"
                )

    cfg = SolverConfig(
        num_workers=args.num_partitions,
        num_iterations=args.num_iterations,
        gamma=args.gamma,
        taw=args.taw,
        batch_rate=args.batch_rate,
        bucket_ratio=args.bucket_ratio,
        printer_freq=args.printer_freq,
        coeff=args.coeff,
        seed=args.seed,
        loss=args.loss,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_freq=args.checkpoint_freq,
        event_log=args.event_log,
        metrics_csv=args.metrics_csv,
        ui_port=args.ui_port,
        trace_sample=args.trace_sample,
        speculation=args.speculation,
        dynamic_allocation=args.dynamic_allocation,
        stale_read_offset=args.stale_read,
        heartbeat=not args.no_heartbeat,
    )
    # conf overlays beat recipe args for every registered solver knob
    for key, field in CONF_TO_FIELD.items():
        if conf.contains(key):
            setattr(cfg, field, conf.get(key))

    if fused:
        # numeric guards run AFTER the overlays (a --conf async.taw /
        # async.num.workers rewrite must be what is judged) and BEFORE the
        # (possibly large) dataset loads -- run_fused's own checks would
        # surface as tracebacks after the load.  Thresholds differ by
        # family: ASGD's staleness filter is wave-bounded (taw >= nw-1
        # never fires); ASAGA's quirk binds on iteration count (taw >=
        # num_iterations never fires) -- see each solver's run_fused.
        if driver.startswith("asgd") and cfg.taw < cfg.num_workers - 1:
            raise SystemExit(
                "asgd-fused admits taw >= num_workers-1 (its wave "
                "staleness never exceeds that); a tighter taw needs the "
                "engine's tau filter -- use asgd"
            )
        if driver.startswith("asaga") and cfg.taw < cfg.num_iterations:
            raise SystemExit(
                "asaga-fused requires taw >= num_iterations (the ASAGA "
                "filter quirk binds on iteration count); a tighter taw "
                "needs the engine -- use asaga"
            )
        if cfg.coeff != 0.0:
            raise SystemExit(
                "fused drivers cannot inject stragglers (no host between "
                "updates); use asgd/asaga"
            )

    X, y = load_data(args, cfg, devices, need_host=(driver == "sgd-mllib"))
    t0 = time.monotonic()
    if driver == "sgd-mllib":
        from asyncframework_tpu_torch.parallel import make_mesh

        Xh, yh = (X, y) if y is not None else X.global_arrays()
        sgd = MiniBatchSGD(  # reads cfg so --conf overlays apply here too
            gamma=cfg.gamma, batch_rate=cfg.batch_rate,
            num_iterations=cfg.num_iterations, loss=cfg.loss,
            seed=cfg.seed, snapshot_every=cfg.printer_freq,
            trace_sample=cfg.trace_sample,
        )
        # one rank a device of every process (a process group spans the
        # processes; on one process, this process's devices)
        mesh = (multihost.global_mesh() if multihost.is_initialized()
                else make_mesh(len(devices), devices=devices))
        w, losses, snaps = sgd.run(Xh, yh, mesh=mesh)
        elapsed = time.monotonic() - t0
        # the whole run is one fused loop, so per-iteration wall time is
        # uniform: spread elapsed evenly to keep the (ms, objective) output
        # contract comparable with the async drivers' trajectories
        per_iter_ms = elapsed * 1e3 / max(len(losses), 1)
        trajectory = [
            ((i + 1) * per_iter_ms, float(l)) for i, l in enumerate(losses)
        ]
        summary = {
            "driver": driver,
            "final_objective": float(losses[-1]) if len(losses) else None,
            "iterations": len(losses),
            "elapsed_s": elapsed,
            "snapshots": len(snaps),
        }
        if args.event_log:
            # the fused baseline has no per-task events; log the
            # trajectory so the report/history tooling still works on it
            from asyncframework_tpu_torch.solvers.instrumentation import (
                log_trajectory,
            )

            log_trajectory(args.event_log, trajectory, cfg.printer_freq)
    else:
        solver_cls = ASGD if driver.startswith("asgd") else ASAGA
        solver = solver_cls(X, y, cfg, devices=devices)
        if driver.endswith("-sync"):
            res = solver.run_sync()
        elif driver.endswith("-fused"):
            res = solver.run_fused()
            if args.event_log:
                # the fused loop has no per-task events; log the trajectory
                # so --event-log/--report keep working (same fallback as
                # the sgd-mllib baseline)
                from asyncframework_tpu_torch.solvers.instrumentation import (
                    log_trajectory,
                )

                log_trajectory(args.event_log, res.trajectory,
                               cfg.printer_freq)
        else:
            res = solver.run()
        trajectory = res.trajectory
        summary = {
            "driver": driver,
            "final_objective": res.final_objective,
            "accepted": res.accepted,
            "dropped": res.dropped,
            "rounds": res.rounds,
            "max_staleness": res.max_staleness,
            "avg_delay_ms": res.avg_delay_ms,
            "updates_per_sec": res.updates_per_sec,
            "elapsed_s": res.elapsed_s,
        }
        for key in ("workers_lost", "shards_moved", "speculated"):
            if key in res.extras:
                summary[key] = res.extras[key]
    if args.report:
        from asyncframework_tpu_torch.metrics.report import render_report

        render_report(args.event_log, args.report,
                      title=f"async-submit {driver} run")
        summary["report"] = args.report
    summary["trajectory"] = trajectory
    return summary


def run_async_cluster(args, conf, algo: str = "asgd"):
    """Multi-process ASGD/ASAGA over the DCN parameter server.

    Roles by ``ASYNCTPU_PROCESS_ID``: 0 = PS (binds the coordinator
    address's port; owns the model + updater semantics -- and for ASAGA the
    scalar-history table and sampling), 1..N-1 = worker processes
    (generate/load their shard slice locally, push gradients).  The PS
    prints the run summary; workers print a small role record.  Every
    process runs on :func:`resolve_cli_devices`' devices (the PS's model
    on the first).
    """
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.solvers import SolverConfig

    coord = os.environ["ASYNCTPU_COORDINATOR"]
    host, port_s = coord.rsplit(":", 1)
    nproc = int(os.environ.get("ASYNCTPU_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("ASYNCTPU_PROCESS_ID", "0"))
    if nproc < 2:
        raise SystemExit(f"DCN {algo} needs >= 2 processes (PS + workers)")

    apply_defaults(conf, CLUSTER_DEFAULTS)

    cfg = SolverConfig(
        num_workers=args.num_partitions,
        num_iterations=args.num_iterations,
        gamma=args.gamma,
        taw=args.taw,
        batch_rate=args.batch_rate,
        bucket_ratio=args.bucket_ratio,
        printer_freq=args.printer_freq,
        coeff=args.coeff,
        seed=args.seed,
        loss=args.loss,
    )
    for key, field in CONF_TO_FIELD.items():
        if conf.contains(key):
            setattr(cfg, field, conf.get(key))

    n_workers_procs = nproc - 1
    if n_workers_procs > cfg.num_workers:
        raise SystemExit(
            f"DCN {algo}: {n_workers_procs} worker processes but only "
            f"{cfg.num_workers} logical workers; every worker process "
            f"needs at least one partition"
        )
    devices = resolve_cli_devices(args.devices)
    if pid == 0:
        from asyncframework_tpu_torch.conf import ELASTIC_ENABLED, PS_SHARDS

        # sharded PS group (async.ps.shards > 1, ASGD only): this driver
        # process runs shard 0 (the primary -- wave gate, worker
        # supervision, eval plane) on the coordinator port and a
        # ShardGroup controller spawning + supervising the secondary
        # shard processes; workers resolve the map at HELLO.
        ps_shards = max(1, int(conf.get(PS_SHARDS)))
        if ps_shards > 1 and algo != "asgd":
            raise SystemExit("async.ps.shards > 1 supports asgd only "
                             "(ASAGA's PS-side sampling is range-global)")
        ckpt_dir = args.checkpoint_dir
        if ps_shards > 1 and not ckpt_dir:
            # sharded failover is checkpoint-based: a shard relaunched
            # with no durable state would serve a ZERO model for its
            # range mid-run (silent convergence loss).  "Kill any shard,
            # lose nothing" therefore defaults to a run-scoped dir
            # rather than degrading quietly; --checkpoint-dir overrides.
            import tempfile

            ckpt_dir = tempfile.mkdtemp(prefix="async-ps-shards-")
            print(f"async.ps.shards={ps_shards}: no --checkpoint-dir; "
                  f"using {ckpt_dir} for shard failover checkpoints",
                  file=sys.stderr)
        ckpt_path = None
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            ckpt_path = (
                os.path.join(ckpt_dir, "ps_shard0.npz")
                if ps_shards > 1
                else os.path.join(ckpt_dir, f"ps_{algo}.npz")
            )
        sup = None
        if conf.get(ELASTIC_ENABLED):
            from asyncframework_tpu_torch.parallel.supervisor import (
                ElasticSupervisor,
            )

            sup = ElasticSupervisor.from_conf(cfg.num_workers, conf)
        # PS-side observability spine: merges + trace spans (the PS's own
        # server-side stages plus the spans workers piggyback on PUSH) flow
        # bus -> event log -> live UI, same as the single-process solvers
        bus = writer = ui = live_state = None
        # cluster cfg is built from the recipe's positional args; the
        # observability flags live on argparse (plus conf overlays)
        ui_port = args.ui_port
        if ui_port is None and conf.contains("async.ui.port"):
            ui_port = int(conf.get("async.ui.port"))
        want_ui = ui_port is not None and ui_port >= 0
        if args.event_log or want_ui:
            from asyncframework_tpu_torch.metrics.bus import ListenerBus
            from asyncframework_tpu_torch.metrics.eventlog import (
                EventLogWriter,
            )

            bus = ListenerBus()
            if args.event_log:
                writer = EventLogWriter(args.event_log)
                bus.add_listener(writer)
            if want_ui:
                from asyncframework_tpu_torch.metrics.live import (
                    LiveStateListener,
                    LiveUIServer,
                )

                live_state = LiveStateListener(cfg.num_workers)
                bus.add_listener(live_state)
                ui = LiveUIServer(live_state, port=ui_port).start()
            bus.start()
        group = None
        controller = None
        try:
            ps_d = args.d
            shard_map_wire = None
            if ps_shards > 1:
                from asyncframework_tpu_torch.parallel.shardgroup import (
                    ShardGroup,
                    shard_ranges,
                )

                # the driver IS shard 0 (primary: wave gate, worker
                # supervision, eval plane) on the coordinator port; the
                # ShardGroup controller spawns, probes, and restarts the
                # secondary shard processes on this host, on this
                # process's device.  Workers learn the assembled map from
                # the primary's WELCOME.
                group = ShardGroup(
                    cfg, args.d, args.N, ps_shards, host=host, algo=algo,
                    checkpoint_dir=ckpt_dir,
                    indices=range(1, ps_shards),
                    fixed_entries={0: (host, int(port_s))},
                    conf_overlays=conf.to_dict(),
                    worker_procs=0,
                    stderr_dir=os.environ.get("ASYNC_SHARD_STDERR_DIR"),
                    device=devices[0].type,
                ).start()
                shard_map_wire = group.smap.to_wire()
                ps_d = shard_ranges(args.d, ps_shards)[0][1]
            ps = ps_dcn.ParameterServer(
                cfg, ps_d, args.N, device=devices[0], host="0.0.0.0",
                port=int(port_s), algo=algo, checkpoint_path=ckpt_path,
                supervisor=sup, bus=bus, shard_map=shard_map_wire,
                shard_index=0,
                shard_epochs=(group.epochs_wire()
                              if group is not None else None),
            )
            if conf.get("async.control.enabled"):
                # adaptive asynchrony controller on the primary PS:
                # telemetry -> decisions -> CTRL over WELCOME/PULL (and
                # SETMAP to the shard group, surviving promotions).
                # Started BEFORE ps.start(): the first WELCOME served
                # must already carry the CTRL payload, or a worker that
                # HELLOs in the gap never builds a ControlSink and
                # ignores every decision for the whole run.
                from asyncframework_tpu_torch.parallel.controller import (
                    AsyncController,
                )

                controller = AsyncController(ps, conf=conf,
                                             group=group).start()
            ps.start()
            ok = ps.wait_done(timeout_s=cfg.run_timeout_s)
            if not ok:
                # progress-aware diagnostic: who went silent, who
                # contributed
                print(ok.diagnostic, file=sys.stderr)
            if group is not None:
                # group-wide DONE backstop (workers' BYE already broadcast
                # FINISH best-effort); also stops treating child exits as
                # deaths so teardown is not mistaken for a crash
                group.finish()
            total = ps.collect_eval(n_workers_procs, timeout_s=120.0)
            trajectory = []
            if total is not None:
                times, _W = ps.snapshot_stack()
                # sharded eval stacks are tail-aligned worker-side (the
                # assembled trajectory is the min length across shards),
                # so the loss rows pair with the TAIL of the primary's
                # snapshot times; at shards=1 the slice is the whole list
                times = times[-len(total):]
                trajectory = [
                    (t, float(l) / args.N) for t, l in zip(times, total)
                ]
            ps.stop()
            summary = {
                "driver": f"{algo}-dcn-ps",
                "done": bool(ok),
                "accepted": ps.accepted,
                "dropped": ps.dropped,
                "max_staleness": ps.max_staleness,
                "resumed_from": ps.resumed_from_k,
                "recovery": sup.counters() if sup is not None else None,
                "trace_spans": ps.trace_spans,
                "final_objective": trajectory[-1][1] if trajectory else None,
                "trajectory": trajectory,
            }
            if group is not None:
                # same section /api/status serves (metrics/live.py reads
                # the active group) -- one assembly, no drift
                summary["ps_shards"] = group.status_section()
            if ui is not None:
                summary["ui_port"] = ui.port
            return summary
        finally:
            # teardown on EVERY path: a crash between start() and the
            # summary must still seal the event log (a .gz without its end
            # marker forces every later read through the torn-tail path)
            # and stop the UI/bus threads
            if controller is not None:
                controller.stop()
            if group is not None:
                group.stop()
            if ui is not None:
                ui.stop()
            if bus is not None:
                bus.stop()
            if writer is not None:
                writer.close()
    # ---------------------------------------------------------- worker role
    # per-process telemetry endpoint (async.metrics.port; -1 = off, so a
    # stock cluster run adds no ports): /metrics + /api/status on every
    # worker process, not just the PS/driver dashboard
    from asyncframework_tpu_torch.metrics.live import start_telemetry_from_conf

    start_telemetry_from_conf(f"worker-{pid}", labels={"proc": str(pid)})
    X, _y = load_data(args, cfg, devices, need_host=False)
    wids = [
        w for w in range(cfg.num_workers)
        if w % n_workers_procs == (pid - 1)
    ]
    shards = {w: X.shard(w) for w in wids}
    counts = ps_dcn.run_worker_process(
        host, int(port_s), wids, shards, cfg, args.d, args.N,
        eval_wid=wids[0], deadline_s=cfg.run_timeout_s, algo=algo,
        # every worker process holds the full (deterministic) dataset, so
        # it can materialize ANY shard on adoption orders from the PS
        shard_factory=X.shard,
        proc_token=f"dcn-{os.getpid()}-p{pid}",
        devices=devices,
    )
    return {
        "driver": f"{algo}-dcn-worker",
        "process_id": pid,
        "gradients": int(sum(counts.values())),
        "trajectory": [],
    }


_CLUSTER_ONLY_FLAGS = {"--master": 1, "--processes": 1,
                       "--wait-timeout": 1, "--supervise": 0, "--no-wait": 0}


def _submit_to_master(args, argv: Optional[List[str]]) -> int:
    """spark-submit --master parity: ship the recipe argv (cluster-only
    flags stripped) to the standalone master daemon; by default wait for a
    terminal state and exit 0 only on FINISHED."""
    from asyncframework_tpu_torch.deploy.client import _client, wait_app

    raw = list(sys.argv[1:] if argv is None else argv)
    submit_argv: List[str] = []
    i = 0
    while i < len(raw):
        tok = raw[i]
        flag = tok.split("=", 1)[0]
        if flag in _CLUSTER_ONLY_FLAGS:
            i += 1
            if _CLUSTER_ONLY_FLAGS[flag] and "=" not in tok:
                i += 1  # consume the flag's value token
            continue
        submit_argv.append(tok)
        i += 1
    cl = _client(args.master)
    app_id = cl.submit(submit_argv, num_processes=args.processes,
                       supervise=args.supervise)
    print(json.dumps({"app_id": app_id, "master": args.master,
                      "num_processes": args.processes,
                      "supervise": bool(args.supervise)}))
    if args.no_wait:
        return 0
    try:
        st = wait_app(args.master, app_id, timeout_s=args.wait_timeout)
    except TimeoutError:
        print(json.dumps({"app_id": app_id, "state": "TIMEOUT",
                          "wait_timeout_s": args.wait_timeout}))
        return 1
    print(json.dumps({"app_id": app_id, "state": st["state"],
                      "exits": st["exits"]}))
    return 0 if st["state"] == "FINISHED" else 1


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.master:
        return _submit_to_master(args, argv)
    conf = parse_conf_overlays(args.conf)
    if args.trace_sample is not None:
        # install in the process conf too: the DCN worker/PS paths resolve
        # their recorders from async.trace.sample, not SolverConfig
        conf.set("async.trace.sample", args.trace_sample)
    summary = run_driver(args, conf)
    trajectory = summary.pop("trajectory")
    if not args.quiet:
        for t_ms, obj in trajectory:
            print(f"({t_ms:.1f},{obj:.8g})")
    if args.output:
        with open(args.output, "w") as f:
            f.write("ms,objective\n")
            for t_ms, obj in trajectory:
                f.write(f"{t_ms:.3f},{obj:.10g}\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

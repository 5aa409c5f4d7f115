"""One role of the DCN parameter-server plane as its own process.

    PS_ROLE=ps PS_CONFIG=epsilon PS_ALGO=asgd PS_NUM_WORKER_PROCS=2 \\
        python -m asyncframework_tpu_torch.tools.ps_child
    PS_ROLE=worker PS_PORT=<port> PS_WORKER_ID=0 PS_NUM_WORKER_PROCS=2 \\
        PS_CONFIG=epsilon PS_ALGO=asgd \\
        python -m asyncframework_tpu_torch.tools.ps_child

A worker given ``PS_PORT_FILE`` instead of ``PS_PORT`` builds its data
first and then waits for the file (``tools/dcn.py::launch`` starts the
workers beside the PS and writes it once the PS announces its port).

The role split of ``cli.py``'s ``run_async_cluster`` (process 0 as the
PS) as a measuring harness, and the twin of ``tests/ps_dcn_child.py``.  Role ``ps`` binds the server, prints
``{"port": ...}`` on its first stdout line, waits for the run to finish,
collects the workers' evaluations and prints one result line.  Role
``worker`` builds the deployment's data on its device, keeps its logical
workers' shards (``wid % PS_NUM_WORKER_PROCS == PS_WORKER_ID``, or
``PS_WIDS=4,5``), runs them (``parallel/ps_dcn.py::run_worker_process``),
scores the PS's snapshots over its shards and prints one result line with
its kernel launches (counted from 0 before the run), its gradients and its
peak device memory.

Before either role runs, the cluster path's data-plane defaults
(``cli.py``'s ``DATA_PLANE_DEFAULTS``) are set where the environment sets
nothing: delta pulls, pipeline depth 2, the native codecs and the
shared-memory ring.  Any of
them can be overridden with the conf's environment names, e.g.
``ASYNCTPU_ASYNC_PIPELINE_DEPTH=0``.  Each role then starts its telemetry
from the conf (``metrics/live.py::start_telemetry_from_conf``, as
``cli.py`` does): with ``ASYNCTPU_ASYNC_METRICS_PORT=0`` it serves
``/metrics`` and ``/api/status`` on an ephemeral port, and its result line
carries ``telemetry``: its own endpoints read back at the end (HTTP status,
the samples the strict Prometheus parser read, the status sections).  With
``ASYNCTPU_ASYNC_CONVERGENCE_SAMPLE=N`` the workers sample their shard's
loss every N-th update of each logical worker (``conv_samples`` in their
line, counted where each is taken; ``counts``: the updates of each logical
worker) and the PS's line carries its convergence history's summary
(``convergence``).

A sharded group (``async.ps.shards`` = N > 1, e.g.
``ASYNCTPU_ASYNC_PS_SHARDS=3``): role ``ps`` runs the primary shard (range
0, the wave gate and the evaluation) in its own process and a
:class:`~asyncframework_tpu_torch.parallel.shardgroup.ShardGroup` that
spawns and supervises shards 1..N-1 (``python -m
asyncframework_tpu_torch.parallel.shardgroup``, on the same device), hands
every member the map, and prints the primary's port; workers resolve the
map at HELLO.  With ``async.fence.enabled`` every shard runs under a
minted epoch.  ``PS_CHECKPOINT_DIR`` gives each shard its checkpoint
(``ps_shard{i}.npz``, saved every ``PS_PRINTER_FREQ`` of its updates), and
``PS_KILL_SHARD=i PS_KILL_AT=k`` SIGKILLs shard ``i`` (1..N-1) once the
primary has accepted ``k`` updates: the group relaunches it from its
checkpoint.  The PS's line then carries ``shards``: each shard's result
(pushes, accepted, dropped, dedup hits, epoch, fenced rejects, merges,
wire bytes, peak memory, restarts, promotion, the checkpointed k it
resumed from) and the kill.

With ``async.ps.standby=1`` every shard, the in-process primary
included, gets a warm standby child that its primary streams to
(``parallel/replication.py``), and a killed primary is PROMOTED over
(``kill`` then carries ``promote_s``, kill to promotion).  Its line
carries ``standby``: shard 0's replication lag sampled through the run,
with ``PS_STANDBY_READER=1`` a SUBSCRIBE reader's replies from the last
shard's standby (shapes, versions behind its primary, freshness age; its
frames are left out of the wire totals), and after the run each
standby's model read by SUBSCRIBE against its primary's at the same
clock (``mirrors``).  With ``async.control.enabled`` the PS process runs
the adaptive controller on the primary (``parallel/controller.py``),
fanning its decisions out to the group, and its line carries ``control``:
the counters, the knobs' values and changes, the decision log, the damp
factors its drain applied and whether every actuated value lay within its
declared bounds.  A worker installs the fault schedule of its conf
(``async.net.fault.schedule``): a PUSH delay there makes it a
deterministic straggler.

A worker's mesh plane: ``--mesh N`` (``async.mesh.devices``) computes
each gradient over a ``dp`` mesh of N ranks of ``--devices`` (the worker
process's device list, comma separated, e.g. ``cuda:0,cuda:0,cuda:0,
cuda:0`` for four ranks on one card; default every CUDA device), one B1
launch a rank; its line then carries ``mesh``: the ranks, the shards
placed and the mesh steps run (``parallel/ps_dcn.py::mesh_counts``).

Environment: ``PS_CONFIG`` (``small``: 4,096 x 24, the CPU tests' size;
``epsilon``: 400,000 x 2,000 f32; ``rcv1``: rcv1's padded-ELL shape),
``PS_ALGO`` (``asgd``/``asaga``), ``PS_DEVICE`` (``cuda``, the default, or
``cpu``), ``PS_NUM_ITER``, ``PS_GAMMA``, ``PS_PRINTER_FREQ``, ``PS_EVAL=0``
(no evaluation), ``PS_ELASTIC=1`` (an elastic supervisor on the PS,
``PS_DEAD_AFTER_S``), ``PS_CHECKPOINT`` (the PS's checkpoint path),
``PS_BIND_PORT``, ``PS_LINGER_S`` (seconds the PS, and a group's shards,
go on serving SUBSCRIBE after the run and its evaluation: serving
replicas read the final version from it, ``tools/serve.py``).  The PS's
record carries its SUBSCRIBE replies by shape, their model bytes and the
RELAY_OFFERs its root offer loop delivered.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from asyncframework_tpu_torch import cli
from asyncframework_tpu_torch import conf as conf_mod
from asyncframework_tpu_torch import native_build
from asyncframework_tpu_torch.net import frame
from asyncframework_tpu_torch.parallel import ps_dcn, shardgroup
from asyncframework_tpu_torch.solvers import SolverConfig
from asyncframework_tpu_torch.tools import runs


#: each deployment: (n, d, workers), its solver settings, and the gamma of
#: each algorithm (epsilon: chip_smoke.py phases 3 and 5; rcv1:
#: tools/rcv1.py: bench.py's ASGD recipe, ASAGA's step size chosen on the
#: card; small: tests/test_ps_dcn.py)
CONFIGS = {
    "small": dict(shape=(4_096, 24, 8), gamma={"asgd": 1.2, "asaga": 0.3},
                  iters=400, batch_rate=0.3, bucket_ratio=0.5,
                  printer_freq=50, calibration_iters=20),
    "epsilon": dict(shape=(400_000, 2_000, 8),
                    gamma={"asgd": 100.0, "asaga": 0.5}, iters=1_000,
                    batch_rate=0.1, bucket_ratio=0.7, printer_freq=25,
                    calibration_iters=None),
    "rcv1": dict(shape=(697_641, 47_236, 8),
                 gamma={"asgd": 2361.8, "asaga": 50.0}, iters=1_200,
                 batch_rate=0.05, bucket_ratio=0.7, printer_freq=50,
                 calibration_iters=100),
}


def apply_cluster_defaults() -> None:
    """Set the cluster path's data-plane defaults (``cli.py``'s
    :data:`~asyncframework_tpu_torch.cli.DATA_PLANE_DEFAULTS`) on the
    process conf where neither the conf nor the environment holds a value.
    Its other defaults (convergence samples, fencing, the controller) are
    each arm's own choice here, by the conf's environment names."""
    from asyncframework_tpu_torch.conf import global_conf

    cli.apply_defaults(global_conf(), cli.DATA_PLANE_DEFAULTS)


def refuse_ui_port() -> None:
    """The cluster's live dashboard (``async.ui.port``) is served by the
    CLI's PS process (``python -m asyncframework_tpu_torch.cli``), not by
    these roles: set here it is refused, never ignored."""
    from asyncframework_tpu_torch.conf import UI_PORT

    port = int(conf_mod.global_conf().get(UI_PORT))
    if port >= 0:
        raise SystemExit(
            f"async.ui.port={port}: the cluster's dashboard is served by "
            "the CLI's PS process (python -m asyncframework_tpu_torch.cli "
            "... --ui-port P); a ps_child role serves async.metrics.port")


def config(name: str, algo: str, iters: int = 0, gamma: float = 0.0,
           printer_freq: int = 0) -> SolverConfig:
    """The deployment's solver settings (``iters``/``gamma``/
    ``printer_freq`` override)."""
    c = CONFIGS[name]
    if algo not in c["gamma"]:
        raise ValueError(f"{name} has no {algo} recipe")
    return SolverConfig(
        num_workers=c["shape"][2], num_iterations=iters or c["iters"],
        gamma=gamma or c["gamma"][algo], taw=2**31 - 1,
        batch_rate=c["batch_rate"], bucket_ratio=c["bucket_ratio"],
        printer_freq=printer_freq or c["printer_freq"], seed=42,
        calibration_iters=c["calibration_iters"], run_timeout_s=600.0)


def dataset(name: str, device):
    """The deployment's data, generated on ``device`` from its seed."""
    n, d, nw = CONFIGS[name]["shape"]
    if name == "rcv1":
        from asyncframework_tpu_torch.tools import rcv1

        return rcv1.dataset(device)
    from asyncframework_tpu_torch.data.sharded import ShardedDataset

    seed = 11 if name == "small" else 7
    return ShardedDataset.generate_on_device(n, d, nw, devices=[device],
                                             seed=seed, noise=0.01)


def _peak_bytes(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def watch_start(ps, nw: int) -> dict:
    """Times of the run's first pull and of the moment every logical
    worker has pulled (with the accepted count then), taken by a thread
    polling the PS every millisecond until then."""
    marks: dict = {}

    def poll():
        while not ps._done.is_set():
            if "first" not in marks and ps._last_contact:
                marks["first"] = time.monotonic()
            if len(ps._last_contact) >= nw:
                marks["all"] = time.monotonic()
                marks["accepted_at_all"] = ps.accepted
                return
            time.sleep(0.001)

    t = threading.Thread(target=poll, name="ps-start-watch", daemon=True)
    t.start()
    marks["thread"] = t
    return marks


def ps_summary(ps, marks: dict, t_done: float, n: int,
               total: "np.ndarray | None") -> dict:
    """The PS's record of a finished run: updates/s over the window in
    which every logical worker was running, accepted and dropped, the
    staleness, the wire, the merge drain, the trajectory."""
    from asyncframework_tpu_torch.metrics import timeseries

    t_all = marks.get("all", marks.get("first", t_done))
    window = max(t_done - t_all, 1e-9)
    wire = frame.bytes_totals()
    rec = {
        "accepted": ps.accepted, "dropped": ps.dropped,
        "max_staleness": ps.max_staleness,
        "elapsed_s": t_done - marks.get("first", t_done),
        "updates_per_sec": (ps.accepted - marks.get("accepted_at_all", 0))
        / window,
        "pushes": int(sum(ps.pushes_by_wid.values())),
        "dedup_hits": ps.dedup_hits,
        "accepted_by_wid": {str(w): c for w, c in ps.accepted_by_wid.items()},
        "push_bytes": ps.push_bytes, "pull_model_bytes": ps.pull_model_bytes,
        "wire_bytes_sent": int(wire.get("sent", 0)),
        "wire_bytes_recv": int(wire.get("recv", 0)),
        "repl_bytes_sent": int(wire.get("sent.REPL_APPEND", 0)
                               + wire.get("sent.REPL_SYNC", 0)),
        "staleness_counts": {str(t): c for t, c in
                             sorted(ps.staleness_counts.items())},
        "pull_replies": dict(ps.pull_replies),
        "subscribe_replies": dict(ps.subscribe_replies),
        "subscribe_model_bytes": ps.subscribe_model_bytes,
        "relay_offers": ps.relay_offers,
        "merge_batches": ps.merge_batches, "merge_merged": ps.merge_merged,
        "merge_batch_max": ps.merge_batch_max,
        "resumed_from": ps.resumed_from_k,
        "native": native_build.native_totals(),
        "pipeline": ps_dcn.pipeline_totals(),
        "peak_device_bytes": _peak_bytes(ps.device),
        "convergence": timeseries.convergence().summary(),
        "trajectory": None,
    }
    if total is not None:
        times, _W = ps.snapshot_stack()
        rec["trajectory"] = [[t, float(v) / n] for t, v in zip(times, total)]
    return rec


def _elastic_supervisor(nw: int):
    """The PS's elastic supervisor when ``PS_ELASTIC=1``, else None."""
    if os.environ.get("PS_ELASTIC") != "1":
        return None
    from asyncframework_tpu_torch.parallel.supervisor import (
        ElasticSupervisor,
    )

    return ElasticSupervisor(
        nw, dead_after_s=float(os.environ.get("PS_DEAD_AFTER_S", "2.0")),
        check_interval_s=0.2)


def run_group(name: str, algo: str, device, nprocs: int, shards: int,
              iters: int = 0, gamma: float = 0.0,
              printer_freq: int = 0) -> dict:
    """Role ``ps`` of a sharded group: the primary shard in this process,
    shards 1..``shards``-1 as children of a ShardGroup; serve one run to
    its end and return its record (the primary's, plus ``shards``)."""
    import signal

    from asyncframework_tpu_torch.conf import global_conf

    def set_keys(conf) -> dict:
        """The conf's keys set here or in the environment, resolved: the
        children and the controller run under this process's switches
        (fencing, the data plane's defaults)."""
        return {k: conf.get(k) for k in conf_mod.registry()
                if conf.contains(k)}

    n, d, nw = CONFIGS[name]["shape"]
    cfg = config(name, algo, iters, gamma, printer_freq)
    ckdir = os.environ.get("PS_CHECKPOINT_DIR") or None
    if ckdir:
        os.makedirs(ckdir, exist_ok=True)
    lo, hi = shardgroup.shard_ranges(d, shards)[0]
    sup = _elastic_supervisor(nw)
    ps = ps_dcn.ParameterServer(
        cfg, hi - lo, n, device=device,
        port=int(os.environ.get("PS_BIND_PORT", "0")), algo=algo,
        checkpoint_path=(os.path.join(ckdir, "ps_shard0.npz")
                         if ckdir else None),
        supervisor=sup, shard_index=0).start()
    group = shardgroup.ShardGroup(
        cfg, d, n, shards, indices=range(1, shards),
        fixed_entries={0: ("127.0.0.1", ps.port)}, checkpoint_dir=ckdir,
        conf_overlays=set_keys(global_conf()), device=device.type,
        dead_after_s=float(os.environ.get("PS_DEAD_AFTER_S", "2.0")),
        check_interval_s=0.2, stderr_dir=os.environ.get("PS_STDERR_DIR"),
        spawn_timeout_s=300.0, standby_indices=range(shards))
    t_spawn = time.monotonic()
    controller = None
    reader = None
    try:
        group.start()
        spawn_s = time.monotonic() - t_spawn
        # the primary hands the assembled map and epochs to every HELLO
        ps.shard_map = group.smap.to_wire()
        ps.shard_epochs = group.epochs_wire()
        if group.standbys:
            # the in-process primary's own standby: its stream starts here
            ps.set_standby_map(group.standbys_wire())
        if global_conf().get(conf_mod.CONTROL_ENABLED):
            from asyncframework_tpu_torch.parallel.controller import (
                AsyncController,
            )

            # before any worker learns the port: the first WELCOME must
            # already carry the CTRL payload
            controller = AsyncController(ps, conf=global_conf(),
                                         group=group).start()
        if group.standbys:
            reader = StandbyReader(
                ps, group, shards - 1,
                os.environ.get("PS_STANDBY_READER") == "1").start()
        marks = watch_start(ps, nw)
        kill = {}
        kill_shard = int(os.environ.get("PS_KILL_SHARD", "0"))
        kill_at = int(os.environ.get("PS_KILL_AT", "0"))
        if kill_shard:
            def killer():
                while not ps._done.is_set() and ps.accepted < kill_at:
                    time.sleep(0.001)
                if ps._done.is_set():
                    return
                kill.update(shard=kill_shard, pid=group.pid_of(kill_shard),
                            accepted_at_kill=ps.accepted,
                            epoch_before=group.epoch_of(kill_shard))
                os.kill(kill["pid"], signal.SIGKILL)
                t_kill = time.monotonic()
                # the relaunch or the promotion, as the controller counts
                # them
                while (group.restarts_of(kill_shard) < 1
                       and group.promotions_of(kill_shard) < 1
                       and time.monotonic() - t_kill < 120.0):
                    time.sleep(0.005)
                key = ("promote_s" if group.promotions_of(kill_shard)
                       else "restart_s")
                kill[key] = time.monotonic() - t_kill
                kill["accepted_at_recovery"] = ps.accepted

            from asyncframework_tpu_torch.utils.threads import guarded

            threading.Thread(target=guarded(killer, "ps-shard-killer"),
                             name="ps-shard-killer", daemon=True).start()
        print(json.dumps({"port": ps.port}), flush=True)
        done = ps.wait_done(timeout_s=cfg.run_timeout_s)
        t_done = time.monotonic()
        marks["thread"].join(timeout=1.0)
        if reader is not None:
            reader.stop()
        total = None
        if os.environ.get("PS_EVAL") != "0":
            total = ps.collect_eval(num_worker_procs=nprocs,
                                    timeout_s=120.0)
        group.finish()
        members = [{"shard": 0, "accepted": ps.accepted,
                    "dropped": ps.dropped, "clock": ps._clock,
                    "pushes": int(sum(ps.pushes_by_wid.values())),
                    "dedup_hits": ps.dedup_hits, "epoch": ps.epoch,
                    "fenced_rejects": ps.fenced_rejects,
                    "max_staleness": ps.max_staleness,
                    "staleness_counts": {
                        str(t): c
                        for t, c in sorted(ps.staleness_counts.items())},
                    "merge_batches": ps.merge_batches,
                    "merge_merged": ps.merge_merged, "restarts": 0,
                    "resumed_from": ps.resumed_from_k, "done": bool(done)}]
        for i in range(1, shards):
            res = group.result_of(i, timeout_s=60.0) or {}
            res["restarts"] = group.restarts_of(i)
            res["promotions"] = group.promotions_of(i)
            members.append(res)
        if kill:
            kill["epoch_after"] = group.epoch_of(kill_shard)
        standby = None
        # the frames of the diagnostics (the reader's, the mirror check's)
        # are left out of the run's wire cost: both sides of each are
        # counted here (the reader's primary is one of the members)
        diag_bytes = reader.wire_bytes() if reader is not None else 0
        if group.standbys:
            t_diag = frame.thread_bytes()
            mirrors = mirror_check(group, shards)
            wire = group.standbys_wire() or []
            for entry in wire:
                # a standby spawned after the group's FINISH learns DONE
                # here, and prints its result line
                if entry:
                    try:
                        shardgroup.finish_endpoint(str(entry[0]),
                                                   int(entry[1]))
                    except (ConnectionError, OSError):
                        pass
            diag_bytes += frame.thread_bytes() - t_diag
            sb_results = [group.standby_result_of(i, 30.0) or {}
                          for i in range(shards)]
            standby = {**reader.record(), "standbys": wire,
                       "promotions": group.promotions, "mirrors": mirrors,
                       "peak_device_bytes": [r.get("peak_device_bytes")
                                             for r in sb_results]}
        control = (control_record(controller, ps)
                   if controller is not None else None)
        rec = {"role": "ps", "config": name, "algo": algo,
               "done": bool(done),
               "diagnostic": None if done else str(done),
               "recovery": sup.counters() if sup is not None else None,
               "n_shards": shards,
               "fence": bool(ps.epoch), "spawn_s": spawn_s,
               "shards": members, "kill": kill or None,
               "shard_totals": shardgroup.shard_totals(),
               "standby": standby, "control": control,
               "wire_bytes_diagnostic": diag_bytes,
               **ps_summary(ps, marks, t_done, n, total)}
        linger()
        # each secondary's counts after its last apply (ROADMAP C13): a
        # push in flight at FINISH lands after its result line
        group.stop()
        for i in range(1, shards):
            final = group.final_result_of(i, timeout_s=10.0) or {}
            members[i].update({k: final[k] for k in (
                "accepted", "dropped", "clock", "pushes") if k in final})
    finally:
        if reader is not None:
            reader.stop()
        if controller is not None:
            controller.stop()
        group.stop()
        ps.stop()
    return rec


class StandbyReader:
    """Shard 0's replication lag (``standby_lag``, the in-process
    primary's stream) sampled every 20 ms while the run goes; with
    ``subscribe``, also a SUBSCRIBE reader on one shard's standby: each
    round reads the standby (``have=``-negotiated, counted by reply
    shape) and the shard's primary, and keeps the versions the standby's
    reply is behind the primary's and its freshness age.  Its frames are
    counted (:meth:`wire_bytes`) so that the run's wire cost leaves them
    out."""

    def __init__(self, ps, group, index: int, subscribe: bool = True):
        self.ps, self.group, self.index = ps, group, int(index)
        self.subscribe = subscribe
        self.behind: list = []
        self.age_ms: list = []
        self.lag0: list = []
        self.errors = 0
        self.rounds = 0
        self.shapes: dict = {}
        # the reader's frames: all of them (this process's side) and
        # those with the primary (counted again on the primary's side)
        self.own_bytes = 0
        self.primary_bytes = 0
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "StandbyReader":
        from asyncframework_tpu_torch.utils.threads import guarded

        self._thread = threading.Thread(
            target=guarded(self._run, "standby-reader"),
            name="standby-reader", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = frame.thread_bytes()
        try:
            self._rounds()
        finally:
            self.own_bytes = frame.thread_bytes() - t0

    def _rounds(self) -> None:
        sub = prim = None
        while not self._stop.wait(0.02):
            repl = self.ps.repl
            if repl is not None and repl.synced:
                self.lag0.append(repl.lag_versions())
            if not self.subscribe:
                continue
            wire = self.group.standbys_wire() or []
            entry = wire[self.index] if self.index < len(wire) else None
            if entry is None:
                continue
            try:
                if sub is None or sub.port != int(entry[1]):
                    sub = ps_dcn.PSClient(str(entry[0]), int(entry[1]),
                                          pull_mode="delta", timeout_s=5.0)
                if prim is None:
                    host, port = self.group.smap.entries[self.index][:2]
                    prim = ps_dcn.PSClient(str(host), int(port),
                                           timeout_s=5.0)
                got = sub.subscribe(0)
                t_prim = frame.thread_bytes()
                try:
                    head = prim.subscribe(0)
                finally:
                    self.primary_bytes += frame.thread_bytes() - t_prim
            except (ConnectionError, OSError):
                self.errors += 1
                sub = prim = None
                continue
            self.rounds += 1
            self.behind.append(max(0, int(head[2]) - int(got[0])))
            self.age_ms.append(float(got[4]))
        for c in (sub, prim):
            if c is not None:
                t_bye = frame.thread_bytes()
                try:
                    c.bye()
                except (ConnectionError, OSError):
                    pass
                if c is prim:
                    self.primary_bytes += frame.thread_bytes() - t_bye
        if sub is not None:
            self.shapes = dict(sub.pull_wenc)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def wire_bytes(self) -> int:
        """The reader's frames as the run's wire totals count them: its
        own side, and the primary's side of its rounds with the
        primary."""
        return self.own_bytes + self.primary_bytes

    def record(self) -> dict:
        def stats(xs):
            if not xs:
                return None
            a = np.asarray(xs, np.float64)
            return {"n": int(a.size), "p50": float(np.median(a)),
                    "p99": float(np.percentile(a, 99)),
                    "max": float(a.max())}

        return {"reader_shard": self.index, "reader_rounds": self.rounds,
                "reader_errors": self.errors,
                "reader_wire_bytes": self.wire_bytes(),
                "reader_reply_shapes": self.shapes,
                "reader_versions_behind": stats(self.behind),
                "reader_age_ms": stats(self.age_ms),
                "standby_lag_shard0": stats(self.lag0)}


def mirror_check(group, shards: int, timeout_s: float = 30.0) -> list:
    """After the run: each standby's model, read by SUBSCRIBE, against its
    primary's at the same clock and version (``torch.equal`` of the two
    f32 vectors), waiting with a deadline for a standby respawned late in
    the run (behind a promoted primary) to announce, and for each stream
    to drain."""
    out = []
    deadline = time.monotonic() + timeout_s
    while (not all(group.standbys_wire() or [None])
           and time.monotonic() < deadline):
        time.sleep(0.1)
    wire = group.standbys_wire() or []
    for i in range(shards):
        entry = wire[i] if i < len(wire) else None
        if entry is None:
            out.append({"shard": i, "standby": None, "equal": False})
            continue
        host, port = group.smap.entries[i][:2]
        prim = ps_dcn.PSClient(str(host), int(port), timeout_s=10.0)
        sb = ps_dcn.PSClient(str(entry[0]), int(entry[1]), timeout_s=10.0)
        deadline = time.monotonic() + timeout_s
        while True:
            # the same clock AND the same served version: a SUBSCRIBE that
            # races the standby's REPL_SYNC install serves the version it
            # began building (stamped with its own, older ts) beside the
            # new clock; the next one serves the installed model
            p_got, s_got = prim.subscribe(0), sb.subscribe(0)
            if ((p_got[2] == s_got[2] and p_got[0] == s_got[0])
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
        for c in (prim, sb):
            c.bye()
        w_p, w_s = torch.from_numpy(p_got[1]), torch.from_numpy(s_got[1])
        out.append({
            "shard": i, "primary_clock": int(p_got[2]),
            "standby_clock": int(s_got[2]), "primary_ts": int(p_got[0]),
            "standby_ts": int(s_got[0]),
            "max_abs_diff": float((w_p - w_s).abs().max()),
            "equal": bool(p_got[2] == s_got[2] and p_got[0] == s_got[0]
                          and torch.equal(w_p, w_s))})
    return out


def control_record(controller, ps) -> dict:
    """The controller's record: its counters, knobs and decision log,
    the damp factors the primary's drain applied, and whether every
    actuated value lay within its declared bounds."""
    import math

    from asyncframework_tpu_torch.parallel import controller as ctrl_mod

    status = controller.status()
    log = controller.decision_log()
    p = max(1, int(controller.cfg.num_workers))
    lo_b = max(1.0, math.ceil(controller._bounds["async.bucket.ratio"][0]
                              * p))
    hi_b = float(controller.b_conf)
    lo_m, hi_m = controller._bounds["async.push.merge"]
    lo_d, hi_d = controller._bounds["async.pipeline.depth"]
    bounds = {"b": (lo_b, hi_b),
              "merge": (lo_m, min(hi_m, float(controller.merge_conf))),
              "depth": (lo_d, min(hi_d, float(controller.depth_conf)))}

    def within(d) -> bool:
        if d["knob"] == "wdamp":
            return all(controller.damp_floor <= f <= 1.0
                       for f in dict(d["to"]).values())
        lo, hi = bounds[d["knob"]]
        return lo <= float(d["to"]) <= hi

    return {"totals": ctrl_mod.control_totals(), "seq": status["seq"],
            "knobs": status["knobs"], "damp_law": status["damp"],
            "decisions": log,
            "actuated_within_bounds": all(within(d) for d in log),
            "damped_applies": ps.damped_applies,
            "damp_mean": (ps.damp_sum / ps.damped_applies
                          if ps.damped_applies else None),
            "damp_min": ps.damp_min if ps.damped_applies else None,
            "ctrl_stale_rejects": ps.ctrl_stale_rejects}


def run_ps(name: str, algo: str, device, nprocs: int, iters: int = 0,
           gamma: float = 0.0, printer_freq: int = 0) -> dict:
    """Role ``ps``: serve one run to its end and return its record (a
    sharded group's when ``async.ps.shards`` > 1)."""
    from asyncframework_tpu_torch.conf import PS_SHARDS, global_conf

    shards = int(global_conf().get(PS_SHARDS))
    if shards > 1:
        return run_group(name, algo, device, nprocs, shards, iters, gamma,
                         printer_freq)
    n, d, nw = CONFIGS[name]["shape"]
    cfg = config(name, algo, iters, gamma, printer_freq)
    sup = _elastic_supervisor(nw)
    ps = ps_dcn.ParameterServer(
        cfg, d, n, device=device,
        port=int(os.environ.get("PS_BIND_PORT", "0")), algo=algo,
        checkpoint_path=os.environ.get("PS_CHECKPOINT") or None,
        supervisor=sup).start()
    marks = watch_start(ps, nw)
    print(json.dumps({"port": ps.port}), flush=True)
    done = ps.wait_done(timeout_s=cfg.run_timeout_s)
    t_done = time.monotonic()
    marks["thread"].join(timeout=1.0)
    total = None
    if os.environ.get("PS_EVAL") != "0":
        total = ps.collect_eval(num_worker_procs=nprocs, timeout_s=120.0)
    rec = {"role": "ps", "config": name, "algo": algo, "done": bool(done),
           "diagnostic": None if done else str(done),
           "recovery": sup.counters() if sup is not None else None,
           **ps_summary(ps, marks, t_done, n, total)}
    linger()
    ps.stop()
    return rec


def linger() -> None:
    """Go on serving for ``PS_LINGER_S`` seconds after the run (0 by
    default): readers of the final version (serving replicas) get it from
    a PS that has not stopped yet."""
    time.sleep(float(os.environ.get("PS_LINGER_S", "0")))


def ps_port(timeout_s: float = 600.0) -> int:
    """The PS's port: ``PS_PORT``, else the file ``PS_PORT_FILE`` that the
    launcher writes (whole, by a rename) once the PS has announced it."""
    if "PS_PORT" in os.environ:
        return int(os.environ["PS_PORT"])
    path = os.environ["PS_PORT_FILE"]
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no PS port in {path} after {timeout_s} s")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def run_worker(name: str, algo: str, device, port_of, wids, nprocs: int,
               iters: int = 0, gamma: float = 0.0, host: str = "127.0.0.1",
               evaluate: bool = True, devices=None) -> dict:
    """Role ``worker``: run ``wids`` against the PS at ``host`` and the
    port ``port_of()`` gives once the data is built, and return this
    process's record; ``devices`` is the process's device list for the
    mesh plane (default every CUDA device)."""
    n, d, _nw = CONFIGS[name]["shape"]
    cfg = config(name, algo, iters, gamma)
    ds = dataset(name, device)
    shards = {w: ds.shard(w) for w in wids}
    port = port_of()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    runs.zero_counts()
    ps_dcn.reset_conv_samples_taken()
    ps_dcn.reset_mesh_counts()
    shardgroup.reset_shard_totals()
    t0 = time.monotonic()
    counts = ps_dcn.run_worker_process(
        host, port, list(wids), shards, cfg, d, n,
        eval_wid=wids[0] if evaluate else None, deadline_s=cfg.run_timeout_s,
        algo=algo, shard_factory=ds.shard,
        proc_token=f"ps-child-{os.getpid()}", devices=devices)
    rec = {"role": "worker", "config": name, "algo": algo,
           "wids": list(wids), "gradients": int(sum(counts.values())),
           "counts": {str(w): c for w, c in counts.items()},
           "conv_samples": ps_dcn.conv_samples_taken(),
           "seconds": time.monotonic() - t0,
           # one warm-up launch a distinct shard shape before the first pull
           "warmups": len({tuple((s.cols if hasattr(s, "cols") else s.X).shape)
                           for s in shards.values()}),
           "launches": runs.counts(), "native": native_build.native_totals(),
           "pipeline": ps_dcn.pipeline_totals(),
           # the sharded facade's counts (empty against a single PS)
           "shard_totals": shardgroup.shard_totals(),
           # the mesh plane's counts (empty without a mesh)
           "mesh": ps_dcn.mesh_counts(),
           "peak_device_bytes": _peak_bytes(device)}
    return rec


def read_own_telemetry() -> "dict | None":
    """This process's telemetry endpoint read back over HTTP: the status
    of ``/metrics`` and ``/api/status``, the samples the strict
    Prometheus parser read and the status sections (None when no
    endpoint serves)."""
    import urllib.request

    from asyncframework_tpu_torch.metrics import live, prom

    port = live.telemetry_port()
    if port is None:
        return None
    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        m_status, body = r.status, r.read().decode()
    with urllib.request.urlopen(f"{base}/api/status", timeout=10) as r:
        s_status, status = r.status, json.loads(r.read().decode())
    return {"port": port, "metrics_status": m_status,
            "metrics_samples": len(prom.parse_exposition(body)),
            "status_status": s_status, "sections": sorted(status)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, default=None,
                    help="a worker's mesh ranks (async.mesh.devices)")
    ap.add_argument("--devices", default=None,
                    help="the worker process's device list, comma "
                         "separated (default every CUDA device)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from asyncframework_tpu_torch.metrics.live import (
        start_telemetry_from_conf,
    )

    args = parse_args(argv)
    if args.mesh is not None:
        conf_mod.global_conf().set("async.mesh.devices", args.mesh)
    mesh_list = ([torch.device(x) for x in args.devices.split(",")]
                 if args.devices else None)
    apply_cluster_defaults()
    if os.environ.get("PS_ROLE") == "worker":
        # a worker's fault schedule from the conf or the environment
        # (async.net.fault.schedule), as a chaos run configures daemons
        from asyncframework_tpu_torch.net import faults

        faults.maybe_install_from_conf()
    # before either role builds its data
    refuse_ui_port()
    role = os.environ["PS_ROLE"]
    name = os.environ.get("PS_CONFIG", "small")
    algo = os.environ.get("PS_ALGO", "asgd")
    device = torch.device(os.environ.get("PS_DEVICE", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    nprocs = int(os.environ["PS_NUM_WORKER_PROCS"])
    iters = int(os.environ.get("PS_NUM_ITER", "0"))
    gamma = float(os.environ.get("PS_GAMMA", "0"))
    printer_freq = int(os.environ.get("PS_PRINTER_FREQ", "0"))
    if role == "ps":
        srv = start_telemetry_from_conf("ps")
        rec = run_ps(name, algo, device, nprocs, iters, gamma, printer_freq)
    else:
        pid = int(os.environ["PS_WORKER_ID"])
        srv = start_telemetry_from_conf(f"worker-{pid}",
                                        labels={"proc": str(pid)})
        nw = CONFIGS[name]["shape"][2]
        if os.environ.get("PS_WIDS"):
            wids = [int(w) for w in os.environ["PS_WIDS"].split(",")]
        else:
            wids = [w for w in range(nw) if w % nprocs == pid]
        rec = run_worker(name, algo, device, ps_port,
                         wids, nprocs, iters, gamma,
                         evaluate=os.environ.get("PS_EVAL") != "0",
                         devices=mesh_list)
        rec["pid"] = pid
    rec["telemetry"] = read_own_telemetry()
    if srv is not None:
        srv.stop()
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

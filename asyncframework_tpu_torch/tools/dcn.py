"""The DCN parameter-server plane on one card: runs, records and gates.

    python3 -m asyncframework_tpu_torch.tools.dcn [--runs epsilon:asgd,...]

Each multi-process run is one PS process and two worker processes
(``tools/ps_child.py``: 4 logical workers each), all on ``cuda:0``, over
loopback TCP upgraded to the shared-memory ring, with the cluster path's
defaults (delta pulls, pipeline depth 2 -- ASAGA runs its serial loop --,
the native codecs).  Its record holds the PS's updates/s over the window in
which every logical worker was running, accepted and dropped, the largest
staleness, tasks (gradients computed) per accepted update, wire bytes per
accepted update, the pull replies by shape, the merge drain's batches, each
worker process's kernel launches per accepted update, ``python_fallbacks``
and the peak device memory of each process.  Its gates: the run stopped at
its budget; every push the workers sent was counted once (accepted or
dropped) with no dedup hit; each worker gradient was one launch of its
kernel form (B1's compacted form for dense ASGD, on the staged route; B1's
per-slot form for dense ASAGA; S1's ``compacted_grad`` for sparse ASGD; S1's
per-slot form for sparse ASAGA) with no plain-version call; no codec fell
back to Python and the ring carried the frames; and the objective, by the
JAX package's own bands: epsilon ASGD below 1/10 of its value at w = 0
(``chip_smoke.py`` phase 3), epsilon ASAGA below 1/2 (phase 5), rcv1 ASGD a
best below 0.1x and a final below 0.3x (``tests/test_sparse.py:214-219``),
rcv1 ASAGA a final below 1x (``:143-157``).

:func:`in_process` runs the same recipe with the PS and the 8 logical
workers as threads of this process, for comparison.

``--shards N`` runs each deployment on a sharded PS group instead
(``async.ps.shards``: the primary in the PS process, shards 1..N-1 as
children of ``parallel/shardgroup.py``'s ``ShardGroup`` on the same card),
``--fence`` turns epoch fencing on (``async.fence.enabled``), and
``--kill-shard i --kill-at k`` SIGKILLs shard ``i`` once the primary has
accepted ``k`` updates, with per-shard checkpoints every
``--checkpoint-every`` updates of each shard.  :func:`summarize_sharded`
adds the group's gates (:data:`SHARD_ARMS` are ``chip_smoke.py`` phase
12's arms).

``--standby`` gives every shard a warm standby (``async.ps.standby``: a
killed primary is promoted, not relaunched), ``--control`` runs the
adaptive controller on the primary (``async.control.enabled``), and
``--delay-ms a,b`` delays each PUSH of worker process 0 by ``a`` ms and of
process 1 by ``b`` (a straggler), and ``--reader`` reads the last shard's
standby through SUBSCRIBE while the run goes.  :func:`summarize_standby`
adds the standby plane's and the controller's gates (:data:`STANDBY_ARMS`
are ``chip_smoke.py`` phase 13's arms; ``--phase13`` runs them).

``--mesh N --devices LIST`` runs each worker process's gradients over a
``dp`` mesh of N ranks of its device list (``async.mesh.devices``;
``tools/ps_child.py``): each gradient is one B1 launch a rank, so the
launch gate becomes one launch a rank a gradient.  :data:`MESH_ARMS` are
``chip_smoke.py`` phase 14's DCN arms (``--phase14`` runs them): epsilon
ASGD without and with a 4-rank mesh on one card, then ASAGA with it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch import native_build
from asyncframework_tpu_torch.net import faults
from asyncframework_tpu_torch.tools import ps_child, runs

#: the chip runs: (deployment, algorithm, updates); epsilon ASAGA at
#: phase 5's budget, rcv1 ASGD at bench.py's
RUNS = (("epsilon", "asgd", 1_000), ("epsilon", "asaga", 2_000),
        ("rcv1", "asgd", 1_200), ("rcv1", "asaga", 600))
#: the kernel form one worker gradient launches, by (dense?, algorithm)
TASK_FORM = {("epsilon", "asgd"): "masked_grad",
             ("epsilon", "asaga"): "saga_slots_grad",
             ("rcv1", "asgd"): "compacted_grad",
             ("rcv1", "asaga"): "sparse_saga_slots_grad",
             ("small", "asgd"): "masked_grad",
             ("small", "asaga"): "saga_slots_grad"}
PLAIN_CALLS = ("compacted_grad_plain", "grad_sum_plain",
               "ell_residual_plain", "segment_sum_plain",
               "masked_grad_plain", "saga_grad_plain",
               "saga_slots_grad_plain", "xt_coeff_plain")
CHILD = [sys.executable, "-m", "asyncframework_tpu_torch.tools.ps_child"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_natives() -> Dict[str, str]:
    """Build the wire codecs before any process needs them (the children
    load the same files); raises where one does not build."""
    out = {}
    for name in native_build.SOURCES:
        path = native_build.ensure_built(name, quiet=False)
        if path is None:
            raise RuntimeError(f"native {name} did not build (g++)")
        out[name] = path
    return out


def launch(config: str, algo: str, iters: int, device: str = "cuda",
           nprocs: int = 2, timeout_s: float = 600.0,
           env: "Dict[str, str] | None" = None,
           delays_ms=None, worker_args=()) -> Tuple[dict, List[dict]]:
    """One PS process and ``nprocs`` worker processes; returns the PS's
    record and the workers'.  ``env`` is added to every process's
    environment (e.g. conf keys by their ``ASYNCTPU_`` names);
    ``delays_ms[i]`` delays each PUSH of worker process ``i`` (its
    ``async.net.fault.schedule``); ``worker_args`` go on each worker's
    command line (:func:`mesh_args`).  The workers start beside the PS,
    building their data while it comes up, and read its port from a file
    this function writes once the PS announces it (``PS_PORT_FILE``).
    Every process is waited for or killed."""
    with Launched(config, algo, iters, device, nprocs, env, delays_ms,
                  worker_args) as run:
        return run.collect(timeout_s)


class Launched:
    """:func:`launch` in two halves, for a caller that works against the
    PS while the run goes (``tools/serve.py``): entering starts the
    processes and waits for the PS's port (:attr:`port`); :meth:`collect`
    waits for every process and returns the PS's record and the
    workers'; leaving kills whatever still runs."""

    def __init__(self, config: str, algo: str, iters: int,
                 device: str = "cuda", nprocs: int = 2,
                 env: "Dict[str, str] | None" = None, delays_ms=None,
                 worker_args=()):
        self.config, self.algo = config, algo
        self.env = dict(os.environ, PYTHONPATH=ROOT, PS_CONFIG=config,
                        PS_ALGO=algo, PS_DEVICE=device,
                        PS_NUM_WORKER_PROCS=str(nprocs),
                        PS_NUM_ITER=str(iters), **(env or {}))
        self.nprocs, self.delays_ms = nprocs, delays_ms
        self.worker_args = list(worker_args)
        self.procs: List[subprocess.Popen] = []
        self._drains: list = []
        self.port = None
        self._port_dir = None

    def __enter__(self) -> "Launched":
        import tempfile

        self._port_dir = tempfile.TemporaryDirectory(prefix="dcn-port-")
        try:
            self._start()
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _start(self) -> None:
        env, nprocs, delays_ms = self.env, self.nprocs, self.delays_ms
        procs = self.procs
        port_file = os.path.join(self._port_dir.name, "port")
        ps = subprocess.Popen(CHILD, env=dict(env, PS_ROLE="ps"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT)
        procs.append(ps)
        for i in range(nprocs):
            wenv = dict(env, PS_ROLE="worker", PS_PORT_FILE=port_file,
                        PS_WORKER_ID=str(i))
            if delays_ms and i < len(delays_ms) and delays_ms[i] > 0:
                # the deterministic slow-but-alive member: every PUSH of
                # this process pays the delay (count=0 = forever)
                sched = faults.FaultSchedule().add_delay(
                    "*", "PUSH", delays_ms[i], count=0)
                wenv["ASYNCTPU_ASYNC_NET_FAULT_SCHEDULE"] = sched.to_json()
            procs.append(subprocess.Popen(
                CHILD + self.worker_args, env=wenv,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=ROOT))
        line = ps.stdout.readline()
        if not line:
            raise RuntimeError(f"the PS process died: "
                               f"{ps.communicate()[1][-3000:]}")
        self.port = int(json.loads(line)["port"])
        with open(port_file + ".tmp", "w") as f:
            f.write(str(self.port))
        os.replace(port_file + ".tmp", port_file)
        # every pipe read as it comes: a caller that works against the PS
        # for a while must not leave a process blocked on a full pipe
        for i, p in enumerate(procs):
            self._drains.append([self._drain(p.stdout, f"dcn-out-{i}"),
                                 self._drain(p.stderr, f"dcn-err-{i}")])

    @staticmethod
    def _drain(stream, name: str):
        import threading

        chunks: List[str] = []
        t = threading.Thread(target=lambda: chunks.extend(iter(
            stream.readline, "")), name=name, daemon=True)
        t.start()
        return t, chunks

    def collect(self, timeout_s: float = 600.0) -> Tuple[dict, List[dict]]:
        deadline = time.monotonic() + timeout_s
        order = list(range(1, len(self.procs))) + [0]
        recs = []
        for i in order:
            p = self.procs[i]
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            (t_out, out), (t_err, err) = self._drains[i]
            t_out.join()
            t_err.join()
            if p.returncode != 0:
                raise RuntimeError(f"a {self.config} {self.algo} process "
                                   f"failed ({p.returncode}): "
                                   f"{''.join(err)[-3000:]}")
            lines = "".join(out).strip().splitlines()
            recs.append(json.loads(lines[-1]))
        return recs[-1], recs[:-1]

    def __exit__(self, *_exc) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if self._port_dir is not None:
            self._port_dir.cleanup()


def objective_gates(config: str, algo: str, traj,
                    obj0: "float | None" = None) -> Dict[str, bool]:
    """The JAX package's bands for each deployment, against the
    trajectory's first point (the model at w = 0) or ``obj0``."""
    objs = [v for _t, v in traj] if traj else [float("nan")]
    best, final = min(objs), objs[-1]
    obj0 = objs[0] if obj0 is None else obj0
    finite = bool(np.isfinite(objs).all())
    if config == "rcv1" and algo == "asgd":
        return {"finite": finite, "best_below_0.1x": best < 0.1 * obj0,
                "final_below_0.3x": final < 0.3 * obj0}
    if config == "rcv1":
        return {"finite": finite, "final_below_w0": final < obj0}
    frac = 0.1 if algo == "asgd" else 0.5
    return {"finite": finite, f"final_below_{frac}x": final < frac * obj0}


def mesh_args(ranks: int, devices: str = "") -> List[str]:
    """A worker's command line for a ``ranks``-rank mesh over ``devices``
    (comma separated; default ``cuda:0`` repeated: the ranks share one
    card)."""
    if not ranks:
        return []
    return ["--mesh", str(ranks), "--devices",
            devices or ",".join(["cuda:0"] * ranks)]


def summarize(config: str, algo: str, iters: int, ps: dict,
              workers: List[dict]) -> dict:
    """The run's record and its gates (``ok``).  A worker process with a
    mesh of R ranks makes R launches a gradient (and a warm-up), so its
    launch gate is one launch a rank a gradient, every gradient a mesh
    step."""
    form = TASK_FORM[(config, algo)]
    ranks = [max(1, w.get("mesh", {}).get("ranks", 0)) for w in workers]
    accepted = max(ps["accepted"], 1)
    gradients = sum(w["gradients"] for w in workers)
    serial = algo == "asaga"  # ASAGA runs the serial loop
    traj = ps["trajectory"]
    objs = [v for _t, v in traj] if traj else []
    d = ps_child.CONFIGS[config]["shape"][1]
    rec = {
        "config": config, "algo": algo, "processes": 1 + len(workers),
        "updates_per_sec": ps["updates_per_sec"],
        "elapsed_s": ps["elapsed_s"], "accepted": ps["accepted"],
        "dropped": ps["dropped"], "max_staleness": ps["max_staleness"],
        "gradients": gradients,
        "tasks_per_accepted_update": gradients / accepted,
        "pushes": ps["pushes"], "dedup_hits": ps["dedup_hits"],
        "wire_bytes_per_update": (ps["wire_bytes_sent"]
                                  + ps["wire_bytes_recv"]) / accepted,
        "push_bytes_per_push": ps["push_bytes"] / max(ps["pushes"], 1),
        "dense_grad_bytes": d * 4,
        "pull_replies": ps["pull_replies"],
        "merge_batches": ps["merge_batches"],
        "merge_batch_mean": ps["merge_merged"] / max(ps["merge_batches"], 1),
        "merge_batch_max": ps["merge_batch_max"],
        "pipeline": ps["pipeline"],
        "task_form": form,
        "mesh_ranks": [w.get("mesh", {}).get("ranks", 0) for w in workers],
        "launches_per_accepted_update": [
            (w["launches"][form] - r * w["warmups"]) / accepted
            for w, r in zip(workers, ranks)],
        "worker_launches": [{k: v for k, v in w["launches"].items() if v}
                            for w in workers],
        "python_fallbacks": [r["native"].get("python_fallbacks", 0)
                             for r in [ps, *workers]],
        "shm_upgrades": [r["native"].get("shm_upgrades", 0)
                         for r in [ps, *workers]],
        "native_crc_calls": ps["native"].get("native_calls.crc", 0),
        "peak_device_bytes": {"ps": ps["peak_device_bytes"],
                              "workers": [w["peak_device_bytes"]
                                          for w in workers]},
        "objective_at_w0": objs[0] if objs else None,
        "best_objective": min(objs) if objs else None,
        "final_objective": objs[-1] if objs else None,
    }
    sent = ps["pipeline"].get("pushes_async", 0) if not serial else gradients
    gates = {
        "done_at_budget": ps["done"] and ps["accepted"] == iters,
        "exactly_once": (ps["pushes"] == ps["accepted"] + ps["dropped"]
                         and ps["pushes"] == sent and ps["dedup_hits"] == 0),
        "one_launch_a_gradient": all(
            w["launches"][form] == r * (w["gradients"] + w["warmups"])
            and (r == 1 or w.get("mesh", {}).get("steps", 0)
                 == w["gradients"] + w["warmups"])
            and not any(w["launches"][k] for k in PLAIN_CALLS)
            for w, r in zip(workers, ranks)),
        "no_python_fallback": not any(rec["python_fallbacks"]),
        "shm_ring": all(n > 0 for n in rec["shm_upgrades"][1:]),
        "native_codecs": rec["native_crc_calls"] > 0,
        **objective_gates(config, algo, traj),
    }
    if any(r > 1 for r in ranks):
        gates["one_launch_per_rank_a_gradient"] = gates.pop(
            "one_launch_a_gradient")
    if form == "masked_grad":  # epsilon's task (compacted; mesh: full)
        gates["staged_route"] = all(
            w["launches"]["masked_grad_staged"] == w["launches"][form]
            for w in workers)
    rec["gates"] = gates
    rec["ok"] = all(gates.values())
    return rec


#: phase 12's arms: (name, deployment, updates, shards, kill, checkpoint
#: cadence); every arm fenced, ASGD.  (c) kills shard 1 at 500 accepted.
SHARD_ARMS = (("a", "epsilon", 1_000, 2, None, 0),
              ("b", "rcv1", 1_200, 3, None, 0),
              ("c", "epsilon", 1_000, 3, (1, 500), 250))


def shard_env(shards: int, fence: bool = True, kill=None,
              checkpoint_every: int = 0,
              checkpoint_dir: "str | None" = None) -> Dict[str, str]:
    """The processes' environment for a sharded group run."""
    env = {"ASYNCTPU_ASYNC_PS_SHARDS": str(shards),
           "ASYNCTPU_ASYNC_FENCE_ENABLED": "1" if fence else "0"}
    if checkpoint_dir:
        env["PS_CHECKPOINT_DIR"] = checkpoint_dir
    if checkpoint_every:
        env["PS_PRINTER_FREQ"] = str(checkpoint_every)
    if kill:
        env["PS_KILL_SHARD"], env["PS_KILL_AT"] = str(kill[0]), str(kill[1])
    return env


def summarize_sharded(config: str, iters: int, ps: dict,
                      workers: List[dict], kill=None,
                      obj0: "float | None" = None) -> dict:
    """A sharded group run's record and its gates (``ok``): the
    unsharded run's (:func:`summarize`, exactly-once judged on the
    primary), and for the group: every pull a version vector of the map's
    length, each shard's pushes counted once (accepted + dropped, no
    secondary short of the primary's accepted updates, none past the
    pushes the workers sent), fenced epochs with no fenced reject (arms
    without a kill) or the kill's one restart, resumed from its
    checkpoint under a new epoch (arm with a kill).

    The group's trajectory is its shards' snapshot stacks aligned at the
    tail, so a shard relaunched from a checkpoint (fewer snapshots) cuts
    its head: the point at w = 0 is then missing, and ``obj0`` (the same
    deployment's objective at w = 0 from another run) is what the bands
    are held against."""
    rec = summarize(config, "asgd", iters, ps, workers)
    if obj0 is not None:
        rec["gates"].update(objective_gates(config, "asgd",
                                            ps["trajectory"], obj0))
        rec["objective_at_w0"] = obj0
        rec["trajectory_first_objective"] = (ps["trajectory"][0][1]
                                             if ps["trajectory"] else None)
    n_shards = ps["n_shards"]
    members = ps["shards"]
    # rounds the workers sent, plus the rounds abandoned on a sub-shard
    # fault (a round may fail after some of its sub-pushes went out)
    sent = ps["pipeline"].get("pushes_async", 0)
    sent_max = sent + ps["pipeline"].get("push_errors", 0)
    pulls = sum(w["shard_totals"].get("sharded_pulls", 0) for w in workers)
    vec = sum(w["shard_totals"].get(f"pull_vector_len_{n_shards}", 0)
              for w in workers)
    # the diagnostics' frames (a SUBSCRIBE reader, the mirror check) are
    # not the run's
    wire = (ps["wire_bytes_sent"] + ps["wire_bytes_recv"]
            + sum(m["wire_bytes"]["sent"] + m["wire_bytes"]["recv"]
                  for m in members[1:])
            - ps.get("wire_bytes_diagnostic", 0))
    accepted = max(ps["accepted"], 1)
    rec.update({
        "shards": n_shards, "fence": ps["fence"], "spawn_s": ps["spawn_s"],
        "sharded_pulls": pulls, "pulls_with_vector_of_map_length": vec,
        "round_errors": sum(w["shard_totals"].get("shard_round_errors", 0)
                            for w in workers),
        "wire_bytes_per_update": wire / accepted,
        "per_shard": [{k: m.get(k) for k in (
            "shard", "accepted", "dropped", "pushes", "clock",
            "dedup_hits", "epoch", "fenced_rejects", "max_staleness",
            "staleness_counts", "merge_batches", "merge_merged",
            "restarts", "resumed_from", "peak_device_bytes")}
            for m in members],
        "kill": ps["kill"],
        "group_totals": ps["shard_totals"],
    })
    rec["peak_device_bytes"]["shards"] = [
        m.get("peak_device_bytes") for m in members[1:]]
    gates = dict(rec["gates"])
    # the primary's exactly-once (summarize's) stands; the group's:
    gates["vector_of_map_length"] = pulls > 0 and vec == pulls
    gates["each_shard_counts_each_push_once"] = all(
        m["pushes"] == m["accepted"] + m["dropped"]
        and m["pushes"] <= sent_max for m in members)
    gates["no_range_short"] = all(
        m["accepted"] >= ps["accepted"] for m in members[1:]
        if not m.get("restarts"))
    gates["fenced_epochs"] = ps["fence"] and all(
        m["epoch"] >= 1 for m in members)
    if kill is None:
        gates["no_fenced_rejects"] = all(
            m["fenced_rejects"] == 0 for m in members)
        gates["no_dedup_hits"] = all(m["dedup_hits"] == 0 for m in members)
    else:
        # rounds abandoned around the kill: the primary may have applied
        # a sub-push of a round the worker counted as an error, and the
        # replays onto the restarted shard answer from its window
        gates["exactly_once"] = (
            ps["pushes"] == ps["accepted"] + ps["dropped"]
            and sent <= ps["pushes"] <= sent_max)
        k = ps["kill"] or {}
        victim = members[kill[0]] if kill[0] < len(members) else {}
        gates["killed_at"] = k.get("accepted_at_kill", -1) >= kill[1]
        gates["one_restart"] = victim.get("restarts") == 1 and all(
            not m.get("restarts") for j, m in enumerate(members)
            if j != kill[0])
        gates["resumed_from_checkpoint"] = (
            victim.get("resumed_from") is not None)
        gates["new_epoch_above_old"] = (
            victim.get("epoch", 0) > k.get("epoch_before", 0) >= 1)
    rec["gates"] = gates
    rec["ok"] = all(gates.values())
    return rec


def shards_phase(arms=SHARD_ARMS, timeout_s: float = 600.0) -> List[dict]:
    """Phase 12 of ``chip_smoke.py``: each arm of ``arms`` on one card,
    one PS process (the primary and the group controller), its shard
    children and two worker processes; returns each arm's record."""
    import tempfile

    out = []
    obj0 = {}  # each deployment's objective at w = 0, from an unkilled arm
    for name, config, iters, shards, kill, every in arms:
        with tempfile.TemporaryDirectory() as ck:
            env = shard_env(shards, True, kill, every,
                            ck if every else None)
            ps, workers = launch(config, "asgd", iters, env=env,
                                 timeout_s=timeout_s)
        rec = summarize_sharded(config, iters, ps, workers, kill,
                                obj0.get(config) if kill else None)
        if not kill:
            obj0[config] = rec["objective_at_w0"]
        rec.update(arm=name, mode="shards")
        out.append(rec)
    return out


#: phase 13's arms: (name, deployment, updates, shards, kill, per-process
#: PUSH delays in ms, SUBSCRIBE reader); every arm fenced, every shard
#: with a warm standby, the controller on, ASGD.  (a) kills shard 1's
#: primary at 500 accepted and reads the last shard's standby through
#: SUBSCRIBE; (b) makes worker process 1 a straggler.
STANDBY_ARMS = (("a", "epsilon", 1_000, 3, (1, 500), (0, 0), True),
                ("b", "rcv1", 1_200, 2, None, (0, 150), False))


def standby_env(shards: int, kill=None, control: bool = True,
                checkpoint_dir: "str | None" = None,
                reader: bool = False) -> Dict[str, str]:
    """The processes' environment for a sharded, fenced group run with
    warm standbys (and the controller, and a SUBSCRIBE reader on the
    last shard's standby)."""
    env = shard_env(shards, True, kill, 0, checkpoint_dir)
    env["ASYNCTPU_ASYNC_PS_STANDBY"] = "1"
    env["ASYNCTPU_ASYNC_CONTROL_ENABLED"] = "1" if control else "0"
    if reader:
        env["PS_STANDBY_READER"] = "1"
    return env


def summarize_standby(config: str, iters: int, ps: dict,
                      workers: List[dict], kill=None,
                      delays_ms=None, obj0: "float | None" = None) -> dict:
    """A standby group run's record and gates (``ok``): the sharded run's
    (:func:`summarize_sharded`, exactly-once judged on each member), every
    shard backed by a standby at the start, and after the run each
    standby's model read by SUBSCRIBE bit-equal to its primary's at the
    same clock; with a kill, exactly one promotion of the killed shard
    and no relaunch of any, under an epoch above the one it died with
    (the promoted member's own ledger: accepted + dropped == its clock);
    with the controller, its ticks and every actuated value within the
    tunable's declared bounds."""
    rec = summarize_sharded(config, iters, ps, workers, None, obj0)
    members = ps["shards"]
    sb = ps["standby"] or {}
    ctrl = ps["control"]
    # the stream's own bytes (REPL_SYNC and REPL_APPEND frames, every
    # primary's), inside wire_bytes_per_update
    stream = ps.get("repl_bytes_sent", 0) + sum(
        m["wire_bytes"].get("sent.REPL_APPEND", 0)
        + m["wire_bytes"].get("sent.REPL_SYNC", 0) for m in members[1:])
    rec.update({
        "standby": {k: v for k, v in sb.items() if k != "mirrors"},
        "stream_bytes_per_update": stream / max(ps["accepted"], 1),
        "mirrors": sb.get("mirrors"),
        "control": ctrl, "kill": ps["kill"], "delays_ms": delays_ms,
        "per_shard": [dict(m, promotions=members[i].get("promotions", 0))
                      for i, m in enumerate(rec["per_shard"])],
    })
    gates = dict(rec["gates"])
    gates["every_shard_backed"] = bool(ps["standby"]) and len(
        sb.get("mirrors") or []) == ps["n_shards"]
    gates["mirrors_bit_equal"] = bool(sb.get("mirrors")) and all(
        m["equal"] for m in sb["mirrors"])
    if ctrl is not None:
        gates["controller_ticked"] = ctrl["totals"].get("ticks", 0) > 0
        gates["actuated_within_bounds"] = bool(
            ctrl["actuated_within_bounds"])
    if kill is not None:
        # rounds fail around the kill (the dead range's sub-pushes), and
        # the pipeline counters the workers piggyback on their pushes are
        # lost with a failed round's header: judge delivery against the
        # gradients the workers computed (one fan-out round each) and the
        # rounds their facades abandoned
        for key in ("no_fenced_rejects", "no_dedup_hits", "no_range_short"):
            gates.pop(key, None)
        gradients = sum(w["gradients"] for w in workers)
        errors = sum(w["shard_totals"].get("shard_round_errors", 0)
                     for w in workers)
        gates["exactly_once"] = (
            ps["pushes"] == ps["accepted"] + ps["dropped"]
            and gradients - errors <= ps["pushes"] <= gradients)
        gates["each_shard_counts_each_push_once"] = all(
            m["pushes"] == m["accepted"] + m["dropped"]
            and m["pushes"] <= gradients for m in members)
        k = ps["kill"] or {}
        victim = members[kill[0]] if kill[0] < len(members) else {}
        gates["killed_at"] = k.get("accepted_at_kill", -1) >= kill[1]
        gates["one_promotion_no_relaunch"] = (
            victim.get("promotions") == 1 and victim.get("promoted") is True
            and all(not m.get("restarts") for m in members))
        gates["promoted_ledger_exact"] = (
            victim.get("accepted", -1) + victim.get("dropped", -1)
            == victim.get("clock"))
        gates["new_epoch_above_old"] = (
            victim.get("epoch", 0) > k.get("epoch_before", 0) >= 1)
        # a range falls short of the primary only by rounds abandoned
        gates["ranges_short_by_abandoned_rounds_only"] = all(
            0 <= ps["accepted"] - m["accepted"] <= errors
            for m in members[1:])
        rec["round_errors"] = errors
    rec["gates"] = gates
    rec["ok"] = all(gates.values())
    return rec


def standby_phase(arms=STANDBY_ARMS, timeout_s: float = 600.0,
                  obj0: "Dict[str, float] | None" = None) -> List[dict]:
    """Phase 13 of ``chip_smoke.py``: each arm of ``arms`` on one card,
    one PS process (the primary, its standby's stream, the controller and
    the group controller), the shard and standby children and two worker
    processes; returns each arm's record.  A kill arm's objective bands
    are held against ``obj0[deployment]`` (the objective at w = 0) where
    given, else against its tail-aligned trajectory's first point."""
    out = []
    for name, config, iters, shards, kill, delays, reader in arms:
        ps, workers = launch(config, "asgd", iters,
                             env=standby_env(shards, kill, reader=reader),
                             timeout_s=timeout_s, delays_ms=delays)
        rec = summarize_standby(config, iters, ps, workers, kill, delays,
                                (obj0 or {}).get(config) if kill else None)
        rec.update(arm=name, mode="standby")
        out.append(rec)
    return out


#: phase 14's DCN arms: (name, deployment, algorithm, updates, mesh ranks
#: on one card); phase 10's machine shape, ASAGA on its serial loop
MESH_ARMS = (("off", "epsilon", "asgd", 1_000, 0),
             ("on", "epsilon", "asgd", 1_000, 4),
             ("asaga_on", "epsilon", "asaga", 2_000, 4))


def mesh_phase(arms=MESH_ARMS, timeout_s: float = 600.0) -> List[dict]:
    """Phase 14's DCN arms of ``chip_smoke.py``: each arm one PS process
    and two worker processes, the workers' mesh over ``cuda:0`` repeated
    (the ranks share the card); returns each arm's record, gated as
    :func:`summarize` gates it."""
    out = []
    for name, config, algo, iters, ranks in arms:
        ps, workers = launch(config, algo, iters, timeout_s=timeout_s,
                             worker_args=mesh_args(ranks))
        rec = summarize(config, algo, iters, ps, workers)
        rec.update(arm=name, mode="mesh" if ranks else "processes",
                   mesh=ranks)
        out.append(rec)
    return out


def in_process(config: str, algo: str, iters: int, device) -> dict:
    """The same recipe with the PS and its 8 logical workers as threads of
    this process (the cluster path's defaults set for the call)."""
    from asyncframework_tpu_torch.conf import AsyncConf, global_conf
    from asyncframework_tpu_torch.conf import set_global_conf
    from asyncframework_tpu_torch.metrics.live import (
        start_telemetry_from_conf,
    )
    from asyncframework_tpu_torch.parallel import ps_dcn

    n, d, nw = ps_child.CONFIGS[config]["shape"]
    before = global_conf()
    set_global_conf(AsyncConf())
    srv = None
    try:
        ps_child.apply_cluster_defaults()
        # one process holds both roles: one telemetry endpoint
        srv = start_telemetry_from_conf("ps")
        cfg = ps_child.config(config, algo, iters)
        ds = ps_child.dataset(config, device)
        shards = {w: ds.shard(w) for w in range(nw)}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        native_build.reset_native_totals()
        ps_dcn.reset_pipeline_totals()
        ps = ps_dcn.ParameterServer(cfg, d, n, device=device, port=0,
                                    algo=algo).start()
        marks = ps_child.watch_start(ps, nw)
        runs.zero_counts()
        counts = ps_dcn.run_worker_process(
            "127.0.0.1", ps.port, list(range(nw)), shards, cfg, d, n,
            deadline_s=cfg.run_timeout_s, algo=algo)
        done = ps.wait_done(timeout_s=60.0)
        t_done = time.monotonic()
        marks["thread"].join(timeout=1.0)
        launches = runs.counts()
        # the trajectory scored here, after the run (all shards are local)
        times, W = ps.snapshot_stack()
        total = ps_dcn.evaluate_snapshots_on_shards(shards, times, W,
                                                    cfg.loss)
        summary = ps_child.ps_summary(ps, marks, t_done, n, None)
        summary["trajectory"] = [[t, float(v) / n]
                                 for t, v in zip(times, total)]
        ps.stop()
        # one process: the workers' record shares the PS's counters; the 8
        # shards share one shape, so one warm-up launch
        worker = {"gradients": int(sum(counts.values())), "warmups": 1,
                  "launches": launches, "native": summary["native"],
                  "peak_device_bytes": summary["peak_device_bytes"]}
        rec = summarize(config, algo, iters,
                        {**summary, "done": bool(done)}, [worker])
        rec.update(processes=1, mode="threads")
        return rec
    finally:
        if srv is not None:
            srv.stop()
        set_global_conf(before)


def phase(device, runs_=RUNS, in_process_iters: int = 1_000) -> List[dict]:
    """Every multi-process run of ``runs_``, then the in-process epsilon
    ASGD run (``in_process_iters`` updates); each record carries its
    gates."""
    out = []
    for config, algo, iters in runs_:
        ps, workers = launch(config, algo, iters)
        rec = summarize(config, algo, iters, ps, workers)
        rec["mode"] = "processes"
        out.append(rec)
    out.append(in_process("epsilon", "asgd", in_process_iters, device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(
        f"{c}:{a}:{i}" for c, a, i in RUNS),
        help="config:algo:updates, comma separated")
    ap.add_argument("--in-process", action="store_true",
                    help="also run epsilon ASGD with threads")
    ap.add_argument("--shards", type=int, default=1,
                    help="run on a sharded PS group of N shards")
    ap.add_argument("--fence", action="store_true",
                    help="epoch fencing on (async.fence.enabled)")
    ap.add_argument("--kill-shard", type=int, default=0,
                    help="SIGKILL this shard (1..N-1) mid-run")
    ap.add_argument("--kill-at", type=int, default=500,
                    help="... once the primary has accepted this many")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="per-shard checkpoints every N of its updates")
    ap.add_argument("--phase12", action="store_true",
                    help="run chip_smoke.py phase 12's arms and exit")
    ap.add_argument("--standby", action="store_true",
                    help="a warm standby behind every shard "
                         "(async.ps.standby=1; needs --shards and fencing)")
    ap.add_argument("--control", action="store_true",
                    help="the adaptive controller on the primary "
                         "(async.control.enabled)")
    ap.add_argument("--reader", action="store_true",
                    help="with --standby, a SUBSCRIBE reader on the last "
                         "shard's standby")
    ap.add_argument("--delay-ms", default="",
                    help="per worker process PUSH delays in ms, e.g. 0,150")
    ap.add_argument("--phase13", action="store_true",
                    help="run chip_smoke.py phase 13's arms and exit")
    ap.add_argument("--mesh", type=int, default=0,
                    help="each worker's gradients over a dp mesh of N "
                         "ranks (async.mesh.devices)")
    ap.add_argument("--devices", default="",
                    help="with --mesh, the workers' device list, comma "
                         "separated (default cuda:0 repeated)")
    ap.add_argument("--phase14", action="store_true",
                    help="run chip_smoke.py phase 14's DCN arms and exit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dcn: no CUDA device", file=sys.stderr)
        return 2
    from asyncframework_tpu_torch.ops import _build

    _build.build_all()  # once, before the processes that load them start
    build_natives()
    dev = torch.device("cuda", 0)
    ok = True
    if args.phase12 or args.phase13 or args.phase14:
        for rec in (shards_phase() if args.phase12 else standby_phase()
                    if args.phase13 else mesh_phase()):
            ok = ok and rec["ok"]
            print(json.dumps(rec), flush=True)
        return 0 if ok else 1
    kill = (args.kill_shard, args.kill_at) if args.kill_shard else None
    delays = [float(x) for x in args.delay_ms.split(",") if x]
    wargs = mesh_args(args.mesh, args.devices)
    for spec in args.runs.split(","):
        config, algo, iters = spec.split(":")
        if args.shards > 1:
            import tempfile

            with tempfile.TemporaryDirectory() as ck:
                env = shard_env(args.shards, args.fence, kill,
                                args.checkpoint_every,
                                ck if args.checkpoint_every else None)
                if args.standby:
                    env.update(standby_env(args.shards, kill, args.control,
                                           ck if args.checkpoint_every
                                           else None, args.reader))
                elif args.control:
                    env["ASYNCTPU_ASYNC_CONTROL_ENABLED"] = "1"
                ps, workers = launch(config, algo, int(iters), env=env,
                                     delays_ms=delays, worker_args=wargs)
            if args.standby:
                rec = summarize_standby(config, int(iters), ps, workers,
                                        kill, delays)
            else:
                rec = summarize_sharded(config, int(iters), ps, workers,
                                        kill)
        else:
            env = {"ASYNCTPU_ASYNC_FENCE_ENABLED": "1"} if args.fence else {}
            if args.control:
                env["ASYNCTPU_ASYNC_CONTROL_ENABLED"] = "1"
            ps, workers = launch(config, algo, int(iters), env=env,
                                 delays_ms=delays, worker_args=wargs)
            rec = summarize(config, algo, int(iters), ps, workers)
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
    if args.in_process:
        rec = in_process("epsilon", "asgd", 1_000, dev)
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

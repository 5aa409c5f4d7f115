"""The read path on one card: serving while the PS trains, a replica over a
shard group, and the relay tree.

    python3 -m asyncframework_tpu_torch.tools.serve [--arms serve,sharded,relay]
        [--device cuda] [--config epsilon]

Each arm prints one JSON record with its gates (``ok``); ``chip_smoke.py``
phase 16 runs them in turn.

- :func:`serve_arm`: one PS process and two worker processes
  (``tools/dcn.py``'s :class:`~asyncframework_tpu_torch.tools.dcn.Launched`,
  epsilon ASGD) train while ``async.serve.replicas`` replica processes
  (``python -m asyncframework_tpu_torch.serving.cli replica``, on the card)
  subscribe to the PS and HELLO a frontend in this process.  Four client
  threads send 16-row f32 batches and a fifth cycles 1, 3, 17, 64 and 256
  rows (every power-of-two bucket up to 256) from the moment the PS's
  clock moves until training is done; replica 1 is SIGKILLed once the
  clock passes half the budget.  A reader in this process follows the
  PS's versions through SUBSCRIBE and keeps the final one (the PS lingers
  ``PS_LINGER_S`` after the run).  Gates: no client error with a failover
  counted, the surviving replica serving the final version, its
  predictions on a fixed 256-row batch within rtol 1e-5 of ``X @ w``
  computed in float64 on the host (relative to each row's ``|X| @ |w|``),
  its device the one asked for, and the training run's own gates
  (``dcn.summarize``).
- :func:`sharded_arm`: a fenced 2-shard group (``dcn.shard_env``) trains;
  one replica in this process resolves the group (SHARDMAP, then
  ``ShardedSubscriber``).  Gates: after DONE its predictions within rtol
  1e-5 of ``X`` times the concatenated final shards, its STATUS naming
  both ranges, the group run's gates (``dcn.summarize_sharded``).
- :func:`relay_arm`: an in-process PS on the card at rcv1's width
  (d = 47,236) and eight relay nodes with sources, fanout 2, driven
  version by version (the JAX package's ``bench.py`` distribution arm:
  18 versions of decaying size) in three arms, direct SUBSCRIBE, the tree
  raw and the tree compressed; then interior node 1 is stopped and two
  more versions pushed.  Gates: every node holding each version
  bit-equal to the PS's snapshot with its CRC, the stopped node's
  children re-homed to the root, ``relay_offers`` > 0 in every arm.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.net import frame
from asyncframework_tpu_torch.net import wiredelta
from asyncframework_tpu_torch.parallel import shardgroup
from asyncframework_tpu_torch.parallel.ps_dcn import PSClient
from asyncframework_tpu_torch.tools import dcn, ps_child

#: bench.py's serving load: client threads and rows a request
SERVE_CLIENTS = 4
SERVE_BATCH = 16
#: the fifth client's request sizes: every power-of-two bucket to 256
CYCLE_ROWS = (1, 3, 17, 64, 256)
#: the fixed batch the final predictions are checked on
CHECK_ROWS = 256
#: the arms' training budgets (updates)
SERVE_UPDATES = 1_000
SHARDED_UPDATES = 300
#: seconds the PS goes on serving after its run
LINGER_S = 3.0
#: predictions against the float64 product: |y - Xw| <= RTOL * |X| |w|
RTOL = 1e-5
#: the relay arm: rcv1's width, the JAX bench's tree and versions
RELAY_D = 47_236
RELAY_REPLICAS = 8
RELAY_VERSIONS = 18
RELAY_FANOUT = 2
RELAY_EXTRA_VERSIONS = 2
RELAY_STOPPED = 1

SERVE_CLI = [sys.executable, "-m", "asyncframework_tpu_torch.serving.cli"]
#: the fields of a replica's STATUS the serve arm reports
STATUS_KEYS = ("rid", "predicts", "device", "ts", "refreshes",
               "refresh_wenc")


# ------------------------------------------------------------------ pieces
def _call(port: int, hdr: dict, payload: bytes = b"",
          timeout: float = 10.0) -> Tuple[dict, bytes]:
    sock = frame.connect(("127.0.0.1", port), timeout=timeout)
    try:
        frame.send_msg(sock, hdr, payload)
        return frame.recv_msg(sock)
    finally:
        sock.close()


def replica_status(port: int) -> dict:
    return _call(port, {"op": "STATUS"})[0]


def predict_direct(port: int, X: np.ndarray) -> Tuple[dict, np.ndarray]:
    hdr, body = _call(port, {"op": "PREDICT", "n": int(X.shape[0])},
                      np.ascontiguousarray(X, np.float32).tobytes())
    return hdr, np.frombuffer(body, np.float32)


def prediction_error(X: np.ndarray, w: np.ndarray, y: np.ndarray) -> dict:
    """``y`` against ``X @ w`` in float64: the largest error relative to
    each row's ``|X| @ |w|`` (the product's own scale), and whether it is
    within :data:`RTOL`."""
    X64, w64 = X.astype(np.float64), np.asarray(w, np.float64)
    ref = X64 @ w64
    scale = np.abs(X64) @ np.abs(w64)
    rel = np.abs(y.astype(np.float64) - ref) / np.maximum(scale, 1e-30)
    return {"max_rel_err": float(rel.max()), "rtol": RTOL,
            "finite": bool(np.isfinite(y).all()),
            "within": bool(np.isfinite(y).all() and rel.max() <= RTOL)}


def spawn_replica(ps_port: int, rid: int, frontend_port: Optional[int],
                  device: str) -> Tuple[subprocess.Popen, dict]:
    """One ``serving.cli replica`` process (on the card, or on the CPU
    when ``device`` is ``cpu``); returns it and its announce line."""
    env = dict(os.environ, PYTHONPATH=dcn.ROOT)
    if device == "cpu":
        env["ASYNCTPU_FORCE_CPU"] = "1"
    else:
        env.pop("ASYNCTPU_FORCE_CPU", None)
    cmd = SERVE_CLI + ["replica", "--ps", f"127.0.0.1:{ps_port}",
                       "--host", "127.0.0.1", "--rid", str(rid)]
    if frontend_port is not None:
        cmd += ["--frontend", f"127.0.0.1:{frontend_port}"]
    proc = subprocess.Popen(cmd, env=env, cwd=dcn.ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        raise RuntimeError(f"replica {rid} never announced: "
                           f"{proc.communicate()[1][-3000:]}")
    return proc, json.loads(line)


class FinalModel:
    """A reader that follows a PS (or each range of a shard group)
    through SUBSCRIBE every ``interval_s`` and keeps the newest model.
    :meth:`wait_final` returns once every range has said DONE at its
    clock; the reader goes on until the PS stops answering (it lingers
    after its run), and the last model it read is the run's final one
    (:attr:`last`: stamp, model, and the first stamp that carried these
    bytes).  A single PS drops the pushes that land after DONE, which tick
    its clock without changing the model; a shard group's secondaries
    still apply the ones in flight (:attr:`changed_after_done`)."""

    def __init__(self, host: str, port: int, interval_s: float = 0.02):
        smap, epochs, epoch = shardgroup.fetch_group_info(host, port)
        ends = ([(h, p) for (h, p, _lo, _hi) in smap.entries]
                if smap is not None else [(host, port)])
        eps = (list(epochs) if smap is not None and epochs
               else [epoch] * len(ends))
        self.clients = [PSClient(h, p, pull_mode="delta", epoch=int(e or 0))
                        for (h, p), e in zip(ends, eps)]
        self.interval_s = interval_s
        self.ts = 0
        self.clock = 0
        self.w: Optional[np.ndarray] = None
        self.final: Optional[Tuple[int, np.ndarray]] = None
        self.last: Optional[Tuple[int, np.ndarray, int]] = None
        self.changed_after_done = False
        self._final_ready = threading.Event()
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FinalModel":
        from asyncframework_tpu_torch.utils.threads import guarded

        self._thread = threading.Thread(
            target=guarded(self._run, "serve-final-reader"),
            name="serve-final-reader", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        dark = 0
        while not self._stop.is_set():
            try:
                got = [c.subscribe(0) for c in self.clients]
            except (ConnectionError, OSError):
                self.errors += 1
                dark += 1
                if self.final is not None and dark >= 5:
                    return  # the PS has gone after its run
                self._stop.wait(self.interval_s)
                continue
            dark = 0
            self.ts = sum(int(g[0]) for g in got)
            self.clock = sum(int(g[2]) for g in got)
            self.w = np.concatenate([g[1] for g in got])
            if self.final is None and all(g[5] and g[0] >= g[2]
                                          for g in got):
                self.final = (self.ts, self.w)
                self._final_ready.set()
            if self.final is not None:
                if self.w.tobytes() != self.final[1].tobytes():
                    self.changed_after_done = True
            same = (self.last is not None
                    and self.last[1].tobytes() == self.w.tobytes())
            self.last = (self.ts, self.w,
                         self.last[2] if same else self.ts)
            self._stop.wait(self.interval_s)

    def wait_clock(self, at_least: int, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while self.clock < at_least and self.final is None:
            if time.monotonic() > deadline:
                raise TimeoutError(f"the PS's clock stayed below "
                                   f"{at_least} for {timeout_s} s")
            time.sleep(0.01)

    def wait_final(self, timeout_s: float) -> Tuple[int, np.ndarray]:
        if not self._final_ready.wait(timeout_s):
            raise TimeoutError(f"no final version within {timeout_s} s")
        return self.final

    def served_final(self, ts) -> bool:
        """Whether a replica's served version ``ts`` carries the run's
        final model: a stamp between the first one the PS gave these bytes
        and the last one it gave."""
        return (self.last is not None and ts is not None
                and self.last[2] <= int(ts) <= self.last[0])

    def join(self, timeout_s: float) -> None:
        """Wait for the reader to see the PS go (after its linger)."""
        self._thread.join(timeout=timeout_s)

    def own_replies(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.clients:
            for k, v in c.pull_wenc.items():
                out[k] = out.get(k, 0) + v
        return out

    def stop(self) -> None:
        self._stop.set()
        for c in self.clients:
            try:
                c.bye()
            except (ConnectionError, OSError):
                pass


class Load:
    """Client threads against a frontend: :data:`SERVE_CLIENTS` sending
    :data:`SERVE_BATCH`-row batches and one cycling :data:`CYCLE_ROWS`.
    Each answered request's latency, served version and lag are kept; a
    request the frontend could not answer is an error."""

    def __init__(self, frontend, d: int, seed: int = 0):
        self.fe, self.d = frontend, d
        self.lat_ms: List[float] = []
        self.lag_versions: List[int] = []
        self.lag_ms: List[float] = []
        self.ts_seen: List[int] = []
        self.rows_seen: Dict[int, int] = {}
        self.answered = 0
        self.errors: List[str] = []
        self.bad_replies = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._seed = seed
        self.t0 = self.t1 = 0.0

    def _client(self, k: int, sizes) -> None:
        from asyncframework_tpu_torch.serving import PredictError

        rs = np.random.default_rng(self._seed + k)
        batches = {n: rs.normal(size=(n, self.d)).astype(np.float32)
                   for n in set(sizes)}
        i = 0
        while not self._stop.is_set():
            n = sizes[i % len(sizes)]
            i += 1
            t0 = time.perf_counter()
            try:
                y, meta = self.fe.predict_ex(batches[n])
            except PredictError as e:
                with self._lock:
                    self.errors.append(str(e)[:200])
                continue
            dt = (time.perf_counter() - t0) * 1e3
            ok = y.shape == (n,) and bool(np.isfinite(y).all())
            with self._lock:
                self.answered += 1
                self.bad_replies += int(not ok)
                self.lat_ms.append(dt)
                self.lag_versions.append(int(meta["lag_versions"]))
                self.lag_ms.append(float(meta["lag_ms"]))
                self.ts_seen.append(int(meta["ts"]))
                self.rows_seen[n] = self.rows_seen.get(n, 0) + 1

    def start(self) -> "Load":
        self.t0 = time.monotonic()
        plans = [[SERVE_BATCH]] * SERVE_CLIENTS + [list(CYCLE_ROWS)]
        for k, sizes in enumerate(plans):
            t = threading.Thread(target=self._client, args=(k, sizes),
                                 name=f"serve-load-{k}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        self.t1 = time.monotonic()

    def record(self) -> dict:
        window = max(self.t1 - self.t0, 1e-9)

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else None

        return {
            "load_s": window, "requests": self.answered + len(self.errors),
            "answered": self.answered, "qps": self.answered / window,
            "errors": len(self.errors), "error_samples": self.errors[:3],
            "bad_replies": self.bad_replies,
            "predict_ms_p50": pct(self.lat_ms, 50),
            "predict_ms_p99": pct(self.lat_ms, 99),
            "lag_versions_p50": pct(self.lag_versions, 50),
            "lag_versions_max": max(self.lag_versions, default=None),
            "lag_ms_p50": pct(self.lag_ms, 50),
            "lag_ms_max": max(self.lag_ms, default=None),
            "versions_served": len(set(self.ts_seen)),
            "rows_seen": {str(k): v for k, v in sorted(
                self.rows_seen.items())},
        }


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torch_device(device: str) -> torch.device:
    return torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)


def _device_gate(status: dict, device: str) -> bool:
    return str(status.get("device", "")).split(":")[0] == \
        _torch_device(device).type


# --------------------------------------------------------------- (a) serve
def serve_arm(device: str = "cuda", config: str = "epsilon",
              updates: int = SERVE_UPDATES, replicas: Optional[int] = None,
              timeout_s: float = 600.0) -> dict:
    """PREDICT while the PS trains, through a frontend, with replica 1
    SIGKILLed halfway (see the module docstring)."""
    from asyncframework_tpu_torch.conf import SERVE_REPLICAS, global_conf
    from asyncframework_tpu_torch.serving import ServingFrontend
    from asyncframework_tpu_torch.serving import metrics as smetrics

    replicas = int(replicas or global_conf().get(SERVE_REPLICAS))
    d = ps_child.CONFIGS[config]["shape"][1]
    smetrics.reset_serving_totals()
    procs: List[subprocess.Popen] = []
    fe = reader = load = None
    t_start = time.monotonic()
    try:
        # serving first, on the port the PS will bind: the replicas retry
        # their SUBSCRIBE until it is up, so none misses the run's start
        ps_port = _free_port()
        fe = ServingFrontend(deadline_s=2.0).serve(port=0, host="127.0.0.1")
        announced = []
        for rid in range(replicas):
            proc, line = spawn_replica(ps_port, rid, fe.port, device)
            procs.append(proc)
            announced.append(line)
        deadline = time.monotonic() + 120.0
        while fe.replica_count() < replicas:
            if time.monotonic() > deadline:
                raise TimeoutError("replicas never registered")
            time.sleep(0.05)
        t_ready = time.monotonic() - t_start
        env = {"PS_LINGER_S": str(LINGER_S), "PS_BIND_PORT": str(ps_port)}
        with dcn.Launched(config, "asgd", updates, device=device,
                          env=env) as run:
            reader = FinalModel("127.0.0.1", run.port).start()
            reader.wait_clock(1, timeout_s)
            load = Load(fe, d).start()
            t_train0 = time.monotonic()
            reader.wait_clock(updates // 2, timeout_s)
            killed_status = replica_status(announced[1]["port"])
            os.kill(procs[1].pid, signal.SIGKILL)
            t_kill = time.monotonic() - load.t0
            reader.wait_final(timeout_s)
            t_train = time.monotonic() - t_train0
            time.sleep(0.5)  # the survivor answers after DONE too
            load.stop()
            ps, workers = run.collect(timeout_s)
        reader.join(30.0)
        final_ts, w_final, _since = reader.last
        survivor = announced[0]["port"]
        status = replica_status(survivor)
        X = np.random.default_rng(1234).normal(
            size=(CHECK_ROWS, d)).astype(np.float32)
        hdr, y = predict_direct(survivor, X)
        check = prediction_error(X, w_final, y)
        totals = smetrics.serving_totals()
        own = reader.own_replies()
        ps_replies = ps.get("subscribe_replies", {})
        train = dcn.summarize(config, "asgd", updates, ps, workers)
        load_rec = load.record()
        rec = {
            "arm": "serve", "config": config, "d": d, "device": device,
            "replicas": replicas, "updates": updates,
            "replicas_ready_s": t_ready,
            "train_s_under_load": t_train, "kill_at_load_s": t_kill,
            **load_rec,
            "failovers": totals.get("failovers", 0),
            "attempt_errors": totals.get("attempt_errors", 0),
            "unhealthy_rejects": totals.get("unhealthy_rejects", 0),
            "replica_status": [{k: s.get(k) for k in STATUS_KEYS}
                               for s in (status, killed_status)],
            "frontend_by_replica": smetrics.serving_snapshot()["replicas"],
            # the PS's count (at its record, before its linger) holds the
            # reader's replies too; the replicas' own are in their STATUS
            # (refresh_wenc)
            "ps_subscribe_replies": ps_replies,
            "reader_subscribe_replies": own,
            "ps_subscribe_model_bytes": ps.get("subscribe_model_bytes"),
            "final_ts": final_ts, "final_bytes_since_ts": _since,
            "done_ts": reader.final[0],
            "model_changed_after_done": reader.changed_after_done,
            "served_ts": status.get("ts"),
            "final_reply_ts": hdr.get("ts"), "prediction": check,
            "train": {k: train[k] for k in (
                "updates_per_sec", "accepted", "dropped", "max_staleness",
                "launches_per_accepted_update", "final_objective",
                "objective_at_w0")},
            "train_gates": train["gates"],
            "worker_launches": train["worker_launches"],
            "task_form": train["task_form"],
        }
        gates = {
            "no_client_error": load_rec["errors"] == 0
            and load_rec["bad_replies"] == 0,
            "failed_over": rec["failovers"] > 0,
            "every_bucket_hit": all(str(n) in load_rec["rows_seen"]
                                    for n in CYCLE_ROWS),
            "serves_final_version": reader.served_final(status.get("ts"))
            and reader.served_final(hdr.get("ts")),
            "predictions_within_rtol": check["within"],
            "replica_on_device": _device_gate(status, device)
            and _device_gate(killed_status, device),
            **{f"train.{k}": v for k, v in train["gates"].items()},
        }
        rec["gates"] = gates
        rec["ok"] = all(gates.values())
        return rec
    finally:
        if reader is not None:
            reader.stop()
        if load is not None:
            load.stop()
        if fe is not None:
            fe.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


# ------------------------------------------------------------ (b) sharded
def sharded_arm(device: str = "cuda", config: str = "epsilon",
                updates: int = SHARDED_UPDATES, shards: int = 2,
                timeout_s: float = 600.0) -> dict:
    """One replica in this process over a fenced shard group (see the
    module docstring)."""
    from asyncframework_tpu_torch.serving import ModelReplica

    d = ps_child.CONFIGS[config]["shape"][1]
    env = dict(dcn.shard_env(shards, True), PS_LINGER_S=str(LINGER_S))
    rep = reader = None
    try:
        with dcn.Launched(config, "asgd", updates, device=device,
                          env=env) as run:
            rep = ModelReplica("127.0.0.1", run.port, rid=0,
                               host="127.0.0.1",
                               device=_torch_device(device),
                               refresh_interval_s=0.05).start()
            reader = FinalModel("127.0.0.1", run.port).start()
            reader.wait_final(timeout_s)
            ps, workers = run.collect(timeout_s)
        reader.join(30.0)
        # the replica polls until every range has gone
        # (ModelReplica._final): then it holds the last version it read
        rep._refresh_thread.join(timeout=30.0)
        final_ts, w_final, _since = reader.last
        status = rep.status()
        X = np.random.default_rng(4321).normal(
            size=(CHECK_ROWS, d)).astype(np.float32)
        hdr, y = predict_direct(rep.port, X)
        check = prediction_error(X, w_final, y)
        group = dcn.summarize_sharded(config, updates, ps, workers)
        ranges = status.get("ranges") or []
        rec = {
            "arm": "serve_sharded", "config": config, "d": d,
            "device": device, "shards": shards, "updates": updates,
            "final_ts": final_ts, "final_bytes_since_ts": _since,
            "done_ts": reader.final[0],
            "model_changed_after_done": reader.changed_after_done,
            "served_ts": status.get("ts"),
            "ranges": [(r["lo"], r["hi"], r["ts"]) for r in ranges],
            "replica_device": status.get("device"),
            "refresh_wenc": status.get("refresh_wenc"),
            "refreshes": status.get("refreshes"), "prediction": check,
            "group": {k: group[k] for k in ("updates_per_sec", "accepted",
                                            "final_objective")},
            "group_gates": group["gates"],
            "worker_launches": group["worker_launches"],
            "task_form": group["task_form"],
        }
        gates = {
            "serves_final_version": reader.served_final(status.get("ts"))
            and reader.served_final(hdr.get("ts")),
            "predictions_within_rtol": check["within"],
            "status_names_every_range": [
                (r["lo"], r["hi"]) for r in ranges] == [
                    tuple(r) for r in shardgroup.shard_ranges(d, shards)],
            "replica_on_device": _device_gate(status, device),
            **{f"group.{k}": v for k, v in group["gates"].items()},
        }
        rec["gates"] = gates
        rec["ok"] = all(gates.values())
        return rec
    finally:
        if reader is not None:
            reader.stop()
        if rep is not None:
            rep.stop()


# -------------------------------------------------------------- (c) relay
def _relay_ps(device: str, d: int):
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.solvers import SolverConfig

    cfg = SolverConfig(num_workers=2, num_iterations=10_000, gamma=0.5,
                       taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                       printer_freq=1_000, seed=42, calibration_iters=4,
                       run_timeout_s=120.0)
    return ps_dcn.ParameterServer(cfg, d, 1_024, device=_torch_device(device),
                                  port=0).start()


def _push_version(cl, rng, v: int, d: int) -> None:
    ts, _w, _avg, _cal = cl.pull(0)
    # decaying update sizes: from near-incompressible early versions to
    # the small relative updates a serving fleet lives in
    scale = 0.5 * (0.45 ** v) + 1e-5
    cl.push(0, ts, (scale * rng.normal(size=d)).astype(np.float32))


def _held_bit_equal(nodes, snap, skip=()) -> bool:
    for rid, node in enumerate(nodes):
        if rid in skip:
            continue
        cur = node.current()
        if (cur is None or cur.ts != snap.ts or cur.crc != snap.crc
                or cur.wire != snap.wire
                or wiredelta.crc(np.frombuffer(cur.wire, np.float32))
                != snap.crc):
            return False
    return True


def relay_tree(device: str, d: int, relay: bool, compress: bool,
               stop_interior: bool = False) -> dict:
    """One distribution arm: the PS, :data:`RELAY_REPLICAS` nodes and
    sources, :data:`RELAY_VERSIONS` versions driven in topological order;
    with ``stop_interior``, node :data:`RELAY_STOPPED` is then stopped and
    :data:`RELAY_EXTRA_VERSIONS` more versions pushed."""
    from asyncframework_tpu_torch.metrics import reset_totals
    from asyncframework_tpu_torch.relaycast import (
        ROOT,
        RelayNode,
        RelaySource,
        children_of,
        parent_index,
    )
    from asyncframework_tpu_torch.relaycast import metrics as rmetrics

    reset_totals()
    ps = _relay_ps(device, d)
    nodes, sources = [], []
    cl = None
    try:
        cl = PSClient("127.0.0.1", ps.port, pull_mode="full")
        for rid in range(RELAY_REPLICAS):
            node = RelayNode(rid=rid, port=0, compress=compress,
                             fanout=RELAY_FANOUT).start()
            p = parent_index(rid, RELAY_FANOUT)
            parent = (None if (not relay or p == ROOT)
                      else ("127.0.0.1", nodes[p].port))
            nodes.append(node)
            sources.append(RelaySource("127.0.0.1", ps.port, node,
                                       parent=parent, rid=rid))
        rng = np.random.default_rng(7)
        bit_equal = True
        t0 = time.monotonic()
        for v in range(RELAY_VERSIONS):
            _push_version(cl, rng, v, d)
            for rid in range(RELAY_REPLICAS):
                sources[rid].subscribe(rid)
            bit_equal &= _held_bit_equal(nodes, ps._model_snap())
        drive_s = time.monotonic() - t0
        ps_bytes = ps.subscribe_model_bytes
        rt = rmetrics.relay_totals()
        rec = {
            "relay": relay, "compress": compress, "d": d,
            "versions": RELAY_VERSIONS,
            "ps_subscribe_bytes_per_version": ps_bytes / RELAY_VERSIONS,
            "ps_subscribe_replies": dict(ps.subscribe_replies),
            "relay_fetch_bytes_per_version":
                rt.get("fetch_bytes_out", 0) / RELAY_VERSIONS,
            "parent_fetches": rt.get("parent_fetches", 0),
            "root_fallbacks": rt.get("root_fallbacks", 0),
            "drive_s": drive_s, "bit_equal_every_version": bit_equal,
        }
        if stop_interior:
            orphans = children_of(RELAY_STOPPED, RELAY_REPLICAS,
                                  RELAY_FANOUT)
            via_root0 = [sources[c].via_root for c in orphans]
            rehomes0 = rt.get("rehomes", 0)
            nodes[RELAY_STOPPED].stop()
            after = True
            for v in range(RELAY_VERSIONS,
                           RELAY_VERSIONS + RELAY_EXTRA_VERSIONS):
                _push_version(cl, rng, v, d)
                for rid in range(RELAY_REPLICAS):
                    if rid != RELAY_STOPPED:
                        sources[rid].subscribe(rid)
                after &= _held_bit_equal(nodes, ps._model_snap(),
                                         skip=(RELAY_STOPPED,))
            rt = rmetrics.relay_totals()
            rec["interior_stop"] = {
                "stopped": RELAY_STOPPED, "children": orphans,
                "children_via_root": [sources[c].via_root - b
                                      for c, b in zip(orphans, via_root0)],
                "rehomes": rt.get("rehomes", 0) - rehomes0,
                "final_ts": ps._model_snap().ts,
                "bit_equal_after_stop": after,
            }
        # the offer loop runs at 20 ms: give it its round for the last
        # version before the count is read
        deadline = time.monotonic() + 5.0
        while ps.relay_offers == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        rec["relay_offers"] = ps.relay_offers
        return rec
    finally:
        for node in nodes:
            node.stop()
        if cl is not None:
            cl.bye()
        ps.stop()


def relay_arm(device: str = "cuda", d: int = RELAY_D) -> dict:
    """The three distribution arms and the interior stop (see the module
    docstring)."""
    direct = relay_tree(device, d, relay=False, compress=False)
    raw = relay_tree(device, d, relay=True, compress=False)
    comp = relay_tree(device, d, relay=True, compress=True,
                      stop_interior=True)
    stop = comp["interior_stop"]
    rec = {
        "arm": "relay", "device": device, "d": d,
        "replicas": RELAY_REPLICAS, "fanout": RELAY_FANOUT,
        "model_bytes": d * 4,
        "direct": direct, "tree_raw": raw, "tree_compressed": comp,
        "egress_ratio_direct_to_tree_raw":
            direct["ps_subscribe_bytes_per_version"]
            / max(raw["ps_subscribe_bytes_per_version"], 1e-9),
        "egress_ratio_direct_to_tree_compressed":
            direct["ps_subscribe_bytes_per_version"]
            / max(comp["ps_subscribe_bytes_per_version"], 1e-9),
    }
    gates = {
        "bit_equal_every_version": all(
            a["bit_equal_every_version"] for a in (direct, raw, comp)),
        "bit_equal_after_stop": stop["bit_equal_after_stop"],
        "children_rehomed_to_root": all(
            n >= RELAY_EXTRA_VERSIONS for n in stop["children_via_root"])
        and stop["rehomes"] >= len(stop["children"]),
        "relay_offers": all(a["relay_offers"] > 0
                            for a in (direct, raw, comp)),
        "tree_cuts_egress": raw["ps_subscribe_bytes_per_version"]
        < direct["ps_subscribe_bytes_per_version"],
    }
    rec["gates"] = gates
    rec["ok"] = all(gates.values())
    return rec


ARMS = {"serve": serve_arm, "sharded": sharded_arm, "relay": relay_arm}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arms", default="serve,sharded,relay")
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="epsilon",
                   help="the training arms' deployment (tools/ps_child.py)")
    args = p.parse_args(argv)
    ok = True
    for name in args.arms.split(","):
        kw = {"device": args.device}
        if name != "relay":
            kw["config"] = args.config
        rec = ARMS[name](**kw)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

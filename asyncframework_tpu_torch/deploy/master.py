"""Standalone Master daemon: worker registry, app scheduling, recovery.

Parity (studied, not copied): ``deploy/master/Master.scala:41`` -- workers
REGISTER and heartbeat; applications are submitted with a requested process
count; the master assigns processes to alive workers and tells each worker
to launch an executor process; lost workers are detected by heartbeat
timeout; master state survives restart through a persistence engine
(``ZooKeeperPersistenceEngine.scala:34`` -- here a single-node
atomic-rename JSON file fills the PersistenceEngine role; the interface
point is the same, the consensus service is out of scope on one machine).

Deltas: the wire is the same length-prefixed JSON/TCP framing as
the DCN parameter server (``parallel/ps_dcn.py``) -- one transport for the
whole control plane, no RPC mesh.  A launched app process receives the
``ASYNCTPU_*`` env (coordinator address, process count, process id), so a
scheduled app IS an ``async-cluster`` run placed by the master: SPMD jobs
join a global mesh, ``asgd`` jobs form the PS + worker-pusher topology.

A copy of ``asyncframework_tpu/deploy/master.py`` (imports renamed): the
same ops, frames and ``master-state.json``, so this master recovers a JAX
package master's state and serves either package's clients and worker
daemons.

Protocol (all messages carry ``op``):
  worker -> master: REGISTER_WORKER {worker_id, host, port, cores}
                    HEARTBEAT {worker_id}
                    EXECUTOR_EXIT {worker_id, app_id, proc_id, returncode}
  client -> master: SUBMIT_APP {argv, num_processes, env}
                    APP_STATUS {app_id} | LIST_WORKERS | KILL_APP {app_id}
  master -> worker: (reply to heartbeat) LAUNCH orders piggybacked
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from asyncframework_tpu_torch.cluster import _free_port
from asyncframework_tpu_torch.net import DedupWindow
from asyncframework_tpu_torch.net import protocol as _protocol
from asyncframework_tpu_torch.net.frame import recv_msg as _recv_msg
from asyncframework_tpu_torch.net.frame import send_msg as _send_msg

#: ops that mutate master state: a retried SUBMIT_APP must not schedule the
#: app twice, a retried KILL_APP is answered from cache (net/session.py)
# the (sid, seq)-gated verbs come from the declared wire-protocol table
# (net/protocol.py): the table is the single place an op's exactly-once
# obligation lives, and bin/async-lint checks this derivation stays put
_MUTATING_OPS = _protocol.dedup_gated_ops(_protocol.MASTER)

# NOTE on coordinator ports: _free_port binds-then-releases on the master's
# host, so (a) another process could steal the port before the app binds it
# (submit again on that rare failure) and (b) the probe assumes process 0
# lands on a host where the port is equally free -- both acceptable for the
# single-machine standalone story this layer targets.

WORKER_TIMEOUT_S = 10.0


class Master:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        persistence_dir: Optional[str] = None,
        worker_timeout_s: float = WORKER_TIMEOUT_S,
        ha: bool = False,
        ui_port: Optional[int] = None,
        ui_host: str = "127.0.0.1",
    ):
        self.host = host
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._lock = threading.Lock()
        # worker_id -> {host, port, cores, last_seen, alive}
        self.workers: Dict[str, Dict] = {}
        # app_id -> {argv, env, num_processes, state, assignments, exits}
        self.apps: Dict[str, Dict] = {}
        self._app_seq = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._worker_timeout_s = worker_timeout_s
        if persistence_dir:
            os.makedirs(persistence_dir, exist_ok=True)
            self._persist_path = os.path.join(
                persistence_dir, "master-state.json"
            )
        else:
            self._persist_path = None
        # HA: masters race for the flock lease; only the winner recovers
        # state and serves -- standbys answer STANDBY until they win
        # (ZooKeeperLeaderElectionAgent.scala:26 role; see deploy/leader.py)
        if ha and self._persist_path is None:
            raise ValueError("ha masters need a persistence_dir (the lease "
                             "file and shared state live there)")
        self.election = None
        if ha:
            from asyncframework_tpu_torch.deploy.leader import FileLeaderElection

            self.election = FileLeaderElection(
                os.path.join(persistence_dir, "master.lock")
            )
            self.active = False
        else:
            self.active = True
            self._recover()
        self._ui_port = ui_port
        self._ui_host = ui_host
        self._ui = None
        from asyncframework_tpu_torch.conf import NET_DEDUP_WINDOW, global_conf

        self._dedup = DedupWindow(window=global_conf().get(NET_DEDUP_WINDOW))

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Master":
        t = threading.Thread(target=self._accept_loop, name="master-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)
        t2 = threading.Thread(target=self._reaper_loop, name="master-reaper",
                              daemon=True)
        t2.start()
        self._threads.append(t2)
        if self.election is not None:
            t3 = threading.Thread(target=self._election_loop,
                                  name="master-election", daemon=True)
            t3.start()
            self._threads.append(t3)
        if self._ui_port is not None:
            self._ui = MasterUIServer(self, port=self._ui_port,
                                      host=self._ui_host)
        return self

    @property
    def dedup_hits(self) -> int:
        """Retried mutating RPCs answered from the dedup window."""
        return self._dedup.hits

    def status_snapshot(self) -> Dict:
        """Cluster state for the web UI / ops tooling (MasterPage role)."""
        with self._lock:
            return {
                "address": self.address,
                "active": self.active,
                "workers": {
                    wid: {"host": w["host"], "cores": w["cores"],
                          "alive": w["alive"]}
                    for wid, w in self.workers.items()
                },
                "apps": {
                    app_id: {
                        "state": a["state"],
                        "num_processes": a["num_processes"],
                        "supervise": a.get("supervise", False),
                        "exits": dict(a["exits"]),
                        "argv": list(a["argv"])[:6],
                    }
                    for app_id, a in self.apps.items()
                },
            }

    def _election_loop(self) -> None:
        if not self.election.acquire_blocking(self._stop,
                                              holder=self.address):
            return
        with self._lock:
            # takeover recovery: worker daemons and their executors are
            # still alive (only the old MASTER died), so RUNNING apps stay
            # RUNNING -- the workers' EXECUTOR_EXIT reports will land here
            self._recover(takeover=True)
            self.active = True

    def stop(self) -> None:
        self._stop.set()
        if self.election is not None:
            self.election.release()
        if self._ui is not None:
            self._ui.stop()
        try:
            self._srv.close()
        except OSError:
            pass

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # ---------------------------------------------------------- persistence
    def _persist(self) -> None:
        """PersistenceEngine role: apps + registered workers survive a
        master restart (atomic rename; heartbeats re-validate liveness)."""
        if self._persist_path is None:
            return
        state = {
            "workers": {
                wid: {k: w[k] for k in ("host", "port", "cores")}
                for wid, w in self.workers.items()
            },
            "apps": {
                aid: {
                    "argv": a["argv"], "env": a["env"],
                    "num_processes": a["num_processes"],
                    "state": a["state"],
                    # exits persist too: an HA takeover that reset them
                    # could never complete an app whose executors partly
                    # exited before the failover (the worker's ACKed report
                    # is never resent)
                    "exits": dict(a["exits"]),
                }
                for aid, a in self.apps.items()
            },
            "app_seq": self._app_seq,
        }
        tmp = self._persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        # fsync file + rename + fsync directory: an HA takeover after host
        # power loss must see the registry the dead master believed it had
        from asyncframework_tpu_torch.checkpoint import durable_replace

        durable_replace(tmp, self._persist_path)

    def _recover(self, takeover: bool = False) -> None:
        if self._persist_path is None or not os.path.exists(
            self._persist_path
        ):
            return
        with open(self._persist_path) as f:
            state = json.load(f)
        now = time.monotonic()
        for wid, w in state.get("workers", {}).items():
            # recovered workers must re-heartbeat before they count as alive
            self.workers[wid] = {
                **w, "last_seen": now - self._worker_timeout_s, "alive": False
            }
        for aid, a in state.get("apps", {}).items():
            # cold restart: RUNNING apps lost their master mid-flight with
            # no standby watching -- surface LOST instead of pretending.
            # HA takeover: the executors belong to live worker daemons that
            # are about to rotate their heartbeats here, so the app is
            # still RUNNING and its exits will arrive.
            st = a["state"]
            if st in ("RUNNING", "LAUNCHING"):
                st = "RUNNING" if takeover else "LOST"
            self.apps[aid] = {
                **a, "assignments": [],
                "exits": dict(a.get("exits") or {}), "state": st,
            }
        self._app_seq = int(state.get("app_seq", 0))

    # -------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="master-conn", daemon=True)
            t.start()

    def _reaper_loop(self) -> None:
        """Worker-loss detection (the reference's CheckForWorkerTimeOut)."""
        while not self._stop.wait(self._worker_timeout_s / 4):
            now = time.monotonic()
            with self._lock:
                for wid, w in self.workers.items():
                    if w["alive"] and now - w["last_seen"] > self._worker_timeout_s:
                        w["alive"] = False

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                header, _payload = _recv_msg(conn)
                # handler errors must come back as ERR replies -- letting
                # them fall into the connection-error handler would close
                # the socket without replying ("peer closed" at the client,
                # with the real cause invisible)
                cached = (self._dedup.check(header)
                          if header.get("op") in _MUTATING_OPS else None)
                if cached is not None:
                    # duplicate of an applied mutation (reply lost on the
                    # wire): re-answer from cache -- one SUBMIT_APP retry
                    # storm must still schedule exactly one app
                    _send_msg(conn, cached[0])
                    continue
                try:
                    reply = self._handle(header)
                except Exception as e:  # noqa: BLE001 - reported to caller
                    reply = {"op": "ERR",
                             "msg": f"{type(e).__name__}: {e}"}
                if (header.get("op") in _MUTATING_OPS
                        and reply.get("op") not in ("ERR", "STANDBY")):
                    # STANDBY is a routing answer, not an outcome; caching
                    # it would pin a client to the loser after failover
                    self._dedup.record(header, reply)
                _send_msg(conn, reply)
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    # ------------------------------------------------------------- handlers
    def _handle(self, msg: dict) -> dict:
        op = msg.get("op")
        if not self.active:
            # standby: refuse everything until the lease is won (reference
            # parity: standby masters reject RPCs with a not-leader error)
            return {"op": "STANDBY", "master": self.address}
        if op == "REGISTER_WORKER":
            with self._lock:
                self.workers[msg["worker_id"]] = {
                    "host": msg["host"], "port": int(msg["port"]),
                    "cores": int(msg.get("cores", 1)),
                    "last_seen": time.monotonic(), "alive": True,
                }
                self._persist()
            return {"op": "REGISTERED", "master": self.address}
        if op == "HEARTBEAT":
            with self._lock:
                w = self.workers.get(msg["worker_id"])
                if w is None:
                    # reference parity: an unknown heartbeat asks the
                    # worker to re-register (master may have restarted)
                    return {"op": "RECONNECT"}
                w["last_seen"] = time.monotonic()
                w["alive"] = True
            return {"op": "ACK"}
        if op == "EXECUTOR_EXIT":
            with self._lock:
                app = self.apps.get(msg["app_id"])
                if app is not None:
                    app["exits"][str(msg["proc_id"])] = int(msg["returncode"])
                    if (
                        len(app["exits"]) >= app["num_processes"]
                        and app["state"] in ("LAUNCHING", "RUNNING")
                    ):
                        # KILLED stays KILLED: the kill's terminations
                        # produce nonzero exits that must not relabel it
                        bad = [rc for rc in app["exits"].values() if rc]
                        app["state"] = "FAILED" if bad else "FINISHED"
                    # persist EVERY exit, not just the terminal one: the
                    # worker never resends an ACKed report, so a standby
                    # recovering mid-app must find partial exits on disk
                    self._persist()
            return {"op": "ACK"}
        if op == "SUBMIT_APP":
            return self._submit(msg)
        if op == "KILL_APP":
            return self._kill(msg["app_id"])
        if op == "APP_STATUS":
            with self._lock:
                app = self.apps.get(msg["app_id"])
                if app is None:
                    return {"op": "ERR", "msg": "no such app"}
                # copies, not live references: serialization happens after
                # the lock is released, racing EXECUTOR_EXIT mutations
                return {
                    "op": "APP", "app_id": msg["app_id"],
                    "state": app["state"],
                    "assignments": [dict(a) for a in app["assignments"]],
                    "exits": dict(app["exits"]),
                }
        if op == "LIST_WORKERS":
            with self._lock:
                return {
                    "op": "WORKERS",
                    "workers": {
                        wid: {"host": w["host"], "cores": w["cores"],
                              "alive": w["alive"]}
                        for wid, w in self.workers.items()
                    },
                }
        return {"op": "ERR", "msg": f"bad op {op!r}"}

    def _submit(self, msg: dict) -> dict:
        """Schedule: round-robin the app's processes over alive workers
        (spreadOutApps-style placement), then order launches."""
        nproc = int(msg["num_processes"])
        with self._lock:
            alive = [
                (wid, w) for wid, w in self.workers.items() if w["alive"]
            ]
            if not alive:
                return {"op": "ERR", "msg": "no alive workers"}
            self._app_seq += 1
            app_id = f"app-{self._app_seq:04d}"
            coord_port = _free_port()
            coord = f"{alive[0][1]['host']}:{coord_port}"
            assignments = []
            for proc_id in range(nproc):
                wid, w = alive[proc_id % len(alive)]
                assignments.append({"proc_id": proc_id, "worker_id": wid})
            self.apps[app_id] = {
                "argv": list(msg["argv"]), "env": dict(msg.get("env") or {}),
                "num_processes": nproc, "state": "LAUNCHING",
                "assignments": assignments, "exits": {},
                "supervise": bool(msg.get("supervise")),
            }
            self._persist()
            app = self.apps[app_id]
        # order launches outside the lock (worker RPCs)
        ok = True
        for a in assignments:
            w = self.workers[a["worker_id"]]
            env = dict(app["env"])
            env.update(
                ASYNCTPU_COORDINATOR=coord,
                ASYNCTPU_NUM_PROCESSES=str(nproc),
                ASYNCTPU_PROCESS_ID=str(a["proc_id"]),
            )
            try:
                with socket.create_connection(
                    (w["host"], w["port"]), timeout=10
                ) as ws:
                    _send_msg(ws, {
                        "op": "LAUNCH", "app_id": app_id,
                        "proc_id": a["proc_id"], "argv": app["argv"],
                        "env": env, "master": self.address,
                        "supervise": app.get("supervise", False),
                    })
                    _recv_msg(ws)
            except (ConnectionError, OSError):
                ok = False
        if not ok:
            # reclaim executors already launched: half an SPMD app would
            # otherwise sit in distributed bring-up holding devices
            self._order_kills(app_id, assignments)
        with self._lock:
            # only LAUNCHING -> RUNNING: a fast-exiting app may already have
            # reached FINISHED/FAILED via EXECUTOR_EXIT, and stamping RUNNING
            # over a terminal state would strand it forever
            if app["state"] == "LAUNCHING":
                app["state"] = "RUNNING" if ok else "FAILED"
            self._persist()
        return {"op": "SUBMITTED", "app_id": app_id, "coordinator": coord}

    def _order_kills(self, app_id: str, assignments) -> None:
        for a in assignments:
            w = self.workers.get(a["worker_id"])
            if w is None:
                continue
            try:
                with socket.create_connection(
                    (w["host"], w["port"]), timeout=10
                ) as ws:
                    _send_msg(ws, {"op": "KILL", "app_id": app_id})
                    _recv_msg(ws)
            except (ConnectionError, OSError):
                continue  # worker gone; its procs die with it

    def _kill(self, app_id: str) -> dict:
        """KILL_APP: terminate every executor, mark the app KILLED."""
        with self._lock:
            app = self.apps.get(app_id)
            if app is None:
                return {"op": "ERR", "msg": "no such app"}
            assignments = [dict(a) for a in app["assignments"]]
        self._order_kills(app_id, assignments)
        with self._lock:
            if app["state"] in ("LAUNCHING", "RUNNING", "LOST"):
                app["state"] = "KILLED"
                self._persist()
        return {"op": "KILLED", "app_id": app_id}


_UI_HTML = """<!doctype html><html><head><title>async master</title>
<meta http-equiv="refresh" content="2">
<style>body{font-family:monospace;margin:2em}table{border-collapse:collapse}
td,th{border:1px solid #999;padding:4px 10px;text-align:left}
.ok{color:#070}.bad{color:#b00}</style></head><body>
<h2>async master <span id="addr"></span></h2>
<h3>workers</h3><table id="w"><tr><th>id</th><th>host</th><th>cores</th>
<th>alive</th></tr></table>
<h3>applications</h3><table id="a"><tr><th>id</th><th>state</th>
<th>procs</th><th>supervise</th><th>exits</th><th>argv</th></tr></table>
<script>
// textContent only: app argv and worker hosts are CLIENT-supplied strings
// and must never be interpreted as markup in the operator's browser
function row(tbl, cells, cls) {
 const r = tbl.insertRow();
 cells.forEach((v, i) => {
  const c = r.insertCell();
  c.textContent = String(v);
  if (cls && cls[i]) c.className = cls[i];
 });
}
fetch('/api/status').then(r=>r.json()).then(s=>{
 document.getElementById('addr').textContent=
   s.address+(s.active?' (active)':' (standby)');
 const w=document.getElementById('w');
 for(const [id,x] of Object.entries(s.workers))
  row(w, [id, x.host, x.cores, x.alive],
      [null, null, null, x.alive ? 'ok' : 'bad']);
 const a=document.getElementById('a');
 for(const [id,x] of Object.entries(s.apps))
  row(a, [id, x.state, x.num_processes, x.supervise,
          JSON.stringify(x.exits), x.argv.join(' ')]);
});
</script></body></html>"""


class MasterUIServer:
    """Master web page (``deploy/master/ui/MasterPage.scala`` role): the
    cluster's workers and applications over plain HTTP -- ``/api/status``
    JSON plus an auto-refreshing HTML table at ``/``."""

    def __init__(self, master: "Master", port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server
        import json as _json

        outer = master

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path == "/api/status":
                    body = _json.dumps(outer.status_snapshot()).encode()
                    self._send(200, body, "application/json")
                elif self.path in ("/", "/index.html"):
                    self._send(200, _UI_HTML.encode(), "text/html")
                else:
                    self._send(404, b"not found", "text/plain")

            def log_message(self, *a):  # quiet: no stderr per request
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._ui_thread = threading.Thread(
            target=self._httpd.serve_forever, name="master-ui",
            daemon=True)
        self._ui_thread.start()

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover
    import argparse
    import sys

    p = argparse.ArgumentParser("async-master")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7077)
    p.add_argument("--persistence-dir", default=None)
    p.add_argument("--ha", action="store_true",
                   help="race for the persistence-dir lease; serve as "
                        "standby until won (kill the active master and "
                        "this one takes over)")
    p.add_argument("--ui-port", type=int, default=None,
                   help="serve the master status page on this port")
    p.add_argument("--ui-host", default=None,
                   help="bind address for the status page (default "
                        "0.0.0.0 when --ui-port is set: a UI you asked "
                        "for is a UI you can reach from off-box)")
    args = p.parse_args(argv)
    from asyncframework_tpu_torch.net import faults

    faults.maybe_install_from_conf()  # chaos runs configure daemons by env
    from asyncframework_tpu_torch.metrics.live import start_telemetry_from_conf

    start_telemetry_from_conf("master")  # async.metrics.port gates it
    ui_host = args.ui_host
    if ui_host is None:
        ui_host = "0.0.0.0" if args.ui_port is not None else "127.0.0.1"
    m = Master(args.host, args.port, args.persistence_dir,
               ha=args.ha, ui_port=args.ui_port, ui_host=ui_host).start()
    print(f"master listening on {m.address}"
          + (" (ha)" if args.ha else "")
          + (f" ui:{m._ui.port}" if m._ui is not None else ""), flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        m.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())

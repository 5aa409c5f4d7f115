"""Standalone Worker daemon: registers with the master, launches executors.

Parity (studied, not copied): ``deploy/worker/Worker.scala:43`` -- register
with the master, heartbeat, receive LAUNCH orders, fork executor processes
(here: ``python -m asyncframework_tpu_torch.cli`` with the app's argv and the
``ASYNCTPU_*`` env the master assigned), watch them, and report exits back.
An unknown-worker heartbeat reply (master restarted) triggers
re-registration, the reference's reconnect dance.

A copy of ``asyncframework_tpu/deploy/worker.py`` (imports renamed); its
executors run the port's CLI, on the card unless the daemon's environment
(or ``launch_env_extra``) sets ``ASYNCTPU_FORCE_CPU=1``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from asyncframework_tpu_torch.net import RetryPolicy
from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.utils.threads import guarded
from asyncframework_tpu_torch.net.frame import recv_msg as _recv_msg
from asyncframework_tpu_torch.net.frame import send_msg as _send_msg


class Worker:
    def __init__(
        self,
        master_host: str,
        master_port: int,
        worker_id: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        cores: int = 1,
        heartbeat_s: float = 1.0,
        launch_env_extra: Optional[Dict[str, str]] = None,
        standby_masters: Optional[List[str]] = None,
    ):
        # HA: the reference's workers take every master URL
        # (spark://h1:7077,h2:7077) and talk to whichever is leader; here
        # the list is [primary] + standby_masters and _master_call rotates
        # on connection failure or a STANDBY reply
        self._masters = [(master_host, int(master_port))]
        for addr in standby_masters or []:
            h, p = addr.rsplit(":", 1)
            self._masters.append((h, int(p)))
        self._mi = 0  # index of the master believed active
        self.worker_id = worker_id or f"worker-{os.getpid()}"
        self.cores = cores
        self.heartbeat_s = heartbeat_s
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.host = host
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        # app_id -> live Popen list (pruned as executors exit)
        self._procs: Dict[str, List[subprocess.Popen]] = {}
        self._procs_lock = threading.Lock()
        self._killed: set = set()  # apps killed by order: never supervise
        self._launch_env_extra = dict(launch_env_extra or {})
        self.max_supervised_restarts = 3
        # master RPCs ride the shared retry policy; rotation across the HA
        # master list is the per-attempt body, so "no active master" is a
        # retryable condition with real backoff instead of a bare raise
        self._retry = RetryPolicy.from_conf()

    def _master_call(self, msg: dict,
                     retry: "RetryPolicy" = None) -> dict:
        """One RPC to the active master under the retry policy, rotating
        through the configured masters each attempt (STANDBY replies and
        connection failures both rotate).  Raises ConnectionError (via
        RetryError) when no configured master turns active in budget."""

        def attempt() -> dict:
            for _ in range(len(self._masters)):
                addr = self._masters[self._mi]
                try:
                    with _frame.connect(addr, timeout=10) as s:
                        _send_msg(s, msg)
                        reply, _ = _recv_msg(s)
                    if reply.get("op") != "STANDBY":
                        return reply
                except (ConnectionError, OSError):
                    pass
                self._mi = (self._mi + 1) % len(self._masters)
            raise ConnectionError(
                "no active master among "
                f"{[f'{h}:{p}' for h, p in self._masters]}"
            )

        return (retry or self._retry).call(attempt)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Worker":
        self._register()
        for fn, name in (
            (self._serve_loop, "worker-serve"),
            (self._heartbeat_loop, "worker-heartbeat"),
        ):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._procs_lock:
            live = [p for ps in self._procs.values() for p in ps]
        for p in live:
            if p.poll() is None:
                p.terminate()

    # ------------------------------------------------------- master contact
    def _register(self) -> None:
        reply = self._master_call({
            "op": "REGISTER_WORKER", "worker_id": self.worker_id,
            "host": self.host, "port": self.port, "cores": self.cores,
        })
        if reply.get("op") != "REGISTERED":
            raise RuntimeError(f"registration rejected: {reply}")

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                reply = self._master_call({
                    "op": "HEARTBEAT", "worker_id": self.worker_id,
                })
                if reply.get("op") == "RECONNECT":
                    self._register()  # master restarted; re-introduce
            except (ConnectionError, OSError):
                continue  # master gone; keep trying (HA window)

    # --------------------------------------------------------------- orders
    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg, _ = _recv_msg(conn)
                if msg.get("op") == "LAUNCH":
                    self._launch(msg)
                    _send_msg(conn, {"op": "ACK"})
                elif msg.get("op") == "KILL":
                    with self._procs_lock:
                        self._killed.add(msg["app_id"])
                        doomed = list(self._procs.get(msg["app_id"], ()))
                    for p in doomed:
                        if p.poll() is None:
                            p.terminate()
                    _send_msg(conn, {"op": "ACK", "killed": len(doomed)})
                else:
                    _send_msg(conn, {"op": "ERR", "msg": "bad op"})
            except (ConnectionError, OSError):
                pass
            finally:
                conn.close()

    def _launch(self, order: dict) -> None:
        env = dict(os.environ)
        env.update(order.get("env") or {})
        env.update(self._launch_env_extra)
        proc = subprocess.Popen(
            [sys.executable, "-m", "asyncframework_tpu_torch.cli", *order["argv"]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        proc.async_proc_id = order["proc_id"]  # introspection (tests, UI)
        with self._procs_lock:
            self._procs.setdefault(order["app_id"], []).append(proc)

        def watch() -> None:
            # NOTE: output is buffered until exit (fine for the batch apps
            # this layer schedules; a log-streaming executor is future work)
            out, err = proc.communicate()
            with self._procs_lock:
                ps = self._procs.get(order["app_id"], [])
                if proc in ps:
                    ps.remove(proc)
                if not ps:
                    self._procs.pop(order["app_id"], None)
                app_killed = order["app_id"] in self._killed
            if (
                proc.returncode
                and order.get("supervise")
                and not app_killed
                and not self._stop.is_set()
                and order.get("_restarts", 0) < self.max_supervised_restarts
            ):
                # spark-submit --supervise parity (DriverRunner's restart
                # loop): relaunch with the SAME order -- env carries the
                # coordinator address, so a restarted PS rebinds its port
                # and the surviving peers reconnect.  No EXECUTOR_EXIT for
                # a supervised death: the master sees one continuous life.
                order2 = dict(order, _restarts=order.get("_restarts", 0) + 1)
                sys.stderr.write(
                    f"[{self.worker_id}] supervising app {order['app_id']} "
                    f"proc {order['proc_id']}: rc={proc.returncode}, "
                    f"restart {order2['_restarts']}/"
                    f"{self.max_supervised_restarts}\n"
                )
                self._launch(order2)
                return
            # the exit report must survive a master failover window: a
            # standby needs a few hundred ms to win the lease and recover,
            # and a lost report strands the app in RUNNING forever -- so
            # this call gets a much deeper retry budget than the default
            try:
                self._master_call(
                    {
                        "op": "EXECUTOR_EXIT", "worker_id": self.worker_id,
                        "app_id": order["app_id"],
                        "proc_id": order["proc_id"],
                        "returncode": proc.returncode,
                    },
                    retry=RetryPolicy.from_conf(
                        max_attempts=120, deadline_s=30.0, max_ms=500.0,
                        # a stopped worker must not keep dialing the master
                        # for the rest of the budget: classify transport
                        # errors as non-retryable once stop() has run
                        classify=lambda e: (isinstance(e, OSError)
                                            and not self._stop.is_set()),
                    ),
                )
            except (ConnectionError, OSError):
                pass  # budget spent; the app stays RUNNING (operator-visible)
            if proc.returncode and err:
                sys.stderr.write(
                    f"[{self.worker_id}] app {order['app_id']} proc "
                    f"{order['proc_id']} rc={proc.returncode}:\n"
                    + "\n".join(err.splitlines()[-10:]) + "\n"
                )
            # process 0's stdout is the app's output (SPMD/PS convention)
            if order["proc_id"] == 0 and out:
                sys.stdout.write(out)
                sys.stdout.flush()

        threading.Thread(
            target=guarded(watch, f"exec-watch-{order['app_id']}"),
            name=f"exec-watch-{order['app_id']}-{order['proc_id']}",
            daemon=True,
        ).start()


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover
    import argparse

    p = argparse.ArgumentParser("async-worker")
    p.add_argument("master", help="master address(es) host:port[,host:port]"
                                  " -- first is primary, rest standbys")
    p.add_argument("--cores", type=int, default=1)
    p.add_argument("--worker-id", default=None)
    args = p.parse_args(argv)
    from asyncframework_tpu_torch.net import faults

    faults.maybe_install_from_conf()  # chaos runs configure daemons by env
    from asyncframework_tpu_torch.metrics.live import start_telemetry_from_conf

    start_telemetry_from_conf("deploy-worker")  # async.metrics.port gates it
    primary, *standbys = args.master.split(",")
    host, port = primary.rsplit(":", 1)
    w = Worker(host, int(port), worker_id=args.worker_id,
               cores=args.cores, standby_masters=standbys).start()
    print(f"worker {w.worker_id} on {w.host}:{w.port} -> {args.master}",
          flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        w.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

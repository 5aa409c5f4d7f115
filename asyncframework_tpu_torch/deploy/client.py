"""Submission client: talk to a standalone Master.

Parity: ``deploy/client/StandaloneAppClient.scala:44`` + the submit side of
``SparkSubmit.scala:71`` -- register an application, learn its id, poll its
state.  A copy of ``asyncframework_tpu/deploy/client.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from asyncframework_tpu_torch.net import ClientSession, RetryPolicy
from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.net.frame import recv_msg as _recv_msg
from asyncframework_tpu_torch.net.frame import send_msg as _send_msg


class MasterClient:
    def __init__(self, host: str, port: int,
                 standby_masters: Optional[List[str]] = None,
                 retry: Optional[RetryPolicy] = None,
                 session: Optional[ClientSession] = None):
        self._addrs = [(host, int(port))]
        for addr in standby_masters or []:
            h, p = addr.rsplit(":", 1)
            self._addrs.append((h, int(p)))
        self._mi = 0
        self.retry = retry if retry is not None else RetryPolicy.from_conf()
        self.session = session if session is not None else ClientSession()

    @property
    def addr(self):
        return self._addrs[self._mi]

    def _call(self, msg: dict) -> dict:
        """RPC to the active master under the shared retry policy; each
        attempt rotates through every configured master on connection
        failure or a STANDBY reply (reference parity: StandaloneAppClient
        tries every master URL).  Mutating ops arrive pre-stamped with a
        (sid, seq), so the retried SUBMIT of a lost reply is answered from
        the master's dedup window -- exactly one app, as long as the SAME
        master answers the retry (windows are in-memory: a retry that
        lands on a freshly promoted standby is at-least-once again)."""

        def attempt() -> dict:
            last_err: Optional[Exception] = None
            for _ in range(len(self._addrs)):
                try:
                    with _frame.connect(self.addr, timeout=10) as s:
                        _send_msg(s, msg)
                        reply, _ = _recv_msg(s)
                except (ConnectionError, OSError) as e:
                    last_err = e
                    self._mi = (self._mi + 1) % len(self._addrs)
                    continue
                if reply.get("op") == "STANDBY":
                    self._mi = (self._mi + 1) % len(self._addrs)
                    continue
                if reply.get("op") == "ERR":
                    raise RuntimeError(f"master error: {reply.get('msg')}")
                return reply
            raise ConnectionError(
                f"no active master among {self._addrs}"
            ) from last_err

        return self.retry.call(attempt)

    def submit(self, argv: List[str], num_processes: int,
               env: Optional[Dict[str, str]] = None,
               supervise: bool = False) -> str:
        """``supervise``: the reference's ``spark-submit --supervise`` --
        a worker daemon relaunches an executor that exits nonzero (bounded
        restarts), instead of reporting the failure."""
        reply = self._call(self.session.stamp({
            "op": "SUBMIT_APP", "argv": list(argv),
            "num_processes": int(num_processes), "env": env or {},
            "supervise": bool(supervise),
        }))
        return reply["app_id"]

    def status(self, app_id: str) -> dict:
        return self._call({"op": "APP_STATUS", "app_id": app_id})

    def workers(self) -> dict:
        return self._call({"op": "LIST_WORKERS"})["workers"]

    def kill(self, app_id: str) -> dict:
        return self._call(self.session.stamp(
            {"op": "KILL_APP", "app_id": app_id}
        ))


def _client(master: str) -> MasterClient:
    """``master`` may be a comma-separated HA list: primary,standby,..."""
    primary, *standbys = master.split(",")
    host, port = primary.rsplit(":", 1)
    return MasterClient(host, int(port), standby_masters=standbys)


def submit_app(master: str, argv: List[str], num_processes: int,
               env: Optional[Dict[str, str]] = None) -> str:
    return _client(master).submit(argv, num_processes, env)


def wait_app(master: str, app_id: str, timeout_s: float = 300.0) -> dict:
    """Poll until the app reaches a terminal state (FINISHED/FAILED/LOST).

    Rides through a master failover: during the takeover window every
    configured master refuses or answers STANDBY for a few hundred ms --
    the poll keeps retrying until the deadline (the Worker daemon's
    heartbeat loop does the same)."""
    cl = _client(master)
    deadline = time.monotonic() + timeout_s
    st = {"state": "UNKNOWN"}  # non-positive timeout: loop never runs
    while time.monotonic() < deadline:
        try:
            st = cl.status(app_id)
        except (ConnectionError, OSError):
            time.sleep(0.25)
            continue
        if st["state"] in ("FINISHED", "FAILED", "LOST", "KILLED"):
            return st
        time.sleep(0.25)
    raise TimeoutError(f"app {app_id} still {st['state']}")

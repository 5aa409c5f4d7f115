"""ServingFrontend: replica registration + round-robin predict routing
with retry/circuit-breaker failover.

The write path got its process-level membership from
``parallel/supervisor.py``; the read path reuses exactly that machinery
-- an :class:`~asyncframework_tpu_torch.parallel.supervisor.ElasticSupervisor`
in ``adopt=False`` mode: replicas HELLO in (proc token, pid, host, serve
port), every successful RPC refreshes last-contact, a SIGKILLed local
replica is declared dead by the pid probe within one monitor scan and a
remote one by silence, and a restarted replica's re-HELLO revives its
slot.  Dead replicas simply leave the rotation; there is nothing to
adopt -- any healthy replica can answer any request.

Routing: round-robin over live slots, each RPC under a short
:class:`~asyncframework_tpu_torch.net.RetryPolicy` with the shared per-endpoint
circuit breakers -- a replica that keeps failing is skipped breaker-fast
-- and failover walks the remaining replicas until the per-request
deadline (``async.serve.failover.deadline.s``).  An UNHEALTHY reply (the
replica's own freshness-SLO gate) counts as failover, not error: the
frontend prefers a fresh replica over a stale answer and only raises
:class:`PredictError` when NOBODY healthy answered in time.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from asyncframework_tpu_torch.metrics import flightrec as _flight
from asyncframework_tpu_torch.net import RetryPolicy
from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.net.health import RttSuspector
from asyncframework_tpu_torch.net.retry import breaker_for
from asyncframework_tpu_torch.parallel.supervisor import (
    DEAD,
    SUSPECT,
    ElasticSupervisor,
)
from asyncframework_tpu_torch.serving import metrics as smetrics
from asyncframework_tpu_torch.serving.server import FramedServer

_send_msg = _frame.send_msg
_recv_msg = _frame.recv_msg


class PredictError(ConnectionError):
    """No healthy replica answered within the failover deadline."""


class _ReplicaChannel:
    """A pooled set of persistent connections to one replica,
    reconnect-on-error under a short retry policy (failover wants fast
    verdicts, not patience -- patience is the frontend's job, across
    replicas).  Pooling, not a single locked socket: concurrent client
    requests to the same replica must not serialize on the frontend --
    the replica's per-connection handler threads are the concurrency
    unit, so each in-flight RPC gets its own connection and idle ones
    are reused."""

    MAX_IDLE = 8

    def __init__(self, host: str, port: int, proc: str,
                 retry: RetryPolicy):
        self.host, self.port = host, int(port)
        self.endpoint = f"{host}:{self.port}"
        self.proc = proc
        self.retry = retry
        self._lock = threading.Lock()  # guards the idle list only
        self._idle: List[socket.socket] = []
        self._closed = False

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return _frame.connect((self.host, self.port),
                              timeout=self.retry.attempt_timeout_s)

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.MAX_IDLE:
                self._idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def _drop_idle(self) -> None:
        """One transport error condemns the whole idle pool: its sockets
        share the failed connection's fate (replica died/restarted) and
        burning a retry attempt per stale socket would eat the failover
        budget."""
        with self._lock:
            socks, self._idle = self._idle, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def call(self, header: dict, payload: bytes = b""
             ) -> Tuple[dict, bytes]:
        def attempt() -> Tuple[dict, bytes]:
            sock = self._checkout()
            try:
                _send_msg(sock, header, payload)
                out = _recv_msg(sock)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                self._drop_idle()
                raise
            self._checkin(sock)
            return out

        return self.retry.call(attempt, endpoint=self.endpoint)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._drop_idle()


class ServingFrontend(FramedServer):
    """Round-robin predict router over registered replicas.

    Library use: ``fe = ServingFrontend([(host, port), ...]).start()``
    then ``fe.predict(X)``.  Daemon use: ``fe.serve(port)`` additionally
    binds a front door that accepts replica HELLOs (dynamic registration)
    and client PREDICT frames (proxied through :meth:`predict_ex`).
    """

    def __init__(self, replicas: Optional[Sequence[Tuple[str, int]]] = None,
                 deadline_s: Optional[float] = None,
                 max_replicas: Optional[int] = None,
                 dead_after_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None):
        from asyncframework_tpu_torch.conf import (
            ELASTIC_DEAD_AFTER_S,
            SERVE_DEADLINE_S,
            SERVE_MAX_REPLICAS,
            global_conf,
        )

        conf = global_conf()
        super().__init__("serve-frontend")
        self.deadline_s = (float(deadline_s) if deadline_s is not None
                           else float(conf.get(SERVE_DEADLINE_S)))
        cap = (int(max_replicas) if max_replicas is not None
               else int(conf.get(SERVE_MAX_REPLICAS)))
        dead_after = (float(dead_after_s) if dead_after_s is not None
                      else float(conf.get(ELASTIC_DEAD_AFTER_S)))
        # the write path's membership machinery, serving mode: HELLO registration,
        # pid-probe/silence death detection, rejoin revival -- no adoption
        self.supervisor = ElasticSupervisor(
            cap, dead_after_s=dead_after, check_interval_s=0.2,
            adopt=False,
        )
        # ONE attempt per replica per sweep: failover IS the retry (the
        # predict loop re-sweeps the rotation until the deadline, so a
        # transient blip on one replica is retried on the next sweep),
        # and the attempt timeout is a QUARTER of the request deadline so
        # a blackholed replica (partition, SIGSTOP -- it times out rather
        # than refusing) can never eat the whole budget before the other
        # replicas get their turn.  Breakers shared process-wide by
        # endpoint.
        self.retry = retry if retry is not None else RetryPolicy.from_conf(
            max_attempts=1, base_ms=20.0, max_ms=200.0,
            attempt_timeout_s=max(0.25, self.deadline_s / 4.0),
        )
        self._lock = threading.Lock()
        self._channels: List[_ReplicaChannel] = []
        self._by_endpoint: Dict[str, int] = {}
        self._rr = 0
        # gray-failure detection: every answered predict's round trip
        # feeds a cohort RTT suspector; a replica that answers at a
        # multiple of its peers is SUSPECT -- demoted to the back of the
        # rotation (with the dead and breaker-open), never evicted on
        # latency alone
        self._gray = RttSuspector()
        for host, port in (replicas or ()):
            self.add_replica(host, port)

    # --------------------------------------------------------- registration
    def add_replica(self, host: str, port: int,
                    proc: Optional[str] = None,
                    pid: Optional[int] = None,
                    hostname: Optional[str] = None,
                    pid_start: Optional[float] = None) -> int:
        """Register (or revive) a replica; returns its slot index.  The
        proc token defaults to the endpoint, so a restarted replica on
        the same address re-HELLOs into its old slot."""
        endpoint = f"{host}:{int(port)}"
        proc = proc or endpoint
        member = self.supervisor.membership()
        with self._lock:
            idx = self._by_endpoint.get(endpoint)
            if idx is None and len(self._channels) >= \
                    self.supervisor.num_workers:
                # at capacity: reclaim a DEAD slot before refusing --
                # replica churn under k8s hands every replacement pod a
                # fresh IP, so without reclamation the slot table fills
                # with corpses and new replicas can never join
                for i, ch in enumerate(self._channels):
                    if member.get(i, {}).get("state") == DEAD:
                        ch.close()
                        del self._by_endpoint[ch.endpoint]
                        self._channels[i] = _ReplicaChannel(
                            host, port, proc, self.retry
                        )
                        self._by_endpoint[endpoint] = i
                        idx = i
                        smetrics.bump("replicas_registered")
                        break
                if idx is None:
                    raise ValueError(
                        f"replica capacity {self.supervisor.num_workers} "
                        f"exhausted (async.serve.max.replicas) and no "
                        f"dead slot to reclaim"
                    )
            elif idx is None:
                idx = len(self._channels)
                self._channels.append(
                    _ReplicaChannel(host, port, proc, self.retry)
                )
                self._by_endpoint[endpoint] = idx
                smetrics.bump("replicas_registered")
            else:
                self._channels[idx].proc = proc
        self.supervisor.register(proc, [idx], pid=pid, host=hostname,
                                 pid_start=pid_start)
        return idx

    def replica_count(self) -> int:
        with self._lock:
            return len(self._channels)

    def membership(self) -> Dict:
        """Per-slot membership view (the supervisor's, keyed by endpoint)."""
        member = self.supervisor.membership()
        with self._lock:
            return {
                ch.endpoint: member.get(i, {})
                for i, ch in enumerate(self._channels)
            }

    # -------------------------------------------------------------- routing
    def _rotation(self) -> List[_ReplicaChannel]:
        """Live replicas in round-robin order for ONE request: start
        rotates per call; supervisor-dead, SUSPECT (silence past the
        suspect threshold, or a gray-failure RTT outlier), and
        breaker-open slots sort to the back (still tried last -- a
        half-open probe is how a breaker closes, a revived replica is
        how a dead slot comes back, and a suspect that answers fast
        again un-suspects itself)."""
        member = self.supervisor.membership()
        with self._lock:
            n = len(self._channels)
            if n == 0:
                return []
            start = self._rr % n
            self._rr += 1
            order = [self._channels[(start + i) % n] for i in range(n)]
        preferred, backoff = [], []
        for ch in order:
            slot = self._by_endpoint.get(ch.endpoint, 0)
            state = member.get(slot, {}).get("state")
            if state == DEAD:
                # a corpse's frozen RTT EWMA must leave the cohort, or
                # it skews every later suspicion median; a revived
                # replica re-learns from scratch
                self._gray.forget(ch.endpoint)
            if state == SUSPECT and not self._gray.is_suspect(ch.endpoint):
                # the RTT suspicion expired (demotion starved the slot of
                # the traffic that would clear it -- the suspector's TTL
                # is the recovery path), or the suspicion was silence-
                # based, which a demoted replica can also never clear
                # (only predicts touch it): restore the slot to the
                # rotation and let it re-earn its verdict live
                self.supervisor.unsuspect(slot)
                state = None
            tripped = breaker_for(ch.endpoint).open
            (backoff if state in (DEAD, SUSPECT) or tripped
             else preferred).append(ch)
        return preferred + backoff

    def predict(self, X) -> np.ndarray:
        y, _meta = self.predict_ex(X)
        return y

    def predict_ex(self, X) -> Tuple[np.ndarray, Dict]:
        """Route one PREDICT; returns ``(predictions, meta)`` where meta
        carries the answering endpoint, served version, and freshness lag
        (versions + ms).  Raises :class:`PredictError` when no healthy
        replica answers within ``deadline_s``."""
        X = np.ascontiguousarray(np.atleast_2d(np.asarray(X, np.float32)))
        n = int(X.shape[0])
        payload = X.tobytes()
        deadline = time.monotonic() + self.deadline_s
        last_err: Optional[BaseException] = None
        first_try = True
        while True:
            rotation = self._rotation()
            for ch in rotation:
                if time.monotonic() >= deadline:
                    break
                t0 = time.monotonic()
                try:
                    hdr, body = ch.call({"op": "PREDICT", "n": n}, payload)
                except (ConnectionError, OSError) as e:
                    last_err = e
                    smetrics.observe_predict(ch.endpoint, 0.0, 0, 0.0, 0,
                                             ok=False)
                    if not first_try or len(rotation) > 1:
                        smetrics.bump("failovers")
                        # flight-recorder breadcrumb: a frontend dump
                        # ends with which replica it last failed over
                        # from (no-op when no recorder is installed)
                        _flight.note("failover", endpoint=ch.endpoint)
                    first_try = False
                    continue
                first_try = False
                slot = self._by_endpoint.get(ch.endpoint)
                if hdr.get("op") == "UNHEALTHY":
                    # the replica is alive but past its freshness SLO:
                    # contact still counts for membership, the answer
                    # does not
                    if slot is not None:
                        self.supervisor.touch(slot, ch.proc)
                    smetrics.note_attempt()
                    smetrics.bump("unhealthy_rejects")
                    smetrics.bump("failovers")
                    continue
                if hdr.get("op") != "PREDICTION":
                    # ERR-shaped failure (e.g. a malformed batch): this
                    # request failed for the caller -- it must count in
                    # the error view like the deadline path does
                    smetrics.bump("predict_errors")
                    raise PredictError(
                        f"replica {ch.endpoint} answered "
                        f"{hdr.get('op')!r}: {hdr.get('msg')}"
                    )
                if slot is not None:
                    self.supervisor.touch(slot, ch.proc)
                dur_ms = (time.monotonic() - t0) * 1e3
                if slot is not None:
                    # gray-failure feed: this answered RTT vs the cohort
                    if self._gray.observe(ch.endpoint, dur_ms):
                        self.supervisor.suspect(slot)
                    else:
                        self.supervisor.unsuspect(slot)
                meta = {
                    "endpoint": ch.endpoint,
                    "ts": int(hdr.get("ts", 0)),
                    "lag_versions": int(hdr.get("lag_versions", 0)),
                    "lag_ms": float(hdr.get("lag_ms", 0.0)),
                    "dur_ms": dur_ms,
                }
                smetrics.observe_predict(
                    ch.endpoint, dur_ms, meta["lag_versions"],
                    meta["lag_ms"], meta["ts"],
                )
                return np.frombuffer(body, np.float32).copy(), meta
            if time.monotonic() >= deadline:
                break
            # full sweep failed (or nothing registered yet): pace before
            # the next sweep -- open breakers fail fast, and a tight loop
            # here would spin the deadline away
            time.sleep(0.02)
        smetrics.bump("predict_errors")
        raise PredictError(
            f"no healthy replica answered within {self.deadline_s}s "
            f"({self.replica_count()} registered)"
        ) from last_err

    # ------------------------------------------------------------ front door
    def start(self) -> "ServingFrontend":
        """Start the membership monitor (library mode: no front door)."""
        self.supervisor.start()
        return self

    def serve(self, port: int = 0, host: str = "0.0.0.0"
              ) -> "ServingFrontend":
        """Additionally bind the front door: replica HELLOs (dynamic
        registration) and client PREDICT/STATUS frames."""
        self.start()
        self.bind(host, port)
        self.start_accepting()
        return self

    def handle_op(self, conn: socket.socket, op: Optional[str],
                  header: dict, payload: bytes) -> bool:
        if op == "HELLO" and header.get("replica"):
            # dynamic registration: connect back to the peer's IP (its
            # hostname may not resolve here) on its announced serve port;
            # pid+hostname feed the supervisor's local-pid death probe.
            # A refused registration (capacity truly exhausted) is an ERR
            # reply, never a dead handler thread.
            peer_ip = conn.getpeername()[0]
            try:
                idx = self.add_replica(
                    peer_ip, int(header["port"]),
                    proc=str(header.get("proc")),
                    pid=header.get("pid"),
                    hostname=header.get("host"),
                    pid_start=header.get("pstart"),
                )
            except ValueError as e:
                _send_msg(conn, {"op": "ERR", "msg": str(e)[:200]})
                return True
            _send_msg(conn, {"op": "WELCOME", "slot": idx})
        elif op == "PREDICT":
            n = int(header.get("n", 0))
            X = np.frombuffer(payload, np.float32)
            try:
                X = X.reshape(n, -1) if n > 0 else X
                y, meta = self.predict_ex(X)
            except (PredictError, ValueError) as e:
                _send_msg(conn, {"op": "ERR", "msg": str(e)[:200]})
                return True
            _send_msg(conn, {"op": "PREDICTION", **meta},
                      np.ascontiguousarray(y, np.float32).tobytes())
        elif op == "STATUS":
            _send_msg(conn, {
                "op": "STATUS",
                "replicas": self.membership(),
                "serving": smetrics.serving_snapshot(),
                "rtt": self._gray.snapshot(),
            })
        else:
            return False
        return True

    def stop(self) -> None:
        self.stop_server()
        self.supervisor.stop()
        with self._lock:
            for ch in self._channels:
                ch.close()

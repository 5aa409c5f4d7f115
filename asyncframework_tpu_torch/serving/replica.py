"""ModelReplica: a snapshot-subscribing predict server (the read path).

The training plane (parallel/ps_dcn.py) publishes versioned model
snapshots -- zero-copy wire bytes + CRC per version, ``have=``-negotiated
NM/delta pulls.  That machinery IS a replica cache-invalidation protocol
(ASYNC's versioned broadcast, arXiv:1907.08526; ASAP's staleness-bounded
reads, arXiv:1612.08608), so a replica is thin by construction:

- a **background refresh loop** sends ``SUBSCRIBE`` (a wave-gate-free,
  membership-free delta pull -- see ``ParameterServer._handle_subscribe``)
  every ``async.serve.refresh.interval.s``, through the stock
  :class:`~asyncframework_tpu_torch.parallel.ps_dcn.PSClient` basis-cache /
  CRC-fallback machinery: an unchanged version costs a header-only
  NOT_MODIFIED, a changed one a sparse XOR delta, and ANY decode mismatch
  degrades to a full pull -- the replica can lag, never hold a wrong
  model;
- the current model lives behind an **atomic reference swap**
  (:class:`_Served` -- version, host array and device tensor, PS clock,
  freshness basis), so PREDICT handlers read ONE reference and compute
  against a coherent (version, weights) pair: a torn model is
  unrepresentable.  Each new version gets a new device tensor, copied
  with a blocking copy before the swap, and a published tensor is never
  written in place: a handler still holding an old reference computes
  against the old version's bytes, kept alive by that reference;
- **PREDICT** RPCs (single row or batched) run the ``ops`` predict step
  (``ops/steps.make_predict_step``, plain f32 with TF32 off) on the
  replica's device, batch sizes bucketed to powers of two as in the JAX
  package, so a mixed request stream meets O(log n) shapes.  The
  handler's copy of the result to the host is its sync point;
- **freshness-lag SLO**: every reply is stamped with the served version
  and its lag in versions (PS clock - served ts) and ms; a replica whose
  last successful refresh is older than ``async.serve.max.staleness.ms``
  marks itself UNHEALTHY and the frontend fails over -- unless training
  is DONE and the replica already holds the final version, in which case
  it is fresh forever (the PS tearing down must not take reads with it).

The wire rides ``net/frame.py``, so SUBSCRIBE and PREDICT are
fault-schedulable ops for the chaos fabric like any other verb.

The device is ``cuda`` unless the caller gives one; without a card and
without a device the replica raises, never falling back to the CPU.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.parallel.ps_dcn import PSClient
from asyncframework_tpu_torch.serving import metrics as smetrics
from asyncframework_tpu_torch.serving.server import FramedServer
from asyncframework_tpu_torch.utils.devices import canonical, resolve_devices
from asyncframework_tpu_torch.utils.threads import guarded

_send_msg = _frame.send_msg
_recv_msg = _frame.recv_msg


class _Served:
    """One atomically-published served model: immutable once built, so a
    PREDICT handler that read the reference computes against a coherent
    (version, weights) pair no matter how many refreshes land meanwhile."""

    __slots__ = ("ts", "w_host", "w_dev", "clock", "k", "age_ms",
                 "refreshed_mono", "done")

    def __init__(self, ts: int, w_host: np.ndarray, w_dev, clock: int,
                 k: int, age_ms: float, refreshed_mono: float, done: bool):
        self.ts = ts
        self.w_host = w_host
        self.w_dev = w_dev
        self.clock = clock
        self.k = k
        self.age_ms = age_ms
        self.refreshed_mono = refreshed_mono
        self.done = done


class ModelReplica(FramedServer):
    """Subscribe to the PS's versioned snapshots; answer PREDICT RPCs.

    ``start()`` binds the predict server and launches the refresh loop;
    ``refresh_once()`` is the loop body, public so tests can drive the
    subscription deterministically.  ``stop()`` tears both down.
    """

    def __init__(self, ps_host: str, ps_port: int, rid: int = 0,
                 host: str = "0.0.0.0", port: int = 0,
                 loss: str = "least_squares",
                 refresh_interval_s: Optional[float] = None,
                 max_stale_ms: Optional[float] = None,
                 device=None,
                 relay_port: Optional[int] = None,
                 relay_parent: Optional[tuple] = None):
        from asyncframework_tpu_torch.conf import (
            SERVE_MAX_STALE_MS,
            SERVE_REFRESH_S,
            global_conf,
        )

        conf = global_conf()
        super().__init__(f"replica-{int(rid)}")
        self.ps_host, self.ps_port = ps_host, int(ps_port)
        self.rid = int(rid)
        self.loss = loss
        self.refresh_interval_s = (
            float(refresh_interval_s) if refresh_interval_s is not None
            else float(conf.get(SERVE_REFRESH_S))
        )
        self.max_stale_ms = (
            float(max_stale_ms) if max_stale_ms is not None
            else float(conf.get(SERVE_MAX_STALE_MS))
        )
        # the served model's device: the caller's, else the first card
        # (resolve_devices raises without one -- no CPU fallback)
        self.device = (canonical(device) if device is not None
                       else resolve_devices()[0])
        # relaycast (asyncframework_tpu_torch/relaycast/): relay_port is not
        # None = this replica runs a RelayNode next to its predict
        # server and fetches through the distribution tree --
        # relay_parent names its planned parent's relay endpoint (None =
        # a direct child of the PS root, which SUBSCRIBEs as usual and
        # re-serves its children).  The fetch path falls back to a
        # direct root SUBSCRIBE on ANY relay failure, so relay mode can
        # lag, never regress safety.
        self.relay_port = relay_port
        self.relay_parent = (tuple(relay_parent) if relay_parent
                             else None)
        self._relay_node = None
        if relay_port is not None:
            # bind EAGERLY (like the predict server below): children may
            # dial this node before our first refresh lands -- they get
            # an honest "no model yet" ERR and fall back to the root,
            # instead of a connection refused that looks like death
            from asyncframework_tpu_torch.relaycast import RelayNode

            self._relay_node = RelayNode(rid=self.rid,
                                         port=int(relay_port),
                                         on_offer=self._on_relay_offer)
        self._predict_step = None   # built lazily with the first model
        self._served: Optional[_Served] = None  # ATOMIC reference swap
        self.d: Optional[int] = None
        self._client: Optional[PSClient] = None
        self._last_ok_mono: Optional[float] = None
        # local observability (shipped on STATUS; process-global serving
        # counters are bumped too so an in-process replica shows up in
        # /api/status next to the frontend's numbers)
        self.predicts = 0
        self.predict_unhealthy = 0
        self.refreshes = 0
        self.refresh_errors = 0
        self._stats_lock = threading.Lock()
        # serializes refresh_once: the background loop and any manual
        # caller (tests, an admin resync) share ONE PSClient connection,
        # and interleaved send/recv on a framed stream desyncs it
        self._refresh_lock = threading.Lock()
        self._refresh_thread: Optional[threading.Thread] = None
        self.bind(host, port)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ModelReplica":
        self.start_accepting()
        if self._relay_node is not None:
            self._relay_node.start()
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, name=f"replica-{self.rid}-refresh",
            daemon=True,
        )
        self._refresh_thread.start()
        return self

    def stop(self) -> None:
        self.stop_server()
        if self._relay_node is not None:
            self._relay_node.stop()
        if self._client is not None:
            # the refresh thread shares this client's connection: say BYE
            # only once any in-flight refresh has drained (bounded wait --
            # a refresh stuck in its retry budget just forfeits the BYE;
            # the PS treats EOF as goodbye)
            if self._refresh_lock.acquire(timeout=2.0):
                try:
                    self._client.bye()
                except (ConnectionError, OSError):
                    pass
                finally:
                    self._refresh_lock.release()

    # -------------------------------------------------------------- refresh
    def _ensure_client(self):
        if self._client is None:
            # shard-map resolution first (one SHARDMAP round trip): a
            # sharded PS group answers its per-range map and the replica
            # subscribes every range (shardgroup.ShardedSubscriber --
            # partial refresh + per-range freshness); the classic single
            # PS answers empty and gets the stock client.  Delta mode
            # unconditionally either way: the refresh loop is exactly the
            # workload NM/XDELTA negotiation exists for (the CRC fallback
            # keeps it degrade-to-full, never wrong).
            from asyncframework_tpu_torch.parallel import shardgroup as _sg

            smap, epochs, epoch = _sg.fetch_group_info(
                self.ps_host, self.ps_port
            )
            # fencing epochs ride the same handshake: a fenced (zombie)
            # shard answers the subscriber's stamped reads REJECT_FENCED
            # instead of serving a range it no longer owns, and the
            # subscriber self-heals onto the replacement's epoch
            if smap is not None:
                # relay + shard group is not a supported combination:
                # per-range relays would need a per-shard tree each --
                # the sharded subscriber's fan-out pull is the path
                self._client = _sg.ShardedSubscriber(smap, epochs=epochs)
            elif self._relay_node is not None:
                from asyncframework_tpu_torch.relaycast import RelaySource

                node = self._relay_node
                if epoch and epoch > node.epoch:
                    node.epoch = int(epoch)
                self._client = RelaySource(
                    self.ps_host, self.ps_port, node,
                    parent=self.relay_parent, rid=self.rid,
                )
            else:
                self._client = PSClient(self.ps_host, self.ps_port,
                                        pull_mode="delta", epoch=epoch)
        return self._client

    def _on_relay_offer(self) -> None:
        """A parent (or the PS root) announced a new version: refresh
        NOW instead of waiting out the poll interval.  Serialized by the
        refresh lock like every other caller; failures are the refresh
        path's problem (counted there), never the offer handler's."""
        try:
            self.refresh_once()
        except (ConnectionError, OSError):  # pragma: no cover - paced
            pass                            # retry on the poll loop

    def _sharded(self):
        """The ShardedSubscriber when this replica reads a shard group,
        else None (duck-typing on the one surface that differs)."""
        cl = self._client
        return cl if hasattr(cl, "stale_ranges") else None

    def refresh_once(self) -> bool:
        """One SUBSCRIBE round trip; True iff a (possibly unchanged) model
        was validated and (re)published.  Transport errors surface as
        False -- the loop paces and retries; the served reference is only
        ever replaced by a CRC-validated model.  Serialized against the
        background loop (one connection, framed stream)."""
        with self._refresh_lock:
            return self._refresh_once_locked()

    def _refresh_once_locked(self) -> bool:
        try:
            cl = self._ensure_client()
            wenc_before = dict(cl.pull_wenc)
            fb_before = cl.delta_fallbacks
            got = cl.subscribe(self.rid)
        except (ConnectionError, OSError):
            with self._stats_lock:
                self.refresh_errors += 1
            smetrics.bump("refresh_errors")
            return False
        if got is None:  # pragma: no cover - SUBSCRIBE never says DONE
            return False
        ts, w_host, clock, k, age_ms, done = got
        for shape, n in cl.pull_wenc.items():
            delta = n - wenc_before.get(shape, 0)
            if delta:
                smetrics.bump(f"refresh_{shape}", delta)
        if cl.delta_fallbacks > fb_before:
            smetrics.bump("refresh_fallbacks",
                          cl.delta_fallbacks - fb_before)
        prev = self._served
        if (prev is not None and prev.ts == ts
                and not getattr(cl, "changed_since_last", False)):
            # unchanged version (NM fast path): reuse the device buffer,
            # refresh only the freshness bookkeeping.  Against a shard
            # group ts is a SUM of per-shard versions, and a shard
            # restart rolls its clock back -- sum collisions happen, so
            # the subscriber's vector-compare flag gates the reuse (a
            # stock PSClient has no flag: its ts is a single monotone
            # clock and equality IS identity)
            w_dev = prev.w_dev
        else:
            # a NEW device tensor for every new version, by a blocking
            # copy: it has landed before the swap below publishes it, so a
            # handler on another thread (and stream) that reads the new
            # reference can never see a partly-copied model
            w_dev = torch.tensor(np.asarray(w_host, np.float32),
                                 device=self.device)
        if self.d is None:
            self.d = int(w_host.shape[0])
        if self._predict_step is None:
            from asyncframework_tpu_torch.ops import steps

            if self.device.type == "cuda":
                # the served product is plain f32: the replica does not
                # leave that to whoever started its process
                torch.backends.cuda.matmul.allow_tf32 = False
            self._predict_step = steps.make_predict_step(self.loss)
        now = time.monotonic()
        # the atomic swap: PREDICT handlers holding the old reference keep
        # serving the old (coherent) version; new reads see the new one
        self._served = _Served(ts, w_host, w_dev, clock, k, age_ms, now,
                               done)
        self._last_ok_mono = now
        with self._stats_lock:
            self.refreshes += 1
        smetrics.bump("refreshes")
        return True

    def _refresh_loop(self) -> None:
        while not self._stop.is_set():
            ok = self.refresh_once()
            served = self._served
            if self._final(ok, served):
                return
            self._stop.wait(self.refresh_interval_s if ok else
                            max(self.refresh_interval_s, 0.05))

    def _final(self, ok: bool, served: Optional[_Served]) -> bool:
        """Whether the refresh loop may stop: training finished and the
        PS has gone after its run, so the model can never change again --
        serve the last validated version forever.

        The JAX package's replica stops at the first reply that says DONE
        with ``ts >= clock``.  A DONE reply can precede the run's last
        model, though: the PS's drain sets DONE inside its loop, before it
        applies the batch that reached the budget, and a secondary shard
        learns DONE from the primary's FINISH but goes on applying the
        pushes already in flight to it.  So after DONE the loop goes on
        until the PS stops answering (against a group: until every range
        has)."""
        if served is None or not served.done:
            return False
        sub = self._sharded()
        if sub is None:
            return not ok
        return sub.all_ranges_dark()

    # ------------------------------------------------------------ freshness
    def _lag(self, served: _Served) -> Dict[str, float]:
        """Freshness lag of ``served`` NOW, in versions and ms.

        versions = PS clock at last refresh minus served version (the
        send-time re-stamp on SUBSCRIBE makes this 0 when only dropped
        pushes ticked the clock).  ms = the PS-reported age of the served
        version at reply time plus time since that reply when the replica
        KNOWS it is behind; otherwise time-since-refresh alone -- an upper
        bound on how stale the replica could possibly be (versions may
        have appeared since the last refresh).  A replica holding the
        final version of a DONE run is fresh forever."""
        now = time.monotonic()
        lag_v = max(0, served.clock - served.ts)
        since_ms = (now - served.refreshed_mono) * 1e3
        if served.done and lag_v == 0:
            return {"lag_versions": 0, "lag_ms": 0.0}
        if lag_v > 0:
            return {"lag_versions": lag_v,
                    "lag_ms": served.age_ms + since_ms}
        return {"lag_versions": 0, "lag_ms": since_ms}

    def healthy(self) -> bool:
        """False once the last successful refresh is older than the
        ``async.serve.max.staleness.ms`` SLO (0 = no gate) -- except for a
        replica holding the final version of a finished run, which cannot
        go stale."""
        served = self._served
        if served is None:
            return False  # no model yet: nothing correct to serve
        if served.done and served.ts >= served.clock:
            return True
        if self.max_stale_ms <= 0:
            return True
        sub = self._sharded()
        if sub is not None:
            # per-range gate: a partially-dark group keeps publishing
            # (live ranges refresh), so health must price the STALEST
            # range, not the last assembled publish
            age = sub.oldest_ok_age_ms()
            return age is not None and age <= self.max_stale_ms
        last_ok = self._last_ok_mono
        return (last_ok is not None
                and (time.monotonic() - last_ok) * 1e3 <= self.max_stale_ms)

    def status(self) -> Dict:
        served = self._served
        with self._stats_lock:
            out = {
                "rid": self.rid,
                "port": self.port,
                "healthy": self.healthy(),
                "predicts": self.predicts,
                "predict_unhealthy": self.predict_unhealthy,
                "refreshes": self.refreshes,
                "refresh_errors": self.refresh_errors,
                "device": str(self.device),
            }
        cl = self._client
        if cl is not None:
            out["refresh_wenc"] = dict(cl.pull_wenc)
            out["refresh_fallbacks"] = cl.delta_fallbacks
        sub = self._sharded()
        if sub is not None:
            # UNHEALTHY-per-range surface: which ranges are fresh, which
            # are dark, and how stale the stalest is
            out["ranges"] = sub.range_status()
            if self.max_stale_ms > 0:
                out["stale_ranges"] = sub.stale_ranges(self.max_stale_ms)
        node = self._relay_node
        if node is not None:
            # relaycast surface: tree position, learned children, fetch
            # traffic, and how this replica is currently sourcing bytes
            relay = node.status()
            relay["parent"] = (list(self.relay_parent)
                               if self.relay_parent else None)
            if cl is not None:
                relay["via_parent"] = getattr(cl, "via_parent", 0)
                relay["via_root"] = getattr(cl, "via_root", 0)
            out["relay"] = relay
        if served is not None:
            out.update(ts=served.ts, clock=served.clock, k=served.k,
                       **self._lag(served))
        return out

    # ------------------------------------------------------------- serving
    def handle_op(self, conn: socket.socket, op: Optional[str],
                  header: dict, payload: bytes) -> bool:
        if op == "PREDICT":
            self._handle_predict(conn, header, payload)
        elif op == "STATUS":
            _send_msg(conn, {"op": "STATUS", **self.status()})
        else:
            return False
        return True

    def _handle_predict(self, conn: socket.socket, header: dict,
                        payload: bytes) -> None:
        served = self._served
        if served is None or not self.healthy():
            with self._stats_lock:
                self.predict_unhealthy += 1
            lag = self._lag(served) if served is not None else {}
            sub = self._sharded()
            if sub is not None and self.max_stale_ms > 0:
                # name the dark ranges: the caller learns WHICH slice of
                # the model went stale, not just that something did
                lag["stale_ranges"] = sub.stale_ranges(self.max_stale_ms)
            _send_msg(conn, {"op": "UNHEALTHY", "rid": self.rid, **lag})
            return
        n = int(header.get("n", 0))
        d = served.w_host.shape[0]
        if n <= 0 or len(payload) != 4 * n * d:
            _send_msg(conn, {"op": "ERR",
                             "msg": f"PREDICT wants n*d={n}*{d} f32 rows, "
                                    f"got {len(payload)} bytes"})
            return
        X = np.frombuffer(payload, np.float32).reshape(n, d)
        y = self._predict(served, X)
        lag = self._lag(served)
        with self._stats_lock:
            self.predicts += 1
        smetrics.bump("replica_predicts")
        _send_msg(
            conn,
            {"op": "PREDICTION", "rid": self.rid, "n": n,
             "ts": served.ts, **lag},
            np.ascontiguousarray(y, np.float32).tobytes(),
        )

    def _predict(self, served: _Served, X: np.ndarray) -> np.ndarray:
        """The predict step against the served weights; batch rows
        padded to the next power of two, as the JAX package pads them, so
        shapes stay O(log n) across a mixed request stream.  The rows are
        staged in a fresh host array (the request payload is read-only)
        and copied to the device by a blocking copy; ``.cpu()`` of the
        result waits for the product."""
        n = X.shape[0]
        cap = 1 << max(0, (n - 1).bit_length())
        Xp = np.zeros((cap, X.shape[1]), np.float32)
        Xp[:n] = X
        X_dev = torch.from_numpy(Xp).to(self.device)
        y = self._predict_step(X_dev, served.w_dev)
        return y.cpu().numpy()[:n]


def serve_replica(ps: str, rid: int = 0, host: str = "0.0.0.0",
                  port: int = 0, loss: str = "least_squares",
                  frontend: Optional[str] = None,
                  announce=print,
                  hello_interval_s: float = 2.0,
                  relay_port: Optional[int] = None,
                  relay_parent: Optional[str] = None,
                  device=None) -> ModelReplica:
    """CLI helper (``serving.cli replica``): start a replica, keep it
    registered with a frontend, and announce the bound port as one JSON
    line on stdout (launchers parse it).

    Registration is a LOOP, not a one-shot: HELLO is idempotent (same
    endpoint -> same slot) and doubles as a liveness heartbeat, so a
    restarted frontend rebuilds its rotation from the replicas' next
    HELLOs instead of starting a permanent empty-rotation outage, and a
    frontend that was down at replica boot is joined as soon as it
    appears."""
    import json

    ps_host, ps_port = ps.rsplit(":", 1)
    rparent = None
    if relay_parent:
        ph, pp = relay_parent.rsplit(":", 1)
        rparent = (ph, int(pp))
    rep = ModelReplica(ps_host, int(ps_port), rid=rid, host=host,
                       port=port, loss=loss, relay_port=relay_port,
                       relay_parent=rparent, device=device).start()
    if frontend:
        fh, fp = frontend.rsplit(":", 1)

        def hello_once() -> None:
            from asyncframework_tpu_torch.parallel.supervisor import (
                proc_start_time,
            )

            sock = _frame.connect((fh, int(fp)), timeout=5.0)
            try:
                hdr = {"op": "HELLO",
                       "proc": f"replica-{os.getpid()}",
                       "replica": True, "port": rep.port,
                       "host": socket.gethostname(),
                       "pid": os.getpid(), "rid": rid}
                pstart = proc_start_time(os.getpid())
                if pstart is not None:
                    # pid-reuse protection for the frontend's local pid
                    # probe: WHICH process holds this pid, not just that
                    # one does
                    hdr["pstart"] = pstart
                _send_msg(sock, hdr)
                _recv_msg(sock)
            finally:
                sock.close()

        def hello_loop() -> None:
            while not rep._stop.wait(hello_interval_s):
                try:
                    hello_once()
                except (ConnectionError, OSError):
                    pass  # frontend down/restarting: next beat retries

        try:
            hello_once()
        except (ConnectionError, OSError):
            pass  # not fatal: the loop below keeps trying
        threading.Thread(target=guarded(hello_loop, f"replica-{rid}-hello"),
                         name=f"replica-{rid}-hello",
                         daemon=True).start()
    line = {"role": "replica", "rid": rid, "port": rep.port,
            "pid": os.getpid()}
    if rep._relay_node is not None:
        # the node bound in __init__, so an ephemeral ask announces the
        # real port and launchers learn the tree endpoint here
        line["relay_port"] = int(rep._relay_node.port)
    announce(json.dumps(line), flush=True)
    return rep

"""Hot-standby shard replication: primary -> standby merge-batch streaming.

Counterpart of ``asyncframework_tpu/parallel/replication.py``, in the
PyTorch package: the same stream, byte-identical on the wire, so a standby
of either package follows a primary of the other.  Classic primary-backup
replication, shaped by ASAP's observation (arXiv:1612.08608) that the
bounded-staleness semantics the training plane already ships are what lets
a slightly-behind replica take over without violating correctness:

- each shard **primary** streams its accepted merge batches to a warm
  **standby** process over the ``REPL_SYNC`` / ``REPL_APPEND`` plane: one
  full-state bootstrap (the checkpoint image -- model, merge clock, dedup
  window, trajectory), then every drained batch post-dedup,
  post-admission, with each item's ``(sid, seq)`` stamp, verdict,
  staleness and step-DAMP factor, stamped with the primary's merge clock
  (``pre``) and fencing epoch.  The standby applies the batches through
  the same apply function in the same order, so its state is the
  primary's, a bounded number of merges behind (the replication lag);
- on lease expiry the :class:`~asyncframework_tpu_torch.parallel.shardgroup.
  ShardGroup` controller **promotes** the standby (``PROMOTE``) under the
  slot's freshly-minted fencing epoch instead of relaunching a process:
  failover costs suspicion time plus one RPC, not checkpoint replay.  The
  epoch is the promotion-safety primitive -- the deposed primary's
  post-promotion stream appends (and any worker op still routed at it)
  are ``REJECT_FENCED``, and because the standby's dedup window is
  REPLICATED, a worker replaying an applied-but-unACKed push against the
  promoted standby is re-answered from cache, never merged twice (dedup
  strictly precedes fencing, ``net/session.py`` contract);
- standbys double as **read replicas**: ``SUBSCRIBE`` is served from the
  standby's mirrored snapshot, with staleness priced by its replication
  lag -- surfaced as the ``ps.standby_lag`` time series and the default
  ``standby_lag`` SLO rule.

Exactly-once across the failover: an accepted push exists in exactly one
of three places when the primary dies -- (a) applied+streamed: the standby
holds both its effect and its dedup record, so a replay re-ACKs from
cache; (b) applied+unstreamed (still in this sender's queue): its effect
is LOST with the primary, exactly like a push the taw filter dropped --
the worker's replay carries a stale epoch stamp and is ``REJECT_FENCED``,
so it is dropped, not re-applied against diverged state; (c) never
applied: the replay is fenced too and the round is simply lost.  Nothing
is ever applied twice.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.net import shmring as _shmring

# ------------------------------------------------------------ repl totals
# Process-global replication counters (metrics/registry.py family
# "replication"): the primary-side stream and the standby-side appliers
# bump them in whichever process hosts them -- the same per-process
# discipline as every other family.
_totals_lock = threading.Lock()
_totals: Dict[str, int] = {}


def repl_totals() -> Dict[str, int]:
    """Replication counters: batches_streamed / items_streamed /
    syncs_sent (primary sender), appends_applied / append_items /
    sync_installs (standby applier), resyncs + resyncs_requested (gap
    recoveries, both ends), stream_reconnects, queue_overflows (slow
    standby: queue dropped, full re-sync scheduled), fenced_streams
    (a deposed primary's stream hit REJECT_FENCED and parked),
    promotions (standbys promoted to primary, standby-side)."""
    with _totals_lock:
        return dict(_totals)


def reset_repl_totals() -> None:
    """Zero the process-global replication counters (per-run isolation;
    see ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    with _totals_lock:
        _totals.clear()


def bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] = _totals.get(key, 0) + n


class ReplicationStream:
    """The primary-side sender: a bounded queue of drained merge batches
    and one guarded thread that streams them to the shard's standby.

    Lifecycle: connect -> ``REPL_SYNC`` (full checkpoint image, captured
    under the model lock, serialized and sent OFF it) -> ``REPL_APPEND``
    per batch, each ACKed with the standby's applied clock (the lag
    signal).  Any transport fault, queue overflow, or standby-reported
    gap (``resync``) drops the queue and schedules a fresh sync -- the
    stream can always re-bootstrap, so a flapping standby costs
    bandwidth, never correctness.  A ``REJECT_FENCED`` reply means a
    successor epoch exists: THIS primary is deposed -- the stream parks
    permanently and the foreign epoch is folded back into the server
    (:meth:`ParameterServer.note_fenced_above`) so worker ops start
    bouncing too and clients re-resolve onto the promoted standby.

    :meth:`enqueue` is called under the PS model lock and is O(items)
    list work -- serialization and every byte of I/O happen on the
    sender thread.
    """

    def __init__(self, ps, host: str, port: int, queue_max: int = 256):
        self.ps = ps
        self.host, self.port = host, int(port)
        self.queue_max = max(2, int(queue_max))
        self._q: "deque" = deque()
        self._cv = threading.Condition()
        self._need_sync = True
        self._sock = None
        # shm-ring transport (net/shmring.py): a colocated standby's
        # REPL stream is the highest-rate colocated flow in the system,
        # so each fresh dial attempts the upgrade; any ring failure pins
        # this stream back to TCP (the existing reconnect machinery IS
        # the degrade path -- drop, resync, re-dial plain)
        self._shm_failed = False
        self.synced = False
        self.fenced = False
        #: the standby's last ACKed applied clock -- primary_clock minus
        #: this is the replication lag in merge units (ps.standby_lag)
        self.acked_clock = -1
        self.last_ack_mono: Optional[float] = None
        self._stop = threading.Event()
        from asyncframework_tpu_torch.utils.threads import guarded

        self._thread = threading.Thread(
            target=guarded(self._run, "ps-repl-stream"),
            name=f"ps-repl-{self.host}:{self.port}", daemon=True,
        )
        self._thread.start()

    # ------------------------------------------------------------ producer
    def enqueue(self, pre_clock: int, items: List[list],
                grads: List[np.ndarray], cal: List[float]) -> None:
        """One drained merge batch (caller holds the PS model lock).
        ``items`` = ``[wid, ts, accepted, sid, seq, ack, staleness,
        damp]`` per drained push in FIFO order (``damp`` = the
        delay-adaptive step factor the primary applied; the mirror must
        apply the identical one); ``grads`` = the accepted items'
        dense host gradients in the same order; ``cal`` = the primary's
        calibration triple.  A full queue (standby slow or dark) drops
        everything and schedules a re-sync -- bounded memory, and the
        sync carries the state the dropped batches would have built."""
        if self.fenced or self._stop.is_set():
            return
        with self._cv:
            if len(self._q) >= self.queue_max:
                self._q.clear()
                self._need_sync = True
                bump("queue_overflows")
            self._q.append((int(pre_clock), items, grads, list(cal)))
            self._cv.notify()

    def lag_versions(self) -> int:
        """Merge units the standby is behind (primary's clock minus the
        last ACKed applied clock; the whole clock while unsynced)."""
        if not self.synced:
            return int(self.ps._clock)
        return max(0, int(self.ps._clock) - int(self.acked_clock))

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._drop_sock()
        self._thread.join(timeout=5.0)

    # -------------------------------------------------------------- sender
    def _drop_sock(self) -> None:
        sock = self._sock
        self._sock = None
        if sock is not None:
            if isinstance(sock, _shmring.ShmSocket):
                # never resurrect a dropped ring blind: the next dial
                # stays on TCP so the reconnect loop converges
                self._shm_failed = True
            try:
                sock.close()
            except OSError:
                pass

    def _ensure_sock(self):
        if self._sock is None:
            sock = _frame.connect((self.host, self.port), timeout=5.0)
            sock.settimeout(15.0)
            if not self._shm_failed:
                sock, _ = _shmring.maybe_upgrade(sock)
            self._sock = sock
        return self._sock

    def _stamped(self, hdr: dict) -> dict:
        """The replication plane's ep-stamp choke point (pinned by
        async-lint next to PSClient._proc_hdr): every stream frame
        carries the primary's CURRENT fencing epoch, so a deposed
        incarnation's appends are exactly the stale-stamp shape the
        standby's admission rejects."""
        if self.ps.epoch:
            hdr["ep"] = self.ps.epoch
        return hdr

    def _pop(self, timeout_s: float):
        with self._cv:
            if not self._q and not self._stop.is_set():
                self._cv.wait(timeout=timeout_s)
            if not self._q:
                return None
            return self._q.popleft()

    def _reply(self, header: dict, payload: bytes):
        sock = self._ensure_sock()
        _frame.send_msg(sock, header, payload)
        reply, _ = _frame.recv_msg(sock)
        return reply

    def _note_reply(self, reply: dict) -> bool:
        """Fold one standby reply; False = stop processing this round."""
        op = reply.get("op")
        if op == "REJECT_FENCED":
            # a successor epoch exists for this range: we are the
            # deposed primary.  Park forever and tell the server so its
            # worker-facing admission starts bouncing stamped ops too --
            # that bounce is what drives clients to re-resolve onto the
            # promoted standby.
            self.fenced = True
            bump("fenced_streams")
            self.ps.note_fenced_above(int(reply.get("epoch", 0) or 0))
            return False
        if op == "ERR":
            if reply.get("resync"):
                self._need_sync = True
                self.synced = False
                bump("resyncs")
                return False
            raise ConnectionError(
                f"standby refused stream: {reply.get('msg')!r}")
        self.acked_clock = int(reply.get("clock", self.acked_clock))
        self.last_ack_mono = time.monotonic()
        return True

    def _send_sync(self) -> None:
        # drop whatever is queued FIRST: the image captured below
        # already contains those batches' effects, and replaying them
        # after it would read as duplicates (harmless, but wasteful)
        with self._cv:
            self._q.clear()
        with self.ps._lock:
            state = self.ps._checkpoint_state()
        buf = io.BytesIO()
        np.savez(buf, __meta__=json.dumps(state["meta"]),
                 **state["arrays"])
        reply = self._reply(self._stamped({"op": "REPL_SYNC"}),
                            buf.getvalue())
        if self._note_reply(reply):
            self._need_sync = False
            self.synced = True
            bump("syncs_sent")

    def _send_append(self, batch) -> None:
        pre_clock, items, grads, cal = batch
        hdr = self._stamped({"op": "REPL_APPEND", "pre": pre_clock,
                             "items": items, "cal": cal})
        payload = b"".join(
            np.ascontiguousarray(g, np.float32).tobytes() for g in grads
        )
        if self._note_reply(self._reply(hdr, payload)):
            bump("batches_streamed")
            bump("items_streamed", len(items))

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.fenced:
                self._stop.wait(0.5)
                continue
            try:
                if self._need_sync:
                    self._send_sync()
                    continue
                batch = self._pop(0.2)
                if batch is None:
                    continue
                self._send_append(batch)
            except (ConnectionError, OSError):
                self._drop_sock()
                self.synced = False
                self._need_sync = True
                with self._cv:
                    self._q.clear()
                bump("stream_reconnects")
                self._stop.wait(0.3)

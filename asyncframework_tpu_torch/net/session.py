"""Exactly-once-applied client sessions: op sequence numbers + server-side
dedup windows.

The retry layer (``net/retry.py``) makes lost-reply faults *survivable*;
this module makes retrying them *safe*.  Round-5 ADVICE caught the concrete
hole: ``RemoteLogTopic._call`` re-sent APPEND after a lost reply and the
topic grew duplicate records.  The same hazard sits under PUSH (a gradient
applied twice) and SUBMIT_APP (an app scheduled twice).

Mechanism (the classic at-least-once -> exactly-once-applied bridge):

- a client mints a :class:`ClientSession` -- a process-unique ``sid`` plus
  a monotonically increasing per-op ``seq``.  A *logical* op is stamped
  once; every retry re-sends the SAME ``(sid, seq)``.
- a server keeps a :class:`DedupWindow`: for each session, the last
  ``window`` applied seqs with their cached replies.  A request whose
  ``(sid, seq)`` is already present is NOT re-applied -- the cached reply
  is re-sent (the reply the wire ate).

Windows are bounded two ways (per-session entries, total sessions, both
LRU) because sessions come and go with worker churn; a legitimate retry
arrives within one retry-policy deadline, not hours later.  Unstamped
requests pass straight through -- old clients keep working, they just
keep the old at-least-once semantics.

Sharded-PS contract (``parallel/shardgroup.py``): sessions are strictly
**per shard**.  Each of a ``ShardedPSClient``'s sub-clients mints its own
:class:`ClientSession`, each shard keeps its own :class:`DedupWindow`,
and each window rides its shard's durable checkpoint
(``state()``/``load_state()``, captured under the model lock) -- so when
a fan-out round is abandoned mid-flight and replayed, every shard judges
its OWN ``(sid, seq)`` history independently: the sub-pushes that landed
before the fault are re-answered from cache (on a restarted shard, from
the RESTORED window), the ones that never arrived apply fresh.  Nothing
in this module is shard-aware; the guarantee composes because the stamps
never cross shard boundaries.

Epoch-fencing contract (``async.fence.enabled``, parallel/ps_dcn.py):
dedup STRICTLY precedes fencing on the server -- an op this incarnation
already applied re-answers its cached verdict whatever epochs say (the
applied state is the truth), and a REJECT_FENCED verdict is itself
``record()``-ed so retries of a fenced stamp re-answer the fence rather
than racing a fresh admission.  Windows and fences therefore never
disagree: a stamp is applied-once, fenced-once, or unseen.
"""

from __future__ import annotations

import base64
import threading
import uuid
from collections import OrderedDict
from typing import Optional, Tuple

_totals_lock = threading.Lock()
_dedup_hits_total = 0


def dedup_hits_total() -> int:
    """Process-wide dedup hits across every server window (live UI)."""
    with _totals_lock:
        return _dedup_hits_total


def reset_dedup_hits_total() -> None:
    """Zero the process-wide counter (per-run isolation; see
    ``asyncframework_tpu_torch.metrics.reset_totals``)."""
    global _dedup_hits_total
    with _totals_lock:
        _dedup_hits_total = 0


def _bump_hits() -> None:
    global _dedup_hits_total
    with _totals_lock:
        _dedup_hits_total += 1


class ClientSession:
    """Mints ``(sid, seq)`` stamps.  One per client object; thread-safe so
    a client shared across threads still never reuses a seq."""

    def __init__(self, sid: Optional[str] = None):
        self.sid = sid if sid is not None else uuid.uuid4().hex[:16]
        self._seq = 0
        self._lock = threading.Lock()

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def stamp(self, header: dict) -> dict:
        """A NEW header carrying this session's next seq.  Stamp once per
        logical op -- retries re-send the stamped header verbatim."""
        h = dict(header)
        h["sid"] = self.sid
        h["seq"] = self.next_seq()
        return h


class DedupWindow:
    """Server-side (sid, seq) -> cached-reply window.

    ``check(header)`` returns the cached ``(reply_header, payload)`` for a
    duplicate, else None; ``record(header, reply, payload)`` stores a
    freshly applied op's reply.  Both are no-ops for unstamped headers.
    """

    def __init__(self, window: int = 128, max_sessions: int = 1024):
        self.window = max(1, int(window))
        self.max_sessions = max(1, int(max_sessions))
        self._lock = threading.Lock()
        # sid -> (seq -> (reply_header, payload)), both LRU-ordered
        self._sessions: "OrderedDict[str, OrderedDict]" = OrderedDict()
        self.hits = 0
        self.recorded = 0

    @staticmethod
    def _key(header: dict) -> Optional[Tuple[str, int]]:
        sid, seq = header.get("sid"), header.get("seq")
        if sid is None or seq is None:
            return None
        return str(sid), int(seq)

    def check(self, header: dict) -> Optional[Tuple[dict, bytes]]:
        key = self._key(header)
        if key is None:
            return None
        sid, seq = key
        with self._lock:
            ops = self._sessions.get(sid)
            if ops is None:
                return None
            self._sessions.move_to_end(sid)
            hit = ops.get(seq)
            if hit is None:
                return None
            self.hits += 1
        _bump_hits()
        return hit

    def record(self, header: dict, reply_header: dict,
               payload: bytes = b"") -> None:
        key = self._key(header)
        if key is None:
            return
        sid, seq = key
        with self._lock:
            ops = self._sessions.get(sid)
            if ops is None:
                ops = OrderedDict()
                self._sessions[sid] = ops
                while len(self._sessions) > self.max_sessions:
                    self._sessions.popitem(last=False)
            else:
                self._sessions.move_to_end(sid)
            ops[seq] = (reply_header, payload)
            ops.move_to_end(seq)
            while len(ops) > self.window:
                ops.popitem(last=False)
            self.recorded += 1

    # ------------------------------------------------------- checkpointing
    # A window is in-memory, so a bare server restart empties it and a
    # retry spanning the restart silently re-applies (the old at-least-once
    # edge).  A server that checkpoints its own state persists the window
    # WITH it: state()/load_state() round-trip the (sid, seq) -> reply map
    # through JSON, keeping exactly-once-applied true ACROSS a kill -9 +
    # restart-from-checkpoint as long as the window and the applied state
    # are captured under the same lock (the PS does).

    def state(self) -> dict:
        """JSON-serializable snapshot of every session's applied window
        (LRU order preserved -- dicts keep insertion order)."""
        with self._lock:
            return {
                "sessions": {
                    sid: [
                        [seq, hdr,
                         base64.b64encode(payload).decode("ascii")]
                        for seq, (hdr, payload) in ops.items()
                    ]
                    for sid, ops in self._sessions.items()
                }
            }

    def load_state(self, state: Optional[dict]) -> None:
        """Replace this window's contents with a :meth:`state` snapshot."""
        with self._lock:
            self._sessions.clear()
            for sid, entries in (state or {}).get("sessions", {}).items():
                ops: OrderedDict = OrderedDict()
                for seq, hdr, payload_b64 in entries:
                    ops[int(seq)] = (hdr, base64.b64decode(payload_b64))
                self._sessions[str(sid)] = ops

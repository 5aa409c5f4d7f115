"""RelaySource: a replica's model-fetch path through the relay tree.

Duck-types the slice of :class:`~asyncframework_tpu_torch.parallel.ps_dcn.
PSClient` that :class:`~asyncframework_tpu_torch.serving.replica.ModelReplica`
consumes (``subscribe() -> (ts, w, clock, k, age_ms, done)``,
``pull_wenc``, ``delta_fallbacks``, ``bye()``), so the replica's
refresh/publish machinery is untouched -- only where the bytes come
from changes:

- a node with a planned **parent** sends ``RELAY_FETCH have=<ts>`` up
  the tree and reconstructs via the stock ``net/wiredelta.py`` decode
  (CRC-gated; full replies from a PEER are additionally CRC-verified --
  only the PS root's full payload is authoritative by itself);
- ANY parent failure -- dead endpoint, REJECT_FENCED, stale version
  epoch, CRC/decode mismatch, corrupt compression -- **re-homes the
  node to the root** (direct SUBSCRIBE, the existing safe path) and
  backs off the parent for ``async.relay.parent.retry.s``;
- every validated version is **published** into the local
  :class:`~asyncframework_tpu_torch.relaycast.node.RelayNode` and offered to
  this node's own children, which is what makes the tree a tree.

Epoch discipline: the node's believed epoch stamps every relay hop
(``_stamped`` -- the relay plane's client-side fencing choke point,
pinned by the lint (``python -m asyncframework_tpu_torch.analysis.cli``) exactly like ``PSClient._proc_hdr``); root
replies advance it through the stock PSClient epoch tracking.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.net import wirecodec, wiredelta
from asyncframework_tpu_torch.relaycast import metrics as rmetrics
from asyncframework_tpu_torch.relaycast.node import RelayNode

_send_msg = _frame.send_msg
_recv_msg = _frame.recv_msg


class ParentError(ConnectionError):
    """The planned parent cannot serve this node right now (dead,
    fenced, or served bytes that failed validation): re-home to the
    root and back the parent off."""


class ParentEmpty(ParentError):
    """The parent is alive but holds no model yet (boot ordering: a
    subtree can come up before its ancestors' first fetch).  Fall back
    to the root for THIS round only -- no cooloff, the parent usually
    has the version one poll tick later."""


class DecodeMismatch(ParentError):
    """The parent's PAYLOAD failed reconstruction (basis/CRC/compression
    mismatch) -- the one failure class a full refetch can actually fix.
    Header-level rejects (fenced, stale version epoch) raise plain
    :class:`ParentError`: refetching from the same parent is futile."""


class RelaySource:
    """Parent-preferring, root-falling-back model source for a relay
    replica.  NOT thread-safe by itself -- the replica's refresh lock
    serializes callers, same as the stock PSClient contract."""

    def __init__(self, ps_host: str, ps_port: int, node: RelayNode,
                 parent: Optional[Tuple[str, int]] = None, rid: int = 0,
                 retry_parent_s: Optional[float] = None):
        from asyncframework_tpu_torch.conf import (
            RELAY_PARENT_RETRY_S,
            global_conf,
        )

        self.ps_host, self.ps_port = ps_host, int(ps_port)
        self.node = node
        self.parent = (parent[0], int(parent[1])) if parent else None
        self.rid = int(rid)
        self.retry_parent_s = (
            float(retry_parent_s) if retry_parent_s is not None
            else float(global_conf().get(RELAY_PARENT_RETRY_S))
        )
        # the PSClient-compatible observability surface
        self.pull_wenc: Dict[str, int] = {"full": 0, "nm": 0, "xdelta": 0}
        self.delta_fallbacks = 0
        self.via_parent = 0
        self.via_root = 0
        self._root = None               # lazy PSClient (direct SUBSCRIBE)
        self._psock = None              # persistent framed conn to parent
        self._parent_dark_until = 0.0
        self._lock = threading.Lock()   # guards the parent socket swap

    # ------------------------------------------------------------- fencing
    def _stamped(self, hdr: dict) -> dict:
        """The relay plane's client-side epoch stamp choke point (the
        ``_proc_hdr`` analog the lint pins)."""
        if self.node.epoch:
            hdr["ep"] = self.node.epoch
        return hdr

    # ------------------------------------------------------------ plumbing
    def _drop_parent_sock(self) -> None:
        with self._lock:
            if self._psock is not None:
                try:
                    self._psock.close()
                except OSError:
                    pass
                self._psock = None

    def _parent_call(self, hdr: dict) -> Tuple[dict, bytes]:
        """One framed round trip to the parent on the persistent
        connection; one re-dial on a dead socket.  The replica's
        refresh lock serializes callers, so the dial happens unlocked
        (``_lock`` only guards the close-vs-swap race with ``bye``)."""
        for attempt in (0, 1):
            try:
                sock = self._psock
                if sock is None:
                    sock = _frame.connect(self.parent, timeout=5.0)
                    with self._lock:
                        self._psock = sock
                _send_msg(sock, hdr)
                return _recv_msg(sock)
            except (ConnectionError, OSError):
                self._drop_parent_sock()
                if attempt:
                    raise
        raise ConnectionError("unreachable")  # pragma: no cover

    # ------------------------------------------------------ parent fetch
    def _decode_reply(self, header: dict, payload: bytes
                      ) -> Tuple[int, np.ndarray, int]:
        """RELAY_MODEL -> (ts, w, crc); raises ParentError on anything
        that must re-home this node."""
        op = header.get("op")
        if op == "REJECT_FENCED":
            # the parent fenced OUR stamp: adopt the newer epoch (our
            # next hop -- root or retried parent -- is stamped current)
            # and re-home for this round; self-healing without ever
            # accepting bytes across the fence
            srv = int(header.get("epoch", 0))
            if srv > self.node.epoch:
                self.node.epoch = srv
            rmetrics.bump("fenced_hops")
            raise ParentError(f"parent fenced us at epoch {srv}")
        if op == "ERR":
            raise ParentEmpty(str(header.get("msg", "parent empty")))
        if op != "RELAY_MODEL":
            raise ParentError(f"parent answered {op!r}")
        srv_ep = header.get("ep")
        if srv_ep is not None and int(srv_ep) > self.node.epoch:
            self.node.epoch = int(srv_ep)
        vep = int(header.get("vep", 0))
        if self.node.epoch and vep and vep < self.node.epoch:
            # the parent's stored version predates the epoch we believe
            # current: a stale peer must not feed the subtree
            rmetrics.bump("stale_epoch_rejects")
            raise ParentError(f"parent serves stale epoch {vep} "
                              f"(< {self.node.epoch})")
        ts = int(header["ts"])
        want_crc = int(header["crc"])
        try:
            model_part = wirecodec.decompress_model_part(header, payload)
        except ValueError as e:
            rmetrics.bump("crc_rejects")
            raise DecodeMismatch(str(e))
        wenc = header.get("wenc", wiredelta.FULL)
        cur = self.node.current()
        basis = None
        basis_crc = None
        if cur is not None:
            basis = np.frombuffer(cur.wire, np.float32)
            basis_crc = cur.crc
        w = wiredelta.decode(wenc, model_part,
                             int(header.get("nnz", 0)), basis,
                             want_crc, basis_crc)
        if w is not None and wenc == wiredelta.FULL \
                and wiredelta.crc(w) != want_crc:
            # a peer's FULL payload is NOT authoritative (it may be
            # mid-death); only the PS root earns that trust
            w = None
        if w is None:
            rmetrics.bump("crc_rejects")
            raise DecodeMismatch("relay payload failed CRC/decode")
        self.pull_wenc[wenc] = self.pull_wenc.get(wenc, 0) + 1
        rmetrics.bump("parent_bytes_in", len(model_part))
        return ts, w, want_crc

    def _fetch_parent(self) -> Tuple[int, np.ndarray, int, int, float,
                                     bool, int]:
        """(ts, w, clock, k, age_ms, done, crc) from the parent, one
        ``have=`` negotiation plus one full-refetch fallback (exactly
        the PSClient delta discipline)."""
        hdr = {"op": "RELAY_FETCH", "rid": self.rid,
               "rport": self.node.port}
        cur = self.node.current()
        if cur is not None:
            hdr["have"] = cur.ts
        header, payload = self._parent_call(self._stamped(dict(hdr)))
        try:
            ts, w, crc = self._decode_reply(header, payload)
        except DecodeMismatch:
            if "have" not in hdr:
                raise
            # the PAYLOAD failed against our basis: ONE full refetch
            # (cache miss/corruption degrades to full, never to wrong).
            # Header-level rejects (fenced, stale vep) raise plain
            # ParentError above this class and skip the refetch -- the
            # same parent would reject the full identically.
            self.delta_fallbacks += 1
            hdr.pop("have", None)
            header, payload = self._parent_call(self._stamped(dict(hdr)))
            ts, w, crc = self._decode_reply(header, payload)
        rmetrics.bump("parent_fetches")
        return (ts, w, int(header.get("clock", ts)),
                int(header.get("k", 0)),
                float(header.get("age_ms", 0.0)),
                bool(header.get("done", False)), crc)

    # --------------------------------------------------------- root fetch
    def _ensure_root(self):
        if self._root is None:
            from asyncframework_tpu_torch.parallel.ps_dcn import PSClient

            self._root = PSClient(self.ps_host, self.ps_port,
                                  pull_mode="delta",
                                  epoch=self.node.epoch)
        return self._root

    def _root_subscribe(self, wid: int):
        cl = self._ensure_root()
        if self.node.epoch > cl.epoch:
            cl.epoch = self.node.epoch
        before = dict(cl.pull_wenc)
        fb = cl.delta_fallbacks
        # rport rides the SUBSCRIBE: the PS registers this node as a
        # direct relay child and its offer loop announces new versions
        got = cl.subscribe(wid, extra={"rport": self.node.port})
        for shape, n in cl.pull_wenc.items():
            d = n - before.get(shape, 0)
            if d:
                self.pull_wenc[shape] = self.pull_wenc.get(shape, 0) + d
        self.delta_fallbacks += cl.delta_fallbacks - fb
        if cl.epoch > self.node.epoch:
            self.node.epoch = cl.epoch
        if got is None:  # pragma: no cover - SUBSCRIBE never says DONE
            return None
        ts, w, clock, k, age_ms, done = got
        basis = cl._basis.get(wid)
        crc = basis[2] if basis is not None and basis[0] == ts \
            else wiredelta.crc(np.ascontiguousarray(w, np.float32))
        return ts, w, clock, k, age_ms, done, crc

    # ------------------------------------------------------------- facade
    def subscribe(self, wid: int = 0
                  ) -> Optional[Tuple[int, np.ndarray, int, int,
                                      float, bool]]:
        """The ModelReplica-facing fetch: parent when planned and not
        backed off, root otherwise; publishes + offers on success."""
        got = None
        now = time.monotonic()
        if self.parent is not None and now >= self._parent_dark_until:
            try:
                got = self._fetch_parent()
                self.via_parent += 1
            except ParentEmpty:
                pass  # alive-but-empty parent: root this round, no cooloff
            except (ParentError, ConnectionError, OSError) as e:
                self._parent_dark_until = now + self.retry_parent_s
                self._drop_parent_sock()
                rmetrics.bump("rehomes")
                print(f"relay-{self.rid}: parent {self.parent} failed "
                      f"({e}); re-homing to root for "
                      f"{self.retry_parent_s:.1f}s",
                      file=sys.stderr, flush=True)
        if got is None:
            if self.parent is not None:
                rmetrics.bump("root_fallbacks")
            got = self._root_subscribe(wid)
            if got is None:  # pragma: no cover
                return None
            self.via_root += 1
        ts, w, clock, k, age_ms, done, crc = got
        cur = self.node.current()
        if cur is None or ts > cur.ts:
            self.node.publish(ts, w.tobytes(), crc, clock, k, age_ms,
                              done, epoch=self.node.epoch)
            # async fan-out: a dark child's offer timeout must never
            # stall THIS node's refresh cadence (the whole subtree's
            # freshness rides on it)
            self.node.request_offers()
        elif ts < cur.ts:
            # monotone RETURN, not just monotone store: a straggler
            # parent reply (e.g. the parent is still behind after this
            # node re-homed to the root) must not roll the replica's
            # SERVED model back either -- answer from the local store,
            # which holds the newest validated version
            rmetrics.bump("stale_replies")
            return (cur.ts, np.frombuffer(cur.wire, np.float32),
                    cur.clock, cur.k,
                    cur.age_ms
                    + (time.monotonic() - cur.born_mono) * 1e3,
                    cur.done)
        return ts, w, clock, k, age_ms, done

    def bye(self) -> None:
        self._drop_parent_sock()
        if self._root is not None:
            self._root.bye()

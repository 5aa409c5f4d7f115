"""RelayNode: one hop of the relaycast distribution tree.

Every relay-enabled replica runs one of these next to its predict
server.  The node is a tiny versioned model store behind a
:class:`~asyncframework_tpu_torch.serving.server.FramedServer`:

- the replica's fetch path (:class:`~asyncframework_tpu_torch.relaycast.source.
  RelaySource`) **publishes** each CRC-validated version it obtains
  (from its parent or from the root) into the store;
- children send ``RELAY_FETCH have=<ts>`` and get the same negotiated
  NM / XOR-delta / FULL reply shapes as the PS serves (``net/
  wiredelta.py`` -- byte-exact reconstruction, version CRC on every
  reply), optionally zlib-compressed (``net/wirecodec.py``,
  ``async.relay.compress``);
- a node that lands a new version **offers** it to its registered
  children (``RELAY_OFFER`` -- advisory: a lost offer costs nothing,
  the children's poll loops fetch on their next tick);
- every hop is **epoch-gated** (epoch fencing): requests stamped with a
  stale epoch are REJECT_FENCED, and stored versions carry the epoch
  they were fetched under (``vep``) so a child can refuse data from a
  parent that is itself behind -- a deposed or stale peer can never
  poison the subtree; the fallback on ANY mismatch is a direct root
  SUBSCRIBE, the existing safe path.

Children are learned, not configured: a fetch whose header carries the
child's own relay port registers it for offers (bounded by
``async.relay.fanout``); repeated offer failures drop it.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.net import wirecodec, wiredelta
from asyncframework_tpu_torch.relaycast import metrics as rmetrics
from asyncframework_tpu_torch.relaycast.offers import ChildRegistry
from asyncframework_tpu_torch.serving.server import FramedServer

_send_msg = _frame.send_msg
_recv_msg = _frame.recv_msg


class _Stored:
    """One immutable stored model version (atomic-reference discipline:
    a fetch handler that read the reference serves a coherent
    (ts, bytes, crc, epoch, freshness) tuple no matter how many
    publishes land meanwhile)."""

    __slots__ = ("ts", "wire", "crc", "vep", "clock", "k", "age_ms",
                 "born_mono", "done")

    def __init__(self, ts: int, wire: bytes, crc: int, vep: int,
                 clock: int, k: int, age_ms: float, done: bool):
        self.ts = ts
        self.wire = wire
        self.crc = crc
        self.vep = vep
        self.clock = clock
        self.k = k
        self.age_ms = age_ms
        self.born_mono = time.monotonic()
        self.done = done


class RelayNode(FramedServer):
    """Versioned model store + RELAY_FETCH/RELAY_OFFER server."""

    def __init__(self, rid: int = 0, host: str = "0.0.0.0", port: int = 0,
                 versions: Optional[int] = None,
                 compress: Optional[bool] = None,
                 fanout: Optional[int] = None,
                 on_offer: Optional[Callable[[], None]] = None):
        from asyncframework_tpu_torch.conf import (
            RELAY_COMPRESS,
            RELAY_FANOUT,
            RELAY_VERSIONS,
            global_conf,
        )

        conf = global_conf()
        super().__init__(f"relay-{int(rid)}")
        self.rid = int(rid)
        self.versions = (int(versions) if versions is not None
                         else int(conf.get(RELAY_VERSIONS)))
        self.compress = (bool(compress) if compress is not None
                         else bool(conf.get(RELAY_COMPRESS)))
        self.fanout = (int(fanout) if fanout is not None
                       else int(conf.get(RELAY_FANOUT)))
        #: fencing epoch this node believes current (0 = fencing off);
        #: monotone, learned from root replies / fetch traffic
        self.epoch = 0
        #: newest version a parent has offered (monotone; the fetch path
        #: uses it to decide an immediate re-fetch is worthwhile)
        self.offered_ts = 0
        #: the current version, ATOMIC reference swap (serving reads one
        #: reference; publish replaces it whole)
        self._cur: Optional[_Stored] = None
        #: recent versions for delta encoding (ts -> _Stored), insertion
        #: order = version age (ts is monotone)
        self._store: "OrderedDict[int, _Stored]" = OrderedDict()
        self._store_lock = threading.Lock()
        #: learned children (shared registry/offer machinery with the
        #: PS root's offer loop -- relaycast/offers.py)
        self._registry = ChildRegistry(self.fanout)
        #: offer fan-out runs on ITS OWN lazily-started thread (the PS
        #: root's discipline): the publishing/refresh path must never
        #: block on a dark child's connect timeout -- request_offers()
        #: just sets an event, and consecutive publishes coalesce into
        #: one offer round carrying the newest version
        self._offer_event = threading.Event()
        self._offer_thread: Optional[threading.Thread] = None
        self._offer_thread_lock = threading.Lock()
        self.on_offer = on_offer
        # local observability (shipped on RELAY STATUS)
        self.fetches = 0
        self.offers_in = 0
        self.fenced = 0
        self._stats_lock = threading.Lock()
        self.bind(host, port)

    # ------------------------------------------------------------- store
    def publish(self, ts: int, wire: bytes, crc: int, clock: int, k: int,
                age_ms: float, done: bool, epoch: int = 0) -> None:
        """Install a CRC-validated version (the RelaySource calls this
        after every successful parent or root fetch).  Monotone: an older
        ts than the current one is ignored (a late parent reply must
        not roll the subtree back)."""
        if epoch > self.epoch:
            self.epoch = epoch
        cur = self._cur
        if cur is not None and ts < cur.ts:
            return
        item = _Stored(ts, wire, crc, int(epoch or self.epoch),
                       clock, k, age_ms, done)
        with self._store_lock:
            self._store[ts] = item
            while len(self._store) > max(self.versions, 1):
                self._store.popitem(last=False)
        self._cur = item

    def current(self) -> Optional[_Stored]:
        return self._cur

    def basis_for(self, ts: int) -> Optional[np.ndarray]:
        with self._store_lock:
            item = self._store.get(ts)
        if item is None:
            return None
        return np.frombuffer(item.wire, np.float32)

    # ---------------------------------------------------------- children
    def register_child(self, host: str, port: int) -> None:
        self._registry.register(host, port)

    def children(self) -> List[Tuple[str, int]]:
        return self._registry.children()

    def offer_children(self) -> int:
        """One SYNCHRONOUS offer round: announce the current version to
        every registered child (ChildRegistry: short per-child
        timeouts, strike-based drops, LRU eviction at fanout).  Returns
        the number delivered.  Production callers use
        :meth:`request_offers` -- this blocks on dark children's
        timeouts and exists for the offer thread and for tests."""
        cur = self._cur
        if cur is None:
            return 0
        hdr = {"op": "RELAY_OFFER", "ts": cur.ts, "crc": cur.crc,
               "rid": self.rid}
        if self.epoch:
            hdr["ep"] = self.epoch
        return self._registry.offer(hdr)

    def request_offers(self) -> None:
        """Wake the (lazily-started) offer thread -- the non-blocking
        publish-path entry point.  A dark child's connect timeout burns
        the offer thread, never the refresh path that produced the
        version; back-to-back publishes coalesce (the thread always
        offers the CURRENT version)."""
        if self._cur is None:
            return
        if self._offer_thread is None:
            with self._offer_thread_lock:
                if self._offer_thread is None:
                    from asyncframework_tpu_torch.utils.threads import guarded

                    self._offer_thread = threading.Thread(
                        target=guarded(self._offer_loop,
                                       f"relay-{self.rid}-offers"),
                        name=f"relay-{self.rid}-offers", daemon=True,
                    )
                    self._offer_thread.start()
        self._offer_event.set()

    def _offer_loop(self) -> None:
        while not self._stop.is_set():
            if not self._offer_event.wait(0.2):
                continue
            self._offer_event.clear()
            self.offer_children()

    # ------------------------------------------------------------ serving
    def handle_op(self, conn: socket.socket, op: Optional[str],
                  header: dict, payload: bytes) -> bool:
        if op == "RELAY_FETCH":
            if not self._fence_reject(conn, header):
                self._handle_fetch(conn, header)
        elif op == "RELAY_OFFER":
            if not self._fence_reject(conn, header):
                self._handle_offer(conn, header)
        elif op == "STATUS":
            _send_msg(conn, {"op": "STATUS", **self.status()})
        else:
            return False
        return True

    def _fence_reject(self, conn: socket.socket, header: dict) -> bool:
        """Epoch-fencing admission for relay hops, the PS's semantics
        (ps_dcn._fence_reject) on the read plane: with fencing off
        (``self.epoch == 0``) or an unstamped op, serve; a STALE-epoch
        peer is answered REJECT_FENCED with the newest epoch this node
        knows (it self-heals and re-fetches, or falls back to the
        root); a NEWER-epoch peer advances our belief -- we are the
        stale party, and our next root fetch lands on the current
        incarnation (our stored versions keep their old ``vep``, so
        children reject them client-side meanwhile)."""
        if not self.epoch:
            return False
        ep = header.get("ep")
        if ep is None:
            return False
        ep = int(ep)
        if ep >= self.epoch:
            if ep > self.epoch:
                self.epoch = ep
            return False
        with self._stats_lock:
            self.fenced += 1
        rmetrics.bump("fenced_hops")
        _send_msg(conn, {"op": "REJECT_FENCED", "epoch": self.epoch})
        return True

    def _handle_fetch(self, conn: socket.socket, header: dict) -> None:
        rp = header.get("rport")
        if rp is not None:
            try:
                peer = conn.getpeername()[0]
            except OSError:
                peer = None
            if peer is not None:
                self.register_child(peer, int(rp))
        cur = self._cur
        if cur is None:
            _send_msg(conn, {"op": "ERR", "msg": "relay node holds no "
                                                 "model yet"})
            return
        have = header.get("have")
        basis = self.basis_for(int(have)) if have is not None else None
        cur_arr = np.frombuffer(cur.wire, np.float32)
        wenc, model_part, nnz = wiredelta.encode(cur_arr, basis,
                                                 cur_bytes=cur.wire)
        if wenc == wiredelta.FULL and basis is not None \
                and basis.shape == cur_arr.shape and self.compress:
            # dense change (sparse xdelta would not be smaller): ship
            # the dense XOR form instead -- same size raw, but its high
            # byte planes are near-zero for a training step, which is
            # exactly what the shuffle+deflate transform below crunches.
            # Gated on compress: without the transform XFULL is
            # FULL-sized anyway and only ADDS a basis requirement (an
            # extra failure mode for zero wire savings)
            wenc = wiredelta.XFULL
            model_part = wiredelta.encode_xfull(cur_arr, basis)
        hdr: dict = {"op": "RELAY_MODEL", "ts": cur.ts, "wenc": wenc,
                     "crc": cur.crc, "vep": cur.vep, "clock": cur.clock,
                     "k": cur.k, "done": cur.done,
                     "age_ms": round(
                         cur.age_ms
                         + (time.monotonic() - cur.born_mono) * 1e3, 3)}
        if wenc == wiredelta.XDELTA:
            hdr["nnz"] = nnz
        if self.compress:
            cfields, model_part = wirecodec.compress_model_part(
                wenc, model_part, nnz)
            hdr.update(cfields)
        hdr["wlen"] = len(model_part)
        if self.epoch:
            hdr["ep"] = self.epoch
        with self._stats_lock:
            self.fetches += 1
        rmetrics.bump("fetches_served")
        rmetrics.bump(f"fetch_{wenc}")
        rmetrics.bump("fetch_bytes_out", len(model_part))
        _frame.send_msg_vectored(conn, hdr, (model_part,))

    def _handle_offer(self, conn: socket.socket, header: dict) -> None:
        ts = int(header.get("ts", 0))
        with self._stats_lock:
            self.offers_in += 1
        rmetrics.bump("offers_received")
        cur = self._cur
        fresh = ts > (cur.ts if cur is not None else -1) \
            and ts > self.offered_ts
        if fresh:
            self.offered_ts = ts
        else:
            rmetrics.bump("offers_stale")
        # ACK before the (possibly slow) fetch: the parent's offer loop
        # must not block on this subtree's whole refresh chain
        _send_msg(conn, {"op": "ACK", "fresh": fresh})
        if fresh and self.on_offer is not None:
            self.on_offer()

    def status(self) -> Dict:
        cur = self._cur
        with self._stats_lock:
            out = {
                "rid": self.rid, "port": self.port, "epoch": self.epoch,
                "fetches": self.fetches, "offers_in": self.offers_in,
                "fenced": self.fenced,
                "children": [list(c) for c in self.children()],
            }
        with self._store_lock:
            out["stored_versions"] = len(self._store)
        if cur is not None:
            out.update(ts=cur.ts, crc=cur.crc, vep=cur.vep,
                       clock=cur.clock, done=cur.done)
        return out

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RelayNode":
        self.start_accepting()
        return self

    def stop(self) -> None:
        self.stop_server()

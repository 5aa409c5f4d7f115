"""Length-prefixed JSON/payload framing: the one wire format of the DCN
control + data plane.

This is the framing that ``parallel/ps_dcn.py`` introduced and every other
networked layer (the topic server, the standalone master/worker/client
daemons) imported from it.  It now lives here so the robustness layer can
wrap ONE choke point: every frame sent or received anywhere in the
framework passes through :func:`send_msg` / :func:`send_msg_vectored` /
:func:`recv_msg` / :func:`connect`, and each consults the process's active
:class:`~asyncframework_tpu_torch.net.faults.FaultInjector` (when installed) --
the network-plane sibling of ``engine/straggler.py``'s compute delays.

Frame layout (unchanged on the wire): ``!I``-prefixed JSON header line,
then an ``!I``-prefixed raw payload (possibly empty).  The header always
carries ``op``; mutating ops may carry ``sid``/``seq`` (see
``net/session.py``), and a frame sent while a trace context is installed
on the calling thread (``metrics/trace.py``) carries it as an optional
``tc`` entry -- the wire propagation of distributed tracing, stamped here
at the one choke point so every PULL/PUSH/PULL_SAGA/PUSH_SAGA, topic, and
master op is covered.  With tracing off nothing consults the clock and
frames are byte-identical to the pre-trace wire.

Data-plane fast paths (the throughput overhaul):

- :func:`send_msg_vectored` frames a payload given as a *sequence of
  buffers* (``bytes``/``memoryview``/anything exporting the buffer
  protocol) through ``socket.sendmsg`` -- the kernel gathers the iovec, so
  a multi-megabyte model payload is never copied into a fresh frame
  buffer.  The bytes on the wire are identical to
  ``send_msg(sock, header, b"".join(parts))``.
- :func:`recv_exact` fills ONE preallocated ``bytearray`` via
  ``recv_into`` instead of accumulating per-``recv`` ``bytes`` chunks
  (which allocated O(frames) intermediates for large payloads).

Wire-bytes accounting: every frame sent or received here bumps a per-op
byte counter (frame bytes: both length prefixes + header + payload).
``bytes_totals()`` exposes them (live UI ``net.bytes`` section,
``bench.py`` bytes-per-update); ``metrics.reset_totals()`` zeroes them via
``net.reset_net_totals``.  The per-thread ``last_io_bytes()`` value lets a
client attach this RPC's wire cost to its pull.rtt/push.rtt trace span.
"""

from __future__ import annotations

import ctypes
import json
import socket
import struct
import threading
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from asyncframework_tpu_torch.metrics import profiler as _prof
from asyncframework_tpu_torch.metrics import trace as _trace
from asyncframework_tpu_torch.native_build import bump_native as _bump_native
from asyncframework_tpu_torch.net import faults, lockwatch
from asyncframework_tpu_torch.net import retry as _retry

_HDR = struct.Struct("!I")  # 4-byte big-endian frame length

# ---------------------------------------------------------- native gather
#: native symbol -> same-module pure-Python oracle (``native-oracle``
#: lint); wd_gather is the iovec-style memcpy loop of native/wiredelta.cc
NATIVE_ORACLES = {"wd_gather": "_py_gather"}

_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    lib = None
    try:
        from asyncframework_tpu_torch.native_build import ensure_built

        built = ensure_built("wiredelta")
        if built:
            lib = ctypes.CDLL(built)
            lib.wd_gather.restype = ctypes.c_longlong
            lib.wd_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_longlong]
    except Exception:  # noqa: BLE001 - fall back to Python
        lib = None
    _NATIVE = lib or False
    return lib


def _use_native():
    from asyncframework_tpu_torch.conf import NATIVE_ENABLED, global_conf

    if not global_conf().get(NATIVE_ENABLED):
        return None
    lib = _native_lib()
    if lib is None:
        _bump_native("python_fallbacks")
    return lib


def _py_gather(parts) -> bytes:
    return b"".join(bytes(memoryview(p)) for p in parts)


def gather(parts) -> bytes:
    """Materialize a frame from its buffer parts: ``b"".join`` semantics,
    but through the native iovec-memcpy helper when enabled, which
    releases the GIL for the copy of a multi-megabyte payload.  Used by
    the non-vectored send paths (fault-injection materialization, the
    no-``sendmsg`` fallback) and the shm-ring transport's frame staging
    (``net/shmring.py``); byte-identical to the join by construction and
    property-tested in tests/test_native.py."""
    lib = _use_native()
    if lib is not None and len(parts) > 1:
        arrs = [np.frombuffer(memoryview(p).cast("B"), np.uint8)
                for p in parts]
        arrs = [a for a in arrs if a.size]
        if len(arrs) > 1:
            total = int(sum(a.size for a in arrs))
            out = np.empty(total, np.uint8)
            n = len(arrs)
            srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
            lens = (ctypes.c_longlong * n)(*[int(a.size) for a in arrs])
            got = lib.wd_gather(
                ctypes.c_void_p(out.ctypes.data),
                ctypes.cast(srcs, ctypes.c_void_p),
                ctypes.cast(lens, ctypes.c_void_p), n)
            if got == total:
                _bump_native("native_calls.gather")
                return out.tobytes()
    _bump_native("python_calls.gather")
    return _py_gather(parts)

# ------------------------------------------------------------ wire bytes
# Per-op frame byte counters (process-global, lock-guarded like every other
# net counter).  Keyed "sent.<OP>" / "recv.<OP>" so the live UI's _delta
# machinery (flat int dicts) applies unchanged.
_bytes_lock = threading.Lock()
_bytes_totals: Dict[str, int] = {}

# Per-thread bytes of the last send/recv on this thread: a client sums the
# two right after an RPC to stamp its rtt span with the wire cost.
_io_tls = threading.local()


def _count(direction: str, op: str, n: int) -> None:
    key = f"{direction}.{op or '?'}"
    with _bytes_lock:
        _bytes_totals[key] = _bytes_totals.get(key, 0) + n
        _bytes_totals[direction] = _bytes_totals.get(direction, 0) + n
    _io_tls.total = getattr(_io_tls, "total", 0) + n


def bytes_totals() -> Dict[str, int]:
    """Process-wide wire-byte counters: ``sent``/``recv`` grand totals plus
    ``sent.<OP>`` / ``recv.<OP>`` per-op breakdowns (frame bytes, i.e.
    prefixes + header + payload)."""
    with _bytes_lock:
        return dict(_bytes_totals)


def reset_bytes_totals() -> None:
    """Zero the wire-byte counters (per-run isolation; called from
    ``net.reset_net_totals`` -> ``metrics.reset_totals``)."""
    with _bytes_lock:
        _bytes_totals.clear()


def last_io_bytes() -> int:
    """Frame bytes of this thread's most recent send plus most recent
    receive -- the wire cost of the RPC that just completed.  Only valid
    for SYNCHRONOUS request/reply callers; windowed senders interleave
    frames from different RPCs on one thread and must pair
    :func:`last_sent_bytes` (captured at their send) with
    :func:`last_recv_bytes` (captured at their receive) instead."""
    return (getattr(_io_tls, "sent", 0) or 0) + (getattr(_io_tls, "recv", 0)
                                                 or 0)


def thread_bytes() -> int:
    """Frame bytes this thread has sent and received in all: a thread's
    own share of :func:`bytes_totals` (a diagnostic reader's, say, to be
    left out of a run's wire cost)."""
    return getattr(_io_tls, "total", 0)


def last_sent_bytes() -> int:
    """Frame bytes of this thread's most recent send alone."""
    return getattr(_io_tls, "sent", 0) or 0


def last_recv_bytes() -> int:
    """Frame bytes of this thread's most recent receive alone."""
    return getattr(_io_tls, "recv", 0) or 0


def free_port(host: str = "127.0.0.1") -> int:
    """Reserve-and-release one ephemeral port (the ONE copy of the
    bind-port-0 idiom: the local cluster launcher and the shard-group
    controller's telemetry-port pre-assignment both need a port known
    BEFORE the owning process binds it).  The tiny close-to-bind race
    is acceptable for local orchestration; k8s pins ports in the
    manifests instead."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def endpoint_of(sock: socket.socket) -> str:
    """The remote peer as ``host:port`` (fault-schedule addressing)."""
    try:
        host, port = sock.getpeername()[:2]
        return f"{host}:{port}"
    except OSError:
        return "?:?"


#: sock -> its RESTING timeout (the caller's attempt timeout), stashed
#: the first time a deadline cap tightens it so later ops can restore or
#: re-derive the right bound.  Without this, a cap is a ratchet: a call
#: finishing with 0.2 s of deadline left would leave settimeout(0.2) on
#: a REUSED connection (PSClient._sock, the frontend's pooled channels)
#: and every later call -- fresh deadline or none -- would inherit it.
_base_timeouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _deadline_cap(sock: Optional[socket.socket] = None,
                  timeout: Optional[float] = None) -> Optional[float]:
    """Cap a socket timeout to the calling thread's active retry deadline
    (net/retry.py): once the overall deadline is spent, raise
    ``socket.timeout`` immediately instead of letting a blocking syscall
    (a stalled read from a gray peer, a stall_read fault) hold the caller
    past the policy.  Returns the capped timeout; with ``sock`` given,
    installs ``min(resting timeout, remaining deadline)`` on the socket
    -- and with no deadline active, RESTORES the resting timeout a
    previous cap may have tightened."""
    rem = _retry.remaining_deadline_s()
    if sock is not None:
        try:
            cur = sock.gettimeout()
            base = _base_timeouts.get(sock, cur)
            if rem is None:
                if cur != base:
                    sock.settimeout(base)
            elif rem > 0:
                want = rem if base is None else min(base, rem)
                if cur != want:
                    _base_timeouts[sock] = base
                    sock.settimeout(want)
        except OSError:  # pragma: no cover - closed socket races
            pass
    if rem is None:
        return timeout
    if rem <= 0:
        raise socket.timeout("retry deadline exhausted")
    return rem if timeout is None else min(timeout, rem)


def connect(addr: Tuple[str, int], timeout: Optional[float] = 10.0
            ) -> socket.socket:
    """``socket.create_connection`` with the fault hook: an armed
    connection-refused event (or an active partition) fires here, before
    any real dial.  The dial itself is capped to the calling thread's
    retry deadline; the socket's RESTING timeout stays the caller's
    ``timeout`` (per-op deadline caps re-tighten as needed), so a reused
    connection never inherits one call's dying deadline."""
    endpoint = f"{addr[0]}:{int(addr[1])}"
    inj = faults.active()
    if inj is not None:
        inj.check_connect(endpoint)
    sock = socket.create_connection(addr,
                                    timeout=_deadline_cap(None, timeout))
    if sock.gettimeout() != timeout:
        sock.settimeout(timeout)
    return sock


def _stamped(header: dict) -> dict:
    tc = _trace.wire_header()
    if tc is not None and "tc" not in header:
        # copy, never mutate: retries re-send the caller's header verbatim
        # (dedup stamps), and the ambient context at retry time still wins
        header = dict(header, tc=tc)
    return header


_HAVE_SENDMSG = hasattr(socket.socket, "sendmsg")


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """Gather-send every buffer in ``parts`` (memoryviews), handling short
    writes by advancing the iovec -- the vectored analog of ``sendall``."""
    views = [memoryview(p).cast("B") for p in parts if len(p)]
    while views:
        sent = sock.sendmsg(views)
        # advance past fully-sent buffers, slice the partial one
        while sent > 0 and views:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def _send_frame(sock: socket.socket, header: dict, parts: Sequence) -> None:
    """Shared core of :func:`send_msg` / :func:`send_msg_vectored`: tc
    stamping, fault injection, byte accounting, then the wire write --
    vectored (zero-copy gather) when the platform has ``sendmsg`` and no
    injector needs to see a contiguous frame."""
    # lock watchdog (net/lockwatch.py): a frame sent while the caller
    # holds a watched lock (the PS model lock) is exactly the contention
    # the lock-free pull path removes -- fail loudly in debug runs
    lockwatch.check_io("send")
    with _prof.zone("serde"):
        header = _stamped(header)
        head = json.dumps(header).encode()
    # zone scope (profiler exact accumulator): everything past header
    # serialization is the frame pump proper -- byte accounting, fault
    # consult, and the kernel write(s).  Wall time, so a slow peer shows
    # up here (the sampler separates CPU from blocked time).
    with _prof.zone("wire.encode"):
        plen = sum(len(p) for p in parts)
        op = str(header.get("op", ""))
        total = 2 * _HDR.size + len(head) + plen
        _deadline_cap(sock)  # a spent deadline fails the write outright
        inj = faults.active()
        if inj is not None:
            endpoint = endpoint_of(sock)
            if inj.partition_active(endpoint):
                # blackholed: nothing leaves this host, the connection is
                # poisoned (the peer sees silence, exactly like a real cut)
                inj.note_partition_drop(endpoint, op)
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                raise ConnectionError(
                    f"fault-injected: partitioned from {endpoint}"
                )
            # chaos path: materialize the frame so mid-frame cuts slice the
            # exact same byte stream the plain path would have sent
            data = gather(
                [_HDR.pack(len(head)), head, _HDR.pack(plen), *parts])
            kind = inj.check_send(endpoint, op)
            if kind == faults.CUT_MID_FRAME:
                # a prefix of the frame goes out, then the connection dies:
                # the peer sees a short frame + EOF, the sender sees a
                # reset.  The request was NOT applied.
                sock.sendall(data[: max(1, len(data) // 3)])
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                raise ConnectionError(
                    f"fault-injected: mid-frame cut to {endpoint_of(sock)}"
                )
            if kind in (faults.STALL_READ, faults.DROP_REPLY):
                # the request itself goes through (the peer WILL apply it);
                # the fault fires on this socket's next recv.  Arm only
                # AFTER the send succeeds -- a failed send never reaches
                # the peer, and a stale armed entry could fire on an
                # unrelated future socket
                sock.sendall(data)
                inj.arm(sock, kind)
                _io_tls.sent = total
                _count("sent", op, total)
                return
            sock.sendall(data)
            _io_tls.sent = total
            _count("sent", op, total)
            return
        prefix = _HDR.pack(len(head)) + head + _HDR.pack(plen)
        if not plen:
            sock.sendall(prefix)
        elif _HAVE_SENDMSG:
            _sendmsg_all(sock, [prefix, *parts])
        else:  # pragma: no cover - platforms without sendmsg
            sock.sendall(gather([prefix, *parts]))
        _io_tls.sent = total
        _count("sent", op, total)


def send_msg(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    _send_frame(sock, header, (payload,) if payload else ())


def send_msg_vectored(sock: socket.socket, header: dict,
                      parts: Sequence) -> None:
    """Frame ``parts`` (a sequence of buffer-protocol objects) as ONE
    payload without concatenating them: the kernel gathers the iovec via
    ``socket.sendmsg``.  Byte-identical on the wire to
    ``send_msg(sock, header, b"".join(parts))``; same fault-injection and
    trace-stamping semantics (the choke point is shared)."""
    _send_frame(sock, header, tuple(parts))


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes into one preallocated buffer
    (``recv_into`` loop -- no per-chunk intermediate ``bytes``)."""
    if n == 0:
        return b""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


def _recv_msg_raw(sock: socket.socket) -> Tuple[dict, bytes]:
    lockwatch.check_io("recv")
    _deadline_cap(sock)  # cap the blocking read to the retry deadline
    # zone boundary: the 4-byte length read carries the IDLE wait for
    # the next frame (a server handler parks here between requests) --
    # it stays outside wire.decode so the zone measures frame pumping,
    # not time spent waiting for a peer to speak
    (hlen,) = _HDR.unpack(recv_exact(sock, _HDR.size))
    with _prof.zone("wire.decode"):
        hbytes = recv_exact(sock, hlen)
    with _prof.zone("serde"):
        header = json.loads(hbytes)
    with _prof.zone("wire.decode"):
        (plen,) = _HDR.unpack(recv_exact(sock, _HDR.size))
        payload = recv_exact(sock, plen) if plen else b""
    total = 2 * _HDR.size + hlen + plen
    _io_tls.recv = total
    _count("recv", str(header.get("op", "")), total)
    return header, payload


def recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    inj = faults.active()
    if inj is not None:
        endpoint = endpoint_of(sock)
        if inj.partition_active(endpoint):
            # the partition began (or still holds) while a reply was due:
            # the bytes never arrive -- same observable as a gray peer
            inj.note_partition_drop(endpoint, "RECV")
            raise socket.timeout(
                f"fault-injected: partitioned from {endpoint}"
            )
        kind = inj.disarm(sock)
        if kind == faults.STALL_READ:
            # the reply never arrives within the attempt window; the unread
            # bytes stay in the kernel buffer, so the caller MUST drop this
            # connection (the retry layer does)
            raise socket.timeout(
                f"fault-injected: stalled read from {endpoint_of(sock)}"
            )
        if kind == faults.DROP_REPLY:
            # the peer applied the op and replied -- the reply is lost on
            # the wire.  Read and discard it so the injection point is
            # exactly "applied but unacknowledged".
            _recv_msg_raw(sock)
            raise ConnectionError(
                f"fault-injected: reply dropped after apply "
                f"({endpoint_of(sock)})"
            )
    return _recv_msg_raw(sock)

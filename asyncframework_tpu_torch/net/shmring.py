"""Shared-memory ring transport for colocated roles.

An ``async-cluster`` box runs several roles as separate PROCESSES on one
host -- PS shards, the hot standby, serving replicas -- and their
REPL_APPEND / SUBSCRIBE traffic crosses the loopback stack: two syscalls
plus two kernel copies per frame, with the GIL held on each end.  This
module moves those bytes through a lock-free SPSC ring in a shared-memory
segment instead: one mmap'd file per direction, writer and reader in
different processes, release/acquire counter publishes ordering the data
copies (native/shmring.cc; a layout-identical pure-Python
``struct.pack_into`` twin drives the SAME segment when the toolchain is
absent, and the two implementations are cross-tested against each other
in both directions).

The crucial design decision: the ring replaces the SOCKET, not the
PROTOCOL.  :class:`ShmSocket` exposes the socket-method subset
``net/frame.py`` uses (``sendall``/``sendmsg``/``recv_into``/timeouts/
``getpeername``/``shutdown``/``close``), so the exact same framed bytes
-- length-prefixed JSON header, payload, CRC fields, session dedup
stamps, fence epochs -- flow through ``send_msg``/``recv_msg`` unchanged
and every admission check at the server choke point still runs.  Nothing
above the transport can tell the difference, which is what makes the
byte-identity acceptance test possible.

Handshake (``SHM_OPEN``, net/protocol.py): after the normal TCP connect,
a client that finds ``async.shm.enabled`` set and the peer on loopback
creates the two ring files (0600, in /dev/shm when present), stamps its
pid, and sends their paths over the TCP connection; the server attaches
and answers OK, the client then UNLINKS the files -- both processes hold
the mappings, so a SIGKILL on either side cannot leak a name in /dev/shm.
Any refusal (conf off on the server, attach failure, non-colocated peer
that cannot see the paths) answers ERR and the TCP connection continues
unchanged -- the upgrade is strictly opportunistic.

Degrade path: a dead or wedged peer is detected by pid liveness
(``os.kill(pid, 0)``) while stalled on a full/empty ring, surfacing as
``ConnectionError``/``socket.timeout`` -- the SAME exceptions the TCP
paths raise -- so every existing reconnect/degrade loop (replication's
resync machinery, PSClient's retry policy) handles a ring failure by
falling back to a fresh TCP dial with no new code.  Counters
(``native`` family): shm_upgrades, shm_upgrade_refused, shm_degrades,
shm_frames_sent, shm_bytes_sent / shm_bytes_recv.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import socket
import struct
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

from asyncframework_tpu_torch.native_build import bump_native as _bump_native

_MAGIC = 0x53524E47  # 'SRNG'
_VERSION = 2
_HDR = 192  # ring header bytes; data region follows
# v2 layout: head and tail each own a full cache line (v1 packed them 8
# bytes apart, and the two sides' counter publishes invalidated each
# other's hot line on every call -- measured at >4x streaming slowdown)
_OFF_HEAD = 64  # u64, reader-owned: bytes consumed
_OFF_TAIL = 128  # u64, writer-owned: bytes produced
_OFF_WPID = 32  # u32 writer pid / u32 reader pid at 36 (liveness checks)
_OFF_RPID = 36
_OFF_FLAGS = 40  # bit0 = writer closed, bit1 = reader closed

# ---------------------------------------------------------- native loading
#: native symbol -> same-module pure-Python oracle (``native-oracle``
#: lint); the twins operate on the same mmap layout, so a native writer
#: and a Python reader interoperate (cross-tested in tests/test_native.py)
NATIVE_ORACLES = {
    "shm_ring_init": "_py_ring_init",
    "shm_ring_ok": "_py_ring_ok",
    "shm_ring_close": "_py_ring_close",
    "shm_ring_write": "_py_ring_write",
    "shm_ring_read": "_py_ring_read",
}

_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    lib = None
    try:
        from asyncframework_tpu_torch.native_build import ensure_built

        built = ensure_built("shmring")
        if built:
            lib = ctypes.CDLL(built)
            P, LL = ctypes.c_void_p, ctypes.c_longlong
            lib.shm_ring_init.restype = ctypes.c_int
            lib.shm_ring_init.argtypes = [P, ctypes.c_ulonglong]
            lib.shm_ring_ok.restype = ctypes.c_int
            lib.shm_ring_ok.argtypes = [P]
            lib.shm_ring_close.restype = None
            lib.shm_ring_close.argtypes = [P, ctypes.c_int]
            lib.shm_ring_write.restype = LL
            lib.shm_ring_write.argtypes = [P, P, LL]
            lib.shm_ring_read.restype = LL
            lib.shm_ring_read.argtypes = [P, P, LL]
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


# ------------------------------------------------------- pure-Python twin
# The oracle implementations.  CPython gives no explicit memory fences,
# but each op is a handful of bytecodes whose stores the interpreter
# cannot reorder, and on the TSO hardware this targets a plain store
# after the data copy is exactly the release-publish the native twin
# does.  The one semantic gap: ``_py_ring_close`` is a read-modify-write
# of the flags word without atomic OR, so two sides closing in the same
# microsecond can drop one bit -- the peer then learns of the close one
# pid-liveness check later instead of immediately.  Harmless (a closed
# side is on its way out of the process anyway), and only reachable in
# the mixed shutdown race.
def _py_ring_init(mm, capacity: int) -> int:
    if capacity <= 0:
        return -1
    mm[0:_HDR] = b"\0" * _HDR
    struct.pack_into("<IIQ", mm, 0, _MAGIC, _VERSION, capacity)
    return 0


def _py_ring_ok(mm) -> int:
    magic, ver = struct.unpack_from("<II", mm, 0)
    return 1 if (magic == _MAGIC and ver == _VERSION) else 0


def _py_ring_close(mm, writer: int) -> None:
    (flags,) = struct.unpack_from("<I", mm, _OFF_FLAGS)
    struct.pack_into("<I", mm, _OFF_FLAGS, flags | (1 if writer else 2))


def _py_ring_write(mm, data, n: int) -> int:
    (flags,) = struct.unpack_from("<I", mm, _OFF_FLAGS)
    if flags & 2:
        return -1
    (cap,) = struct.unpack_from("<Q", mm, 8)
    (head,) = struct.unpack_from("<Q", mm, _OFF_HEAD)
    (tail,) = struct.unpack_from("<Q", mm, _OFF_TAIL)
    take = min(n, cap - (tail - head))
    if not take:
        return 0
    pos = tail % cap
    first = min(take, cap - pos)
    mm[_HDR + pos:_HDR + pos + first] = data[:first]
    if take > first:
        mm[_HDR:_HDR + take - first] = data[first:take]
    struct.pack_into("<Q", mm, _OFF_TAIL, tail + take)
    return take


def _py_ring_read(mm, maxn: int):
    """Bytes read (possibly ``b""`` for an empty ring), or ``-1`` for
    empty-and-writer-closed (clean EOF)."""
    (cap,) = struct.unpack_from("<Q", mm, 8)
    (head,) = struct.unpack_from("<Q", mm, _OFF_HEAD)
    (tail,) = struct.unpack_from("<Q", mm, _OFF_TAIL)
    avail = tail - head
    if not avail:
        (flags,) = struct.unpack_from("<I", mm, _OFF_FLAGS)
        return -1 if flags & 1 else b""
    take = min(maxn, avail)
    pos = head % cap
    first = min(take, cap - pos)
    out = mm[_HDR + pos:_HDR + pos + first]
    if take > first:
        out += mm[_HDR:_HDR + take - first]
    struct.pack_into("<Q", mm, _OFF_HEAD, head + take)
    return out


# ------------------------------------------------------------------- ring
class ShmRing:
    """One direction of the transport: an mmap'd SPSC byte ring.

    Exactly one process writes and one reads; both may independently run
    the native or the Python implementation per call (the layout is the
    contract, not the code).
    """

    def __init__(self, mm: mmap.mmap, path: str, capacity: int):
        self._mm = mm
        self.path = path
        self.capacity = capacity
        # pin the buffer once for native calls; released in close()
        self._cbuf = ctypes.c_char.from_buffer(mm)
        self._addr = ctypes.addressof(self._cbuf)
        # backend resolved ONCE per ring: the data-plane calls run at
        # poll rates where even the conf lookup in _use_native() shows
        # up; rings are constructed after conf is settled (upgrade time)
        self._lib = _use_native()

    # -- lifecycle
    @classmethod
    def create(cls, capacity: int, directory: Optional[str] = None
               ) -> "ShmRing":
        d = directory or ("/dev/shm" if os.path.isdir("/dev/shm")
                          else tempfile.gettempdir())
        fd, path = tempfile.mkstemp(prefix="async-shm-", suffix=".ring",
                                    dir=d)
        try:
            os.ftruncate(fd, _HDR + capacity)
            mm = mmap.mmap(fd, _HDR + capacity)
        except OSError:
            os.close(fd)
            os.unlink(path)
            raise
        os.close(fd)
        ring = cls(mm, path, capacity)
        if ring._lib is not None:
            rc = ring._lib.shm_ring_init(ring._addr, capacity)
        else:
            rc = _py_ring_init(mm, capacity)
        if rc != 0:
            ring.close()
            os.unlink(path)
            raise ValueError(f"bad ring capacity {capacity}")
        return ring

    @classmethod
    def attach(cls, path: str) -> "ShmRing":
        with open(path, "r+b") as f:
            size = os.fstat(f.fileno()).st_size
            if size <= _HDR:
                raise ValueError(f"ring file too small: {path}")
            mm = mmap.mmap(f.fileno(), size)
        ring = cls(mm, path, size - _HDR)
        ok = (ring._lib.shm_ring_ok(ring._addr) if ring._lib is not None
              else _py_ring_ok(mm))
        if not ok:
            ring.close()
            raise ValueError(f"not a ring segment: {path}")
        return ring

    def close(self, as_writer: Optional[bool] = None) -> None:
        """Release the mapping; with ``as_writer`` given, first latch the
        matching closed flag so the peer sees EOF (reader) or stops
        writing (writer) instead of waiting out a liveness check."""
        if self._mm is None:
            return
        if as_writer is not None:
            try:
                self.latch_closed(as_writer)
            except (OSError, ValueError):  # pragma: no cover - racing unmap
                pass
        self._cbuf = None  # unpin before closing the mapping
        try:
            self._mm.close()
        except BufferError:  # pragma: no cover - stray export
            pass
        self._mm = None

    def latch_closed(self, as_writer: bool) -> None:
        """Set this side's closed flag without unmapping (shutdown())."""
        if self._lib is not None:
            self._lib.shm_ring_close(self._addr, 1 if as_writer else 0)
        else:
            _py_ring_close(self._mm, 1 if as_writer else 0)

    # -- pid stamping (liveness checks read the OTHER side's slot)
    def stamp_pid(self, as_writer: bool) -> None:
        struct.pack_into("<I", self._mm,
                         _OFF_WPID if as_writer else _OFF_RPID, os.getpid())

    def peer_pid(self, i_am_writer: bool) -> int:
        (pid,) = struct.unpack_from(
            "<I", self._mm, _OFF_RPID if i_am_writer else _OFF_WPID)
        return pid

    def available(self) -> int:
        """Readable bytes right now (layout peek; no side effects)."""
        (head,) = struct.unpack_from("<Q", self._mm, _OFF_HEAD)
        (tail,) = struct.unpack_from("<Q", self._mm, _OFF_TAIL)
        return int(tail - head)

    # -- data plane (per-call native/Python dispatch)
    def write(self, buf) -> int:
        """Bytes accepted (0 = full, caller paces); -1 = reader closed."""
        view = memoryview(buf)
        if self._lib is not None:
            a = np.frombuffer(view, np.uint8)
            return int(self._lib.shm_ring_write(
                self._addr, ctypes.c_void_p(a.ctypes.data), a.size))
        return _py_ring_write(self._mm, view, len(view))

    def read_into(self, view) -> int:
        """Bytes filled into ``view`` (0 = empty); -1 = clean EOF."""
        if self._lib is not None:
            a = np.frombuffer(view, np.uint8)
            return int(self._lib.shm_ring_read(
                self._addr, ctypes.c_void_p(a.ctypes.data), a.size))
        got = _py_ring_read(self._mm, len(view))
        if isinstance(got, int):
            return got
        view[: len(got)] = got
        return len(got)


# ------------------------------------------------------------ duck socket
def _peer_alive(pid: int) -> bool:
    if pid <= 0:
        return True  # not yet stamped; give it the benefit of the doubt
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - cross-uid colocations
        return True


#: stall loop tuning: busy-poll briefly (one frame turnaround is usually
#: microseconds), then back off -- first by YIELDING the core (the peer
#: may be runnable on this very CPU; ``sleep(0)`` is sched_yield), then
#: by short sleeps; consult peer liveness about every _LIVENESS_EVERY_S
#: of accumulated waiting.  On a single-CPU box spinning can only steal
#: the peer's timeslice, so the spin window collapses to zero there.
_SPIN_ITERS = 200 if (os.cpu_count() or 1) > 1 else 0
_YIELD_ITERS = 32
_SLEEP_S = 0.0002
_LIVENESS_EVERY_S = 0.05


class ShmSocket:
    """The socket-shaped face of a duplex ring pair.

    Implements exactly the surface ``net/frame.py`` touches --
    ``sendall``/``sendmsg`` (gather), ``recv_into``, timeout get/set
    (honouring the retry-deadline caps), ``getpeername`` (delegated to
    the RETAINED TCP connection, so fault-schedule endpoint addressing
    and log lines are unchanged), ``shutdown``/``close``/``fileno`` --
    so the framing, tracing, fault-injection, and byte-accounting choke
    point runs unmodified over shared memory.  Weakref-able by design
    (frame.py's resting-timeout stash requires it).
    """

    def __init__(self, rd: ShmRing, wr: ShmRing, tcp: socket.socket):
        self._rd = rd
        self._wr = wr
        self._tcp = tcp
        self._timeout = tcp.gettimeout()

    # -- timeouts (frame._deadline_cap drives these)
    def gettimeout(self) -> Optional[float]:
        return self._timeout

    def settimeout(self, t: Optional[float]) -> None:
        self._timeout = t

    def getpeername(self):
        return self._tcp.getpeername()

    def fileno(self) -> int:
        return self._tcp.fileno()

    def readable(self) -> bool:
        """Zero-wait readiness probe (``select`` cannot see ring bytes
        on the retained TCP fd; prefetch hit/miss accounting asks here)."""
        try:
            return self._rd.available() > 0
        except (TypeError, struct.error):  # pragma: no cover - closed
            return False

    # -- stall handling shared by both directions
    def _stall(self, started: float, slept: float, stalls: int,
               ring: ShmRing, i_am_writer: bool, what: str
               ) -> Tuple[float, float]:
        now = time.monotonic()
        if self._timeout is not None and now - started >= self._timeout:
            raise socket.timeout(f"shm ring {what} timed out")
        if now - started >= slept + _LIVENESS_EVERY_S:
            slept = now - started
            if not _peer_alive(ring.peer_pid(i_am_writer)):
                _bump_native("shm_degrades")
                raise ConnectionError(f"shm peer died mid-{what}")
        # yield first: when the peer shares this CPU, handing it the
        # core moves a whole ring's worth per switch; sleep only once
        # yielding has demonstrably not unblocked us
        time.sleep(0 if stalls <= _SPIN_ITERS + _YIELD_ITERS else _SLEEP_S)
        return started, slept

    # -- send side
    def _write_all(self, view) -> None:
        a = np.frombuffer(view, np.uint8)
        off = 0
        started = time.monotonic()
        slept = 0.0
        spins = 0
        while off < a.size:
            w = self._wr.write(a[off:])
            if w == -1:
                _bump_native("shm_degrades")
                raise ConnectionError("shm peer closed the ring")
            if w > 0:
                off += w
                started = time.monotonic()  # progress resets the clock
                slept = 0.0
                spins = 0
                continue
            spins += 1
            if spins <= _SPIN_ITERS:
                continue
            started, slept = self._stall(started, slept, spins,
                                         self._wr, True, "write")

    def sendall(self, data) -> None:
        view = memoryview(data).cast("B")
        self._write_all(view)
        _bump_native("shm_frames_sent")
        _bump_native("shm_bytes_sent", len(view))

    def sendmsg(self, buffers) -> int:
        """Write EVERY buffer before returning (a blocking socket may
        legally do so); one ``_sendmsg_all`` call therefore maps to one
        frame, which is what makes ``shm_frames_sent`` a frame count."""
        views = [memoryview(b).cast("B") for b in buffers]
        total = 0
        for v in views:
            if len(v):
                self._write_all(v)
                total += len(v)
        _bump_native("shm_frames_sent")
        _bump_native("shm_bytes_sent", total)
        return total

    # -- receive side
    def recv_into(self, buf, nbytes: int = 0) -> int:
        view = memoryview(buf).cast("B")
        if nbytes:
            view = view[:nbytes]
        if not len(view):
            return 0
        started = time.monotonic()
        slept = 0.0
        spins = 0
        while True:
            got = self._rd.read_into(view)
            if got == -1:
                return 0  # EOF: recv_exact raises ConnectionError
            if got > 0:
                _bump_native("shm_bytes_recv", got)
                return got
            spins += 1
            if spins <= _SPIN_ITERS:
                continue
            started, slept = self._stall(started, slept, spins,
                                         self._rd, False, "read")

    # -- teardown
    def shutdown(self, how: int) -> None:
        for ring, as_writer in ((self._wr, True), (self._rd, False)):
            try:
                ring.latch_closed(as_writer)
            except (OSError, ValueError, AttributeError, TypeError):
                pass
        try:
            self._tcp.shutdown(how)
        except OSError:
            pass

    def close(self) -> None:
        self._wr.close(as_writer=True)
        self._rd.close(as_writer=False)
        try:
            self._tcp.close()
        except OSError:  # pragma: no cover
            pass


# -------------------------------------------------------------- handshake
def _colocated(sock: socket.socket) -> bool:
    try:
        host = sock.getpeername()[0]
    except OSError:
        return False
    return host.startswith("127.") or host == "::1" or host == "localhost"


def maybe_upgrade(sock: socket.socket) -> Tuple[object, bool]:
    """Client side: opportunistically swap ``sock`` for a ring transport.

    Returns ``(transport, upgraded)``.  Refusals of every kind -- conf
    off, non-loopback peer, segment creation failure, server ERR --
    return the original socket untouched; a handshake that dies MID-WIRE
    raises (the connection is in an unknown framing state, and the
    caller's normal drop-and-redial error path is the correct recovery).
    """
    from asyncframework_tpu_torch.conf import (SHM_ENABLED, SHM_RING_KB,
                                         global_conf)
    from asyncframework_tpu_torch.net import frame as _frame

    conf = global_conf()
    if not conf.get(SHM_ENABLED) or not _colocated(sock):
        return sock, False
    cap = int(conf.get(SHM_RING_KB)) * 1024
    try:
        c2s = ShmRing.create(cap)
    except (OSError, ValueError):
        return sock, False
    try:
        s2c = ShmRing.create(cap)
    except (OSError, ValueError):
        c2s.close()
        os.unlink(c2s.path)
        return sock, False
    c2s.stamp_pid(as_writer=True)
    s2c.stamp_pid(as_writer=False)
    refused = True
    try:
        _frame.send_msg(sock, {"op": "SHM_OPEN", "c2s": c2s.path,
                               "s2c": s2c.path, "pid": os.getpid()})
        header, _ = _frame.recv_msg(sock)
        if header.get("op") == "OK":
            refused = False
            _bump_native("shm_upgrades")
            return ShmSocket(rd=s2c, wr=c2s, tcp=sock), True
        _bump_native("shm_upgrade_refused")
        return sock, False
    finally:
        # the names are transient either way: on OK both sides hold the
        # mappings (unlink frees nothing until both unmap); on refusal
        # the segments are dead weight.  Unlinking HERE -- before the
        # first data frame -- is what makes a SIGKILL unable to leak a
        # /dev/shm entry.
        for ring in (c2s, s2c):
            try:
                os.unlink(ring.path)
            except OSError:
                pass
        if refused:
            c2s.close()
            s2c.close()


def serve_attach(conn: socket.socket, header: dict) -> Optional[ShmSocket]:
    """Server side of ``SHM_OPEN``: attach to the client's segments and
    ACK, or ERR and return None (caller keeps serving the TCP socket).
    The attach path trusts nothing: missing fields, unreadable paths,
    and bad magic all refuse."""
    from asyncframework_tpu_torch.conf import SHM_ENABLED, global_conf
    from asyncframework_tpu_torch.net import frame as _frame

    if not global_conf().get(SHM_ENABLED):
        _bump_native("shm_upgrade_refused")
        _frame.send_msg(conn, {"op": "ERR", "msg": "shm disabled"})
        return None
    try:
        rd = ShmRing.attach(str(header["c2s"]))
    except (OSError, ValueError, KeyError, TypeError):
        _bump_native("shm_upgrade_refused")
        _frame.send_msg(conn, {"op": "ERR", "msg": "shm attach failed"})
        return None
    try:
        wr = ShmRing.attach(str(header["s2c"]))
    except (OSError, ValueError, KeyError, TypeError):
        rd.close()
        _bump_native("shm_upgrade_refused")
        _frame.send_msg(conn, {"op": "ERR", "msg": "shm attach failed"})
        return None
    rd.stamp_pid(as_writer=False)
    wr.stamp_pid(as_writer=True)
    _bump_native("shm_upgrades")
    _frame.send_msg(conn, {"op": "OK"})
    return ShmSocket(rd=rd, wr=wr, tcp=conn)

"""Shared framed-TCP server scaffolding for the serving tier.

The replica's predict server and the frontend's front door are the same
shape: a listening socket with a short accept timeout, one daemon thread
per connection, finished-handler reaping on append (the thread-leak class
the PS's copy of this loop guards against too), a recv/dispatch loop over
``net/frame.py`` messages with shared BYE -> ACK and bad-op -> ERR
handling, and a stop that closes the listener and drops requests already
in flight (a stopped server must fail over, not serve one last possibly-
stale answer).  One base class so a fix to this pattern lands once, not
per daemon; subclasses implement only :meth:`handle_op`.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional

from asyncframework_tpu_torch.net import frame as _frame

_send_msg = _frame.send_msg
_recv_msg = _frame.recv_msg


class FramedServer:
    """Accept-loop + per-connection dispatch over the ``net/`` framing.

    Subclasses call :meth:`bind` (immediately or lazily), then
    :meth:`start_accepting`; :meth:`handle_op` returns True when it
    answered the op, False for the shared bad-op ERR reply."""

    def __init__(self, name: str):
        self._name = name
        self._srv: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def bind(self, host: str, port: int) -> None:
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]

    def start_accepting(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self._name}-accept",
            daemon=True,
        )
        self._accept_thread.start()

    def stop_server(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        self._threads = [t for t in self._threads if t.is_alive()]

    # -------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"{self._name}-conn-{conn.fileno()}", daemon=True
            )
            t.start()
            # reap on append: a long-lived daemon accepts a fresh
            # connection per client reconnect -- finished handler threads
            # must not accumulate for the life of the process
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                header, payload = _recv_msg(conn)
                if self._stop.is_set():
                    # stopped while blocked in recv: drop the request
                    # instead of serving one last (possibly stale) answer
                    # -- the caller's failover handles it
                    return
                op = header.get("op")
                if op == "BYE":
                    _send_msg(conn, {"op": "ACK"})
                    return
                if not self.handle_op(conn, op, header, payload):
                    _send_msg(conn, {"op": "ERR", "msg": f"bad op {op}"})
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def handle_op(self, conn: socket.socket, op: Optional[str],
                  header: dict, payload: bytes) -> bool:
        raise NotImplementedError

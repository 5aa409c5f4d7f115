"""Single-machine leader election for standby masters.

Parity (studied, not copied): the reference's master HA is ZooKeeper leader
election + standby masters
(``deploy/master/ZooKeeperLeaderElectionAgent.scala:26``,
``ZooKeeperPersistenceEngine.scala:34``): masters race for an ephemeral
znode; the winner recovers state from the persistence engine and serves;
the losers answer every RPC with "not leader"; when the leader's session
dies the next master wins the race.

Single-node design: the ephemeral znode's two properties --
exclusive ownership and automatic release on process death -- are exactly
the semantics of an exclusive ``flock`` on a file in the persistence
directory.  A SIGKILLed master's lock is released by the kernel the instant
the process dies, no TTL clock to tune, no renewal thread, no split-brain
window (the consensus *service* stays out of scope on one machine, as the
Master's docstring already records; on a real multi-host deployment this
interface point is where etcd/ZK would plug in).

The holder also writes its address into the lock file so operators (and the
submission client's error messages) can see who is active -- the analog of
the znode payload.

A copy of ``asyncframework_tpu/deploy/leader.py``.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from typing import Optional


class FileLeaderElection:
    """Exclusive-flock leadership over ``<dir>/master.lock``.

    ``try_acquire`` is non-blocking; ``acquire_blocking`` polls until won or
    stopped.  Leadership is held until :meth:`release` or process death.
    """

    def __init__(self, lock_path: str):
        self.lock_path = lock_path
        self._fd: Optional[int] = None

    @property
    def is_leader(self) -> bool:
        return self._fd is not None

    def try_acquire(self, holder: str = "") -> bool:
        if self._fd is not None:
            return True
        fd = os.open(self.lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        # won: record the holder for observability (never read for safety
        # decisions -- the flock itself is the source of truth)
        os.ftruncate(fd, 0)
        os.write(fd, json.dumps(
            {"holder": holder, "pid": os.getpid()}
        ).encode())
        os.fsync(fd)
        self._fd = fd
        return True

    def acquire_blocking(self, stop: Optional[threading.Event] = None,
                         holder: str = "", poll_s: float = 0.1) -> bool:
        """Poll until leadership is won; returns False if ``stop`` fired
        first.  Polling (not a blocking flock) keeps shutdown prompt."""
        while stop is None or not stop.is_set():
            if self.try_acquire(holder):
                return True
            time.sleep(poll_s)
        return False

    def holder_info(self) -> Optional[dict]:
        """Best-effort read of the current holder record (may be stale)."""
        try:
            with open(self.lock_path) as f:
                return json.loads(f.read() or "{}")
        except (OSError, ValueError):
            return None

    def release(self) -> None:
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None

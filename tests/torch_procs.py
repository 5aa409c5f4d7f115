"""Bounded waits on child processes for the port's tests.

A test that waits on a child without a bound can hang the whole run; with
these a hang fails that one test."""

import threading


def readline_within(proc, timeout_s: float = 120.0) -> str:
    """The next line of ``proc``'s stdout, waited for at most
    ``timeout_s`` (the child is killed if none comes, so a blocked read
    ends too)."""
    box = []
    reader = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(timeout_s)
    if not box:
        proc.kill()
        reader.join(10.0)
        raise AssertionError(f"no line from pid {proc.pid} within "
                             f"{timeout_s} s")
    return box[0]


def kill_and_reap(proc, timeout_s: float = 30.0) -> None:
    """SIGKILL ``proc`` if it still runs and wait for it, at most
    ``timeout_s``."""
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=timeout_s)

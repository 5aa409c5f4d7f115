"""Debug lock watchdog: no socket I/O while a watched lock is held.

The pipelined data plane's central claim is that ``_handle_pull`` serves
model replies WITHOUT touching the PS model lock (the lock guards the
updater's apply path only), and that nothing anywhere does wire I/O while
holding it -- a send or recv under the model lock would let one slow
worker's socket stall every merge in the process.  That claim is easy to
break silently in a refactor, so this module makes it checkable at
runtime:

- :class:`WatchedLock` is a drop-in ``threading.Lock`` replacement that
  tracks, per thread, which watched locks are currently held, plus hold
  counts and the max hold time (reported in the live UI's ``lockwatch``
  section).
- ``net/frame.py`` calls :func:`check_io` at its send/recv choke points;
  when the watchdog is enabled and the calling thread holds any watched
  lock, the call raises ``AssertionError`` naming the lock -- the
  violation is also counted, so soak harnesses can assert on totals.

Enablement is process-global and off by default (one module-flag check
per frame when disabled).  ``async.debug.lockwatch`` turns it on via
conf/env (subprocess chaos children inherit
``ASYNCTPU_ASYNC_DEBUG_LOCKWATCH=1``); :func:`enable` turns it on
programmatically (the chaos suite's autouse fixture).  The PS installs a
watched model lock whenever either source says so, and the other
contended locks of the training plane ride :func:`named_lock` -- plain
``threading.Lock`` when the watchdog is off (zero hot-path cost),
watched when it is on.

**Lock-order race detection** (the dynamic half of the async-lint
story): every acquisition of a watched lock B while the thread already
holds watched lock A folds an A->B edge into a process-global
acquisition-order graph.  A cycle in that graph is a POTENTIAL DEADLOCK
-- two threads taking the same pair of locks in opposite orders need
only the right interleaving to wedge forever, which is exactly the kind
of bug a chaos run exhibits once a year and a graph exhibits on the
first pass.  Cycles are counted and rendered in :func:`totals` (the
live UI ``lockwatch`` section), :func:`assert_no_cycles` raises with
the rendered cycles (the chaos suite's autouse fixture calls it at
teardown, and ``bin/chaos_sweep.py`` arms the detector every seed), and
``lock_order_edges``/``lock_order_cycles`` expose the raw graph for
tests.  The static twin -- blocking calls lexically under a lock --
lives in ``asyncframework_tpu_torch/analysis/rules_locks.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

_enabled = False

_tls = threading.local()

_totals_lock = threading.Lock()
_holds = 0
_violations = 0
_max_hold_ms = 0.0
# acquisition-order graph: (held, acquired) -> observation count; cycles
# keyed by their canonical rotation so each distinct cycle reports once
_edges: Dict[Tuple[str, str], int] = {}
_cycles: Dict[Tuple[str, ...], str] = {}
# sticky cycle history: reset_totals() FOLDS current cycles here instead
# of erasing them -- a cycle is a correctness verdict, not a per-run
# counter, so a suite resetting the graph for isolation must not be able
# to erase another suite's potential deadlock before the session-wide
# gate (tests/conftest.py) sees it.  Cleared only by
# clear_cycle_history() (tests that drive cycles DELIBERATELY).
_cycles_ever: List[str] = []


def enable(flag: bool = True) -> None:
    """Turn the watchdog on/off process-wide (tests/suites; conf-driven
    daemons go through :func:`enabled_for`)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def enabled_for(conf=None) -> bool:
    """Should a freshly constructed server run with a watched lock?
    True when the watchdog was enabled programmatically OR
    ``async.debug.lockwatch`` is set; a conf hit also flips the process
    flag so the frame choke points start checking."""
    if _enabled:
        return True
    from asyncframework_tpu_torch.conf import DEBUG_LOCKWATCH, global_conf

    conf = conf if conf is not None else global_conf()
    if bool(conf.get(DEBUG_LOCKWATCH)):
        enable(True)
        return True
    return False


def named_lock(name: str):
    """A lock for a contended structure: :class:`WatchedLock` when the
    watchdog is armed (hold stats + I/O assert + lock-order edges),
    plain ``threading.Lock`` otherwise.  Construction-time resolution,
    same contract as the PS model lock."""
    if enabled_for():
        return WatchedLock(name)
    return threading.Lock()


def held() -> List[str]:
    """Names of the watched locks the calling thread currently holds."""
    return list(getattr(_tls, "stack", ()))


# ------------------------------------------------------------ lock order
def _canonical(cycle: Tuple[str, ...]) -> Tuple[str, ...]:
    """Rotate a cycle (no repeated terminal) so its min element leads --
    one key per distinct cycle regardless of discovery point."""
    i = cycle.index(min(cycle))
    return cycle[i:] + cycle[:i]


def _record_edges(held_now: List[str], acquired: str) -> None:
    """Fold held->acquired edges into the graph; on a NEW edge, scan for
    cycles it closes (DFS from ``acquired`` back to the edge's tail).
    Called under ``_totals_lock``; the graph is names, small."""
    for h in held_now:
        if h == acquired:
            continue
        edge = (h, acquired)
        seen = _edges.get(edge, 0)
        _edges[edge] = seen + 1
        if seen:
            continue  # old edge cannot close a new cycle
        # DFS: path acquired ->* h closes the cycle h -> acquired -> ... -> h
        stack: List[Tuple[str, Tuple[str, ...]]] = [(acquired, (h, acquired))]
        while stack:
            node, path = stack.pop()
            for (a, b) in _edges:
                if a != node or b in path[1:]:
                    continue
                if b == h:
                    key = _canonical(path)
                    if key not in _cycles:
                        _cycles[key] = " -> ".join(path + (h,))
                elif len(path) < 16:
                    stack.append((b, path + (b,)))


def lock_order_edges() -> Dict[Tuple[str, str], int]:
    """The observed acquisition-order graph (edge -> count)."""
    with _totals_lock:
        return dict(_edges)


def lock_order_cycles() -> List[str]:
    """Rendered potential-deadlock cycles ('a -> b -> a'), one per
    distinct cycle, discovery order."""
    with _totals_lock:
        return list(_cycles.values())


def cycle_history() -> List[str]:
    """Every cycle observed since the last :func:`clear_cycle_history`,
    including ones folded in by intervening ``reset_totals()`` calls."""
    with _totals_lock:
        cur = [c for c in _cycles.values() if c not in _cycles_ever]
        return list(_cycles_ever) + cur


def set_cycle_history(cycles: List[str]) -> None:
    """Replace the sticky cycle log.  ONLY for tests/harnesses that
    create cycles deliberately (tests/test_analysis.py's detector
    units, chaos_sweep's lockorder_sanity): they snapshot
    :func:`cycle_history` BEFORE driving their cycle and RESTORE the
    snapshot afterwards -- wholesale clearing would also erase a real
    cycle an earlier armed suite left for the session-wide gate."""
    with _totals_lock:
        _cycles_ever[:] = list(cycles)


def clear_cycle_history() -> None:
    """``set_cycle_history([])`` -- see the restore-don't-clear caveat
    there."""
    set_cycle_history([])


def assert_no_cycles(include_history: bool = False) -> None:
    """Raise AssertionError naming every observed lock-order cycle --
    the chaos suite's teardown check and chaos_sweep's per-seed gate.
    ``include_history=True`` (the session-wide conftest gate) also
    counts cycles a reset_totals() folded into the sticky history."""
    cycles = cycle_history() if include_history else lock_order_cycles()
    if cycles:
        raise AssertionError(
            "lockwatch: potential deadlock -- lock-order cycle(s) "
            "observed: " + "; ".join(cycles))


def check_io(what: str) -> None:
    """Choke-point assert (``net/frame.py``): socket I/O under a watched
    lock is the exact contention the lock-free pull path exists to
    remove.  No-op when disabled."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", None)
    if stack:
        global _violations
        with _totals_lock:
            _violations += 1
        raise AssertionError(
            f"lockwatch: socket {what} while holding watched lock(s) "
            f"{list(stack)}"
        )


class WatchedLock:
    """``threading.Lock`` with per-thread hold tracking + hold-time
    stats.  Context-manager and acquire/release compatible; the tracking
    cost is two thread-local list ops per hold."""

    __slots__ = ("name", "_lock", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        # per-holder acquire time; single writer (the holder), so a plain
        # attribute is enough
        self._t0 = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            if stack:
                # nested hold: fold acquisition-order edges (held -> new)
                # into the process-global graph and scan for cycles
                with _totals_lock:
                    _record_edges(stack, self.name)
            stack.append(self.name)
            self._t0 = time.monotonic()
        return got

    def release(self) -> None:
        global _holds, _max_hold_ms
        hold_ms = (time.monotonic() - self._t0) * 1e3
        stack = getattr(_tls, "stack", None)
        if stack and self.name in stack:
            stack.remove(self.name)
        with _totals_lock:
            _holds += 1
            if hold_ms > _max_hold_ms:
                _max_hold_ms = hold_ms
        self._lock.release()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()


def totals() -> Dict[str, object]:
    """Watchdog report for the live UI: enabled flag, hold count, max
    single hold in ms, violations caught (0 is the claim holding)."""
    with _totals_lock:
        return {
            "enabled": _enabled,
            "holds": _holds,
            "violations": _violations,
            "max_hold_ms": round(_max_hold_ms, 3),
            # lock-order race detector: observed acquisition-order edges
            # and the potential-deadlock cycles among them (0 = claim
            # holding); cycles rendered for the dashboard, capped
            "order_edges": len(_edges),
            "order_cycles": len(_cycles),
            "cycles": list(_cycles.values())[:8],
        }


def reset_totals() -> None:
    """Zero the counters and the acquisition-order graph (per-run
    isolation; enabled flag untouched).  Cycles are FOLDED into the
    sticky history, not erased -- see ``_cycles_ever``."""
    global _holds, _violations, _max_hold_ms
    with _totals_lock:
        _holds = 0
        _violations = 0
        _max_hold_ms = 0.0
        for c in _cycles.values():
            if c not in _cycles_ever:
                _cycles_ever.append(c)
        _edges.clear()
        _cycles.clear()

"""Unified retry/backoff policy + per-endpoint circuit breakers.

Before this module the DCN plane had three independent hand-rolled
reconnect loops (``ps_dcn.run_worker_process``'s bare "drop socket, back
off, re-pull", ``RemoteLogTopic._call``'s fixed-count loop, the deploy
daemons' rotate-and-sleep) -- each with its own backoff shape, none with a
deadline, none observable.  :class:`RetryPolicy` is the one policy they all
route through now:

- **exponential backoff with decorrelated jitter** (the AWS-style
  ``sleep = min(cap, U(base, 3 * prev))`` walk) -- fresh entropy per call
  by default so a fleet's retries decorrelate, seedable so a chaos replay
  sleeps the same schedule;
- **per-attempt timeout** (``attempt_timeout_s``: callers set it as the
  socket timeout -- the policy cannot bound a blocking syscall from
  outside) and an **overall deadline** across attempts;
- **retryable-error classification**: transport errors (``OSError`` --
  which covers ``ConnectionError`` and ``socket.timeout``) retry,
  everything else (protocol errors, bad requests) raises immediately;
- a **circuit breaker per endpoint**: after ``breaker_threshold``
  consecutive failures the endpoint is OPEN and calls fail fast with
  :class:`CircuitOpenError` for ``breaker_cooldown_s``, then one half-open
  probe either closes it or re-opens it.  Breakers are shared process-wide
  by endpoint string, so forty worker threads hammering one dead PS back
  off as a group.

Counters (retries, give-ups, breaker trips) are process-global and
surfaced in the live UI next to the shuffle totals.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


class RetryError(ConnectionError):
    """All attempts exhausted (or deadline passed); ``__cause__`` is the
    last transport error.  Subclasses ConnectionError so existing
    "peer is gone" handlers need no new except clauses."""


class CircuitOpenError(ConnectionError):
    """Failing fast: the endpoint's breaker is open (no dial attempted)."""


_totals_lock = threading.Lock()
_totals = {"retries": 0, "giveups": 0, "breaker_trips": 0}

# -------------------------------------------------------- deadline plumbing
# The overall deadline, enforced AT THE SOCKET LAYER: the policy alone can
# only check the clock between attempts, so one attempt whose socket
# timeout (attempt_timeout_s, default 120 s) exceeds the remaining
# deadline used to hold the caller long past it -- a stalled read (gray
# peer, stall_read fault) outlived the policy.  call() publishes the
# absolute deadline in a thread-local for the attempt's duration;
# net/frame.py consults it before every blocking connect/send/recv and
# caps the socket timeout to the remaining budget (raising socket.timeout
# outright once it is spent).  Zero cost on the no-deadline path.
_deadline_tls = threading.local()


def remaining_deadline_s() -> Optional[float]:
    """Seconds left on the calling thread's active retry deadline; None
    when no deadline-bearing RetryPolicy.call is on the stack."""
    dl = getattr(_deadline_tls, "deadline", None)
    if dl is None:
        return None
    return dl - time.monotonic()


def _bump(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] += n


def retry_totals() -> Dict[str, int]:
    with _totals_lock:
        return dict(_totals)


def reset_retry_totals() -> None:
    with _totals_lock:
        for k in _totals:
            _totals[k] = 0


class CircuitBreaker:
    """Consecutive-failure breaker: CLOSED -> OPEN (threshold reached) ->
    half-open probe after the cooldown -> CLOSED on success / OPEN again
    on failure."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None

    @property
    def open(self) -> bool:
        with self._lock:
            return (
                self._opened_at is not None
                and self._clock() - self._opened_at < self.cooldown_s
            )

    def allow(self) -> bool:
        """False only while OPEN and inside the cooldown; past it the call
        through is the half-open probe."""
        with self._lock:
            if self._opened_at is None:
                return True
            return self._clock() - self._opened_at >= self.cooldown_s

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def record_failure(self) -> bool:
        """Returns True when THIS failure trips (or re-trips) the breaker."""
        with self._lock:
            self._failures += 1
            was_open = self._opened_at is not None
            if self._failures >= self.threshold:
                tripping = (not was_open
                            or self._clock() - self._opened_at
                            >= self.cooldown_s)
                self._opened_at = self._clock()
                return tripping
            return False


_breakers_lock = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}


def breaker_for(endpoint: str, threshold: int = 5, cooldown_s: float = 1.0
                ) -> CircuitBreaker:
    """The process-wide breaker for an endpoint (first caller's settings
    win; all clients of one endpoint share one breaker by design)."""
    with _breakers_lock:
        br = _breakers.get(endpoint)
        if br is None:
            br = CircuitBreaker(threshold, cooldown_s)
            _breakers[endpoint] = br
        return br


def reset_breakers() -> None:
    """Drop all per-endpoint breakers (tests; ephemeral ports recycle)."""
    with _breakers_lock:
        _breakers.clear()


def default_classify(exc: BaseException) -> bool:
    """Retry transport faults, surface everything else immediately."""
    return isinstance(exc, OSError)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 5
    base_ms: float = 50.0
    max_ms: float = 2000.0
    attempt_timeout_s: float = 120.0   # callers apply as the socket timeout
    deadline_s: float = 0.0            # 0 = no overall deadline
    # None = fresh entropy per call(): forty workers losing one PS must NOT
    # wake in lockstep (the thundering herd jitter exists to break).  Chaos
    # runs pin an int so the backoff walk replays.
    seed: Optional[int] = None
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 1.0
    classify: Callable[[BaseException], bool] = field(
        default=default_classify, repr=False, compare=False
    )
    sleep: Callable[[float], None] = field(
        default=time.sleep, repr=False, compare=False
    )

    @classmethod
    def from_conf(cls, conf=None, **overrides) -> "RetryPolicy":
        from asyncframework_tpu_torch import conf as C

        conf = conf if conf is not None else C.global_conf()
        kw = dict(
            max_attempts=conf.get(C.NET_RETRY_MAX_ATTEMPTS),
            base_ms=conf.get(C.NET_RETRY_BASE_MS),
            max_ms=conf.get(C.NET_RETRY_MAX_MS),
            attempt_timeout_s=conf.get(C.NET_RETRY_ATTEMPT_TIMEOUT_S),
            deadline_s=conf.get(C.NET_RETRY_DEADLINE_S),
            breaker_threshold=conf.get(C.NET_BREAKER_THRESHOLD),
            breaker_cooldown_s=conf.get(C.NET_BREAKER_COOLDOWN_S),
        )
        kw.update(overrides)
        return cls(**kw)

    def backoffs_ms(self):
        """The decorrelated-jitter walk this policy sleeps between
        attempts -- deterministic when ``seed`` is pinned, decorrelated
        across clients otherwise; exposed for tests and replay audits."""
        rng = random.Random(self.seed) if self.seed is not None \
            else random.Random()
        prev = self.base_ms
        while True:
            prev = min(self.max_ms, rng.uniform(self.base_ms, prev * 3))
            yield prev

    def call(self, fn: Callable, *, endpoint: Optional[str] = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None):
        """Run ``fn()`` under this policy.  ``endpoint`` opts into the
        shared circuit breaker; ``on_retry(attempt, exc)`` fires before
        each backoff sleep (callers use it to drop dead sockets)."""
        br = (breaker_for(endpoint, self.breaker_threshold,
                          self.breaker_cooldown_s)
              if endpoint is not None else None)
        backoff = self.backoffs_ms()
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s > 0 else None)
        # publish the absolute deadline for the socket layer (net/frame.py
        # caps connect/recv timeouts to the remaining budget); nested
        # policy calls see the TIGHTER of the two deadlines
        outer_dl = getattr(_deadline_tls, "deadline", None)
        if deadline is not None:
            _deadline_tls.deadline = (deadline if outer_dl is None
                                      else min(deadline, outer_dl))
        try:
            return self._call_inner(fn, br, backoff, deadline, endpoint,
                                    on_retry)
        finally:
            if deadline is not None:
                _deadline_tls.deadline = outer_dl

    def _call_inner(self, fn, br, backoff, deadline, endpoint, on_retry):
        last: Optional[BaseException] = None
        attempt = 0
        for attempt in range(1, self.max_attempts + 1):
            if br is not None and not br.allow():
                _bump("giveups")
                raise CircuitOpenError(
                    f"circuit open for {endpoint} "
                    f"(cooldown {self.breaker_cooldown_s}s)"
                ) from last
            try:
                out = fn()
            except BaseException as e:  # noqa: BLE001 - classified below
                if not self.classify(e):
                    raise
                last = e
                if br is not None and br.record_failure():
                    _bump("breaker_trips")
                if attempt >= self.max_attempts:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                _bump("retries")
                if on_retry is not None:
                    on_retry(attempt, e)
                pause = next(backoff) / 1e3
                if deadline is not None:
                    pause = min(pause, max(0.0, deadline - time.monotonic()))
                self.sleep(pause)
                continue
            if br is not None:
                br.record_success()
            return out
        _bump("giveups")
        raise RetryError(
            f"gave up after {attempt} attempt(s)"
            + (f" to {endpoint}" if endpoint else "")
            + f": {last!r}"
        ) from last

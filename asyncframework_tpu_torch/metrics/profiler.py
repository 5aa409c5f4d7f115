"""Continuous profiling plane: attribute every hot-path cycle.

ROADMAP item 5 argues "the interpreter is the next NIC": every frame
pump, XOR delta, CRC, quantize and compress pass runs in pure Python
under the GIL -- and until now nothing *measured* where those cycles
go.  This module is the measuring instrument the native rewrite will be
validated against: two complementary collectors feeding one declared
zone table.

- **Sampling collector** (statistical, whole-process): a daemon thread
  walks ``sys._current_frames()`` at ``async.prof.hz``, classifies each
  thread's stack into one zone via the ``_CLASSIFIER`` table, and
  collapses the stack into a bounded count map
  (flamegraph-compatible ``a;b;c count`` lines).  Sampling error for a
  zone with true share p after N samples is ~sqrt(p(1-p)/N) -- at
  97 Hz a 60 s window gives ~5800 samples, so a 10 % zone is resolved
  to +-0.4 % -- the ASAP argument (arXiv:1612.08608) that approximate,
  low-overhead measurement is what makes always-on telemetry viable.
- **Exact collector** (nanosecond accumulators): ``zone()`` /
  ``zoned()`` / ``zone_ns()`` at the existing choke points
  (``net/frame.py`` send/recv, ``net/wiredelta.py``,
  ``net/wirecodec.py``, the PS merge drain) plus ``wrap_dispatch()``
  around the step callables (first call = compile, later calls =
  dispatch, per-label EWMA of step wall time).

Off by default (``async.prof.enabled=0``): ``zone()`` returns the one
shared no-op context manager, ``wrap_dispatch()`` returns its argument
unchanged, and the wire is byte-identical -- all asserted by
``tests/test_torch_telemetry.py``.

The zone table below is THE declaration: the async-lint ``prof-zone``
rule cross-checks every zone literal used by a collector or accumulator
anywhere in the tree against it, both directions (undeclared use /
declared-but-never-attributed), matching the series-family discipline.

Import-light by contract (the flight recorder and ``python -m
asyncframework_tpu_torch.metrics.profiler`` import this module on paths
where no CUDA context may be created): no torch / conf / live imports at
module scope.

A copy of the JAX package's ``metrics/profiler.py`` with three parts of
its own:

- the frame classifier's ``kernel.dispatch`` rows name ``/torch/`` and
  this package's kernel launch wrappers (``ops/masked_grad.py``,
  ``ops/sparse_grad.py``, ``ops/chunk_attention.py``) where the JAX
  package names ``/jaxlib/`` and ``/jax/``, and its wire rows name this
  package's modules;
- :func:`memory_gauges` reads ``torch.cuda.memory_stats()`` only once
  CUDA is initialized in the process, so a readout never creates a CUDA
  context;
- :func:`wrap_dispatch` times the host's dispatch of a step, as in JAX:
  it never synchronizes the device, so a wrapped step still captures in
  a CUDA graph.  The first call of a step callable, which here loads the
  kernel library, is counted as ``compile``.  Beside the totals, the
  snapshot's ``dispatch`` section counts each label's compiles and
  dispatches (``labels``).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# ------------------------------------------------------------- zone table
#: THE one declared zone table.  Every zone literal passed to ``zone()``,
#: ``zoned()``, ``zone_ns()``, ``wrap_dispatch()`` or ``_zrule()`` must
#: appear here, and every zone here must be attributed somewhere
#: (async-lint ``prof-zone``, mutation-tested both directions).
ZONES: Tuple[str, ...] = (
    "wire.encode",      # frame pump, send side: header stamp + sendall
    "wire.decode",      # frame pump, recv side: recv_exact + header parse
    "wire.xor",         # XOR bit-pattern delta encode/decode (wiredelta)
    "wire.crc",         # basis CRC gating (wiredelta.crc)
    "wire.quantize",    # gradient quantize/dequantize (wirecodec fp16/int8)
    "wire.compress",    # model-part compress/decompress (wirecodec)
    "merge.drain",      # PS merge-queue drain + fused apply dispatch
    "kernel.dispatch",  # step dispatch (wrap_dispatch wrappers)
    "serde",            # JSON header encode/decode and friends
    "gil.other",        # sampled Python time not claimed by any rule
)

_WIRE_ZONES: Tuple[str, ...] = tuple(z for z in ZONES if z.startswith("wire."))

#: EWMA weight for the per-label step-time gauge (same spirit as the
#: controller's telemetry smoothing: new sample gets 0.2).
_EWMA_ALPHA = 0.2

#: sampler stack bounds: frames kept per stack, distinct collapsed
#: stacks kept (beyond it new stacks are dropped and counted, never
#: evicted -- eviction would bias long-running hot stacks out).
_STACK_DEPTH = 48

_SCHEMA = 1


# ------------------------------------------------------- frame classifier
class _ZRule:
    """One classifier row: substring of the frame's filename (forward
    slashes), optional function-name set, target zone."""

    __slots__ = ("path", "funcs", "zone")

    def __init__(self, path: str, funcs: Tuple[str, ...], zone: str):
        self.path = path
        self.funcs = frozenset(funcs)
        self.zone = zone


def _zrule(path: str, funcs: Tuple[str, ...], zone: str) -> _ZRule:
    # the lint extracts the LAST positional arg of every _zrule(...) call
    # as a zone literal; keep zone last.
    return _ZRule(path, funcs, zone)


#: ordered, first match wins; function-specific rows precede their
#: same-file catch-alls.  The final row is the declared fallback.
_CLASSIFIER: Tuple[_ZRule, ...] = (
    _zrule("asyncframework_tpu_torch/net/wiredelta", ("crc",), "wire.crc"),
    _zrule("asyncframework_tpu_torch/net/wiredelta", (), "wire.xor"),
    _zrule("asyncframework_tpu_torch/net/wirecodec",
           ("encode_grad", "decode_grad", "_quantize", "_dequantize"),
           "wire.quantize"),
    _zrule("asyncframework_tpu_torch/net/wirecodec", (), "wire.compress"),
    _zrule("asyncframework_tpu_torch/net/frame",
           ("_recv_msg_raw", "recv_msg", "recv_exact", "_recv_exact_into"),
           "wire.decode"),
    _zrule("asyncframework_tpu_torch/net/frame", (), "wire.encode"),
    _zrule("asyncframework_tpu_torch/parallel/ps_dcn",
           ("_drain_merge_locked", "_apply_merge"), "merge.drain"),
    _zrule("/json/", (), "serde"),
    _zrule("asyncframework_tpu_torch/ops/masked_grad", (), "kernel.dispatch"),
    _zrule("asyncframework_tpu_torch/ops/sparse_grad", (), "kernel.dispatch"),
    _zrule("asyncframework_tpu_torch/ops/chunk_attention", (),
           "kernel.dispatch"),
    _zrule("/torch/", (), "kernel.dispatch"),
    _zrule("", (), "gil.other"),
)


def _classify_frame(filename: str, funcname: str) -> Optional[str]:
    """Zone for ONE frame, or None if only the fallback would match
    (the stack walk wants 'no specific claim' to keep descending)."""
    for rule in _CLASSIFIER:
        if not rule.path:
            return None
        if rule.path in filename and (not rule.funcs
                                      or funcname in rule.funcs):
            return rule.zone
    return None


def classify_stack(frames: List[Tuple[str, str]]) -> str:
    """Zone for one sampled stack (``[(filename, funcname), ...]``,
    innermost first): the innermost frame any non-fallback rule claims
    wins; otherwise the declared fallback."""
    for filename, funcname in frames:
        z = _classify_frame(filename, funcname)
        if z is not None:
            return z
    return _CLASSIFIER[-1].zone


# ----------------------------------------------------------- no-op timer
class _NoopZone:
    """The disabled-path context manager: one shared instance, no state.
    ``zone(...) is _NOOP_ZONE`` is the asserted zero-overhead guard."""

    __slots__ = ()

    def __enter__(self) -> "_NoopZone":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP_ZONE = _NoopZone()


class _ZoneTimer:
    """One enabled-path timing scope; a fresh instance per ``zone()``
    call so concurrent threads never share a ``t0``."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "Profiler", name: str):
        self._prof = prof
        self._name = name
        self._t0 = 0

    def __enter__(self) -> "_ZoneTimer":
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._prof._zone_ns(self._name, time.monotonic_ns() - self._t0)


# --------------------------------------------------------------- profiler
class Profiler:
    """Process-global profiling plane: sampler thread + exact zone
    accumulators + step compile/dispatch accounting + memory gauges.

    All counters live in one lock-guarded flat dict (the ``_bump`` /
    ``_totals`` pattern every family in ``metrics/registry.py`` uses)
    so the ``profile`` counter family, /metrics exposition and the
    flight recorder's counter-delta events ride for free.
    """

    def __init__(self, role: str, hz: float = 97.0, stacks_max: int = 256):
        self.role = role
        self.hz = float(hz)
        self.stacks_max = int(stacks_max)
        self._lock = threading.Lock()
        self._totals: Dict[str, int] = {}
        self._stacks: Dict[str, int] = {}
        self._ewma_ms: Dict[str, float] = {}
        # label -> [compiles, dispatches] (the snapshot's dispatch.labels)
        self._label_calls: Dict[str, List[int]] = {}
        self._started_s = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ accumulators
    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._totals[key] = self._totals.get(key, 0) + n

    def _zone_ns(self, name: str, ns: int) -> None:
        with self._lock:
            self._totals[f"zone_ns.{name}"] = (
                self._totals.get(f"zone_ns.{name}", 0) + ns)
            self._totals[f"zone_calls.{name}"] = (
                self._totals.get(f"zone_calls.{name}", 0) + 1)

    def note_dispatch(self, zone_name: str, label: str, ns: int,
                      first: bool) -> None:
        """One wrapped step call: first call per wrapper = compile (the
        first launch loads the kernel library), later calls = dispatch."""
        with self._lock:
            calls = self._label_calls.setdefault(label or "step", [0, 0])
            calls[0 if first else 1] += 1
            if first:
                self._totals["compile_count"] = (
                    self._totals.get("compile_count", 0) + 1)
                self._totals["compile_ns"] = (
                    self._totals.get("compile_ns", 0) + ns)
            else:
                self._totals["dispatch_count"] = (
                    self._totals.get("dispatch_count", 0) + 1)
                self._totals["dispatch_ns"] = (
                    self._totals.get("dispatch_ns", 0) + ns)
                self._totals[f"zone_ns.{zone_name}"] = (
                    self._totals.get(f"zone_ns.{zone_name}", 0) + ns)
                self._totals[f"zone_calls.{zone_name}"] = (
                    self._totals.get(f"zone_calls.{zone_name}", 0) + 1)
                ms = ns / 1e6
                prev = self._ewma_ms.get(label or "step")
                self._ewma_ms[label or "step"] = (
                    ms if prev is None
                    else _EWMA_ALPHA * ms + (1.0 - _EWMA_ALPHA) * prev)

    # ----------------------------------------------------------- sampler
    def start(self) -> "Profiler":
        if self.hz > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="prof-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        period = 1.0 / max(self.hz, 1e-3)
        own = threading.get_ident()
        while not self._stop.wait(period):
            try:
                self.sample_once(skip_tid=own)
            except Exception:
                self._bump("sample_errors")

    def sample_once(self, skip_tid: Optional[int] = None) -> int:
        """One sampling pass over every live thread; returns the number
        of stacks sampled (tests drive this directly, hz=0)."""
        frames = sys._current_frames()
        sampled = 0
        for tid, top in frames.items():
            if tid == skip_tid:
                continue
            stack: List[Tuple[str, str]] = []
            f = top
            while f is not None and len(stack) < _STACK_DEPTH:
                code = f.f_code
                stack.append((code.co_filename.replace(os.sep, "/"),
                              code.co_name))
                f = f.f_back
            if not stack:
                continue
            zone_name = classify_stack(stack)
            collapsed = ";".join(
                f"{os.path.basename(fn)}:{func}"
                for fn, func in reversed(stack))
            with self._lock:
                self._totals["samples"] = self._totals.get("samples", 0) + 1
                self._totals[f"samples.{zone_name}"] = (
                    self._totals.get(f"samples.{zone_name}", 0) + 1)
                if collapsed in self._stacks:
                    self._stacks[collapsed] += 1
                elif len(self._stacks) < self.stacks_max:
                    self._stacks[collapsed] = 1
                else:
                    self._totals["stack_overflow"] = (
                        self._totals.get("stack_overflow", 0) + 1)
            sampled += 1
        return sampled

    # ---------------------------------------------------------- readout
    def totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._totals)

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._stacks.clear()
            self._ewma_ms.clear()
            self._label_calls.clear()

    def snapshot(self) -> Dict[str, Any]:
        """The full profile snapshot: what /api/status serves, the
        observer harvests, the flight recorder embeds, and bench arms
        report.  Self-contained (carries its own identity + clock)."""
        with self._lock:
            totals = dict(self._totals)
            stacks = dict(self._stacks)
            ewma = dict(self._ewma_ms)
            labels = {k: {"compile": c, "dispatch": n}
                      for k, (c, n) in self._label_calls.items()}
        samples = totals.get("samples", 0)
        zones: Dict[str, Dict[str, Any]] = {}
        for z in ZONES:
            zs = totals.get(f"samples.{z}", 0)
            zns = totals.get(f"zone_ns.{z}", 0)
            zc = totals.get(f"zone_calls.{z}", 0)
            if not (zs or zns or zc):
                continue
            zones[z] = {
                "samples": zs,
                "share": (zs / samples) if samples else 0.0,
                "ns": zns,
                "calls": zc,
            }
        return {
            "schema": _SCHEMA,
            "role": self.role,
            "pid": os.getpid(),
            "host": _hostname(),
            "hz": self.hz,
            "started_s": self._started_s,
            "dumped_s": time.time(),
            "samples": samples,
            "zones": zones,
            "compile": {
                "count": totals.get("compile_count", 0),
                "ns": totals.get("compile_ns", 0),
            },
            "dispatch": {
                "count": totals.get("dispatch_count", 0),
                "ns": totals.get("dispatch_ns", 0),
                "ewma_ms": ewma,
                "labels": labels,
            },
            "memory": memory_gauges(),
            "stacks": stacks,
            "totals": totals,
        }


def _hostname() -> str:
    try:
        import socket
        return socket.gethostname()
    except Exception:
        return "?"


def _host_rss_bytes() -> int:
    """Resident set size without psutil: /proc on Linux, ru_maxrss
    fallback elsewhere (then it is a high-water, not a gauge)."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        try:
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # Linux reports KiB, macOS bytes; this branch is non-Linux.
            return int(ru)
        except Exception:
            return 0


def memory_gauges() -> Dict[str, Any]:
    """Host RSS always; device stats only if torch is ALREADY imported
    and CUDA is ALREADY initialized in this process (a profiler readout
    must never be the thing that creates a CUDA context).  The current
    device's ``allocated_bytes.all.current`` is ``device_bytes_in_use``
    and its total memory ``device_bytes_limit``."""
    mem: Dict[str, Any] = {"host_rss_bytes": _host_rss_bytes()}
    torchmod = sys.modules.get("torch")
    if torchmod is not None:
        try:
            cuda = torchmod.cuda
            if cuda.is_initialized():
                dev = cuda.current_device()
                st = cuda.memory_stats(dev)
                mem["device_bytes_in_use"] = int(
                    st.get("allocated_bytes.all.current", 0))
                mem["device_bytes_limit"] = int(
                    cuda.get_device_properties(dev).total_memory)
        except Exception:
            pass
    return mem


# ----------------------------------------------- process-global plumbing
_lock = threading.Lock()
_profiler: Optional[Profiler] = None
#: final snapshot captured at uninstall so a post-run flight dump still
#: carries the profile post-mortem.
_last_final: Optional[Dict[str, Any]] = None


def active() -> Optional[Profiler]:
    return _profiler


def zone(name: str) -> Any:
    """Timing scope for one zone: ``with zone("wire.encode"): ...``.
    Disabled -> the shared no-op (identity-asserted zero overhead)."""
    p = _profiler
    if p is None:
        return _NOOP_ZONE
    return _ZoneTimer(p, name)


def zone_ns(name: str, ns: int) -> None:
    """Direct exact-accumulator bump for callers that already hold a
    duration (vectored send paths)."""
    p = _profiler
    if p is not None:
        p._zone_ns(name, ns)


def zoned(name: str) -> Callable[[Callable], Callable]:
    """Decorator form of ``zone()`` for whole-function choke points
    (wiredelta/wirecodec codecs, the PS merge drain).  The disabled
    path is one global read + branch."""
    if name not in ZONES:
        raise ValueError(f"undeclared profile zone {name!r}")

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            p = _profiler
            if p is None:
                return fn(*args, **kwargs)
            t0 = time.monotonic_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                p._zone_ns(name, time.monotonic_ns() - t0)
        return wrapper
    return deco


def wrap_dispatch(fn: Callable, zone_name: str, label: str = "") -> Callable:
    """Wrap one step callable: first call is accounted as
    compile (count + ns), later calls as dispatch (count + ns + the
    zone + a per-label EWMA of step wall time).  Disabled -> returns
    ``fn`` UNCHANGED (the asserted zero-overhead guard), so profiling
    must be enabled before the step factories run -- which it is:
    ``live.start_telemetry_from_conf`` installs at process boot."""
    p = _profiler
    if p is None:
        return fn
    state = {"n": 0}
    # worker threads share one step callable: exactly one call is first
    count_lock = threading.Lock()

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        t0 = time.monotonic_ns()
        out = fn(*args, **kwargs)
        ns = time.monotonic_ns() - t0
        with count_lock:
            first = state["n"] == 0
            state["n"] += 1
        p.note_dispatch(zone_name, label, ns, first)
        return out
    return wrapper


def profile_totals() -> Dict[str, int]:
    """Registry provider (``profile`` counter family)."""
    p = _profiler
    return p.totals() if p is not None else {}


def reset_profile_totals() -> None:
    """Registry reset hook."""
    p = _profiler
    if p is not None:
        p.reset()


def last_snapshot() -> Optional[Dict[str, Any]]:
    """Freshest profile snapshot: live (computed now) while installed,
    the final uninstall snapshot afterwards, None when profiling never
    ran.  The flight recorder embeds this in every dump."""
    p = _profiler
    if p is not None:
        return p.snapshot()
    return _last_final


def install(role: str, hz: float = 97.0, stacks_max: int = 256) -> Profiler:
    """Install (and start) the process-global profiler; idempotent per
    process, same contract as ``flightrec.install``."""
    global _profiler
    with _lock:
        if _profiler is not None:
            return _profiler
        p = Profiler(role, hz=hz, stacks_max=stacks_max)
        _profiler = p
    try:
        from asyncframework_tpu_torch.metrics import live
        live.register_status_section("profile", last_snapshot)
    except Exception:
        pass
    return p.start()


def install_from_conf(role: str) -> Optional[Profiler]:
    """Conf-gated install (``async.prof.enabled=0`` = off, the
    default): the one call every daemon entry point makes, riding
    ``live.start_telemetry_from_conf`` next to the flight recorder."""
    from asyncframework_tpu_torch.conf import (
        PROF_ENABLED,
        PROF_HZ,
        PROF_STACKS,
        global_conf,
    )

    conf = global_conf()
    if not int(conf.get(PROF_ENABLED) or 0):
        return None
    return install(role, hz=float(conf.get(PROF_HZ)),
                   stacks_max=int(conf.get(PROF_STACKS)))


def uninstall() -> Optional[Dict[str, Any]]:
    """Stop and drop the process-global profiler; keeps (and returns)
    its final snapshot so late flight dumps still carry it."""
    global _profiler, _last_final
    with _lock:
        p, _profiler = _profiler, None
    if p is None:
        return None
    p.stop()
    snap = p.snapshot()
    _last_final = snap
    try:
        from asyncframework_tpu_torch.metrics import live
        live.unregister_status_section("profile")
    except Exception:
        pass
    return snap


# ------------------------------------------------------------ CLI readers
def collapsed_lines(snap: Dict[str, Any]) -> List[str]:
    """Flamegraph collapsed-stack lines (``a;b;c count``), stable
    order: count desc then stack.  Feed straight to flamegraph.pl /
    speedscope / inferno."""
    stacks = snap.get("stacks") or {}
    # the collapsed format is space-delimited: frames like
    # "<frozen importlib._bootstrap>:_gcd_import" would split wrong in
    # strict consumers, so spaces inside frame names become underscores
    return [f"{stack.replace(' ', '_')} {count}" for stack, count in
            sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))]


def zone_table(snap: Dict[str, Any]) -> List[Tuple[str, int, float, float, int]]:
    """Rows (zone, samples, share, exact_ms, calls), share desc then
    exact time desc -- the async-prof top view."""
    zones = snap.get("zones") or {}
    rows = []
    for z, d in zones.items():
        rows.append((z, int(d.get("samples", 0)),
                     float(d.get("share", 0.0)),
                     float(d.get("ns", 0)) / 1e6,
                     int(d.get("calls", 0))))
    rows.sort(key=lambda r: (-r[2], -r[3], r[0]))
    return rows


def diff_zones(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Zone-level diff of two snapshots: share/ms deltas plus the
    only-in sets (the codec-on-vs-off acceptance reads ``only_in_a``)."""
    za = a.get("zones") or {}
    zb = b.get("zones") or {}
    out: Dict[str, Any] = {
        "only_in_a": sorted(set(za) - set(zb)),
        "only_in_b": sorted(set(zb) - set(za)),
        "zones": {},
    }
    for z in sorted(set(za) | set(zb)):
        da, db = za.get(z) or {}, zb.get(z) or {}
        out["zones"][z] = {
            "share_a": float(da.get("share", 0.0)),
            "share_b": float(db.get("share", 0.0)),
            "share_delta": float(da.get("share", 0.0))
            - float(db.get("share", 0.0)),
            "ms_a": float(da.get("ns", 0)) / 1e6,
            "ms_b": float(db.get("ns", 0)) / 1e6,
        }
    return out


def _looks_like_snapshot(d: Any) -> bool:
    return isinstance(d, dict) and ("zones" in d or "stacks" in d)


def load_profiles(path: str) -> Dict[str, Dict[str, Any]]:
    """Profile snapshots from any artifact the stack produces, keyed by
    a human label:

    - a raw snapshot JSON (async-prof itself, the observer's
      ``profile/`` files),
    - a flight-recorder dump (``flight-*.json``: the ``profile`` key),
    - a bench output (top-level or per-arm ``profile`` blocks, keyed by
      arm name),
    - a directory: an observer run dir (``profile/*.json``) or a flight
      dump dir.
    """
    out: Dict[str, Dict[str, Any]] = {}
    if os.path.isdir(path):
        profdir = os.path.join(path, "profile")
        scan = profdir if os.path.isdir(profdir) else path
        for fn in sorted(os.listdir(scan)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(scan, fn), "r",
                          encoding="utf-8") as f:
                    d = json.load(f)
            except (OSError, ValueError):
                continue
            if _looks_like_snapshot(d):
                out[fn[:-5]] = d
            elif (isinstance(d, dict)
                  and _looks_like_snapshot(d.get("profile"))):
                out[fn[:-5]] = d["profile"]
        return out
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    if _looks_like_snapshot(d):
        out[os.path.basename(path)] = d
        return out
    if isinstance(d, dict):
        if _looks_like_snapshot(d.get("profile")):
            out[os.path.basename(path)] = d["profile"]
            return out
        arms = d.get("arms")
        if isinstance(arms, dict):
            arms = [dict(v, name=k) for k, v in arms.items()]
        if isinstance(arms, list):
            for i, arm in enumerate(arms):
                if not isinstance(arm, dict):
                    continue
                prof = arm.get("profile")
                if _looks_like_snapshot(prof):
                    out[str(arm.get("name") or arm.get("arm")
                            or arm.get("codec") or i)] = prof
        # bench outputs nest arm records one or two levels deep
        # ({"codec": {"off": {"profile": ...}}}); scan both
        for k, v in d.items():
            if k == "profile" or not isinstance(v, dict):
                continue
            prof = v.get("profile")
            if _looks_like_snapshot(prof):
                out.setdefault(str(k), prof)
                continue
            for k2, v2 in v.items():
                if isinstance(v2, dict) and \
                        _looks_like_snapshot(v2.get("profile")):
                    out.setdefault(f"{k}/{k2}", v2["profile"])
    return out


def _pick(profiles: Dict[str, Dict[str, Any]], arm: Optional[str],
          what: str) -> Dict[str, Any]:
    if arm is not None:
        if arm not in profiles:
            raise SystemExit(
                f"async-prof: no arm {arm!r} in {what} "
                f"(have: {', '.join(sorted(profiles)) or 'none'})")
        return profiles[arm]
    if len(profiles) == 1:
        return next(iter(profiles.values()))
    raise SystemExit(
        f"async-prof: {what} holds {len(profiles)} profiles "
        f"({', '.join(sorted(profiles))}); pick one with --arm/--arm-b")


def _render_table(label: str, snap: Dict[str, Any], out) -> None:
    print(f"== {label}: role={snap.get('role', '?')} "
          f"pid={snap.get('pid', '?')} hz={snap.get('hz', '?')} "
          f"samples={snap.get('samples', 0)}", file=out)
    comp = snap.get("compile") or {}
    disp = snap.get("dispatch") or {}
    print(f"   compile: {comp.get('count', 0)} in "
          f"{float(comp.get('ns', 0)) / 1e6:.1f} ms   dispatch: "
          f"{disp.get('count', 0)} in "
          f"{float(disp.get('ns', 0)) / 1e6:.1f} ms", file=out)
    mem = snap.get("memory") or {}
    if mem:
        dev = mem.get("device_bytes_in_use")
        print(f"   rss: {mem.get('host_rss_bytes', 0) / 2**20:.0f} MiB"
              + (f"   device: {dev / 2**20:.0f} MiB" if dev else ""),
              file=out)
    rows = zone_table(snap)
    if not rows:
        print("   (no zones attributed)", file=out)
        return
    print(f"   {'zone':<16} {'share':>7} {'samples':>8} "
          f"{'exact ms':>10} {'calls':>8}", file=out)
    for z, samples, share, ms, calls in rows:
        print(f"   {z:<16} {share * 100:>6.1f}% {samples:>8} "
              f"{ms:>10.2f} {calls:>8}", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    """async-prof (``python -m asyncframework_tpu_torch.metrics.profiler``):
    top-zone tables, flamegraph collapsed stacks,
    and run/arm diffs over any profile-carrying artifact."""
    import argparse

    p = argparse.ArgumentParser(
        prog="async-prof",
        description="Render continuous-profiling snapshots: top-zone "
                    "tables, flamegraph-compatible collapsed stacks, "
                    "and diffs between two runs or bench arms.")
    p.add_argument("source", help="profile snapshot JSON, flight dump, "
                                  "bench output, or observer run dir")
    p.add_argument("source_b", nargs="?", default=None,
                   help="second source (with --diff)")
    p.add_argument("--arm", default=None,
                   help="arm/profile label to pick from a multi-profile "
                        "source")
    p.add_argument("--arm-b", default=None,
                   help="arm/profile label for the second source "
                        "(--diff; defaults to --arm)")
    p.add_argument("--collapsed", action="store_true",
                   help="emit flamegraph collapsed-stack lines instead "
                        "of the zone table")
    p.add_argument("--diff", action="store_true",
                   help="diff two sources (or two arms of one source)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    args = p.parse_args(argv)
    out = sys.stdout

    profiles = load_profiles(args.source)
    if not profiles:
        print(f"async-prof: no profile snapshots in {args.source}",
              file=sys.stderr)
        return 2

    if args.diff:
        if args.source_b is not None:
            profiles_b = load_profiles(args.source_b)
            if not profiles_b:
                print(f"async-prof: no profile snapshots in "
                      f"{args.source_b}", file=sys.stderr)
                return 2
        else:
            profiles_b = profiles
            if args.arm is None or (args.arm_b or args.arm) == args.arm:
                print("async-prof: --diff over one source needs --arm "
                      "and --arm-b", file=sys.stderr)
                return 2
        a = _pick(profiles, args.arm, args.source)
        b = _pick(profiles_b, args.arm_b or args.arm,
                  args.source_b or args.source)
        d = diff_zones(a, b)
        if args.json:
            json.dump(d, out, indent=2, sort_keys=True)
            out.write("\n")
            return 0
        for z in d["only_in_a"]:
            print(f"only in A: {z} "
                  f"(share {d['zones'][z]['share_a'] * 100:.1f}%, "
                  f"{d['zones'][z]['ms_a']:.2f} ms)", file=out)
        for z in d["only_in_b"]:
            print(f"only in B: {z} "
                  f"(share {d['zones'][z]['share_b'] * 100:.1f}%, "
                  f"{d['zones'][z]['ms_b']:.2f} ms)", file=out)
        print(f"   {'zone':<16} {'share A':>8} {'share B':>8} "
              f"{'delta':>8} {'ms A':>10} {'ms B':>10}", file=out)
        for z, row in sorted(d["zones"].items(),
                             key=lambda kv: -abs(kv[1]["share_delta"])):
            print(f"   {z:<16} {row['share_a'] * 100:>7.1f}% "
                  f"{row['share_b'] * 100:>7.1f}% "
                  f"{row['share_delta'] * 100:>+7.1f}% "
                  f"{row['ms_a']:>10.2f} {row['ms_b']:>10.2f}", file=out)
        return 0

    snap = _pick(profiles, args.arm, args.source)
    if args.collapsed:
        for line in collapsed_lines(snap):
            print(line, file=out)
        return 0
    if args.json:
        json.dump(snap, out, indent=2, sort_keys=True)
        out.write("\n")
        return 0
    label = args.arm or next(iter(profiles))
    _render_table(label, snap, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

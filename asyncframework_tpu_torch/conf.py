"""Typed configuration system.

Parity: the reference has two layers -- a string k/v ``SparkConf`` and a typed
``ConfigEntry``/``ConfigBuilder`` registry (``core/.../internal/config/
package.scala:26``) with precedence CLI > conf file > defaults.  This module
provides both: :class:`ConfigEntry` (typed, documented, defaulted, registered)
and :class:`AsyncConf` (k/v store with env-var and dict overlays).

A copy of the JAX package's ``conf.py`` holding the entries of the DCN
plane that this package reads; the solvers take their knobs from
``SolverConfig``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: Dict[str, "ConfigEntry"] = {}


@dataclass(frozen=True)
class ConfigEntry(Generic[T]):
    """A typed, registered configuration key.

    ``tunable=True`` marks a knob the adaptive controller
    (``parallel/controller.py``) is allowed to actuate at runtime; a
    tunable MUST declare ``floor`` and ``ceiling`` -- the hard bounds
    every controller decision is clamped to (async-lint's
    ``conf-tunable`` rule enforces both directions: a tunable without
    bounds, or a controller actuation of a non-tunable key, fails the
    lint).  For ``async.step.size`` the bounds apply to the step-DAMP
    multiplier (the controller scales the effective step, never the
    configured gamma itself)."""

    key: str
    default: T
    value_type: Callable[[str], T]
    doc: str = ""
    tunable: bool = False
    floor: Optional[float] = None
    ceiling: Optional[float] = None

    def __post_init__(self):
        _REGISTRY[self.key] = self

    def from_string(self, s: str) -> T:
        if self.value_type is bool:
            return s.strip().lower() in ("1", "true", "yes", "on")  # type: ignore
        return self.value_type(s)


def registry() -> Dict[str, ConfigEntry]:
    return dict(_REGISTRY)


_GLOBAL_CONF: Optional["AsyncConf"] = None


def set_global_conf(conf: Optional["AsyncConf"]) -> None:
    """Install the process's effective configuration (the CLI does this
    with its --conf overlays) so components constructed without an explicit
    conf -- e.g. receivers resolving backpressure defaults -- see the same
    values the run was submitted with."""
    global _GLOBAL_CONF
    _GLOBAL_CONF = conf


def global_conf() -> "AsyncConf":
    """The installed process conf; created AND INSTALLED on first use.

    The lazily-created default is installed (not discarded): before this,
    ``global_conf().set(...)`` on a process that never called
    :func:`set_global_conf` silently mutated a throwaway instance and the
    next ``global_conf()`` call returned a fresh one -- the classic
    lost-write footgun.  Now the first call pins the instance, so sets
    stick regardless of whether the CLI installed overlays first."""
    global _GLOBAL_CONF
    if _GLOBAL_CONF is None:
        _GLOBAL_CONF = AsyncConf()
    return _GLOBAL_CONF


class AsyncConf:
    """String/typed k/v configuration with precedence: explicit set > env
    (``ASYNCTPU_<KEY_UPPER_WITH_UNDERSCORES>``) > registered default."""

    ENV_PREFIX = "ASYNCTPU_"

    def __init__(self, initial: Optional[Dict[str, Any]] = None):
        self._store: Dict[str, Any] = {}
        if initial:
            self._store.update(initial)

    def set(self, key: str, value: Any) -> "AsyncConf":
        self._store[key] = value
        return self

    def set_all(self, kv: Dict[str, Any]) -> "AsyncConf":
        self._store.update(kv)
        return self

    def contains(self, key: str) -> bool:
        return key in self._store or self._env_name(key) in os.environ

    def _env_name(self, key: str) -> str:
        return self.ENV_PREFIX + key.upper().replace(".", "_")

    def get(self, entry_or_key, default: Any = None) -> Any:
        if isinstance(entry_or_key, ConfigEntry):
            entry = entry_or_key
            if entry.key in self._store:
                v = self._store[entry.key]
                return entry.from_string(v) if isinstance(v, str) else v
            env = os.environ.get(self._env_name(entry.key))
            if env is not None:
                return entry.from_string(env)
            return entry.default
        key = entry_or_key
        entry = _REGISTRY.get(key)
        if key in self._store:
            v = self._store[key]
            if entry is not None and isinstance(v, str):
                return entry.from_string(v)
            return v
        env = os.environ.get(self._env_name(key))
        if env is not None:
            return entry.from_string(env) if entry is not None else env
        if entry is not None:
            return entry.default
        return default

    def to_dict(self) -> Dict[str, Any]:
        d = {k: e.default for k, e in _REGISTRY.items()}
        d.update(self._store)
        return d

    def __repr__(self) -> str:  # pragma: no cover
        return f"AsyncConf({self._store!r})"


# --------------------------------------------------------------------------
# Registered entries: the engine knobs and the reference's 13 driver args
# (the submit CLI's --conf table, cli.py::CONF_TO_FIELD), and the knobs of
# the DCN plane and of the telemetry plane, each a copy of the JAX
# package's entry.
# --------------------------------------------------------------------------
NUM_WORKERS = ConfigEntry("async.num.workers", 8, int, "Logical workers (device slots).")
NUM_ITERATIONS = ConfigEntry("async.num.iterations", 1000, int, "Total accepted updates.")
TAW = ConfigEntry("async.taw", 2**31 - 1, int, "Staleness bound tau.")
BATCH_RATE = ConfigEntry("async.batch.rate", 0.1, float, "Per-round Bernoulli sample rate b.")
PRINTER_FREQ = ConfigEntry("async.printer.freq", 100, int, "Trajectory snapshot period.")
DELAY_COEFF = ConfigEntry("async.delay.coeff", 0.0, float,
                          "Straggler delay intensity; -1 = cloud long-tail model.")
SEED = ConfigEntry("async.seed", 42, int, "Root PRNG seed.")
MODEL_VERSIONS = ConfigEntry("async.broadcast.versions", 4, int,
                             "Model versions kept live in the versioned store "
                             "(SolverConfig.max_live_versions).")
DRAIN_BATCH = ConfigEntry("async.drain.batch", 1, int,
                          "Queued gradients folded into one device dispatch.")
SPECULATION_QUANTILE = ConfigEntry(
    "async.speculation.quantile", 0.75, float,
    "Fraction of tasks that must finish before speculating.")
SPECULATION_MULTIPLIER = ConfigEntry(
    "async.speculation.multiplier", 1.5, float,
    "Running task speculated past multiplier * median duration.")
SPECULATION_MIN_MS = ConfigEntry(
    "async.speculation.min.ms", 100.0, float,
    "Never speculate tasks younger than this.")
ALLOCATION_MAX_EXTRA = ConfigEntry(
    "async.allocation.max.extra", 1, int,
    "Max sibling executors added per slot by dynamic allocation.")
ALLOCATION_BACKLOG = ConfigEntry(
    "async.allocation.backlog.threshold", 2, int,
    "Queued tasks per slot that trigger a sibling (sustained).")
ALLOCATION_IDLE_S = ConfigEntry(
    "async.allocation.idle.timeout.s", 1.0, float,
    "Idle seconds before a sibling executor retires.")
HEARTBEAT_TIMEOUT_MS = ConfigEntry(
    "async.heartbeat.timeout.ms", 2000.0, float,
    "Solver-run heartbeat timeout (ms), see SolverConfig.")
MAX_SLOT_FAILURES = ConfigEntry(
    "async.max.slot.failures", 2, int,
    "Repeated executor deaths on a slot before its shard re-homes.")
SHUFFLE_SPILL_BYTES = ConfigEntry(
    "async.shuffle.spill.bytes", 256 * 1024 * 1024, int,
    "Driver-side shuffle routing buffer bound; past it routed entries "
    "spill to disk runs (0 = unbounded) -- "
    "SortShuffleManager/UnifiedMemoryManager role.")
SHUFFLE_DATA_PLANE = ConfigEntry(
    "async.shuffle.data.plane", "auto", str,
    "Array-pair reduce_by_key route: 'device' (one sort and segment reduce "
    "on the partitions' device), 'host' (vectorized numpy sort/bincount), "
    "or 'auto' -- device for CUDA tensors, host otherwise (see "
    "ops/shuffle.py).")
# ------------------------------------------------------- controller tunables
# The two engine knobs the adaptive controller actuates besides the DCN
# plane's (parallel/controller.py): declared with their hard bounds.
STEP_SIZE = ConfigEntry("async.step.size", 0.1, float, "Base step size gamma.",
                        # tunable: the controller's per-push delay-adaptive
                        # DAMP multiplier is clamped to [floor, ceiling] --
                        # it scales the effective step, never gamma itself
                        tunable=True, floor=0.05, ceiling=1.0)
BUCKET_RATIO = ConfigEntry("async.bucket.ratio", 0.5, float,
                           "Cohort availability threshold.",
                           # tunable: the controller re-clamps the partial-
                           # barrier cohort between floor*P (never solo
                           # unless P=1) and ceiling*P (the configured b is
                           # its own upper bound when smaller)
                           tunable=True, floor=0.125, ceiling=1.0)
# ------------------------------------------------------------- net plane
# The shared robustness layer (net/retry.py, net/session.py, net/faults.py):
# every DCN client (PS workers, remote topics, deploy daemons) resolves its
# retry policy from these, and every server sizes its dedup window from
# them -- one set of knobs for the whole control + data plane.
NET_RETRY_MAX_ATTEMPTS = ConfigEntry(
    "async.net.retry.max.attempts", 5, int,
    "Attempts per logical op before the retry layer gives up.")
NET_RETRY_BASE_MS = ConfigEntry(
    "async.net.retry.base.ms", 50.0, float,
    "Backoff floor (decorrelated jitter draws start here).")
NET_RETRY_MAX_MS = ConfigEntry(
    "async.net.retry.max.ms", 2000.0, float,
    "Backoff cap per sleep.")
NET_RETRY_ATTEMPT_TIMEOUT_S = ConfigEntry(
    "async.net.retry.attempt.timeout.s", 120.0, float,
    "Per-attempt socket timeout clients apply to their connections.")
NET_RETRY_DEADLINE_S = ConfigEntry(
    "async.net.retry.deadline.s", 0.0, float,
    "Overall deadline across attempts (0 = attempts bound alone).")
NET_BREAKER_THRESHOLD = ConfigEntry(
    "async.net.breaker.threshold", 5, int,
    "Consecutive failures that open an endpoint's circuit breaker.")
NET_BREAKER_COOLDOWN_S = ConfigEntry(
    "async.net.breaker.cooldown.s", 1.0, float,
    "Open-state fail-fast window before the half-open probe.")
NET_DEDUP_WINDOW = ConfigEntry(
    "async.net.dedup.window", 128, int,
    "Applied (sid, seq) ops each server remembers per client session "
    "(exactly-once-applied retry dedup).")
NET_FAULT_SCHEDULE = ConfigEntry(
    "async.net.fault.schedule", "", str,
    "Deterministic fault schedule as inline JSON or @/path/to/file "
    "(net/faults.py); empty = injection off.")
NET_FAULT_SEED = ConfigEntry(
    "async.net.fault.seed", 0, int,
    "Seed chaos runs hand to retry policies so backoff walks replay.")
# ------------------------------------------------------------- data plane
# The DCN throughput knobs (net/wiredelta.py + parallel/ps_dcn.py): PULL
# reply negotiation and the PS-side fused gradient apply.
PULL_MODE = ConfigEntry(
    "async.pull.mode", "full", str,
    "PULL reply negotiation: 'full' ships the whole model every pull "
    "(byte-identical legacy wire, the safe default); 'delta' sends "
    "have=<ts> so the PS can answer NOT_MODIFIED (zero payload), a "
    "byte-exact XOR sparse delta, or the full model -- whichever is "
    "smallest.  Decode mismatch or cache miss falls back to a full pull.")
PULL_DELTA_VERSIONS = ConfigEntry(
    "async.pull.delta.versions", 4, int,
    "Recent model versions the PS keeps host-side for delta encoding "
    "(un-overridden, the PS auto-scales this to 4*num_workers+2 -- a "
    "worker's basis is ~P versions old by its next pull); oldest "
    "versions evict first, and the cache is only maintained once a "
    "delta client shows up.  0 disables the cache: delta-mode pulls are "
    "answered NOT_MODIFIED on an exact-version match (needs no cache) "
    "or full otherwise.")
PS_SHARDS = ConfigEntry(
    "async.ps.shards", 1, int,
    "Parameter-server shard processes the launcher provisions "
    "(parallel/shardgroup.py): the model is range-partitioned across "
    "this many ParameterServer processes behind a shard map workers "
    "resolve at HELLO.  A PULL becomes per-shard parallel sub-pulls "
    "(each reusing the have= NM/XDELTA/FULL negotiation and CRC "
    "gating), a PUSH fans out per-shard rows under per-shard (sid, "
    "seq) exactly-once sessions, and the staleness contract becomes a "
    "per-shard version vector.  Shard 0 (the primary) keeps the wave "
    "gate, the elastic supervisor, and the eval plane; secondaries "
    "serve their ranges ungated.  1 (the default) is the classic "
    "single-PS path, byte- and step-identical.")
PS_STANDBY = ConfigEntry(
    "async.ps.standby", 0, int,
    "Warm standby processes per PS shard (parallel/replication.py): 1 "
    "provisions one standby child behind every shard primary; the "
    "primary streams accepted merge batches to it (REPL_SYNC bootstrap "
    "+ REPL_APPEND per drained batch -- post-dedup, with each item's "
    "(sid, seq) stamp and verdict, stamped with the primary's merge "
    "clock and fencing epoch), and on lease expiry the ShardGroup "
    "controller PROMOTEs the standby under the next fencing epoch "
    "instead of relaunching from checkpoint -- failover is bounded by "
    "suspicion time, not checkpoint replay, and the deposed primary's "
    "writes are REJECT_FENCED.  Standbys double as read replicas "
    "(SUBSCRIBE / relaycast roots) with staleness priced by their "
    "replication lag (ps.standby_lag series, standby_lag SLO rule).  "
    "0 (the default) keeps the classic restart-from-checkpoint "
    "recovery.  Promotion additionally requires async.fence.enabled "
    "and shards >= 2 (a map to re-announce the moved endpoint "
    "through); otherwise a standby is a warm read replica only.")
PUSH_MERGE = ConfigEntry(
    "async.push.merge", 8, int,
    "Upper bound on PUSHes the PS coalesces into one fused device apply "
    "when the model lock is contended (bit-identical to the serial apply "
    "order; 1 = classic one-dispatch-per-push path).",
    # tunable: the controller resizes the EFFECTIVE budget within
    # [floor, min(ceiling, configured value)] -- the fused kernel
    # compiles once at the configured bound, so the ceiling can never
    # grow a compiled shape
    tunable=True, floor=1, ceiling=64)
PIPELINE_DEPTH = ConfigEntry(
    "async.pipeline.depth", 0, int,
    "DCN worker update-loop pipelining: 0 = the classic serial "
    "pull -> compute -> push loop (byte- and step-identical legacy "
    "behavior); >= 1 = a prefetch thread on a second PS connection pulls "
    "model v(k+1) while step k computes, and pushes are handed to a "
    "bounded in-flight sender (at most this many unacknowledged pushes) "
    "so the next compute starts before the push ACK returns.  Gradient "
    "staleness stays bounded: the PS's taw admission prices the extra "
    "in-flight steps, and a taw rejection makes the worker discard its "
    "prefetched model and re-pull fresh.  ASAGA ignores this (its "
    "PS-side sampling requires strict pull->push alternation per "
    "worker).",
    # tunable: with pipelining ON the controller auto-sizes the live
    # in-flight window within [floor, min(ceiling, configured depth)]
    # from measured pull RTT vs compute time; it never flips 0 <-> >=1
    # (the loop SHAPE is chosen at worker start)
    tunable=True, floor=1, ceiling=8)
MESH_DEVICES = ConfigEntry(
    "async.mesh.devices", 0, int,
    "Devices in each DCN worker's LOCAL compute mesh (parallel/mesh.py): "
    "0 = the classic single-device gradient step (byte- and step-"
    "identical legacy behavior); >= 2 = the worker computes each "
    "mini-batch gradient batch-parallel over a dp mesh of this many "
    "chips -- its shard rows are padded+sharded into HBM once at loop "
    "start (ops/steps.make_mesh_asgd_worker_step / "
    "make_mesh_saga_dcn_worker_step), per-device partial gradients "
    "lax.psum-reduce locally, and the worker still emits ONE fused "
    "gradient per step (wire protocol unchanged).  A value beyond the "
    "rig's device count clamps (logged); a clamped value below 2, or a "
    "sparse (padded-ELL) shard, degrades to the serial single-device "
    "path instead of crashing the worker daemon.")
DEBUG_LOCKWATCH = ConfigEntry(
    "async.debug.lockwatch", False, bool,
    "Debug lock watchdog (net/lockwatch.py): the PS model lock becomes a "
    "watched lock -- any socket send/recv attempted while it is held "
    "raises AssertionError, and hold counts / max hold time are reported "
    "in the live UI.  Enabled for the chaos suite and bin/chaos_sweep.py "
    "so the lock-free PULL-serving claim is continuously checked; off by "
    "default (zero hot-path cost).")
# ------------------------------------------------------------- codec plane
# Wire-compression codecs (net/wirecodec.py): quantized gradient pushes
# with per-worker error feedback, and lossless compression of snapshot
# deltas on the relaycast distribution plane.
CODEC_PUSH = ConfigEntry(
    "async.codec.push", "off", str,
    "Gradient PUSH quantization (net/wirecodec.py): 'off' (the default) "
    "ships raw f32 -- byte-identical legacy wire; 'fp16' halves and "
    "'int8' (per-push max-abs scale) quarters the dense gradient bytes, "
    "with the quantization residual kept in a per-worker error-feedback "
    "accumulator and folded into the next push, so the model's deviation "
    "from the uncompressed trajectory stays bounded by ONE step's "
    "quantization error.  Non-finite gradients, fp16-overflowing "
    "magnitudes, sparse-encoded pushes, and ASAGA (exact history "
    "scalars) always fall back to the raw wire.")
# ------------------------------------------------------------ native plane
# Native hot-path data plane (native/wiredelta.cc, native/wirecodec.cc,
# native/shmring.cc behind native_build.py): GIL-free C++ twins of the
# pure-Python wire codecs, plus a shared-memory ring transport for
# colocated roles.  Both default OFF = byte-identical legacy wire; the
# async-cluster launcher flips them on.
NATIVE_ENABLED = ConfigEntry(
    "async.native.enabled", False, bool,
    "Route the wire hot paths (XOR delta encode/decode + CRC32 in "
    "net/wiredelta.py, int8/fp16 quantize + byte-shuffle + delta-index "
    "transform in net/wirecodec.py, the frame pump's gather copy in "
    "net/frame.py) through the ctypes-loaded C++ extensions, releasing "
    "the GIL for the whole pass.  Every native entry point has a "
    "registered pure-Python bit-identity oracle (the pre-native "
    "implementation) and silently degrades to it when no toolchain is "
    "present -- the wire is byte-identical either way, only the "
    "interpreter time changes (metrics family 'native' says which path "
    "actually ran).  Off by default.")
SHM_ENABLED = ConfigEntry(
    "async.shm.enabled", False, bool,
    "Shared-memory ring transport for COLOCATED roles (net/shmring.py): "
    "after the normal TCP dial, a loopback connection is upgraded via "
    "an SHM_OPEN handshake to a pair of lock-free SPSC rings in "
    "/dev/shm, and REPL_APPEND / SUBSCRIBE frames move through them "
    "instead of the loopback socket.  The framed BYTES are identical "
    "and still pass the net/frame.py choke point (CRC, fencing, dedup, "
    "byte counters, fault injection all unchanged); only the kernel "
    "socket hop is bypassed.  Any ring failure (peer death, handshake "
    "refusal) degrades to the plain socket path.  Off by default = "
    "byte-identical legacy transport.")
SHM_RING_KB = ConfigEntry(
    "async.shm.ring.kb", 4096, int,
    "Per-direction shared-memory ring capacity in KiB (net/shmring.py). "
    "A frame larger than the ring falls back to chunked writes; sizing "
    "the ring to a few model payloads keeps the writer from ever "
    "spinning on a healthy reader.",
    tunable=True, floor=64, ceiling=262144)
# ------------------------------------------------------------- relay plane
# Relaycast (asyncframework_tpu_torch/relaycast/): peer-relayed versioned model
# distribution -- replicas form a k-ary tree rooted at the PS, the root's
# direct children SUBSCRIBE as usual, and every deeper node RELAY_FETCHes
# CRC-gated XOR deltas from its parent and re-serves them to its own
# children, so PS egress per version is O(fanout), not O(replicas).
RELAY_FANOUT = ConfigEntry(
    "async.relay.fanout", 2, int,
    "Children per node in the relaycast distribution tree (the PS root "
    "included: it accepts at most this many relay-child registrations "
    "for its RELAY_OFFER push path; k8s/CLI tree plans use the same "
    "arity).  Tree depth is log_fanout(replicas).")
RELAY_COMPRESS = ConfigEntry(
    "async.relay.compress", True, bool,
    "Lossless zlib compression of relay-hop model payloads "
    "(net/wirecodec.py): XOR deltas of a training step compress "
    "severalfold (agreeing sign/exponent bits, ascending index half); "
    "losslessness keeps the CRC gate exact.  On by default -- the relay "
    "plane is new wire with no byte-identity legacy to preserve; "
    "payloads that would not shrink ship raw automatically.")
RELAY_VERSIONS = ConfigEntry(
    "async.relay.versions", 8, int,
    "Recent model versions a relay node keeps for delta-encoding "
    "children's RELAY_FETCH have= requests (oldest evict first; a "
    "missing basis answers full, exactly like the PS delta cache).")
RELAY_PARENT_RETRY_S = ConfigEntry(
    "async.relay.parent.retry.s", 5.0, float,
    "After a relay parent fails (dead, fenced, CRC mismatch) the child "
    "re-homes to the ROOT (direct SUBSCRIBE -- the always-safe path) "
    "and only re-tries its parent after this many seconds, so a "
    "flapping interior node cannot oscillate the subtree.")
# ---------------------------------------------------------- elastic plane
# The process-level membership supervisor (parallel/supervisor.py): worker
# death detection, shard adoption, rejoin, degraded-cohort clamping for
# the multi-process DCN training path.
ELASTIC_ENABLED = ConfigEntry(
    "async.elastic.enabled", True, bool,
    "Run the DCN parameter server with the elastic membership supervisor "
    "(worker-death detection + shard adoption + rejoin).")
ELASTIC_DEAD_AFTER_S = ConfigEntry(
    "async.elastic.dead.after.s", 5.0, float,
    "Silence past this declares a worker dead (local process exit is "
    "detected immediately via its registered pid).")
ELASTIC_CHECK_INTERVAL_S = ConfigEntry(
    "async.elastic.check.interval.s", 0.5, float,
    "Supervisor monitor scan period.")
ELASTIC_BOOT_GRACE_S = ConfigEntry(
    "async.elastic.boot.grace.s", 10.0, float,
    "Never-contacted shards are not handed out for adoption before this "
    "much run time has passed (covers slow worker bring-up/compile).")
# ---------------------------------------------------------- fencing plane
# Partition-tolerant membership (parallel/supervisor.py, parallel/ps_dcn.py,
# parallel/shardgroup.py): time-bounded leases granted at HELLO and renewed
# on any op, a SUSPECT state between live and dead, and monotonic fencing
# epochs minted per member so a partitioned-but-alive zombie can never
# mutate or serve a range it no longer owns (servers answer REJECT_FENCED
# to stale-epoch ops).
FENCE_ENABLED = ConfigEntry(
    "async.fence.enabled", False, bool,
    "Epoch fencing for the PS plane: servers mint a monotonic fencing "
    "epoch (persisted in their checkpoints, bumped every incarnation and "
    "every lease-expiry failover), clients stamp it on every "
    "PULL/PUSH/SUBSCRIBE (ep header), and a server rejects ops whose "
    "epoch is not current (REJECT_FENCED) -- so a zombie shard behind a "
    "healed partition, or a deposed worker replaying its buffered "
    "pushes, can never double-apply against the replacement's state.  "
    "Off (the default) the wire is byte-identical legacy (no ep keys, "
    "epoch 0 everywhere); async-cluster flips it on.")
LEASE_S = ConfigEntry(
    "async.lease.s", 0.0, float,
    "Membership lease duration: granted at HELLO, renewed by any op; a "
    "member whose lease expires is declared dead and (with fencing on) "
    "its replacement is launched under a bumped fencing epoch.  0 (the "
    "default) aliases async.elastic.dead.after.s -- the lease IS the "
    "silence bound, named for what it grants.")
SUSPECT_AFTER_S = ConfigEntry(
    "async.suspect.after.s", 0.0, float,
    "Silence past this marks a member SUSPECT (surfaced in membership, "
    "metrics, and routing demotion) without declaring death -- the "
    "partition-tolerant middle state between live and dead.  0 (the "
    "default) = half the lease.")
GRAY_RTT_FACTOR = ConfigEntry(
    "async.gray.rtt.factor", 3.0, float,
    "Gray-failure detection (net/health.py): an endpoint whose op-RTT "
    "EWMA exceeds this multiple of the cohort median (and the floor "
    "below) is latency-SUSPECT -- slow-but-alive members are demoted in "
    "routing and surfaced in membership without being declared dead.")
GRAY_RTT_MIN_MS = ConfigEntry(
    "async.gray.rtt.min.ms", 50.0, float,
    "Gray-failure RTT floor: an endpoint is never latency-suspected "
    "while its EWMA is under this many ms (micro-jitter on a fast local "
    "cohort is not a gray failure).")
# ----------------------------------------------------------- serving plane
# The read path (asyncframework_tpu_torch/serving/): ModelReplica processes
# subscribe to the PS's versioned snapshots (SUBSCRIBE = a wave-gate-free
# delta-negotiated pull) and answer PREDICT RPCs while training runs; a
# ServingFrontend round-robins client requests over registered replicas
# with retry/circuit-breaker failover.
SERVE_REFRESH_S = ConfigEntry(
    "async.serve.refresh.interval.s", 0.05, float,
    "Replica background refresh period: how often a ModelReplica sends a "
    "SUBSCRIBE (delta-mode have= pull, CRC-gated, full-pull fallback) to "
    "the PS.  Bounds the replica's freshness lag when training is "
    "advancing the model.")
SERVE_MAX_STALE_MS = ConfigEntry(
    "async.serve.max.staleness.ms", 2000.0, float,
    "A replica whose last SUCCESSFUL refresh is older than this marks "
    "itself unhealthy: PREDICT is answered UNHEALTHY (the frontend fails "
    "over) until a refresh lands again.  0 disables the health gate -- "
    "the replica serves its last model forever (bounded-staleness reads "
    "degrade to eventual consistency).")
SERVE_REPLICAS = ConfigEntry(
    "async.serve.replicas", 2, int,
    "Replica count launchers (bench --serve, k8s manifests) provision.")
SERVE_MAX_REPLICAS = ConfigEntry(
    "async.serve.max.replicas", 16, int,
    "Registration slots a ServingFrontend allocates (the ElasticSupervisor "
    "membership table is sized once).")
SERVE_DEADLINE_S = ConfigEntry(
    "async.serve.failover.deadline.s", 2.0, float,
    "Frontend per-request budget across failover attempts: a PREDICT that "
    "cannot be answered by ANY healthy replica within this raises "
    "PredictError to the caller.")
CONV_SAMPLE = ConfigEntry(
    "async.convergence.sample", 0, int,
    "Worker-side convergence sampling: every Nth update per logical "
    "worker computes its shard's mean loss (one extra jitted eval) and "
    "the gradient norm, and piggybacks (version, loss, grad_norm) on "
    "the next PUSH header (cv entry) for the PS to fold into the "
    "loss-vs-wallclock / loss-vs-version curves.  0 = off (the default: "
    "the piggyback adds header bytes, and byte-identity suites compare "
    "exact wires); async-cluster flips it to 16.")
# ------------------------------------------------------------- tracing
TRACE_SAMPLE = ConfigEntry(
    "async.trace.sample", 1.0 / 64.0, float,
    "Per-update trace sampling rate (1 = every update, 0 = tracing off; "
    "counter-based per worker, so the first update is always sampled when "
    "> 0 and runs of any length yield >= 1 trace).  This default governs "
    "the DCN plane (PSClient/ParameterServer), whose stages are network-"
    "dominated; the in-process engine traces only on explicit opt-in "
    "(SolverConfig.trace_sample / --trace-sample) because its updater "
    "thread is itself the measured hot path.")
TRACE_BUFFER = ConfigEntry(
    "async.trace.buffer", 512, int,
    "Completed-span ring-buffer capacity per worker process (bounded, "
    "lock-light; oldest spans dropped, counted).")
# ------------------------------------------------------------- live UI
UI_PORT = ConfigEntry("async.ui.port", -1, int,
                      "Live dashboard HTTP port (0 = ephemeral, -1 = off) "
                      "-- spark.ui.port analog.")
# --------------------------------------------------------- telemetry plane
# Continuous telemetry (metrics/timeseries.py, metrics/prom.py,
# metrics/slo.py): every process samples its counter families into a
# bounded time-series store, exposes Prometheus text exposition on
# /metrics, folds convergence samples into loss-vs-wallclock /
# loss-vs-version curves, and evaluates declarative SLO rules over
# time-series windows.
METRICS_PORT = ConfigEntry(
    "async.metrics.port", -1, int,
    "Per-process telemetry HTTP port serving /metrics (Prometheus text "
    "exposition) and /api/status (-1 = off, 0 = ephemeral).  Processes "
    "that already serve a live UI (async.ui.port) expose /metrics there "
    "too; this knob adds the endpoint to processes with no dashboard -- "
    "workers, serving replicas, frontends, the master.  k8s manifests "
    "set it to 9095 via env and annotate pods for scraping.")
METRICS_INTERVAL_S = ConfigEntry(
    "async.metrics.interval.s", 1.0, float,
    "Telemetry sampler period: every tick records each counter family "
    "and derived source into the bounded time-series store and runs one "
    "SLO evaluation pass.  <= 0 disables sampling (the /metrics "
    "exposition still serves instantaneous values).")
METRICS_RETENTION = ConfigEntry(
    "async.metrics.retention", 512, int,
    "Samples retained per time series (bounded ring; oldest evict "
    "first, counted).  At the default 1 s interval this is ~8.5 min of "
    "history per series; RAM is O(series x retention) small floats.")
SLO_RULES = ConfigEntry(
    "async.slo.rules",
    "serve_freshness: p95(serving.freshness_lag_ms) < 2000 over 15s "
    "for 2s; "
    "predict_p99: max(serving.predict_ms_p99) < 500 over 30s for 5s; "
    "staleness_ms: max(trace.staleness_ms_p95) < 60000 over 30s for 5s; "
    "updates_floor: rate(ps.accepted) > 0.5 over 30s for 10s "
    "unless ps.done; "
    "shard_availability: max(ps_shards.dark_ranges) < 1 over 15s "
    "for 3s unless ps_shards.done; "
    "standby_lag: max(ps.standby_lag) < 512 over 15s for 5s "
    "unless ps.done; "
    "fenced_writes: rate(recovery.fenced_rejects) < 1 over 30s for 10s; "
    "controller_converged: rate(control.changes) < 0.5 over 20s for 5s "
    "unless observer.fleet_done; "
    "fleet_stragglers: max(observer.straggler_score) < 2.5 over 30s "
    "for 10s unless observer.fleet_done; "
    "fleet_freshness: max(observer.freshness_lag_ms) < 5000 over 30s "
    "for 5s unless observer.fleet_done; "
    "fleet_roles: max(observer.roles_down) < 1 over 30s for 10s "
    "unless observer.fleet_done",
    str,
    "Declarative SLO rule set (metrics/slo.py grammar: '<name>: "
    "<agg>(<series>) <op> <threshold> [over Ns] [for Ns] "
    "[unless <series>]', clauses ';'-separated; 'unless' gates a rule "
    "to no_data while its series' last sample is truthy -- the "
    "updates/s floor stands down once the run is DONE instead of "
    "firing forever on a finished-but-still-serving PS).  Evaluated "
    "over time-series windows each sampler "
    "tick; rule states (ok/pending/firing/no_data, with burn "
    "durations) surface as the /api/status 'health' section and the "
    "async_slo_state gauges on /metrics.  Rules whose series never "
    "produce samples report no_data and never fire.")
# -------------------------------------------------------- cluster observer
# Central collector (metrics/observer.py + bin/async-mon): discovers every
# role, scrapes /api/status + /metrics over the net/ retry plane, persists
# a durable per-run per-role history store, derives cross-role signals
# (straggler scores, merge-queue pressure, fleet freshness) as the
# ``observer.*`` series the fleet SLO rules watch, and harvests crash
# flight-recorder dumps.
OBSERVER_INTERVAL_S = ConfigEntry(
    "async.observer.interval.s", 1.0, float,
    "Collector scrape period: every tick fetches each discovered role's "
    "/api/status, folds the numbers into the per-run history store, and "
    "recomputes the derived observer.* signals.  <= 0 disables the "
    "scrape loop (scrape_once() still works on demand).")
OBSERVER_ENDPOINTS = ConfigEntry(
    "async.observer.endpoints", "", str,
    "Static scrape targets beside discovery, ';'-separated "
    "'name=role@host:port' entries (role and name optional: "
    "'host:port' scrapes as role 'process').  The k8s observer "
    "Deployment passes the per-role Services here.")
OBSERVER_HISTORY_DIR = ConfigEntry(
    "async.observer.history.dir", "", str,
    "Root directory of the durable run-history store (one run-<id>/ "
    "subdir per observed run: meta.json + per-role compacted series + "
    "harvested flight-recorder dumps; bin/async-history renders an "
    "index over it).  Empty = in-memory only, nothing persisted.")
OBSERVER_HISTORY_POINTS = ConfigEntry(
    "async.observer.history.points", 512, int,
    "Per-series capacity of the run-history store.  At capacity every "
    "other point is dropped and the acceptance stride doubles "
    "(ConvergenceHistory's compaction), so a persisted series spans "
    "the WHOLE run at bounded disk/RAM instead of forgetting its "
    "start.")
OBSERVER_PERSIST_S = ConfigEntry(
    "async.observer.persist.s", 5.0, float,
    "How often the collector persists the run-history store to disk "
    "(atomic per-role files via checkpoint.durable_replace; also "
    "persisted once at stop).  <= 0 persists only at stop.")
OBSERVER_STRAGGLER_FACTOR = ConfigEntry(
    "async.observer.straggler.factor", 2.5, float,
    "A worker whose straggler score (max over the compute / push-RTT / "
    "push-interval / staleness dimensions of worker_value over "
    "cohort_median) reaches this factor is flagged in the fleet view "
    "and counted in observer.stragglers_flagged -- the input surface "
    "for delay-adaptive control (ROADMAP item 2).")
# --------------------------------------------------------- flight recorder
FLIGHT_DIR = ConfigEntry(
    "async.flight.dir", "", str,
    "Crash flight recorder dump directory (metrics/flightrec.py): when "
    "set, this process keeps a bounded in-memory ring of recent "
    "events/spans/counter deltas and writes it to "
    "flight-<role>-<pid>.json here -- atomically on a cadence, plus a "
    "final dump on SIGTERM/SIGINT/atexit -- so even a SIGKILL leaves a "
    "post-mortem at most one flush behind.  The cluster observer "
    "harvests these into the run-history store.  Empty = off (the "
    "default: zero hot-path work).")
FLIGHT_EVENTS = ConfigEntry(
    "async.flight.events", 256, int,
    "Flight-recorder ring capacity in events (oldest evict first, "
    "counted).  Bounds both RAM and the dump file size.")
FLIGHT_FLUSH_S = ConfigEntry(
    "async.flight.flush.s", 0.5, float,
    "Flight-recorder flush cadence: how stale an uncatchable-kill "
    "(SIGKILL) post-mortem can be.  Each flush also records one "
    "counter-delta event (non-zero registry family deltas since the "
    "previous flush).  <= 0 disables the flush thread (dumps only on "
    "fatal signal / exit).")
# --------------------------------------------------- continuous profiling
PROF_ENABLED = ConfigEntry(
    "async.prof.enabled", 0, int,
    "Continuous profiling plane (metrics/profiler.py): 1 starts the "
    "stack sampler and arms the exact zone accumulators at the wire/"
    "merge/dispatch choke points; snapshots ride /api/status, the "
    "observer run history, and every flight-recorder dump.  0 (the "
    "default) is asserted byte-identical on the wire and zero-overhead "
    "on the hot path: zone() returns the shared no-op context manager "
    "and wrap_dispatch() returns the step callable unchanged.")
PROF_HZ = ConfigEntry(
    "async.prof.hz", 97.0, float,
    "Sampling-profiler frequency in Hz (prime, to avoid lockstep with "
    "periodic work).  Sampling error for a zone with true share p "
    "after N samples is ~sqrt(p(1-p)/N): 97 Hz resolves a 10% zone to "
    "+-0.4% over a 60 s window.  <= 0 keeps the exact zone "
    "accumulators but starts no sampler thread.")
PROF_STACKS = ConfigEntry(
    "async.prof.stacks", 256, int,
    "Bound on DISTINCT collapsed stacks the sampler keeps (bounds RAM "
    "and snapshot size).  Beyond it, new stacks are dropped and "
    "counted in profile.stack_overflow -- never evicted, which would "
    "bias long-running hot stacks out of the flamegraph.")
# -------------------------------------------------------- adaptive control
# The closed loop from cluster telemetry to the async knobs
# (parallel/controller.py): an AsyncController on the primary PS
# periodically reads the observed signals (PS-local per-worker
# staleness/RTT/compute EWMAs; observer.* straggler scores and fleet
# freshness when a collector is attached) and actuates the declared
# tunables -- per-push delay-adaptive step damping, partial-barrier
# cohort size, pipeline depth, push-merge budget.  Decisions propagate
# through the existing SETMAP/WELCOME control path as a CTRL payload
# next to the shard map and epoch vector.
CONTROL_ENABLED = ConfigEntry(
    "async.control.enabled", False, bool,
    "Run the adaptive asynchrony controller on the primary PS.  Off "
    "(the default) the wire is byte-identical legacy -- no CTRL "
    "payloads anywhere; async-cluster flips it on (straggler-heavy "
    "runs stop needing hand-tuned b/depth/merge/step conf).")
CONTROL_INTERVAL_S = ConfigEntry(
    "async.control.interval.s", 0.5, float,
    "Controller decision period: every tick reads the observed "
    "signals and re-evaluates every knob target.  <= 0 disables the "
    "loop thread (tick() still works on demand -- the ManualClock "
    "test surface).")
CONTROL_HYSTERESIS = ConfigEntry(
    "async.control.hysteresis", 0.25, float,
    "Relative dead-band per knob: a recomputed target actuates only "
    "when it differs from the current value by more than this "
    "fraction (and by >= 1 for integer knobs).  The first defense "
    "against knob flapping; the oscillation guard is the second.")
CONTROL_COOLDOWN_S = ConfigEntry(
    "async.control.cooldown.s", 2.0, float,
    "Minimum seconds between successive changes of the SAME knob -- "
    "a decision needs time to show up in the signals it was made "
    "from (staleness EWMAs, queue depth) before being revised.")
CONTROL_OSC_REVERSALS = ConfigEntry(
    "async.control.osc.reversals", 3, int,
    "Oscillation guard: this many direction REVERSALS of one knob "
    "within the freeze window trips the guard -- the knob freezes at "
    "its current value for async.control.osc.freeze.s and the trip "
    "is counted (control.osc_trips) and surfaced in /api/status.")
CONTROL_OSC_FREEZE_S = ConfigEntry(
    "async.control.osc.freeze.s", 10.0, float,
    "How long an oscillation-tripped knob stays frozen before the "
    "controller may move it again (reversal history cleared).")
CONTROL_DAMP_FREE = ConfigEntry(
    "async.control.damp.free", -1.0, float,
    "Staleness slack before delay-adaptive step damping engages: a "
    "push at staleness tau is damped by 1/(1 + tau - free) only past "
    "this threshold (floored at the async.step.size tunable floor).  "
    "-1 (the default) auto-sizes to num_workers + pipeline depth + 2: "
    "with P workers and a depth-D in-flight window the steady-state "
    "staleness is ~P-1+D, so only ABNORMAL delay damps -- damping the "
    "healthy steady state just slows convergence at a fixed budget.")

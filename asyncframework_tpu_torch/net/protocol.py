"""The declared wire-protocol table: every op, one row, one place.

Nine PRs grew four framed-TCP planes -- the parameter server
(``parallel/ps_dcn.py`` + ``parallel/shardgroup.py``), the serving tier
(``serving/replica.py`` / ``serving/frontend.py``), the deploy control
plane (``deploy/master.py`` / ``deploy/worker.py``), and the log-topic
stream (``streaming/log_net.py``) -- and with them a set of per-op
obligations that were, until this module, encoded only as scattered
``frozenset`` literals and dispatch branches:

- **dedup gating**: a mutating, non-idempotent op (PUSH, APPEND,
  SUBMIT_APP, ...) must ride the ``net/session.py`` ``(sid, seq)``
  DedupWindow, or a retry after a lost reply applies it twice -- the
  exact double-apply the ASYNC staleness bookkeeping cannot survive;
- **epoch stamping**: with ``async.fence.enabled``, PS-plane ops carry
  the ``ep`` fencing stamp and servers must run fencing admission, or a
  zombie incarnation silently mutates a range it no longer owns;
- **fault schedulability**: chaos presets (``net/faults.py``) name ops
  by pattern; a renamed op silently drops out of every chaos schedule.

This table declares those obligations per op.  Servers derive their
mutating-op sets from it (:func:`dedup_gated_ops` -- ``deploy/master.py``
and ``streaming/log_net.py`` import theirs), and the static analyzer
(``asyncframework_tpu_torch/analysis/``, ``bin/async-lint``) cross-checks every
dispatch branch, dedup route, and fence-admission call in the tree
against it: a new op missing its DedupWindow route or ``ep`` stamp is a
lint failure, not a chaos-suite lottery.

Pure data -- this module imports nothing from the package and is safe to
import from any layer (including ``analysis/``, which must not drag in
jax-heavy modules).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Tuple

#: direction values
REQUEST = "request"
REPLY = "reply"
BOTH = "both"      # same verb is used as a request and as a reply shape

#: planes (who serves the op)
PS = "ps"               # parallel/ps_dcn.py (+ shardgroup fan-out)
SERVING = "serving"     # serving/replica.py, serving/frontend.py
MASTER = "master"       # deploy/master.py
WORKER = "worker"       # deploy/worker.py order socket
TOPIC = "topic"         # streaming/log_net.py
RELAY = "relay"         # relaycast/node.py (peer-relayed distribution)
PSEUDO = "pseudo"       # protocol-less hook points (fault injection)


@dataclass(frozen=True)
class WireOp:
    """One wire verb and its protocol obligations.

    ``mutating`` is "changes server state at all"; ``dedup_gated`` is the
    stronger "non-idempotent, MUST ride the (sid, seq) DedupWindow".
    Every mutating-but-ungated op carries its idempotence argument in
    ``doc`` -- that argument is the thing a reviewer must re-check when
    the handler changes.  ``fence_stamped`` ops carry the ``ep`` epoch
    stamp client-side and pass fencing admission server-side when
    ``async.fence.enabled`` is on.  ``fault_schedulable`` ops are legal
    targets for non-test fault-schedule presets (tests may target
    anything)."""

    name: str
    plane: str
    direction: str = REQUEST
    mutating: bool = False
    dedup_gated: bool = False
    fence_stamped: bool = False
    fault_schedulable: bool = False
    doc: str = ""

    def __post_init__(self):
        if self.dedup_gated and not self.mutating:
            raise ValueError(f"{self.name}: dedup_gated implies mutating")
        if self.direction == REPLY and (self.mutating or self.dedup_gated):
            raise ValueError(f"{self.name}: a reply cannot be mutating")


_OPS: Dict[str, WireOp] = {}


def _op(*args, **kw) -> None:
    op = WireOp(*args, **kw)
    if op.name in _OPS:
        raise ValueError(f"duplicate wire op {op.name}")
    _OPS[op.name] = op


# ---------------------------------------------------------------- PS plane
_op("PULL", PS, fence_stamped=True, fault_schedulable=True,
    doc="Wave-gated model read; idempotent and unstamped, safe to retry.")
_op("PULL_SAGA", PS, fence_stamped=True, fault_schedulable=True,
    doc="ASAGA's PULL verb (own name so fault schedules can target the "
        "ASAGA stream without also counting ASGD ops).")
_op("PUSH", PS, mutating=True, dedup_gated=True, fence_stamped=True,
    fault_schedulable=True,
    doc="Gradient contribution; THE double-apply hazard.  Dedup strictly "
        "precedes fencing (net/session.py contract).")
_op("PUSH_SAGA", PS, mutating=True, dedup_gated=True, fence_stamped=True,
    fault_schedulable=True,
    doc="ASAGA's PUSH verb; same exactly-once obligations as PUSH.")
_op("SUBSCRIBE", PS, fence_stamped=True, fault_schedulable=True,
    doc="Serving-tier snapshot read: wave-gate-free, membership-free "
        "PULL that keeps answering after DONE.")
_op("HELLO", PS, mutating=True, fault_schedulable=True,
    doc="Worker/replica introduction (also served by the serving "
        "frontend).  Mutates membership but is idempotent: re-HELLO of "
        "the same proc token re-registers, it never double-allocates.")
_op("SHARDMAP", PS, direction=BOTH,
    doc="Shard-map query and its reply verb; read-only.")
_op("SETMAP", PS, mutating=True,
    doc="Controller installs the assembled shard map/epoch vector; "
        "idempotent -- re-install of the same map is a no-op by value.")
_op("FINISH", PS, mutating=True,
    doc="Group-wide DONE broadcast; idempotent by construction (sets an "
        "already-set event).")
_op("SNAPSHOTS", PS, direction=BOTH,
    doc="Trajectory snapshot-stack read (eval plane) and its reply.")
_op("EVAL_RESULT", PS, mutating=True,
    doc="Worker's end-of-run eval vector; stamped client-side but "
        "idempotent server-side (same-wid overwrite of the same array).")
_op("BYE", PS, mutating=True,
    doc="Departing client's final piggybacks (spans/pl/cv).  Sent once "
        "per connection, never retried; span folds dedup by span_id.")
_op("SHM_OPEN", PS, fault_schedulable=True,
    doc="Transport upgrade handshake (net/shmring.py): a colocated "
        "client offers two shared-memory ring segments; the server "
        "attaches and ACKs, after which the SAME framed protocol "
        "continues over the rings instead of the TCP socket (which is "
        "retained for identity/liveness).  Non-mutating and trivially "
        "idempotent: it changes the TRANSPORT of a connection, never "
        "server state -- a refused or lost upgrade leaves the TCP "
        "conversation exactly where it was, and admission checks "
        "(dedup, fencing) run unchanged over either transport.")
_op("REPL_APPEND", PS, mutating=True, fence_stamped=True,
    fault_schedulable=True,
    doc="Primary->standby replication of one accepted merge batch "
        "(parallel/replication.py): the post-dedup drained items with "
        "their (sid, seq) stamps, verdicts, and staleness, stamped with "
        "the primary's merge clock (pre) and fencing epoch; accepted "
        "gradients ride as the payload.  Mutating but NOT dedup-gated: "
        "idempotence is the clock compare -- a batch entirely at-or-"
        "below the standby's applied clock re-ACKs as a duplicate, a "
        "batch starting exactly AT the clock applies, anything else is "
        "refused with resync=True (never applied twice; the stream is "
        "strictly serial per connection).  A deposed primary's post-"
        "promotion appends are REJECT_FENCED -- that admission IS the "
        "promotion-safety argument.")
_op("REPL_SYNC", PS, mutating=True, fence_stamped=True,
    fault_schedulable=True,
    doc="Full-state bootstrap of a (re)connecting standby: the "
        "primary's checkpoint image (model + clock + dedup window + "
        "trajectory) as one payload.  Idempotent: installing the same "
        "image twice converges to the same state, and a newer sync "
        "simply supersedes an older one.")
_op("PROMOTE", PS, mutating=True,
    doc="Controller order promoting a standby to range primary under "
        "the NEXT fencing epoch.  Deliberately NOT fence_stamped: its "
        "whole job is to raise the epoch past the deposed primary's.  "
        "Idempotent by monotone epoch compare -- re-delivery of the "
        "same (or an older) epoch re-answers ACK without demoting "
        "anything.")
_op("MODEL", PS, direction=REPLY,
    doc="PULL/SUBSCRIBE reply: full / NOT_MODIFIED / XOR-delta payload "
        "with version CRC.")
_op("WELCOME", PS, direction=REPLY,
    doc="HELLO reply (PS and serving frontend): elastic flag, shard "
        "map, epoch vector, slot index.")
_op("REJECT_FENCED", PS, direction=REPLY,
    doc="Fencing admission verdict; carries the highest known epoch so "
        "a deposed client self-heals.")
_op("RELEASED", PS, direction=REPLY,
    doc="PUSH reply deposing a surrogate after the owner rejoined.")
_op("DONE", PS, direction=REPLY,
    doc="PUSH reply: run complete, stop contributing.")
# ----------------------------------------------------------- serving plane
_op("PREDICT", SERVING, fault_schedulable=True,
    doc="Inference read (frontend round-robins it over replicas).")
_op("STATUS", SERVING, direction=BOTH,
    doc="Replica/frontend introspection read and its reply verb.")
_op("PREDICTION", SERVING, direction=REPLY,
    doc="PREDICT reply with row-major payload.")
_op("UNHEALTHY", SERVING, direction=REPLY,
    doc="Replica past its staleness SLO refusing to serve; frontend "
        "fails over.")
# ------------------------------------------------------------- relay plane
_op("RELAY_FETCH", RELAY, fence_stamped=True, fault_schedulable=True,
    doc="Peer fetch of a relayed model version (``have=``-negotiated "
        "NM/XDELTA/FULL, optionally zlib-compressed, always CRC-gated); "
        "read-only and idempotent, safe to retry.  A fetch whose stamped "
        "epoch is stale is REJECT_FENCED; a fetch whose REPLY carries a "
        "stale version epoch is discarded client-side (the child falls "
        "back to a direct root SUBSCRIBE either way).")
_op("RELAY_OFFER", RELAY, mutating=True, fence_stamped=True,
    fault_schedulable=True,
    doc="Parent's new-version announcement down the distribution tree "
        "(the PS root's offer loop and every interior node send it).  "
        "Mutating only as 'remember the newest offered version and wake "
        "the fetch path'; idempotent by construction -- re-delivery of "
        "the same (ts, crc) is a no-op by monotone version compare, so "
        "no dedup window is needed, and a LOST offer costs nothing (the "
        "child's poll loop fetches on its next tick).")
_op("RELAY_MODEL", RELAY, direction=REPLY,
    doc="RELAY_FETCH reply: negotiated model payload with wenc/CRC, the "
        "version's fencing epoch, and freshness metadata "
        "(clock/k/age_ms/done) so every hop keeps pricing its lag.")
# ------------------------------------------------------------ master plane
_op("REGISTER_WORKER", MASTER, mutating=True,
    doc="Worker daemon introduction; idempotent re-register by "
        "worker_id.")
_op("HEARTBEAT", MASTER, mutating=True,
    doc="Liveness renewal; idempotent (monotone last-seen update).")
_op("EXECUTOR_EXIT", MASTER, mutating=True,
    doc="Executor-death report; idempotent (set-insert by exec id).")
_op("SUBMIT_APP", MASTER, mutating=True, dedup_gated=True,
    fault_schedulable=True,
    doc="App scheduling; one retry storm must schedule exactly one app.")
_op("KILL_APP", MASTER, mutating=True, dedup_gated=True,
    doc="App kill fan-out; gated so a retried kill is answered from "
        "cache instead of re-fanning KILL orders.")
_op("APP_STATUS", MASTER, doc="App state read.")
_op("LIST_WORKERS", MASTER, doc="Membership read.")
_op("REGISTERED", MASTER, direction=REPLY, doc="REGISTER_WORKER reply.")
_op("RECONNECT", MASTER, direction=REPLY,
    doc="HEARTBEAT reply: master restarted, re-introduce yourself.")
_op("STANDBY", MASTER, direction=REPLY,
    doc="Not-leader refusal during HA election; never dedup-cached "
        "(routing answer, not an outcome).")
_op("SUBMITTED", MASTER, direction=REPLY, doc="SUBMIT_APP reply.")
_op("KILLED", MASTER, direction=REPLY, doc="KILL_APP reply.")
_op("APP", MASTER, direction=REPLY, doc="APP_STATUS reply.")
_op("WORKERS", MASTER, direction=REPLY, doc="LIST_WORKERS reply.")
# ------------------------------------------------------------ worker plane
_op("LAUNCH", WORKER, mutating=True,
    doc="Executor launch order.  Idempotent per app_id: a re-LAUNCH of "
        "a killed app_id is refused by the worker's killed-set.")
_op("KILL", WORKER, mutating=True,
    doc="Executor kill order; idempotent (kill of the dead is a no-op).")
# ------------------------------------------------------------- topic plane
_op("APPEND", TOPIC, mutating=True, dedup_gated=True,
    fault_schedulable=True,
    doc="Log append; a duplicated record is exactly an ungated APPEND "
        "retry.")
_op("COMMIT", TOPIC, mutating=True, dedup_gated=True,
    doc="Consumer-group offset commit; non-idempotent against "
        "concurrent commits from a rebalanced consumer.")
_op("READ", TOPIC, doc="Record-range read.")
_op("END", TOPIC, direction=BOTH,
    doc="End-offset query and its reply verb.")
_op("COMMITTED", TOPIC, direction=BOTH,
    doc="Committed-offset query (request) and COMMIT's reply verb.")
_op("APPENDED", TOPIC, direction=REPLY, doc="APPEND reply.")
_op("RECORDS", TOPIC, direction=REPLY, doc="READ reply with payload.")
_op("OFFSET", TOPIC, direction=REPLY, doc="COMMITTED-query reply.")
# ------------------------------------------------------------------ shared
_op("ACK", PS, direction=REPLY,
    doc="Generic applied/accepted reply (every plane).")
_op("ERR", PS, direction=REPLY,
    doc="Generic refusal/bad-op reply (every plane).")
_op("CONNECT", PSEUDO, fault_schedulable=True,
    doc="Pseudo-op fault schedules use to target the dial itself "
        "(net/faults.py CONNECT_OP; the dial has no header).")


# ------------------------------------------------------------------ access
def table() -> Dict[str, WireOp]:
    """The full op table, name -> row (a copy; the table is immutable)."""
    return dict(_OPS)


def get(name: str) -> WireOp:
    return _OPS[name]


def is_declared(name: str) -> bool:
    return name in _OPS


def ops(plane: str = None) -> Tuple[WireOp, ...]:
    """Rows, optionally filtered by plane."""
    return tuple(op for op in _OPS.values()
                 if plane is None or op.plane == plane)


def dedup_gated_ops(plane: str) -> FrozenSet[str]:
    """The (sid, seq)-gated mutating verbs of one plane -- servers derive
    their ``_MUTATING_OPS`` sets from this, so the table is the single
    point where an op's exactly-once obligation is declared (and
    ``bin/async-lint`` checks the derivation is in place)."""
    return frozenset(op.name for op in _OPS.values()
                     if op.plane == plane and op.dedup_gated)


def fence_stamped_ops() -> FrozenSet[str]:
    """Verbs that carry the ``ep`` fencing stamp (all PS-plane)."""
    return frozenset(op.name for op in _OPS.values() if op.fence_stamped)


def fault_schedulable_ops() -> FrozenSet[str]:
    """Verbs non-test chaos presets may legally target."""
    return frozenset(op.name for op in _OPS.values()
                     if op.fault_schedulable)


#: modules the protocol linter scans for op literals (repo-relative).
#: sql/ also compares a variable named ``op`` against uppercase strings
#: (UNION/EXCEPT) -- protocol scanning is scoped to the wire planes, not
#: keyed on variable names alone.
PROTOCOL_MODULES: Tuple[str, ...] = (
    "asyncframework_tpu_torch/parallel/ps_dcn.py",
    "asyncframework_tpu_torch/parallel/shardgroup.py",
    "asyncframework_tpu_torch/parallel/replication.py",
    "asyncframework_tpu_torch/serving/replica.py",
    "asyncframework_tpu_torch/serving/frontend.py",
    "asyncframework_tpu_torch/serving/server.py",
    "asyncframework_tpu_torch/deploy/master.py",
    "asyncframework_tpu_torch/deploy/worker.py",
    "asyncframework_tpu_torch/deploy/client.py",
    "asyncframework_tpu_torch/streaming/log_net.py",
    "asyncframework_tpu_torch/relaycast/node.py",
    "asyncframework_tpu_torch/relaycast/source.py",
    "asyncframework_tpu_torch/net/faults.py",
)

#: request-op -> server modules whose dispatch must handle it (the
#: coverage matrix the linter enforces).  HELLO/SUBSCRIBE/PREDICT appear
#: under every server that answers them.
SERVER_DISPATCH: Dict[str, Tuple[str, ...]] = {
    "PULL": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "PULL_SAGA": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "PUSH": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "PUSH_SAGA": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "SUBSCRIBE": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "HELLO": ("asyncframework_tpu_torch/parallel/ps_dcn.py",
              "asyncframework_tpu_torch/serving/frontend.py"),
    "SHARDMAP": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "SETMAP": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "FINISH": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "SHM_OPEN": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "REPL_APPEND": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "REPL_SYNC": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "PROMOTE": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "SNAPSHOTS": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "EVAL_RESULT": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "BYE": ("asyncframework_tpu_torch/parallel/ps_dcn.py",),
    "PREDICT": ("asyncframework_tpu_torch/serving/replica.py",
                "asyncframework_tpu_torch/serving/frontend.py"),
    "STATUS": ("asyncframework_tpu_torch/serving/replica.py",
               "asyncframework_tpu_torch/serving/frontend.py"),
    "REGISTER_WORKER": ("asyncframework_tpu_torch/deploy/master.py",),
    "HEARTBEAT": ("asyncframework_tpu_torch/deploy/master.py",),
    "EXECUTOR_EXIT": ("asyncframework_tpu_torch/deploy/master.py",),
    "SUBMIT_APP": ("asyncframework_tpu_torch/deploy/master.py",),
    "KILL_APP": ("asyncframework_tpu_torch/deploy/master.py",),
    "APP_STATUS": ("asyncframework_tpu_torch/deploy/master.py",),
    "LIST_WORKERS": ("asyncframework_tpu_torch/deploy/master.py",),
    "LAUNCH": ("asyncframework_tpu_torch/deploy/worker.py",),
    "KILL": ("asyncframework_tpu_torch/deploy/worker.py",),
    "RELAY_FETCH": ("asyncframework_tpu_torch/relaycast/node.py",),
    "RELAY_OFFER": ("asyncframework_tpu_torch/relaycast/node.py",),
    "APPEND": ("asyncframework_tpu_torch/streaming/log_net.py",),
    "COMMIT": ("asyncframework_tpu_torch/streaming/log_net.py",),
    "READ": ("asyncframework_tpu_torch/streaming/log_net.py",),
    "END": ("asyncframework_tpu_torch/streaming/log_net.py",),
    "COMMITTED": ("asyncframework_tpu_torch/streaming/log_net.py",),
}

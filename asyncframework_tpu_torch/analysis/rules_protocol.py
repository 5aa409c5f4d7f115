"""Wire-protocol coverage matrix against ``net/protocol.py``.

The table declares every op's obligations; this rule statically
cross-checks the planes' dispatch code against it, so a new op missing
its DedupWindow route or ``ep`` stamp is a lint failure, not a
chaos-suite lottery:

- ``proto-undeclared-op``: an uppercase op literal used in a protocol
  module (``{"op": "X"}`` construction, ``op == "X"`` dispatch,
  mutating-set membership, fault-preset pattern) that has no table row;
- ``proto-unhandled-op``: a table op whose declared server module has
  no dispatch branch for it (SERVER_DISPATCH coverage);
- ``proto-dedup-gate``: a dedup-gated op whose ps_dcn dispatch branch
  does not route through the DedupWindow, or a server module whose
  ``_MUTATING_OPS`` is hand-rolled instead of derived from
  ``protocol.dedup_gated_ops(...)`` (the drift that re-opens the
  round-5 duplicate-APPEND bug);
- ``proto-fence-gate``: a fence-stamped op whose ps_dcn dispatch branch
  never calls ``_fence_reject`` (server side), or a PS client module
  that no longer stamps ``ep`` anywhere (client side);
- ``proto-fault-target``: a non-test fault-schedule preset targeting an
  op the table does not mark fault-schedulable.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from asyncframework_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    SourceFile,
    const_str,
    tail_name,
)
from asyncframework_tpu_torch.net import protocol

_OP_RE = re.compile(r"^[A-Z][A-Z_]+$")
PS_DCN_PATH = "asyncframework_tpu_torch/parallel/ps_dcn.py"
FAULTS_PATH = "asyncframework_tpu_torch/net/faults.py"

#: server modules that owe fence-stamped ops a ``_fence_reject``
#: admission call in their dispatch branches (the PS plane and the
#: relaycast plane -- the two places a zombie incarnation could serve
#: or mutate state it no longer owns)
FENCE_SERVER_PATHS = (
    PS_DCN_PATH,
    "asyncframework_tpu_torch/relaycast/node.py",
)

#: the client-side fencing stamp choke points, path -> stamping function:
#: every PS-plane client op header flows through PSClient._proc_hdr (the
#: sharded facade and serving replicas ride PSClient sub-clients, so
#: there is exactly one), and every relay hop through
#: RelaySource._stamped.  The rule requires the ``["ep"]`` assignment
#: INSIDE the named function -- an ``ep`` write elsewhere (a server
#: advertising its epoch on replies) must not satisfy the client-stamp
#: obligation.
FENCE_CLIENT_STAMPS = {
    PS_DCN_PATH: "_proc_hdr",
    "asyncframework_tpu_torch/relaycast/source.py": "_stamped",
    # the replication stream's choke point: every REPL_SYNC/REPL_APPEND
    # frame carries the primary's current epoch, so a deposed
    # incarnation's appends are exactly the stale-stamp shape the
    # standby's admission rejects
    "asyncframework_tpu_torch/parallel/replication.py": "_stamped",
}
# legacy aliases (kept: the acceptance tests and docs name them)
FENCE_CLIENT_PATHS = tuple(FENCE_CLIENT_STAMPS)
FENCE_STAMP_FN = FENCE_CLIENT_STAMPS[PS_DCN_PATH]


def _is_op_compare(node: ast.Compare) -> bool:
    """``op == "X"`` / ``op in (...)`` where the left side is an ``op``
    variable or a ``.get("op")`` call -- the dispatch shapes the planes
    use."""
    left = node.left
    if isinstance(left, (ast.Name, ast.Attribute)) and \
            tail_name(left) == "op":
        return True
    if isinstance(left, ast.Call) and tail_name(left.func) == "get" and \
            left.args and const_str(left.args[0]) == "op":
        return True
    return False


def _compare_ops(node: ast.Compare) -> Iterable[Tuple[str, int]]:
    for comp in node.comparators:
        s = const_str(comp)
        if s is not None:
            yield s, comp.lineno
        elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
            for elt in comp.elts:
                s = const_str(elt)
                if s is not None:
                    yield s, elt.lineno


def _op_literals(sf: SourceFile) -> List[Tuple[str, int, str]]:
    """(op, line, context) for every op literal in one protocol module.

    Contexts: 'construct' ({"op": X} headers), 'dispatch' (op == X),
    'mutset' (_MUTATING_OPS membership), 'fault' (fault-preset
    patterns, split on '|')."""
    out: List[Tuple[str, int, str]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if const_str(k) == "op":
                    s = const_str(v)
                    if s is not None:
                        out.append((s, v.lineno, "construct"))
        elif isinstance(node, ast.Compare) and _is_op_compare(node):
            for s, line in _compare_ops(node):
                out.append((s, line, "dispatch"))
        elif isinstance(node, ast.Assign) and node.targets and \
                tail_name(node.targets[0]) == "_MUTATING_OPS":
            for sub in ast.walk(node.value):
                s = const_str(sub)
                if s is not None:
                    out.append((s, sub.lineno, "mutset"))
    if sf.relpath == FAULTS_PATH:
        # preset op patterns: alternations ("PUSH|PUSH_SAGA") anywhere,
        # plus the op argument of schedule.add()/add_delay() calls --
        # bare all-caps strings elsewhere in faults.py (env-var names,
        # fault-kind constants) are not op patterns
        for node in ast.walk(sf.tree):
            s = const_str(node)
            if s is not None and "|" in s:
                parts = s.split("|")
                if all(_OP_RE.match(p) for p in parts):
                    for p in parts:
                        out.append((p, node.lineno, "fault"))
            elif isinstance(node, ast.Call) and \
                    tail_name(node.func) in ("add", "add_delay") and \
                    len(node.args) >= 2:
                s = const_str(node.args[1])
                if s is not None and s != "*" and _OP_RE.match(s):
                    out.append((s, node.args[1].lineno, "fault"))
    return out


def _dispatch_branches(sf: SourceFile, op: str) -> List[ast.If]:
    """Every ``if``/``elif`` whose test compares the op variable against
    ``op`` (a file can dispatch the same verb in more than one place --
    server loop and windowed-client reply reaping, say)."""
    out: List[ast.If] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.If):
            continue
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Compare) and _is_op_compare(sub) and \
                    any(s == op for s, _ in _compare_ops(sub)):
                out.append(node)
                break
    return out


def _branch_scope(branch: ast.If) -> Iterable[ast.AST]:
    """The test + taken-body of a dispatch branch (not the elif chain)."""
    yield from ast.walk(branch.test)
    for stmt in branch.body:
        yield from ast.walk(stmt)


def _file_has_dispatch(sf: SourceFile, op: str) -> bool:
    if _dispatch_branches(sf, op):
        return True
    # master-style tables: membership in a set the dispatch consults
    for s, _line, kind in _op_literals(sf):
        if s == op and kind == "mutset":
            return True
    return False


def _mutset_derived(sf: SourceFile) -> Optional[bool]:
    """None = module has no ``_MUTATING_OPS``; else whether it derives
    from ``protocol.dedup_gated_ops(...)``."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and node.targets and \
                tail_name(node.targets[0]) == "_MUTATING_OPS":
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Call) and \
                        tail_name(sub.func) == "dedup_gated_ops":
                    return True
            return False
    return None


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    declared = protocol.table()

    # 1. every op literal in a protocol module is declared
    seen_ops: Dict[str, Set[str]] = {}
    for path in protocol.PROTOCOL_MODULES:
        sf = ctx.get(path)
        if sf is None:
            continue
        for op, line, kind in _op_literals(sf):
            if not _OP_RE.match(op):
                continue
            seen_ops.setdefault(op, set()).add(path)
            if op not in declared:
                findings.append(Finding(
                    "proto-undeclared-op", path, line, op,
                    f"wire op {op!r} ({kind}) has no row in "
                    f"net/protocol.py -- declare it (mutating? "
                    f"dedup-gated? fence-stamped? fault-schedulable?) "
                    f"before shipping it"))

    # 2. server coverage matrix
    for op, servers in sorted(protocol.SERVER_DISPATCH.items()):
        for path in servers:
            sf = ctx.get(path)
            if sf is None or _file_has_dispatch(sf, op):
                continue
            findings.append(Finding(
                "proto-unhandled-op", path, 1, op,
                f"net/protocol.py declares {op!r} served by this "
                f"module, but no dispatch branch handles it"))

    # 3. dedup gating
    ps = ctx.get(PS_DCN_PATH)
    for op in sorted(protocol.dedup_gated_ops(protocol.PS)):
        if ps is None:
            break
        branches = _dispatch_branches(ps, op)
        if not branches:
            continue  # already a proto-unhandled-op finding
        gated = any(
            isinstance(n, ast.Attribute) and n.attr == "check"
            and "dedup" in tail_name(n.value).lower()
            for branch in branches for n in _branch_scope(branch))
        if not gated:
            findings.append(Finding(
                "proto-dedup-gate", PS_DCN_PATH, branches[0].lineno, op,
                f"dispatch branch for dedup-gated op {op!r} does not "
                f"consult the DedupWindow (net/session.py) -- a retried "
                f"{op} after a lost reply double-applies"))
    for plane, path in ((protocol.MASTER,
                         "asyncframework_tpu_torch/deploy/master.py"),
                        (protocol.TOPIC,
                         "asyncframework_tpu_torch/streaming/log_net.py")):
        sf = ctx.get(path)
        if sf is None:
            continue
        derived = _mutset_derived(sf)
        if derived is None:
            findings.append(Finding(
                "proto-dedup-gate", path, 1, plane,
                f"module serves dedup-gated {plane!r} ops but declares "
                f"no _MUTATING_OPS set"))
        elif not derived:
            findings.append(Finding(
                "proto-dedup-gate", path, 1, plane,
                f"_MUTATING_OPS is hand-rolled -- derive it from "
                f"protocol.dedup_gated_ops({plane!r}) so the table "
                f"stays the single source of truth"))

    # 4. fencing: server-side admission per branch, client-side stamp
    for path in FENCE_SERVER_PATHS:
        sf = ctx.get(path)
        if sf is None:
            continue
        for op in sorted(protocol.fence_stamped_ops()):
            branches = _dispatch_branches(sf, op)
            if not branches:
                continue
            fenced = any(
                isinstance(n, (ast.Attribute, ast.Name))
                and tail_name(n) == "_fence_reject"
                for branch in branches for n in _branch_scope(branch))
            if not fenced:
                findings.append(Finding(
                    "proto-fence-gate", path, branches[0].lineno, op,
                    f"dispatch branch for fence-stamped op {op!r} never "
                    f"calls _fence_reject -- a zombie incarnation would "
                    f"serve/apply it (async.fence.enabled)"))
    if protocol.fence_stamped_ops():
        for path, stamp_fn in FENCE_CLIENT_STAMPS.items():
            sf = ctx.get(path)
            if sf is None:
                continue
            stamps = any(
                isinstance(fn, ast.FunctionDef)
                and fn.name == stamp_fn
                and any(
                    isinstance(node, ast.Assign) and node.targets and
                    isinstance(node.targets[0], ast.Subscript) and
                    const_str(node.targets[0].slice) == "ep"
                    for node in ast.walk(fn))
                for fn in ast.walk(sf.tree))
            if not stamps:
                findings.append(Finding(
                    "proto-fence-gate", path, 1, "ep-stamp",
                    f"net/protocol.py declares fence-stamped ops but "
                    f"the client stamp choke point "
                    f"{stamp_fn}() no longer assigns the 'ep' "
                    f"header"))

    # 5. fault presets may only target schedulable ops
    faults_sf = ctx.get(FAULTS_PATH)
    if faults_sf is not None:
        schedulable = protocol.fault_schedulable_ops()
        for op, line, kind in _op_literals(faults_sf):
            if kind == "fault" and op not in schedulable:
                findings.append(Finding(
                    "proto-fault-target", FAULTS_PATH, line, op,
                    f"fault preset targets {op!r}, which "
                    f"net/protocol.py does not mark fault-schedulable"))
    return findings

"""Thread hygiene at every ``threading.Thread(...)`` construction site.

The connection thread-leak (one Thread object per connection ever
accepted) and a fleet of anonymous daemon threads made post-mortems read like
``Thread-47``: this rule pins the discipline the tree converged on:

- ``thread-unnamed``: every Thread names itself (``name=...``) --
  anonymous threads make stack dumps, lockwatch reports, and the live
  UI's thread table unreadable;
- ``thread-implicit-daemon``: daemonness is explicit (``daemon=...``)
  -- inheriting it from the spawner is how a should-be-daemon thread
  ends up wedging interpreter shutdown (or a must-survive thread dies
  with a daemon spawner);
- ``thread-unguarded``: the site either RETAINS the thread object (so
  someone can join/reap/health-check it: assignment, appended to a
  registry, returned) or wraps its target in the exception policy
  (``utils/threads.guarded``) -- a fire-and-forget
  ``threading.Thread(...).start()`` whose target raises dies silently,
  the connection-leak class of reap gap.

The constructor-kwarg check is lexical on purpose: a wrapper that
forwards ``**kwargs`` to Thread is invisible to it, so the repo's one
sanctioned wrapper (``utils/threads.py``) is itself allowlisted with a
reason, and everything else constructs Thread directly.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from asyncframework_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    SourceFile,
    dotted_name,
    tail_name,
)


def _is_thread_ctor(call: ast.Call) -> bool:
    dn = dotted_name(call.func)
    return dn in ("threading.Thread", "Thread") or \
        dn.endswith(".threading.Thread")


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_retained(sf: SourceFile, call: ast.Call) -> bool:
    """True when the Thread object outlives the statement: assigned,
    appended/registered, returned, yielded, or passed to a call other
    than its own ``.start()``."""
    node: ast.AST = call
    while True:
        parent = sf.parent_of(node)
        if parent is None:
            return False
        if isinstance(parent, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                               ast.NamedExpr, ast.Return, ast.Yield,
                               ast.List, ast.Tuple, ast.Dict,
                               ast.ListComp, ast.GeneratorExp)):
            return True
        if isinstance(parent, ast.Call) and parent is not call:
            # an argument to some call (e.g. registry.append(Thread(...)))
            return True
        if isinstance(parent, ast.Attribute):
            # Thread(...).start() -- whatever happens to the RESULT of
            # that method call (None), the Thread object itself is lost:
            # `t = threading.Thread(...).start()` binds None, not the
            # thread, so the chain is not-retained, full stop
            return False
        if isinstance(parent, ast.Expr):
            return False
        node = parent


def _target_guarded(call: ast.Call) -> bool:
    """target=guarded(...) -- the utils/threads.py exception policy (or
    a local ``_guarded`` copy where importing the package is off-limits,
    e.g. bench.py's probe path)."""
    target = _kwarg(call, "target")
    return (isinstance(target, ast.Call)
            and tail_name(target.func).lstrip("_") == "guarded")


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for path, sf in ctx.files.items():
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and _is_thread_ctor(node)):
                continue
            token = ""
            tgt = _kwarg(node, "target")
            if tgt is not None:
                token = tail_name(tgt) or tail_name(
                    tgt.func if isinstance(tgt, ast.Call) else tgt) or ""
            token = token or f"line{node.lineno}"
            if _kwarg(node, "name") is None:
                findings.append(Finding(
                    "thread-unnamed", path, node.lineno, token,
                    "Thread(...) without name= -- anonymous threads "
                    "make dumps and lockwatch reports unreadable"))
            if _kwarg(node, "daemon") is None:
                findings.append(Finding(
                    "thread-implicit-daemon", path, node.lineno, token,
                    "Thread(...) without explicit daemon= -- "
                    "daemonness inherited from the spawner is a "
                    "shutdown-wedge (or surprise-death) footgun"))
            if not _is_retained(sf, node) and not _target_guarded(node):
                findings.append(Finding(
                    "thread-unguarded", path, node.lineno, token,
                    "fire-and-forget Thread whose target is not "
                    "wrapped in utils/threads.guarded(...) -- an "
                    "exception in it dies silently and nothing can "
                    "reap or health-check the thread"))
    return findings

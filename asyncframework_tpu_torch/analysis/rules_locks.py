"""Blocking calls lexically inside ``with <lock>:`` -- the static twin
of ``net/lockwatch.py``.

The dynamic watchdog catches socket I/O under a *watched* lock at
runtime, on the paths a given run happens to execute.  This rule is its
lexical complement: it flags blocking calls written inside ANY
``with``-block whose context expression looks like a lock (identifier
containing ``lock``, or a ``cv``/``cond`` condition variable), on every
path, executed or not.  Code inside nested ``def``/``lambda`` bodies is
excluded (it runs later, outside the hold), and ``Condition.wait`` is
NOT flagged (it releases the lock while blocking -- that is its job).

Flagged callees:

- ``time.sleep``
- socket verbs: ``connect``/``accept``/``recv``/``recv_into``/
  ``recvmsg``/``sendall``/``sendmsg``
- the framing/RPC choke points: ``send_msg``/``recv_msg``/
  ``send_msg_vectored``/``recv_exact``/``_send_msg``/``_recv_msg``/
  ``_oneshot``/``_call``/``_call_raw``/``.call(...)`` (retry-policy and
  channel RPC)
- subprocess: ``communicate``, ``os.waitpid``, ``.wait()`` on a
  receiver named like a process (``proc``/``popen``/``child``)
- thread joins: ``.join()`` with no positional argument (``str.join``
  always has exactly one), or any ``.join`` on a receiver named like a
  thread

A true positive here is one slow peer stalling every thread that needs
the lock -- the exact convoy the lock-free pull path removed.
"""

from __future__ import annotations

import ast
import re
from typing import List

from asyncframework_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    dotted_name,
    tail_name,
    walk_excluding_nested_defs,
)

_LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|locks|cv|cond)\d*$|lock$",
                           re.IGNORECASE)

_SOCKET_VERBS = {"connect", "accept", "recv", "recv_into", "recvmsg",
                 "sendall", "sendmsg"}
_FRAME_VERBS = {"send_msg", "recv_msg", "send_msg_vectored", "recv_exact",
                "_send_msg", "_recv_msg", "_oneshot", "_call", "_call_raw",
                "call"}
_PROC_RE = re.compile(r"proc|popen|child", re.IGNORECASE)
_THREAD_RE = re.compile(r"thread|^_?t\d?$|^th$", re.IGNORECASE)


def _is_lock_expr(node: ast.AST) -> str:
    """The lock-ish identifier a with-item acquires, or ''."""
    name = tail_name(node)
    if name and _LOCK_NAME_RE.search(name):
        return name
    return ""


def _blocking_callee(call: ast.Call) -> str:
    """Why this call blocks, or '' if it does not match the catalog."""
    func = call.func
    dn = dotted_name(func)
    attr = tail_name(func)
    if dn in ("time.sleep", "sleep") or dn.endswith(".time.sleep"):
        return "time.sleep"
    if dn == "os.waitpid":
        return "os.waitpid"
    if attr in _SOCKET_VERBS and isinstance(func, ast.Attribute):
        return f"socket .{attr}()"
    if attr in _FRAME_VERBS:
        return f"{attr}() wire I/O"
    if attr == "communicate":
        return "subprocess .communicate()"
    if attr == "wait" and isinstance(func, ast.Attribute) and \
            _PROC_RE.search(tail_name(func.value) or ""):
        return "process .wait()"
    if attr == "join" and isinstance(func, ast.Attribute):
        recv = tail_name(func.value) or ""
        positional = [a for a in call.args]
        if not positional or _THREAD_RE.search(recv):
            return "thread .join()"
    return ""


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for path, sf in ctx.files.items():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.With):
                continue
            lock_names = [n for n in
                          (_is_lock_expr(item.context_expr)
                           for item in node.items) if n]
            if not lock_names:
                continue
            for sub in walk_excluding_nested_defs(node.body):
                if not isinstance(sub, ast.Call):
                    continue
                why = _blocking_callee(sub)
                if why:
                    # token carries the LOCK name too: an allowlist
                    # entry for one lock's documented contract must not
                    # suppress the same callee under a different lock
                    # in the same file
                    findings.append(Finding(
                        "lock-blocking-call", path, sub.lineno,
                        f"{lock_names[0]}:"
                        f"{tail_name(sub.func) or 'call'}",
                        f"{why} lexically inside "
                        f"`with {lock_names[0]}:` -- blocking under a "
                        f"held lock convoys every waiter "
                        f"(net/lockwatch.py is the dynamic twin of "
                        f"this rule)"))
    return findings

"""Native-oracle discipline: every ctypes entry point keeps a Python twin.

The native data plane (``native/*.cc`` via ctypes) is an
*optimization*, never a capability: every native symbol a module
configures must have a registered pure-Python oracle in that module's
``NATIVE_ORACLES`` table, the oracle must exist, and every dispatch site
that calls into the shared library must keep its guarded fallback
wired.  The property suites (``tests/test_wire_native.py``) prove the
two implementations bit-identical at runtime, but only for the pairs
they know about; this rule is the static registry that keeps the pair
set complete as entry points are added -- a native symbol without a twin
is a box that silently changes behavior when the toolchain disappears.

``NATIVE_ORACLES`` values come in two shapes, matching the two fallback
idioms in the tree:

- ``"_py_fn"`` -- a module-level function: the dispatch function that
  calls ``lib.<sym>`` must also (on its guarded branch) call a declared
  oracle function, in the SAME function body.  Deleting the fallback
  branch fires ``native-fallback-missing``.
- ``"_PyBackend.method"`` -- a class-shaped twin (``storage/kvstore.py``
  style, where backend selection happens once at construction): the
  class and method must exist, and the class must be instantiated
  somewhere in the module (the backend-selection fallback site).

Directions checked:

- ``native-oracle-missing``: a configured ctypes symbol
  (``lib.<sym>.restype = ...``) with no ``NATIVE_ORACLES`` entry;
- ``native-oracle-undefined``: an entry whose oracle does not exist at
  module level (a rename that silently orphaned the twin);
- ``native-oracle-stale``: an entry whose native symbol is no longer
  configured anywhere in the module (drift the other way);
- ``native-fallback-missing``: a dispatch function calling a native
  symbol with no oracle call in its body (function-shaped oracles), or
  a class-shaped twin that is never instantiated.

Scope: modules that call ``native_build.ensure_built`` -- the one
gateway to the shared libraries (loading a ``.so`` any other way is
already unidiomatic here).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from asyncframework_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    SourceFile,
    const_str,
    tail_name,
    walk_excluding_nested_defs,
)

ORACLE_TABLE = "NATIVE_ORACLES"


def _calls_ensure_built(sf: SourceFile) -> bool:
    return any(
        isinstance(n, ast.Call) and tail_name(n.func) == "ensure_built"
        for n in ast.walk(sf.tree))


def _oracle_table(sf: SourceFile) -> Tuple[Optional[Dict[str, str]], int]:
    """The module-level ``NATIVE_ORACLES`` dict literal (native symbol ->
    oracle name) + its line; (None, 0) when the module declares none."""
    for node in sf.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == ORACLE_TABLE
                   for t in node.targets):
            continue
        if not isinstance(node.value, ast.Dict):
            return None, node.lineno
        table: Dict[str, str] = {}
        for k, v in zip(node.value.keys, node.value.values):
            ks, vs = const_str(k), const_str(v)
            if ks is not None and vs is not None:
                table[ks] = vs
        return table, node.lineno
    return None, 0


def _configured_symbols(sf: SourceFile) -> Dict[str, int]:
    """Native symbols this module configures: every
    ``<handle>.<sym>.restype = ...`` assignment (the ctypes idiom makes
    restype configuration the one unskippable step)."""
    out: Dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Attribute) and t.attr == "restype"
                    and isinstance(t.value, ast.Attribute)):
                out.setdefault(t.value.attr, node.lineno)
    return out


def _loader_names(sf: SourceFile) -> Set[str]:
    """Functions that hold restype/argtypes configuration -- the loaders
    themselves, exempt from the fallback-call check."""
    out: Set[str] = set()
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for n in walk_excluding_nested_defs(fn.body):
            if (isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Attribute)
                    and t.attr in ("restype", "argtypes")
                    for t in n.targets)):
                out.add(fn.name)
                break
    return out


def _module_defs(sf: SourceFile) -> Tuple[Set[str], Dict[str, Set[str]]]:
    """(module-level function/class names, class name -> method names)."""
    funcs: Set[str] = set()
    classes: Dict[str, Set[str]] = {}
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.add(node.name)
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = {
                m.name for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return funcs, classes


def _check_module(path: str, sf: SourceFile) -> List[Finding]:
    configured = _configured_symbols(sf)
    if not configured:
        return []
    findings: List[Finding] = []
    table, table_line = _oracle_table(sf)
    if table is None:
        line = min(configured.values())
        findings.append(Finding(
            "native-oracle-missing", path, line, ORACLE_TABLE,
            f"module configures native symbols "
            f"{sorted(configured)} but declares no {ORACLE_TABLE} "
            f"table -- every ctypes entry point needs a registered "
            f"pure-Python twin"))
        return findings

    funcs, classes = _module_defs(sf)

    # direction 1: configured symbol with no oracle entry
    for sym in sorted(set(configured) - set(table)):
        findings.append(Finding(
            "native-oracle-missing", path, configured[sym], sym,
            f"native symbol {sym!r} is configured but has no "
            f"{ORACLE_TABLE} entry -- register its pure-Python twin "
            f"(the bit-identity property suite keys off this table)"))

    # direction 2: oracle entries must resolve; collect the fallback
    # name sets the call-site check accepts
    plain_oracles: Set[str] = set()
    twin_classes: Set[str] = set()
    for sym, oracle in sorted(table.items()):
        if sym not in configured:
            findings.append(Finding(
                "native-oracle-stale", path, table_line, sym,
                f"{ORACLE_TABLE} entry {sym!r} names a native symbol "
                f"this module no longer configures -- drop or fix the "
                f"entry"))
            continue
        if "." in oracle:
            cls, _, meth = oracle.partition(".")
            if cls not in classes or meth not in classes[cls]:
                findings.append(Finding(
                    "native-oracle-undefined", path, table_line, sym,
                    f"oracle {oracle!r} for native symbol {sym!r} does "
                    f"not exist (no module-level class {cls!r} with "
                    f"method {meth!r})"))
                continue
            twin_classes.add(cls)
        else:
            if oracle not in funcs:
                findings.append(Finding(
                    "native-oracle-undefined", path, table_line, sym,
                    f"oracle {oracle!r} for native symbol {sym!r} is "
                    f"not a module-level function"))
                continue
            plain_oracles.add(oracle)

    # direction 3a: class-shaped twins must actually be constructed
    # somewhere (the backend-selection fallback site)
    instantiated = {
        tail_name(n.func) for n in ast.walk(sf.tree)
        if isinstance(n, ast.Call)}
    for cls in sorted(twin_classes):
        if cls not in instantiated:
            findings.append(Finding(
                "native-fallback-missing", path, table_line, cls,
                f"class-shaped twin {cls!r} is declared in "
                f"{ORACLE_TABLE} but never instantiated -- the "
                f"backend-selection fallback site is gone"))

    # direction 3b: every dispatch function calling a native symbol with
    # a function-shaped oracle must keep a guarded oracle call in its
    # own body (the degrade path)
    loaders = _loader_names(sf)
    plain_syms = {s for s in configured
                  if s in table and "." not in table[s]}
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in loaders or fn.name in plain_oracles:
            continue
        native_called: Dict[str, int] = {}
        oracle_called = False
        for n in walk_excluding_nested_defs(fn.body):
            if not isinstance(n, ast.Call):
                continue
            callee = tail_name(n.func)
            if callee in plain_syms and isinstance(n.func, ast.Attribute):
                native_called.setdefault(callee, n.lineno)
            elif callee in plain_oracles:
                oracle_called = True
        if native_called and not oracle_called:
            for sym, line in sorted(native_called.items()):
                findings.append(Finding(
                    "native-fallback-missing", path, line, sym,
                    f"function {fn.name!r} calls native symbol {sym!r} "
                    f"but no declared oracle -- the pure-Python "
                    f"fallback branch is missing (toolchain-absent "
                    f"boxes would lose this code path)"))
    return findings


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for path, sf in sorted(ctx.files.items()):
        if path == "asyncframework_tpu_torch/native_build.py":
            continue  # the build gateway itself, not a dispatch module
        if not _calls_ensure_built(sf):
            continue
        findings.extend(_check_module(path, sf))
    return findings

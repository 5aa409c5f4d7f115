"""Lint core: source-tree walk, AST cache, findings, allowlist, runner.

Counterpart of ``asyncframework_tpu/analysis/core.py``, aimed at the
PyTorch package: it lints ``asyncframework_tpu_torch/`` and
``chip_smoke.py``.  The analyzer is *static*: it parses the tree with
``ast`` and never imports the modules it checks (so a lint run cannot
trigger CUDA initialization, socket binds, or conf mutation).  The only
modules it imports are the three declaration tables the rules cross-check against
-- ``conf.py``, ``net/protocol.py``, ``metrics/registry.py`` -- all of
which are dependency-light by contract (their docstrings say so; the
lint would be the first thing to break if that regressed).
"""

from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple


@dataclass(frozen=True)
class Finding:
    """One lint violation.

    ``token`` is the stable detail key allowlist entries match against
    (a conf key, an op name, a lock name, a callee) -- line numbers
    drift, tokens do not."""

    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    token: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "token": self.token, "message": self.message}


@dataclass(frozen=True)
class Allow:
    """One suppression: rule + path glob + token (exact or ``*``) and a
    MANDATORY human reason.  Reasons are rendered by ``--list-allow`` and
    the ARCHITECTURE.md catalog; an empty reason fails the lint run
    itself."""

    rule: str
    path: str
    token: str
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.rule == f.rule
                and fnmatch.fnmatch(f.path, self.path)
                and (self.token == "*" or self.token == f.token))


class SourceFile:
    """One parsed file: source text, AST, and a parent map (ast has no
    parent links; the thread rule needs them to see how a Thread(...)
    call is used)."""

    def __init__(self, root: str, relpath: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.abspath = os.path.join(root, relpath)
        with open(self.abspath, "r", encoding="utf-8") as f:
            self.source = f.read()
        self.tree = ast.parse(self.source, filename=self.relpath)
        self._parents: Optional[Dict[int, ast.AST]] = None

    def parents(self) -> Dict[int, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[id(child)] = node
        return self._parents

    def parent_of(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents().get(id(node))


#: directories under the repo root that are linted (tests/ hosts the
#: deliberately-bad rule fixtures, so it is out of scope by design; the
#: JAX package, its launchers and examples are linted by its own copy)
LINT_DIRS = ("asyncframework_tpu_torch",)
LINT_FILES = ("chip_smoke.py",)
_SKIP_DIRS = {"__pycache__", ".git", "native", "_build", "csrc"}

#: the package every rule's path constants live under
PKG = "asyncframework_tpu_torch"

#: modules a rule checks that the package does not have yet, each with
#: the ROADMAP item that ports it.  While a file is absent its rule skips
#: it; :func:`pending_paths` lists the skips, and the CLI prints them, so
#: no obligation is dropped without a word.
PENDING_PATHS: Dict[str, str] = {
    PKG + "/streaming/log_net.py": "A10",
}


def pending_paths(root: str) -> List[Tuple[str, str]]:
    """``(path, ROADMAP item)`` of each declared module absent under
    ``root`` -- the obligations the rules skip until it is ported."""
    return [(p, item) for p, item in sorted(PENDING_PATHS.items())
            if not os.path.isfile(os.path.join(root, p))]


def iter_lint_paths(root: str) -> Iterable[str]:
    """Repo-relative paths of every linted source file."""
    for base in LINT_DIRS:
        basedir = os.path.join(root, base)
        if not os.path.isdir(basedir):
            continue
        for dirpath, dirnames, filenames in os.walk(basedir):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                if fn.endswith(".py"):
                    yield rel
    for fn in LINT_FILES:
        if os.path.isfile(os.path.join(root, fn)):
            yield fn


class LintContext:
    """Shared state for one lint run: parsed files + declaration tables."""

    def __init__(self, root: str, paths: Optional[List[str]] = None):
        self.root = os.path.abspath(root)
        self.files: Dict[str, SourceFile] = {}
        self.parse_errors: List[Finding] = []
        for rel in (paths if paths is not None
                    else iter_lint_paths(self.root)):
            try:
                sf = SourceFile(self.root, rel)
            except (SyntaxError, UnicodeDecodeError) as e:
                self.parse_errors.append(Finding(
                    "parse-error", rel.replace(os.sep, "/"),
                    getattr(e, "lineno", 0) or 0, "syntax",
                    f"cannot parse: {e}"))
                continue
            self.files[sf.relpath] = sf

    def get(self, relpath: str) -> Optional[SourceFile]:
        return self.files.get(relpath)


RuleFn = Callable[[LintContext], List[Finding]]


def _rules() -> Dict[str, RuleFn]:
    # imported lazily so `analysis.core` stays importable from fixtures
    # that construct a LintContext over a single snippet
    from asyncframework_tpu_torch.analysis import (
        rules_conf,
        rules_locks,
        rules_metrics,
        rules_native,
        rules_protocol,
        rules_threads,
    )

    return {
        "conf": rules_conf.check,
        "protocol": rules_protocol.check,
        "locks": rules_locks.check,
        "threads": rules_threads.check,
        "metrics": rules_metrics.check,
        "native": rules_native.check,
    }


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Tuple[Finding, Allow]] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict[str, object]:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [
                {**f.to_json(), "reason": a.reason}
                for f, a in self.suppressed
            ],
        }


def run_lint(root: str, rules: Optional[List[str]] = None,
             allowlist: Optional[List[Allow]] = None,
             paths: Optional[List[str]] = None) -> LintResult:
    """Run the rule set over the tree at ``root``.

    ``rules``: subset of rule-group names (None = all).  ``allowlist``:
    None = the repo's declared list (``analysis/allowlist.py``); pass
    ``[]`` to see raw findings.  ``paths``: explicit repo-relative file
    list (fixtures); None = the standard tree walk."""
    if allowlist is None:
        from asyncframework_tpu_torch.analysis.allowlist import ALLOWLIST
        allowlist = list(ALLOWLIST)
    for a in allowlist:
        if not str(a.reason or "").strip():
            raise ValueError(
                f"allowlist entry {a.rule}:{a.path}:{a.token} has no "
                f"reason -- every suppression carries one (policy)")

    ctx = LintContext(root, paths=paths)
    result = LintResult(files_scanned=len(ctx.files))
    raw: List[Finding] = list(ctx.parse_errors)
    table = _rules()
    for name, fn in table.items():
        if rules is not None and name not in rules:
            continue
        raw.extend(fn(ctx))
    raw.sort(key=lambda f: (f.path, f.line, f.rule, f.token))
    for f in raw:
        allow = next((a for a in allowlist if a.matches(f)), None)
        if allow is not None:
            result.suppressed.append((f, allow))
        else:
            result.findings.append(f)
    return result


# ----------------------------------------------------------- AST helpers
def const_str(node: ast.AST) -> Optional[str]:
    """The string value of a Constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def tail_name(node: ast.AST) -> str:
    """The final identifier of a Name/Attribute chain ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def walk_excluding_nested_defs(body: Iterable[ast.stmt]) -> Iterable[ast.AST]:
    """Walk statements lexically, NOT descending into nested function /
    lambda bodies (code in them runs later, outside the enclosing
    ``with``)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue  # its body runs later, outside the hold
        yield node
        stack.extend(ast.iter_child_nodes(node))

"""Conf-key discipline: every ``async.*`` read declared, every declared
knob read.

The ``global_conf()`` lost-write footgun and the connection thread-leak
were both silent-conf-drift bugs: a knob read that nothing declared (so nothing
documented, defaulted, or CLI-exposed it) or a declared knob that
nothing read (so operators tuned a no-op).  ~66 distinct conf keys are
now read across the tree; this rule pins them to ``conf.py``'s
ConfigEntry registry:

- ``conf-undeclared-read``: an ``"async.*"`` string literal used
  anywhere outside ``conf.py`` that is not a registered key;
- ``conf-dead-knob``: a registered key that is neither referenced by
  its entry constant (``conf.TRACE_SAMPLE``) nor by its key literal
  anywhere outside ``conf.py`` (tests do not count: a knob only tests
  read is dead in production);
- ``conf-field-map``: a ``CONF_TO_FIELD`` entry whose key is not
  registered or whose field is not a ``SolverConfig`` attribute;
- ``conf-env-alias``: an ``ASYNCTPU_ASYNC*`` env-var literal that does
  not round-trip to a registered key (the alias grammar is mechanical:
  ``ASYNCTPU_`` + key upper-cased, dots to underscores -- a typo'd env
  literal silently configures nothing);
- ``conf-tunable``: the adaptive-controller actuation surface
  (``parallel/controller.py``).  Every knob the controller actuates --
  a ``CONTROLLER_TUNABLES`` key or an ``_actuate("<key>", ...)``
  literal -- must be a registered ConfigEntry carrying ``tunable=True``
  WITH declared ``floor``/``ceiling`` bounds, and every declared
  tunable must carry both bounds.  Undeclaring a tunable (or actuating
  an undeclared key) therefore fails the lint -- a controller may only
  move knobs whose hard bounds an operator can read off conf.py.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from asyncframework_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    const_str,
    tail_name,
)

CONF_PATH = "asyncframework_tpu_torch/conf.py"
CLI_PATH = "asyncframework_tpu_torch/cli.py"
SOLVER_BASE_PATH = "asyncframework_tpu_torch/solvers/base.py"
CONTROLLER_PATH = "asyncframework_tpu_torch/parallel/controller.py"

# key segments are dot-separated and underscore-FREE: the ASYNCTPU_ env
# alias maps dots to underscores, so an underscore inside a segment
# would make the reverse mapping ambiguous -- the grammar forbids it and
# conf-key-grammar flags any declaration that violates it
_KEY_RE = re.compile(r"^async\.[a-z0-9]+(\.[a-z0-9]+)*$")
_ENV_RE = re.compile(r"^ASYNCTPU_ASYNC[A-Z0-9_]*$")


def declared_entries(ctx: LintContext) -> Dict[str, str]:
    """key -> entry constant name, parsed from conf.py's
    ``NAME = ConfigEntry("key", ...)`` assignments."""
    sf = ctx.get(CONF_PATH)
    out: Dict[str, str] = {}
    if sf is None:
        return out
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Assign) and
                isinstance(node.value, ast.Call) and
                tail_name(node.value.func) == "ConfigEntry" and
                node.value.args):
            continue
        key = const_str(node.value.args[0])
        if key is None:
            continue
        name = ""
        if node.targets and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
        out[key] = name
    return out


def declared_tunables(ctx: LintContext) -> Dict[str, "tuple[bool, bool, int]"]:
    """key -> (has_floor, has_ceiling, line) for every ConfigEntry
    declared with ``tunable=True`` (constant keyword) in conf.py."""
    sf = ctx.get(CONF_PATH)
    out: Dict[str, tuple] = {}
    if sf is None:
        return out
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and
                tail_name(node.func) == "ConfigEntry" and node.args):
            continue
        key = const_str(node.args[0])
        if key is None:
            continue
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        tn = kw.get("tunable")
        if not (isinstance(tn, ast.Constant) and tn.value is True):
            continue

        def has_bound(name):
            v = kw.get(name)
            return (isinstance(v, ast.Constant)
                    and isinstance(v.value, (int, float))
                    and not isinstance(v.value, bool))

        out[key] = (has_bound("floor"), has_bound("ceiling"), node.lineno)
    return out


def _actuated_keys(ctx: LintContext) -> List["tuple[str, int]"]:
    """(key, line) for every knob the controller actuates: the
    ``CONTROLLER_TUNABLES`` table's literal keys plus the first-arg
    string literal of every ``_actuate(...)`` call in controller.py."""
    sf = ctx.get(CONTROLLER_PATH)
    out: List[tuple] = []
    if sf is None:
        return out
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = (node.targets[0] if isinstance(node, ast.Assign)
                      and node.targets else getattr(node, "target", None))
            value = node.value
            if (target is not None and value is not None
                    and tail_name(target) == "CONTROLLER_TUNABLES"
                    and isinstance(value, ast.Dict)):
                for k in value.keys:
                    key = const_str(k)
                    if key is not None:
                        out.append((key, k.lineno))
        elif isinstance(node, ast.Call) and \
                tail_name(node.func) == "_actuate" and node.args:
            key = const_str(node.args[0])
            if key is not None:
                out.append((key, node.lineno))
    return out


def _conf_to_field(ctx: LintContext) -> Dict[str, "tuple[str, int]"]:
    """CONF_TO_FIELD key -> (field, line) from cli.py's dict literal."""
    sf = ctx.get(CLI_PATH)
    out: Dict[str, tuple] = {}
    if sf is None:
        return out
    for node in ast.walk(sf.tree):
        # both plain and ANNOTATED assignment: the real cli.py declares
        # `CONF_TO_FIELD: Dict[str, str] = {...}` (ast.AnnAssign)
        if isinstance(node, ast.Assign) and node.targets:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        else:
            continue
        if not (tail_name(target) == "CONF_TO_FIELD" and
                isinstance(value, ast.Dict)):
            continue
        for k, v in zip(value.keys, value.values):
            key, fld = const_str(k), const_str(v)
            if key is not None and fld is not None:
                out[key] = (fld, k.lineno)
    return out


def _solver_fields(ctx: LintContext) -> Set[str]:
    """SolverConfig's declared attribute names (AnnAssign/Assign targets
    in the class body)."""
    sf = ctx.get(SOLVER_BASE_PATH)
    fields: Set[str] = set()
    if sf is None:
        return fields
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "SolverConfig":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    fields.add(stmt.target.id)
                elif isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            fields.add(t.id)
    return fields


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    entries = declared_entries(ctx)
    declared_keys = set(entries)
    entry_names = {n for n in entries.values() if n}

    # every async.* literal read + every entry-constant reference,
    # anywhere outside conf.py
    read_keys: Set[str] = set()
    referenced_names: Set[str] = set()
    for path, sf in ctx.files.items():
        is_conf = path == CONF_PATH
        for node in ast.walk(sf.tree):
            s = const_str(node)
            if s is not None and _KEY_RE.match(s):
                if not is_conf:
                    read_keys.add(s)
                    if s not in declared_keys:
                        findings.append(Finding(
                            "conf-undeclared-read", path, node.lineno, s,
                            f"conf key {s!r} is read here but not "
                            f"declared in conf.py -- register a "
                            f"ConfigEntry (default + doc) or drop the "
                            f"read"))
                continue
            if is_conf:
                continue
            name = tail_name(node)
            if name in entry_names and isinstance(
                    node, (ast.Name, ast.Attribute)):
                referenced_names.add(name)

    # dead knobs: declared but neither key literal nor constant is
    # referenced anywhere in the linted tree outside conf.py
    conf_sf = ctx.get(CONF_PATH)
    decl_lines: Dict[str, int] = {}
    if conf_sf is not None:
        for node in ast.walk(conf_sf.tree):
            if (isinstance(node, ast.Call) and
                    tail_name(node.func) == "ConfigEntry" and node.args):
                key = const_str(node.args[0])
                if key is not None:
                    decl_lines[key] = node.lineno
    for key, name in sorted(entries.items()):
        if not _KEY_RE.match(key):
            findings.append(Finding(
                "conf-key-grammar", CONF_PATH, decl_lines.get(key, 0),
                key,
                f"declared key {key!r} violates the key grammar "
                f"(lowercase dot-separated segments, no underscores) "
                f"-- an underscore-bearing segment makes the "
                f"ASYNCTPU_ env-alias reverse mapping ambiguous"))
            continue
        if key in read_keys or (name and name in referenced_names):
            continue
        findings.append(Finding(
            "conf-dead-knob", CONF_PATH, decl_lines.get(key, 0), key,
            f"declared knob {key!r} ({name or 'unnamed'}) is never read "
            f"outside conf.py -- wire it up or delete the declaration"))

    # CONF_TO_FIELD consistency
    fields = _solver_fields(ctx)
    for key, (fld, line) in sorted(_conf_to_field(ctx).items()):
        if key not in declared_keys:
            findings.append(Finding(
                "conf-field-map", CLI_PATH, line, key,
                f"CONF_TO_FIELD maps unregistered key {key!r}"))
        if fields and fld not in fields:
            findings.append(Finding(
                "conf-field-map", CLI_PATH, line, key,
                f"CONF_TO_FIELD maps {key!r} to SolverConfig.{fld}, "
                f"which does not exist"))

    # tunable discipline: every declared tunable carries both bounds,
    # and the controller actuates ONLY declared tunables
    tunables = declared_tunables(ctx)
    for key, (has_floor, has_ceiling, line) in sorted(tunables.items()):
        if not (has_floor and has_ceiling):
            findings.append(Finding(
                "conf-tunable", CONF_PATH, line, key,
                f"tunable knob {key!r} must declare numeric floor AND "
                f"ceiling bounds (the controller clamps every decision "
                f"to them; a boundless tunable is unactuatable)"))
    for key, line in _actuated_keys(ctx):
        if key not in tunables:
            findings.append(Finding(
                "conf-tunable", CONTROLLER_PATH, line, key,
                f"controller actuates {key!r}, which is not declared "
                f"tunable=True in conf.py -- the controller may only "
                f"move declared tunables (add the marker + bounds or "
                f"drop the actuation)"))

    # env-alias grammar: ASYNCTPU_ASYNC* literals must round-trip
    for path, sf in ctx.files.items():
        for node in ast.walk(sf.tree):
            s = const_str(node)
            if s is None or not _ENV_RE.match(s):
                continue
            key = s[len("ASYNCTPU_"):].lower().replace("_", ".")
            if key not in declared_keys:
                findings.append(Finding(
                    "conf-env-alias", path, node.lineno, s,
                    f"env literal {s!r} does not alias any registered "
                    f"conf key (expected ASYNCTPU_<KEY_UPPER_WITH_"
                    f"UNDERSCORES> of a declared key; got back "
                    f"{key!r})"))
    return findings

"""Counter-family registration: the static equivalent of the
runtime audit (``tests/test_telemetry.py``'s pkgutil walk).

``metrics/registry.py`` is the ONE list of counter families; four
consumers iterate it (``reset_totals``, live-UI baselines, the sampler,
/metrics).  The runtime audit only fires when the telemetry suite runs
and only sees modules that import cleanly in that environment; this rule
fires on every lint of every tree state:

- ``metrics-unregistered-totals``: a public module-level ``*_totals``
  function in the package that no ``CounterFamily`` row references --
  the "second run inherits counts" bug waiting to happen;
- ``metrics-dangling-family``: a registry row whose (module, attr)
  provider does not exist in the tree (a rename that silently emptied a
  dashboard section);
- ``metrics-series-family``: a time-series key written anywhere (a
  ``register_source`` family, a ``record_flat`` prefix, a dotted
  ``record`` literal) must parse as ``family.metric`` with the family
  declared in ``metrics/registry.py`` (counter family or
  ``DYNAMIC_SERIES_FAMILIES``).  An undeclared family is a series the
  SLO grammar, the per-run dashboards, and the cluster observer's
  scrape surface all silently cannot see.
- ``prof-zone``: the same discipline for the continuous-profiling
  plane's zone table (``metrics/profiler.py`` ``ZONES``): every zone
  literal an accumulator or classifier uses (``zone(...)``,
  ``zone_ns(...)``, ``zoned(...)``, ``wrap_dispatch(fn, zone)``, a
  ``_zrule(...)`` classifier row) must be declared there, and every
  declared zone must be attributed by at least one such site -- an
  undeclared literal is a zone no table/flamegraph/diff will ever
  show; an unattributed declaration is a dashboard row that can never
  light up.

Aggregator functions that roll other families up (``registry.all_totals``
itself, ``net/retry.retry_totals`` inside ``net_totals``) are suppressed
in ``analysis/allowlist.py`` with their reasons -- the same exemptions
the runtime audit documents.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from asyncframework_tpu_torch.analysis.core import (
    Finding,
    LintContext,
    const_str,
    tail_name,
)

PKG_PREFIX = "asyncframework_tpu_torch/"

#: the series-key grammar the sampler's ``<family>.<key>`` naming
#: produces: only literals shaped like this are series keys (other
#: ``.record(...)`` APIs -- dedup windows, calibrators -- take dicts or
#: numbers and never match)
_SERIES_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[A-Za-z0-9_.]+)+$")
_FAMILY_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _module_name(path: str) -> str:
    mod = path[:-3] if path.endswith(".py") else path
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _registered(ctx: LintContext) -> Set[Tuple[str, str]]:
    """(module, attr) provider pairs from metrics/registry.py."""
    from asyncframework_tpu_torch.metrics import registry

    out: Set[Tuple[str, str]] = set()
    for fam in registry.families().values():
        out.add((fam.module, fam.totals_attr))
        out.add((fam.module, fam.reset_attr))
    return out


def _declared_series_families() -> Set[str]:
    from asyncframework_tpu_torch.metrics import registry

    return set(registry.series_families())


def _check_series_keys(ctx: LintContext) -> List[Finding]:
    """metrics-series-family: every literal series key written anywhere
    must carry a declared family."""
    declared = _declared_series_families()
    findings: List[Finding] = []
    for path, sf in ctx.files.items():
        if path == "asyncframework_tpu_torch/metrics/registry.py":
            continue  # the declaration table itself
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            callee = tail_name(node.func)
            lit = const_str(node.args[0])
            if lit is None:
                continue
            family = None
            if callee == "register_source":
                if _FAMILY_RE.match(lit):
                    family = lit
            elif callee == "record_flat":
                if _FAMILY_RE.match(lit):
                    family = lit
            elif callee == "record":
                if _SERIES_KEY_RE.match(lit):
                    family = lit.split(".", 1)[0]
            if family is None or family in declared:
                continue
            findings.append(Finding(
                "metrics-series-family", path, node.lineno, family,
                f"series key {lit!r} writes undeclared family "
                f"{family!r} -- declare it in metrics/registry.py (a "
                f"CounterFamily or DYNAMIC_SERIES_FAMILIES) so the SLO "
                f"grammar, dashboards, and the cluster observer can "
                f"see it"))
    return findings


PROF_PATH = PKG_PREFIX + "metrics/profiler.py"

#: callee tail -> index of the positional arg holding the zone literal
_ZONE_CALLS = {"zone": 0, "zone_ns": 0, "zoned": 0, "wrap_dispatch": 1}


def _declared_zones(ctx: LintContext) -> Tuple[Set[str], int]:
    """The ``ZONES`` tuple from metrics/profiler.py's AST (static, like
    every other declaration-table read here) + its line number."""
    sf = ctx.get(PROF_PATH)
    if sf is None:
        return set(), 0
    for node in sf.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == "ZONES"
                   for t in targets):
            continue
        value = node.value
        if isinstance(value, (ast.Tuple, ast.List)):
            zones = {z for z in (const_str(e) for e in value.elts)
                     if z is not None}
            return zones, node.lineno
    return set(), 0


def _check_prof_zones(ctx: LintContext) -> List[Finding]:
    """prof-zone, both directions: undeclared literal at an attribution
    site / declared zone with no attribution site anywhere."""
    declared, zones_line = _declared_zones(ctx)
    if not declared:
        return []  # no zone table in this tree (fixture snippets)
    findings: List[Finding] = []
    attributed: Set[str] = set()
    for path, sf in ctx.files.items():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = tail_name(node.func)
            if callee in _ZONE_CALLS:
                idx = _ZONE_CALLS[callee]
                if len(node.args) <= idx:
                    continue
                lit = const_str(node.args[idx])
            elif callee == "_zrule":
                lit = const_str(node.args[-1]) if node.args else None
            else:
                continue
            if lit is None:
                continue
            if callee in ("zone", "zone_ns") and "." not in lit \
                    and lit not in declared:
                # ``zone()`` is a common name; a dotless literal that is
                # not a declared zone is some other API's first arg
                # (e.g. a k8s zone selector), not a profiler site
                continue
            if lit not in declared:
                findings.append(Finding(
                    "prof-zone", path, node.lineno, lit,
                    f"zone literal {lit!r} at a profiler attribution "
                    f"site ({callee}) is not declared in the ZONES "
                    f"table ({PROF_PATH}) -- no table, flamegraph, or "
                    f"diff will ever show it"))
            else:
                attributed.add(lit)
    for z in sorted(declared - attributed):
        findings.append(Finding(
            "prof-zone", PROF_PATH, zones_line, z,
            f"declared zone {z!r} has no attribution site (zone/"
            f"zone_ns/zoned/wrap_dispatch/_zrule) anywhere in the "
            f"tree -- a dashboard row that can never light up"))
    return findings


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = _check_series_keys(ctx)
    findings.extend(_check_prof_zones(ctx))
    registered = _registered(ctx)

    providers: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for path, sf in ctx.files.items():
        if not path.startswith(PKG_PREFIX):
            continue
        mod = _module_name(path)
        for node in sf.tree.body:  # module level only, like the pkgutil walk
            if isinstance(node, ast.FunctionDef) and \
                    node.name.endswith("_totals") and \
                    not node.name.startswith(("_", "reset")):
                providers[(mod, node.name)] = (path, node.lineno)

    for (mod, attr), (path, line) in sorted(providers.items()):
        if (mod, attr) in registered:
            continue
        # a provider re-exported via a package __init__ may be registered
        # under the package name (net_totals lives in net/__init__.py)
        if any(rm.startswith(mod) or mod.startswith(rm)
               for rm, ra in registered if ra == attr):
            continue
        findings.append(Finding(
            "metrics-unregistered-totals", path, line, attr,
            f"public counter provider {mod}.{attr} is not referenced by "
            f"any CounterFamily in metrics/registry.py -- register it "
            f"(wires reset_totals, live-UI baselines, the sampler and "
            f"/metrics) or rename it private"))

    # dangling registry rows: provider module/attr must exist in-tree
    known_paths = set(ctx.files)
    for (mod, attr) in sorted(registered):
        relpath = mod.replace(".", "/")
        candidates = (relpath + ".py", relpath + "/__init__.py")
        sf = next((ctx.files[c] for c in candidates if c in known_paths),
                  None)
        if sf is None:
            continue  # outside lint scope
        present = any(
            (isinstance(n, ast.FunctionDef) and n.name == attr) or
            (isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == attr
                for t in n.targets)) or
            (isinstance(n, (ast.Import, ast.ImportFrom)) and any(
                (a.asname or a.name) == attr for a in n.names))
            for n in sf.tree.body)
        if not present:
            findings.append(Finding(
                "metrics-dangling-family", "asyncframework_tpu_torch/metrics/"
                "registry.py", 1, f"{mod}.{attr}",
                f"registry references provider {mod}.{attr}, which does "
                f"not exist at module level in {sf.relpath}"))
    return findings

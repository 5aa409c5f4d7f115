"""The port's lint (``asyncframework_tpu_torch/analysis/``) against the JAX
package's own lint suite, and on the port's tree.

- The JAX package's cases (``tests/test_analysis.py``: every rule's bad
  fixture, the clean tree per rule, the acceptance mutations, the
  allowlist policy and the lock-order detector) run here a second time
  with the modules they test swapped for the port's copies (the reference
  module's globals by monkeypatch).  Fixture trees keep their layout with
  the package directory renamed (``asyncframework_tpu/`` becomes
  ``asyncframework_tpu_torch/``), and the mutations edit a copy of the
  port's own ``parallel/ps_dcn.py``.  The cases that name the JAX
  package's tree (its ``cli.py``, ``bin/async-lint``, its allowlist, its
  controller, replication stream, relay node and relay source) are
  rewritten for the port beside it, under the same name.
- The port's own: the CLI (``python -m
  asyncframework_tpu_torch.analysis.cli``) clean and listing the skipped
  modules with their items; the allowlist is exactly the retargeted
  reference entries, each with a reason (no refused op is left in it);
  no ``proto-fence-gate`` and no SETMAP finding before
  the allowlist; every ``NotImplementedError`` of the port names an open
  ROADMAP item.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

import test_analysis as ref_lint
from asyncframework_tpu_torch.analysis import core as t_core
from asyncframework_tpu_torch.analysis import (
    rules_conf as t_rules_conf,
    rules_locks as t_rules_locks,
    rules_metrics as t_rules_metrics,
    rules_protocol as t_rules_protocol,
    rules_threads as t_rules_threads,
)
from asyncframework_tpu_torch.analysis.allowlist import ALLOWLIST
from asyncframework_tpu_torch.analysis.core import (
    Allow,
    LintContext,
    run_lint,
)
from asyncframework_tpu_torch.net import lockwatch as t_lockwatch
from asyncframework_tpu_torch.net import protocol as t_protocol

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "asyncframework_tpu_torch"
PS_DCN = os.path.join(REPO, PKG, "parallel", "ps_dcn.py")


def _port_path(rel: str) -> str:
    """A reference fixture's path, in the port's package directory."""
    if rel.startswith("asyncframework_tpu/"):
        return PKG + rel[len("asyncframework_tpu"):]
    return rel


_REF_MAKE_TREE = ref_lint.make_tree


def _make_tree(tmp_path, files):
    """``tests/test_analysis.py::make_tree`` with the package directory
    renamed."""
    return _REF_MAKE_TREE(tmp_path,
                          {_port_path(k): v for k, v in files.items()})


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    """Point the reference module's globals at the port's analysis."""
    for name, value in dict(
            lint_core=t_core, rules_conf=t_rules_conf,
            rules_locks=t_rules_locks, rules_metrics=t_rules_metrics,
            rules_protocol=t_rules_protocol, rules_threads=t_rules_threads,
            Allow=Allow, LintContext=LintContext, run_lint=run_lint,
            lockwatch=t_lockwatch, protocol=t_protocol,
            make_tree=_make_tree, PS_DCN_REAL=PS_DCN).items():
        monkeypatch.setattr(ref_lint, name, value)
    yield


@pytest.fixture(scope="module")
def whole_tree():
    """One lint of the port's whole tree, read by every test below that
    reads its findings (its raw findings are its findings and its
    suppressed ones)."""
    return run_lint(REPO)


def _ctx(tmp_path, files):
    root, paths = _make_tree(tmp_path, files)
    return LintContext(root, paths=paths)


def _tokens(findings, rule):
    return sorted(f.token for f in findings if f.rule == rule)


# ------------------------------- tests/test_analysis.py on the port
class TestConfRuleOnThePort(ref_lint.TestConfRule):
    def test_real_controller_surface_is_declared(self):
        """The reference case on the port's controller and conf: every
        tunable it actuates is a registered tunable ConfigEntry with
        bounds."""
        from asyncframework_tpu_torch.parallel.controller import (
            CONTROLLER_TUNABLES,
        )

        ctx = LintContext(REPO)
        tunables = t_rules_conf.declared_tunables(ctx)
        actuated = {k for k, _line in t_rules_conf._actuated_keys(ctx)}
        assert actuated, "controller actuation surface not parsed"
        assert set(CONTROLLER_TUNABLES) <= actuated
        for key in actuated:
            assert key in tunables, key
            has_floor, has_ceiling, _line = tunables[key]
            assert has_floor and has_ceiling, key

    def test_real_controller_is_declared_pending(self):
        """The controller is ported (ROADMAP A6b.4): its module is no
        longer a pending path, and the conf-tunable rule reads it."""
        assert t_rules_conf.CONTROLLER_PATH not in t_core.PENDING_PATHS
        assert os.path.isfile(os.path.join(REPO,
                                           t_rules_conf.CONTROLLER_PATH))
        assert t_rules_conf.CONTROLLER_PATH not in dict(
            t_core.pending_paths(REPO))


class TestProtocolRuleOnThePort(ref_lint.TestProtocolRule):
    def test_deleting_relay_fence_admission_fails_lint(self, tmp_path):
        """The reference case on the port's relay node: its dispatch runs
        fencing admission on every fence-stamped relay verb, and deleting
        the admission call is a ``proto-fence-gate`` finding."""
        rel = f"{PKG}/relaycast/node.py"
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        mutated = src.replace(
            'if op == "RELAY_FETCH":\n'
            '            if not self._fence_reject(conn, header):\n'
            '                self._handle_fetch(conn, header)\n',
            'if op == "RELAY_FETCH":\n'
            '            self._handle_fetch(conn, header)\n', 1)
        assert mutated != src
        toks = _tokens(t_rules_protocol.check(
            _ctx(tmp_path, {rel: mutated})), "proto-fence-gate")
        assert "RELAY_FETCH" in toks
        assert _tokens(t_rules_protocol.check(
            _ctx(tmp_path / "clean", {rel: src})), "proto-fence-gate") == []

    def test_deleting_relay_client_ep_stamp_fails_lint(self, tmp_path):
        """The reference case on the port's relay source:
        ``RelaySource._stamped`` is the relay plane's ep-stamp choke
        point, pinned like ``PSClient._proc_hdr``."""
        rel = f"{PKG}/relaycast/source.py"
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        i = src.index("def _stamped")
        j = src.index('hdr["ep"] = self.node.epoch', i)
        mutated = (src[:j] + "pass"
                   + src[j + len('hdr["ep"] = self.node.epoch'):])
        toks = _tokens(t_rules_protocol.check(
            _ctx(tmp_path, {rel: mutated})), "proto-fence-gate")
        assert toks == ["ep-stamp"]
        assert _tokens(t_rules_protocol.check(
            _ctx(tmp_path / "clean", {rel: src})), "proto-fence-gate") == []

    def test_deleting_repl_stream_ep_stamp_fails_lint(self, tmp_path):
        """The reference case on the port's replication stream:
        ``ReplicationStream._stamped`` is the replication plane's
        ep-stamp choke point."""
        rel = f"{PKG}/parallel/replication.py"
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        i = src.index("def _stamped")
        j = src.index('hdr["ep"] = self.ps.epoch', i)
        mutated = (src[:j] + "pass"
                   + src[j + len('hdr["ep"] = self.ps.epoch'):])
        toks = _tokens(t_rules_protocol.check(
            _ctx(tmp_path, {rel: mutated})), "proto-fence-gate")
        assert toks == ["ep-stamp"]
        assert _tokens(t_rules_protocol.check(
            _ctx(tmp_path / "clean", {rel: src})), "proto-fence-gate") == []


class TestLockRuleOnThePort(ref_lint.TestLockRule):
    def test_allowlist_tokens_are_lock_scoped(self):
        """The reference case on the port's paths and allowlist."""
        hot = t_core.Finding(
            "lock-blocking-call", f"{PKG}/parallel/ps_dcn.py", 1,
            "_lock:connect", "socket .connect() under the model lock")
        assert not any(a.matches(hot) for a in ALLOWLIST)
        win = t_core.Finding(
            "lock-blocking-call", f"{PKG}/parallel/ps_dcn.py", 1,
            "_win_lock:connect", "push-window reconnect")
        assert any(a.matches(win) for a in ALLOWLIST)


class TestThreadRuleOnThePort(ref_lint.TestThreadRule):
    pass


class TestMetricsRuleOnThePort(ref_lint.TestMetricsRule):
    def test_series_family_mutation_deleting_declaration_fails(
            self, monkeypatch):
        """The reference case on the port's registry: un-declare the
        ``ps`` dynamic family -> the port's PS register_source site
        becomes a finding."""
        from asyncframework_tpu_torch.metrics import registry

        full = registry.series_families()
        mutated = tuple(f for f in full if f != "ps")
        monkeypatch.setattr(registry, "series_families", lambda: mutated)
        result = run_lint(REPO, rules=["metrics"])
        toks = _tokens(result.findings, "metrics-series-family")
        assert "ps" in toks, [f.format() for f in result.findings]
        assert any("ps_dcn" in f.path for f in result.findings
                   if f.rule == "metrics-series-family")


class TestProfZoneRuleOnThePort(ref_lint.TestProfZoneRule):
    pass


class TestAllowlistPolicyOnThePort(ref_lint.TestAllowlistPolicy):
    def test_repo_allowlist_entries_all_carry_reasons(self):
        assert ALLOWLIST and all(a.reason.strip() for a in ALLOWLIST)


class TestWholeTreeSelfLintOnThePort(ref_lint.TestWholeTreeSelfLint):
    def test_whole_tree_self_lints_clean(self, whole_tree):
        """Every rule over the port's tree (the package and
        ``chip_smoke.py``), zero findings beyond the allowlist."""
        result = whole_tree
        assert result.ok, "\n".join(f.format() for f in result.findings)
        assert result.files_scanned > 90
        assert all(f.path.startswith(PKG + "/") or f.path == "chip_smoke.py"
                   for f, _a in result.suppressed)

    def test_cli_json_clean_and_machine_readable(self):
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.analysis.cli", "--json"],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        payload = json.loads(proc.stdout)
        assert payload["ok"] is True
        assert payload["findings"] == []
        for s in payload["suppressed"]:
            assert s["reason"].strip()
        assert {p["path"]: p["item"] for p in payload["pending"]} == dict(
            t_core.pending_paths(REPO))

    def test_deleting_a_conf_declaration_fails_lint(self, tmp_path):
        """Drop ONE ConfigEntry declaration from a copy of the port's
        conf.py next to the real ``cli.py`` -> its literal read of that
        key (the cluster defaults, which ``tools/ps_child.py`` takes from
        the CLI) becomes an undeclared read."""
        with open(os.path.join(REPO, PKG, "conf.py")) as f:
            conf_src = f.read()
        with open(os.path.join(REPO, PKG, "cli.py")) as f:
            child_src = f.read()
        target = re.search(r'PULL_MODE = ConfigEntry\(\n(?:.*\n)*?.*\)\n',
                           conf_src).group(0)
        assert '"async.pull.mode"' in target
        ctx = _ctx(tmp_path, {
            f"{PKG}/conf.py": conf_src.replace(target, ""),
            f"{PKG}/cli.py": child_src,
        })
        toks = _tokens(t_rules_conf.check(ctx), "conf-undeclared-read")
        assert "async.pull.mode" in toks


class TestLockOrderDetectorOnThePort(ref_lint.TestLockOrderDetector):
    pass


# ------------------------------------------- the entry points on the lint
def _real_src(*parts):
    with open(os.path.join(REPO, PKG, *parts)) as f:
        return f.read()


def test_the_entry_points_are_linted():
    """The CLI, the launcher and the deploy modules are in the linted
    tree and lint clean with the rest."""
    paths = set(t_core.iter_lint_paths(REPO))
    want = {f"{PKG}/cli.py", f"{PKG}/cluster.py"} | {
        f"{PKG}/deploy/{m}.py"
        for m in ("__init__", "client", "leader", "master", "worker")}
    assert want <= paths


def test_deleting_taw_next_to_the_ports_cli_fails_lint(tmp_path):
    """The JAX package's acceptance mutation on the port's ``cli.py``:
    drop ``async.taw``'s declaration from a copy of conf.py next to the
    real CLI -> its ``CONF_TO_FIELD`` read becomes an undeclared read."""
    conf_src = _real_src("conf.py")
    target = ('TAW = ConfigEntry("async.taw", 2**31 - 1, int, '
              '"Staleness bound tau.")')
    assert target in conf_src
    ctx = _ctx(tmp_path, {f"{PKG}/conf.py": conf_src.replace(target, ""),
                          f"{PKG}/cli.py": _real_src("cli.py")})
    assert "async.taw" in _tokens(t_rules_conf.check(ctx),
                                  "conf-undeclared-read")
    clean = _ctx(tmp_path / "clean", {f"{PKG}/conf.py": conf_src,
                                      f"{PKG}/cli.py": _real_src("cli.py"),
                                      f"{PKG}/solvers/base.py":
                                          _real_src("solvers", "base.py")})
    assert _tokens(t_rules_conf.check(clean), "conf-field-map") == []


def test_a_cli_field_map_entry_without_its_field_fails_lint(tmp_path):
    """A ``CONF_TO_FIELD`` entry naming no ``SolverConfig`` field (here
    ``async.pipeline.depth``'s field renamed) is a ``conf-field-map``
    finding on the port's CLI."""
    cli_src = _real_src("cli.py")
    old = '"async.pipeline.depth": "pipeline_depth",'
    assert old in cli_src
    ctx = _ctx(tmp_path, {
        f"{PKG}/conf.py": _real_src("conf.py"),
        f"{PKG}/solvers/base.py": _real_src("solvers", "base.py"),
        f"{PKG}/cli.py": cli_src.replace(
            old, '"async.pipeline.depth": "pipe_depth",')})
    assert _tokens(t_rules_conf.check(ctx), "conf-field-map") == [
        "async.pipeline.depth"]


@pytest.mark.parametrize("mutation", ["hand_rolled", "deleted"])
def test_the_ports_master_derives_its_dedup_set(tmp_path, mutation):
    """The master's ``_MUTATING_OPS`` must come from the protocol table:
    a hand-rolled set, or none, fails the lint on a copy of the port's
    ``deploy/master.py``; the real file is clean."""
    src = _real_src("deploy", "master.py")
    old = "_MUTATING_OPS = _protocol.dedup_gated_ops(_protocol.MASTER)"
    assert old in src
    new = ('_MUTATING_OPS = frozenset({"SUBMIT_APP"})'
           if mutation == "hand_rolled" else "_UNUSED = None")
    ctx = _ctx(tmp_path, {f"{PKG}/deploy/master.py": src.replace(old, new)})
    assert _tokens(t_rules_protocol.check(ctx), "proto-dedup-gate") == [
        t_protocol.MASTER]
    clean = _ctx(tmp_path / "clean", {f"{PKG}/deploy/master.py": src})
    assert _tokens(t_rules_protocol.check(clean), "proto-dedup-gate") == []


# ------------------------------------------------------- the port's own
def _real_ps_src():
    with open(PS_DCN) as f:
        return f.read()


def _protocol_findings(tmp_path, ps_src):
    return t_rules_protocol.check(
        _ctx(tmp_path, {f"{PKG}/parallel/ps_dcn.py": ps_src}))


def test_rules_check_the_ports_tables_and_paths():
    assert t_core.LINT_DIRS == (PKG,) and t_core.LINT_FILES == (
        "chip_smoke.py",)
    assert t_rules_protocol.protocol is t_protocol
    for path in (t_rules_conf.CONF_PATH, t_rules_protocol.PS_DCN_PATH,
                 t_rules_protocol.FAULTS_PATH, t_rules_metrics.PROF_PATH):
        assert path.startswith(PKG + "/") and os.path.isfile(
            os.path.join(REPO, path)), path
    paths = set(t_core.iter_lint_paths(REPO))
    assert "chip_smoke.py" in paths and "bench.py" not in paths
    assert not any(p.startswith("asyncframework_tpu/") for p in paths)


def test_pending_paths_are_skipped_by_name_and_item(whole_tree, monkeypatch,
                                                    capsys):
    """Each module a rule names that the port lacks is declared with its
    ROADMAP item, reported by the CLI, and skipped without a crash.  The
    CLI renders the module's one lint of the tree (its subprocess run is
    ``test_cli_json_clean_and_machine_readable``)."""
    from asyncframework_tpu_torch.analysis import cli as t_cli

    pending = dict(t_core.pending_paths(REPO))
    assert pending == {
        f"{PKG}/streaming/log_net.py": "A10",
    }
    rule_paths = {t_rules_conf.CLI_PATH, t_rules_conf.CONTROLLER_PATH,
                  *t_rules_protocol.FENCE_SERVER_PATHS,
                  *t_rules_protocol.FENCE_CLIENT_STAMPS}
    # the entry points (cli.py, deploy/master.py) and the relaycast
    # plane are linted since they were ported
    ported = {t_rules_protocol.PS_DCN_PATH, t_rules_conf.CONTROLLER_PATH,
              f"{PKG}/parallel/replication.py", t_rules_conf.CLI_PATH,
              f"{PKG}/relaycast/node.py", f"{PKG}/relaycast/source.py"}
    assert ported <= rule_paths
    assert set(pending) >= rule_paths - ported
    assert not set(pending) & ported
    monkeypatch.setattr(t_core, "run_lint", lambda *_a, **_k: whole_tree)
    rc = t_cli.main(["--root", REPO])
    out = capsys.readouterr().out
    assert rc == 0, out
    for path, item in pending.items():
        assert f"{path}: not ported yet (ROADMAP {item})" in out
    assert "async-lint: clean" in out
    for path in (t_rules_conf.CLI_PATH, f"{PKG}/deploy/master.py",
                 f"{PKG}/relaycast/node.py", f"{PKG}/relaycast/source.py"):
        assert os.path.isfile(os.path.join(REPO, path))
        assert f"{path}: not ported yet" not in out


def test_allowlist_is_the_retargeted_reference_and_the_refused_ops():
    from asyncframework_tpu.analysis.allowlist import ALLOWLIST as REF

    retargeted = {(a.rule, _port_path(a.path), a.token) for a in REF
                  if os.path.exists(os.path.join(REPO, _port_path(a.path)))}
    mine = {(a.rule, a.path, a.token): a.reason for a in ALLOWLIST}
    # the refused ops (PROMOTE, REPL_APPEND, REPL_SYNC, SUBSCRIBE) were
    # its last entries of its own: every op of the wire is handled now
    assert set(mine) == retargeted
    assert not any(rule == "proto-unhandled-op" for rule, _p, _t in mine)
    assert all(reason.strip() for reason in mine.values())


def test_no_fence_gate_or_setmap_finding_before_the_allowlist(whole_tree):
    raw = {(f.rule, f.token) for f in whole_tree.findings} | {
        (f.rule, f.token) for f, _allow in whole_tree.suppressed}
    assert not any(rule == "proto-fence-gate" for rule, _t in raw), raw
    assert ("proto-unhandled-op", "SETMAP") not in raw
    # PROMOTE, REPL_APPEND, REPL_SYNC and SUBSCRIBE are handled now
    assert {t for r, t in raw if r == "proto-unhandled-op"} == set()


@pytest.mark.parametrize("mutation", ["dedup", "ep_stamp", "fence_push"])
def test_mutations_of_the_ports_ps_dcn_fail_the_lint(tmp_path, mutation):
    """The acceptance mutations on a copy of the port's ``ps_dcn.py``:
    dropping the PUSH dedup gate, the client's ``ep`` stamp or the PUSH
    fence admission each fail the lint naming the invariant; the
    unmutated copy is clean for both rules."""
    src = _real_ps_src()
    if mutation == "dedup":
        mutated = src.replace("cached = self._dedup.check(header)",
                              "cached = None", 1)
        rule, want = "proto-dedup-gate", {"PUSH", "PUSH_SAGA"}
    elif mutation == "ep_stamp":
        i = src.index("def _proc_hdr")
        j = src.index('hdr["ep"] = self.epoch', i)
        mutated = (src[:j] + "pass"
                   + src[j + len('hdr["ep"] = self.epoch'):])
        rule, want = "proto-fence-gate", {"ep-stamp"}
    else:
        mutated = src.replace(
            "elif not self._fence_reject(conn, header, record=True):",
            "else:", 1)
        rule, want = "proto-fence-gate", {"PUSH", "PUSH_SAGA"}
    assert mutated != src
    assert set(_tokens(_protocol_findings(tmp_path, mutated), rule)) >= want
    clean = _protocol_findings(tmp_path / "clean", src)
    assert _tokens(clean, "proto-dedup-gate") == []
    assert _tokens(clean, "proto-fence-gate") == []


def _roadmap_open_items():
    """The items ROADMAP.md lists as left: the labels in its 'Left, in
    this order' part (``**A2b.``, ``**A6b.3.``, ...)."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    left = text[text.index("**Left, in this order:**"):]
    left = left[:left.index("\n### ")]
    return set(re.findall(r"\*\*(A\d+[a-z]?(?:\.\d+)?)\.", left))


def _refusal_items():
    """(file, line, item) of every ROADMAP item a refusal of the port
    names: string literals in ``NotImplementedError(...)`` calls and the
    item argument of ``ps_dcn._refuse``."""
    out = []
    base = os.path.join(REPO, PKG)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "csrc")]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = getattr(node.func, "id", getattr(node.func, "attr",
                                                        ""))
                if name == "NotImplementedError":
                    text = "".join(
                        n.value for a in node.args for n in ast.walk(a)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str))
                    for item in re.findall(r"ROADMAP (A\d+[a-z]?(?:\.\d+)?)",
                                           text):
                        out.append((path, node.lineno, item))
                elif name == "_refuse" and len(node.args) == 2:
                    item = node.args[1]
                    if isinstance(item, ast.Constant):
                        out.append((path, node.lineno, item.value))
    return out


def test_no_refusal_names_an_item_roadmap_marks_done():
    """Every NotImplementedError of the port names an item ROADMAP.md
    still lists as left (a done item's name in a refusal is a stale
    reason)."""
    open_items = _roadmap_open_items()
    assert {"A2b", "A6b.6", "A8"} <= open_items
    assert not {"A4", "A11", "A6b.1", "A6b.2", "A6b.3", "A6b.4",
                "A6b.5"} & open_items
    found = _refusal_items()
    assert found
    stale = [(os.path.relpath(p, REPO), line, item)
             for p, line, item in found if item not in open_items]
    assert stale == []

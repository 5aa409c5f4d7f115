"""Repo-invariant static analysis of the PyTorch package
(``python -m asyncframework_tpu_torch.analysis.cli``).

Counterpart of ``asyncframework_tpu/analysis/``: the same rules, aimed at
``asyncframework_tpu_torch/`` and ``chip_smoke.py``, checked against this
package's own declaration tables (``conf.py``, ``net/protocol.py``,
``metrics/registry.py``).  A module a rule names that is not ported yet is
declared in ``core.PENDING_PATHS`` with its ROADMAP item and skipped.

Nine PRs of engine growth accumulated load-bearing invariants that were
enforced only at runtime (``net/lockwatch.py``, the registration
audit) or not at all: every mutating wire op rides the exactly-once
dedup window, fence-stamped ops carry ``ep``, no socket I/O under the
model lock, every ``threading.Thread`` is named/daemon-explicit/guarded,
every counter family is registered, every ``async.*`` knob is declared.
This package makes them *build-time* invariants: an AST pass with
repo-specific rules, wired into tier-1 (``tests/test_torch_analysis.py``) so
the whole tree must self-lint clean.

Rules (see ``analysis/rules_*.py`` and the ARCHITECTURE.md
"Correctness tooling" catalog):

- ``conf-*``     -- conf-key discipline against ``conf.py``'s registry
- ``proto-*``    -- wire-protocol coverage matrix against
  ``net/protocol.py``
- ``lock-*``     -- blocking calls lexically under a lock (the static
  twin of the dynamic ``net/lockwatch.py`` watchdog)
- ``thread-*``   -- thread hygiene at every ``threading.Thread(...)``
  site
- ``metrics-*``  -- counter-family registration against
  ``metrics/registry.py``

Suppressions live ONLY in ``analysis/allowlist.py`` and every entry
carries a reason string; there is no inline-pragma escape hatch.
"""

from asyncframework_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintContext,
    run_lint,
)

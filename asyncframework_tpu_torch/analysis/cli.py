"""The lint's entry point: ``python -m asyncframework_tpu_torch.analysis.cli``.

Exit status: 0 = clean (suppressions allowed, findings not), 1 = any
finding, 2 = usage/internal error.  ``--json`` emits the machine-readable
report (findings + suppressions with reasons) for CI annotation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m asyncframework_tpu_torch.analysis.cli",
        description="Repo-invariant static analysis: conf-key "
                    "discipline, wire-protocol coverage "
                    "(net/protocol.py), blocking-calls-under-lock, "
                    "thread hygiene, counter-family registration.",
    )
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected from this "
                        "file's location)")
    p.add_argument("--rule", action="append", default=None,
                   choices=["conf", "protocol", "locks", "threads",
                            "metrics"],
                   help="run only this rule group (repeatable; "
                        "default: all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--no-allowlist", action="store_true",
                   help="show raw findings, ignoring "
                        "analysis/allowlist.py")
    p.add_argument("--list-allow", action="store_true",
                   help="print every suppression with its reason and "
                        "exit")
    return p


def _detect_root() -> str:
    # analysis/cli.py -> asyncframework_tpu_torch/ -> repo root
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from asyncframework_tpu_torch.analysis import core
    from asyncframework_tpu_torch.analysis.allowlist import ALLOWLIST

    root = args.root or _detect_root()

    if args.list_allow:
        for a in ALLOWLIST:
            print(f"[{a.rule}] {a.path} :: {a.token}\n    reason: "
                  f"{a.reason}")
        print(f"{len(ALLOWLIST)} suppression(s)")
        return 0

    try:
        result = core.run_lint(
            root, rules=args.rule,
            allowlist=[] if args.no_allowlist else None)
    except ValueError as e:
        print(f"async-lint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        report = result.to_json()
        report["pending"] = [{"path": p, "item": item}
                             for p, item in core.pending_paths(root)]
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if result.ok else 1

    for path, item in core.pending_paths(root):
        print(f"{path}: not ported yet (ROADMAP {item}); its checks are "
              f"skipped")
    for f in result.findings:
        print(f.format())
    tail = (f"async-lint: {len(result.findings)} finding(s), "
            f"{len(result.suppressed)} suppressed, "
            f"{result.files_scanned} files")
    print(tail if result.findings else f"async-lint: clean -- {tail}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Times phases of ``chip_smoke.py`` in two checkouts on one GPU, in turn.

    python3 -m asyncframework_tpu_torch.tools.phase_times \
        --roots OLD_DIR,NEW_DIR [--order ABBA] [--phases entry,serving] \
        [--out FILE]

Two trees compare only on one host (``chip_smoke.py``'s whole run spreads
650-1,018 s by host).  Each run is a fresh process whose working directory
and ``PYTHONPATH`` are its checkout's root, so the phases' child processes
import that checkout's package.  It builds the checkout's kernels (not
timed), turns TF32 off as ``chip_smoke.py`` does, then runs each phase
function of that checkout's ``chip_smoke.py`` once and prints one JSON
line: the checkout, the seconds of each phase, the card's name and power
limit; with ``--out``, the phases' own lines (``chip_smoke.py``'s records,
each arm's seconds among them) go to ``OUT.run<i>.log``.  ``--order``
lists the runs by letter (A the first root, B the second).  Phases:
``entry`` (15, ``entry_phase``), ``serving`` (16, ``serving_phase``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional

# run inside the checkout: its chip_smoke.py and its package
_RUN = r"""
import json, sys, time
import torch
import chip_smoke as cs
from asyncframework_tpu_torch.ops import _build
t0 = time.monotonic()
_build.build_all()
build_s = time.monotonic() - t0
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.card_line()
calls = {"entry": lambda: cs.entry_phase(torch, card),
         "serving": lambda: cs.serving_phase(card)}
seconds = {}
for name in sys.argv[1].split(","):
    t0 = time.monotonic()
    calls[name]()
    seconds[name] = time.monotonic() - t0
print("PHASE_TIMES " + json.dumps({"card": card, "build_s": build_s,
                                   "seconds": seconds}), flush=True)
"""


def run_once(root: str, phases: str, timeout_s: float,
             log: Optional[str] = None) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _RUN, phases], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=timeout_s)
    if log:
        with open(log, "w") as f:
            f.write(proc.stdout)
    for line in proc.stdout.splitlines():
        if line.startswith("PHASE_TIMES "):
            return json.loads(line[len("PHASE_TIMES "):])
    raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                       f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", required=True,
                    help="two checkout roots, comma-separated (A,B)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--phases", default="entry,serving")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a run may take")
    ap.add_argument("--out", default=None,
                    help="also append the lines to this file")
    args = ap.parse_args(argv)
    roots = dict(zip("AB", (os.path.abspath(r)
                            for r in args.roots.split(","))))
    lines = []
    for i, letter in enumerate(args.order):
        log = f"{args.out}.run{i}.log" if args.out else None
        rec = {"run": i, "tree": letter, "root": roots[letter],
               **run_once(roots[letter], args.phases, args.timeout, log)}
        rec["total_s"] = sum(rec["seconds"].values())
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

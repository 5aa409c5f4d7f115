"""Build the native C++ sources (wire codecs, LibSVM parser) at first use.

Counterpart of ``asyncframework_tpu/native_build.py``, for the port's copies
of ``net/`` and the dense LibSVM loader (``data/libsvm.py``):
``native/{wirecodec,wiredelta,shmring,libsvm_parser}.cc`` are compiled with
``g++`` into ``asyncframework_tpu_torch/_build/native/`` (listed in
``.gitignore``), never next to their sources, and the port never loads the
JAX package's ``native/*.so``.  The file name carries a hash of the source,
the compiler and its flags, so an edited source or recipe is rebuilt and an
unchanged one is loaded as it is.  Each build compiles into a private
temporary file and renames it into place, so processes that start together
(a parameter server and its worker processes) may build at once and never
load a half-written library.

Library code calls :func:`ensure_built` lazily; without a toolchain it
returns None and the loaders take their pure-Python oracles, the
documented path, each counted in ``python_fallbacks`` of
:func:`native_totals` (the JAX package's ``native`` counter family).

``python -m asyncframework_tpu_torch.native_build`` builds every source and
prints where each library went; ``--check`` prints each one's state without
building.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

SOURCES = ("wiredelta", "wirecodec", "shmring", "libsvm_parser")

# ------------------------------------------------------------ native totals
# Process-global counters: native_calls.<unit> / python_calls.<unit> per
# dispatch site, python_fallbacks (native WANTED but the library is
# unavailable), and the shm-ring transport's frame/byte/upgrade/degrade
# counts (net/shmring.py).
_totals_lock = threading.Lock()
_totals: Dict[str, int] = {}
_build_lock = threading.Lock()


def bump_native(key: str, n: int = 1) -> None:
    with _totals_lock:
        _totals[key] = _totals.get(key, 0) + n


def native_totals() -> Dict[str, int]:
    """Flat monotone counters: native_calls.<unit> / python_calls.<unit>
    (which implementation actually ran, per codec unit),
    python_fallbacks (native was enabled but unavailable), shm_upgrades /
    shm_upgrade_refused / shm_degrades, shm_frames_sent, shm_bytes_sent /
    shm_bytes_recv."""
    with _totals_lock:
        return dict(_totals)


def reset_native_totals() -> None:
    """Zero the native-plane counters (per-run isolation)."""
    with _totals_lock:
        _totals.clear()


# ------------------------------------------------------------------- build
def _source(name: str) -> str:
    return os.path.join(NATIVE_DIR, f"{name}.cc")


def _compile_flags() -> list:
    return [os.environ.get("CXX", "g++"),
            *os.environ.get("CXXFLAGS",
                            "-O3 -fPIC -shared -std=c++17 -Wall").split()]


def lib_path(name: str) -> Optional[str]:
    """Where ``name``'s library for the current source and recipe lives
    (built or not); None when the source is absent."""
    src = _source(name)
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_compile_flags()).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def ensure_built(name: str, quiet: bool = True) -> Optional[str]:
    """Build ``name`` if its library is missing; returns the library's path,
    or None when it cannot be built (no source, no compiler, a failed
    compile: its stderr is printed unless ``quiet``)."""
    if name not in SOURCES:
        raise ValueError(f"unknown native source {name!r}")
    out = lib_path(name)
    if out is None:
        return None
    if os.path.exists(out):
        return out
    with _build_lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [*_compile_flags(), "-o", tmp, _source(name)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=NATIVE_DIR, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            if not quiet:
                sys.stderr.write(res.stderr)
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
        os.replace(tmp, out)
    return out


def check_status(name: str) -> str:
    """One source's build state WITHOUT building: ``built``, ``missing``
    (never built for this source and recipe) or ``no-source``; ``missing``
    is suffixed ``, no-toolchain`` when a build could not run anyway."""
    out = lib_path(name)
    if out is None:
        return "no-source"
    if os.path.exists(out):
        return "built"
    if shutil.which(_compile_flags()[0]) is None:
        return "missing, no-toolchain"
    return "missing"


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--check" in argv:
        states = {name: check_status(name) for name in SOURCES}
        for name, state in states.items():
            print(f"{name}: {state}")
        return 0 if all(s == "built" for s in states.values()) else 1
    ok = True
    for name in SOURCES:
        path = ensure_built(name, quiet=False)
        print(f"{name}: {'built -> ' + path if path else 'FAILED'}")
        ok = ok and path is not None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

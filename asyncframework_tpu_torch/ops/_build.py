"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, under
``asyncframework_tpu_torch/_build/`` (listed in ``.gitignore``).  The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Only sources in the
package are compiled; a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    usual home, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from asyncframework_tpu_torch/csrc at first use"
        )
    return found


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns None when the library exists."""
    src, lib = _target(name)
    if os.path.isfile(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, lib, cmd


def _finish(job) -> None:
    proc, tmp, lib, cmd = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}{out}"
        )
    # ptxas -v report (registers, shared memory, spills) kept beside the
    # library; rename last so a concurrent loader never sees a partial file
    with open(lib[:-3] + ".log", "w") as f:
        f.write(err + out)
    os.replace(tmp, lib)


def build_all(names: Iterable[str] = ()) -> float:
    """Build every kernel source (or ``names``) with one nvcc each, all
    started together; returns the wall seconds taken."""
    t0 = time.monotonic()
    with _lock:
        jobs = [j for j in map(_start, list(names) or sources()) if j]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.monotonic() - t0


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output from the build of ``name``."""
    log = _target(name)[1][:-3] + ".log"
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first
    use)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(_target(name)[1])
            _loaded[name] = lib
    return lib

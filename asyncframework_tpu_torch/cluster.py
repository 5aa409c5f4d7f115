"""Local multi-process cluster launcher.

Counterpart of ``asyncframework_tpu/cluster.py`` (parity:
``deploy/LocalSparkCluster.scala:36`` -- the reference's single-machine
REAL cluster, actual processes and RPC, used both as a test rig and a
demo).  N OS processes on one machine, each running the port's stock CLI
(``python -m asyncframework_tpu_torch.cli``) with the bring-up env vars set
(``ASYNCTPU_COORDINATOR`` / ``ASYNCTPU_NUM_PROCESSES`` /
``ASYNCTPU_PROCESS_ID``), so a recipe that works single-process works on
the cluster unchanged.  Two multi-process modes:

- ``sgd-mllib``: SPMD over a ``torch.distributed`` process group and a
  global mesh (``parallel/multihost.py``; gloo on the CPU, NCCL on cards);
- ``asgd``/``asaga``: the DCN parameter server (``parallel/ps_dcn.py``) --
  process 0 runs the PS (the driver IS the server, across the process
  boundary), the rest push tau-stamped gradients to it over TCP.

Devices: by default every process runs on the CUDA devices it sees; on one
card every process shares ``cuda:0``, and ``--devices-per-process`` is
unused (as the reference's launcher ignores it off its CPU rig).  The CPU
is taken only when asked: ``platform="cpu"``, or ``ASYNCTPU_FORCE_CPU`` in
the caller's environment; each process then runs on ``devices_per_process``
ranks of the CPU (``XLA_FLAGS``'s host device count, read by the CLI).
Without a card and without either, the launcher raises before it starts a
process.

CLI: ``python -m asyncframework_tpu_torch.cluster <N> [--devices-per-process
K] -- <cli args...>``, e.g. ``python -m asyncframework_tpu_torch.cluster 3
-- asgd synthetic x 2000 400000 8 1000 100 2147483647 0.1 0.7 25 0 42``
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List, Optional, Tuple


def _free_port() -> int:
    from asyncframework_tpu_torch.net.frame import free_port

    return free_port()


def launch_local_cluster(
    num_processes: int,
    cli_args: List[str],
    devices_per_process: int = 2,
    timeout_s: float = 300.0,
    platform: Optional[str] = None,
) -> Tuple[int, List[str]]:
    """Spawn ``num_processes`` CLI processes joined by the bring-up env.

    Returns ``(worst_returncode, [process-0 stdout lines])``.  Process 0's
    output is the run's output (every SPMD process computes identical
    results; the DCN PS prints the summary); other processes' stdout is
    suppressed unless they fail.

    ``platform=None`` runs on the card, or on the CPU when the caller's
    environment sets ``ASYNCTPU_FORCE_CPU``; ``platform="cpu"`` forces
    ``devices_per_process`` CPU ranks per process (the LocalSparkCluster
    test-rig mode, no card needed).
    """
    from asyncframework_tpu_torch.cli import FORCE_CPU_ENV

    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if platform is None and os.environ.get(FORCE_CPU_ENV):
        platform = "cpu"
    if platform != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; launch on the CPU with "
                f"platform='cpu' or {FORCE_CPU_ENV}=1 in the environment")
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env["ASYNCTPU_COORDINATOR"] = coord
        env["ASYNCTPU_NUM_PROCESSES"] = str(num_processes)
        env["ASYNCTPU_PROCESS_ID"] = str(pid)
        if platform == "cpu":
            env[FORCE_CPU_ENV] = "1"
            flags = env.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                env["XLA_FLAGS"] = (
                    flags + " --xla_force_host_platform_device_count="
                    f"{devices_per_process}"
                ).strip()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "asyncframework_tpu_torch.cli", *cli_args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    # drain every process CONCURRENTLY: a sequential communicate() would
    # let a later process block on its full 64KB stdout pipe while we wait
    # on an earlier one stuck in the distributed barrier behind it
    import threading

    results: List[Optional[Tuple[str, str]]] = [None] * num_processes

    def drain(pid: int, p) -> None:
        try:
            results[pid] = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            results[pid] = p.communicate()

    threads = [
        threading.Thread(target=drain, args=(pid, p),
                         name=f"cluster-drain-{pid}", daemon=True)
        for pid, p in enumerate(procs)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    outs: List[str] = []
    worst = 0
    for pid, p in enumerate(procs):
        out, err = results[pid] if results[pid] is not None else ("", "")
        if p.returncode:
            worst = p.returncode
            print(f"--- process {pid} rc={p.returncode} stderr tail ---",
                  file=sys.stderr)
            print("\n".join(err.splitlines()[-15:]), file=sys.stderr)
        if pid == 0:
            outs = out.splitlines()
    return worst, outs


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or not argv[0].isdigit():
        print(
            "usage: python -m asyncframework_tpu_torch.cluster "
            "<num_processes> [--devices-per-process K] -- <cli args...>",
            file=sys.stderr,
        )
        return 2
    n = int(argv.pop(0))
    dpp = 2
    if argv and argv[0] == "--devices-per-process":
        argv.pop(0)
        if not argv or not argv[0].isdigit():
            print("--devices-per-process needs an integer", file=sys.stderr)
            return 2
        dpp = int(argv.pop(0))
    if argv and argv[0] == "--":
        argv.pop(0)
    rc, out = launch_local_cluster(n, argv, devices_per_process=dpp)
    for line in out:
        print(line)
    return rc


if __name__ == "__main__":
    sys.exit(main())

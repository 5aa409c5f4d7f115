"""Child of ``tests/test_torch_multihost.py``: one process of a gloo group.

Joins the group through ``asyncframework_tpu_torch.parallel.multihost``
(the coordinator, the process count and this process's id from
``ASYNCTPU_COORDINATOR`` / ``ASYNCTPU_NUM_PROCESSES`` /
``ASYNCTPU_PROCESS_ID``), fences on the host barrier, sums ``pid + 1``
over the group, and with ``train`` as its argument also trains
``MiniBatchSGD`` over the global mesh (``MH_RANKS`` CPU ranks in each
process).  Prints one JSON line.  It imports neither JAX nor the JAX
package.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from asyncframework_tpu_torch.parallel import multihost  # noqa: E402


def problem():
    rs = np.random.default_rng(7)
    X = rs.normal(size=(256, 16)).astype(np.float32)
    w = rs.normal(size=(16,)).astype(np.float32)
    y = (X @ w + 0.01 * rs.normal(size=(256,))).astype(np.float32)
    return X, y


SGD = dict(gamma=0.5, batch_rate=0.5, num_iterations=40, seed=3)


def main() -> None:
    ranks = int(os.environ.get("MH_RANKS", "2"))
    active = multihost.ensure_initialized(
        devices=[torch.device("cpu")] * ranks,
        timeout_s=float(os.environ.get("MH_TIMEOUT_S", "60")))
    pid, pc = multihost.process_info()
    multihost.sync_hosts("start")
    t = torch.tensor([float(pid + 1)])
    torch.distributed.all_reduce(t)
    mesh = multihost.global_mesh()
    rec = {"active": bool(active), "pid": pid, "pc": pc,
           "devices": multihost.device_count(),
           "local_ranks": mesh.local_ranks(), "mesh_size": mesh.size,
           "sum": float(t[0]), "backend": torch.distributed.get_backend()}
    if len(sys.argv) > 1 and sys.argv[1] == "train":
        from asyncframework_tpu_torch.solvers import MiniBatchSGD

        X, y = problem()  # every process holds the same global arrays
        w, losses, _ = MiniBatchSGD(**SGD).run(X, y, mesh=mesh)
        rec.update(w=np.asarray(w).tolist(), final_loss=float(losses[-1]))
    multihost.sync_hosts("end")
    multihost.shutdown()
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

"""Staleness at merge and the controller's damped share on a sharded group
of either package, trained by the same worker processes.

A 3-shard group (an in-process primary for shard 0, shards 1 and 2 as the
package's own child processes, each with a warm standby, fenced), the
adaptive controller on the primary, and two worker processes of the JAX
package (``tests/ps_dcn_child.py``: 8 logical workers, pipeline depth
``DEPTH``) that run ``ITERS`` updates.  The primary's merge-time staleness
and each item's damp factor are read off its ``_wstat_merge`` and
``_item_damp`` calls; the children report their own largest staleness
(the port's children also their counts).  Prints one JSON line a run.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_staleness_compare.py jax
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_staleness_compare.py port

Both packages' rows under one host are the comparison: the distribution
is set by the workers' pipelining and the host's speed, the accounting
(``clock - ts`` at the drain) by the PS.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

NW, N, D = 8, 4096, 24
ITERS = int(os.environ.get("ITERS", "600"))
DEPTH = int(os.environ.get("DEPTH", "2"))
CHILD = os.path.join(ROOT, "tests", "ps_dcn_child.py")


def _worker(port: int, wpid: int, tmp: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT, PS_ROLE="worker",
               PS_PORT=str(port), PS_WORKER_ID=str(wpid),
               PS_NUM_WORKER_PROCS="2", PS_NUM_ITER=str(ITERS),
               PS_EVAL="0", JAX_PLATFORMS="cpu",
               ASYNCTPU_ASYNC_PIPELINE_DEPTH=str(DEPTH))
    return subprocess.Popen(
        [sys.executable, CHILD], env=env, stdout=subprocess.PIPE,
        stderr=open(os.path.join(tmp, f"worker{wpid}.stderr.log"), "w"),
        text=True)


def _stats(counts: dict) -> dict:
    keys = sorted(counts)
    xs = np.repeat(np.asarray(keys), [counts[k] for k in keys])
    return {"p50": float(np.median(xs)),
            "p90": float(np.percentile(xs, 90)), "max": int(xs.max())}


def run(pkg: str) -> dict:
    overlays = {"async.fence.enabled": True, "async.ps.standby": 1,
                "async.pipeline.depth": DEPTH}
    if pkg == "jax":
        import jax

        from asyncframework_tpu.conf import AsyncConf, set_global_conf
        from asyncframework_tpu.net import frame
        from asyncframework_tpu.parallel import ps_dcn
        from asyncframework_tpu.parallel import shardgroup as sg
        from asyncframework_tpu.parallel.controller import AsyncController
        from asyncframework_tpu.solvers import SolverConfig

        device, group_kw = jax.devices()[0], {}
    else:
        import torch

        from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
        from asyncframework_tpu_torch.net import frame
        from asyncframework_tpu_torch.parallel import ps_dcn
        from asyncframework_tpu_torch.parallel import shardgroup as sg
        from asyncframework_tpu_torch.parallel.controller import (
            AsyncController,
        )
        from asyncframework_tpu_torch.solvers import SolverConfig

        device, group_kw = torch.device("cpu"), {"device": "cpu"}
    # tests/ps_dcn_child.py::config()
    cfg = SolverConfig(num_workers=NW, num_iterations=ITERS, gamma=1.2,
                       taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.5,
                       printer_freq=50, seed=42, calibration_iters=20,
                       run_timeout_s=120.0)
    if pkg == "jax":
        cfg.pipeline_depth = DEPTH  # the JAX controller reads it here
    conf = AsyncConf(dict(overlays))
    set_global_conf(conf)
    tmp = tempfile.mkdtemp(prefix="staleness-")
    port0 = frame.free_port()
    group = sg.ShardGroup(
        cfg, D, N, 3, checkpoint_dir=tmp, indices=range(1, 3),
        fixed_entries={0: ("127.0.0.1", port0)}, worker_procs=2,
        dead_after_s=2.0, check_interval_s=0.2, stderr_dir=tmp,
        conf_overlays=dict(overlays), **group_kw).start()
    ps = ps_dcn.ParameterServer(
        cfg, sg.shard_ranges(D, 3)[0][1], N, port=port0, device=device,
        shard_map=group.smap.to_wire(), shard_index=0,
        shard_epochs=group.epochs_wire()).start()
    hist: dict = {}
    damps: list = []
    wstat, item_damp = ps._wstat_merge, ps._item_damp

    def counted_wstat(wid, staleness, accepted):
        hist[staleness] = hist.get(staleness, 0) + 1
        return wstat(wid, staleness, accepted)

    def counted_damp(wid, staleness):
        damps.append(item_damp(wid, staleness))
        return damps[-1]

    ps._wstat_merge, ps._item_damp = counted_wstat, counted_damp
    ctl = AsyncController(ps, conf=conf, group=group).start()
    workers = [_worker(port0, 0, tmp), _worker(port0, 1, tmp)]
    t0 = time.monotonic()
    try:
        if not ps.wait_done(timeout_s=150.0):
            raise RuntimeError("the run did not finish")
        elapsed = time.monotonic() - t0
        group.finish()
        children = [group.result_of(i, timeout_s=60.0) or {} for i in (1, 2)]
        for w in workers:
            w.communicate(timeout=120)
        law = ctl.status()["damp"]
    finally:
        ctl.stop()
        group.stop()
        ps.stop()
        set_global_conf(None)
        for w in workers:
            if w.poll() is None:
                w.kill()
    d = np.asarray(damps)
    return {"pkg": pkg, "accepted": ps.accepted, "elapsed_s": elapsed,
            "depth": DEPTH, "primary": _stats(hist),
            "children_max": [c.get("max_staleness") for c in children],
            "children": [_stats({int(k): v for k, v in
                                 c["staleness_counts"].items()})
                         if c.get("staleness_counts") else None
                         for c in children],
            "damped_share": float((d < 1.0).mean()) if d.size else None,
            "damp_mean": float(d[d < 1.0].mean()) if (d < 1.0).any()
            else None, "law": law}


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1])), flush=True)

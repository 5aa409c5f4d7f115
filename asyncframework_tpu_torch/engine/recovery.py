"""Elastic recovery: re-homing a dead worker's data shard.

Parity: the reference's recovery story is lineage -- a lost executor's cached
partitions are *recomputed* from their parent RDDs on surviving executors
(``DAGScheduler.scala:1326-1400`` resubmission, ``DistributedSuite``'s
"recover from node failures" cases).  The port has no lineage because it
has no lazy transformation graph on the hot path; the equivalent capability
is explicit: a shard whose worker slot is declared dead is re-placed into a
surviving slot's device memory by a device-to-device copy of the live
buffer (``Tensor.to``).

``plan_reassignment`` is the pure policy (balanced round-robin of dead slots
over survivors); ``ShardRecovery`` applies a plan to a ``ShardedDataset``
or a ``SparseShardedDataset`` by building per-worker *assignment views*:
worker slots keep their identity, a surviving worker simply computes extra
shards' gradients in subsequent rounds.  The solver layer stays oblivious
-- it asks ``assignments(wid)`` for the shard list a worker currently owns.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from asyncframework_tpu_torch.data.sharded import Shard, ShardedDataset
from asyncframework_tpu_torch.data.sparse import SparseShard


@dataclass(frozen=True)
class ReassignmentPlan:
    """dead worker id -> adopting (live) worker id."""

    moves: Dict[int, int]


def plan_reassignment(
    all_workers: Sequence, dead: Sequence[int],
    load: Optional[Dict] = None,
) -> ReassignmentPlan:
    """Round-robin dead workers' shards over survivors, least-loaded first.

    Deterministic: survivors are visited in ascending id order, dead shards
    in ascending id order, so every host computes the same plan.

    ``load`` (optional) is the survivors' CURRENT shard count -- the
    multi-process supervisor re-plans incrementally as membership keeps
    changing, so a survivor that already adopted shards must weigh
    heavier than a fresh one.  Default (None) is the single-shot policy:
    every survivor owns exactly its own shard.  Survivor ids need not be
    worker ints -- the DCN supervisor plans over process tokens.
    """
    dead_set = set(dead)
    survivors = sorted(w for w in all_workers if w not in dead_set)
    if not survivors:
        raise RuntimeError("no surviving workers to adopt shards")
    if load is None:
        load = {w: 1 for w in survivors}  # own shard
    else:
        load = {w: int(load.get(w, 0)) for w in survivors}
    moves: Dict[int, int] = {}
    for d in sorted(dead_set):
        target = min(survivors, key=lambda w: (load[w], w))
        moves[d] = target
        load[target] += 1
    return ReassignmentPlan(moves)


class ShardRecovery:
    """Tracks which worker currently owns which shards; applies plans.

    After ``apply(plan)``, each adopted shard has been re-placed on its new
    owner's device (device-to-device) and ``assignments(wid)`` lists every shard worker
    ``wid`` now computes per round.
    """

    def __init__(self, ds: ShardedDataset, devices: Sequence):
        self.ds = ds
        self.devices = list(devices)
        self._lock = threading.Lock()
        self._owner: Dict[int, int] = {w: w for w in range(ds.num_workers)}
        # shard_id -> device-resident Shard under its current owner
        self._placed: Dict[int, Shard] = {w: ds.shard(w) for w in range(ds.num_workers)}

    def _device_of(self, wid: int):
        return self.devices[wid % len(self.devices)]

    def apply(self, plan: ReassignmentPlan) -> None:
        for shard_id, new_owner in plan.moves.items():
            self.move_shard(shard_id, new_owner)

    def move_shard(self, shard_id: int, new_owner: int):
        """Re-place one shard on ``new_owner``'s device; returns the new view."""
        with self._lock:
            cur = self._placed[shard_id]
            target_dev = self._device_of(new_owner)
            # a device-to-device copy (the same tensors when the adopting
            # worker shares the shard's device)
            if hasattr(cur, "cols"):  # padded-ELL sparse shard
                moved = SparseShard(
                    worker_id=shard_id,
                    cols=cur.cols.to(target_dev),
                    vals=cur.vals.to(target_dev),
                    y=cur.y.to(target_dev),
                    start=cur.start,
                    size=cur.size,
                )
            else:
                moved = Shard(
                    worker_id=shard_id,
                    X=cur.X.to(target_dev),
                    y=cur.y.to(target_dev),
                    start=cur.start,
                    size=cur.size,
                )
            self._placed[shard_id] = moved
            self._owner[shard_id] = new_owner
            return moved

    # ------------------------------------------------------------------ views
    def owner(self, shard_id: int) -> int:
        with self._lock:
            return self._owner[shard_id]

    def assignments(self, worker_id: int) -> List[Shard]:
        """Every shard this worker currently computes (own + adopted)."""
        with self._lock:
            return [
                self._placed[sid]
                for sid, own in sorted(self._owner.items())
                if own == worker_id
            ]

    def shard(self, shard_id: int) -> Shard:
        with self._lock:
            return self._placed[shard_id]

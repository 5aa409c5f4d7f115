"""Relaycast tree plan: deterministic k-ary distribution forest.

The reference's ``TorrentBroadcast`` shapes its swarm dynamically; this
plane keeps the ASYNC stance that correctness machinery should be
*deterministic and inspectable*: given (replica count, fanout) every
launcher -- tests, k8s StatefulSet ordinals, serving CLI -- computes the
SAME tree with no coordination, so the topology is a pure function, not
a protocol.  Repair is not re-planning: a node whose parent dies falls
back to the ROOT (the PS -- the always-safe direct SUBSCRIBE path) for
``async.relay.parent.retry.s`` and then re-tries its planned parent;
the plan itself never changes mid-run.

Layout: replicas ``0..n-1``; nodes ``0..k-1`` are children of the root
(the PS, denoted index ``ROOT == -1``); node ``i >= k`` has parent
``i // k - 1``.  Depth is ``O(log_k n)``, every node has at most ``k``
children, and the child sets partition ``1..n-1`` -- properties the
relaycast test suite asserts over a sweep of (n, k).
"""

from __future__ import annotations

from typing import List

#: the PS root's index in a tree plan
ROOT = -1


def parent_index(i: int, fanout: int) -> int:
    """Planned parent of replica ``i`` (``ROOT`` for the first ``fanout``
    replicas, which SUBSCRIBE directly to the PS)."""
    if i < 0:
        raise ValueError(f"replica index must be >= 0, got {i}")
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if i < fanout:
        return ROOT
    return i // fanout - 1


def children_of(i: int, n: int, fanout: int) -> List[int]:
    """Planned children of replica ``i`` among ``n`` replicas."""
    lo = (i + 1) * fanout
    return [c for c in range(lo, min(lo + fanout, n))]


def depth_of(i: int, fanout: int) -> int:
    """Hops from replica ``i`` to the root (direct children are 1)."""
    d = 1
    while parent_index(i, fanout) != ROOT:
        i = parent_index(i, fanout)
        d += 1
    return d

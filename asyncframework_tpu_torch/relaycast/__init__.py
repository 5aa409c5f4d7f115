"""Relaycast: peer-relayed versioned model distribution.

The ASYNCbroadcast/TorrentBroadcast analog for the serving fleet:
replicas form a deterministic k-ary tree rooted at the PS
(:mod:`~asyncframework_tpu_torch.relaycast.tree`), the root's direct children
SUBSCRIBE as usual, and every deeper node RELAY_FETCHes CRC-gated XOR
deltas from its parent and re-serves them to its own children
(:mod:`~asyncframework_tpu_torch.relaycast.node`), so PS snapshot egress per
version is O(fanout) instead of O(replicas).  Every hop is epoch-gated
(epoch fencing) and falls back to a direct root SUBSCRIBE on any
mismatch (:mod:`~asyncframework_tpu_torch.relaycast.source`).
"""

from asyncframework_tpu_torch.relaycast.node import RelayNode
from asyncframework_tpu_torch.relaycast.source import (
    DecodeMismatch,
    ParentEmpty,
    ParentError,
    RelaySource,
)
from asyncframework_tpu_torch.relaycast.tree import (
    ROOT,
    children_of,
    depth_of,
    parent_index,
)

__all__ = [
    "ROOT",
    "DecodeMismatch",
    "ParentEmpty",
    "ParentError",
    "RelayNode",
    "RelaySource",
    "children_of",
    "depth_of",
    "parent_index",
]

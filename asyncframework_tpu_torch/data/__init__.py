"""Device-resident datasets."""

from asyncframework_tpu_torch.data.sharded import (
    Shard,
    ShardedDataset,
    balanced_sizes,
)

__all__ = ["Shard", "ShardedDataset", "balanced_sizes"]

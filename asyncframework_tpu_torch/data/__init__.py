"""Device-resident datasets, loaders and synthetic generators."""

from asyncframework_tpu_torch.data.libsvm import (
    load_libsvm,
    load_libsvm_sparse,
    parse_libsvm_lines,
    parse_libsvm_lines_sparse,
)
from asyncframework_tpu_torch.data.sharded import (
    Shard,
    ShardedDataset,
    balanced_sizes,
)
from asyncframework_tpu_torch.data.sparse import (
    SparseShard,
    SparseShardedDataset,
    densify,
)
from asyncframework_tpu_torch.data.synthetic import (
    make_classification,
    make_regression,
    make_sparse_regression,
)

__all__ = [
    "Shard",
    "ShardedDataset",
    "SparseShard",
    "SparseShardedDataset",
    "balanced_sizes",
    "densify",
    "load_libsvm",
    "load_libsvm_sparse",
    "make_classification",
    "make_regression",
    "make_sparse_regression",
    "parse_libsvm_lines",
    "parse_libsvm_lines_sparse",
]

"""Data pipeline of the port: datasets, sampler and loader."""

from distributed_training_tpu_torch.data.datasets import (
    ArrayDataset,
    SyntheticLMDataset,
    build_dataset,
)
from distributed_training_tpu_torch.data.loader import ShardedDataLoader
from distributed_training_tpu_torch.data.sampler import (
    DistributedShardSampler,
    epoch_permutation,
)

__all__ = ["ArrayDataset", "DistributedShardSampler", "ShardedDataLoader",
           "SyntheticLMDataset", "build_dataset", "epoch_permutation"]

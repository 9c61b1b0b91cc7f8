"""Data pipeline of the port: datasets, sampler, loader and corpus
preparation."""

from distributed_training_tpu_torch.data.datasets import (
    ArrayDataset,
    MemmapTokenDataset,
    SubsetDataset,
    SyntheticDocDataset,
    SyntheticImageDataset,
    SyntheticLMDataset,
    SyntheticRegressionDataset,
    build_dataset,
    train_eval_split,
)
from distributed_training_tpu_torch.data.loader import ShardedDataLoader
from distributed_training_tpu_torch.data.sampler import (
    DistributedShardSampler,
    epoch_permutation,
)

__all__ = ["ArrayDataset", "DistributedShardSampler", "MemmapTokenDataset",
           "ShardedDataLoader", "SubsetDataset", "SyntheticDocDataset",
           "SyntheticImageDataset", "SyntheticLMDataset",
           "SyntheticRegressionDataset", "build_dataset", "epoch_permutation",
           "train_eval_split"]

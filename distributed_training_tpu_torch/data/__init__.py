"""Data pipeline of the port: datasets, sampler, the sharded loader, the
exactly-once streaming loader and corpus preparation."""

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
from distributed_training_tpu_torch.data.stream import (
    StreamingDataLoader,
    StreamSource,
    StreamState,
    build_stream_sources,
)

__all__ = ["ArrayDataset", "DistributedShardSampler", "MemmapTokenDataset",
           "ShardedDataLoader", "StreamSource", "StreamState",
           "StreamingDataLoader", "SubsetDataset", "SyntheticDocDataset",
           "SyntheticImageDataset", "SyntheticLMDataset",
           "SyntheticRegressionDataset", "build_dataset",
           "build_stream_sources", "epoch_permutation", "train_eval_split"]

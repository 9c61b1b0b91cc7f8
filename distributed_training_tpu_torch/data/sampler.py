"""Deterministic distributed sampling (port of ``data/sampler.py``).

torch ``DistributedSampler`` semantics over NumPy's PCG64, exactly as the
JAX package: ``num_samples = ceil(N / num_shards)``, a permutation seeded
by ``seed + epoch``, wrap-around padding, shard ``s`` takes
``indices[s::num_shards]``. The index stream is identical to the JAX
package's for the same seed and epoch.
"""

from __future__ import annotations

import numpy as np


def epoch_permutation(seed: int, epoch: int, n: int,
                      shuffle: bool = True,
                      stream: int = 0) -> np.ndarray:
    """Deterministic per-epoch permutation of ``range(n)``, a pure
    function of ``(seed, stream, epoch)``."""
    if not shuffle:
        return np.arange(n)
    rng = np.random.default_rng([seed, stream, epoch])
    return rng.permutation(n)


class DistributedShardSampler:
    """Yields per-shard index arrays for one epoch."""

    def __init__(self, dataset_size: int, num_shards: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False) -> None:
        if dataset_size <= 0:
            raise ValueError(f"dataset_size must be > 0, got {dataset_size}")
        if num_shards <= 0:
            raise ValueError(f"num_shards must be > 0, got {num_shards}")
        self.dataset_size = dataset_size
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_size // num_shards
            if self.num_samples == 0:
                raise ValueError(
                    f"drop_last with {num_shards} shards leaves no samples "
                    f"from dataset of {dataset_size}")
        else:
            self.num_samples = -(-dataset_size // num_shards)  # ceil
        self.total_size = self.num_samples * self.num_shards

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def global_indices(self) -> np.ndarray:
        """The epoch's full index order before sharding, padded/truncated
        to ``total_size``."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if self.drop_last:
            return indices[:self.total_size]
        pad = self.total_size - self.dataset_size
        if pad > 0:
            reps = -(-pad // self.dataset_size)
            indices = np.concatenate(
                [indices] + [indices] * reps)[:self.total_size]
        return indices

    def shard_indices(self, shard: int) -> np.ndarray:
        """Index array for one shard (torch's ``indices[rank::world]``)."""
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.num_shards})")
        return self.global_indices()[shard::self.num_shards]

    def __len__(self) -> int:
        return self.num_samples

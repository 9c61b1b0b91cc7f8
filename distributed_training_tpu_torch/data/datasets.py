"""Datasets: map-style, NumPy-backed, deterministic (port of
``data/datasets.py``).

``len(ds)`` and ``ds.batch(indices) -> dict of stacked arrays`` over
columnar NumPy, as in the JAX package. This slice ports the in-memory
dataset and the synthetic LM corpus that ``conf/train/gpt2.yaml`` reads;
the other registry names wait for ROADMAP.md queue A item 2.
"""

from __future__ import annotations

from typing import Mapping, Protocol

import numpy as np

from distributed_training_tpu_torch import native


class Dataset(Protocol):
    """Map-style dataset: columnar access by index array."""

    def __len__(self) -> int: ...

    def batch(self, indices: np.ndarray) -> Mapping[str, np.ndarray]:
        """Gather rows for ``indices`` into a dict of stacked arrays."""
        ...


class ArrayDataset:
    """Columnar in-memory dataset over named NumPy arrays."""

    def __init__(self, **columns: np.ndarray):
        if not columns:
            raise ValueError("ArrayDataset needs at least one column")
        sizes = {k: len(v) for k, v in columns.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"column length mismatch: {sizes}")
        self.columns = dict(columns)
        self._size = next(iter(sizes.values()))

    def __len__(self) -> int:
        return self._size

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        idx = np.asarray(indices, dtype=np.int64)
        return {k: v[idx] for k, v in self.columns.items()}


class SyntheticLMDataset(ArrayDataset):
    """Synthetic language-model corpus: each row is ``seq_len + 1``
    tokens (the model reads ``tokens[:-1]`` and predicts ``tokens[1:]``),
    drawn by the JAX package's SplitMix64 fill, so both packages build the
    same corpus from the same seed."""

    def __init__(self, size: int = 1024, seq_len: int = 128,
                 vocab_size: int = 50257, seed: int = 0):
        tokens = native.fill_tokens(
            seed, vocab_size, size * (seq_len + 1)).reshape(
                size, seq_len + 1)
        super().__init__(tokens=tokens)
        self.seq_len = seq_len
        self.vocab_size = vocab_size


_LATER = ("synthetic", "synthetic_normal", "synthetic_linear",
          "synthetic_doc", "synthetic_images", "memmap_tokens", "bytes")


def build_dataset(name: str, _defaults: dict | None = None,
                  **kwargs) -> Dataset:
    """Dataset registry keyed by config ``train.dataset``.

    ``_defaults`` are soft kwargs (size/seed from TrainConfig) applied
    only where the caller did not set them; explicit ``kwargs`` pass
    through unfiltered so typos fail loudly."""
    if name in _LATER:
        raise NotImplementedError(
            f"dataset '{name}' waits for ROADMAP.md queue A item 2 "
            "(skeleton slice); this slice has 'synthetic_lm'")
    if name != "synthetic_lm":
        raise ValueError(f"unknown dataset '{name}'; known: "
                         f"{sorted(('synthetic_lm',) + _LATER)}")
    return SyntheticLMDataset(**{**(_defaults or {}), **kwargs})

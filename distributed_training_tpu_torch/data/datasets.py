"""Datasets: map-style, NumPy-backed, deterministic (port of
``data/datasets.py``).

``len(ds)`` and ``ds.batch(indices) -> dict of stacked arrays`` over
columnar NumPy, as in the JAX package, with every dataset of its
registry (``build_dataset``): the reference's synthetic regression data
(``synthetic``, ``synthetic_normal``, ``synthetic_linear``), the
synthetic LM corpus, ragged synthetic documents, synthetic images, a
token corpus on a flat binary file (``memmap_tokens``) and the
byte-level corpus ``data/prepare.py`` writes (``bytes``). Every
generator is NumPy's, seeded as in the JAX package, so both packages
build the same rows byte for byte. ``train_eval_split`` carves the
held-out rows off, seed-keyed, as the JAX one does.
"""

from __future__ import annotations

import inspect
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
        # The native multithreaded row gather (equal to NumPy's fancy
        # indexing; native/).
        return {k: native.gather_rows(v, indices)
                for k, v in self.columns.items()}


class SyntheticRegressionDataset(ArrayDataset):
    """Parity with the reference's synthetic data distributions.

    ``kind="uniform"`` reproduces ``MyTrainDataset`` (rand(in_dim), rand(1);
    src/data_utils.py:10); ``kind="normal"`` reproduces the playground's
    ``DummyDataset`` (randn; src/playground/ddp_script.py:30-32) whose
    targets carry a learnable linear signal via the loss (MSE). Data is
    generated once, seeded, identical on every process: every rank builds
    the same dataset, then samples its shard.
    """

    def __init__(self, size: int = 2048, in_dim: int = 20, out_dim: int = 1,
                 seed: int = 0, kind: str = "uniform"):
        rng = np.random.default_rng(seed)
        if kind == "uniform":
            x = rng.random((size, in_dim), dtype=np.float32)
            y = rng.random((size, out_dim), dtype=np.float32)
        elif kind == "normal":
            x = rng.standard_normal((size, in_dim), dtype=np.float32)
            y = rng.standard_normal((size, out_dim), dtype=np.float32)
        elif kind == "linear":
            # A solvable regression task (for convergence tests): y = xW + b
            # + noise. The reference's default task is degenerate (SURVEY.md
            # §8 B5); this kind exists so convergence is actually testable.
            w = rng.standard_normal((in_dim, out_dim), dtype=np.float32)
            b = rng.standard_normal((out_dim,), dtype=np.float32)
            x = rng.standard_normal((size, in_dim), dtype=np.float32)
            noise = 0.01 * rng.standard_normal((size, out_dim),
                                               dtype=np.float32)
            y = x @ w + b + noise
        else:
            raise ValueError(f"unknown kind: {kind}")
        super().__init__(x=x, y=y)


class SyntheticLMDataset(ArrayDataset):
    """Synthetic language-model corpus: random token sequences with a
    next-token structure (each row is ``seq_len + 1`` tokens; the model sees
    ``tokens[:-1]`` and predicts ``tokens[1:]``). Stands in for the
    OpenWebText shard of BASELINE.json config 3 in tests/benches."""

    def __init__(self, size: int = 1024, seq_len: int = 128,
                 vocab_size: int = 50257, seed: int = 0):
        # The native token fill; its NumPy fallback replays the same
        # SplitMix64 stream, so every process builds the same corpus.
        tokens = native.fill_tokens(
            seed, vocab_size, size * (seq_len + 1)).reshape(
                size, seq_len + 1)
        super().__init__(tokens=tokens)
        self.seq_len = seq_len
        self.vocab_size = vocab_size


class SyntheticImageDataset(ArrayDataset):
    """Synthetic labelled images (CIFAR-10-shaped by default) for the
    ResNet config of BASELINE.json when no real data is present."""

    def __init__(self, size: int = 1024, height: int = 32, width: int = 32,
                 channels: int = 3, num_classes: int = 10, seed: int = 0):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((size, height, width, channels),
                                dtype=np.float32)
        y = rng.integers(0, num_classes, (size,), dtype=np.int32)
        super().__init__(x=x, y=y)
        self.num_classes = num_classes


class SyntheticDocDataset:
    """Variable-length synthetic token DOCUMENTS (ragged, stored as one
    flat token array + offsets) — the shape real pretraining corpora
    have before packing. Row ``i`` is a doc of ``min_len..max_len``
    tokens; the streaming packer (data/stream.py) reads docs exactly
    via ``doc(i)`` and concatenates them into fixed blocks.

    ``batch`` keeps the map-style contract for probes by zero-padding
    to the corpus max length — training should consume this dataset
    through the packer, which never pads."""

    def __init__(self, size: int = 256, min_len: int = 16,
                 max_len: int = 96, vocab_size: int = 50257,
                 seed: int = 0):
        if not 0 < min_len <= max_len:
            raise ValueError(
                f"need 0 < min_len <= max_len, got {min_len}..{max_len}")
        rng = np.random.default_rng([seed, 0x0D0C])
        lengths = rng.integers(min_len, max_len + 1, size)
        self._offsets = np.concatenate(
            [[0], np.cumsum(lengths)]).astype(np.int64)
        self._tokens = rng.integers(
            0, vocab_size, int(self._offsets[-1]), dtype=np.int32)
        self._size = size
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __len__(self) -> int:
        return self._size

    def doc(self, i: int) -> np.ndarray:
        return self._tokens[self._offsets[i]:self._offsets[i + 1]]

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        out = np.zeros((len(indices), self.max_len), dtype=np.int32)
        for r, i in enumerate(np.asarray(indices)):
            d = self.doc(int(i))
            out[r, :len(d)] = d
        return {"tokens": out}


class MemmapTokenDataset:
    """Token corpus over a flat binary file of token ids (np.memmap), the
    standard 'tokenized shard on shared storage' layout for real LM
    pretraining. Rows are non-overlapping windows of ``seq_len + 1``."""

    def __init__(self, path: str, seq_len: int, dtype: str = "uint16",
                 vocab_size: int = 50257):
        self._data = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self._size = (len(self._data) - 1) // seq_len
        if self._size <= 0:
            raise ValueError(f"{path} too small for seq_len={seq_len}")

    def __len__(self) -> int:
        return self._size

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        starts = indices.astype(np.int64) * self.seq_len
        offsets = np.arange(self.seq_len + 1, dtype=np.int64)
        window = starts[:, None] + offsets[None, :]
        return {"tokens": np.asarray(self._data[window], dtype=np.int32)}


class SubsetDataset:
    """Index-remapped view of a base dataset (no copy)."""

    def __init__(self, base, indices: np.ndarray):
        self._base = base
        self._indices = np.asarray(indices, dtype=np.int64)
        # Surface base attributes models/loaders key off (vocab_size,
        # seq_len, num_classes, ...).
        for attr in ("vocab_size", "seq_len", "num_classes"):
            if hasattr(base, attr):
                setattr(self, attr, getattr(base, attr))

    def __len__(self) -> int:
        return len(self._indices)

    def batch(self, indices: np.ndarray) -> Mapping[str, np.ndarray]:
        return self._base.batch(self._indices[indices])


def train_eval_split(ds, eval_fraction: float, seed: int = 0,
                     multiple_of: int = 1):
    """Deterministic disjoint (train, eval) split of a map-style
    dataset. The permutation is seed-keyed and identical on every
    process (same contract as the sampler's shuffle).

    ``multiple_of``: round the eval size UP to this multiple (callers
    pass the global batch size). With an exact multiple, the sharded
    loader never wrap-pads eval batches, so val_loss is an exact mean
    over the eval rows — padding would double-count duplicated rows
    and make val_loss depend on the pod's shard count."""
    if not 0.0 < eval_fraction < 1.0:
        raise ValueError(
            f"eval_fraction must be in (0, 1), got {eval_fraction}")
    if multiple_of < 1:
        raise ValueError(f"multiple_of must be >= 1, got {multiple_of}")
    n = len(ds)
    n_eval = max(1, int(round(n * eval_fraction)))
    n_eval = -(-n_eval // multiple_of) * multiple_of  # ceil to multiple
    if n_eval >= n:
        raise ValueError(
            f"eval_fraction={eval_fraction} (rounded to a multiple of "
            f"{multiple_of} -> {n_eval}) leaves no training data "
            f"(dataset size {n})")
    perm = np.random.default_rng(seed).permutation(n)
    return (SubsetDataset(ds, perm[n_eval:]),
            SubsetDataset(ds, perm[:n_eval]))


def build_dataset(name: str, _defaults: dict | None = None,
                  **kwargs) -> Dataset:
    """Dataset registry keyed by config ``train.dataset``.

    ``_defaults`` are soft kwargs (size/seed from TrainConfig) applied
    only when the builder accepts them and the user didn't override —
    file-backed datasets like ``memmap_tokens`` take neither.
    Explicit ``kwargs`` are passed through unfiltered so typos fail loudly.
    """
    builders = {
        "synthetic": SyntheticRegressionDataset,
        "synthetic_normal": lambda **kw: SyntheticRegressionDataset(
            kind="normal", **kw),
        "synthetic_linear": lambda **kw: SyntheticRegressionDataset(
            kind="linear", **kw),
        "synthetic_lm": SyntheticLMDataset,
        "synthetic_doc": SyntheticDocDataset,
        "synthetic_images": SyntheticImageDataset,
        "memmap_tokens": MemmapTokenDataset,
        # Byte-level LM over ANY local file: the zero-dependency real-
        # data path (subword tokenizers need downloaded vocab files;
        # bytes need nothing). vocab_size 256, uint8 storage.
        "bytes": lambda path, seq_len: MemmapTokenDataset(
            path, seq_len, dtype="uint8", vocab_size=256),
    }
    if name not in builders:
        raise ValueError(
            f"unknown dataset '{name}'; known: {sorted(builders)}")
    builder = builders[name]
    if _defaults:
        try:
            sig = inspect.signature(builder)
            accepted = {
                k: v for k, v in _defaults.items()
                if k in sig.parameters or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in sig.parameters.values())
            }
        except (TypeError, ValueError):  # pragma: no cover
            accepted = dict(_defaults)
        kwargs = {**accepted, **kwargs}
    return builder(**kwargs)

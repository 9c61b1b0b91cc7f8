"""Host-side data kernels of the port (counterpart of ``native/``).

Only ``fill_tokens`` on its NumPy SplitMix64 path: the JAX package's
C++ fill and its NumPy fallback draw the same stream, so the synthetic
corpus here is bit-identical to the JAX package's. The multithreaded C++
gather and fill wait for ROADMAP.md queue A item 2; NumPy's fancy
indexing and this vectorized fill are exact stand-ins.
"""

from __future__ import annotations

import numpy as np

_FILL_BLOCK = 4096  # the C++ fill's block constant
_SM64_GAMMA = 0x9E3779B97F4A7C15
_SM64_M1 = 0xBF58476D1CE4E5B9
_SM64_M2 = 0x94D4A2CA9C8DE917
_FILL_STREAM = 0xD1342543DE82EF95


def fill_tokens(seed: int, vocab: int, n: int) -> np.ndarray:
    """n int32 tokens uniform in [0, vocab), deterministic in seed.

    Per 4096-token block ``b``: state ``s0 = seed ^ (STREAM * (b+1))``;
    draw ``i`` mixes ``s0 + (i+1) * GAMMA`` through the SplitMix64
    finalizer; token = mix % vocab. All modular uint64: NumPy unsigned
    arithmetic wraps exactly like C."""
    n_blocks = (n + _FILL_BLOCK - 1) // _FILL_BLOCK
    seed_u = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    b = np.arange(1, n_blocks + 1, dtype=np.uint64)
    s0 = seed_u ^ (np.uint64(_FILL_STREAM) * b)          # (n_blocks,)
    i = np.arange(1, _FILL_BLOCK + 1, dtype=np.uint64)
    z = s0[:, None] + i[None, :] * np.uint64(_SM64_GAMMA)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(_SM64_M1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(_SM64_M2)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32).reshape(-1)[:n]

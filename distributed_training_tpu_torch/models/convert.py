"""Carry JAX-package weights into the port, leaf for leaf.

``from_jax_params`` takes the nested dict that
``distributed_training_tpu.models.transformer.Transformer.init`` returns,
converted to numpy (``jax.tree.map(np.asarray, params)``), and returns
the port's weight pytree: the same keys, the same stacked ``(L, …)``
shapes, no ``lm_head`` when embeddings are tied (the head is
``tok_embed.T`` on both sides). This module imports neither framework's
model code from the other: it checks the tree against
``param_shapes(cfg)``.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_training_tpu_torch.models.transformer import (
    TransformerConfig,
    param_shapes,
    torch_dtype,
)
from distributed_training_tpu_torch.runtime import resolve_device


def from_jax_params(np_tree: dict, cfg: TransformerConfig,
                    device=None) -> dict:
    """numpy weight tree → the port's tensors on ``device`` (None → the
    CUDA card), in ``cfg.param_dtype``. Raises ``ValueError`` on a
    missing or extra key or a wrong shape."""
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)

    def conv(node, expected, path):
        if isinstance(expected, dict):
            if not isinstance(node, dict) or set(node) != set(expected):
                got = sorted(node) if isinstance(node, dict) else node
                raise ValueError(
                    f"weights at '{path or '/'}': keys {got} != expected "
                    f"{sorted(expected)}")
            return {k: conv(node[k], expected[k], f"{path}/{k}")
                    for k in expected}
        arr = np.asarray(node)
        if arr.shape != tuple(expected):
            raise ValueError(f"weights at '{path}': shape {arr.shape} != "
                             f"expected {tuple(expected)}")
        # via f32: numpy has no native bf16, and bf16 -> f32 is exact.
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=pdt)

    return conv(np_tree, param_shapes(cfg), "")

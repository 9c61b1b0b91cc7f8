"""Carry JAX-package weights into the port, leaf for leaf.

``mlp_from_jax_params`` does the same for the MLP's ``{"layer<i>":
{"w", "b"}}`` tree against ``MLP.param_shapes()``, and
``resnet_from_jax_params`` for ResNet's against ``ResNet.param_shapes()``
(each stage's list of blocks becomes a dict keyed by the block's index).

``from_jax_params`` takes the nested dict that
``distributed_training_tpu.models.transformer.Transformer.init`` returns,
converted to numpy (``jax.tree.map(np.asarray, params)``), and returns
the port's weight pytree: the same keys, the same stacked ``(L, …)``
shapes, no ``lm_head`` when embeddings are tied (the head is
``tok_embed.T`` on both sides), and under MoE the ``mlp`` leaves
``router`` (L, D, E), ``wi`` (L, E, D, F) and ``wo`` (L, E, F, D). This
module imports neither framework's model code from the other: it checks
the tree against ``param_shapes(cfg)``.

An int8 weight-only tree (``serving/disagg.py::quantize_params_int8``,
or the JAX package's) carries across too: a ``{"qw", "scale"}`` node at
a ``_QUANT_AXES`` site becomes an int8 ``qw`` of the weight's shape and
an f32 ``scale`` of its keepdims shape, never cast to the param dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_training_tpu_torch.models.transformer import (
    _QUANT_AXES,
    TransformerConfig,
    param_shapes,
    torch_dtype,
)
from distributed_training_tpu_torch.runtime import resolve_device


def from_jax_params(np_tree: dict, cfg: TransformerConfig,
                    device=None) -> dict:
    """numpy weight tree → the port's tensors on ``device`` (None → the
    CUDA card), in ``cfg.param_dtype`` (int8 leaves as int8 and f32).
    Raises ``ValueError`` on a missing or extra key or a wrong shape."""
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)

    def tensor(node, shape, dtype, path):
        arr = np.asarray(node)
        if arr.shape != tuple(shape):
            raise ValueError(f"weights at '{path}': shape {arr.shape} != "
                             f"expected {tuple(shape)}")
        if dtype == torch.int8:
            if arr.dtype != np.int8:
                raise ValueError(f"weights at '{path}': dtype {arr.dtype} "
                                 "!= int8")
            return torch.from_numpy(np.array(arr)).to(dev)
        # via f32: numpy has no native bf16, and bf16 -> f32 is exact.
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    def conv(node, expected, path):
        site = tuple(path.strip("/").split("/"))
        if site in _QUANT_AXES and isinstance(node, dict):
            if set(node) != {"qw", "scale"}:
                raise ValueError(f"int8 leaf at '{path}': keys "
                                 f"{sorted(node)} != ['qw', 'scale']")
            kept = [1 if d in _QUANT_AXES[site] else n
                    for d, n in enumerate(expected)]
            return {"qw": tensor(node["qw"], expected, torch.int8,
                                 f"{path}/qw"),
                    "scale": tensor(node["scale"], kept, torch.float32,
                                    f"{path}/scale")}
        if isinstance(expected, dict):
            if not isinstance(node, dict) or set(node) != set(expected):
                got = sorted(node) if isinstance(node, dict) else node
                raise ValueError(
                    f"weights at '{path or '/'}': keys {got} != expected "
                    f"{sorted(expected)}")
            return {k: conv(node[k], expected[k], f"{path}/{k}")
                    for k in expected}
        return tensor(node, expected, pdt, path)

    return conv(np_tree, param_shapes(cfg), "")


def mlp_from_jax_params(np_tree: dict, model, device=None) -> dict:
    """An MLP's numpy weight tree (``jax.tree.map(np.asarray, params)``
    of the JAX ``MLP.init``) → the port's f32 tensors on ``device`` (None
    → the CUDA card). Raises ``ValueError`` on a missing or extra key or
    a wrong shape."""
    dev = resolve_device(device)
    want = model.param_shapes()
    if set(np_tree) != set(want):
        raise ValueError(f"MLP weights: layers {sorted(np_tree)} != "
                         f"expected {sorted(want)}")
    out = {}
    for layer, leaves in want.items():
        if set(np_tree[layer]) != set(leaves):
            raise ValueError(f"MLP weights at '{layer}': keys "
                             f"{sorted(np_tree[layer])} != ['b', 'w']")
        out[layer] = {}
        for k, shape in leaves.items():
            arr = np.array(np_tree[layer][k], dtype=np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(f"MLP weights at '{layer}/{k}': shape "
                                 f"{arr.shape} != expected {shape}")
            out[layer][k] = torch.from_numpy(arr).to(dev)
    return out


def resnet_from_jax_params(np_tree: dict, model, device=None) -> dict:
    """A ResNet's numpy weight tree (``jax.tree.map(np.asarray, params)``
    of the JAX ``ResNet.init``) → the port's f32 tensors on ``device``
    (None → the CUDA card): each ``stage<i>`` list of blocks becomes
    ``{"0": block, "1": block, …}``. Raises ``ValueError`` on a missing
    or extra key or a wrong shape."""
    dev = resolve_device(device)

    def conv(node, expected, path):
        if isinstance(node, (list, tuple)):
            node = {str(i): blk for i, blk in enumerate(node)}
        if isinstance(expected, dict):
            if not isinstance(node, dict) or set(node) != set(expected):
                got = sorted(node) if isinstance(node, dict) else node
                raise ValueError(
                    f"ResNet weights at '{path or '/'}': keys {got} != "
                    f"expected {sorted(expected)}")
            return {k: conv(node[k], expected[k], f"{path}/{k}")
                    for k in expected}
        arr = np.array(node, dtype=np.float32)
        if arr.shape != tuple(expected):
            raise ValueError(f"ResNet weights at '{path}': shape "
                             f"{arr.shape} != expected {tuple(expected)}")
        return torch.from_numpy(arr).to(dev)

    return conv(np_tree, model.param_shapes(), "")

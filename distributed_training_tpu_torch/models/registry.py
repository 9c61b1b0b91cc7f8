"""Model registry keyed by config ``model.name`` (port of
``models/registry.py``)."""

from __future__ import annotations

from typing import Any

_TRANSFORMERS = ("transformer", "gpt2", "gpt2_125m", "gpt2_350m",
                 "transformer_1b", "transformer_7b", "moe_transformer")


def build_model(name: str, loss: str = "auto", dtype: str = "float32",
                device=None, **kwargs: Any):
    """Construct a model family from config, as the JAX ``build_model``
    (``loss="auto"`` keeps the family's default: mse for the MLP,
    next-token xent for a transformer). ``device`` as ``Transformer``
    (None = the CUDA card). ResNet ignores ``loss``, as the JAX
    branch does."""
    name = name.lower()
    if name == "mlp":
        from distributed_training_tpu_torch.models.mlp import MLP, MLPConfig
        return MLP(MLPConfig(loss_name="mse" if loss == "auto" else loss,
                             dtype=dtype, **kwargs), device=device)
    if name in _TRANSFORMERS:
        from distributed_training_tpu_torch.models.transformer import (
            build_transformer,
        )
        return build_transformer(name, loss=loss, dtype=dtype,
                                 device=device, **kwargs)
    if name in ("resnet", "resnet18"):
        from distributed_training_tpu_torch.models.resnet import ResNet
        return ResNet(dtype=dtype, device=device, **kwargs)
    raise ValueError(f"unknown model '{name}'")

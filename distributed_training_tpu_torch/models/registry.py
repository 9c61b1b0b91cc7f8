"""Model registry keyed by config ``model.name`` (port of
``models/registry.py``)."""

from __future__ import annotations

from typing import Any

_TRANSFORMERS = ("transformer", "gpt2", "gpt2_125m", "gpt2_350m",
                 "transformer_1b", "transformer_7b", "moe_transformer")


def build_model(name: str, loss: str = "auto", dtype: str = "float32",
                device=None, **kwargs: Any):
    """Construct a model family from config, as the JAX ``build_model``
    (``loss="auto"`` keeps the family's default). ``device`` as
    ``Transformer`` (None = the CUDA card). The MLP and ResNet families
    wait for ROADMAP.md queue A items 2 and 16."""
    name = name.lower()
    if name in _TRANSFORMERS:
        from distributed_training_tpu_torch.models.transformer import (
            build_transformer,
        )
        return build_transformer(name, loss=loss, dtype=dtype,
                                 device=device, **kwargs)
    if name in ("mlp", "resnet", "resnet18"):
        raise NotImplementedError(
            f"model '{name}' waits for ROADMAP.md queue A "
            f"item {2 if name == 'mlp' else 16}")
    raise ValueError(f"unknown model '{name}'")

"""Model helpers shared by the port's model families (port of
``models/base.py``)."""

from __future__ import annotations

import math
from typing import Any

import torch


def count_params(params: Any) -> int:
    """Elements in a nested dict of tensors."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())


def uniform_fan_in(gen: torch.Generator, shape: tuple, fan_in: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``gen`` (the JAX ``uniform_fan_in``'s family; the two
    frameworks draw different numbers from one seed)."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=device or gen.device)
    return (u * (2 * bound) - bound).to(dtype)


def normal_init(gen: torch.Generator, shape: tuple, std: float,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``std`` times a standard normal draw from ``gen`` (the JAX
    ``normal_init``; the two frameworks draw different numbers from one
    seed)."""
    z = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (z * std).to(dtype)

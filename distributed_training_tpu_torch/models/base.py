"""Model helpers shared by the port's model families (port of
``models/base.py``)."""

from __future__ import annotations

from typing import Any


def count_params(params: Any) -> int:
    """Elements in a nested dict of tensors."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())

"""Parallelism strategies of the port and their collectives."""

from distributed_training_tpu_torch.parallel.strategy import (
    check_strategy,
    get_strategy,
)

__all__ = ["check_strategy", "get_strategy"]

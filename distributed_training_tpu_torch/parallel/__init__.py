"""Parallelism strategies of the port."""

from distributed_training_tpu_torch.parallel.strategy import get_strategy

__all__ = ["get_strategy"]

"""Checkpointing of the port."""

from distributed_training_tpu_torch.checkpoint.manager import Checkpointer

__all__ = ["Checkpointer"]

"""The host-staging rule of the port's point-to-point exchanges.

A gloo process group moves CPU tensors only, so an exchange of a card's
tensors over gloo copies them to the host before the send and back to
the card after the receive (each copy counted by its caller); a NCCL
group sends device tensors as they are. Sequence parallelism's ring and
all-to-all (``parallel/ring_attention.py``) and the pipeline's
activations and gradients (``parallel/pipeline.py``) both apply it.
"""

from __future__ import annotations

import torch


def through_host(device: torch.device | torch.Tensor,
                 backend: str | None) -> bool:
    """Whether a tensor on ``device`` (or the tensor itself) goes through
    host memory over a group of ``backend``: a card's tensor over gloo."""
    dev = device.device if isinstance(device, torch.Tensor) else device
    return torch.device(dev).type == "cuda" and backend == "gloo"

"""Train state (port of ``train/state.py``).

``{"params", "opt_state", "step"}``: the unit the checkpoint saves and
restores. ``params`` is the model's nested dict of leaf tensors, marked
to require gradients; the trainer updates them in place (the JAX state is
immutable and donated; updating in place keeps one copy of the weights on
the card). ``opt_state`` is ``Optimizer.init``'s dict and ``step`` the
number of steps taken, a Python int.
"""

from __future__ import annotations

from distributed_training_tpu_torch.train.optimizer import flatten


def with_grad(params: dict) -> dict:
    """Mark every leaf as an autograd leaf that requires gradients."""
    for p in flatten(params).values():
        p.requires_grad_(True)
    return params


def init_state(model, optimizer, seed: int) -> dict:
    """Fresh params from ``seed`` on the model's device, and the
    optimizer state for them."""
    params = with_grad(model.init(seed))
    return {"params": params,
            "opt_state": optimizer.init(flatten(params)),
            "step": 0}

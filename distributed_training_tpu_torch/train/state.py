"""Train state (port of ``train/state.py``).

``{"params", "opt_state", "step"}``: the unit the checkpoint saves and
restores. ``params`` is the model's nested dict of leaf tensors, marked
to require gradients; the trainer updates them in place (the JAX state is
immutable and donated; updating in place keeps one copy of the weights on
the card). ``opt_state`` is ``Optimizer.init``'s dict and ``step`` the
number of steps taken, a Python int.

Under a sharded strategy every leaf holds this process's shard, as the
trainer's layout places it (``parallel/strategy.py``): params per
``param_spec``, moments per ``opt_spec``. The init is the same whole
tree on every process (one seed), then cut to the local shards.
"""

from __future__ import annotations

from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten


def with_grad(params: dict) -> dict:
    """Mark every leaf as an autograd leaf that requires gradients."""
    for p in flatten(params).values():
        p.requires_grad_(True)
    return params


def init_state(model, optimizer, seed: int, layout: dict | None = None,
               runtime=None, params: dict | None = None) -> dict:
    """Fresh params from ``seed`` (or the whole tree ``params``) on the
    model's device, cut to this process's shards by ``layout``, and the
    optimizer state for them."""
    full = flatten(params if params is not None else model.init(seed))
    if layout is None:
        local, moments = full, full
    else:
        local = {k: fsdp.shard(t, layout["params"][k], runtime)
                 for k, t in full.items()}
        # Moments laid out like their param share its shard; ZeRO-1's
        # (params replicated) take a slice of the whole param.
        moments = {k: local[k] if layout["opt"][k] == layout["params"][k]
                   else fsdp.local_view(t, layout["opt"][k], runtime)
                   for k, t in full.items()}
    del full
    return {"params": with_grad(unflatten(local)),
            "opt_state": optimizer.init(moments),
            "step": 0}

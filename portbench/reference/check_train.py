"""The training cells' comparison with the plain reference.

The reference takes the weights again from the seed and the rows the
program's first steps consumed, and trains them for the same steps in
float32 (TF32 off), in blocks of rows so that it fits on the card. Each
number compared is relative:

- ``loss_step<i>``: the gap between the program's loss of step ``i`` and
  the reference's, over the reference's;
- ``grad_leaf``: the first step's gradient as the optimizer took it
  (the program's from its first moment after one step, ``mu / (1 -
  b1)``), by the worst leaf: the gap between the program's norm of the
  leaf and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change_leaf``: the same of each leaf's change over the steps, left
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.reference.model import Reference
from portbench.reference.optim import AdamW

QUIET_GRAD = 1e-3


def train_reference(cfg: dict, opt: dict, seed: int, steps: list,
                    device, rows_per_block: int, low: bool = False,
                    half: bool = False) -> dict:
    """The reference's losses, first-step gradient norms and change
    norms by leaf over ``steps`` (each the step's rows, (B, S + 1)
    int). ``low``: fp8 matmuls (the control); ``half``: each step's
    loss taken over the first half of its rows alone (a fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = weights.flat(weights.make(cfg, seed, device))
    start = {k: p.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    model = Reference(cfg, low=low)
    adam = AdamW(opt, params)
    losses, first = [], None
    for rows in steps:
        rows = torch.as_tensor(np.asarray(rows), device=device).long()
        if half:
            rows = rows[: rows.shape[0] // 2]
        count = rows.shape[0] * (rows.shape[1] - 1)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        total = torch.zeros((), device=device)
        tree = weights.nest(params)
        for b in range(0, rows.shape[0], rows_per_block):
            nll = model.nll_sum(tree, rows[b:b + rows_per_block])
            parts = torch.autograd.grad(nll, list(params.values()))
            for k, g in zip(params, parts):
                grads[k] += g
            total += nll.detach()
            del nll, parts
        grads = {k: g / count for k, g in grads.items()}
        losses.append(float(total / count))
        taken = adam.step(params, grads)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g))
                     for k, g in taken.items()}
        del grads, taken
    change = {k: float(torch.linalg.vector_norm(params[k].detach()
                                                - start[k]))
              for k in params}
    return {"losses": losses, "grad": first, "change": change}


def _worst_leaf(got: dict, want: dict, keys) -> float:
    keys = list(keys)
    median = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30)
               for k in keys)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared (module docstring)."""
    out = {f"loss_step{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    out["grad_leaf"] = _worst_leaf(prog["grad"], ref["grad"], ref["grad"])
    median = float(np.median(list(ref["grad"].values())))
    moving = [k for k, g in ref["grad"].items() if g >= QUIET_GRAD * median]
    out["change_leaf"] = _worst_leaf(prog["change"], ref["change"], moving)
    return out

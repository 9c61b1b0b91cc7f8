"""Optimizer construction (port of ``train/optimizer.py``).

Plain functions over the flat param dict that follow the JAX package's
optax chain step for step: ``clip_by_global_norm`` (when
``grad_clip_norm`` > 0), then ``sgd`` or ``adamw`` (decoupled weight
decay on the old params, ``eps`` outside the square root, bias
correction from the update count) scaled by the learning-rate schedule
(constant or cosine with floor ``alpha=0.1``, after a linear warmup that
gives lr 0 on the very first update). Every quantity the optax chain
computes in f32 is computed in f32 here. Adafactor waits for ROADMAP.md
queue A item 2.

The state is a dict: ``count`` (updates applied so far, a Python int,
so the schedule needs no device sync) plus ``mu``/``nu`` keyed like the
params; the checkpoint saves it as it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# optax.adamw's default epsilon (outside the square root).
_EPS = 1e-8
# Leaf names that never decay under decay_mask="matrices", whatever their
# rank (stacked per-layer norms and biases are (L, D)).
_NO_DECAY_KEYS = frozenset({"b", "bi", "bo", "bias", "scale"})


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict of tensors → {"a/b": tensor} in sorted key order (a
    JAX pytree's leaf order, so sums over leaves add in the same
    order)."""
    out = {}
    for k, v in sorted(tree.items()):
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _f32(x) -> np.float32:
    return np.float32(x)


def build_schedule(cfg, total_steps: int):
    """count (int) → learning rate, evaluated in f32 as optax does."""
    base = _f32(cfg.learning_rate)
    if cfg.lr_schedule == "constant":
        def sched(count):
            return base
    elif cfg.lr_schedule == "cosine":
        decay_steps = _f32(max(total_steps - cfg.warmup_steps, 1))
        alpha = 0.1

        def sched(count):
            c = np.minimum(_f32(count), decay_steps)
            cosine = _f32(0.5) * (_f32(1) + np.cos(
                _f32(math.pi) * c / decay_steps))
            return base * (_f32(1 - alpha) * cosine + _f32(alpha))
    else:
        raise ValueError(f"unknown lr_schedule '{cfg.lr_schedule}'")
    if cfg.warmup_steps <= 0:
        return sched
    warmup = cfg.warmup_steps
    after = sched

    def joined(count):
        if count < warmup:
            # linear_schedule(0, base, warmup): lr 0 at count 0.
            frac = _f32(1) - _f32(min(max(count, 0), warmup)) / _f32(warmup)
            return (_f32(0) - base) * frac + base
        return after(count - warmup)
    return joined


def _matrices_mask(params: dict) -> dict:
    """path → decays? A leaf decays iff it is >= 2-D and its name is not
    a bias/scale name."""
    return {path: p.dim() >= 2 and path.rsplit("/", 1)[-1]
            not in _NO_DECAY_KEYS for path, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


@dataclass
class Optimizer:
    """The optax chain as ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)`` over flat dicts
    of tensors (``params + updates`` is the new params)."""

    kind: str
    schedule: object
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.0
    decay_mask: str = "all"
    clip_norm: float = 0.0

    def init(self, params: dict) -> dict:
        state = {"count": 0}
        if self.kind == "adamw":
            state["mu"] = {k: torch.zeros_like(p) for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def update(self, grads: dict, state: dict,
               params: dict) -> tuple[dict, dict]:
        count = state["count"]
        if self.clip_norm > 0:
            gn = global_norm(grads.values())
            clip = torch.tensor(self.clip_norm, dtype=torch.float32,
                                device=gn.device)
            keep = gn < clip
            grads = {k: torch.where(keep, g, (g / gn.to(g.dtype)) * clip)
                     for k, g in grads.items()}
        lr = float(self.schedule(count))
        new = {"count": count + 1}
        if self.kind == "sgd":
            updates = {k: g * -lr for k, g in grads.items()}
            return updates, new
        n = count + 1
        bc1 = float(_f32(1) - _f32(self.b1) ** n)
        bc2 = float(_f32(1) - _f32(self.b2) ** n)
        decay = (_matrices_mask(params) if self.decay_mask == "matrices"
                 else dict.fromkeys(params, True))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS)
            if self.weight_decay and decay[k]:
                u = u + self.weight_decay * params[k]
            updates[k] = u * -lr
        new["mu"], new["nu"] = mu, nu
        return updates, new


def build_optimizer(cfg, total_steps: int) -> Optimizer:
    """The optimizer for a ``TrainConfig``, as the JAX
    ``build_optimizer``."""
    if cfg.decay_mask not in ("all", "matrices"):
        raise ValueError(f"unknown decay_mask '{cfg.decay_mask}' "
                         "(expected 'all' or 'matrices')")
    if cfg.optimizer == "adafactor":
        raise NotImplementedError(
            "adafactor waits for ROADMAP.md queue A item 2 "
            "(train/optimizer.py)")
    if cfg.optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer '{cfg.optimizer}'")
    return Optimizer(kind=cfg.optimizer,
                     schedule=build_schedule(cfg, total_steps),
                     b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay,
                     decay_mask=cfg.decay_mask,
                     clip_norm=cfg.grad_clip_norm or 0.0)

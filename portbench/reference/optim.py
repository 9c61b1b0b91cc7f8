"""AdamW as the configurations state it (optax's chain): the gradients
clipped to a global norm, then Adam with the bias corrections of the
update count, ``eps`` outside the square root, and weight decay
decoupled from the gradient on every leaf; the learning rate rises
linearly from 0 over the warmup (0 on the first update), then follows
a cosine to a tenth of its peak."""

from __future__ import annotations

import math

import torch


def learning_rate(opt: dict, count: int) -> float:
    base, warm = opt["learning_rate"], opt["warmup_steps"]
    if count < warm:
        return base * count / warm
    decay = max(opt["total_steps"] - warm, 1)
    c = min(count - warm, decay)
    return base * (0.9 * 0.5 * (1 + math.cos(math.pi * c / decay)) + 0.1)


class AdamW:
    def __init__(self, opt: dict, params: dict):
        self.opt = opt
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        """Update the flat ``params`` in place; returns the gradients as
        the moments took them (after the clip)."""
        o = self.opt
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if o["grad_clip_norm"] > 0 and gnorm >= o["grad_clip_norm"]:
            grads = {k: g * (o["grad_clip_norm"] / gnorm)
                     for k, g in grads.items()}
        lr = learning_rate(o, self.count)
        self.count += 1
        n, b1, b2 = self.count, o["b1"], o["b2"]
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
                self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
                u = ((self.mu[k] / (1 - b1 ** n))
                     / (torch.sqrt(self.nu[k] / (1 - b2 ** n)) + o["eps"]))
                params[k].sub_(lr * (u + o["weight_decay"] * params[k]))
        return grads

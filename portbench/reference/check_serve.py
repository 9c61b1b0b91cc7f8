"""The serving cells' comparison with the plain reference.

Greedy serving is judged token by token: the reference runs once over
each sampled request's prompt and served tokens (float32 on the served
weights' values, TF32 off), and at every served position reads how far
below its own best logit the served token's logit lies. The number
compared, ``served_gap``, is the widest such gap over the sample. The
control puts the fp8 reference in the program's place: at the same
positions it reads the gap of the token the fp8 logits put first.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.reference.model import Reference


def sample(finished: list, seed: int, want_tokens: int) -> list:
    """Requests drawn from ``seed`` among ``finished`` (dicts with
    ``prompt`` and ``tokens``), the longest always among them, until
    ``want_tokens`` served tokens are in."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: (
        len(finished[i]["prompt"]) + len(finished[i]["tokens"])))
    order = np.random.default_rng(seed).permutation(len(finished))
    picked, n = [longest], len(finished[longest]["tokens"])
    for i in order:
        if n >= want_tokens:
            break
        if i != longest:
            picked.append(int(i))
            n += len(finished[i]["tokens"])
    return [finished[i] for i in picked]


def served_weights(cfg: dict, seed: int, device, dtype: str) -> dict:
    """The weights as served (made in f32, cast to the served type),
    back in f32 for the reference."""
    w = weights.make(cfg, seed, device, getattr(torch, dtype))
    return {k: v.float() for k, v in weights.flat(w).items()}


@torch.no_grad()
def gaps(cfg: dict, params: dict, requests: list, device,
         low: bool = False) -> list:
    """Per request, the gap at each served position: of the served token
    (``low`` False), or of the fp8 reference's first choice (``low``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = weights.nest(params)
    ref = Reference(cfg)
    ctl = Reference(cfg, low=True) if low else None
    out = []
    for r in requests:
        prompt, served = list(r["prompt"]), list(r["tokens"])
        seq = torch.tensor([prompt + served[:-1]], device=device)
        at = slice(len(prompt) - 1, len(prompt) - 1 + len(served))
        logits = ref.logits(tree, seq)[0, at]
        if ctl is not None:
            pick = ctl.logits(tree, seq)[0, at].argmax(-1)
        else:
            pick = torch.tensor(served, device=device)
        best = logits.max(-1).values
        got = logits.gather(-1, pick[:, None])[:, 0]
        out.append((best - got).cpu().numpy())
    return out


def served_gap(per_request: list) -> float:
    return float(max(g.max() for g in per_request)) if per_request else \
        float("inf")

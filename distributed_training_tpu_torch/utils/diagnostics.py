"""Replica-drift diagnostics (port of ``utils/diagnostics.py``).

``replica_divergence``: are the replicas of every param bitwise in sync?
Each process fingerprints its copy of each leaf (a shard is fingerprinted
in place), the int32 fingerprints are all-gathered over the leaf's group
of replicas (the mesh axes it is replicated on: the data axes, and tp for
a leaf tensor parallelism leaves whole), and a leaf's divergence is the
spread (max - min) of its fingerprints: 0 on every leaf ⇔ the replicas
are identical.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def fingerprint(x: torch.Tensor) -> int:
    """Order-stable int32 fingerprint of a tensor's f32 bits: the JAX
    package's ``_fingerprint``, ``sum(bits * (idx % 8191 + 1))`` with
    int32 wrap-around. Computed in int64 (whose wrap-around agrees
    modulo 2**32) and reduced to int32; sensitive to any elementwise
    change."""
    bits = x.detach().float().contiguous().view(torch.int32).to(torch.int64)
    idx = torch.arange(bits.numel(), dtype=torch.int64,
                       device=bits.device).view(bits.shape)
    s = int(torch.sum(bits * (idx % 8191 + 1))) & 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


def replica_divergence(params: dict, groups: dict) -> dict:
    """Per leaf of the flat dict ``params``: the spread of its
    fingerprints over the processes of its group of replicas,
    ``groups[path]`` (a leaf without one has none: spread 0). One
    all-gather per group, in the order the groups first appear:
    collective on every process, each passing its own slices' groups
    for the same axes. ``{"max_divergence": int, "leaves": {path:
    int}}``."""
    leaves = dict.fromkeys(params, 0)
    by_group: dict = {}
    for k, g in groups.items():
        by_group.setdefault(id(g), (g, []))[1].append(k)
    for group, keys in by_group.values():
        local = torch.tensor([fingerprint(params[k]) for k in keys],
                             dtype=torch.int64, device=params[keys[0]].device)
        n = dist.get_world_size(group)
        every = local.new_empty(n * len(keys))
        dist.all_gather_into_tensor(every, local, group=group)
        every = every.view(n, len(keys))
        spread = (every.max(0).values - every.min(0).values).tolist()
        leaves.update(zip(keys, (int(v) for v in spread)))
    worst = max(leaves.values(), default=0)
    if worst > 0:
        logger.warning("replica divergence detected: %s",
                       {k: v for k, v in leaves.items() if v > 0})
    return {"max_divergence": worst, "leaves": leaves}

"""Expert parallelism's collectives: the MoE router's load-balancing
statistics over the data shards, and the routing positions across the
sequence slices.

In the JAX package one SPMD program sees the whole global batch, so the
router's statistics (``_moe_router``: each expert's share of the
(token, slot) assignments and its mean probability) are means over every
data shard, and the slot-major cumsum that gives a (token, slot) its
place in an expert's capacity buffer runs over a routing group's whole
sequence, across the ``sp`` shards. Here each process holds its data
shard's rows and its slice of their sequence, and the MoE block
(``Transformer._block``) calls these itself:

- ``DataGroup`` is the model's binding (``Transformer.bind_data_group``):
  the group of the processes that hold parts of one global batch (the
  ``dp``, ``fsdp`` and ``sp`` axes; not ``tp``, whose ranks compute the
  same routing, nor ``pp``, whose stages run other layers). ``aux``
  all-reduces each expert's assignment count and probability sum and
  the count of live tokens in one collective and returns the global
  aux. Its value is JAX's; its gradient is this process's share of the
  global aux's, which is linear in the local probability sums once the
  assignment shares (which carry no gradient) are global: the sum of
  the shares over the group is the global gradient. The share is scaled
  by ``grad_scale`` (the model passes the data shards over the weight
  the trainer puts on this shard's loss), so that the trainer's weighting
  and its mean over the data shards leave exactly the share.
- ``slot_counts`` all-gathers over the ``sp`` group each slice's count
  of (token, slot) assignments per (row, group, slot, expert): a rank's
  place for a token of slot ``j`` follows every assignment of the
  group's earlier slots (all slices) and those of slot ``j`` on the
  slices before its own.

The expert weights need no collective of their own: the sharding rules
store their ``expert`` dim split over ``fsdp`` (``parallel/strategy.py``)
and ``parallel/fsdp.py`` gathers each layer's whole for compute and
reduce-scatters its gradient, as for every other sharded leaf.

``EXCHANGES`` counts the collectives launched since the last reset:
``"aux"`` one per MoE layer per forward, ``"slot_counts"`` one per MoE
layer per forward under sp. ``ROUTING`` accumulates the routed
dispatch's (token, slot) pairs (``"pairs"``, a Python int) and those
capacity dropped (``"dropped"``, a tensor on the device, so that reading
it is the only host sync).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.telemetry import collectives

EXCHANGES: collections.Counter = collections.Counter()
ROUTING: dict = {}


def count_routing(pairs: int, dropped: torch.Tensor) -> None:
    """Add one routing's (token, slot) pairs and its dropped count."""
    ROUTING["pairs"] = ROUTING.get("pairs", 0) + pairs
    prev = ROUTING.get("dropped")
    d = dropped.detach()
    ROUTING["dropped"] = d if prev is None else prev + d


def dropped_share() -> float | None:
    """The share of routed (token, slot) pairs dropped by capacity since
    the last reset (None when nothing was routed)."""
    if not ROUTING.get("pairs"):
        return None
    return float(ROUTING["dropped"]) / ROUTING["pairs"]


def local_aux(counts: torch.Tensor, probsum: torch.Tensor, n,
              E: int) -> torch.Tensor:
    """``E · Σ_e frac_e · mean_prob_e`` of one process's statistics:
    ``counts`` (E,) assignments, ``probsum`` (E,) probability sums, over
    ``n`` live tokens."""
    return E * torch.sum((counts / n) * (probsum / n))


class DataGroup:
    """The processes that hold parts of one global batch (``group``;
    None is a group of one) and the batch's data-shard count
    (``shards``, the trainer's divisor of the summed gradients)."""

    def __init__(self, group=None, shards: int = 1):
        self.group = group
        self.shards = shards

    def aux(self, counts: torch.Tensor, probsum: torch.Tensor, n,
            E: int, grad_scale: float | torch.Tensor = 1.0) -> torch.Tensor:
        """The global aux (module docstring): its value over the whole
        group, its gradient ``grad_scale`` times this process's share."""
        if self.group is None:
            return local_aux(counts, probsum, n, E)
        n = torch.as_tensor(n, dtype=torch.float32, device=probsum.device)
        stats = torch.cat([counts.float(), probsum.detach().float(),
                           n.reshape(1)])
        EXCHANGES["aux"] += 1
        dist.all_reduce(stats, group=self.group)
        collectives.record("all-reduce", self.group, stats)
        counts_g, probsum_g, n_g = stats[:E], stats[E:2 * E], stats[2 * E]
        frac = counts_g / n_g
        value = E * torch.sum(frac * (probsum_g / n_g))
        share = E * torch.sum(frac * (probsum / n_g)) * grad_scale
        return value + (share - share.detach())


def slot_counts(counts: torch.Tensor, group, rank: int) -> tuple:
    """``counts`` (B, G, k, E): this slice's assignments per (row, group,
    slot, expert). Returns (the sum over the ``sp`` group, the sum over
    the slices before this one)."""
    n = dist.get_world_size(group)
    EXCHANGES["slot_counts"] += 1
    buf = counts.new_empty(n * counts.numel())
    dist.all_gather_into_tensor(buf, counts.contiguous().reshape(-1),
                                group=group)
    collectives.record("all-gather", group, buf)
    buf = buf.view(n, *counts.shape)
    return buf.sum(0), buf[:rank].sum(0)

"""Tensor parallelism's collectives (Megatron-style), as autograd
Functions over the ``tp`` group.

In the JAX package tensor parallelism is a sharding annotation and XLA
inserts the collectives. Here the decoder block calls them itself
(``Transformer.bind_tensor_parallel``), on activations that are whole
and alike on every tp rank between blocks:

- ``copy_to_tp``: identity in the forward, all-reduce sum of the
  gradient in the backward. It goes on the input of each column-parallel
  product (q/k/v, the MLP's ``wi``, the head), where each rank's
  gradient is the part its own columns give.
- ``reduce_from_tp``: all-reduce sum in the forward, identity in the
  backward. It goes on the output of each row-parallel product (the
  attention's and the MLP's ``wo``), which each rank computes from its
  own rows.
- ``vocab_embed``: the vocab-parallel lookup. Each rank holds rows
  ``[lo, lo + V/tp)`` of the embedding; ids outside them read row 0 and
  are zeroed, and ``reduce_from_tp`` sums the ranks' parts.

- ``gather_from_tp``: the whole last dim from each rank's block of it,
  one all-gather, no gradient: the serving programs' vocab-split head,
  whose logits every tp rank needs whole to pick the same token.

``ALL_REDUCES`` counts the all-reduces each Function launched since the
last reset, as ``fsdp.GATHERS`` counts the gathers: ``copy_to_tp`` one
per backward, ``reduce_from_tp`` one per forward (the lookup's
included); ``ops/xent.py`` adds its own under ``"xent"``.
``ALL_GATHERS`` counts ``gather_from_tp``'s. A forward that activation
checkpointing re-runs re-runs what it wraps, so the model keeps
``reduce_from_tp`` outside every recomputed function.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.telemetry import collectives

ALL_REDUCES: collections.Counter = collections.Counter()
ALL_GATHERS: collections.Counter = collections.Counter()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        # The gradient may be shared with another branch (an add's
        # backward hands one tensor to both inputs): reduce a copy.
        g = g.clone(memory_format=torch.contiguous_format)
        ALL_REDUCES["copy_to_tp"] += 1
        dist.all_reduce(g, group=ctx.group)
        collectives.record("all-reduce", ctx.group, g)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        ALL_REDUCES["reduce_from_tp"] += 1
        dist.all_reduce(out, group=group)
        collectives.record("all-reduce", group, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, lo: int,
                group) -> torch.Tensor:
    """Rows ``ids`` of the whole embedding from this rank's rows
    ``table`` = ``[lo, lo + len(table))``: zero where another rank owns
    the id, summed over ``group``. The gradient of ``table`` is this
    rank's rows' own (the masked rows get none)."""
    local = ids - lo
    own = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(own, local, 0)]
    return reduce_from_tp(torch.where(own[..., None], rows, 0), group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank's block of the last dim of ``x``, laid end to end in
    rank order (one all-gather over ``group``; no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    ALL_GATHERS["gather_from_tp"] += 1
    dist.all_gather(parts, x.contiguous(), group=group)
    collectives.record("all-gather", group, parts)
    return torch.cat(parts, dim=-1)


class TPGroup:
    """The model's binding over this process's ``tp`` group: its size,
    this process's rank in it, and the Functions over it."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_tp(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_tp(x, self.group)

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return vocab_embed(table, ids, self.rank * table.shape[0],
                           self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_from_tp(x, self.group)

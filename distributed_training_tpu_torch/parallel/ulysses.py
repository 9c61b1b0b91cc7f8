"""Ulysses sequence parallelism: all-to-all over the ``sp`` group (port
of ``parallel/ulysses.py``).

The second of the two sequence-parallel layouts (DeepSpeed-Ulysses;
the other is ring attention, ``parallel/ring_attention.py``). Where the
ring keeps the queries home and rotates key/value blocks, Ulysses
re-shards twice per attention call:

    (B, S/sp, H, D)  --all_to_all-->  (B, S, H/sp, D)
         sequence-sharded                  head-sharded
    → plain local attention over the whole sequence for this member's
      head group (``ops/attention.dot_product_attention``: the flash
      forward B1 and, by default, the fused backward B2 on the card) →
    (B, S, H/sp, D)  --all_to_all-->  (B, S/sp, H, D)

It needs the per-process head counts (after tp: ``H/tp`` and the kv
heads this rank holds) divisible by ``sp``; the ring has no such
constraint. The backward is autograd: each all-to-all's gradient is the
inverse all-to-all (``_AllToAll``), and the local attention carries its
own. On the card over a gloo group the exchanges stage through host
memory, as the ring's do (``SPGroup.all_to_all``).
"""

from __future__ import annotations

import torch

from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.parallel.ring_attention import SPGroup


def _seq_to_heads(x: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """(B, S/sp, h, D) → (B, S, h/sp, D): member j receives head group j
    of every member's sequence slice, in sequence order."""
    B, Sl, h, D = x.shape
    parts = x.reshape(B, Sl, sp.size, h // sp.size, D).permute(2, 0, 1, 3, 4)
    got = sp.all_to_all(parts)                 # (sp, B, Sl, h/sp, D)
    return got.permute(1, 0, 2, 3, 4).reshape(B, sp.size * Sl,
                                              h // sp.size, D)


def _heads_to_seq(x: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """(B, S, h/sp, D) → (B, S/sp, h, D), the inverse of
    ``_seq_to_heads``."""
    B, S, hl, D = x.shape
    parts = x.reshape(B, sp.size, S // sp.size, hl, D).permute(1, 0, 2, 3, 4)
    got = sp.all_to_all(parts)                 # (sp, B, S/sp, h/sp, D)
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // sp.size,
                                              sp.size * hl, D)


class _AllToAll(torch.autograd.Function):
    """One re-shard with the inverse re-shard as its gradient."""

    @staticmethod
    def forward(ctx, x, sp, to_heads: bool):
        ctx.sp, ctx.to_heads = sp, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, sp)

    @staticmethod
    def backward(ctx, g):
        back = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return back(g.contiguous(), ctx.sp), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sp: SPGroup | None = None, causal: bool = True,
                      block_q: int = 0, block_k: int = 0,
                      window: int = 0) -> torch.Tensor:
    """Sequence-parallel attention over this process's slices: q (B,
    S_local, H, D), k/v (B, S_local, Hkv, D), the global sequence being
    the members' slices in ``sp`` order. Output as q. The whole-sequence
    local attention is ``dot_product_attention`` (the flash kernels on
    the card); ``block_q``/``block_k`` are its tile overrides;
    ``window`` is global (the local attention sees the whole sequence).
    The per-shard head counts (after tp) must divide by sp: the one
    check of that, which the model reaches through this call."""
    sp = sp or SPGroup()
    if sp.size == 1:
        return dot_product_attention(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k,
                                     window=window)
    H, Hkv = q.shape[2], k.shape[2]
    if H % sp.size or Hkv % sp.size:
        raise ValueError(
            f"ulysses needs the per-shard head counts (q: {H}, "
            f"kv: {Hkv}) divisible by sp ({sp.size}); use ring attention "
            "otherwise")
    out = dot_product_attention(
        _AllToAll.apply(q, sp, True), _AllToAll.apply(k, sp, True),
        _AllToAll.apply(v, sp, True), causal=causal, block_q=block_q,
        block_k=block_k, window=window)
    return _AllToAll.apply(out, sp, False)

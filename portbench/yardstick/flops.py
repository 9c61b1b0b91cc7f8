"""The FLOP count that MFU is read against.

Every matmul of the forward and the backward counted once (2 FLOPs a
multiply-add, the backward twice the forward), the output head
included; embedding lookups, norms, elementwise work and recomputation
(remat) left out; causal attention at ``12·L·d·S/2`` a token for the
forward and the backward together (the scores and the weighted sum over
the half of the keys a causal query sees on average).
"""

from __future__ import annotations


def matmul_params(cfg: dict) -> int:
    """Weights that take part in a matmul for every token: the blocks'
    q, k, v, o and the MLP's two projections, and the output head."""
    d, L, f = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    hd = d // cfg["n_heads"]
    kv = cfg.get("n_kv_heads") or cfg["n_heads"]
    attn = d * d + 2 * d * kv * hd + d * d
    return L * (attn + 2 * d * f) + d * cfg["vocab_rows"]


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward FLOPs of one token of a row of ``seq_len``."""
    return (6.0 * matmul_params(cfg)
            + 12.0 * cfg["n_layers"] * cfg["d_model"] * seq_len / 2)


def train_flops_per_sample(cfg: dict, seq_len: int) -> float:
    return train_flops_per_token(cfg, seq_len) * seq_len


def forward_flops(cfg: dict, keys: int, head: bool) -> float:
    """Forward FLOPs of one token that attends ``keys`` cached keys
    (itself included); ``head``: whether its logits are computed."""
    d, L = cfg["d_model"], cfg["n_layers"]
    body = matmul_params(cfg) - d * cfg["vocab_rows"]
    return (2.0 * body + (2.0 * d * cfg["vocab_rows"] if head else 0.0)
            + 4.0 * L * d * keys)

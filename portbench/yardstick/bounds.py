"""The least time the card could take for one launch of a kernel: the
larger of its operations over the peak FLOP rate and its bytes over the
HBM bandwidth, for the inputs of that launch. Each input byte is counted
read once and each output byte written once; only the (query, key)
pairs the mask keeps are counted.
"""

from __future__ import annotations

from portbench.yardstick import peaks


def bound_s(flops: float, nbytes: float,
            peak_flops: float = peaks.BF16_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / peaks.HBM_BYTES_PER_S)


def causal_pairs(B: int, H: int, S: int) -> int:
    return B * H * S * (S + 1) // 2


def flash_fwd(B: int, H: int, S: int, D: int, elt: int = 2,
              Hkv: int | None = None) -> float:
    """B1: q, k, v in, out written, f32 log-sum-exp written; 4·D FLOPs a
    live pair."""
    Hkv = Hkv or H
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * elt + 4 * B * H * S
    return bound_s(4.0 * D * causal_pairs(B, H, S), nbytes)


def flash_bwd(B: int, H: int, S: int, D: int, elt: int = 2,
              Hkv: int | None = None, part: str = "fused") -> float:
    """B2 (``fused``: 10·D FLOPs a live pair), B3a (``dq``: 6·D) or B3b
    (``dkv``: 8·D): q, k, v, dout in, f32 lse and delta in, and the
    part's gradients written."""
    Hkv = Hkv or H
    per_pair = {"fused": 10, "dq": 6, "dkv": 8}[part]
    q_like, kv_like = B * H * S * D, B * Hkv * S * D
    in_bytes = (2 * q_like + 2 * kv_like) * elt + 2 * 4 * B * H * S
    out = {"fused": q_like + 2 * kv_like, "dq": q_like,
           "dkv": 2 * kv_like}[part]
    return bound_s(per_pair * D * causal_pairs(B, H, S),
                   in_bytes + out * elt)


def paged_decode(lengths, H: int, Hkv: int, hd: int, page_size: int,
                 elt: int = 2) -> float:
    """B4 over one launch: the live K/V rows, q and out of every row, the
    lengths and the live page-table entries; 4·hd FLOPs a live key and
    head."""
    toks = sum(int(n) for n in lengths)
    pages = sum(-(-int(n) // page_size) for n in lengths)
    nbytes = ((2 * toks * Hkv * hd + 2 * len(lengths) * H * hd) * elt
              + 4 * (len(lengths) + pages))
    return bound_s(4.0 * toks * H * hd, nbytes)

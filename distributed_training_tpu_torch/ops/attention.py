"""Attention implementations (port of ``distributed_training_tpu/ops/attention.py``).

- ``naive``: straightforward attention (einsum, softmax, einsum) — the
  numerics reference every kernel is tested against.
- ``flash``: the hand-written Hopper flash attention
  (ops/flash_attention.py: forward and backward kernels under one
  autograd Function; bf16 at head dim 64/128 on the tensor-core kernels
  csrc/flash_{fwd,bwd}_sm90.cu, the rest on csrc/flash_{fwd,bwd}.cu).

Both carry gradients: naive through autograd over its torch ops, flash
through the backward kernels.
- ``ring``/``ulysses``: sequence-parallel attention waits for the
  sharded slices (ROADMAP.md queue A).
"""

from __future__ import annotations

import torch


def _naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True,
                     segment_mask: torch.Tensor | None = None,
                     window: int = 0) -> torch.Tensor:
    """Reference attention. Shapes: q (B, Sq, H, D); k/v (B, Sk, Hkv, D).

    Supports grouped-query attention (Hkv divides H). Logits and softmax
    in f32 regardless of input dtype, output in q.dtype."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    group = H // Hkv
    qg = q.reshape(B, Sq, Hkv, group, D)
    scale = D ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * scale
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if causal:
        Sk = k.shape[1]
        # Offset alignment: query i attends keys <= i + (Sk - Sq).
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=q.device)[None, :]
        mask = cols <= rows
        if window:
            # Sliding window: keys in [i - window + 1, i] only.
            mask = mask & (cols >= rows - (window - 1))
        logits = logits.masked_fill(~mask, float("-inf"))
    if segment_mask is not None:
        logits = logits.masked_fill(~segment_mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          impl: str = "auto",
                          block_q: int | None = None,
                          block_k: int | None = None,
                          window: int = 0,
                          layout: str = "bshd") -> torch.Tensor:
    """Dispatching attention entry point. ``impl``:

    - "auto": the flash kernel when ``flash_attention.supported()``
      admits the shapes (CUDA tensors, tile-friendly lengths), else naive;
    - "naive" | "flash".

    ``block_q``/``block_k`` override the flash kernel's tiles (None →
    its defaults); ignored by the naive path. ``layout="bhsd"``: inputs
    and output are in the kernel's (B, H, S, D) layout."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl='{impl}' is sequence-parallel attention, "
            "which waits for ROADMAP.md queue A 'Sharded training'")
    if impl in ("auto", "flash"):
        from distributed_training_tpu_torch.ops import flash_attention as fa
        if fa.supported(q, k, v, block_q=block_q or 0,
                        block_k=block_k or 0,
                        layout=layout) or impl == "flash":
            return fa.flash_attention(q, k, v, causal=causal,
                                      block_q=block_q or 0,
                                      block_k=block_k or 0,
                                      window=window, layout=layout)
        impl = "naive"
    if impl == "naive":
        if layout == "bhsd":
            def t(x):
                return x.transpose(1, 2)
            return t(_naive_attention(t(q), t(k), t(v), causal,
                                      window=window))
        return _naive_attention(q, k, v, causal, window=window)
    raise ValueError(f"unknown attention impl '{impl}'")

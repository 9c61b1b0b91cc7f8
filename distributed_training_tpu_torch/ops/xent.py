"""Memory-efficient LM softmax cross-entropy (port of ``ops/xent.py``).

Per-token ``nll = logsumexp(x @ head) - (x @ head)[t]`` over sequence
chunks, as a ``torch.autograd.Function`` that recomputes each chunk's
logits in the backward instead of saving them:

- forward residuals: ``x``, ``head``, ``targets`` and the per-token
  ``lse`` (f32, B x S); no (B, S, V) buffer survives the forward;
- backward, per chunk: ``dlogits = (softmax - onehot) * dnll``, rounded
  to ``x.dtype``, feeds the two head products; ``dx`` is an f32 product
  cast to ``x.dtype``, and ``dhead`` accumulates in f32 across chunks and
  is cast to the head's dtype at the end;
- chunks cut the sequence axis and keep the batch axis whole (the JAX
  op's sharding contract);
- negative target ids are masked: zero nll and zero gradient.

The JAX package computes these products in XLA, outside any Pallas
kernel, so plain PyTorch products are their counterpart here. Every
product has f32 outputs, as the JAX op's ``preferred_element_type=f32``:
on the card a bf16 GEMM that writes its f32 accumulator
(``torch.mm(..., out_dtype=torch.float32)``); on the CPU, which has no
such overload, the bf16 operands are widened to f32 first, which gives
the same exact products summed in f32.
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK_ROWS = 2048


def _seq_chunk(batch: int, seq: int, chunk_rows: int) -> int:
    """Sequence positions per chunk so that ``B * sc`` is about the
    requested row budget (the only (rows, V) f32 buffer alive)."""
    return max(1, min(seq, chunk_rows // max(batch, 1)))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with an f32 output from f32 accumulators."""
    if a.dtype == b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(xb: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    B, sc, D = xb.shape
    return _mm_f32(xb.reshape(B * sc, D), head).view(B, sc, -1)  # f32


class _LMXent(torch.autograd.Function):
    """x (B, S_p, D), head (D, V), t (B, S_p) with S_p a multiple of
    ``sc`` → nll (B, S_p) f32."""

    @staticmethod
    def forward(ctx, x, head, t, sc):
        S = x.shape[1]
        nll = torch.empty(t.shape, dtype=torch.float32, device=x.device)
        lse = torch.empty(t.shape, dtype=torch.float32, device=x.device)
        for s0 in range(0, S, sc):
            logits = _chunk_logits(x[:, s0:s0 + sc], head)
            tb = t[:, s0:s0 + sc]
            lse_b = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1,
                               tb.clamp(min=0)[..., None])[..., 0]
            nll[:, s0:s0 + sc] = torch.where(tb >= 0, lse_b - tgt, 0.0)
            lse[:, s0:s0 + sc] = lse_b
        ctx.save_for_backward(x, head, t, lse)
        ctx.sc = sc
        return nll

    @staticmethod
    def backward(ctx, dnll):
        x, head, t, lse = ctx.saved_tensors
        sc = ctx.sc
        S = x.shape[1]
        dx = torch.empty_like(x)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        for s0 in range(0, S, sc):
            xb, tb = x[:, s0:s0 + sc], t[:, s0:s0 + sc]
            p = torch.exp(_chunk_logits(xb, head)
                          - lse[:, s0:s0 + sc, None])
            valid = tb >= 0
            p.scatter_add_(-1, tb.clamp(min=0)[..., None],
                           torch.full(p.shape[:-1] + (1,), -1.0,
                                      device=p.device))
            g = torch.where(valid, dnll[:, s0:s0 + sc], 0.0)
            dlogits = (p * g[..., None]).to(x.dtype).reshape(
                -1, p.shape[-1])
            dx[:, s0:s0 + sc] = _mm_f32(dlogits, head.T).view(
                xb.shape).to(x.dtype)
            dhead += _mm_f32(xb.reshape(-1, xb.shape[-1]).T, dlogits)
        return dx, dhead.to(head.dtype), None, None


def lm_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                     targets: torch.Tensor,
                     chunk_rows: int = DEFAULT_CHUNK_ROWS) -> torch.Tensor:
    """Per-token LM loss without an (N, V) residual.

    x: final hidden states (B, S, D); head: unembedding (D, V) in x's
    dtype; targets: int ids (B, S), negative ids masked (zero nll and
    zero gradient). ``chunk_rows``: rows per chunk, ``B * sc``. Returns
    the per-token nll (B, S) f32."""
    B, S, D = x.shape
    sc = _seq_chunk(B, S, chunk_rows)
    targets = targets.long()
    pad = (-S) % sc
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad, D))], dim=1)
        targets = torch.cat([targets, targets.new_full((B, pad), -1)],
                            dim=1)
    return _LMXent.apply(x, head, targets, sc)[:, :S]

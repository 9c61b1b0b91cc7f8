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

Vocab-parallel (``group``, tensor parallelism): ``head`` is this rank's
columns ``[v0, v0 + V/tp)`` of the unembedding. Per chunk, the local
row maxima are all-reduced with MAX over the group, then the local sums
of exponentials and the target logits (from the rank that owns the id,
0 elsewhere) together with SUM; ``lse = log(sum) + max`` on every rank.
The backward's ``dlogits`` are local, ``dhead`` stays local, and ``dx``
is this rank's part: the caller sums it over the group (``copy_to_tp``
on ``x``). Without a group the same code runs without the collectives;
over a group of one they change no bit. ``parallel/tensor.py``'s
``ALL_REDUCES["xent"]`` counts them, two per chunk.

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
import torch.distributed as dist

from distributed_training_tpu_torch.parallel.tensor import ALL_REDUCES

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


def _own_targets(t: torch.Tensor, v0: int, width: int) -> tuple:
    """The ids of ``t`` in this rank's columns ``[v0, v0 + width)``:
    (their local column, clamped into range; whether this rank owns
    them). Masked (negative) ids are owned by no rank."""
    local = t - v0
    own = (t >= 0) & (local >= 0) & (local < width)
    return local.clamp(0, width - 1), own


class _LMXent(torch.autograd.Function):
    """x (B, S_p, D), head (D, V_local), t (B, S_p) with S_p a multiple
    of ``sc``, this rank's first column ``v0`` and the vocab's ``group``
    (None: the head is the whole vocab) → nll (B, S_p) f32."""

    @staticmethod
    def forward(ctx, x, head, t, sc, v0, group):
        S = x.shape[1]
        nll = torch.empty(t.shape, dtype=torch.float32, device=x.device)
        lse = torch.empty(t.shape, dtype=torch.float32, device=x.device)
        for s0 in range(0, S, sc):
            logits = _chunk_logits(x[:, s0:s0 + sc], head)
            tb = t[:, s0:s0 + sc]
            m = logits.amax(dim=-1)
            if group is not None:
                ALL_REDUCES["xent"] += 1
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            col, own = _own_targets(tb, v0, logits.shape[-1])
            sums = torch.stack([
                torch.exp(logits - m[..., None]).sum(dim=-1),
                torch.where(own, torch.gather(logits, -1,
                                              col[..., None])[..., 0], 0.0)])
            if group is not None:
                ALL_REDUCES["xent"] += 1
                dist.all_reduce(sums, group=group)
            lse_b = torch.log(sums[0]) + m
            nll[:, s0:s0 + sc] = torch.where(tb >= 0, lse_b - sums[1], 0.0)
            lse[:, s0:s0 + sc] = lse_b
        ctx.save_for_backward(x, head, t, lse)
        ctx.sc, ctx.v0 = sc, v0
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
            col, own = _own_targets(tb, ctx.v0, p.shape[-1])
            p.scatter_add_(-1, col[..., None], -own[..., None].float())
            g = torch.where(tb >= 0, dnll[:, s0:s0 + sc], 0.0)
            dlogits = (p * g[..., None]).to(x.dtype).reshape(
                -1, p.shape[-1])
            dx[:, s0:s0 + sc] = _mm_f32(dlogits, head.T).view(
                xb.shape).to(x.dtype)
            dhead += _mm_f32(xb.reshape(-1, xb.shape[-1]).T, dlogits)
        return dx, dhead.to(head.dtype), None, None, None, None


def lm_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                     targets: torch.Tensor,
                     chunk_rows: int = DEFAULT_CHUNK_ROWS,
                     group=None, vocab_start: int = 0) -> torch.Tensor:
    """Per-token LM loss without an (N, V) residual.

    x: final hidden states (B, S, D); head: unembedding (D, V) in x's
    dtype; targets: int ids (B, S), negative ids masked (zero nll and
    zero gradient). ``chunk_rows``: rows per chunk, ``B * sc``. Returns
    the per-token nll (B, S) f32. Vocab-parallel: ``head`` is this
    rank's columns from ``vocab_start`` of the vocab split over
    ``group`` (module docstring); every rank returns the whole nll."""
    B, S, D = x.shape
    sc = _seq_chunk(B, S, chunk_rows)
    targets = targets.long()
    pad = (-S) % sc
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad, D))], dim=1)
        targets = torch.cat([targets, targets.new_full((B, pad), -1)],
                            dim=1)
    return _LMXent.apply(x, head, targets, sc, vocab_start, group)[:, :S]

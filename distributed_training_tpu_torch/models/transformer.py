"""Decoder-only transformer (port of ``models/transformer.py``).

Same configuration (``TransformerConfig``, ``PRESETS``) and the same
weight pytree as the JAX package: a nested dict of tensors with stacked
``(L, …)`` per-layer leaves under ``tok_embed``, ``pos_embed``,
``ln1``/``ln2``, ``attn.{wq,wk,wv,wo}``, ``mlp.{wi,bi,wo,bo}``,
``final_norm`` and ``lm_head`` (absent when embeddings are tied), so
``models/convert.py`` carries JAX weights across leaf for leaf. A Python
loop over layers replaces ``lax.scan``.

``apply`` is the inference forward (the serving engine's dense
reference; under a tp binding it gathers the vocab-split logits, so it
returns the whole vocab's f32 logits under any layout, as JAX's);
``prefill``/``generate`` decode over a dense KV cache
(``generate.py --decode fused``); ``loss`` is the training forward, differentiable by autograd
through the stacked leaves (the tied ``tok_embed`` takes both the
embedding-gather and the head gradient). Remat recomputes what the JAX
policies' allow-lists leave unsaved, and never attention: the flash
kernel's residuals (q, k, v, out, lse) stay saved by its autograd
Function, so its forward launches once per layer per step:

- ``mlp``: save the MLP's input; the backward recomputes the ``wi``
  product and the gelu (``_RematMLP``), never the ``wo`` product;
- ``mlp_pre``: also save the pre-gelu ``h @ wi + bi``; the backward
  recomputes the gelu alone;
- ``selective`` and ``full``: recompute everything in the block but
  attention (``torch.utils.checkpoint``; in the JAX package ``full``
  re-runs attention too).

Dropout (``cfg.dropout``, GPT-2's ``resid_pdrop``/``embd_pdrop``) is
JAX's inverted ``_dropout`` on both residual branches and on the
embedding, active when ``train`` and an ``rng`` seed are given (the
trainer's: ``train.seed``, the step, the microbatch and the data
shard). Each site draws its mask from a ``torch.Generator`` seeded with
``fold_seed(rng, ...)`` of the global layer id and the site, so masks
differ per site, layer, microbatch and step and repeat for the same
seed. torch cannot replay JAX's ``jax.random`` stream: the tests feed
both sides the same masks.

Under FSDP the trainer stores the weights sharded and binds a gather
(``bind_gather_for_compute``, ``parallel/fsdp.py``): the forward casts
each layer's shards to the compute dtype and all-gathers them one layer
at a time, so activations never pay collective traffic.
``logical_axes`` names each leaf's dims for the sharding rules.

Under tensor parallelism (``tp``/``tp_fsdp``) the trainer also binds the
tp group (``bind_tensor_parallel``, ``parallel/tensor.py``), and each
rank computes on its own block of every weight the strategy splits over
tp, Megatron-style: the embedding lookup over its vocab rows; q, k, v on
its H/tp heads (column-parallel, input through ``copy_to_tp``); the
attention kernels on those heads; the attention's ``wo`` and the MLP's
``wo`` row-parallel, each ending in ``reduce_from_tp``, the MLP's ``wi``
and ``bi`` column-parallel; the replicated ``bo`` added once, after the
reduce; the head over its vocab columns (``ops/xent.py``'s
vocab-parallel loss). When tp does not divide the kv heads (GQA), the
strategy keeps ``wk``/``wv`` whole and each rank slices out the kv heads
its query heads read before the product, so the flash kernels still run
(the JAX model falls back to naive attention there). No collective runs
inside a function that remat recomputes, and the tp ranks of a data
shard draw the same dropout masks.

Under sequence parallelism (``attention_impl`` "ring" or "ulysses" on a
mesh with ``sp``) the trainer binds the sp group
(``bind_sequence_parallel``): each process holds its slice of every
row's sequence, its positions (learned and RoPE) offset by its slice's
start, and attention crosses the slices over the group, as JAX's
``_attention`` dispatches (``parallel/ring_attention.py``,
``parallel/ulysses.py``); under tp each rank's heads ride the ring or
the all-to-all. A window is compared with the global length. The loss
sums the negative log-likelihood and the count of live targets over the
group (a sum whose gradient is the identity), so every member's loss is
its data shard's mean over real tokens, and each member's gradients are
its part of that loss's, which the trainer sums over ``sp``. Dropout
masks are drawn over the global sequence and sliced, so they equal the
masks of a run at sp 1.

Under pipeline parallelism (a mesh with ``pp``) the trainer binds the
pp group (``bind_pipeline``) and takes each step's gradients from
``pipeline_grads``: stage 0 embeds the whole batch (positions and the
embedding's dropout as at pp 1) and splits it into ``M`` strided
microbatches (``parallel/pipeline.py::num_microbatches``, the JAX rule
over the global batch); every stage runs its chunks of blocks
(``_run_layers``, given their global layer ids, no remat: the pipeline
keeps each chunk's input and recomputes it) under the ``pp_schedule``;
the last stage applies the final norm, the head and the loss to the
whole batch, so the loss is the batch's mean over its real tokens, and
broadcasts it over ``pp``. A layer's dropout seed folds the pipeline
microbatch when ``M > 1``, so with one microbatch pp N draws exactly
the pp 1 masks. Inside a stage, tp and sp run as above (each stage's tp
ranks compute their heads; JAX's stage params are whole over tp).

MoE (``moe_num_experts > 0``, JAX's helpers of the same names): every
MLP becomes ``E`` experts (``mlp.{router,wi,wo}``, no biases) that a
router reaches top-k. ``moe_impl="routed"`` routes each row's sequence
in groups of ``moe_group_size`` into per-expert capacity buffers (a
slot-major cumsum gives each (token, slot) its place; what overflows is
dropped), gathers each buffer's tokens by index where JAX multiplies by
one-hot matrices (the same values), runs the experts as batched
products over the buffers and combines by index; ``"dense"`` runs every
expert on every token. The load-balancing aux, ``E · Σ frac · mean_prob``
before capacity, is summed over the layers and divided by ``n_layers``
(under pp also by ``M``) and enters the loss at ``moe_aux_weight``. Its
statistics are the global batch's: under a bound data group
(``bind_data_group``, ``parallel/expert.py``) they are summed over the
data shards and the sequence slices, and each process backpropagates
its share. Under sp a rank's capacity places follow the group's
earlier slices (``expert.slot_counts``). Under tp the routing is
replicated, the experts split their hidden width (``wi`` by column,
``wo`` by row), the tokens enter the experts through ``copy_to_tp`` and
the experts' outputs are summed over tp before the combine, so the
router's gradient is whole on every rank. Under ``fsdp`` the experts'
``expert`` dim is stored split (expert parallelism) and gathered per
layer. Remat ``mlp`` and ``mlp_pre`` recompute the experts' hiddens and
gelu (``_RematExperts``); ``full`` and ``selective`` checkpoint the
experts alone, so no collective of the routing is run twice.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.ops.xent import lm_cross_entropy
from distributed_training_tpu_torch.parallel import expert, pipeline
from distributed_training_tpu_torch.parallel.ring_attention import (
    SPGroup,
    ring_attention,
    sum_over_sp,
)
from distributed_training_tpu_torch.parallel.ulysses import ulysses_attention
from distributed_training_tpu_torch.runtime import make_generator, resolve_device


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclass
class TransformerConfig:
    vocab_size: int = 50257
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 0          # 0 → = n_heads (MHA); < n_heads → GQA
    d_ff: int = 0                # 0 → 4 * d_model
    max_seq_len: int = 1024
    pos_encoding: str = "learned"  # "learned" (GPT-2) | "rope"
    dropout: float = 0.0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"      # compute dtype
    param_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "selective"  # "full"|"selective"|"mlp"|"mlp_pre"
    attention_impl: str = "auto"
    # Sliding-window attention: query i attends keys in
    # [i - window + 1, i]. 0 = full causal.
    attention_window: int = 0
    # Flash-kernel tile overrides (0 → ops/flash_attention defaults).
    flash_block_q: int = 0
    flash_block_k: int = 0
    scan_unroll: int = 1
    pp_microbatches: int = 4
    pp_schedule: str = "gpipe"    # "gpipe" | "interleaved"
    pp_virtual_stages: int = 2
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01
    moe_impl: str = "routed"
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024
    loss_name: str = "xent"
    loss_impl: str = "fused"
    xent_chunk_rows: int = 2048

    def __post_init__(self):
        if self.n_kv_heads == 0:
            self.n_kv_heads = self.n_heads
        if self.d_ff == 0:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide into n_kv_heads")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(
                f"dropout must be in [0, 1), got {self.dropout}")
        if self.moe_num_experts > 0 and self.moe_capacity_factor <= 0:
            raise ValueError(
                f"moe_capacity_factor must be > 0, got "
                f"{self.moe_capacity_factor}")
        if self.pp_schedule not in ("gpipe", "interleaved"):
            raise ValueError(
                f"unknown pp_schedule '{self.pp_schedule}' "
                "(expected 'gpipe' or 'interleaved')")
        if self.moe_impl not in ("routed", "dense"):
            raise ValueError(
                f"unknown moe_impl '{self.moe_impl}' "
                "(expected 'routed' or 'dense')")
        if self.loss_impl not in ("fused", "dense"):
            raise ValueError(
                f"unknown loss_impl '{self.loss_impl}' "
                "(expected 'fused' or 'dense')")
        if self.attention_window < 0:
            raise ValueError(
                f"attention_window must be >= 0, got "
                f"{self.attention_window}")
        if self.scan_unroll < 1 or self.n_layers % self.scan_unroll:
            raise ValueError(
                f"scan_unroll ({self.scan_unroll}) must be >= 1 and "
                f"divide n_layers ({self.n_layers})")
        if self.remat_policy not in ("full", "selective", "mlp",
                                     "mlp_pre"):
            raise ValueError(
                f"unknown remat_policy '{self.remat_policy}' "
                "(expected 'full', 'selective', 'mlp' or 'mlp_pre')")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# The JAX package's presets. Vocab is GPT-2's 50257 padded to 50304.
PRESETS: dict[str, dict] = {
    "gpt2_125m": dict(vocab_size=50304, d_model=768, n_layers=12,
                      n_heads=12, max_seq_len=1024),
    "gpt2_350m": dict(vocab_size=50304, d_model=1024, n_layers=24,
                      n_heads=16, max_seq_len=1024),
    "transformer_1b": dict(vocab_size=50304, d_model=2048, n_layers=24,
                           n_heads=16, max_seq_len=2048,
                           pos_encoding="rope", tie_embeddings=False),
    "transformer_7b": dict(vocab_size=50304, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, max_seq_len=2048,
                           pos_encoding="rope", tie_embeddings=False,
                           remat=True),
}

_STACKED = ("ln1", "ln2", "attn", "mlp")


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype name ("float32", "bfloat16") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype '{name}'")
    return dt


def param_shapes(cfg: TransformerConfig) -> dict:
    """The weight pytree's leaf shapes (the JAX ``Transformer.init``
    layout)."""
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "tok_embed": (cfg.vocab_size, D),
        "ln1": {"scale": (L, D), "bias": (L, D)},
        "ln2": {"scale": (L, D), "bias": (L, D)},
        "attn": {"wq": (L, D, H, hd), "wk": (L, D, Hkv, hd),
                 "wv": (L, D, Hkv, hd), "wo": (L, H, hd, D)},
        "mlp": {"wi": (L, D, F_), "bi": (L, F_), "wo": (L, F_, D),
                "bo": (L, D)},
        "final_norm": {"scale": (D,), "bias": (D,)},
    }
    if cfg.moe_num_experts > 0:
        E = cfg.moe_num_experts
        shapes["mlp"] = {"router": (L, D, E), "wi": (L, E, D, F_),
                         "wo": (L, E, F_, D)}
    if cfg.pos_encoding == "learned":
        shapes["pos_embed"] = (cfg.max_seq_len, D)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


# The int8 weight-only sites (the serving transformer's matmul operands)
# and the dims their per-output-channel scale reduces over; dim 0 is the
# stacked layer axis, always kept. Embeddings, the head, norms and
# biases stay as they are (``serving/disagg.py`` quantizes).
_QUANT_AXES: dict[tuple[str, str], tuple[int, ...]] = {
    ("attn", "wq"): (1,),        # (L, D, H, hd)  — reduce D
    ("attn", "wk"): (1,),        # (L, D, Hkv, hd)
    ("attn", "wv"): (1,),        # (L, D, Hkv, hd)
    ("attn", "wo"): (1, 2),      # (L, H, hd, D)  — reduce H, hd
    ("mlp", "wi"): (1,),         # (L, D, F)      — reduce D
    ("mlp", "wo"): (1,),         # (L, F, D)      — reduce F
}


def _is_quant_leaf(x) -> bool:
    """An int8 weight-only leaf: ``{"qw": int8, "scale": f32}``."""
    return isinstance(x, dict) and "qw" in x and "scale" in x


def cast_for_compute(params: dict, cfg: TransformerConfig) -> dict:
    """Every leaf the forward casts to the compute dtype, cast once.

    The JAX programs cast each weight at its use (``_w``); casting ahead
    gives the same values without a per-step cast. Layer-norm scales and
    biases stay in the parameter dtype: the norm applies them in f32. An
    int8 weight-only leaf (``{"qw", "scale"}``) passes through whole: the
    serving programs dequantize it one layer at a time."""
    dt = torch_dtype(cfg.dtype)
    out = {k: v for k, v in params.items()}
    for key in ("tok_embed", "pos_embed", "lm_head"):
        if key in params:
            out[key] = params[key].to(dt)
    for grp in ("attn", "mlp"):
        out[grp] = {k: w if _is_quant_leaf(w) else w.to(dt)
                    for k, w in params[grp].items()}
    return out


def layer_slice(params: dict, i: int) -> dict:
    """Layer ``i``'s weights from the stacked ``(L, …)`` leaves; an int8
    leaf gives layer ``i``'s ``qw`` and ``scale``."""
    return {k: {n: ({m: t[i] for m, t in w.items()} if _is_quant_leaf(w)
                    else w[i])
                for n, w in params[k].items()}
            for k in _STACKED}


def _cast_layer(layer: dict, dt: torch.dtype) -> dict:
    """A layer's matmul weights and biases in the compute dtype (the
    norms stay in the param dtype)."""
    return {k: ({n: w.to(dt) for n, w in ws.items()}
                if k in ("attn", "mlp") else ws)
            for k, ws in layer.items()}


def _layers(params: dict, n_layers: int) -> list[dict]:
    """Every layer's weights, each stacked leaf unbound once (one
    backward ``stack`` per leaf instead of a full-size scatter per
    layer)."""
    parts = {k: {n: w.unbind(0) for n, w in params[k].items()}
             for k in _STACKED}
    return [{k: {n: ws[i] for n, ws in parts[k].items()} for k in _STACKED}
            for i in range(n_layers)]


def _checkpoint(fn, *args):
    """Recompute ``fn`` in the backward instead of saving what it
    computes (non-reentrant; no RNG inside, so no RNG state kept)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _mlp_pre(h, wi, bi):
    """The MLP's pre-gelu ``h @ wi + bi``."""
    return torch.einsum("bsd,df->bsf", h, wi) + bi


def _mlp_post(pre, wo):
    """``gelu(pre) @ wo``: the MLP's output before ``bo``."""
    return torch.einsum("bsf,fd->bsd", F.gelu(pre, approximate="tanh"), wo)


class _RematMLP(torch.autograd.Function):
    """``_mlp_post(_mlp_pre(h, wi, bi), wo)`` that saves its input ``h``
    (and, with ``keep_pre``, the pre-gelu tensor) and nothing F-wide
    after the gelu: the backward recomputes the ``wi`` product (unless
    kept) and the gelu, never the ``wo`` product. The recompute set of
    JAX's ``mlp`` and ``mlp_pre`` allow-lists."""

    @staticmethod
    def forward(ctx, h, wi, bi, wo, keep_pre: bool):
        pre = _mlp_pre(h, wi, bi)
        ctx.save_for_backward(h, wi, bi, wo, pre if keep_pre else None)
        return _mlp_post(pre, wo)

    @staticmethod
    def backward(ctx, g):
        h, wi, bi, wo, pre = ctx.saved_tensors
        if pre is None:
            pre = _mlp_pre(h, wi, bi)
        u = F.gelu(pre, approximate="tanh")
        g_wo = torch.einsum("bsf,bsd->fd", u, g)
        g_pre = torch.ops.aten.gelu_backward(
            torch.einsum("bsd,fd->bsf", g, wo), pre, approximate="tanh")
        g_h = torch.einsum("bsf,df->bsd", g_pre, wi)
        g_wi = torch.einsum("bsd,bsf->df", h, g_pre)
        return g_h, g_wi, g_pre.sum((0, 1)), g_wo, None


# -- MoE ---------------------------------------------------------------------


def _expert_ffn(x: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """Every expert's ``gelu(x @ wi) @ wo``: x (E, N, D), wi (E, D, F),
    wo (E, F, D) → (E, N, D)."""
    return torch.bmm(F.gelu(torch.bmm(x, wi), approximate="tanh"), wo)


class _RematExperts(torch.autograd.Function):
    """``_expert_ffn`` that saves its inputs and nothing F-wide: the
    backward recomputes the ``wi`` products and the gelu, never the
    ``wo`` products (the recompute set of JAX's ``mlp`` allow-list, to
    which ``mlp_pre`` degrades under MoE)."""

    @staticmethod
    def forward(ctx, x, wi, wo):
        ctx.save_for_backward(x, wi, wo)
        return _expert_ffn(x, wi, wo)

    @staticmethod
    def backward(ctx, g):
        x, wi, wo = ctx.saved_tensors
        pre = torch.bmm(x, wi)
        g_wo = torch.bmm(F.gelu(pre, approximate="tanh").transpose(1, 2), g)
        g_pre = torch.ops.aten.gelu_backward(
            torch.bmm(g, wo.transpose(1, 2)), pre, approximate="tanh")
        return (torch.bmm(g_pre, wi.transpose(1, 2)),
                torch.bmm(x.transpose(1, 2), g_pre), g_wo)


def _experts(remat: str | None):
    """The expert FFN under the remat policy ``remat``."""
    if remat in ("mlp", "mlp_pre"):
        return _RematExperts.apply
    if remat in ("full", "selective"):
        return lambda *a: _checkpoint(_expert_ffn, *a)
    return _expert_ffn


def _topk_by_argmax(p: torch.Tensor, k: int) -> tuple:
    """Top-k along the last dim by k rounds of argmax and mask: values
    descending, the first index on ties (``torch.argmax`` returns the
    first maximum; ``torch.topk`` does not promise it), and the values
    gathered from the original ``p``, so the gradient reaches only the
    selected entries."""
    orig = p
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        vals.append(torch.gather(orig, -1, i[..., None])[..., 0])
        idxs.append(i)
        p = p.masked_fill(F.one_hot(i, p.shape[-1]).bool(), -torch.inf)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _moe_router(h: torch.Tensor, mlp: dict, c: TransformerConfig,
                aux_fn=None) -> tuple:
    """The routing head over h (…, D): the router product in h's dtype,
    the softmax in f32, the top-k renormalised. Returns (weights (…, k),
    experts (…, k), one-hots (…, k, E), aux). The aux is the Switch/GShard
    load-balancing loss ``E · Σ_e frac_e · mean_prob_e`` over h's tokens,
    before capacity; ``aux_fn(counts, probsum, n)`` forms it from the
    per-expert assignment counts and probability sums over ``n`` tokens
    (default ``expert.local_aux``; the model's sums them over its data
    group)."""
    E, k = c.moe_num_experts, c.moe_top_k
    gates = torch.einsum("...d,de->...e", h, mlp["router"].to(h.dtype))
    probs = torch.softmax(gates.float(), dim=-1)
    topv, topi = _topk_by_argmax(probs, k)
    topv = topv / topv.sum(-1, keepdim=True)
    onehot = F.one_hot(topi, E).float()
    red = tuple(range(probs.ndim - 1))
    counts = onehot.sum(red + (onehot.ndim - 2,))
    probsum = probs.sum(red)
    n = probs[..., 0].numel()
    aux = (aux_fn(counts, probsum, n) if aux_fn is not None
           else expert.local_aux(counts, probsum, n, E))
    return topv, topi, onehot, aux


def _moe_mlp_dense(h: torch.Tensor, mlp: dict, c: TransformerConfig,
                   aux_fn=None, copy=_same, reduce=_same,
                   ffn=_expert_ffn) -> tuple:
    """Every expert on every token, the outputs combined by the top-k
    weights (exact, O(E) FLOPs: the routed path's reference). ``copy``
    and ``reduce``: the tp seams around the experts."""
    dt = h.dtype
    B, S, D = h.shape
    E = c.moe_num_experts
    topv, _, onehot, aux = _moe_router(h, mlp, c, aux_fn)
    combine = torch.einsum("bsk,bske->bse", topv, onehot)
    x = copy(h).reshape(1, B * S, D).expand(E, B * S, D)
    down = reduce(ffn(x, mlp["wi"].to(dt), mlp["wo"].to(dt)))
    out = torch.einsum("ebsd,bse->bsd", down.view(E, B, S, D),
                       combine.to(dt))
    return out, aux


def _moe_group_size(S: int, cap: int) -> tuple[int, int]:
    """The routing group's length along the sequence and the padded
    sequence length: S pads up to a multiple of ``min(S, cap)`` (a
    divisor search would collapse poorly composite lengths to tiny
    groups); pad positions route nowhere."""
    g = min(S, max(1, cap))
    return g, -(-S // g) * g


def _moe_positions(topi: torch.Tensor, E: int, gs: int, G: int,
                   start: int, sp=None) -> torch.Tensor:
    """Each (token, slot)'s place in its expert's buffer: topi (B, S, k)
    holds the experts of the tokens at global positions ``start`` … of a
    sequence routed in G groups of ``gs``. Slot-major within a group:
    slot 0's assignments take places before slot 1's, each slot's in
    sequence order. ``sp``: (group, rank) of the sequence slices, whose
    counts come first (``expert.slot_counts``)."""
    B, S, k = topi.shape
    frame = topi.new_zeros((B, G * gs, k, E))
    frame[:, start:start + S] = F.one_hot(topi, E)
    frame = frame.view(B, G, gs, k, E)
    counts = frame.sum(2)                                   # (B, G, k, E)
    before = 0
    if sp is not None:
        counts, before = expert.slot_counts(counts, *sp)
    base = counts.cumsum(2) - counts + before
    pos = ((frame.cumsum(2) + base[:, :, None] - 1) * frame).sum(-1)
    return pos.view(B, G * gs, k)[:, start:start + S]


def _moe_mlp_routed(h: torch.Tensor, mlp: dict, c: TransformerConfig,
                    seq: tuple | None = None, sp=None, aux_fn=None,
                    copy=_same, reduce=_same, ffn=_expert_ffn) -> tuple:
    """Capacity-bounded top-k dispatch (GShard). Each row's sequence is
    routed in groups of ``gs`` tokens into per-expert buffers of
    ``C = ceil(cf · k · gs / E)`` places (``_moe_positions``); what
    overflows is dropped (its combine weight lands nowhere). The buffers
    are gathered by index and the experts run as E batched products of
    (B · G · C) rows, so their FLOPs do not grow with E. ``seq``:
    (start, global length) of h's slice of the sequence under sp, with
    ``sp`` the (group, rank) the slot counts are exchanged over."""
    dt = h.dtype
    E, k = c.moe_num_experts, c.moe_top_k
    B, S, D = h.shape
    start, total = seq or (0, S)
    gs, S_pad = _moe_group_size(total, c.moe_group_size)
    G = S_pad // gs
    C = int(-(-c.moe_capacity_factor * k * gs // E))  # ceil
    C = min(C, gs * k)  # can't hold more than every (token, slot)
    topv, topi, _, aux = _moe_router(h, mlp, c, aux_fn)
    pos = _moe_positions(topi, E, gs, G, start, sp)
    keep = pos < C
    expert.count_routing(B * S * k, (~keep).sum())
    dev = h.device
    b = torch.arange(B, device=dev)[:, None, None]
    g = (torch.arange(start, start + S, device=dev) // gs)[None, :, None]
    N = E * B * G * C
    place = torch.where(keep, ((topi * B + b) * G + g) * C + pos, N)
    tok = (b * S + torch.arange(S, device=dev)[None, :, None]).expand(B, S, k)
    src = torch.full((N + 1,), B * S, dtype=torch.long, device=dev)
    src.scatter_(0, place.reshape(-1), tok.reshape(-1))
    x = torch.cat([copy(h).reshape(B * S, D), h.new_zeros(1, D)])
    down = reduce(ffn(x[src[:N]].view(E, B * G * C, D), mlp["wi"].to(dt),
                      mlp["wo"].to(dt)))
    down = torch.cat([down.reshape(N, D), down.new_zeros(1, D)])
    w = torch.where(keep, topv, 0.0).to(dt)
    out = torch.einsum("bskd,bsk->bsd", down[place].float(), w.float())
    return out.to(dt), aux


def _moe_mlp(h: torch.Tensor, mlp: dict, c: TransformerConfig,
             seq: tuple | None = None, sp=None, aux_fn=None, copy=_same,
             reduce=_same, ffn=_expert_ffn) -> tuple:
    """Top-k routed expert MLP: (out, aux), the dispatch per
    ``cfg.moe_impl``."""
    if c.moe_impl == "routed":
        return _moe_mlp_routed(h, mlp, c, seq, sp, aux_fn, copy, reduce, ffn)
    return _moe_mlp_dense(h, mlp, c, aux_fn, copy, reduce, ffn)


# The embedding's dropout key (JAX folds 1_000_003 into the step's rng
# for ``embd_pdrop``), the layers' (JAX's ``fold_in(rng, 7)``) and the
# pipeline microbatch's.
_EMBED_KEY = 1_000_003
_LAYER_KEY = 7
_PP_MICROBATCH_KEY = 11


def fold_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed mixed from ``seed`` and the non-negative ``keys``
    (the port's ``jax.random.fold_in``): equal inputs give the same
    seed, a change in any of them an unrelated one."""
    state = np.random.SeedSequence([seed, *keys]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def dropout_seed(rng: int, layer: int | None, site: int = 0) -> int:
    """The seed of one dropout mask of the step seed ``rng``: the
    embedding's (``layer=None``), or global layer ``layer``'s residual
    branch ``site`` (0 attention, 1 MLP)."""
    if layer is None:
        return fold_seed(rng, _EMBED_KEY)
    return fold_seed(rng, _LAYER_KEY, layer, site)


def _dropout(x: torch.Tensor, rate: float, seed: int,
             seq: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout (JAX ``_dropout``): zero with probability
    ``rate`` and scale what is kept by ``1 / (1 - rate)``, so the
    expectation is unchanged; the mask comes from a ``torch.Generator``
    on x's device seeded with ``seed``. ``seq=(start, total)``: x (B, S,
    …) is the slice at ``start`` of a sequence of ``total`` positions;
    the mask is drawn over the whole sequence and sliced."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    shape = x.shape if seq is None else (x.shape[0], seq[1], *x.shape[2:])
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - rate
    if seq is not None:
        keep = keep[:, seq[0]:seq[0] + x.shape[1]]
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _rope(q: torch.Tensor, k: torch.Tensor,
          positions: torch.Tensor) -> tuple:
    """Rotary position embedding (half-split rotation, base 10000) on
    (B, S, H, D) q/k."""
    D = q.shape[-1]
    half = D // 2
    freqs = 1.0 / (10000 ** (torch.arange(half, dtype=torch.float32,
                                          device=q.device) / half))
    angles = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin,
                          x1 * sin + x2 * cos], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def kv_heads_of_rank(n_heads: int, n_kv_heads: int, tp: int,
                     rank: int) -> list:
    """The kv heads that tp rank ``rank``'s query heads read, when tp
    does not divide the kv heads: one per kv head when the rank's query
    heads read each of them alike (whole GQA groups, or a part of one),
    else one per query head (plain multi-head over repeated kv)."""
    per, group = n_heads // tp, n_heads // n_kv_heads
    idx = [h // group for h in range(rank * per, (rank + 1) * per)]
    uniq = sorted(set(idx))
    if per % len(uniq) == 0 and all(
            idx.count(u) == per // len(uniq) for u in uniq):
        return uniq
    return idx


def check_tp_split(cfg: TransformerConfig, tp: int) -> None:
    """Raise when tp does not divide the query heads, the MLP width or
    the vocab (the dims tensor parallelism splits)."""
    for what, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(
                f"tensor parallelism: {what}={n} does not split over "
                f"tp={tp}")


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Layer norm in f32 with eps 1e-5, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-5)
    return (y * scale + bias).to(x.dtype)


class Transformer:
    """Functional decoder-only transformer: ``init`` makes the weight
    pytree, ``apply`` runs the dense inference forward over it and
    ``loss`` the training forward.

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU."""

    batch_keys: tuple[str, ...] = ("tokens",)
    # Top-level keys of the stacked (L, …) per-layer leaves.
    stacked_keys: tuple[str, ...] = _STACKED

    def __init__(self, cfg: TransformerConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._gather = None
        self._tp = None
        self._kv_index = None
        self._sp = None
        self._pp = None
        self._pp_shards = 1
        self._data = None
        self._aux_scale = 1.0

    def param_shapes(self) -> dict:
        return param_shapes(self.cfg)

    def logical_axes(self) -> dict:
        """Per-leaf logical axis names, the JAX ``logical_axes`` leaf for
        leaf: the stacked ``(L, …)`` leaves carry ``None`` on the layer
        axis."""
        c = self.cfg
        axes = {
            "tok_embed": ("vocab", "embed"),
            "ln1": {"scale": (None, "embed"), "bias": (None, "embed")},
            "ln2": {"scale": (None, "embed"), "bias": (None, "embed")},
            "attn": {
                "wq": (None, "embed", "heads", None),
                "wk": (None, "embed", "kv", None),
                "wv": (None, "embed", "kv", None),
                "wo": (None, "heads", None, "embed"),
            },
            "final_norm": {"scale": ("embed",), "bias": ("embed",)},
            "mlp": {
                "wi": (None, "embed", "mlp"),
                "bi": (None, "mlp"),
                "wo": (None, "mlp", "embed"),
                "bo": (None, "embed"),
            },
        }
        if c.moe_num_experts > 0:
            axes["mlp"] = {
                "router": (None, "embed", None),
                "wi": (None, "expert", "embed", "mlp"),
                "wo": (None, "expert", "mlp", "embed"),
            }
        if c.pos_encoding == "learned":
            axes["pos_embed"] = (None, "embed")
        if not c.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        return axes

    def bind_gather_for_compute(self, gather) -> None:
        """Train on sharded weights: ``gather.layer(layer)`` returns a
        layer's weights (matmul weights already in the compute dtype)
        whole, and ``gather.leaf(name, w)`` a top-level leaf. ``None``
        unbinds."""
        self._gather = gather

    def bind_tensor_parallel(self, tp) -> None:
        """Train with the weights split over a tp group (``tp``: a
        ``parallel.tensor.TPGroup``; the strategy's ``tp`` layout): each
        rank computes on its own block of every tp-split weight and sums
        the partial results over the group. ``None`` unbinds. Raises
        when tp does not divide the heads, the MLP width or the vocab."""
        self._tp, self._kv_index = tp, None
        if tp is None:
            return
        c = self.cfg
        check_tp_split(c, tp.size)
        if c.n_kv_heads % tp.size:
            self._kv_index = torch.tensor(
                kv_heads_of_rank(c.n_heads, c.n_kv_heads, tp.size, tp.rank),
                device=self.device)

    def bind_sequence_parallel(self, sp: SPGroup | None) -> None:
        """Train with each row's sequence split over the sp group
        (``sp``: a ``parallel.ring_attention.SPGroup``): this process
        holds slice ``sp.rank`` of ``sp.size``, attention crosses the
        slices (``attention_impl`` "ring" or "ulysses"), and the loss is
        summed over the group. ``None`` unbinds (a group of one). Raises
        for a group larger than 1 under another attention."""
        if (sp is not None and sp.size > 1
                and self.cfg.attention_impl not in ("ring", "ulysses")):
            raise ValueError(
                f"sequence parallelism (sp={sp.size}) needs "
                "attention_impl 'ring' or 'ulysses', not "
                f"'{self.cfg.attention_impl}'")
        self._sp = sp

    def bind_pipeline(self, pp: pipeline.PPGroup | None,
                      data_shards: int = 1) -> None:
        """Train with the layers' work split over a pp group (``pp``: a
        ``parallel.pipeline.PPGroup``): this process runs its stage's
        chunks of every microbatch under ``pp_schedule``; gradients come
        from ``pipeline_grads``. ``data_shards``: the global batch's
        data shards (the microbatch count's rule). ``None`` (or a group
        of one) unbinds. Raises when pp does not divide the layers
        (interleaved: ``pp_virtual_stages * pp``)."""
        if pp is not None and pp.size > 1:
            c = self.cfg
            pipeline.check_pipeline(c.pp_schedule, 1, 1, c.n_layers,
                                    pp.size, c.pp_virtual_stages)
            if (c.attention_impl == "ulysses" and self._sp is not None
                    and (c.n_kv_heads % self._sp.size
                         or c.n_heads % self._sp.size)):
                raise ValueError(
                    f"attention_impl='ulysses' under pp with "
                    f"sp={self._sp.size} needs n_heads ({c.n_heads}) and "
                    f"n_kv_heads ({c.n_kv_heads}) divisible by sp")
        self._pp = pp if pp is not None and pp.size > 1 else None
        self._pp_shards = data_shards

    def bind_data_group(self, data: expert.DataGroup | None) -> None:
        """Train with the global batch split over a data group (``data``:
        a ``parallel.expert.DataGroup`` over the dp, fsdp and sp axes):
        the MoE aux's statistics are summed over it. ``None`` unbinds."""
        self._data = data

    def _moe_aux(self, counts: torch.Tensor, probsum: torch.Tensor,
                 n) -> torch.Tensor:
        """A layer's MoE aux over the bound data group (module
        docstring), its gradient scaled by ``_aux_scale``."""
        E = self.cfg.moe_num_experts
        if self._data is None:
            return expert.local_aux(counts, probsum, n, E)
        return self._data.aux(counts, probsum, n, E, self._aux_scale)

    def _seq_slice(self, s_local: int) -> tuple[int, int] | None:
        """(start, global length) of this process's sequence slice, or
        None without a bound sp group larger than 1."""
        sp = self._sp
        if sp is None or sp.size == 1:
            return None
        return sp.rank * s_local, sp.size * s_local

    def _leaf(self, params: dict, name: str, dt=None) -> torch.Tensor:
        """A top-level leaf, cast to ``dt`` and gathered when bound."""
        w = params[name] if dt is None else params[name].to(dt)
        return w if self._gather is None else self._gather.leaf(name, w)

    def init(self, rng) -> dict:
        """Random weights from a seed (int) or a ``torch.Generator`` on
        this model's device: the JAX init's structure, shapes and
        scales (normal std 0.02, depth-scaled residual-out weights,
        unit norms, zero biases)."""
        c = self.cfg
        gen = rng if isinstance(rng, torch.Generator) else \
            make_generator(rng, self.device)
        pdt = torch_dtype(c.param_dtype)
        shapes = param_shapes(c)
        std = 0.02
        out_std = std / (2 * c.n_layers) ** 0.5

        def normal(shape, s):
            return (torch.randn(shape, generator=gen, device=self.device)
                    * s).to(pdt)

        def norm_pair(shape):
            return {"scale": torch.ones(shape, dtype=pdt,
                                        device=self.device),
                    "bias": torch.zeros(shape, dtype=pdt,
                                        device=self.device)}

        a, m = shapes["attn"], shapes["mlp"]

        def mlp():
            if c.moe_num_experts > 0:
                return {"router": normal(m["router"], std),
                        "wi": normal(m["wi"], std),
                        "wo": normal(m["wo"], out_std)}
            return {"wi": normal(m["wi"], std),
                    "bi": torch.zeros(m["bi"], dtype=pdt, device=self.device),
                    "wo": normal(m["wo"], out_std),
                    "bo": torch.zeros(m["bo"], dtype=pdt, device=self.device)}

        params = {
            "tok_embed": normal(shapes["tok_embed"], std),
            "ln1": norm_pair(shapes["ln1"]["scale"]),
            "ln2": norm_pair(shapes["ln2"]["scale"]),
            "attn": {"wq": normal(a["wq"], std),
                     "wk": normal(a["wk"], std),
                     "wv": normal(a["wv"], std),
                     "wo": normal(a["wo"], out_std)},
            "final_norm": norm_pair(shapes["final_norm"]["scale"]),
            "mlp": mlp(),
        }
        if "pos_embed" in shapes:
            params["pos_embed"] = normal(shapes["pos_embed"], std)
        if "lm_head" in shapes:
            params["lm_head"] = normal(shapes["lm_head"], std)
        return params

    def _attention(self, q, k, v):
        c = self.cfg
        sp = self._sp or SPGroup()
        # A window covering the whole sequence is plain causal. The
        # comparison is with the GLOBAL length: under sp, q holds the
        # local slice.
        S = q.shape[1]
        if c.attention_impl in ("ring", "ulysses"):
            S *= sp.size
        window = c.attention_window if 0 < c.attention_window < S else 0
        if c.attention_impl == "ulysses":
            # Under tp, q/k/v hold this rank's heads: ulysses_attention
            # refuses counts that do not divide by sp.
            return ulysses_attention(q, k, v, sp, causal=True,
                                     block_q=c.flash_block_q,
                                     block_k=c.flash_block_k, window=window)
        if c.attention_impl == "ring":
            return ring_attention(q, k, v, sp, causal=True,
                                  block_q=c.flash_block_q,
                                  block_k=c.flash_block_k, window=window)
        return dot_product_attention(q, k, v, causal=True,
                                     impl=c.attention_impl,
                                     block_q=c.flash_block_q,
                                     block_k=c.flash_block_k,
                                     window=window)

    def _block(self, x: torch.Tensor, layer: dict,
               positions: torch.Tensor, remat: str | None = None,
               return_kv: bool = False, attend=None, drop=None,
               local_aux: bool = False):
        """One decoder block. x: (B, S, D) in compute dtype. Returns (x,
        aux): the MoE layer's aux (0 for the dense MLP), and with
        ``return_kv`` the post-rope (k, v) third, from which generation's
        prefill fills its cache. ``remat``: the remat policy to apply
        (None: save everything autograd needs). Under a tp binding the
        weights are this rank's blocks and every ``reduce_from_tp`` stays
        outside every recomputed function. ``attend(q, k, v)``: the
        attention (default: the model's, over these positions).
        ``drop(y, site)``: dropout on the residual branches (site 0 the
        attention's projection, 1 the MLP's output with ``bo``), outside
        every recomputed function. ``local_aux``: the MoE aux of these
        tokens alone, not summed over the bound data group
        (generation)."""
        attend = attend or self._attention
        drop = drop or (lambda y, site: y)
        c = self.cfg
        dt = x.dtype
        a, m = layer["attn"], layer["mlp"]
        tp = self._tp
        copy, reduce = (tp.copy, tp.reduce) if tp else (_same, _same)

        def kv_weight(w):
            w = w.to(dt)
            return w if self._kv_index is None else w.index_select(
                1, self._kv_index)

        def qkv(x):
            h = copy(_layer_norm(x, layer["ln1"]["scale"],
                                 layer["ln1"]["bias"]))
            q = torch.einsum("bsd,dhk->bshk", h, a["wq"].to(dt))
            k = torch.einsum("bsd,dhk->bshk", h, kv_weight(a["wk"]))
            v = torch.einsum("bsd,dhk->bshk", h, kv_weight(a["wv"]))
            if c.pos_encoding == "rope":
                q, k = _rope(q, k, positions)
            return q, k, v

        def ln2(x):
            return _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])

        def mlp(h):
            """This rank's part of the MLP's output, before ``bo``."""
            return _mlp_post(_mlp_pre(h, m["wi"].to(dt), m["bi"].to(dt)),
                             m["wo"].to(dt))

        def attn_out(attn):
            return reduce(torch.einsum("bshk,hkd->bsd", attn,
                                       a["wo"].to(dt)))

        ckpt = remat in ("full", "selective")
        q, k, v = _checkpoint(qkv, x) if ckpt else qkv(x)
        x = x + drop(attn_out(attend(q, k, v)), 0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if c.moe_num_experts > 0:
            # Routed on ln2's output itself: only the experts' input
            # goes through copy_to_tp, so the router's gradient is whole.
            seq = self._seq_slice(x.shape[1])
            part, aux = _moe_mlp(
                ln2(x), m, c, seq=seq,
                sp=(self._sp.group, self._sp.rank) if seq else None,
                aux_fn=None if local_aux else self._moe_aux,
                copy=copy, reduce=reduce, ffn=_experts(remat))
            x = x + drop(part, 1)
        else:
            if ckpt:
                part = _checkpoint(lambda x: mlp(copy(ln2(x))), x)
            elif remat in ("mlp", "mlp_pre"):
                part = _RematMLP.apply(copy(ln2(x)), m["wi"].to(dt),
                                       m["bi"].to(dt), m["wo"].to(dt),
                                       remat == "mlp_pre")
            else:
                part = mlp(copy(ln2(x)))
            x = x + drop(reduce(part) + m["bo"].to(dt), 1)
        return (x, aux, (k, v)) if return_kv else (x, aux)

    def _embed(self, params: dict, tokens: torch.Tensor,
               rng: int | None = None) -> torch.Tensor:
        """tokens (B, S) → embeddings (B, S, D) in compute dtype, the
        positions (under sp, this slice's) added and the embedding's
        dropout applied: the pipeline's first stage."""
        c = self.cfg
        dt = torch_dtype(c.dtype)
        S = tokens.shape[1]
        tokens = tokens.to(device=self.device, dtype=torch.long)
        table = self._leaf(params, "tok_embed", dt)
        x = table[tokens] if self._tp is None else self._tp.embed(table,
                                                                 tokens)
        # Under sp, this slice's global positions; its dropout masks are
        # slices of the whole sequence's (``_dropout``'s ``seq``).
        seq = self._seq_slice(S)
        start = seq[0] if seq else 0
        if c.pos_encoding == "learned":
            x = x + self._leaf(params, "pos_embed", dt)[start:start + S]
        if rng is not None and c.dropout > 0.0:
            x = _dropout(x, c.dropout, dropout_seed(rng, None),
                         *((seq,) if seq else ()))
        return x

    def _run_layers(self, params: dict, x: torch.Tensor, layer_ids: range,
                    remat: str | None = None,
                    rng: int | None = None) -> tuple:
        """The blocks of the global layers ``layer_ids`` (consecutive)
        over x (B, S, D): a whole stack, or one pipeline chunk. Returns
        (x, the sum of the layers' MoE aux). ``rng``: the dropout seed of
        these rows (None: no dropout)."""
        c = self.cfg
        dt = x.dtype
        seq = self._seq_slice(x.shape[1])
        start = seq[0] if seq else 0
        in_seq = (seq,) if seq else ()
        positions = torch.arange(start, start + x.shape[1],
                                 device=self.device)
        dropping = rng is not None and c.dropout > 0.0
        whole = len(layer_ids) == c.n_layers
        parts = {k: {n: (w if whole else w.narrow(0, layer_ids.start,
                                                  len(layer_ids))).unbind(0)
                     for n, w in params[k].items()}
                 for k in _STACKED}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lid in enumerate(layer_ids):
            layer = {k: {n: ws[i] for n, ws in parts[k].items()}
                     for k in _STACKED}
            if self._gather is not None:
                layer = self._gather.layer(_cast_layer(layer, dt))
            drop = None
            if dropping:
                def drop(y, site, lid=lid):
                    return _dropout(y, c.dropout,
                                    dropout_seed(rng, lid, site), *in_seq)
            x, part = self._block(x, layer, positions, remat, drop=drop)
            aux = aux + part
        return x, aux

    def _final_norm(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The final layer norm: the pipeline's last stage."""
        norm = params["final_norm"]
        if self._gather is not None:
            norm = {n: self._gather.leaf(f"final_norm/{n}", w)
                    for n, w in norm.items()}
        return _layer_norm(x, norm["scale"], norm["bias"])

    def _trunk(self, params: dict, tokens: torch.Tensor,
               remat: str | None = None, rng: int | None = None) -> tuple:
        """tokens (B, S) → final-norm hidden states (B, S, D) in compute
        dtype, plus the MoE aux, the mean over the layers (0 without
        MoE). ``rng``: the step's dropout seed (None: no dropout). Every
        layer runs here, also under a bound pp group (``apply``'s whole
        forward)."""
        x = self._embed(params, tokens, rng)
        x, aux = self._run_layers(params, x, range(self.cfg.n_layers), remat,
                                  rng)
        x = self._final_norm(params, x)
        return x, aux / self.cfg.n_layers

    def _head(self, params: dict, dt=None) -> torch.Tensor:
        """Unembedding matrix (D, V), cast to ``dt`` when given; under a
        tp binding this rank's columns (D, V/tp)."""
        if self.cfg.tie_embeddings:
            return self._leaf(params, "tok_embed", dt).T
        return self._leaf(params, "lm_head", dt)

    @torch.no_grad()
    def apply(self, params: dict, tokens, rng=None,
              train: bool = False) -> tuple:
        """tokens (B, S) int → logits (B, S, V) f32 over the whole vocab
        (under a tp binding each rank's vocab columns, gathered), aux
        loss scalar. No gradients: training goes through ``loss``.
        Dropout is active only when ``train`` and an ``rng`` seed are
        given; inference is deterministic."""
        tokens = torch.as_tensor(tokens)
        x, aux = self._trunk(params, tokens, rng=rng if train else None)
        logits = torch.einsum("bsd,dv->bsv", x, self._head(params, x.dtype))
        if self._tp is not None:
            logits = self._tp.gather(logits)
        return logits.float(), aux

    # -- training ------------------------------------------------------------

    def loss(self, params: dict, batch, rng=None, train: bool = True,
             shard_weight=None) -> tuple:
        """Next-token loss over ``batch["tokens"]`` (B, S + 1): the
        model reads ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``.
        Returns (scalar f32 loss, metrics), differentiable in the params
        by autograd. Negative target ids are masked pad positions: the
        loss is the mean over real tokens. ``loss_impl="fused"`` takes the
        chunked head (ops/xent.py, no (B, S, V) residual); ``"dense"``
        the full logits. Remat (``cfg.remat``) applies when gradients are
        being recorded; dropout when ``train`` and an ``rng`` seed (the
        trainer's step seed) are given. Under a bound sp group the batch
        holds this process's slice (B, S/sp + 1) and the loss is the data
        shard's mean over the group's real tokens. Under a bound pp group
        it runs the pipeline's forward alone, with no autograd graph, and
        returns the last stage's loss on every stage (gradients come from
        ``pipeline_grads``). With MoE the loss adds ``moe_aux_weight``
        times the aux, reported as ``moe_aux``; ``shard_weight``: the
        weight the caller puts on this loss before it averages the
        gradients over the data shards (the trainer's live-target share
        times the shard count; None: 1), which the aux's gradient, a
        share of the global batch's, undoes."""
        c = self.cfg
        if c.loss_impl == "dense" and self._tp is not None:
            raise ValueError(
                "loss_impl='dense' needs the whole vocab's logits; under "
                "tensor parallelism use loss_impl='fused' (vocab-parallel)")
        tokens = torch.as_tensor(batch["tokens"]).to(
            device=self.device, dtype=torch.long)
        rng = rng if train else None
        if self._pp is not None:
            if torch.is_grad_enabled():
                raise RuntimeError(
                    "under a bound pp group the loss is not differentiable "
                    "by autograd: take gradients from pipeline_grads")
            return self._pp_step(params, tokens, rng, grads=False)
        remat = (c.remat_policy if c.remat and torch.is_grad_enabled()
                 else None)
        with self._aux_scaled(shard_weight):
            x, aux = self._trunk(params, tokens[:, :-1], remat, rng=rng)
        loss = self._loss_of_hidden(params, x, tokens[:, 1:])
        return self._with_aux(loss, aux)

    @contextlib.contextmanager
    def _aux_scaled(self, shard_weight):
        """Within it, the MoE aux's gradient share is scaled by the data
        shards over ``shard_weight`` (``loss``)."""
        shards = self._data.shards if self._data is not None else 1
        self._aux_scale = (shards if shard_weight is None
                           else shards / shard_weight)
        try:
            yield
        finally:
            self._aux_scale = 1.0

    def _with_aux(self, loss: torch.Tensor, aux: torch.Tensor) -> tuple:
        """(the loss plus the weighted MoE aux, metrics): ``loss`` the
        next-token loss, as JAX's ``loss`` reports it."""
        metrics = {"loss": loss.detach(),
                   "perplexity": torch.exp(loss.detach())}
        if self.cfg.moe_num_experts > 0:
            loss = loss + self.cfg.moe_aux_weight * aux
            metrics["moe_aux"] = aux.detach()
        return loss, metrics

    def _loss_of_hidden(self, params: dict, x: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
        """The mean next-token loss over the real targets of the
        final-norm hidden states x (B, S, D): the head, the fused or the
        dense cross-entropy, and under sp the sums over the group."""
        c = self.cfg
        tp = self._tp
        head = self._head(params, x.dtype)
        if c.loss_impl == "fused":
            if tp is not None:
                x = tp.copy(x)
            nll = lm_cross_entropy(
                x, head, targets, chunk_rows=c.xent_chunk_rows,
                group=tp.group if tp else None,
                vocab_start=tp.rank * head.shape[1] if tp else 0)
        else:
            logits = torch.einsum("bsd,dv->bsv", x, head).float()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1,
                                targets.clamp(min=0)[..., None])[..., 0]
            nll = torch.where(targets >= 0, nll, 0.0)
        if self._seq_slice(targets.shape[1]) is not None:
            # The data shard's mean over real tokens: the sum and the
            # count of live targets over the sp group's slices.
            tot = sum_over_sp(torch.stack(
                [nll.sum(), (targets >= 0).sum().to(nll.dtype)]), self._sp)
            return tot[0] / tot[1].clamp(min=1)
        valid = (targets >= 0).sum().clamp(min=1)
        return nll.sum() / valid

    # -- pipeline ------------------------------------------------------------

    def pipeline_grads(self, params: dict, batch, rng=None,
                       scale: torch.Tensor | None = None) -> tuple:
        """Under a bound pp group, this stage's part of one forward and
        backward of ``loss`` over ``batch`` (collective over the pp
        group): the gradients of ``loss * scale`` (``scale`` None: 1) are
        accumulated into the ``.grad`` of each param leaf this stage
        uses (its chunks' layers; the embedding on stage 0; the final
        norm and the head on the last stage), partial over ``pp``.
        Returns (loss, metrics) as ``loss``, the same on every stage."""
        tokens = torch.as_tensor(batch["tokens"]).to(
            device=self.device, dtype=torch.long)
        return self._pp_step(params, tokens, rng, grads=True, scale=scale)

    def _pp_step(self, params: dict, tokens: torch.Tensor, rng,
                 grads: bool, scale=None) -> tuple:
        """The pipelined forward (and with ``grads`` its backward) of the
        next-token loss over tokens (B, S + 1); returns (loss, metrics)
        as ``loss`` does, the same on every stage (detached). The MoE
        aux is summed over the microbatches, the layers and the stages
        and divided by ``M`` and ``n_layers``, as JAX's; its gradient
        reaches every recomputed chunk through the pipeline's
        ``g_aux``."""
        c = self.cfg
        pp = self._pp
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        B, S = inputs.shape
        M = pipeline.num_microbatches(B * self._pp_shards, c.pp_microbatches,
                                      self._pp_shards)
        pipeline.check_pipeline(c.pp_schedule, B, M, c.n_layers, pp.size,
                                c.pp_virtual_stages)

        def run_chunk(vstage, x, mb):
            layers = pipeline.chunk_layers(c.n_layers, pp.size, c.pp_schedule,
                                           c.pp_virtual_stages, vstage)
            mrng = (rng if rng is None or M == 1
                    else fold_seed(rng, _PP_MICROBATCH_KEY, mb))
            return self._run_layers(params, x, layers, None, mrng)

        pipe = pipeline.Pipeline(pp, run_chunk, M, c.pp_schedule,
                                 c.pp_virtual_stages)
        like = ((B // M, S, c.d_model), torch_dtype(c.dtype), self.device)
        x0 = None
        if pp.is_first:
            with torch.set_grad_enabled(grads):
                x0 = self._embed(params, inputs, rng)
        with self._aux_scaled(scale):
            outs, aux = pipe.forward(
                pipeline.split_microbatches(x0.detach(), M) if pp.is_first
                else None, like)
        div = M * c.n_layers
        if c.moe_num_experts > 0:
            aux = pp.sum(aux) / div
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        g_outs = None
        if pp.is_last:
            h = pipeline.merge_microbatches(outs).requires_grad_(grads)
            with torch.set_grad_enabled(grads):
                loss = self._loss_of_hidden(
                    params, self._final_norm(params, h), targets)
            if grads:
                (loss if scale is None else loss * scale).backward()
                g_outs = pipeline.split_microbatches(h.grad, M)
        if grads:
            g_aux = None
            if c.moe_num_experts > 0:
                g_aux = (c.moe_aux_weight / div) * torch.as_tensor(
                    1.0 if scale is None else scale, dtype=torch.float32,
                    device=self.device)
            with self._aux_scaled(scale):
                g_in = pipe.backward(g_outs, like, g_aux)
            if pp.is_first:
                x0.backward(pipeline.merge_microbatches(g_in))
        return self._with_aux(pp.broadcast_from_last(loss.detach()), aux)

    # -- generation ----------------------------------------------------------

    def _decode_cache_len(self, max_len: int) -> int:
        """KV-cache capacity for decode: a sliding window keeps only its
        last ``window`` positions (a rolling buffer), full causal every
        position."""
        c = self.cfg
        return min(max_len, c.attention_window) if c.attention_window \
            else max_len

    def _attend_cache(self, q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int) -> torch.Tensor:
        """One position's attention: q (B, 1, H, hd) against the cache
        (B, Sm, Hkv, hd), GQA-grouped (hkv-major head order), products
        summed in f32 as the JAX ``preferred_element_type``.

        The cache is a modular ring over absolute positions: position p
        lives in slot ``p % Sm``, so slot s holds absolute position
        ``pos - ((pos - s) mod Sm)``; a slot is visible when that is >= 0
        (written) and inside the attention window when one is set."""
        c = self.cfg
        group = c.n_heads // c.n_kv_heads
        B, Sm = k_cache.shape[0], k_cache.shape[1]
        qg = q[:, 0].reshape(B, c.n_kv_heads, group, c.head_dim)
        logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                              k_cache.float()) * c.head_dim ** -0.5
        idx = torch.arange(Sm, device=q.device)
        abs_pos = pos - torch.remainder(pos - idx, Sm)
        mask = abs_pos >= 0
        if c.attention_window:
            mask = mask & (abs_pos >= pos - (c.attention_window - 1))
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd",
                           probs.to(v_cache.dtype).float(), v_cache.float())
        return out.reshape(B, 1, c.n_heads, c.head_dim).to(q.dtype)

    def _block_decode(self, x: torch.Tensor, layer: dict,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      pos: int) -> torch.Tensor:
        """One block (``_block``) for one new token at position ``pos``,
        x (B, 1, D): its attention writes the token's k and v into the
        layer's cache in place and reads the cache. A MoE layer routes
        the token alone (a group of 1, capacity 1: nothing drops)."""
        def attend(q, k, v):
            slot = pos % k_cache.shape[1]
            k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
            v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
            return self._attend_cache(q, k_cache, v_cache, pos)

        return self._block(x, layer, torch.full((1,), pos, device=x.device),
                           attend=attend, local_aux=True)[0]

    def _lm_head(self, params: dict, x_last: torch.Tensor) -> torch.Tensor:
        """(B, D) hidden → (B, V) f32 logits (final norm and head)."""
        x = _layer_norm(x_last, params["final_norm"]["scale"],
                        params["final_norm"]["bias"])
        return torch.einsum("bd,dv->bv", x,
                            self._head(params, x.dtype)).float()

    @torch.no_grad()
    def prefill(self, params: dict, tokens, max_len: int) -> tuple:
        """The prompt (B, P) through the stack: per-layer KV caches
        (L, B, Sm, Hkv, hd) in the compute dtype, ``Sm =
        _decode_cache_len(max_len)`` (position p in slot ``p % Sm``, the
        layout ``_attend_cache`` reads), and f32 logits (B, V) for the
        next position. The prompt's attention takes the model's
        ``attention_impl``, the flash forward on the card."""
        c = self.cfg
        dt = torch_dtype(c.dtype)
        tokens = torch.as_tensor(tokens).to(device=self.device,
                                            dtype=torch.long)
        B, P = tokens.shape
        x = params["tok_embed"][tokens].to(dt)
        positions = torch.arange(P, device=self.device)
        if c.pos_encoding == "learned":
            x = x + params["pos_embed"][:P].to(dt)
        ks, vs = [], []
        for layer in _layers(params, c.n_layers):
            x, _, (k, v) = self._block(x, layer, positions, return_kv=True,
                                       local_aux=True)
            ks.append(k)
            vs.append(v)
        Sm = self._decode_cache_len(max_len)
        keep = min(P, Sm)
        slots = torch.arange(P - keep, P, device=self.device) % Sm
        shape = (c.n_layers, B, Sm, c.n_kv_heads, c.head_dim)
        k_cache = torch.zeros(shape, dtype=dt, device=self.device)
        v_cache = torch.zeros(shape, dtype=dt, device=self.device)
        k_cache[:, :, slots] = torch.stack(ks)[:, :, P - keep:].to(dt)
        v_cache[:, :, slots] = torch.stack(vs)[:, :, P - keep:].to(dt)
        return k_cache, v_cache, self._lm_head(params, x[:, -1])

    @torch.no_grad()
    def generate(self, params: dict, prompt, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0, rng=None,
                 max_len: int | None = None) -> torch.Tensor:
        """Autoregressive decode over a dense KV cache: (B, P) prompt →
        (B, max_new_tokens) int32 tokens. ``temperature == 0`` is greedy;
        otherwise categorical sampling (after the ``top_k`` cut when
        set) from ``rng``, a seed or a ``torch.Generator`` on this
        model's device. The JAX package draws with ``jax.random``, which
        torch cannot replay: greedy tokens agree across the packages,
        sampled ones only within one."""
        c = self.cfg
        prompt = torch.as_tensor(prompt).to(device=self.device,
                                            dtype=torch.long)
        B, P = prompt.shape
        max_len = max_len or c.max_seq_len
        if P + max_new_tokens > max_len:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({max_len})")
        if temperature > 0 and rng is None:
            raise ValueError("sampling (temperature > 0) needs an rng")
        gen = None
        if temperature > 0:
            gen = rng if isinstance(rng, torch.Generator) else \
                make_generator(rng, self.device)

        def sample(logits):
            if temperature <= 0:
                return torch.argmax(logits, dim=-1)
            logits = logits / temperature
            if top_k:
                kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
                logits = torch.where(logits < kth, -torch.inf, logits)
            return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                     generator=gen)[:, 0]

        params = cast_for_compute(params, c)
        dt = torch_dtype(c.dtype)
        k_cache, v_cache, logits = self.prefill(params, prompt, max_len)
        layers = _layers(params, c.n_layers)
        tok = sample(logits)
        out = [tok]
        for i in range(max_new_tokens - 1):
            pos = P + i
            x = params["tok_embed"][tok][:, None, :].to(dt)
            if c.pos_encoding == "learned":
                x = x + params["pos_embed"][pos].to(dt)
            for li, layer in enumerate(layers):
                x = self._block_decode(x, layer, k_cache[li], v_cache[li],
                                       pos)
            tok = sample(self._lm_head(params, x[:, 0]))
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)

    # -- accounting ----------------------------------------------------------

    def num_params(self) -> int:
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            n = 1
            for d in tree:
                n *= d
            return n
        return count(param_shapes(self.cfg))

    def flops_per_token(self, seq_len: int | None = None) -> float:
        """Forward + backward FLOPs per token: 6 * N plus the attention
        quadratic term (causal: half; sliding window: the band's mean
        width), the JAX package's PaLM-appendix accounting; under MoE N
        counts top_k of the E experts."""
        c = self.cfg
        S = seq_len or c.max_seq_len
        N = self.num_params()
        if c.moe_num_experts > 0:
            # Only top_k of the experts run for a token.
            expert_p = c.moe_num_experts * 2 * c.d_model * c.d_ff * c.n_layers
            N = N - expert_p + expert_p * c.moe_top_k // c.moe_num_experts
        if c.attention_window:
            W = min(c.attention_window, S)
            avg_keys = W - W * (W - 1) / (2 * S)
        else:
            avg_keys = S * 0.5
        return 6.0 * N + 12 * c.n_layers * c.d_model * avg_keys

    def flops_per_sample(self) -> float:
        S = self.cfg.max_seq_len
        return self.flops_per_token(S) * S


def build_transformer(name: str, loss: str = "auto",
                      dtype: str = "bfloat16", device=None,
                      **kwargs) -> Transformer:
    """Build from a preset name or raw kwargs (the registry's entry),
    as the JAX ``build_transformer``; ``device`` as ``Transformer``."""
    preset = dict(PRESETS.get(name, {}))
    if name == "moe_transformer":
        preset = dict(d_model=512, n_layers=8, n_heads=8, max_seq_len=512,
                      moe_num_experts=8)
    preset.update(kwargs)
    preset.setdefault("dtype", dtype)
    if loss != "auto":
        preset["loss_name"] = loss
    return Transformer(TransformerConfig(**preset), device=device)


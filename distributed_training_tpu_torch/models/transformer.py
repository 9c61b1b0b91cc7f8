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
ranks compute their heads; JAX's stage params are whole over tp). The
dense block has no aux loss to divide by ``M``.

MoE (item 16c) waits for a later slice (ROADMAP.md queue A) and raises
``NotImplementedError`` when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.ops.xent import lm_cross_entropy
from distributed_training_tpu_torch.parallel import pipeline
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
        if cfg.moe_num_experts > 0:
            raise NotImplementedError(
                "MoE layers wait for ROADMAP.md queue A item 16c (MoE and "
                "expert parallelism)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._gather = None
        self._tp = None
        self._kv_index = None
        self._sp = None
        self._pp = None
        self._pp_shards = 1

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
        params = {
            "tok_embed": normal(shapes["tok_embed"], std),
            "ln1": norm_pair(shapes["ln1"]["scale"]),
            "ln2": norm_pair(shapes["ln2"]["scale"]),
            "attn": {"wq": normal(a["wq"], std),
                     "wk": normal(a["wk"], std),
                     "wv": normal(a["wv"], std),
                     "wo": normal(a["wo"], out_std)},
            "final_norm": norm_pair(shapes["final_norm"]["scale"]),
            "mlp": {"wi": normal(m["wi"], std),
                    "bi": torch.zeros(m["bi"], dtype=pdt,
                                      device=self.device),
                    "wo": normal(m["wo"], out_std),
                    "bo": torch.zeros(m["bo"], dtype=pdt,
                                      device=self.device)},
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
               return_kv: bool = False, attend=None, drop=None):
        """One decoder block. x: (B, S, D) in compute dtype. ``remat``:
        the remat policy to apply (None: save everything autograd
        needs). Under a tp binding the weights are this rank's blocks
        and the two ``reduce_from_tp`` stay outside every recomputed
        function. ``return_kv``: also return the post-rope (k, v), from
        which generation's prefill fills its cache. ``attend(q, k, v)``:
        the attention (default: the model's, over these positions).
        ``drop(y, site)``: dropout on the residual branches (site 0 the
        attention's projection, 1 the MLP's output with ``bo``), outside
        every recomputed function."""
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

        def mlp_in(x):
            return copy(_layer_norm(x, layer["ln2"]["scale"],
                                    layer["ln2"]["bias"]))

        def mlp(h):
            """This rank's part of the MLP's output, before ``bo``."""
            return _mlp_post(_mlp_pre(h, m["wi"].to(dt), m["bi"].to(dt)),
                             m["wo"].to(dt))

        def attn_out(attn):
            return reduce(torch.einsum("bshk,hkd->bsd", attn,
                                       a["wo"].to(dt)))

        if remat in ("full", "selective"):
            q, k, v = _checkpoint(qkv, x)
            x = x + drop(attn_out(attend(q, k, v)), 0)
            part = _checkpoint(lambda x: mlp(mlp_in(x)), x)
        else:
            q, k, v = qkv(x)
            x = x + drop(attn_out(attend(q, k, v)), 0)
            h = mlp_in(x)
            if remat in ("mlp", "mlp_pre"):
                part = _RematMLP.apply(h, m["wi"].to(dt), m["bi"].to(dt),
                                       m["wo"].to(dt), remat == "mlp_pre")
            else:
                part = mlp(h)
        x = x + drop(reduce(part) + m["bo"].to(dt), 1)
        return (x, (k, v)) if return_kv else x

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
                    rng: int | None = None) -> torch.Tensor:
        """The blocks of the global layers ``layer_ids`` (consecutive)
        over x (B, S, D): a whole stack, or one pipeline chunk. ``rng``:
        the dropout seed of these rows (None: no dropout)."""
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
            x = self._block(x, layer, positions, remat, drop=drop)
        return x

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
        dtype, plus the (zero) aux loss. ``rng``: the step's dropout
        seed (None: no dropout). Every layer runs here, also under a
        bound pp group (``apply``'s whole forward)."""
        x = self._embed(params, tokens, rng)
        x = self._run_layers(params, x, range(self.cfg.n_layers), remat, rng)
        x = self._final_norm(params, x)
        return x, torch.zeros((), dtype=torch.float32, device=self.device)

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

    def loss(self, params: dict, batch, rng=None,
             train: bool = True) -> tuple:
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
        ``pipeline_grads``)."""
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
            loss = self._pp_step(params, tokens, rng, grads=False)
        else:
            remat = (c.remat_policy if c.remat and torch.is_grad_enabled()
                     else None)
            x, _ = self._trunk(params, tokens[:, :-1], remat, rng=rng)
            loss = self._loss_of_hidden(params, x, tokens[:, 1:])
        metrics = {"loss": loss.detach(),
                   "perplexity": torch.exp(loss.detach())}
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
        loss = self._pp_step(params, tokens, rng, grads=True, scale=scale)
        return loss, {"loss": loss, "perplexity": torch.exp(loss)}

    def _pp_step(self, params: dict, tokens: torch.Tensor, rng,
                 grads: bool, scale=None) -> torch.Tensor:
        """The pipelined forward (and with ``grads`` its backward) of the
        next-token loss over tokens (B, S + 1); returns the last stage's
        loss on every stage (detached)."""
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
            x = self._run_layers(params, x, layers, None, mrng)
            return x, torch.zeros((), dtype=torch.float32, device=x.device)

        pipe = pipeline.Pipeline(pp, run_chunk, M, c.pp_schedule,
                                 c.pp_virtual_stages)
        like = ((B // M, S, c.d_model), torch_dtype(c.dtype), self.device)
        x0 = None
        if pp.is_first:
            with torch.set_grad_enabled(grads):
                x0 = self._embed(params, inputs, rng)
        outs, _ = pipe.forward(
            pipeline.split_microbatches(x0.detach(), M) if pp.is_first
            else None, like)
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
            g_in = pipe.backward(g_outs, like)
            if pp.is_first:
                x0.backward(pipeline.merge_microbatches(g_in))
        return pp.broadcast_from_last(loss.detach())

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
        layer's cache in place and reads the cache."""
        def attend(q, k, v):
            slot = pos % k_cache.shape[1]
            k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
            v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
            return self._attend_cache(q, k_cache, v_cache, pos)

        return self._block(x, layer, torch.full((1,), pos, device=x.device),
                           attend=attend)

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
            x, (k, v) = self._block(x, layer, positions, return_kv=True)
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
        width), the JAX package's PaLM-appendix accounting."""
        c = self.cfg
        S = seq_len or c.max_seq_len
        if c.attention_window:
            W = min(c.attention_window, S)
            avg_keys = W - W * (W - 1) / (2 * S)
        else:
            avg_keys = S * 0.5
        return 6.0 * self.num_params() + 12 * c.n_layers * c.d_model * avg_keys

    def flops_per_sample(self) -> float:
        S = self.cfg.max_seq_len
        return self.flops_per_token(S) * S


def build_transformer(name: str, loss: str = "auto",
                      dtype: str = "bfloat16", device=None,
                      **kwargs) -> Transformer:
    """Build from a preset name or raw kwargs (the registry's entry),
    as the JAX ``build_transformer``; ``device`` as ``Transformer``."""
    if name == "moe_transformer":
        raise NotImplementedError(
            "MoE layers wait for ROADMAP.md queue A item 16c (MoE and "
            "expert parallelism)")
    preset = dict(PRESETS.get(name, {}))
    preset.update(kwargs)
    preset.setdefault("dtype", dtype)
    if loss != "auto":
        preset["loss_name"] = loss
    return Transformer(TransformerConfig(**preset), device=device)


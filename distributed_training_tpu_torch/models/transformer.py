"""Decoder-only transformer (port of ``models/transformer.py``).

Same configuration (``TransformerConfig``, ``PRESETS``) and the same
weight pytree as the JAX package: a nested dict of tensors with stacked
``(L, …)`` per-layer leaves under ``tok_embed``, ``pos_embed``,
``ln1``/``ln2``, ``attn.{wq,wk,wv,wo}``, ``mlp.{wi,bi,wo,bo}``,
``final_norm`` and ``lm_head`` (absent when embeddings are tied), so
``models/convert.py`` carries JAX weights across leaf for leaf. A Python
loop over layers replaces ``lax.scan``.

``apply`` is the inference forward (the serving engine's dense
reference); ``loss`` is the training forward, differentiable by autograd
through the stacked leaves (the tied ``tok_embed`` takes both the
embedding-gather and the head gradient). Remat keeps the JAX policies'
intent with ``torch.utils.checkpoint``, and never around attention: the
flash kernel's residuals (q, k, v, out, lse) stay saved by its autograd
Function, so its forward launches once per layer per step:

- ``mlp``: recompute only the MLP sub-block ``gelu(h @ wi + bi) @ wo``;
- ``mlp_pre``: also save the pre-gelu ``h @ wi + bi``;
- ``selective`` and ``full``: recompute everything in the block but
  attention (in the JAX package ``full`` re-runs attention too).

Dropout, MoE, pipeline and sequence parallelism wait for later slices
(ROADMAP.md queue A) and raise ``NotImplementedError`` when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.ops.xent import lm_cross_entropy
from distributed_training_tpu_torch.runtime import make_generator, resolve_device


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


def cast_for_compute(params: dict, cfg: TransformerConfig) -> dict:
    """Every leaf the forward casts to the compute dtype, cast once.

    The JAX programs cast each weight at its use (``_w``); casting ahead
    gives the same values without a per-step cast. Layer-norm scales and
    biases stay in the parameter dtype: the norm applies them in f32."""
    dt = torch_dtype(cfg.dtype)
    out = {k: v for k, v in params.items()}
    for key in ("tok_embed", "pos_embed", "lm_head"):
        if key in params:
            out[key] = params[key].to(dt)
    out["attn"] = {k: w.to(dt) for k, w in params["attn"].items()}
    out["mlp"] = {k: w.to(dt) for k, w in params["mlp"].items()}
    return out


def layer_slice(params: dict, i: int) -> dict:
    """Layer ``i``'s weights from the stacked ``(L, …)`` leaves."""
    return {k: {n: w[i] for n, w in params[k].items()} for k in _STACKED}


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

    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.moe_num_experts > 0:
            raise NotImplementedError(
                "MoE layers wait for ROADMAP.md queue A 'Remaining "
                "parallelism and models'")
        self.cfg = cfg
        self.device = resolve_device(device)

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
        S = q.shape[1]
        # A window covering the whole sequence is plain causal.
        window = c.attention_window if 0 < c.attention_window < S else 0
        return dot_product_attention(q, k, v, causal=True,
                                     impl=c.attention_impl,
                                     block_q=c.flash_block_q,
                                     block_k=c.flash_block_k,
                                     window=window)

    def _block(self, x: torch.Tensor, layer: dict,
               positions: torch.Tensor, remat: str | None = None
               ) -> torch.Tensor:
        """One decoder block. x: (B, S, D) in compute dtype. ``remat``:
        the remat policy to apply (None: save everything autograd
        needs)."""
        c = self.cfg
        dt = x.dtype
        a, m = layer["attn"], layer["mlp"]

        def qkv(x):
            h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
            q = torch.einsum("bsd,dhk->bshk", h, a["wq"].to(dt))
            k = torch.einsum("bsd,dhk->bshk", h, a["wk"].to(dt))
            v = torch.einsum("bsd,dhk->bshk", h, a["wv"].to(dt))
            if c.pos_encoding == "rope":
                q, k = _rope(q, k, positions)
            return q, k, v

        def mlp_pre(h):
            return (torch.einsum("bsd,df->bsf", h, m["wi"].to(dt))
                    + m["bi"].to(dt))

        def mlp_post(u):
            return (torch.einsum("bsf,fd->bsd",
                                 F.gelu(u, approximate="tanh"),
                                 m["wo"].to(dt)) + m["bo"].to(dt))

        def out(x, attn):
            x = x + torch.einsum("bshk,hkd->bsd", attn, a["wo"].to(dt))
            h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
            if remat == "mlp":
                return x + _checkpoint(lambda h: mlp_post(mlp_pre(h)), h)
            if remat == "mlp_pre":
                return x + _checkpoint(mlp_post, mlp_pre(h))
            return x + mlp_post(mlp_pre(h))

        if remat in ("full", "selective"):
            q, k, v = _checkpoint(qkv, x)
            return _checkpoint(out, x, self._attention(q, k, v))
        return out(x, self._attention(*qkv(x)))

    def _trunk(self, params: dict, tokens: torch.Tensor,
               remat: str | None = None) -> tuple:
        """tokens (B, S) → final-norm hidden states (B, S, D) in compute
        dtype, plus the (zero) aux loss."""
        c = self.cfg
        dt = torch_dtype(c.dtype)
        S = tokens.shape[1]
        tokens = tokens.to(device=self.device, dtype=torch.long)
        x = params["tok_embed"].to(dt)[tokens]
        positions = torch.arange(S, device=self.device)
        if c.pos_encoding == "learned":
            x = x + params["pos_embed"].to(dt)[:S]
        for layer in _layers(params, c.n_layers):
            x = self._block(x, layer, positions, remat)
        x = _layer_norm(x, params["final_norm"]["scale"],
                        params["final_norm"]["bias"])
        return x, torch.zeros((), dtype=torch.float32, device=self.device)

    def _head(self, params: dict) -> torch.Tensor:
        """Unembedding matrix (D, V) in param dtype."""
        return (params["tok_embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    @torch.no_grad()
    def apply(self, params: dict, tokens, rng=None,
              train: bool = False) -> tuple:
        """tokens (B, S) int → logits (B, S, V) f32, aux loss scalar.
        No gradients: training goes through ``loss``. Dropout in
        training mode raises, as in ``loss``."""
        del rng
        if train and self.cfg.dropout > 0.0:
            raise NotImplementedError(
                "training-mode dropout waits for ROADMAP.md queue A item 3 "
                "'Training main path' (the RoPE/GQA half)")
        tokens = torch.as_tensor(tokens)
        x, aux = self._trunk(params, tokens)
        logits = torch.einsum("bsd,dv->bsv", x,
                              self._head(params).to(x.dtype))
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
        being recorded."""
        del rng
        c = self.cfg
        if train and c.dropout > 0.0:
            raise NotImplementedError(
                "training-mode dropout waits for ROADMAP.md queue A item 3 "
                "'Training main path' (the RoPE/GQA half)")
        tokens = torch.as_tensor(batch["tokens"]).to(
            device=self.device, dtype=torch.long)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        remat = (c.remat_policy if c.remat and torch.is_grad_enabled()
                 else None)
        x, _ = self._trunk(params, inputs, remat)
        head = self._head(params).to(x.dtype)
        if c.loss_impl == "fused":
            nll = lm_cross_entropy(x, head, targets,
                                   chunk_rows=c.xent_chunk_rows)
        else:
            logits = torch.einsum("bsd,dv->bsv", x, head).float()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1,
                                targets.clamp(min=0)[..., None])[..., 0]
            nll = torch.where(targets >= 0, nll, 0.0)
        valid = (targets >= 0).sum().clamp(min=1)
        loss = nll.sum() / valid
        metrics = {"loss": loss.detach(),
                   "perplexity": torch.exp(loss.detach())}
        return loss, metrics

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
            "MoE layers wait for ROADMAP.md queue A 'Remaining "
            "parallelism and models'")
    preset = dict(PRESETS.get(name, {}))
    preset.update(kwargs)
    preset.setdefault("dtype", dtype)
    if loss != "auto":
        preset["loss_name"] = loss
    return Transformer(TransformerConfig(**preset), device=device)


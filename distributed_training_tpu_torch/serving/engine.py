"""Continuous-batching engine over the paged KV cache (port).

The port of ``distributed_training_tpu/serving/engine.py`` for one card
and one dp group. Requests join and leave the running batch at every
step against fixed-shape programs:

- **prefill**, in one of two modes:
  ``batched`` (default) — up to ``prefill_slots`` sequences' current
  prompt chunks in one launch, each lane writing its chunk's KV through
  one batched page scatter and attending through the paged chunk form;
  the next token of every prompt-completing lane is sampled in the
  program, so completion reads an (S,) int block, never logits.
  ``sequential`` — one sequence's chunk per launch; a prompt's first
  chunk runs ordinary causal attention (``ops.attention``, which takes
  the flash-attention kernel on the card when the chunk is tile-sized),
  later chunks the paged chunk form, and the completing chunk returns
  its logits for a host-side sample.
- **decode** — one token for every decodable slot in one launch; each
  layer's attention is the paged-decode kernel on the card.

Pools are written in place (the JAX programs donate them instead).
PyTorch runs eagerly and has no jit cache: ``compile_counts()`` reports,
per program, how many times this process built the CUDA kernels that
program launches; after ``warmup()`` join/evict must never move them
(the port's counterpart of "no recompiles").

Scheduling (``EngineConfig.policy``): ``"prefill"`` runs pending prompt
work before decode (lowest TTFT); ``"decode"`` decodes the active batch
first. Sampling is greedy at ``temperature == 0`` (the parity-tested
path) and per-slot categorical with optional top-k otherwise, drawn
from a ``torch.Generator`` seeded with ``cfg.seed``.

Prefix sharing (refcounted page reuse with copy-on-write) and chat
sessions (a finished turn's pages retained under its session key for a
zero-prefill resume) are on by default, as in the JAX engine.

What waits for later slices raises ``NotImplementedError`` naming its
ROADMAP.md item: speculative and device-resident decode, a mesh or dp
groups, int8 weight leaves, weight hot-swap, drain, preempt/adopt/
export, fault hooks.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.kernels import build
from distributed_training_tpu_torch.models.transformer import (
    _layer_norm,
    cast_for_compute,
    layer_slice,
)
from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_chunk,
)
from distributed_training_tpu_torch.runtime import resolve_device
from distributed_training_tpu_torch.serving.kv_cache import (
    PagedCacheConfig,
    PagedKVCache,
)
from distributed_training_tpu_torch.telemetry import event

logger = logging.getLogger(__name__)

# ROADMAP.md queue A items the deferred features name.
SPEC_ITEM = "ROADMAP.md queue A 'Serving: speculative and resident decode'"
DP_ITEM = "ROADMAP.md queue A 'Serving: dp groups and a mesh'"
INT8_ITEM = "ROADMAP.md queue A 'Serving: int8 weight-only leaves'"
LIFECYCLE_ITEM = ("ROADMAP.md queue A 'Serving: hot-swap, drain, "
                  "preempt, adopt and export'")
FAULTS_ITEM = "ROADMAP.md queue A 'Serving: fault hooks'"

# The CUDA kernels each program launches (``compile_counts``).
_PROGRAM_KERNELS = {
    "decode": ("paged_decode",),
    "prefill_batch": (),
    "prefill_first": ("flash_fwd", "flash_fwd_sm90"),
    "prefill_cont": (),
    "cow": (),
}


@dataclass(frozen=True)
class EngineConfig:
    """Engine knobs (mirrored by ``conf/serving/default.yaml``), the
    JAX engine's fields and validations.

    ``prefill_slots`` is the lane count of the batched prefill program
    (0 = same as ``max_batch``). ``spec_k``/``resident_k`` > 1,
    ``kv_axis``/``dp_axis`` sharding and ``swap_staleness_tokens``
    belong to features later slices port."""

    max_batch: int = 8            # decode slots
    page_size: int = 16
    num_pages: int = 128          # scratch page 0 included
    max_seq_len: int = 256        # per-sequence cap (prompt + new)
    prefill_chunk: int = 32       # tokens per prefill lane per step
    prefill_slots: int = 0        # batched-prefill lanes (0 = max_batch)
    prefill_mode: str = "batched"  # "batched" | "sequential"
    spec_k: int = 1               # decode tokens per launch (1 = off)
    spec_ngram: int = 3           # longest prompt-lookup n-gram tried
    resident_k: int = 1           # device-resident decode steps (1 = off)
    prefix_sharing: bool = True   # refcounted prefix reuse + sessions
    eos_id: int = -1              # stop token (< 0 = disabled)
    policy: str = "prefill"       # "prefill" | "decode" priority
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    kv_axis: str = "tp"           # pool kv-head shard axis
    dp_axis: str = "dp"           # slot-table / pool batch shard axis
    paged_impl: str = "auto"      # ops/paged_attention dispatch
    swap_staleness_tokens: int = -1  # hot-swap bound (-1 = unbounded)

    def __post_init__(self):
        if self.swap_staleness_tokens < -1:
            raise ValueError(
                "swap_staleness_tokens must be >= -1 (-1 disables "
                "the bound; 0 resubmits every in-flight request with "
                "emitted tokens at swap time)")
        if self.policy not in ("prefill", "decode"):
            raise ValueError(
                f"unknown scheduling policy '{self.policy}' "
                "(expected 'prefill' or 'decode')")
        if self.prefill_mode not in ("batched", "sequential"):
            raise ValueError(
                f"unknown prefill_mode '{self.prefill_mode}' "
                "(expected 'batched' or 'sequential')")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.prefill_slots < 0:
            raise ValueError("prefill_slots must be >= 0")
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if self.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if self.spec_k > 1 and self.temperature > 0:
            raise ValueError(
                "speculative decode (spec_k > 1) requires greedy "
                "temperature == 0")
        if self.resident_k < 1:
            raise ValueError("resident_k must be >= 1")
        if self.resident_k > 1 and self.temperature > 0:
            raise ValueError(
                "device-resident decode (resident_k > 1) requires "
                "greedy temperature == 0")
        if self.resident_k > 1 and self.prefill_mode != "batched":
            raise ValueError(
                "device-resident decode (resident_k > 1) requires "
                "prefill_mode='batched'")


@dataclass
class Request:
    """One generation request. ``arrival`` defaults to submit time.
    ``session``: chat-session key — on completion the sequence's KV
    pages are retained under it, and a later request with the same key
    whose prompt extends the retained history re-attaches them.
    ``tenant``: accounting label carried into the completion record."""

    id: str
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float | None = None
    session: str | None = None
    tenant: str = "default"


@dataclass
class _Seq:
    req: Request
    slot: int
    prefilled: int = 0            # prompt tokens consumed so far
    generated: list = field(default_factory=list)
    first_token_t: float | None = None
    token_times: list = field(default_factory=list)
    eos: bool = False             # emitted the configured stop token
    queue_wait_s: float | None = None  # arrival -> admission

    @property
    def prompt_len(self) -> int:
        return int(self.req.prompt.shape[0])

    @property
    def last_token(self) -> int:
        """The token the next decode launch feeds. A zero-prefill
        admission (full prefix hit / exact session resume) replays the
        last prompt token at its resident position, which samples
        exactly the first token a prefill would have."""
        return int(self.generated[-1]) if self.generated \
            else int(self.req.prompt[-1])

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prompt_len

    @property
    def done(self) -> bool:
        return self.eos or \
            len(self.generated) >= self.req.max_new_tokens


# ---------------------------------------------------------------------------
# Programs: plain functions over device tensors. Pools arrive as the
# (1, L, Hkv, N, ps, hd) tensors and are written in place.
# ---------------------------------------------------------------------------


def _rope_bhd(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE on (..., H, hd) with per-row absolute positions (...) — the
    freqs and rotation of models.transformer._rope."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (10000 ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _write_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor,
              page_ids: torch.Tensor, offsets: torch.Tensor) -> None:
    """Scatter per-row new KV into one layer's pool, in place.

    k_pages/v_pages (Hkv, N, ps, hd); k_new/v_new (B, Hkv, hd);
    page_ids/offsets (B,) — rows whose write must be dead point at the
    scratch page 0. Live rows never share a (page, slot) pair, so the
    order of the scatter does not matter; scratch collisions write
    garbage over garbage."""
    k_pages[:, page_ids, offsets] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page_ids, offsets] = v_new.transpose(0, 1).to(v_pages.dtype)


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            gen: torch.Generator) -> torch.Tensor:
    """(B, V) f32 logits → (B,) sampled ids: argmax at temperature 0
    (first maximal index, as jnp.argmax), else categorical over the
    top-k-filtered, temperature-scaled logits."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    lg = logits / temperature
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def _head(params: dict, cfg) -> torch.Tensor:
    return (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])


def _mlp(x: torch.Tensor, layer: dict) -> torch.Tensor:
    h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
    m = layer["mlp"]
    u = F.gelu(h @ m["wi"] + m["bi"], approximate="tanh")
    return x + (u @ m["wo"] + m["bo"])


@torch.no_grad()
def _decode_program(params, k_pages, v_pages, tokens, positions,
                    page_tables, active, gen, *, cfg, temperature,
                    top_k, paged_impl) -> torch.Tensor:
    """One token for every slot of the table.

    ``params`` in compute dtype (``cast_for_compute``); tokens (B,) —
    last sampled token per slot; positions (B,) — the absolute position
    that token occupies (== kv entries already written); page_tables
    (B, P) int32; active (B,) bool. Returns next tokens (B,); inactive
    slots write into the scratch page and return 0."""
    ps, P = k_pages.shape[4], page_tables.shape[1]
    x = params["tok_embed"][tokens]                      # (B, D)
    if cfg.pos_encoding == "learned":
        x = x + params["pos_embed"][positions]
    logical = torch.clamp(positions // ps, max=P - 1)
    page_ids = torch.where(
        active, page_tables.gather(1, logical[:, None])[:, 0], 0)
    offsets = torch.where(active, positions % ps, 0)
    lengths = torch.where(active, positions + 1, 0).int()
    for i in range(cfg.n_layers):
        layer = layer_slice(params, i)
        a = layer["attn"]
        kp, vp = k_pages[0, i], v_pages[0, i]
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        q = torch.einsum("bd,dhk->bhk", h, a["wq"])
        k = torch.einsum("bd,dhk->bhk", h, a["wk"])
        v = torch.einsum("bd,dhk->bhk", h, a["wv"])
        if cfg.pos_encoding == "rope":
            q = _rope_bhd(q, positions)
            k = _rope_bhd(k, positions)
        _write_kv(kp, vp, k, v, page_ids.long(), offsets)
        attn = paged_attention(q, kp, vp, lengths, page_tables,
                               impl=paged_impl)
        x = x + torch.einsum("bhk,hkd->bd", attn, a["wo"])
        x = _mlp(x, layer)
    x = _layer_norm(x, params["final_norm"]["scale"],
                    params["final_norm"]["bias"])
    logits = (x @ _head(params, cfg)).float()
    return torch.where(active, _sample(logits, temperature, top_k, gen), 0)


@torch.no_grad()
def _prefill_program(params, k_pages, v_pages, page_row, live,
                     chunk_tokens, start_pos, n_valid, *, cfg,
                     first) -> torch.Tensor:
    """One prompt chunk of one sequence (the sequential prefill).

    page_row (P,) int32; live — False writes everything into the
    scratch page; chunk_tokens (C,) (positions >= n_valid are padding);
    start_pos — the chunk's first absolute position. Writes the chunk's
    KV and returns the next-token logits (V,) f32 of the last valid
    position.

    ``first`` (start_pos == 0): ordinary causal self-attention over the
    chunk through ``ops.attention`` (the flash kernel on the card for a
    tile-sized chunk). Later chunks attend the pool through the paged
    chunk form. Both write then read the pool identically."""
    C = chunk_tokens.shape[0]
    ps, P = k_pages.shape[4], page_row.shape[0]
    idx = torch.arange(C, device=chunk_tokens.device)
    abs_pos = start_pos + idx
    valid = (idx < n_valid) & live
    x = params["tok_embed"][chunk_tokens]                # (C, D)
    if cfg.pos_encoding == "learned":
        # Clamp padding positions into range; their rows are dead.
        x = x + params["pos_embed"][torch.clamp(abs_pos,
                                                max=cfg.max_seq_len - 1)]
    logical = torch.clamp(abs_pos // ps, max=P - 1)
    page_ids = torch.where(valid, page_row[logical], 0).long()
    offsets = torch.where(valid, abs_pos % ps, 0)
    q_pos = torch.where(valid, abs_pos, -1)[None, :]     # (1, C)
    impl = (cfg.attention_impl
            if cfg.attention_impl in ("auto", "flash", "naive") else "auto")
    for i in range(cfg.n_layers):
        layer = layer_slice(params, i)
        a = layer["attn"]
        kp, vp = k_pages[0, i], v_pages[0, i]
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        q = torch.einsum("cd,dhk->chk", h, a["wq"])
        k = torch.einsum("cd,dhk->chk", h, a["wk"])
        v = torch.einsum("cd,dhk->chk", h, a["wv"])
        if cfg.pos_encoding == "rope":
            q = _rope_bhd(q, abs_pos)
            k = _rope_bhd(k, abs_pos)
        _write_kv(kp, vp, k, v, page_ids, offsets)
        if first:
            attn = dot_product_attention(q[None], k[None], v[None],
                                         causal=True, impl=impl)[0]
        else:
            attn = paged_attention_chunk(q[None], kp, vp, page_row[None],
                                         q_pos)[0]
        x = x + torch.einsum("chk,hkd->cd", attn, a["wo"])
        x = _mlp(x, layer)
    x_last = x[max(int(n_valid) - 1, 0)]
    x_last = _layer_norm(x_last, params["final_norm"]["scale"],
                         params["final_norm"]["bias"])
    return (x_last @ _head(params, cfg)).float()


@torch.no_grad()
def _chunk_program(params, k_pages, v_pages, page_rows, tokens,
                   start_pos, n_valid, active, gen, *, cfg, temperature,
                   top_k) -> torch.Tensor:
    """Multi-token chunks for a whole lane table (the batched prefill).

    page_rows (S, P) int32; tokens (S, C) (positions >= n_valid[s] are
    padding); start_pos (S,) — each lane's first absolute position;
    n_valid (S,); active (S,) bool — dead lanes write into the scratch
    page and their queries mask out. Every lane's valid tokens' KV goes
    through one batched scatter per layer, then each query attends its
    own pages at positions <= its own. Returns the token sampled after
    each lane's last valid position, (S,); inactive lanes give 0."""
    S, C = tokens.shape
    ps, P = k_pages.shape[4], page_rows.shape[1]
    idx = torch.arange(C, device=tokens.device)
    abs_pos = start_pos[:, None] + idx[None, :]          # (S, C)
    valid = (idx[None, :] < n_valid[:, None]) & active[:, None]
    x = params["tok_embed"][tokens]                      # (S, C, D)
    if cfg.pos_encoding == "learned":
        x = x + params["pos_embed"][torch.clamp(abs_pos,
                                                max=cfg.max_seq_len - 1)]
    # Padding positions of a lane near max_seq_len could index past its
    # row: clamp the logical page first (JAX clamps such gathers
    # silently; a CUDA index would assert).
    logical = torch.clamp(abs_pos // ps, max=P - 1)
    page_ids = torch.where(valid, page_rows.gather(1, logical), 0)
    offsets = torch.where(valid, abs_pos % ps, 0)
    q_pos = torch.where(valid, abs_pos, -1)
    for i in range(cfg.n_layers):
        layer = layer_slice(params, i)
        a = layer["attn"]
        kp, vp = k_pages[0, i], v_pages[0, i]
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        q = torch.einsum("scd,dhk->schk", h, a["wq"])
        k = torch.einsum("scd,dhk->schk", h, a["wk"])
        v = torch.einsum("scd,dhk->schk", h, a["wv"])
        if cfg.pos_encoding == "rope":
            q = _rope_bhd(q, abs_pos)
            k = _rope_bhd(k, abs_pos)
        Hkv, hd = k.shape[2], k.shape[3]
        _write_kv(kp, vp, k.reshape(S * C, Hkv, hd),
                  v.reshape(S * C, Hkv, hd), page_ids.reshape(-1).long(),
                  offsets.reshape(-1))
        attn = paged_attention_chunk(q, kp, vp, page_rows, q_pos)
        x = x + torch.einsum("schk,hkd->scd", attn, a["wo"])
        x = _mlp(x, layer)
    last = torch.clamp(n_valid - 1, min=0)
    x_last = x[torch.arange(S, device=x.device), last]   # (S, D)
    x_last = _layer_norm(x_last, params["final_norm"]["scale"],
                         params["final_norm"]["bias"])
    logits = (x_last @ _head(params, cfg)).float()
    return torch.where(active, _sample(logits, temperature, top_k, gen), 0)


@torch.no_grad()
def _cow_program(k_pages, v_pages, src, dst) -> None:
    """Copy-on-write page copy in place: ``src``/``dst`` (W,) page ids,
    one gather + scatter per pool for all W copies. Unused lanes ride as
    (0 -> 0), a scratch-to-scratch identity copy."""
    for pages in (k_pages, v_pages):
        g = pages[0]                                     # (L, Hkv, N, ...)
        g[:, :, dst] = g[:, :, src]


def _check_weight_leaves(tree, device: torch.device, path: str = "") -> int:
    """Validate the weight pytree: tensors on ``device``; int8 weight-
    only leaves (``{"qw", "scale"}``) are a later slice's. Returns the
    byte count."""
    if isinstance(tree, dict):
        if "qw" in tree:
            raise NotImplementedError(
                f"int8 weight-only leaf at '{path}' waits for {INT8_ITEM}")
        return sum(_check_weight_leaves(v, device, f"{path}/{k}")
                   for k, v in tree.items())
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"weight leaf at '{path}' is {type(tree)}")
    if tree.device != device:
        raise ValueError(f"weight leaf at '{path}' is on {tree.device}, "
                         f"the engine runs on {device}")
    return tree.numel() * tree.element_size()


class Engine:
    """The continuous-batching engine over one model + weight set.

    ``model`` is the port's ``Transformer``; ``params`` its weight
    pytree, already on ``device``. ``device=None`` runs on the CUDA card
    and raises without one. Every step emits a ``serving`` telemetry
    record through the ambient sink."""

    def __init__(self, model, params, cfg: EngineConfig, mesh=None,
                 weights_version: str = "v0", device=None):
        if mesh is not None or cfg.dp_axis != "dp" or cfg.kv_axis != "tp":
            raise NotImplementedError(f"a mesh waits for {DP_ITEM}")
        if cfg.spec_k > 1 or cfg.resident_k > 1:
            raise NotImplementedError(
                f"spec_k={cfg.spec_k}, resident_k={cfg.resident_k}: "
                f"multi-token decode waits for {SPEC_ITEM}")
        if getattr(model.cfg, "moe_num_experts", 0) > 0:
            raise ValueError("serving engine has no MoE decode path")
        if cfg.max_seq_len > model.cfg.max_seq_len:
            raise ValueError(
                f"engine max_seq_len ({cfg.max_seq_len}) exceeds the "
                f"model's ({model.cfg.max_seq_len})")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.weight_bytes = _check_weight_leaves(params, self.device)
        self.params = params
        # Weights in compute dtype, cast once (the JAX programs cast at
        # each use); layer-norm parameters stay in param dtype.
        self._cparams = cast_for_compute(params, model.cfg)
        self.weights_version = weights_version
        self.batch_local = cfg.max_batch
        self.prefill_local = cfg.prefill_slots or cfg.max_batch
        self._sharing = cfg.prefix_sharing
        self.sessions: dict[str, dict] = {}
        self.prefix_stats = {"hit_tokens": 0, "saved_tokens": 0,
                             "cow_pages": 0, "session_resumes": 0}
        self._step_prefix = [0, 0]
        # Prompt tokens pushed through a prefill program, and program
        # launches per kind (a zero-prefill resume moves neither).
        self.prefill_tokens_computed = 0
        self.prefill_launches = 0
        self.decode_launches = 0
        self._cow_width = max(self.batch_local, self.prefill_local)
        # Every device->host transfer of the step loop goes through
        # ``_fetch_host``, so this count is exact.
        self.host_syncs = 0
        self.cache = PagedKVCache(
            PagedCacheConfig(
                n_layers=model.cfg.n_layers,
                n_kv_heads=model.cfg.n_kv_heads,
                head_dim=model.cfg.head_dim,
                page_size=cfg.page_size,
                num_pages=cfg.num_pages,
                max_seq_len=cfg.max_seq_len,
                dtype=model.cfg.dtype),
            device=self.device)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[_Seq | None] = [None] * cfg.max_batch
        self.completed: list[dict] = []
        self._step_counter = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self._host_gen = torch.Generator()
        self._host_gen.manual_seed(cfg.seed + 1_000_000)
        self._token_listeners: dict[str, object] = {}
        self.launch_count = 0

    # -- deferred features ---------------------------------------------------

    @property
    def faults(self):
        """Fault-injection hook slot; always None in this slice."""
        return None

    @faults.setter
    def faults(self, injector) -> None:
        if injector is not None:
            raise NotImplementedError(f"fault hooks wait for {FAULTS_ITEM}")

    def swap_weights(self, params, version: str,
                     provenance: dict | None = None):
        raise NotImplementedError(f"swap_weights waits for {LIFECYCLE_ITEM}")

    def drain(self, deadline_s: float | None = None) -> dict:
        raise NotImplementedError(f"drain waits for {LIFECYCLE_ITEM}")

    def preempt(self) -> list:
        raise NotImplementedError(f"preempt waits for {LIFECYCLE_ITEM}")

    def adopt(self, req, first_token, k_dense, v_dense) -> None:
        raise NotImplementedError(f"adopt waits for {LIFECYCLE_ITEM}")

    def adopt_batch(self, items) -> None:
        raise NotImplementedError(f"adopt_batch waits for {LIFECYCLE_ITEM}")

    def export_in_flight(self) -> dict:
        raise NotImplementedError(
            f"export_in_flight waits for {LIFECYCLE_ITEM}")

    # -- programs ------------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode(self, tokens, positions, rows, active) -> torch.Tensor:
        c = self.cfg
        return _decode_program(
            self._cparams, self.cache.k_pages, self.cache.v_pages,
            self._t(tokens).long(), self._t(positions).long(),
            self._t(rows), self._t(active), self._gen,
            cfg=self.model.cfg, temperature=c.temperature, top_k=c.top_k,
            paged_impl=c.paged_impl)

    def _prefill_batch(self, rows, tokens, start_pos, n_valid,
                       active) -> torch.Tensor:
        c = self.cfg
        return _chunk_program(
            self._cparams, self.cache.k_pages, self.cache.v_pages,
            self._t(rows), self._t(tokens).long(),
            self._t(start_pos).long(), self._t(n_valid).long(),
            self._t(active), self._gen, cfg=self.model.cfg,
            temperature=c.temperature, top_k=c.top_k)

    def _prefill_one(self, row, live: bool, chunk, start: int,
                     n_valid: int) -> torch.Tensor:
        return _prefill_program(
            self._cparams, self.cache.k_pages, self.cache.v_pages,
            self._t(row), live, self._t(chunk).long(), start, n_valid,
            cfg=self.model.cfg, first=start == 0)

    def _cow(self, src: np.ndarray, dst: np.ndarray) -> None:
        _cow_program(self.cache.k_pages, self.cache.v_pages,
                     self._t(src).long(), self._t(dst).long())

    def compile_counts(self) -> dict:
        """Per program, the builds of the CUDA kernels it launches that
        this process ran. ``warmup()`` builds what the programs need;
        join/evict must never move these counts afterwards."""
        names = ["decode"]
        names += (["prefill_batch"] if self.cfg.prefill_mode == "batched"
                  else ["prefill_first", "prefill_cont"])
        if self._sharing:
            names.append("cow")
        return {n: sum(build.build_count(k) for k in _PROGRAM_KERNELS[n])
                for n in names}

    def warmup(self) -> dict:
        """Run every program once against scratch-only page rows and
        all-dead lanes (zero allocator side effects: every write lands
        in the scratch page), which builds the kernels they launch.
        Returns compile_counts()."""
        B, Sp = self.batch_local, self.prefill_local
        P = self.cache.cfg.pages_per_seq
        C = self.cfg.prefill_chunk
        self._decode(np.zeros((B,), np.int32), np.zeros((B,), np.int32),
                     np.zeros((B, P), np.int32), np.zeros((B,), bool))
        if self.cfg.prefill_mode == "batched":
            self._prefill_batch(np.zeros((Sp, P), np.int32),
                                np.zeros((Sp, C), np.int32),
                                np.zeros((Sp,), np.int32),
                                np.zeros((Sp,), np.int32),
                                np.zeros((Sp,), bool))
        else:
            for start in (0, C):
                self._prefill_one(np.zeros((P,), np.int32), False,
                                  np.zeros((C,), np.int32), start, 1)
        if self._sharing:
            W = self._cow_width
            self._cow(np.zeros((W,), np.int32), np.zeros((W,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_counts()

    # -- admission -----------------------------------------------------------

    def _validate(self, req: Request) -> None:
        if req.prompt.shape[0] == 0:
            raise ValueError(f"request {req.id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.id}: max_new_tokens must be >= 1")
        total = req.prompt.shape[0] + req.max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"request {req.id}: prompt ({req.prompt.shape[0]}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_seq_len ({self.cfg.max_seq_len})")
        vocab = self.model.cfg.vocab_size
        p = np.asarray(req.prompt)
        if p.min() < 0 or p.max() >= vocab:
            raise ValueError(
                f"request {req.id}: prompt ids must be in [0, {vocab})")

    def submit(self, req: Request) -> None:
        if req.arrival is None:
            req.arrival = time.monotonic()
        self._validate(req)
        self.queue.append(req)

    def _mark_admitted(self, seq: _Seq) -> None:
        if seq.req.arrival is not None:
            seq.queue_wait_s = time.monotonic() - seq.req.arrival

    def add_token_listener(self, req_id: str, fn) -> None:
        """Register ``fn(token: int, done: bool)`` to fire as each of
        ``req_id``'s tokens is sampled (the HTTP streaming path).
        Dropped when the request completes; listener exceptions are
        logged, never raised into the step loop."""
        self._token_listeners[req_id] = fn

    def remove_token_listener(self, req_id: str) -> None:
        self._token_listeners.pop(req_id, None)

    def _emit_token(self, seq: _Seq, token: int) -> None:
        fn = self._token_listeners.get(seq.req.id)
        if fn is not None:
            try:
                fn(int(token), seq.done)
            except Exception:
                logger.exception("token listener for %r failed; "
                                 "dropping it", seq.req.id)
                self._token_listeners.pop(seq.req.id, None)
        if seq.done:
            self._token_listeners.pop(seq.req.id, None)

    @property
    def in_flight(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def idle(self) -> bool:
        return not self.queue and self.in_flight == 0

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self) -> _Seq | None:
        """Move the head-of-queue request into a free slot. With prefix
        sharing the new sequence attaches the longest resident
        page-aligned prefix of its prompt read-only and prefills only
        the unmatched tail (a full cover prefills nothing); a session
        request whose retained turn matches resumes it. None =
        backpressure — the request stays queued."""
        if not self.queue:
            return None
        req = self.queue[0]
        plen = int(req.prompt.shape[0])
        first = min(plen, self.cfg.prefill_chunk)
        if not self._sharing:
            slot = self._free_slot()
            if slot is None or not self.cache.can_admit(first):
                return None
            self.queue.popleft()
            self.cache.join(req.id)
            self.cache.ensure(req.id, first)
            seq = _Seq(req=req, slot=slot)
            self._mark_admitted(seq)
            self.slots[slot] = seq
            return seq
        if req.session is not None and req.session in self.sessions:
            res = self._try_resume(req)
            if res is not None:
                return None if res == "wait" else res
            # The retained turn diverged from this prompt and was
            # dropped; the prefix index may still cover part of it.
        ps = self.cfg.page_size
        slot = self._free_slot()
        if slot is None:
            return None
        pages, m = self.cache.match_prefix(req.prompt)
        if m * ps >= plen:
            need = 1  # COW headroom for the boundary replay
        elif m:
            tgt = min(plen, m * ps + self.cfg.prefill_chunk)
            need = -(-tgt // ps) - m
        else:
            need = -(-first // ps)
        if need > self.cache.free_pages:
            # Evict idle sessions (LRU) before giving up — retained
            # pages must never wedge admission. Re-match afterwards:
            # the eviction may have freed the pages the match used.
            if not self._evict_sessions(need):
                return None
            pages, m = self.cache.match_prefix(req.prompt)
            if not (m * ps >= plen or m or self.cache.can_admit(first)):
                return None
        self.queue.popleft()
        self.cache.join(req.id)
        seq = _Seq(req=req, slot=slot)
        if m * ps >= plen:
            # Full page-aligned cover: zero prefill — attach at length
            # plen - 1; the first decode replays the last prompt token.
            self.cache.attach(req.id, pages, plen - 1)
            seq.prefilled = plen
            hit = plen
        elif m:
            self.cache.attach(req.id, pages, m * ps)
            self.cache.ensure(
                req.id, min(plen, m * ps + self.cfg.prefill_chunk))
            seq.prefilled = m * ps
            hit = m * ps
        else:
            self.cache.ensure(req.id, first)
            hit = 0
        if hit:
            self.prefix_stats["hit_tokens"] += hit
            self.prefix_stats["saved_tokens"] += hit
            self._step_prefix[0] += hit
            self._step_prefix[1] += hit
        self._mark_admitted(seq)
        self.slots[slot] = seq
        return seq

    # -- prefix sharing / sessions -------------------------------------------

    def _try_resume(self, req: Request):
        """Re-attach a retained session turn. Returns the installed
        ``_Seq``, ``"wait"`` (no free slot), or None (the prompt
        diverged from the retained history, which was just dropped)."""
        key = req.session
        sess = self.sessions[key]
        hist = sess["history"]
        hl = int(hist.shape[0])
        prompt = np.array(req.prompt, np.int32)
        plen = int(prompt.shape[0])
        if hl > plen or not np.array_equal(prompt[:hl], hist):
            self._drop_session(key)
            return None
        slot = self._free_slot()
        if slot is None:
            return "wait"
        self.queue.popleft()
        del self.sessions[key]
        self.cache.rename(sess["cache_id"], req.id)
        # Retained length is hl - 1 (the last generated token's KV was
        # never written). Exact match: zero prefill, decode replays
        # prompt[-1]. Extended: the tail from hl - 1 prefills.
        exact = plen == hl
        seq = _Seq(req=req, slot=slot,
                   prefilled=plen if exact else hl - 1)
        self.slots[slot] = seq
        saved = plen if exact else hl - 1
        self._mark_admitted(seq)
        self.prefix_stats["session_resumes"] += 1
        self.prefix_stats["hit_tokens"] += saved
        self.prefix_stats["saved_tokens"] += saved
        self._step_prefix[0] += saved
        self._step_prefix[1] += saved
        return seq

    def _drop_session(self, key: str) -> None:
        sess = self.sessions.pop(key)
        self.cache.free(sess["cache_id"])

    def _evict_sessions(self, need: int) -> bool:
        """Free retained sessions (LRU first) until ``need`` pages are
        free. Returns True when satisfied."""
        while self.cache.free_pages < need:
            cands = sorted((s["t"], k) for k, s in self.sessions.items())
            if not cands:
                return False
            self._drop_session(cands[0][1])
        return True

    def _cow_guard(self, seq_id) -> list | None:
        """Privatize any shared page the next write into ``seq_id``
        would touch. Returns the (src, dst) pairs ([] = nothing shared)
        or None when the fork stalled on free pages."""
        pairs = self.cache.privatize(seq_id)
        if pairs is None:
            self._evict_sessions(1)
            pairs = self.cache.privatize(seq_id)
        return pairs

    def _apply_cow(self, pairs: list) -> None:
        """One fixed-width page copy for every forked page; unused lanes
        stay (0 -> 0) scratch identities."""
        W = self._cow_width
        src = np.zeros((W,), np.int32)
        dst = np.zeros((W,), np.int32)
        for i, (a, b) in enumerate(pairs):
            src[i], dst[i] = a, b
        self._cow(src, dst)
        self.prefix_stats["cow_pages"] += len(pairs)

    def _register(self, seq: _Seq) -> None:
        """Index the sequence's newly committed page-aligned prefixes.
        Skipped when the pages are about to be freed anyway."""
        if not self._sharing:
            return
        if seq.done and seq.req.session is None:
            return
        if not self.cache.needs_register(seq.req.id):
            return
        self.cache.register_prefix(
            seq.req.id,
            np.concatenate([np.array(seq.req.prompt, np.int32),
                            np.array(seq.generated, np.int32)]))

    # -- step ----------------------------------------------------------------

    def _prefill_candidates(self) -> list[_Seq]:
        return [s for s in self.slots
                if s is not None and not s.prefill_done]

    def _decode_candidates(self) -> list[_Seq]:
        return [s for s in self.slots
                if s is not None and s.prefill_done and not s.done]

    def step(self) -> dict:
        """One scheduling decision + one program launch. Returns a
        record of what ran (``op``: prefill/decode/idle)."""
        t0 = time.monotonic()
        pending = self._prefill_candidates()
        can_admit = bool(self.queue) and self._free_slot() is not None
        want_prefill = bool(pending or can_admit)
        decodable = self._decode_candidates()
        if self.cfg.policy == "prefill":
            kind = "prefill" if want_prefill else (
                "decode" if decodable else "idle")
        else:
            kind = "decode" if decodable else (
                "prefill" if want_prefill else "idle")
        tokens_out = 0
        self._step_prefix = [0, 0]
        syncs0 = self.host_syncs
        if kind == "prefill":
            if self.cfg.prefill_mode == "batched":
                # Admit everything slots+pages allow before the launch.
                while self.queue and self._admit() is not None:
                    pass
                tokens_out = self._run_prefill_batch(
                    self._prefill_candidates())
                if tokens_out == 0:
                    # Backpressure, or every admission was a zero-
                    # prefill attach: decode instead.
                    decodable = self._decode_candidates()
                    kind = "decode" if decodable else "idle"
            else:
                seq = pending[0] if pending else self._admit()
                if seq is not None and seq.prefill_done:
                    # Zero-prefill admission: the slot decodes now.
                    decodable = self._decode_candidates()
                    kind = "decode" if decodable else "idle"
                # Backpressure fallback: when admission or a mid-prompt
                # page allocation fails, decode so pages free up
                # (without it a prefill-priority engine livelocks).
                elif seq is None or not self._run_prefill_chunk(seq):
                    kind = "decode" if decodable else "idle"
        if kind == "decode":
            tokens_out = self._run_decode(decodable)
        dur = time.monotonic() - t0
        rec = {"op": kind, "dur_s": dur, "tokens": tokens_out,
               "in_flight": self.in_flight,
               "queue_depth": len(self.queue),
               **self.cache.occupancy()}
        if self._sharing:
            rec["prefix_hit_tokens"] = self._step_prefix[0]
            rec["prefill_tokens_saved"] = self._step_prefix[1]
            rec["sessions_resident"] = len(self.sessions)
            rec["kv_pages_shared"] = [self.cache.shared_pages()]
        syncs = self.host_syncs - syncs0
        rec["host_syncs"] = syncs
        if tokens_out:
            rec["host_syncs_per_token"] = round(syncs / tokens_out, 6)
        rec["weight_bytes"] = self.weight_bytes
        event("serving", **rec)
        self._step_counter += 1
        if kind != "idle":
            self.launch_count += 1
        return rec

    def _fetch_host(self, *tensors) -> tuple:
        """The designated device->host transfer of the step loop: every
        blocking fetch goes through here, so ``host_syncs`` is exact.
        One call = one sync, however many tensors ride it."""
        self.host_syncs += 1
        return tuple(t.cpu().numpy() for t in tensors)

    def _run_prefill_chunk(self, seq: _Seq) -> bool:
        """One chunk of ``seq``'s prompt (sequential mode). False = no
        progress (the pool could not cover the chunk's pages)."""
        c = self.cfg
        start = seq.prefilled
        n_valid = min(c.prefill_chunk, seq.prompt_len - start)
        if not self.cache.ensure(seq.req.id, start + n_valid):
            return False
        if self._sharing:
            pairs = self._cow_guard(seq.req.id)
            if pairs is None:
                return False  # fork stalled on pages — backpressure
            if pairs:
                self._apply_cow(pairs)
        chunk = np.zeros((c.prefill_chunk,), np.int32)
        chunk[:n_valid] = seq.req.prompt[start:start + n_valid]
        logits = self._prefill_one(self.cache.page_row(seq.req.id), True,
                                   chunk, start, n_valid)
        self.cache.advance(seq.req.id, n_valid)
        seq.prefilled = start + n_valid
        self.prefill_tokens_computed += n_valid
        self.prefill_launches += 1
        if seq.prefill_done:
            (lg,) = self._fetch_host(logits)
            tok = self._sample_host(lg)
            now = time.monotonic()
            seq.first_token_t = now
            seq.token_times.append(now)
            seq.generated.append(tok)
            if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                seq.eos = True
            self._emit_token(seq, tok)
            self._register(seq)
            self._maybe_finish(seq)
            return True
        self._register(seq)
        return True

    def _sample_host(self, logits: np.ndarray) -> int:
        """Sample the sequential prefill's first token from host logits
        (already fetched through ``_fetch_host``)."""
        if self.cfg.temperature <= 0:
            return int(logits.argmax())
        lg = torch.from_numpy(logits)[None]
        return int(_sample(lg, self.cfg.temperature, self.cfg.top_k,
                           self._host_gen)[0])

    def _run_prefill_batch(self, pending: list[_Seq]) -> int:
        """One launch of the batched prefill program over up to
        ``prefill_local`` pending sequences (pages ensured first), then
        read the in-program sample of every lane whose chunk completed
        its prompt. Returns the prompt tokens processed (0 = every
        pending chunk stalled on pages)."""
        c = self.cfg
        Sp, C = self.prefill_local, c.prefill_chunk
        chosen: list[_Seq] = []
        cow: list = []
        for s in pending:
            if len(chosen) >= Sp:
                break
            n = min(C, s.prompt_len - s.prefilled)
            if not self.cache.ensure(s.req.id, s.prefilled + n):
                continue  # this lane stalls; others still launch
            if self._sharing:
                pairs = self._cow_guard(s.req.id)
                if pairs is None:
                    continue  # lane stalls on fork pages
                cow += pairs
            chosen.append(s)
        if not chosen:
            return 0
        if cow:
            self._apply_cow(cow)
        tokens = np.zeros((Sp, C), np.int32)
        start_pos = np.zeros((Sp,), np.int32)
        n_valid = np.zeros((Sp,), np.int32)
        active = np.zeros((Sp,), bool)
        for i, s in enumerate(chosen):
            start = s.prefilled
            n = min(C, s.prompt_len - start)
            tokens[i, :n] = s.req.prompt[start:start + n]
            start_pos[i] = start
            n_valid[i] = n
            active[i] = True
        rows = self.cache.page_rows([s.req.id for s in chosen], width=Sp)
        nxt = self._prefill_batch(rows, tokens, start_pos, n_valid, active)
        self.prefill_launches += 1
        total = 0
        fetched = None
        now = None
        for i, s in enumerate(chosen):
            n = int(n_valid[i])
            self.cache.advance(s.req.id, n)
            s.prefilled += n
            total += n
            if s.prefill_done:
                if fetched is None:
                    # One (Sp,) pull for the whole launch, and only when
                    # some prompt completed; the clock is read after it.
                    (fetched,) = self._fetch_host(nxt)
                    now = time.monotonic()
                tok = int(fetched[i])
                s.first_token_t = now
                s.token_times.append(now)
                s.generated.append(tok)
                if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                    s.eos = True
                self._emit_token(s, tok)
            self._register(s)
            if s.prefill_done:
                self._maybe_finish(s)
        self.prefill_tokens_computed += total
        return total

    def _run_decode(self, decodable: list[_Seq]) -> int:
        B = self.batch_local
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        seq_ids: list = [None] * B
        stepped: list[_Seq] = []
        cow: list = []
        for s in decodable:
            # The new token's KV lands at position length(seq); a full
            # pool stalls the slot this step.
            if not self.cache.ensure(s.req.id,
                                     self.cache.length(s.req.id) + 1):
                continue
            if self._sharing:
                pairs = self._cow_guard(s.req.id)
                if pairs is None:
                    continue  # fork stalled on pages; retry next step
                cow += pairs
            i = s.slot
            tokens[i] = s.last_token
            positions[i] = self.cache.length(s.req.id)
            active[i] = True
            seq_ids[i] = s.req.id
            stepped.append(s)
        if not stepped:
            return 0
        if cow:
            self._apply_cow(cow)
        rows = self.cache.page_rows(seq_ids)
        nxt = self._decode(tokens, positions, rows, active)
        self.decode_launches += 1
        (nxt,) = self._fetch_host(nxt)
        now = time.monotonic()
        for s in stepped:
            self.cache.advance(s.req.id, 1)
            tok = int(nxt[s.slot])
            s.generated.append(tok)
            if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                s.eos = True
            if s.first_token_t is None:
                s.first_token_t = now
            s.token_times.append(now)
            self._emit_token(s, tok)
            self._register(s)
            self._maybe_finish(s)
        return len(stepped)

    def _maybe_finish(self, seq: _Seq) -> None:
        if not seq.done:
            return
        if self._sharing and seq.req.session is not None:
            # Retain the turn's pages under the session key; a stale
            # earlier turn of the same key is superseded.
            key = seq.req.session
            if key in self.sessions:
                self._drop_session(key)
            cid = f"~session:{key}"
            self.cache.rename(seq.req.id, cid)
            self.sessions[key] = {
                "cache_id": cid,
                "history": np.concatenate([
                    np.array(seq.req.prompt, np.int32),
                    np.array(seq.generated, np.int32)]),
                "t": time.monotonic()}
        else:
            self.cache.free(seq.req.id)
        self.slots[seq.slot] = None
        now = time.monotonic()
        arrival = seq.req.arrival if seq.req.arrival is not None \
            else now
        gaps = [b - a for a, b in zip(seq.token_times,
                                      seq.token_times[1:])]
        rec = {
            "id": seq.req.id,
            "tenant": seq.req.tenant,
            "prompt_tokens": seq.prompt_len,
            "new_tokens": len(seq.generated),
            "tokens": list(seq.generated),
            "ttft_s": (seq.first_token_t - arrival
                       if seq.first_token_t is not None else None),
            "queue_wait_s": seq.queue_wait_s,
            "latency_s": now - arrival,
            "token_gaps_s": gaps,
            "group": 0,
        }
        self.completed.append(rec)
        event("serving_request",
              **{k: rec[k] for k in ("id", "tenant", "prompt_tokens",
                                     "new_tokens", "ttft_s",
                                     "queue_wait_s", "latency_s",
                                     "group")})

    # -- convenience ---------------------------------------------------------

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        """Step until queue + slots are empty. Returns steps taken."""
        n = 0
        while not self.idle and n < max_steps:
            self.step()
            n += 1
        if not self.idle:
            raise RuntimeError(
                f"engine not drained after {max_steps} steps "
                f"(queue={len(self.queue)}, in_flight="
                f"{self.in_flight})")
        return n

    def generate(self, prompt: np.ndarray, max_new_tokens: int
                 ) -> list[int]:
        """One prompt through the full continuous-batching path.
        Returns the generated token ids."""
        rid = f"gen-{self._step_counter}-{len(self.completed)}"
        self.submit(Request(id=rid, prompt=np.array(prompt, np.int32),
                            max_new_tokens=max_new_tokens))
        self.run_until_drained()
        rec = next(r for r in reversed(self.completed)
                   if r["id"] == rid)
        return rec["tokens"]

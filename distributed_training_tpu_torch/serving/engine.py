"""Continuous-batching engine over the paged KV cache (port).

The port of ``distributed_training_tpu/serving/engine.py``, on one card
or on a mesh of ``dp x tp`` processes (below). Requests join and leave
the running batch at every step against fixed-shape programs:

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
- **decode**, in one of three forms:
  one token for every decodable slot in one launch (default); each
  layer's attention is the paged-decode kernel on the card.
  ``spec_k > 1`` — speculative: each slot carries its last token and
  ``spec_k - 1`` tokens drafted by prompt lookup over its own history
  (``NgramIndex``), one launch verifies the whole chain (the argmax
  after every position) and the host accepts the longest prefix whose
  drafts match. ``resident_k > 1`` — device-resident: one burst runs
  ``resident_k`` such chain iterations, drafting, verifying, stopping
  and advancing every slot on the device, and the host syncs once per
  burst. On the card the burst is one CUDA graph, captured at warmup
  and replayed (``_ResidentGraph``). The chain's attention is the
  paged-decode kernel at S·C rows (``paged_decode_chain``); greedy
  tokens equal one-token decode's, speculation moves only the number
  of launches.

Pools are written in place (the JAX programs donate them instead).
PyTorch runs eagerly and has no jit cache: ``compile_counts()`` reports,
per program, how many times this process built the CUDA kernels that
program launches; after ``warmup()`` join/evict must never move them
(the port's counterpart of "no recompiles").

Scheduling (``EngineConfig.policy``): ``"prefill"`` runs pending prompt
work before decode (lowest TTFT); ``"decode"`` decodes the active batch
first. Sampling is greedy at ``temperature == 0`` (the parity-tested
path) and per-slot categorical with optional top-k otherwise, drawn
from a ``torch.Generator`` seeded with ``cfg.seed`` (``cfg.seed + g``
for dp group g's slots).

Prefix sharing (refcounted page reuse with copy-on-write) and chat
sessions (a finished turn's pages retained under its session key for a
zero-prefill resume) are on by default, as in the JAX engine.

**On a mesh** (``mesh=``, the port's ``Runtime``; one process per mesh
rank, as the trainer runs) the slot table of ``max_batch`` slots is
dealt into ``G = dp`` groups of ``batch_local`` slots (slots ``g·B …
(g+1)·B − 1`` are group g's), each with its own pool and allocator
(``kv_cache.py``), and admission places a request in the group holding
the longest resident prefix of its prompt, else in the one with the
fewest active slots (ties to the lowest index). Every process runs the
whole host scheduler in lock-step: the queue, every group's slots,
allocator, prefix index and sessions. It builds the JAX engine's
``(G, B_local, …)`` host arrays and launches only its own group's row
of each program (``k_pages[0, i]`` is its group's pool), at its tp
rank's heads: q/k/v column-parallel at ``H/tp`` and ``Hkv/tp`` heads,
the attention's and the MLP's ``wo`` row-parallel ending in an
all-reduce (``bo`` added once, after it), ``wi``/``bi`` column-parallel,
the embedding vocab-parallel, and the head's vocab-split logits
all-gathered over tp before the sample (``parallel/tensor.py``), so
every tp rank picks the same token from the same row. Each device
fetch (``_fetch_host``) is one all-gather over the dp group followed by
one copy to the host, after which every process reads the ``(G, …)``
results, as the JAX engine does.

The contract is SPMD: every process is given the same submissions in
the same order and steps as often. Each step begins with one all-gather
over the whole mesh of a 64-bit digest of the scheduler state (queued
ids, each slot's occupant, pages used per group) and the step number,
before any other collective of the step; a process whose digest differs
makes every process raise ``RuntimeError`` naming the step, instead of
hanging in a later collective or going on with other decisions. No
scheduling decision reads the clock.

**Serving weights and recovery.** Weights may be int8 weight-only
leaves (``serving/disagg.py::quantize_params_int8``), dequantized at
compute one layer at a time (``_w``). The engine computes from tensors
of its own (``Engine.params``: this rank's weights in compute dtype,
one device copy; it keeps no reference to the caller's tree), so
``swap_weights`` republishes a weight set while it serves by copying
the new values into them: the programs and the resident burst's CUDA
graph read the new weights with no recapture.
``drain`` stops admission and runs in-flight work out (or persists it
at a deadline through ``export_in_flight``), ``preempt`` hands back
every request, ``adopt_batch`` takes sequences with their dense KV, and
every emitted token passes an exactly-once gate (``_emit_hwm``) that a
resubmitted or re-adopted request's regenerated prefix never passes
twice; ``resilience/supervisor.py::supervise_serving`` strings these
together across an engine crash. The ``faults`` slot takes a
``resilience/faults.py::FaultInjector`` whose serving kinds fire after
each launch's step record.

On a mesh of more than one process ``export_in_flight`` gathers each
sequence's dense KV from the processes holding its dp group's kv heads
(one all-gather over the mesh, so every process exports the same),
``adopt_batch`` writes each process's own group and heads of the
incoming KV, and a drain's deadline is rank 0's clock, broadcast at
every step so that every process stops at the same one.

What waits for later slices raises ``NotImplementedError`` naming its
ROADMAP.md item: a mesh over other axes than dp and tp, and the
resident burst under tp > 1 on the card over anything but NCCL.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_training_tpu_torch.kernels import build
from distributed_training_tpu_torch.models.transformer import (
    _is_quant_leaf,
    _layer_norm,
    cast_for_compute,
    check_tp_split,
    layer_slice,
    torch_dtype,
)
from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_chunk,
    paged_decode_chain,
)
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.parallel import tensor as tensor_parallel
from distributed_training_tpu_torch.parallel.strategy import (
    get_strategy,
    layout,
)
from distributed_training_tpu_torch.resilience.faults import InjectedCrash
from distributed_training_tpu_torch.runtime import resolve_device
from distributed_training_tpu_torch.serving.disagg import (
    ProvenanceError,
    export_kv_batch,
    import_kv_batch,
    quant_leaves,
)
from distributed_training_tpu_torch.serving.kv_cache import (
    PagedCacheConfig,
    PagedKVCache,
)
from distributed_training_tpu_torch.telemetry import event
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten

logger = logging.getLogger(__name__)

# ROADMAP.md queue A items the deferred features name.
MESH_AXIS_ITEMS = {
    "fsdp": "ROADMAP.md queue A item 17 (the planner's serving layouts)",
    "sp": "ROADMAP.md queue A item 16a's remainder (serving over sp)",
    "pp": ("ROADMAP.md queue A item 16b's remainder (serving over pp: the "
           "JAX engine leaves pp an auto axis of its shard_map)")}
TP_RESIDENT_ITEM = ("ROADMAP.md queue A 'Left from done items': 'the resident "
                    "burst under tp > 1 on cards'")

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

    ``max_batch`` is the aggregate slot count over the dp groups, which
    must deal it into equal group tables; ``num_pages`` is each group's
    pool (scratch page 0 included). ``prefill_slots`` is the aggregate
    lane count of the batched prefill program (0 = same as
    ``max_batch``), dealt like the slots. ``spec_k`` is the tokens per
    decode launch of speculative decode, ``resident_k`` the chain
    iterations of one device-resident burst (each ``spec_k`` wide).
    ``dp_axis`` names the mesh axis the slots and pools are dealt over,
    ``kv_axis`` the one the pools' kv heads (and the programs' heads)
    split over. ``swap_staleness_tokens``: after a weight swap, a
    sequence that has emitted more tokens than this is preempted and
    resubmitted (-1: never)."""

    max_batch: int = 8            # decode slots, aggregate over dp
    page_size: int = 16
    num_pages: int = 128          # per dp group, scratch page 0 included
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
    ngram: NgramIndex | None = None  # lazy prompt-lookup index
    trace: list = field(default_factory=list)  # lifecycle spans
    prefix_hit: int = 0           # prompt tokens served from cache
    # Per-token weight-version tags, run-length encoded as [version,
    # count] pairs in emission order.
    versions: list = field(default_factory=list)

    def span(self, ev: str, t: float, **fields) -> None:
        """Append a lifecycle span at ``t``, a monotonic host time the
        caller already took, stored relative to arrival. A host list
        append only: no device sync, no launch."""
        rel = t - self.req.arrival if self.req.arrival is not None \
            else t
        self.trace.append({"ev": ev, "t": round(rel, 6), **fields})

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


def draft_tokens(history: np.ndarray, m: int,
                 ngram_max: int = 3) -> np.ndarray:
    """Prompt-lookup drafting: ``m`` speculative tokens from the
    sequence's own history (prompt + generated), no second model.

    Finds the most recent earlier occurrence of the history's trailing
    n-gram (longest n <= ngram_max first) and drafts the tokens that
    followed it; short continuations pad with the last token, and a
    history with no repeated n-gram drafts the last token repeated.
    Draft quality moves only the acceptance length, never the output:
    verification emits the argmax chain whatever the drafts."""
    hist = np.array(history, np.int32)
    L = hist.shape[0]
    if m <= 0 or L == 0:
        return np.zeros((max(0, m),), np.int32)
    fill = int(hist[-1])
    for n in range(min(ngram_max, L - 1), 0, -1):
        pat = hist[L - n:]
        # Windows starting strictly before the trailing n-gram itself
        # (an occurrence needs at least one continuation token).
        win = np.lib.stride_tricks.sliding_window_view(hist, n)[:L - n]
        matches = np.nonzero((win == pat).all(axis=1))[0]
        if matches.size:
            p = int(matches[-1])
            cont = hist[p + n:p + n + m]
            if cont.shape[0] < m:
                cont = np.concatenate([
                    cont, np.full((m - cont.shape[0],), fill, np.int32)])
            return cont.astype(np.int32)
    return np.full((m,), fill, np.int32)


class NgramIndex:
    """Incremental trailing-n-gram index behind ``Engine._draft``.

    ``draft_tokens`` rescans the whole history per launch. This keeps,
    per n <= ngram_max, a dict from n-gram to its most recent start and
    a link from each start to the previous start of the same gram,
    updated in O(ngram) per appended token, so a draft is a dict probe.
    Its drafts equal ``draft_tokens``' (held by a randomized test)."""

    def __init__(self, ngram_max: int = 3):
        self.ngram_max = ngram_max
        self.hist: list[int] = []
        # maps[n-1]: gram tuple -> most recent start index;
        # prev[n-1]: start index -> previous start of the same gram.
        self._maps: list[dict] = [{} for _ in range(ngram_max)]
        self._prev: list[dict] = [{} for _ in range(ngram_max)]

    def __len__(self) -> int:
        return len(self.hist)

    def extend(self, tokens) -> None:
        for t in tokens:
            self.append(int(t))

    def append(self, t: int) -> None:
        self.hist.append(int(t))
        L = len(self.hist)
        for n in range(1, self.ngram_max + 1):
            if L < n:
                break
            start = L - n
            gram = tuple(self.hist[start:])
            m = self._maps[n - 1]
            if gram in m:
                self._prev[n - 1][start] = m[gram]
            m[gram] = start

    def draft(self, m: int) -> np.ndarray:
        """``m`` drafted tokens, equal to ``draft_tokens(hist, m,
        ngram_max)``."""
        L = len(self.hist)
        if m <= 0 or L == 0:
            return np.zeros((max(0, m),), np.int32)
        fill = self.hist[-1]
        for n in range(min(self.ngram_max, L - 1), 0, -1):
            p = self._maps[n - 1].get(tuple(self.hist[L - n:]))
            if p == L - n:
                # The trailing gram itself needs a continuation token:
                # step to the previous start (draft_tokens' windows stop
                # at L - n).
                p = self._prev[n - 1].get(p)
            if p is None:
                continue
            cont = self.hist[p + n:p + n + m]
            return np.array(cont + [fill] * (m - len(cont)), np.int32)
        return np.full((m,), fill, np.int32)


# ---------------------------------------------------------------------------
# Programs: plain functions over device tensors. Pools arrive as this
# process's (1, L, Hkv, N, ps, hd) block and are written in place; the
# weights are this process's tp blocks. ``tp`` (a ``TPGroup``, None off a
# tensor-parallel mesh) runs the block's collectives: 2L + 1 all-reduces
# (the lookup, each layer's two row-parallel outputs) and one all-gather
# of the logits a forward, as ``parallel/tensor.py`` counts them.
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


def _embed(params: dict, tokens: torch.Tensor, tp) -> torch.Tensor:
    """Token embeddings: the lookup, vocab-parallel under tp."""
    table = params["tok_embed"]
    return table[tokens] if tp is None else tp.embed(table, tokens)


def _reduce(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel product's output summed over tp."""
    return y if tp is None else tp.reduce(y)


def _logits(x: torch.Tensor, params: dict, cfg, tp) -> torch.Tensor:
    """Final hidden states (already normed) → f32 logits over the whole
    vocab: under tp each rank's vocab columns, gathered."""
    lg = x @ _head(params, cfg)
    return (lg if tp is None else tp.gather(lg)).float()


def _w(leaf) -> torch.Tensor:
    """A weight leaf in compute dtype: an int8 weight-only leaf
    (``{"qw", "scale"}``) dequantized here as ``qw * scale``, one
    launch: the scale was cast to the compute dtype once
    (``_own_compute``), and the int8 operand is promoted to it exactly
    (|qw| <= 127), so the product has the bits of JAX's per-use
    ``qw.astype(dt) * scale.astype(dt)``. Any other leaf is already in
    compute dtype. Every weight product of the programs reads its
    operand through this one helper, one layer at a time, so the device
    holds int8 and scales plus one layer's dequantized transient, never
    a whole dequantized copy."""
    if isinstance(leaf, dict):
        return leaf["qw"] * leaf["scale"]
    return leaf


def _mlp(x: torch.Tensor, layer: dict, tp=None) -> torch.Tensor:
    h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
    m = {n: _w(w) for n, w in layer["mlp"].items()}
    u = F.gelu(h @ m["wi"] + m["bi"], approximate="tanh")
    if tp is None:
        return x + (u @ m["wo"] + m["bo"])
    # bo is whole on every rank: added once, after the sum.
    return x + (tp.reduce(u @ m["wo"]) + m["bo"])


@torch.no_grad()
def _decode_program(params, k_pages, v_pages, tokens, positions,
                    page_tables, active, gen, *, cfg, temperature,
                    top_k, paged_impl, tp=None) -> torch.Tensor:
    """One token for every slot of the table.

    ``params`` in compute dtype (``cast_for_compute``); tokens (B,) —
    last sampled token per slot; positions (B,) — the absolute position
    that token occupies (== kv entries already written); page_tables
    (B, P) int32; active (B,) bool. Returns next tokens (B,); inactive
    slots write into the scratch page and return 0."""
    ps, P = k_pages.shape[4], page_tables.shape[1]
    x = _embed(params, tokens, tp)                       # (B, D)
    if cfg.pos_encoding == "learned":
        x = x + params["pos_embed"][positions]
    logical = torch.clamp(positions // ps, max=P - 1)
    page_ids = torch.where(
        active, page_tables.gather(1, logical[:, None])[:, 0], 0)
    offsets = torch.where(active, positions % ps, 0)
    lengths = torch.where(active, positions + 1, 0).int()
    for i in range(cfg.n_layers):
        layer = layer_slice(params, i)
        a = {n: _w(w) for n, w in layer["attn"].items()}
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
        x = x + _reduce(torch.einsum("bhk,hkd->bd", attn, a["wo"]), tp)
        x = _mlp(x, layer, tp)
    x = _layer_norm(x, params["final_norm"]["scale"],
                    params["final_norm"]["bias"])
    logits = _logits(x, params, cfg, tp)
    return torch.where(active, _sample(logits, temperature, top_k, gen), 0)


@torch.no_grad()
def _prefill_program(params, k_pages, v_pages, page_row, live,
                     chunk_tokens, start_pos, n_valid, *, cfg,
                     first, tp=None) -> torch.Tensor:
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
    x = _embed(params, chunk_tokens, tp)                 # (C, D)
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
        a = {n: _w(w) for n, w in layer["attn"].items()}
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
        x = x + _reduce(torch.einsum("chk,hkd->cd", attn, a["wo"]), tp)
        x = _mlp(x, layer, tp)
    x_last = x[max(int(n_valid) - 1, 0)]
    x_last = _layer_norm(x_last, params["final_norm"]["scale"],
                         params["final_norm"]["bias"])
    return _logits(x_last, params, cfg, tp)


def _chunk_hidden(params, k_pages, v_pages, page_rows, tokens, start_pos,
                  n_valid, active, *, cfg, chain, paged_impl="auto",
                  tp=None):
    """The multi-lane chunk forward shared by batched prefill, spec
    verification and every resident iteration, so none of them can
    drift from the others.

    page_rows (S, P) int32; tokens (S, C) (positions >= n_valid[s] are
    padding); start_pos (S,) — each lane's first absolute position;
    n_valid (S,); active (S,) bool — dead lanes write into the scratch
    page and their queries mask out. Every lane's valid tokens' KV goes
    through one batched scatter per layer, then each query attends its
    own pages at positions <= its own: through the paged chunk form
    (``chain=False``, batched prefill), or through single-token decode
    at S·C rows (``chain=True``, ``paged_decode_chain``: the kernel on
    the card). Returns ``(x (S, C, D) final hidden states, valid (S,
    C))``."""
    S, C = tokens.shape
    ps, P = k_pages.shape[4], page_rows.shape[1]
    idx = torch.arange(C, device=tokens.device)
    abs_pos = start_pos[:, None] + idx[None, :]          # (S, C)
    valid = (idx[None, :] < n_valid[:, None]) & active[:, None]
    x = _embed(params, tokens, tp)                       # (S, C, D)
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
        a = {n: _w(w) for n, w in layer["attn"].items()}
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
        if chain:
            attn = paged_decode_chain(q, kp, vp, page_rows, q_pos,
                                      impl=paged_impl)
        else:
            attn = paged_attention_chunk(q, kp, vp, page_rows, q_pos)
        x = x + _reduce(torch.einsum("schk,hkd->scd", attn, a["wo"]), tp)
        x = _mlp(x, layer, tp)
    return x, valid


def _argmax_chain(params, x, valid, cfg, tp=None) -> torch.Tensor:
    """The verification chain over chunk hidden states: the argmax after
    every position (position c's argmax is the verified next token given
    tokens[:c+1]), greedy only by the spec/resident config contract.
    Invalid positions give 0."""
    xs = _layer_norm(x, params["final_norm"]["scale"],
                     params["final_norm"]["bias"])
    logits = _logits(xs, params, cfg, tp)
    return torch.where(valid, torch.argmax(logits, dim=-1), 0)


@torch.no_grad()
def _chunk_program(params, k_pages, v_pages, page_rows, tokens,
                   start_pos, n_valid, active, gen, *, cfg, temperature,
                   top_k, emit="last", paged_impl="auto",
                   tp=None) -> torch.Tensor:
    """Multi-token chunks for a whole lane table: batched prefill
    (``emit="last"``, S = prefill lanes, C = prefill_chunk) and
    speculative decode (``emit="all"``, S = decode slots, C = spec_k).
    Arguments as ``_chunk_hidden``'s.

    - ``emit="last"``: the token sampled after each lane's last valid
      position, (S,); the paged chunk form attends.
    - ``emit="all"``: the argmax after every position, (S, C)
      (``_argmax_chain``); the chain attends through single-token
      decode. The host accepts the longest prefix whose drafts match.

    Inactive lanes give 0."""
    S = tokens.shape[0]
    x, valid = _chunk_hidden(params, k_pages, v_pages, page_rows, tokens,
                             start_pos, n_valid, active, cfg=cfg,
                             chain=emit == "all", paged_impl=paged_impl,
                             tp=tp)
    if emit == "all":
        return _argmax_chain(params, x, valid, cfg, tp)
    last = torch.clamp(n_valid - 1, min=0)
    x_last = x[torch.arange(S, device=x.device), last]   # (S, D)
    x_last = _layer_norm(x_last, params["final_norm"]["scale"],
                         params["final_norm"]["bias"])
    logits = _logits(x_last, params, cfg, tp)
    return torch.where(active, _sample(logits, temperature, top_k, gen), 0)


def _draft_cols(hist, hlen, last, C: int, ngram: int) -> torch.Tensor:
    """Prompt-lookup drafts (B, C-1) on the device: for each slot the
    longest trailing n-gram (n <= ngram) with an earlier occurrence in
    ``hist[:hlen]`` proposes its continuation; slots with no match
    repeat ``last``. Vectorised over every window at once (ascending n,
    so the longest match overwrites)."""
    B, Lmax = hist.shape
    dev = hist.device
    pos = torch.arange(Lmax, device=dev)
    draft = last[:, None].expand(B, C - 1)
    for n in range(1, ngram + 1):
        off = torch.arange(n, device=dev)
        pat = hist.gather(1, torch.clamp(hlen[:, None] - n + off[None, :],
                                         0, Lmax - 1))           # (B, n)
        win = hist[:, torch.clamp(pos[:, None] + off[None, :],
                                  max=Lmax - 1)]                 # (B, Lmax, n)
        match = (win == pat[:, None, :]).all(-1)
        # Earlier occurrences only: the window's continuation must land
        # inside the history, which also excludes the trailing gram.
        ok = match & ((pos[None, :] + n) < hlen[:, None])
        has = ok.any(dim=1) & (hlen > n)
        p = torch.where(ok, pos[None, :], -1).amax(dim=1)
        cont_idx = (p[:, None] + n
                    + torch.arange(C - 1, device=dev)[None, :])
        cont = hist.gather(1, torch.clamp(cont_idx, 0, Lmax - 1))
        cont = torch.where(cont_idx < hlen[:, None], cont, last[:, None])
        draft = torch.where(has[:, None], cont, draft)
    return draft


@torch.no_grad()
def _resident_program(params, k_pages, v_pages, page_rows, history, kv_len,
                      budget, active, *, cfg, K, C, ngram, eos_id,
                      paged_impl="auto", tp=None) -> tuple:
    """Device-resident K-step decode for the slot table (JAX
    ``_resident_program``), a function of static-shape tensors.

    Each of the ``K`` iterations is one ``C``-wide speculative chain
    through ``_chunk_hidden`` + ``_argmax_chain``, the same forward as
    the host-driven spec path: every running slot drafts from its own
    history, verifies the chain, truncates at EOS, appends the accepted
    tokens to its history row and advances its KV cursor, all on the
    device. JAX's ``while_loop`` exits once every slot has stopped; this
    body unrolls all ``K`` iterations (a CUDA graph has no early exit):
    a stopped slot is a dead lane that writes only the scratch page and
    masks its queries, and ``steps`` counts on the device the iterations
    in which any slot was running, which is JAX's loop count. No value
    is read on the host, so the body can be captured.

    page_rows (B, P) int32; history (B, Lmax) — prompt + generated so
    far, ``history[kv_len]`` the last generated token (its KV not yet
    written); kv_len (B,) — committed KV length; budget (B,) — the most
    tokens this burst may emit per slot (sized by the host against page
    capacity: ``kvl + bud`` is invariant, so no write lands past
    ``kv_len + budget - 1``); active (B,) bool. Returns ``(out (B, K*C)
    emitted tokens, n_emitted (B,), steps ())``."""
    B, Lmax = history.shape
    T = K * C
    dev = history.device
    pos = torch.arange(Lmax, device=dev)
    cl = torch.arange(C, device=dev)
    tl = torch.arange(T, device=dev)
    out = torch.zeros((B, T), dtype=torch.long, device=dev)
    n_em = torch.zeros((B,), dtype=torch.long, device=dev)
    steps = torch.zeros((), dtype=torch.long, device=dev)
    # Out-of-place updates only: the arguments are a graph's static
    # inputs and must hold the burst's inputs through a replay.
    hist, kvl, bud = history.long(), kv_len.long(), budget.long()
    running = active & (bud > 0)
    for _ in range(K):
        steps = steps + running.any()
        n = torch.where(running, torch.clamp(bud, max=C), 0)
        # A stopped slot's cursor may sit at Lmax; its lane is dead.
        last = hist.gather(1, torch.clamp(kvl, max=Lmax - 1)[:, None])[:, 0]
        if C > 1:
            tokens = torch.cat(
                [last[:, None], _draft_cols(hist, kvl + 1, last, C, ngram)],
                dim=1)
        else:
            tokens = last[:, None]
        x, valid = _chunk_hidden(params, k_pages, v_pages, page_rows,
                                 tokens, kvl, n, running, cfg=cfg,
                                 chain=True, paged_impl=paged_impl, tp=tp)
        nxt = _argmax_chain(params, x, valid, cfg, tp)   # (B, C)
        if C > 1:
            match = ((tokens[:, 1:] == nxt[:, :-1])
                     & (cl[None, :-1] < (n - 1)[:, None]))
            e = 1 + torch.cumprod(match.long(), dim=1).sum(dim=1)
        else:
            e = torch.ones_like(n)
        e = torch.where(n > 0, e, 0)
        if eos_id >= 0:
            is_eos = (nxt == eos_id) & (cl[None, :] < e[:, None])
            any_eos = is_eos.any(dim=1)
            e = torch.where(any_eos, torch.argmax(is_eos.long(), dim=1) + 1,
                            e)
        else:
            any_eos = torch.zeros_like(running)
        # This iteration's accepted tokens go into the output block at
        # each slot's emission cursor, and into the history row right
        # after its current last token.
        rel = tl[None, :] - n_em[:, None]
        sel = (rel >= 0) & (rel < e[:, None])
        out = torch.where(sel, nxt.gather(1, torch.clamp(rel, 0, C - 1)),
                          out)
        hrel = pos[None, :] - (kvl + 1)[:, None]
        hsel = (hrel >= 0) & (hrel < e[:, None])
        hist = torch.where(hsel, nxt.gather(1, torch.clamp(hrel, 0, C - 1)),
                           hist)
        n_em = n_em + e
        kvl = kvl + e
        bud = bud - e
        running = running & (bud > 0) & ~any_eos
    return out, n_em, steps


# The counters besides ``paged_attention.launches`` that the resident
# burst's launches tick (``_ResidentGraph`` replays their capture deltas).
_BURST_COUNTERS = (paged_attention.launches_by_design,
                   tensor_parallel.ALL_REDUCES, tensor_parallel.ALL_GATHERS)


class _ResidentGraph:
    """The resident burst as one CUDA graph, the port's counterpart of
    the JAX engine's single jitted program.

    Owns the burst's static inputs (``page_rows`` (B, P) int32,
    ``history`` (B, Lmax), ``kv_len``, ``budget``, ``active``) and, once
    captured, its static outputs (``out`` (B, K*C), ``n_emitted``,
    ``steps``). ``warmup()`` runs the body once eagerly on a side stream
    (the paged-decode entry's one-time ``cudaFuncSetAttribute`` and the
    allocator's first blocks happen there, outside the capture), then
    captures it once with ``torch.cuda.graph``; the pools and the
    compute-dtype weights keep their addresses for the engine's life.
    ``run()`` copies a burst's host arrays into the static inputs and
    replays. On the CPU, where the caller asked for it, the same body
    runs eagerly. On the card nothing falls back: a capture or a replay
    that fails raises."""

    def __init__(self, body, k_pages, v_pages, B: int, P: int, Lmax: int,
                 device: torch.device):
        self._body = body
        self._pools = (k_pages, v_pages)
        self.device = device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.inputs = (z((B, P), torch.int32), z((B, Lmax), torch.long),
                       z((B,), torch.long), z((B,), torch.long),
                       z((B,), torch.bool))
        self.graph = None
        self.outputs = None
        self.captures = 0
        self._launches = (0, [{} for _ in _BURST_COUNTERS])

    def eager(self, k_pages, v_pages) -> tuple:
        """The body on the current static inputs, not captured (the CPU
        path, the warmup, and the replay check's reference)."""
        return self._body(k_pages, v_pages, *self.inputs)

    def warmup(self) -> None:
        if self.device.type != "cuda":
            self.eager(*self._pools)
            return
        if self.graph is not None:
            return
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.eager(*self._pools)
        stream.wait_stream(side)
        # Python launch and collective counters tick only while the
        # capture records the launches, never on replay: keep the
        # capture's deltas and add them on every replay (every replay
        # runs all K iterations, so the count is exact).
        n0 = paged_attention.launches
        c0 = [dict(c) for c in _BURST_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.outputs = self.eager(*self._pools)
        self._launches = (
            paged_attention.launches - n0,
            [{k: n - d0.get(k, 0) for k, n in c.items()}
             for c, d0 in zip(_BURST_COUNTERS, c0)])
        paged_attention.launches = n0
        for c, d0 in zip(_BURST_COUNTERS, c0):
            c.clear()
            c.update(d0)
        self.graph = graph
        self.captures += 1

    def run(self, *arrays: np.ndarray) -> tuple:
        """One burst: ``(page_rows, history, kv_len, budget, active)``
        host arrays in, ``(out, n_emitted, steps)`` device tensors out
        (on the card, the graph's static outputs: read them before the
        next burst)."""
        if self.device.type == "cuda":
            # Captures on first use if warmup() was not called, while
            # the static inputs still hold an all-dead burst.
            self.warmup()
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        if self.device.type != "cuda":
            return self.eager(*self._pools)
        self.graph.replay()
        n, deltas = self._launches
        paged_attention.launches += n
        for c, delta in zip(_BURST_COUNTERS, deltas):
            for k, d in delta.items():
                c[k] += d
        return self.outputs


@torch.no_grad()
def _cow_program(k_pages, v_pages, src, dst) -> None:
    """Copy-on-write page copy in place: ``src``/``dst`` (W,) page ids,
    one gather + scatter per pool for all W copies. Unused lanes ride as
    (0 -> 0), a scratch-to-scratch identity copy."""
    for pages in (k_pages, v_pages):
        g = pages[0]                                     # (L, Hkv, N, ...)
        g[:, :, dst] = g[:, :, src]


def _check_weight_leaves(tree, device: torch.device, path: str = "") -> int:
    """Validate the weight pytree: tensors on ``device``, an int8
    weight-only leaf an int8 ``qw`` and an f32 ``scale``. Returns the
    byte count (an int8 leaf's ``qw`` and ``scale`` bytes, as
    ``quantized_weight_bytes(...)["int8"]`` counts them)."""
    if _is_quant_leaf(tree):
        if set(tree) != {"qw", "scale"} or \
                tree["qw"].dtype != torch.int8 or \
                tree["scale"].dtype != torch.float32:
            raise TypeError(f"int8 weight leaf at '{path}' must be "
                            "{'qw': int8, 'scale': float32}")
    if isinstance(tree, dict):
        return sum(_check_weight_leaves(v, device, f"{path}/{k}")
                   for k, v in tree.items())
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"weight leaf at '{path}' is {type(tree)}")
    if tree.device != device:
        raise ValueError(f"weight leaf at '{path}' is on {tree.device}, "
                         f"the engine runs on {device}")
    return tree.numel() * tree.element_size()


def _leaf_specs(params: dict) -> dict:
    """``{"a/b": (shape, dtype)}`` of every tensor of a weight tree, an
    int8 leaf's ``qw`` and ``scale`` each their own entry: the structure
    ``swap_weights`` holds a publish to."""
    return {k: (tuple(t.shape), t.dtype) for k, t in flatten(params).items()}


def _own_compute(params: dict, cfg) -> dict:
    """The weights in compute dtype (``cast_for_compute``, and an int8
    leaf's ``scale`` too) in storage of the engine's own: a leaf the cast
    would hand back as the caller's tensor (same dtype, an int8 ``qw``,
    a norm) is cloned, so that ``swap_weights`` can copy a publish into
    these in place without writing into the caller's weights, and the
    engine keeps no reference to the caller's tree: one device copy."""
    dt = torch_dtype(cfg.dtype)
    cast = cast_for_compute(params, cfg)
    for grp in ("attn", "mlp"):
        cast[grp] = {n: ({"qw": w["qw"], "scale": w["scale"].to(dt)}
                         if _is_quant_leaf(w) else w)
                     for n, w in cast[grp].items()}
    theirs = {t.untyped_storage().data_ptr()
              for t in flatten(params).values()}
    return unflatten({
        k: t.clone() if t.untyped_storage().data_ptr() in theirs else t
        for k, t in flatten(cast).items()})


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(world of ``group``, *x.shape): every process's ``x``, in rank
    order (the list form, which gloo takes for CUDA tensors too)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _mesh_extents(mesh, cfg: EngineConfig) -> tuple[int, int]:
    """(dp groups, tp) of ``mesh`` (a ``Runtime``; (1, 1) without one).
    The engine deals its slots over ``cfg.dp_axis`` = ``dp`` and splits
    heads over ``cfg.kv_axis`` = ``tp``; any other axis above 1 raises
    naming its ROADMAP.md item."""
    if mesh is None:
        return 1, 1
    sizes = mesh.spec.as_dict()
    for axis, n in sizes.items():
        if n > 1 and not (axis == "dp" == cfg.dp_axis
                          or axis == "tp" == cfg.kv_axis):
            raise NotImplementedError(
                f"serving over mesh axis '{axis}'={n} (dp_axis="
                f"'{cfg.dp_axis}', kv_axis='{cfg.kv_axis}') waits for "
                f"{MESH_AXIS_ITEMS.get(axis, MESH_AXIS_ITEMS['fsdp'])}")
    return sizes["dp"], sizes["tp"]


def _rank_params(params: dict, model, mesh, tp: int) -> dict:
    """This process's blocks of the whole weights ``params``: under tp >
    1 each leaf cut by the trainer's ``TensorParallel`` placements (query
    and kv heads, MLP columns and rows, vocab rows of the embedding and
    columns of the head; norms, ``bo`` and positions whole), else the
    weights themselves. An int8 leaf's ``qw`` is cut like its weight and
    its ``scale`` only on the dims where it is larger than 1 (the JAX
    ``plan_shardings`` rule): column-parallel scales split with their
    heads or columns, row-parallel ``wo`` scales stay whole."""
    if tp == 1:
        return params
    lay = layout(get_strategy("tp", mesh.spec),
                 flatten(model.param_shapes()), flatten(model.logical_axes()))
    out = {}
    for k, leaf in quant_leaves(params).items():
        pl = lay["params"][k]
        if not _is_quant_leaf(leaf):
            out[k] = fsdp.shard(leaf, pl, mesh)
            continue
        scale = leaf["scale"]
        spl = pl and pl._replace(splits=tuple(
            (d, axes) for d, axes in pl.splits if scale.shape[d] > 1))
        out[k] = {"qw": fsdp.shard(leaf["qw"], pl, mesh),
                  "scale": fsdp.shard(scale, spl or None, mesh)}
    return unflatten(out)


class Engine:
    """The continuous-batching engine over one model + weight set.

    ``model`` is the port's ``Transformer``; ``params`` its whole weight
    pytree (int8 weight-only leaves allowed), already on ``device``; the
    engine copies what it needs (``self.params``) and keeps no reference
    to it, so the caller may free it. ``device=None`` runs on the CUDA
    card and raises without one.
    ``mesh``: a ``Runtime`` over ``dp x tp`` processes, each running one
    engine given the same submissions (and the same ``swap_weights``,
    ``preempt`` and ``drain`` calls); this one keeps its tp rank's
    blocks of the weights and its dp group's pool (module docstring).
    ``weights_provenance``: the plan stamp (``{"name", "fingerprint"}``)
    every later publish must carry. Every step emits a ``serving``
    telemetry record through the ambient sink."""

    def __init__(self, model, params, cfg: EngineConfig, mesh=None,
                 weights_version: str = "v0", device=None,
                 weights_provenance: dict | None = None):
        if getattr(model.cfg, "moe_num_experts", 0) > 0:
            raise ValueError("serving engine has no MoE decode path")
        if cfg.max_seq_len > model.cfg.max_seq_len:
            raise ValueError(
                f"engine max_seq_len ({cfg.max_seq_len}) exceeds the "
                f"model's ({model.cfg.max_seq_len})")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.dp_groups, tp = _mesh_extents(mesh, cfg)
        G = self.dp_groups
        if cfg.max_batch % G:
            raise ValueError(
                f"max_batch ({cfg.max_batch}) must divide over the "
                f"{G} dp group(s) — the slot table is dealt into equal "
                "group-local tables")
        self.batch_local = cfg.max_batch // G
        prefill_slots = cfg.prefill_slots or cfg.max_batch
        if prefill_slots % G:
            raise ValueError(
                f"prefill_slots ({prefill_slots}) must divide over the "
                f"{G} dp group(s) — the prefill lane table deals exactly "
                "like the decode table")
        self.prefill_local = prefill_slots // G
        # This process's groups on a mesh of more than one: every process
        # (the step's digest), its dp group (each fetch) and its tp group
        # (the programs' collectives).
        self._mesh_group = self._dp_group = self._tp = None
        if mesh is not None and mesh.process_count > 1:
            self._mesh_group = mesh.group(("dp", "tp"))
            if G > 1:
                self._dp_group = mesh.group(("dp",))
            if tp > 1:
                check_tp_split(model.cfg, tp)
                self._tp = tensor_parallel.TPGroup(mesh.group(("tp",)))
        self.cache = PagedKVCache(
            PagedCacheConfig(
                n_layers=model.cfg.n_layers,
                n_kv_heads=model.cfg.n_kv_heads,
                head_dim=model.cfg.head_dim,
                page_size=cfg.page_size,
                num_pages=cfg.num_pages,
                max_seq_len=cfg.max_seq_len,
                dtype=model.cfg.dtype,
                dp_groups=G),
            device=self.device, mesh=mesh, kv_axis=cfg.kv_axis,
            dp_axis=cfg.dp_axis)
        # The dp group whose row of every program this process launches.
        self._g = self.cache.local_group or 0
        _check_weight_leaves(params, self.device)
        self._specs = _leaf_specs(params)
        self._tp_size = tp
        rank = _rank_params(params, model, mesh, tp)
        # Bytes of this rank's weights as given (an int8 leaf's qw and
        # f32 scale): the JAX engine's count.
        self.weight_bytes = _check_weight_leaves(rank, self.device)
        # This rank's weights in compute dtype, cast once (the JAX
        # programs cast at each use; int8 leaves are dequantized at each
        # use), in storage of the engine's own that ``swap_weights``
        # copies into: the engine's one device copy.
        self.params = _own_compute(rank, model.cfg)
        del rank
        self.weights_version = weights_version
        self.weights_provenance = (dict(weights_provenance)
                                   if weights_provenance else None)
        self.swap_stats = {"installed": 0, "refused": 0,
                           "stale_preempted": 0}
        self._sharing = cfg.prefix_sharing
        self.sessions: dict[str, dict] = {}
        # Orders retained sessions for LRU eviction (a count, not the
        # clock: every process of a mesh must evict alike).
        self._session_clock = 0
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
        # ``_fetch_host``, so this count is exact. ``gathers`` counts
        # the engine's own collectives on a mesh: ``dp_fetch`` (one per
        # fetch, over the dp group), ``lockstep`` (one per step, over
        # the mesh), ``kv_export`` (one per export of dense KV) and
        # ``deadline`` (one per step of a drain with a deadline); the
        # programs' tp collectives are ``parallel/tensor.py``'s.
        self.host_syncs = 0
        self.gathers: collections.Counter = collections.Counter()
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[_Seq | None] = [None] * cfg.max_batch
        self.completed: list[dict] = []
        self._step_counter = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed + self._g)
        self._host_gen = torch.Generator()
        self._host_gen.manual_seed(cfg.seed + 1_000_000)
        self._token_listeners: dict[str, object] = {}
        # Exactly-once stream state: per request, the count of tokens
        # already delivered. It survives preemption and export (unlike
        # the listeners), so a resubmitted or re-adopted request's
        # regenerated prefix is never delivered twice; popped at
        # completion. ``finished_total`` is the progress count the
        # serving supervisor's restart budget refunds against.
        self._emit_hwm: dict[str, int] = {}
        self.finished_total = 0
        # ``draining`` gates admission only; ``launch_count`` (one per
        # non-idle step) is what the ``faults`` injector's serving kinds
        # key on (None: no injection).
        self.draining = False
        self.launch_count = 0
        self.faults = None
        # Speculative-decode accounting: per slot-launch totals, and the
        # last step's (slot launches, emitted) for the step record.
        self.spec_stats = {"launches": 0, "emitted": 0}
        self._step_spec: tuple[int, int] | None = None
        self._last_prefill_lanes: list[int] | None = None
        # Device-resident accounting: bursts, chain iterations run on
        # the device, tokens emitted; the last burst's mean iterations
        # over the groups that ran.
        self.resident_stats = {"launches": 0, "steps": 0, "emitted": 0}
        self._step_resident: float | None = None
        self._resident = None
        if cfg.resident_k > 1:
            if (self._tp is not None and self.device.type == "cuda"
                    and dist.get_backend(self._tp.group) != "nccl"):
                raise NotImplementedError(
                    "the resident burst under tp > 1 on the card is a CUDA "
                    "graph, which cannot capture "
                    f"{dist.get_backend(self._tp.group)}'s collectives: it "
                    f"waits for {TP_RESIDENT_ITEM}")
            self._resident = _ResidentGraph(
                functools.partial(
                    _resident_program, self.params, cfg=model.cfg,
                    K=cfg.resident_k, C=cfg.spec_k, ngram=cfg.spec_ngram,
                    eos_id=cfg.eos_id, paged_impl=cfg.paged_impl,
                    tp=self._tp),
                self.cache.k_pages, self.cache.v_pages, self.batch_local,
                self.cache.cfg.pages_per_seq, cfg.max_seq_len, self.device)

    # -- programs ------------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode(self, tokens, positions, rows, active) -> torch.Tensor:
        c = self.cfg
        return _decode_program(
            self.params, self.cache.k_pages, self.cache.v_pages,
            self._t(tokens).long(), self._t(positions).long(),
            self._t(rows), self._t(active), self._gen,
            cfg=self.model.cfg, temperature=c.temperature, top_k=c.top_k,
            paged_impl=c.paged_impl, tp=self._tp)

    def _chunk(self, rows, tokens, start_pos, n_valid, active,
               emit: str) -> torch.Tensor:
        """Batched prefill (``emit="last"``) or spec verification
        (``emit="all"``)."""
        c = self.cfg
        return _chunk_program(
            self.params, self.cache.k_pages, self.cache.v_pages,
            self._t(rows), self._t(tokens).long(),
            self._t(start_pos).long(), self._t(n_valid).long(),
            self._t(active), self._gen, cfg=self.model.cfg,
            temperature=c.temperature, top_k=c.top_k, emit=emit,
            paged_impl=c.paged_impl, tp=self._tp)

    def _prefill_one(self, row, live: bool, chunk, start: int,
                     n_valid: int) -> torch.Tensor:
        return _prefill_program(
            self.params, self.cache.k_pages, self.cache.v_pages,
            self._t(row), live, self._t(chunk).long(), start, n_valid,
            cfg=self.model.cfg, first=start == 0, tp=self._tp)

    def _cow(self, src: np.ndarray, dst: np.ndarray) -> None:
        _cow_program(self.cache.k_pages, self.cache.v_pages,
                     self._t(src).long(), self._t(dst).long())

    def compile_counts(self) -> dict:
        """Per program, the builds of the CUDA kernels it launches that
        this process ran; with ``resident_k > 1``, ``decode_graph`` counts
        the captures of the resident burst's CUDA graph (one, at warmup,
        on the card; none on the CPU). ``warmup()`` builds and captures
        what the programs need; join/evict must never move these counts
        afterwards."""
        names = ["decode"]
        names += (["prefill_batch"] if self.cfg.prefill_mode == "batched"
                  else ["prefill_first", "prefill_cont"])
        if self._sharing:
            names.append("cow")
        counts = {n: sum(build.build_count(k) for k in _PROGRAM_KERNELS[n])
                  for n in names}
        if self._resident is not None:
            counts["decode_graph"] = self._resident.captures
        return counts

    def warmup(self) -> dict:
        """Run every program once against scratch-only page rows and
        all-dead lanes (zero allocator side effects: every write lands
        in the scratch page), which builds the kernels they launch, and
        capture the resident burst's graph. Returns compile_counts()."""
        B, Sp = self.batch_local, self.prefill_local
        P = self.cache.cfg.pages_per_seq
        C = self.cfg.prefill_chunk
        if self._resident is not None:
            self._resident.warmup()
        elif self.cfg.spec_k > 1:
            K = self.cfg.spec_k
            self._chunk(np.zeros((B, P), np.int32),
                        np.zeros((B, K), np.int32), np.zeros((B,), np.int32),
                        np.zeros((B,), np.int32), np.zeros((B,), bool),
                        emit="all")
        else:
            self._decode(np.zeros((B,), np.int32), np.zeros((B,), np.int32),
                         np.zeros((B, P), np.int32), np.zeros((B,), bool))
        if self.cfg.prefill_mode == "batched":
            self._chunk(np.zeros((Sp, P), np.int32),
                        np.zeros((Sp, C), np.int32), np.zeros((Sp,), np.int32),
                        np.zeros((Sp,), np.int32), np.zeros((Sp,), bool),
                        emit="last")
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

    # -- request-lifecycle tracing -------------------------------------------
    #
    # Spans are host list appends at points the admission and launch
    # bookkeeping already occupies, timed by the clock reads the engine
    # takes after ``_fetch_host`` where there is one: no device sync, no
    # launch, nothing captured. The record goes out through the ambient
    # telemetry sink (telemetry/serving_trace.py has its schema).

    def _mark_admitted(self, seq: _Seq, ev: str, **fields) -> None:
        """Open a sequence's trace: ``queued`` at t=0 (its arrival),
        then the admission span (``admitted``, ``resumed`` or
        ``adopted``). ``queue_wait_s`` is fixed here; a request
        resubmitted after a preemption keeps its first arrival, so its
        second trace shows the whole wait."""
        now = time.monotonic()
        seq.trace.append({"ev": "queued", "t": 0.0})
        seq.span(ev, now, slot=seq.slot, **fields)
        if seq.req.arrival is not None:
            seq.queue_wait_s = now - seq.req.arrival
        seq.prefix_hit = int(fields.get("prefix_hit_tokens")
                             or fields.get("hit_tokens") or 0)

    def _emit_trace(self, seq: _Seq, outcome: str, now: float,
                    tokens_discarded: int = 0) -> None:
        """Close a sequence's trace with ``outcome`` (``finished`` or
        ``preempted``) at ``now``, a time the caller already took, and
        emit its ``serving_trace`` record."""
        seq.span(outcome, now,
                 **({"tokens_discarded": tokens_discarded}
                    if outcome == "preempted" else {}))
        arrival = seq.req.arrival
        ttft = None
        if seq.first_token_t is not None and arrival is not None:
            ttft = seq.first_token_t - arrival
        event("serving_trace",
              id=seq.req.id,
              tenant=seq.req.tenant,
              outcome=outcome,
              prompt_tokens=seq.prompt_len,
              new_tokens=len(seq.generated),
              queue_wait_s=seq.queue_wait_s,
              ttft_s=ttft,
              e2e_s=(now - arrival) if arrival is not None else None,
              prefix_hit_tokens=seq.prefix_hit,
              tokens_discarded=tokens_discarded,
              weights_versions=[list(p) for p in seq.versions],
              spans=list(seq.trace))

    def add_token_listener(self, req_id: str, fn) -> None:
        """Register ``fn(token: int, done: bool)`` to fire as each of
        ``req_id``'s tokens is sampled (the HTTP streaming path).
        Dropped when the request completes; listener exceptions are
        logged, never raised into the step loop."""
        self._token_listeners[req_id] = fn

    def remove_token_listener(self, req_id: str) -> None:
        self._token_listeners.pop(req_id, None)

    def _emit_token(self, seq: _Seq, token: int) -> None:
        """Tag the sequence's newest token with the live weight version
        and deliver it to the request's listener unless its index is
        below the request's high-water mark (a replayed prefix after a
        preemption or a re-adoption, greedy-identical, is not delivered
        again)."""
        if not seq.versions or seq.versions[-1][0] != self.weights_version:
            seq.versions.append([self.weights_version, 0])
        seq.versions[-1][1] += 1
        idx = len(seq.generated) - 1
        fresh = idx >= self._emit_hwm.get(seq.req.id, 0)
        if fresh:
            self._emit_hwm[seq.req.id] = idx + 1
        fn = self._token_listeners.get(seq.req.id)
        if fn is not None and fresh:
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

    def group_of_slot(self, slot: int) -> int:
        return slot // self.batch_local

    def slots_active_by_group(self) -> list[int]:
        B = self.batch_local
        return [sum(1 for s in self.slots[g * B:(g + 1) * B]
                    if s is not None)
                for g in range(self.dp_groups)]

    def _free_slot(self, group: int | None = None) -> int | None:
        B = self.batch_local
        span = (range(len(self.slots)) if group is None
                else range(group * B, (group + 1) * B))
        for i in span:
            if self.slots[i] is None:
                return i
        return None

    def _groups_by_load(self) -> list[int]:
        """The groups, fewest active slots first, ties to the lowest
        index."""
        active = self.slots_active_by_group()
        return sorted(range(self.dp_groups), key=lambda g: (active[g], g))

    def _pick_group(self, first_tokens: int) -> tuple[int, int] | None:
        """Admission load balancing: the fewest-active-slots group (ties
        to the lowest index) that has both a free slot and pages for the
        first chunk. None = every group is full or backpressured (the
        request stays queued)."""
        for g in self._groups_by_load():
            slot = self._free_slot(g)
            if slot is not None and self.cache.can_admit(first_tokens,
                                                         group=g):
                return g, slot
        return None

    def _admit(self) -> _Seq | None:
        """Move the head-of-queue request into a free slot. With prefix
        sharing the placement prefers the group holding the longest
        resident page-aligned prefix of the prompt (the new sequence
        attaches those pages read-only and prefills only the unmatched
        tail; a full cover prefills nothing); with no hit anywhere it
        falls back to fewest-active-slots first. A session request whose
        retained turn matches resumes in its own group (pages cannot
        cross a pool) or waits for a slot there. None = backpressure —
        the request stays queued."""
        if not self.queue:
            return None
        req = self.queue[0]
        plen = int(req.prompt.shape[0])
        first = min(plen, self.cfg.prefill_chunk)
        if not self._sharing:
            picked = self._pick_group(first)
            if picked is None:
                return None
            group, slot = picked
            self.queue.popleft()
            self.cache.join(req.id, group=group)
            self.cache.ensure(req.id, first)
            seq = _Seq(req=req, slot=slot)
            self._mark_admitted(seq, "admitted", group=group,
                                prefix_hit_tokens=0)
            self.slots[slot] = seq
            return seq
        if req.session is not None and req.session in self.sessions:
            res = self._try_resume(req)
            if res is not None:
                return None if res == "wait" else res
            # The retained turn diverged from this prompt and was
            # dropped; the prefix index may still cover part of it.
        ps = self.cfg.page_size
        best = None      # (m, pages, group, slot): the longest match
        starved = None   # the best candidate short on pages
        for g in self._groups_by_load():
            slot = self._free_slot(g)
            if slot is None:
                continue
            pages, m = self.cache.match_prefix(g, req.prompt)
            if m * ps >= plen:
                need = 1  # COW headroom for the boundary replay
            elif m:
                tgt = min(plen, m * ps + self.cfg.prefill_chunk)
                need = -(-tgt // ps) - m
            else:
                need = -(-first // ps)
            if need > self.cache.free_pages_in(g):
                if starved is None or m > starved[0]:
                    starved = (m, pages, g, slot, need)
                continue
            if best is None or m > best[0]:
                best = (m, pages, g, slot)
            if best[0] == 0:
                break  # no hit, and the balanced pick is found
        if best is None and starved is not None:
            # Every group with a free slot is short on pages: evict idle
            # sessions (LRU) in the best starved group before giving up —
            # retained pages must never wedge admission. Re-match
            # afterwards: the eviction may have freed the pages the
            # match used.
            m, pages, g, slot, need = starved
            if self._evict_sessions(g, need):
                pages, m = self.cache.match_prefix(g, req.prompt)
                if m * ps >= plen or m or self.cache.can_admit(first,
                                                               group=g):
                    best = (m, pages, g, slot)
        if best is None:
            return None
        m, pages, group, slot = best
        self.queue.popleft()
        self.cache.join(req.id, group=group)
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
        self._mark_admitted(seq, "admitted", group=group,
                            prefix_hit_tokens=hit)
        self.slots[slot] = seq
        return seq

    # -- prefix sharing / sessions -------------------------------------------

    def _try_resume(self, req: Request):
        """Re-attach a retained session turn in its group. Returns the
        installed ``_Seq``, ``"wait"`` (no free slot in that group), or
        None (the prompt diverged from the retained history, which was
        just dropped)."""
        key = req.session
        sess = self.sessions[key]
        hist = sess["history"]
        hl = int(hist.shape[0])
        prompt = np.array(req.prompt, np.int32)
        plen = int(prompt.shape[0])
        if hl > plen or not np.array_equal(prompt[:hl], hist):
            self._drop_session(key)
            return None
        slot = self._free_slot(sess["group"])
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
        self._mark_admitted(seq, "resumed", group=sess["group"],
                            session=key, hit_tokens=saved)
        self.prefix_stats["session_resumes"] += 1
        self.prefix_stats["hit_tokens"] += saved
        self.prefix_stats["saved_tokens"] += saved
        self._step_prefix[0] += saved
        self._step_prefix[1] += saved
        return seq

    def _drop_session(self, key: str) -> None:
        sess = self.sessions.pop(key)
        self.cache.free(sess["cache_id"])

    def _evict_sessions(self, group: int, need: int) -> bool:
        """Free retained sessions in ``group`` (least recently retained
        first) until ``need`` pages are free there. Returns True when
        satisfied."""
        while self.cache.free_pages_in(group) < need:
            cands = sorted((s["t"], k) for k, s in self.sessions.items()
                           if s["group"] == group)
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
            self._evict_sessions(self.cache.group_of(seq_id), 1)
            pairs = self.cache.privatize(seq_id)
        return pairs

    def _apply_cow(self, pairs: list) -> None:
        """One fixed-width page copy for every forked page of this
        process's group (``pairs``: [(group, src, dst)]; only a group
        with forks copies); unused lanes stay (0 -> 0) scratch
        identities."""
        G, W = self.dp_groups, self._cow_width
        src = np.zeros((G, W), np.int32)
        dst = np.zeros((G, W), np.int32)
        fill = [0] * G
        for g, a, b in pairs:
            src[g, fill[g]] = a
            dst[g, fill[g]] = b
            fill[g] += 1
        if fill[self._g]:
            self._cow(src[self._g], dst[self._g])
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

    def _scheduler_digest(self) -> int:
        """64 bits of the scheduler state every process of a mesh holds
        alike: the queued ids, each slot's occupant, pages used per
        group, the weight version and whether it drains."""
        state = ([r.id for r in self.queue],
                 [None if s is None else s.req.id for s in self.slots],
                 [self.cache.pages_used_in(g)
                  for g in range(self.dp_groups)],
                 self.weights_version, self.draining)
        h = hashlib.blake2b(repr(state).encode(), digest_size=8).digest()
        return int.from_bytes(h, "little", signed=True)

    def _check_lockstep(self) -> None:
        """One all-gather over every process of the mesh of (digest,
        step number), before any other collective of the step: when one
        differs every process raises, at the same step."""
        mine = torch.tensor([self._scheduler_digest(), self._step_counter],
                            dtype=torch.int64, device=self.device)
        got = _all_gather(mine, self._mesh_group).cpu().numpy()
        self.gathers["lockstep"] += 1
        if (got != got[0]).any():
            raise RuntimeError(
                f"serving mesh out of lock-step at step "
                f"{self._step_counter}: the processes' (scheduler digest, "
                f"step) are {got.tolist()}; every process must be given "
                "the same submissions in the same order")

    def step(self) -> dict:
        """One scheduling decision + one program launch. Returns a
        record of what ran (``op``: prefill/decode/idle)."""
        t0 = time.monotonic()
        if self._mesh_group is not None:
            self._check_lockstep()
        pending = self._prefill_candidates()
        can_admit = (not self.draining and bool(self.queue)
                     and self._free_slot() is not None)
        want_prefill = bool(pending or can_admit)
        decodable = self._decode_candidates()
        if self.cfg.policy == "prefill":
            kind = "prefill" if want_prefill else (
                "decode" if decodable else "idle")
        else:
            kind = "decode" if decodable else (
                "prefill" if want_prefill else "idle")
        tokens_out = 0
        self._step_spec = None
        self._step_resident = None
        self._last_prefill_lanes = None
        self._step_prefix = [0, 0]
        syncs0 = self.host_syncs
        if kind == "prefill":
            if self.cfg.prefill_mode == "batched":
                # Admit everything slots+pages allow before the launch.
                while not self.draining and self.queue \
                        and self._admit() is not None:
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
        if self._step_spec is not None:
            launches, emitted = self._step_spec
            rec["spec_k"] = self.cfg.spec_k
            rec["spec_accepted_mean"] = round(emitted / launches, 4)
        if self._step_resident is not None:
            rec["resident_k"] = self.cfg.resident_k
            rec["resident_steps_per_launch"] = self._step_resident
        if self._sharing:
            rec["prefix_hit_tokens"] = self._step_prefix[0]
            rec["prefill_tokens_saved"] = self._step_prefix[1]
            rec["sessions_resident"] = len(self.sessions)
            rec["kv_pages_shared"] = [self.cache.shared_pages_in(g)
                                      for g in range(self.dp_groups)]
        syncs = self.host_syncs - syncs0
        rec["host_syncs"] = syncs
        if tokens_out:
            rec["host_syncs_per_token"] = round(syncs / tokens_out, 6)
        rec["weight_bytes"] = self.weight_bytes
        if self.dp_groups > 1:
            rec["group_slots_active"] = self.slots_active_by_group()
            if self._last_prefill_lanes is not None:
                rec["group_prefill_slots_active"] = self._last_prefill_lanes
        event("serving", **rec)
        self._step_counter += 1
        if kind != "idle":
            self.launch_count += 1
            if self.faults is not None:
                self._run_faults()
        return rec

    def _run_faults(self) -> None:
        """The serving fault hook, after the step record (the injector
        writes its ledger before any action, so a restart cannot re-fire
        a fault). The injector sleeps ``slow_decode`` itself; the engine
        acts on the kinds that need its state: ``client_disconnect``
        drops one live stream listener (the high-water mark keeps
        advancing, so the severed stream never resumes with duplicates),
        and ``engine_crash`` raises out of ``step()`` as a real
        engine-thread fault would."""
        fired = self.faults.on_launch(self.launch_count)
        if "client_disconnect" in fired and self._token_listeners:
            rid = next(iter(self._token_listeners))
            self._token_listeners.pop(rid, None)
            logger.warning("injected client_disconnect: dropped stream "
                           "listener %r", rid)
        if "engine_crash" in fired:
            raise InjectedCrash(
                f"injected engine_crash at launch {self.launch_count}")

    def _fetch_host(self, *tensors) -> tuple:
        """The designated device->host transfer of the step loop: every
        blocking fetch goes through here, so ``host_syncs`` is exact.
        One call = one sync, however many tensors ride it. Each tensor
        comes back with a leading dp-group dim, ``(G, …)``: with dp
        groups, every group's tensors by one all-gather over the dp
        group (their bytes end to end), then one copy to the host; else
        this process's own."""
        self.host_syncs += 1
        if self._dp_group is None:
            return tuple(t.cpu().numpy()[None] for t in tensors)
        G = self.dp_groups
        buf = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
        rows = _all_gather(buf, self._dp_group).cpu().numpy()
        self.gathers["dp_fetch"] += 1
        res, off = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            dt = torch.empty((), dtype=t.dtype).numpy().dtype
            res.append(rows[:, off:off + n].copy().view(dt)
                       .reshape(G, *t.shape))
            off += n
        return tuple(res)

    def _group_row(self, seq_id) -> tuple[np.ndarray, np.ndarray, int]:
        """(G, P) page rows + (G,) live mask for a single sequence: the
        owner group's real row, all-scratch rows elsewhere."""
        G = self.dp_groups
        g = self.cache.group_of(seq_id)
        rows = np.zeros((G, self.cache.cfg.pages_per_seq), np.int32)
        rows[g] = self.cache.page_row(seq_id)
        live = np.zeros((G,), bool)
        live[g] = True
        return rows, live, g

    def _run_prefill_chunk(self, seq: _Seq) -> bool:
        """One chunk of ``seq``'s prompt (sequential mode). False = no
        progress (the owning group's pool could not cover the chunk's
        pages). Every process launches its group's row: the owner's live,
        the others all-scratch."""
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
                g = self.cache.group_of(seq.req.id)
                self._apply_cow([(g, a, b) for a, b in pairs])
        chunk = np.zeros((c.prefill_chunk,), np.int32)
        chunk[:n_valid] = seq.req.prompt[start:start + n_valid]
        rows, live, g = self._group_row(seq.req.id)
        logits = self._prefill_one(rows[self._g], bool(live[self._g]),
                                   chunk, start, n_valid)
        self.cache.advance(seq.req.id, n_valid)
        seq.prefilled = start + n_valid
        self.prefill_tokens_computed += n_valid
        self.prefill_launches += 1
        if seq.prefill_done:
            (lg,) = self._fetch_host(logits)
            tok = self._sample_host(lg[g])
            now = time.monotonic()
            seq.span("prefill", now, tokens=n_valid)
            seq.first_token_t = now
            seq.token_times.append(now)
            seq.generated.append(tok)
            if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                seq.eos = True
            self._emit_token(seq, tok)
            self._register(seq)
            self._maybe_finish(seq)
            return True
        # Mid-prompt chunk: no fetch, so the span's time is the host
        # clock after the enqueue (the token count is what it carries).
        seq.span("prefill", time.monotonic(), tokens=n_valid)
        self._register(seq)
        return True

    def _sample_host(self, logits: np.ndarray) -> int:
        """Sample the sequential prefill's first token from host logits
        (already fetched through ``_fetch_host``; every process samples
        the same row with the same generator)."""
        if self.cfg.temperature <= 0:
            return int(logits.argmax())
        lg = torch.from_numpy(logits)[None]
        return int(_sample(lg, self.cfg.temperature, self.cfg.top_k,
                           self._host_gen)[0])

    def _run_prefill_batch(self, pending: list[_Seq]) -> int:
        """One launch of the batched prefill program: up to
        ``prefill_local`` pending sequences per group (pages ensured
        first), then read the in-program sample of every lane whose chunk
        completed its prompt. Returns the prompt tokens processed (0 =
        every pending chunk stalled on pages)."""
        c = self.cfg
        G, Sp, C = self.dp_groups, self.prefill_local, c.prefill_chunk
        chosen: list[list[_Seq]] = [[] for _ in range(G)]
        cow: list = []
        for s in pending:
            g = self.cache.group_of(s.req.id)
            if len(chosen[g]) >= Sp:
                continue
            n = min(C, s.prompt_len - s.prefilled)
            if not self.cache.ensure(s.req.id, s.prefilled + n):
                continue  # this lane stalls; others still launch
            if self._sharing:
                pairs = self._cow_guard(s.req.id)
                if pairs is None:
                    continue  # lane stalls on fork pages
                cow += [(g, a, b) for a, b in pairs]
            chosen[g].append(s)
        if not any(chosen):
            return 0
        if cow:
            self._apply_cow(cow)
        tokens = np.zeros((G, Sp, C), np.int32)
        start_pos = np.zeros((G, Sp), np.int32)
        n_valid = np.zeros((G, Sp), np.int32)
        active = np.zeros((G, Sp), bool)
        for g, seqs in enumerate(chosen):
            for i, s in enumerate(seqs):
                start = s.prefilled
                n = min(C, s.prompt_len - start)
                tokens[g, i, :n] = s.req.prompt[start:start + n]
                start_pos[g, i] = start
                n_valid[g, i] = n
                active[g, i] = True
        rows = self.cache.page_rows_grouped(
            [[s.req.id for s in seqs] for seqs in chosen], width=Sp)
        me = self._g
        nxt = self._chunk(rows[me], tokens[me], start_pos[me], n_valid[me],
                          active[me], emit="last")
        self._last_prefill_lanes = [len(seqs) for seqs in chosen]
        self.prefill_launches += 1
        total = 0
        fetched = None
        now = None
        t_launch = time.monotonic()  # for lanes that trigger no fetch
        for g, seqs in enumerate(chosen):
            for i, s in enumerate(seqs):
                n = int(n_valid[g, i])
                self.cache.advance(s.req.id, n)
                s.prefilled += n
                total += n
                if not s.prefill_done:
                    s.span("prefill", t_launch, tokens=n)
                if s.prefill_done:
                    if fetched is None:
                        # One (G, Sp) pull for the whole launch, and only
                        # when some prompt completed; the clock is read
                        # after it.
                        (fetched,) = self._fetch_host(nxt)
                        now = time.monotonic()
                    tok = int(fetched[g, i])
                    s.span("prefill", now, tokens=n)
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

    def _draft(self, seq: _Seq, m: int) -> np.ndarray:
        """``m`` drafted tokens for ``seq`` by prompt lookup over its own
        history: ``draft_tokens`` served from the sequence's incremental
        ``NgramIndex`` (built on the first draft, then extended by the
        tokens emitted since the last one)."""
        if m <= 0:
            return np.zeros((0,), np.int32)
        idx = seq.ngram
        if idx is None:
            idx = seq.ngram = NgramIndex(self.cfg.spec_ngram)
            idx.extend(seq.req.prompt.tolist())
            idx.extend(seq.generated)
        else:
            idx.extend(seq.generated[len(idx) - seq.prompt_len:])
        return idx.draft(m)

    def _emit_tokens(self, seq: _Seq, toks, now: float) -> None:
        """Append a decode launch's emitted tokens to ``seq``, stream
        them, and retire the sequence if it is done."""
        for tok in toks:
            seq.generated.append(tok)
            if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                seq.eos = True
            if seq.first_token_t is None:
                seq.first_token_t = now
            seq.token_times.append(now)
            self._emit_token(seq, tok)
        self._register(seq)
        self._maybe_finish(seq)

    def _run_decode_spec(self, decodable: list[_Seq]) -> int:
        """One launch of the speculative decode program: every decodable
        slot carries [last sampled token, spec_k - 1 drafted tokens], the
        program verifies every position in one forward (the argmax
        chain), and the host emits the accepted prefix. Each emitted
        token is the argmax given the true prefix, so greedy output
        equals one-token decode's. The cache advances only by the
        accepted length; rejected positions' KV sits past ``length``
        (masked) and the next launch overwrites it. Eager on the card
        too, as the JAX host loop is."""
        G, B, K = self.dp_groups, self.batch_local, self.cfg.spec_k
        tokens = np.zeros((G, B, K), np.int32)
        start_pos = np.zeros((G, B), np.int32)
        n_valid = np.zeros((G, B), np.int32)
        active = np.zeros((G, B), bool)
        seq_ids: list[list] = [[None] * B for _ in range(G)]
        stepped: list[tuple[_Seq, int, np.ndarray]] = []
        cow: list = []
        for s in decodable:
            length = self.cache.length(s.req.id)
            remaining = s.req.max_new_tokens - len(s.generated)
            # Clamp the chain to what the sequence can still hold:
            # positions past max_seq_len or the budget ride as masked
            # padding, never as writes.
            n = min(K, remaining, self.cfg.max_seq_len - length)
            if not self.cache.ensure(s.req.id, length + n):
                # Pages for the whole chain are short: a one-token
                # launch in the same program before stalling outright.
                if n == 1 or not self.cache.ensure(s.req.id, length + 1):
                    continue
                n = 1
            g, i = divmod(s.slot, B)
            if self._sharing:
                pairs = self._cow_guard(s.req.id)
                if pairs is None:
                    continue  # fork stalled on pages; retry next step
                cow += [(g, a, b) for a, b in pairs]
            draft = self._draft(s, n - 1)
            tokens[g, i, 0] = s.last_token
            tokens[g, i, 1:n] = draft
            start_pos[g, i] = length
            n_valid[g, i] = n
            active[g, i] = True
            seq_ids[g][i] = s.req.id
            stepped.append((s, n, draft))
        if not stepped:
            return 0
        if cow:
            self._apply_cow(cow)
        rows = self.cache.page_rows_grouped(seq_ids)
        me = self._g
        out = self._chunk(rows[me], tokens[me], start_pos[me], n_valid[me],
                          active[me], emit="all")
        self.decode_launches += 1
        (out,) = self._fetch_host(out)
        now = time.monotonic()
        total = 0
        for s, n, draft in stepped:
            g, i = divmod(s.slot, B)
            # out[g, i, j] is the verified argmax after position j. Draft
            # j is accepted while it equals the chain's previous token,
            # so every accepted argmax is conditioned on true tokens only.
            emit = [int(out[g, i, 0])]
            j = 1
            while j < n and int(draft[j - 1]) == emit[-1]:
                emit.append(int(out[g, i, j]))
                j += 1
            if self.cfg.eos_id >= 0 and self.cfg.eos_id in emit:
                # Later positions are conditioned on an ended sequence.
                emit = emit[:emit.index(self.cfg.eos_id) + 1]
            self.cache.advance(s.req.id, len(emit))
            self.spec_stats["launches"] += 1
            self.spec_stats["emitted"] += len(emit)
            total += len(emit)
            s.span("decode", now, emitted=len(emit), budget=n)
            self._emit_tokens(s, emit, now)
        self._step_spec = (len(stepped), total)
        return total

    def _run_decode_resident(self, decodable: list[_Seq]) -> int:
        """One burst of device-resident decode: every decodable slot
        ships its history row and a token budget, the burst runs
        ``resident_k`` chain iterations on the device (one CUDA graph on
        the card), and the host syncs once for the whole burst: ``(out,
        n_emitted, steps)`` in one ``_fetch_host``. Each iteration emits
        exactly the argmax chain the spec path would (the same
        ``_chunk_hidden``), so K moves only the sync cadence. The cache
        advances only after the fetch."""
        G, B = self.dp_groups, self.batch_local
        T = self.cfg.resident_k * self.cfg.spec_k
        history = np.zeros((G, B, self.cfg.max_seq_len), np.int32)
        kv_len = np.zeros((G, B), np.int32)
        budget = np.zeros((G, B), np.int32)
        active = np.zeros((G, B), bool)
        seq_ids: list[list] = [[None] * B for _ in range(G)]
        stepped: list[_Seq] = []
        cow: list = []
        for s in decodable:
            length = self.cache.length(s.req.id)
            remaining = s.req.max_new_tokens - len(s.generated)
            # The budget is clamped to the pages the slot could claim
            # now (its own plus its group's free list): a tight pool
            # shrinks the burst toward one token instead of stalling it.
            want = min(remaining, T,
                       self.cache.token_capacity(s.req.id) - length)
            if want < 1:
                continue  # no headroom: wait for frees
            if not self.cache.ensure(s.req.id, length + want):
                continue
            g, i = divmod(s.slot, B)
            if self._sharing:
                pairs = self._cow_guard(s.req.id)
                if pairs is None:
                    continue  # fork stalled on pages; retry next step
                cow += [(g, a, b) for a, b in pairs]
            hist = np.concatenate([np.array(s.req.prompt, np.int32),
                                   np.array(s.generated, np.int32)])
            history[g, i, :hist.shape[0]] = hist
            kv_len[g, i] = length
            budget[g, i] = want
            active[g, i] = True
            seq_ids[g][i] = s.req.id
            stepped.append(s)
        if not stepped:
            return 0
        if cow:
            self._apply_cow(cow)
        rows = self.cache.page_rows_grouped(seq_ids)
        me = self._g
        out, n_emitted, steps = self._fetch_host(*self._resident.run(
            rows[me], history[me], kv_len[me], budget[me], active[me]))
        self.decode_launches += 1
        now = time.monotonic()
        total = 0
        for s in stepped:
            g, i = divmod(s.slot, B)
            e = int(n_emitted[g, i])
            self.cache.advance(s.req.id, e)
            total += e
            s.span("decode", now, emitted=e, budget=int(budget[g, i]))
            self._emit_tokens(s, [int(t) for t in out[g, i, :e]], now)
        g_steps = [int(steps[g]) for g in range(G) if active[g].any()]
        self.resident_stats["launches"] += 1
        self.resident_stats["steps"] += max(g_steps, default=0)
        self.resident_stats["emitted"] += total
        self._step_resident = round(sum(g_steps) / max(1, len(g_steps)), 4)
        return total

    def _run_decode(self, decodable: list[_Seq]) -> int:
        if self._resident is not None:
            return self._run_decode_resident(decodable)
        if self.cfg.spec_k > 1:
            return self._run_decode_spec(decodable)
        G, B = self.dp_groups, self.batch_local
        tokens = np.zeros((G, B), np.int32)
        positions = np.zeros((G, B), np.int32)
        active = np.zeros((G, B), bool)
        seq_ids: list[list] = [[None] * B for _ in range(G)]
        stepped: list[_Seq] = []
        cow: list = []
        for s in decodable:
            # The new token's KV lands at position length(seq); a full
            # pool stalls the slot this step.
            if not self.cache.ensure(s.req.id,
                                     self.cache.length(s.req.id) + 1):
                continue
            g, i = divmod(s.slot, B)
            if self._sharing:
                pairs = self._cow_guard(s.req.id)
                if pairs is None:
                    continue  # fork stalled on pages; retry next step
                cow += [(g, a, b) for a, b in pairs]
            tokens[g, i] = s.last_token
            positions[g, i] = self.cache.length(s.req.id)
            active[g, i] = True
            seq_ids[g][i] = s.req.id
            stepped.append(s)
        if not stepped:
            return 0
        if cow:
            self._apply_cow(cow)
        rows = self.cache.page_rows_grouped(seq_ids)
        me = self._g
        nxt = self._decode(tokens[me], positions[me], rows[me], active[me])
        self.decode_launches += 1
        (nxt,) = self._fetch_host(nxt)
        now = time.monotonic()
        for s in stepped:
            g, i = divmod(s.slot, B)
            self.cache.advance(s.req.id, 1)
            s.span("decode", now, emitted=1)
            self._emit_tokens(s, [int(nxt[g, i])], now)
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
            self._session_clock += 1
            self.sessions[key] = {
                "cache_id": cid,
                "history": np.concatenate([
                    np.array(seq.req.prompt, np.int32),
                    np.array(seq.generated, np.int32)]),
                "group": self.cache.group_of(cid),
                "t": self._session_clock}
            seq.span("session_retain", time.monotonic(), session=key)
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
            "group": self.group_of_slot(seq.slot),
            "weights_versions": [list(p) for p in seq.versions],
        }
        self.completed.append(rec)
        self.finished_total += 1
        self._emit_hwm.pop(seq.req.id, None)
        event("serving_request",
              **{k: rec[k] for k in ("id", "tenant", "prompt_tokens",
                                     "new_tokens", "ttft_s",
                                     "queue_wait_s", "latency_s",
                                     "group")})
        self._emit_trace(seq, "finished", now)

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

    # -- serving weights and recovery ---------------------------------------

    def adopt(self, req: Request, first_token: int, k_dense, v_dense
              ) -> None:
        """Adopt one externally prefilled sequence: its prompt KV arrives
        dense (L, Hkv, prompt_len, hd) and decode continues here."""
        self.adopt_batch([(req, first_token, k_dense, v_dense)])

    def adopt_batch(self, items) -> None:
        """Adopt many sequences in one batched page import (one scatter
        per pool). ``items``: ``(req, tokens, k_dense, v_dense)`` with
        ``tokens`` the first sampled token or the whole generated
        history so far (the crash re-adoption of ``export_in_flight``);
        the dense KV covers ``prompt_len + len(tokens) - 1`` positions
        (the newest token's KV is written by its own decode launch).
        Each goes to the group ``_pick_group`` picks; on a mesh every
        process is given the same items, whole, and writes its own
        group's pages at its kv heads. Raises before touching the pools
        when a request gets no slot and pages, and frees whatever the
        batch took: the caller holds it and retries."""
        now = time.monotonic()
        staged = []
        try:
            for req, toks, k_dense, v_dense in items:
                tokens = ([int(toks)] if isinstance(toks, (int, np.integer))
                          else [int(t) for t in toks])
                if not tokens:
                    raise ValueError(
                        f"adopt of {req.id!r} carries no tokens: a "
                        "never-decoded sequence resubmits as a fresh "
                        "request instead")
                if req.arrival is None:
                    req.arrival = now
                self._validate(req)
                need = req.prompt.shape[0] + len(tokens) - 1
                picked = self._pick_group(need)
                if picked is None:
                    raise RuntimeError(
                        f"no free slot/pages to adopt {req.id!r} into")
                group, slot = picked
                self.cache.join(req.id, group=group)
                seq = _Seq(req=req, slot=slot,
                           prefilled=int(req.prompt.shape[0]))
                self._mark_admitted(seq, "adopted", group=group)
                self.slots[slot] = seq
                staged.append((seq, tokens, k_dense, v_dense))
            import_kv_batch(self.cache, [(s.req.id, k, v)
                                         for s, _t, k, v in staged])
        except Exception:
            # A failed batch leaks no table entry or slot (a retry of the
            # same id would otherwise hit "already joined"); ensure() is
            # atomic per sequence, so freeing returns exactly the pages
            # taken.
            for s, _t, _k, _v in staged:
                self.cache.free(s.req.id)
                self.slots[s.slot] = None
            raise
        now = time.monotonic()
        for seq, tokens, _k, _v in staged:
            seq.first_token_t = now
            for tok in tokens:
                seq.token_times.append(now)
                seq.generated.append(tok)
                if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                    seq.eos = True
                self._emit_token(seq, tok)
                self._register(seq)
            self._maybe_finish(seq)

    def preempt(self) -> list[Request]:
        """Drop all device-side progress, free every sequence's pages and
        hand back the unfinished work (in-flight requests, fresh, then
        the queue), with their listeners dropped: a resubmitted request
        restarts from its prompt. Retained sessions survive (their pages
        are refcount-held and untouched by the frees)."""
        lost: list[Request] = []
        now = time.monotonic()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            # The trace closes before the state goes: the tokens thrown
            # away are recorded, not inferred.
            self._emit_trace(s, "preempted", now,
                             tokens_discarded=len(s.generated))
            self.cache.free(s.req.id)
            self.slots[i] = None
            lost.append(Request(id=s.req.id, prompt=s.req.prompt,
                                max_new_tokens=s.req.max_new_tokens,
                                arrival=s.req.arrival, tenant=s.req.tenant))
        lost.extend(self.queue)
        self.queue.clear()
        for req in lost:
            self._token_listeners.pop(req.id, None)
        event("serving_preempt", lost=len(lost))
        return lost

    def _replay_request(self, seq: _Seq) -> Request:
        """A fresh Request with the original identity (id, arrival,
        session, tenant), so the queue wait and the exactly-once stream
        stay keyed to the same request."""
        return Request(id=seq.req.id, prompt=seq.req.prompt,
                       max_new_tokens=seq.req.max_new_tokens,
                       arrival=seq.req.arrival, session=seq.req.session,
                       tenant=seq.req.tenant)

    def _preempt_seq(self, seq: _Seq) -> None:
        """Preempt one in-flight sequence back to the head of the queue
        (the staleness bound): pages freed, slot vacated, listener and
        high-water mark kept, so greedy decode regenerates its prefix
        without delivering it twice. Its trace closes as preempted."""
        self._emit_trace(seq, "preempted", time.monotonic(),
                         tokens_discarded=len(seq.generated))
        self.cache.free(seq.req.id)
        self.slots[seq.slot] = None
        self.queue.appendleft(self._replay_request(seq))

    def swap_weights(self, params, version: str,
                     provenance: dict | None = None) -> int:
        """Install a new weight set into the running engine between
        launches. All or nothing: every gate runs before the first byte
        is copied, and a refusal leaves the incumbent weights serving.

        Gates, in order: (1) an injected ``swap_corrupt``; (2) plan
        provenance, the same plan name and fingerprint as the engine's;
        (3) tree structure and (4) each leaf's shape and dtype, against
        the whole tree the engine was built with; (5) placement: the
        tree is cut to this rank (``_rank_params``) and copied into the
        engine's compute tensors, which the programs and the resident
        burst's CUDA graph read, so nothing is captured again (the
        port's "zero recompiles"). ``params`` may lie on the host or the
        device; the engine keeps no reference to it.

        In-flight sequences keep decoding on the new weights, each token
        version-tagged. With ``cfg.swap_staleness_tokens`` >= 0 a
        sequence that has emitted more tokens than that is preempted and
        resubmitted instead. Returns the number so preempted."""

        def refuse(exc: Exception):
            self.swap_stats["refused"] += 1
            event("serving_swap", outcome="refused", version=version,
                  engine_version=self.weights_version, reason=str(exc))
            logger.warning("weight swap to %r refused: %s", version, exc)
            raise exc

        if self.faults is not None and self.faults.on_swap(
                self.launch_count):
            refuse(ProvenanceError(
                f"swap to {version!r}: injected swap_corrupt — published "
                "artifact failed verification"))
        if self.weights_provenance is not None:
            if provenance is None:
                refuse(ProvenanceError(
                    f"swap to {version!r}: engine weights carry plan "
                    f"provenance ({self.weights_provenance.get('name')}) "
                    "but the publish carries none"))
            for key in ("name", "fingerprint"):
                if provenance.get(key) != self.weights_provenance.get(key):
                    refuse(ProvenanceError(
                        f"swap to {version!r}: plan {key} mismatch — "
                        f"engine {self.weights_provenance.get(key)!r} vs "
                        f"publish {provenance.get(key)!r}"))
        elif provenance is None:
            logger.warning("weight swap to %r: no provenance on either "
                           "side; accepting on shape/dtype/placement gates "
                           "only", version)
        new = _leaf_specs(params)
        if list(new) != list(self._specs):
            refuse(ValueError(f"swap to {version!r}: params tree structure "
                              "differs from the serving tree"))
        bad = [i for i, (o, n) in enumerate(zip(self._specs.values(),
                                                new.values())) if o != n]
        if bad:
            refuse(ValueError(
                f"swap to {version!r}: {len(bad)} leaf(s) differ in "
                f"shape/dtype (first at flat index {bad[0]})"))
        rank = _rank_params(params, self.model, self.mesh, self._tp_size)
        with torch.no_grad():
            ours = flatten(self.params)
            for k, t in flatten(rank).items():
                ours[k].copy_(t)
        self.weights_version = version
        if provenance is not None:
            self.weights_provenance = dict(provenance)
        self.swap_stats["installed"] += 1
        bound = self.cfg.swap_staleness_tokens
        stale = []
        if bound >= 0:
            stale = [s for s in self.slots
                     if s is not None and len(s.generated) > bound]
            for s in stale:
                self._preempt_seq(s)
            self.swap_stats["stale_preempted"] += len(stale)
        event("serving_swap", outcome="installed", version=version,
              stale_preempted=len(stale), in_flight=self.in_flight,
              swaps_installed=self.swap_stats["installed"])
        return len(stale)

    def drain(self, deadline_s: float | None = None) -> dict:
        """Stop admission, run in-flight work to completion (or to
        ``deadline_s``) and report each request's outcome: ``finished``,
        ``persisted`` (still in flight at the deadline, exported through
        ``export_in_flight`` for re-adoption, under ``export``) and
        ``requeued`` (queued, never admitted; they stay queued).
        Retained sessions survive. The engine stays draining (clear
        ``draining`` to reopen admission). On a mesh the deadline is read
        from the mesh's first process's clock (``_past``)."""
        self.draining = True
        t0 = time.monotonic()
        n0 = len(self.completed)
        steps = 0
        while self.in_flight and not self._past(t0, deadline_s):
            self.step()
            steps += 1
            if steps > 200_000:
                raise RuntimeError(
                    "drain not converging after 200k steps "
                    f"(in_flight={self.in_flight})")
        persisted = (self.export_in_flight() if self.in_flight
                     else {"adoptable": [], "requests": []})
        report = {
            "finished": [r["id"] for r in self.completed[n0:]],
            "persisted": ([it[0].id for it in persisted["adoptable"]]
                          + [r.id for r in persisted["requests"]]),
            "requeued": [r.id for r in self.queue],
            "steps": steps,
            "duration_s": time.monotonic() - t0,
            "export": persisted,
        }
        event("serving_drain", deadline_s=deadline_s,
              finished=len(report["finished"]),
              persisted=len(report["persisted"]),
              requeued=len(report["requeued"]), steps=steps,
              duration_s=report["duration_s"])
        return report

    def _past(self, t0: float, deadline_s: float | None) -> bool:
        """Whether ``deadline_s`` from ``t0`` has passed: on a mesh, by
        the first process's clock, broadcast over the mesh, so that every
        process stops at the same step."""
        if deadline_s is None:
            return False
        past = time.monotonic() - t0 >= deadline_s
        if self._mesh_group is None:
            return past
        flag = torch.tensor([past], dtype=torch.int64, device=self.device)
        dist.broadcast(flag, src=self.mesh.first_rank,
                       group=self._mesh_group)
        self.gathers["deadline"] += 1
        return bool(flag.item())

    def export_kv(self, seq_ids: list, to_host: bool = True) -> tuple:
        """Dense KV of ``seq_ids`` (``disagg.export_kv_batch``): on a mesh
        gathered over its processes, the same on every one."""
        if self._mesh_group is not None and seq_ids:
            self.gathers["kv_export"] += 1
        return export_kv_batch(self.cache, seq_ids, group=self._mesh_group,
                               to_host=to_host)

    def export_in_flight(self) -> dict:
        """Persist every in-flight sequence on the host and vacate its
        device state (the crash salvage and the drain deadline).
        Sequences that have decoded at least one token export their
        exact dense KV (one ``export_kv_batch`` transfer) and generated
        history as ``adopt_batch`` items (``"adoptable"``);
        never-decoded ones come back as fresh requests (``"requests"``).
        On a mesh the KV is gathered over its processes and every
        process exports the same. Listeners and high-water marks are
        left to ``export_emission_state``."""
        seqs = [s for s in self.slots if s is not None]
        adoptable = [s for s in seqs if s.prefill_done and s.generated]
        ks, vs = self.export_kv([s.req.id for s in adoptable])
        items = [(self._replay_request(s), list(s.generated), k, v)
                 for s, k, v in zip(adoptable, ks, vs)]
        requests = [self._replay_request(s) for s in seqs
                    if not (s.prefill_done and s.generated)]
        now = time.monotonic()
        for s in seqs:
            # Traces close as preempted; the exported ones discard
            # nothing (their tokens travel with them).
            kept = s.prefill_done and s.generated
            self._emit_trace(s, "preempted", now,
                             tokens_discarded=0 if kept else len(s.generated))
            self.cache.free(s.req.id)
            self.slots[s.slot] = None
        return {"adoptable": items, "requests": requests}

    def export_emission_state(self) -> dict:
        """The exactly-once stream state for a successor engine in this
        process: the high-water marks and the live listeners."""
        return {"hwm": dict(self._emit_hwm),
                "listeners": dict(self._token_listeners)}

    def import_emission_state(self, state: dict | None) -> None:
        if not state:
            return
        self._emit_hwm.update(state.get("hwm", {}))
        self._token_listeners.update(state.get("listeners", {}))

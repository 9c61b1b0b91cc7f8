"""Ring attention: sequence parallelism over the ``sp`` mesh axis (port
of ``parallel/ring_attention.py``).

Long-context training shards each row's sequence over the ``sp``
members of a data shard; attention then needs every query slice to see
every key slice. Ring attention does this with O(S/sp) attention memory
per process: the key/value blocks rotate around the ``sp`` group (a ring
of point-to-point exchanges, ``SPGroup.rotate``) while each process folds
the incoming block into its queries' running (normalized output,
logsumexp) pair (Liu et al., Ring Attention with Blockwise Transformers,
2023).

Causality with a contiguously sharded sequence: ring step ``t`` holds
the block of member ``(i - t) mod sp`` on member ``i``; that block is
entirely in the past (unmasked block attention), the diagonal (causal
block attention), or entirely in the future (skipped, no FLOPs). The
schedule is the same on every member: ``sp - 1`` rotations in the
forward (the JAX ring's last rotation only brings the blocks home), so
causal skipping saves FLOPs, not bandwidth. Each block's output is kept
in f32 and the output is rounded to the input dtype once, at the end.

Per-block attention on the card runs the flash kernels when the local
shard is tile-friendly (``_use_flash``): the forward kernel
``flash_fwd(..., out_dtype=torch.float32)`` (B1, causal on the
diagonal, non-causal on past blocks), and in the backward the split
pair ``flash_bwd_dq`` (B3a) and ``flash_bwd_dkv`` (B3b) with the final
``delta`` and f32 gradients, as the JAX ``_block_grads_flash`` calls the
split ``_flash_bwd``. The split pair has no atomics, so a ring run repeats
its bits. Otherwise (CPU tensors, shards the kernels do not tile) the
einsum reference ``_block_attn_naive``/``_block_grads_naive`` runs. Under
a sliding window only the diagonal block takes the kernels (they model
the band in the aligned geometry alone); offset blocks run the einsum
path in global positions, and blocks wholly behind the window are
skipped.

The backward is a reverse ring (``_RingCore``, a
``torch.autograd.Function``), not autograd through the loop: autograd
would save every rotated block (O(S) per process). The Function saves
q, k, v, out and lse, all O(S_local); its backward sends the original
key/value blocks around the ring a second time, recomputes each step's
gradients from the final logsumexp and ``delta`` (the FlashAttention-2
decomposition, so per-block gradients sum to the exact total), and the
dk/dv accumulators travel with their block: after ``sp`` rotations each
block's gradient is back home. dq accumulates locally.

``SPGroup`` is the model's binding (``Transformer.bind_sequence_parallel``):
the ``sp`` process group of this process. Its exchanges post send and
receive together (``batch_isend_irecv``), so a ring of 2 cannot
deadlock. A gloo group moves CPU tensors only, so on the card a gloo
group stages each block through host tensors (counted in
``EXCHANGES["staged_bytes"]``); the attention itself never leaves the
card, and a NCCL group sends device tensors. ``EXCHANGES`` counts what
the exchanges moved since its last reset and the host seconds spent
waiting for them (``wait_s``, which the train step adds to its
``sync_s``).
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.ops import flash_attention as fa
from distributed_training_tpu_torch.ops.attention import dot_product_attention
from distributed_training_tpu_torch.parallel.staging import through_host
from distributed_training_tpu_torch.telemetry import collectives

NEG_INF = -1e30

# What the sequence-parallel exchanges moved since the last reset:
# "rotations" (ring steps' exchanges), "all_to_all" (Ulysses'), "bytes"
# sent, "staged_bytes" copied between the card and the host for a gloo
# group, and "wait_s", host seconds spent waiting for them.
EXCHANGES: collections.Counter = collections.Counter()


class SPGroup:
    """This process's ``sp`` group: its size, this process's coordinate
    on ``sp`` (its slice of the sequence) and the world ranks of its
    ring neighbours. ``group=None`` is a group of one (no process
    group: the degenerate ring)."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.size, self.rank, self.ranks = 1, 0, (0,)
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.ranks = tuple(dist.get_process_group_ranks(group))
        self.backend = (dist.get_backend(group) if group is not None
                        else None)

    def staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through host memory: a card's tensor over a
        gloo group (``parallel/staging.py``)."""
        return through_host(t, self.backend)

    def rotate(self, tensors: list, tag: int = 0) -> "_Rotation":
        """Start sending ``tensors`` to the next member of the ring and
        receiving the previous member's; ``.wait()`` returns them. Two
        exchanges in flight at once take distinct ``tag`` bases."""
        return _Rotation(self, tensors, tag)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (sp, ...): chunk ``j`` goes to member ``j``; returns the
        chunks received, chunk ``j`` from member ``j``."""
        EXCHANGES["all_to_all"] += 1
        EXCHANGES["bytes"] += x.numel() * x.element_size()
        t0 = time.perf_counter()
        src = x.contiguous()
        if self.staged(src):
            host = src.cpu()
            out = torch.empty_like(host)
            dist.all_to_all_single(out, host, group=self.group)
            collectives.record("all-to-all", self.group, out)
            EXCHANGES["staged_bytes"] += 2 * host.numel() * host.element_size()
            out = out.to(src.device)
        else:
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
            collectives.record("all-to-all", self.group, out)
        EXCHANGES["wait_s"] += time.perf_counter() - t0
        return out


class _Rotation:
    """One ring step's exchange in flight: every tensor sent to the next
    member and received from the previous one, posted together."""

    def __init__(self, sp: SPGroup, tensors: list, tag: int = 0):
        self.device = tensors[0].device
        self.stage = sp.staged(tensors[0])
        t0 = time.perf_counter()
        sends = [t.contiguous() for t in tensors]
        if self.stage:
            sends = [t.cpu() for t in sends]
        self.recvs = [torch.empty_like(t) for t in sends]
        nxt = sp.ranks[(sp.rank + 1) % sp.size]
        prv = sp.ranks[(sp.rank - 1) % sp.size]
        ops = ([dist.P2POp(dist.isend, t, nxt, sp.group, tag=tag + i)
                for i, t in enumerate(sends)]
               + [dist.P2POp(dist.irecv, t, prv, sp.group, tag=tag + i)
                  for i, t in enumerate(self.recvs)])
        self.works = dist.batch_isend_irecv(ops)
        for t in sends:
            collectives.record("collective-permute", sp.group, t)
        self._sends = sends     # kept alive until the exchange completes
        nbytes = sum(t.numel() * t.element_size() for t in sends)
        EXCHANGES["rotations"] += 1
        EXCHANGES["bytes"] += nbytes
        if self.stage:
            EXCHANGES["staged_bytes"] += 2 * nbytes
        EXCHANGES["wait_s"] += time.perf_counter() - t0

    def wait(self) -> list:
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        out = self.recvs
        if self.stage:
            out = [t.to(self.device) for t in out]
        self._sends = None
        EXCHANGES["wait_s"] += time.perf_counter() - t0
        return out


class _SumOverSP(torch.autograd.Function):
    """Sum over the sp group in the forward, identity in the backward:
    each member's gradient is then the part its own slice gives, and the
    trainer sums the members' gradients (``parallel/fsdp.py``)."""

    @staticmethod
    def forward(ctx, x, sp):
        out = x.clone(memory_format=torch.contiguous_format)
        if sp.size > 1:
            dist.all_reduce(out, group=sp.group)
            collectives.record("all-reduce", sp.group, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_sp(x: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    return _SumOverSP.apply(x, sp)


# -- block attention -----------------------------------------------------


def _block_mask(Sq: int, Sk: int, mode: str, offset: int, window: int,
                device):
    """Visibility mask (Sq, Sk) for one ring block pair, or None when
    nothing is masked. ``offset`` = absolute query start minus absolute
    key start (0 on the diagonal, t·S_local for a block t steps in the
    past): query row r sits at r + offset relative to key column c;
    causal keeps ``c <= r + offset``, a window also needs
    ``c >= r + offset - (window - 1)``."""
    rows = torch.arange(Sq, device=device)[:, None] + offset
    cols = torch.arange(Sk, device=device)[None, :]
    mask = None
    if mode == "causal":
        mask = cols <= rows
    if window:
        lower = cols >= rows - (window - 1)
        mask = lower if mask is None else mask & lower
    return mask


def _block_attn_naive(q, k, v, mode: str, offset: int | None = None,
                      window: int = 0):
    """Einsum block attention → (out_norm (B, Sq, H, D) f32, lse
    (B, H, Sq) f32): the numerics reference for the flash block, f32
    logits, the weights rounded to v's dtype before the value product.
    ``offset=None`` aligns the queries' end with the keys' end."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Sq, Hkv, group, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * D ** -0.5
    if offset is None:
        offset = Sk - Sq
    mask = _block_mask(Sq, Sk, mode, offset, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)          # (B,Hkv,g,Sq)
    p = torch.exp(s - m[..., None])
    lsum = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                     v.float()) / lsum[..., None]
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    lse = (m + torch.log(lsum)).reshape(B, H, Sq)
    return out, lse


def _validate_tile_overrides(q, k, block_q: int, block_k: int) -> None:
    """Raise-don't-ignore: an explicit flash tile override that does not
    divide the local shard would otherwise be dropped silently."""
    S, Sk = q.shape[1], k.shape[1]
    if (block_q and S % min(block_q, S)) or (
            block_k and Sk % min(block_k, Sk)):
        raise ValueError(
            f"flash tile overrides ({block_q}, {block_k}) do not "
            f"divide the local shard lengths ({S}, {Sk})")


def _use_flash(q, k, block_q: int = 0, block_k: int = 0) -> bool:
    """Route the ring's blocks through the flash kernels? The
    single-process gate ``fa.supported`` (CUDA tensors, tile-friendly
    shards). The tests replace it to run the kernels' wrappers on CPU
    tensors, where they take their plain versions."""
    return fa.supported(q, k, k, block_q=block_q, block_k=block_k)


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def _block_attn_flash(qt, k, v, mode: str, window: int = 0):
    """One ring block through the forward kernel (B1) with f32 output,
    so per-block partials are not rounded before the merge. ``qt``: the
    local queries in (B, H, S, D), made once per ring. ``window``: the
    diagonal block only (the aligned band)."""
    out, lse = fa.flash_fwd(qt, _bhsd(k), _bhsd(v), causal=mode == "causal",
                            out_dtype=torch.float32, window=window)
    return out.transpose(1, 2), lse[..., 0]


def _merge(out_a, lse_a, out_b, lse_b):
    """Merge two normalized partial attentions by their logsumexps:
    the softmax over the union is the lse-weighted convex combination."""
    lse = torch.logaddexp(lse_a, lse_b)                # (B,H,S)
    wa = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    wb = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return out_a * wa + out_b * wb, lse


def _ring_branch(src: int, idx: int, t: int, S: int, window: int) -> int:
    """Ring-step branch: 0 = past block, 1 = diagonal, 2 = skip. Blocks
    ahead of the queries are skipped (causality); under a window, a past
    block t steps back is also skipped when even its newest key (gap
    (t-1)·S + 1 to the oldest local query) is outside the window."""
    if src == idx:
        return 1
    past = 0 if src < idx else 2
    if window and (t - 1) * S + 1 > window - 1:
        past = 2
    return past


def _block_grads_naive(q, k, v, do_g, lse, delta, mode: str,
                       offset: int | None = None, window: int = 0):
    """Einsum gradients of one key/value block against the local
    queries, the softmax recomputed from the final logsumexp. q (B, Sq,
    H, D); k/v (B, Sk, Hkv, D); do_g (B, Hkv, g, Sq, D) f32; lse/delta
    (B, H, Sq) f32. Returns (dq (B, Sq, H, D), dk, dv (B, Sk, Hkv, D)),
    all f32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Sq, Hkv, group, D).float()
    lse_g = lse.reshape(B, Hkv, group, Sq)
    delta_g = delta.reshape(B, Hkv, group, Sq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if offset is None:
        offset = Sk - Sq
    mask = _block_mask(Sq, Sk, mode, offset, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - lse_g[..., None])
    dv = torch.einsum("bhgqk,bhgqd->bkhd", p, do_g)
    dp = torch.einsum("bhgqd,bkhd->bhgqk", do_g, v.float())
    ds = p * (dp - delta_g[..., None]) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(B, Sq, H, D), dk, dv


def _block_grads_flash(qt, dot, k, v, lse, delta, mode: str,
                       window: int = 0):
    """One block's gradients through the split backward kernels, dq
    (B3a) and dk/dv (B3b), from the final lse and delta (the FA2
    decomposition), in f32. ``qt``/``dot``: the local queries and
    upstream gradient in (B, H, S, D), made once per ring; lse/delta
    (B, H, S, 1)."""
    kt, vt = _bhsd(k), _bhsd(v)
    kw = dict(causal=mode == "causal", window=window,
              grads_dtype=torch.float32)
    dq = fa.flash_bwd_dq(qt, kt, vt, dot, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(qt, kt, vt, dot, lse, delta, **kw)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _ring_fwd(q, k, v, sp: SPGroup, causal: bool, use_flash: bool,
              window: int):
    """A full ring of online-softmax accumulation: the normalized output
    (B, S, H, D) in q's dtype and the per-row logsumexp (B, H, S) f32."""
    B, S, H, D = q.shape
    qt = _bhsd(q) if use_flash else None
    out = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = [k, v]
    for t in range(sp.size):
        # Post the next exchange before this block's compute, so the
        # transfer overlaps it.
        nxt = sp.rotate(kv) if t < sp.size - 1 else None
        src = (sp.rank - t) % sp.size
        branch = (_ring_branch(src, sp.rank, t, S, window) if causal
                  else 0)
        if branch != 2:
            mode = "causal" if branch == 1 else "full"
            if use_flash and (not window or mode == "causal"):
                o_t, l_t = _block_attn_flash(qt, kv[0], kv[1], mode, window)
            else:
                o_t, l_t = _block_attn_naive(q, kv[0], kv[1], mode,
                                             offset=0 if branch else t * S,
                                             window=window)
            out, lse = _merge(out, lse, o_t, l_t)
        if nxt is not None:
            kv = nxt.wait()
    return out.to(q.dtype), lse


class _RingCore(torch.autograd.Function):
    """Ring attention with the reverse-ring backward: saves q, k, v, out
    and lse (all O(S_local)), never a rotated block."""

    @staticmethod
    def forward(ctx, q, k, v, sp, causal, use_flash, window):
        out, lse = _ring_fwd(q, k, v, sp, causal, use_flash, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (sp, causal, use_flash, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        sp, causal, use_flash, window = ctx.args
        B, S, H, D = q.shape
        Hkv = k.shape[2]
        do_f = do.float()
        delta = (do_f * out.float()).sum(-1).transpose(1, 2)   # (B,H,S)
        if use_flash:
            qt, dot = _bhsd(q), _bhsd(do.to(q.dtype))
            lse4 = lse[..., None].contiguous()
            delta4 = delta[..., None].contiguous()
        do_g = None
        if not use_flash or window:
            # The einsum path: every block without the kernels, the
            # offset blocks under a window.
            do_g = do_f.reshape(B, S, Hkv, H // Hkv, D).permute(0, 2, 3, 1, 4)
        dq = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kv = [k, v]
        for t in range(sp.size):
            src = (sp.rank - t) % sp.size
            branch = (_ring_branch(src, sp.rank, t, S, window) if causal
                      else 0)
            # The key/value block moves on while its gradient is
            # computed; the accumulators follow once it is added in.
            nxt = sp.rotate(kv) if t < sp.size - 1 else None
            if branch != 2:
                mode = "causal" if branch == 1 else "full"
                if use_flash and (not window or mode == "causal"):
                    g = _block_grads_flash(qt, dot, kv[0], kv[1], lse4,
                                           delta4, mode, window)
                else:
                    g = _block_grads_naive(q, kv[0], kv[1], do_g, lse,
                                           delta, mode,
                                           offset=0 if branch else t * S,
                                           window=window)
                dq += g[0]
                dk += g[1]
                dv += g[2]
            if sp.size > 1:
                # The gradients ride with their block: after sp steps
                # each block's dk/dv is home.
                dk, dv = sp.rotate([dk, dv], tag=2).wait()
            if nxt is not None:
                kv = nxt.wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sp: SPGroup | None = None, causal: bool = True,
                   block_q: int = 0, block_k: int = 0,
                   window: int = 0) -> torch.Tensor:
    """Sequence-parallel attention over this process's slices: q (B,
    S_local, H, D), k/v (B, S_local, Hkv, D), the global sequence being
    the members' slices in ``sp`` order. Output as q. The blocks run the
    flash kernels when the shard is tile-friendly (the forward and the
    reverse ring), else the einsum reference. ``block_q``/``block_k``:
    flash tile overrides, which must divide the shard. ``window > 0``:
    sliding window in global positions (requires ``causal``); blocks
    behind it are skipped and only the diagonal block takes the
    kernels."""
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    _validate_tile_overrides(q, k, block_q, block_k)
    sp = sp or SPGroup()
    if sp.size == 1:
        # Degenerate ring: the single-process attention (on the card the
        # flash forward and its backward kernels).
        return dot_product_attention(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k,
                                     window=window)
    return _RingCore.apply(q, k, v, sp, causal,
                           _use_flash(q, k, block_q, block_k), window)

"""Pipeline parallelism over the ``pp`` mesh axis: the GPipe and the
interleaved schedules (port of ``parallel/pipeline.py``).

The decoder's stack is a stacked-layer pytree (leaves shaped ``(L, …)``),
so a pipeline is a schedule over layer chunks. Stage ``d`` of ``pp`` (a
process: its coordinate on ``pp``) runs the chunks the schedule gives it,
one microbatch at a time, and passes each chunk's output to the stage of
the next chunk:

- **GPipe**: ``M`` microbatches, ``M + pp - 1`` ticks; at tick ``t``
  stage ``d`` runs its ``L/pp`` layers on microbatch ``t - d``. Idle
  share ``(pp-1)/(M+pp-1)``.
- **Interleaved** (Megatron-style virtual stages): each stage owns ``v``
  non-contiguous chunks of ``L/(v·pp)`` layers; virtual stage ``s``
  lives on stage ``s % pp``, so the last stage hands each microbatch
  back to stage 0 between chunks, and the tables of
  ``_interleave_tables`` (a copy of the JAX package's) place microbatch
  ``m`` at virtual stage ``s`` on tick ``entry(m) + s``. A tick is one
  chunk, so the fill idles ``v`` times fewer device slots
  (``schedule_stats``).

The JAX package runs these ticks as one SPMD program inside
``shard_map`` (every device computes every tick, idle ones on masked
buffers) and differentiates it, ``ppermute`` transposing to the reverse
permute. Here each process walks its own list of actions
(``stage_actions``: tick, microbatch, virtual stage, the stage it
receives from and the one it sends to, from the same tables) and skips
its idle ticks:

- ``Pipeline.forward`` runs the ticks with no autograd graph. A stage
  keeps only each (microbatch, chunk)'s input, as JAX's checkpointed
  tick keeps its carry; ``cfg.remat`` does not apply inside a stage.
- ``Pipeline.backward`` walks the same ticks in reverse: it recomputes
  the chunk from its saved input with grad enabled, calls
  ``torch.autograd.backward`` on the output with the output's gradient
  (from the loss on the last virtual stage, else received from the
  stage of the next chunk), which accumulates the parameters'
  gradients, and sends the input's gradient to the stage of the
  previous chunk.
- Each tick's sends and receives are posted together
  (``batch_isend_irecv``) over the ``pp`` group, in both directions, so
  every exchange of tick ``t`` pairs with one of tick ``t`` on the
  neighbour and no order of stages can deadlock. On the card over a gloo
  group the tensors are staged through host memory
  (``parallel/staging.py``), counted in ``EXCHANGES`` with the host
  seconds spent waiting (``wait_s``, which the train step adds to its
  ``sync_s``).

Every stage holds every layer (the JAX package stores the stacked
params replicated over ``pp`` too, and only the computation is
pipelined), so a chunk indexes the global layers it owns and hands their
global ids to the body: nothing is permuted in storage, where JAX's
interleaved schedule gathers the stacked params into device order every
step. Each stage's parameter gradients are therefore partial (its own
layers' rows, and the embedding or the head on the first and last
stage): the trainer sums them over ``pp`` (``parallel/fsdp.py``).

``pipeline_apply`` is the port of JAX's function, with its body
signature ``body_fn(stage_params, layer_ids, x, mb_idx) -> (x, aux)``:
a differentiable function across the ``pp`` group whose output is the
last stage's, broadcast to every stage, and whose input and parameter
gradients are partial on each stage (their sum over ``pp`` is the
gradient).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.parallel.staging import through_host
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten

SCHEDULES = ("gpipe", "interleaved")

# What the pipeline's exchanges moved since the last reset: "exchanges"
# (ticks that posted a send or a receive), "sends", "bytes" sent,
# "staged_bytes" copied between the card and the host for a gloo group,
# "broadcasts" (loss and metrics from the last stage), and "wait_s",
# host seconds spent waiting for them.
EXCHANGES: collections.Counter = collections.Counter()


def schedule_stats(pp: int, num_microbatches: int, schedule: str,
                   virtual_stages: int = 2) -> dict:
    """Static schedule accounting in *chunk-tick* units (a chunk is
    ``L/(v·pp)`` layers; a GPipe tick costs ``v`` chunk-ticks so both
    schedules are measured in the same currency).

    Returns ticks, total device-slots, useful slots, and idle slots."""
    m = num_microbatches
    if schedule == "gpipe":
        ticks = (m + pp - 1) * virtual_stages
    elif schedule == "interleaved":
        # last microbatch enters at (g·v·pp + r) and takes v·pp ticks
        # (same arithmetic as _interleave_tables).
        g, r = divmod(m - 1, pp)
        ticks = g * virtual_stages * pp + r + virtual_stages * pp
    else:
        raise ValueError(f"unknown schedule '{schedule}'")
    slots = ticks * pp
    useful = m * virtual_stages * pp
    return {"ticks": ticks, "slots": slots, "useful": useful,
            "idle": slots - useful}


def _interleave_tables(pp: int, M: int, v: int) -> tuple:
    """Static (T, pp) tables for the interleaved schedule: microbatch
    index (−1 = idle), virtual stage (−1 = idle) per (tick, device).

    Microbatch ``m`` (group ``g = m // pp``, slot ``r = m % pp``) enters
    virtual stage 0 at tick ``g·v·pp + r`` and advances one virtual
    stage per tick; virtual stage ``s`` lives on device ``s % pp``. The
    group spacing guarantees at most one live buffer per device per
    tick (device d, tick t holds the unique in-flight m with
    ``t − e_m ≡ d (mod pp)``)."""
    S = v * pp
    entry = [(m // pp) * S + (m % pp) for m in range(M)]
    T = entry[-1] + S
    mb = -np.ones((T, pp), dtype=np.int32)
    vs = -np.ones((T, pp), dtype=np.int32)
    for m in range(M):
        for s in range(S):
            t = entry[m] + s
            d = s % pp
            assert mb[t, d] < 0, "schedule collision"
            mb[t, d] = m
            vs[t, d] = s
    return mb, vs


def _gpipe_tables(pp: int, M: int) -> tuple:
    """The GPipe wavefront in the same form: stage ``d`` runs microbatch
    ``t - d`` on tick ``t`` while ``0 <= t - d < M``; its virtual stage
    is ``d`` (one chunk a stage)."""
    T = M + pp - 1
    mb = -np.ones((T, pp), dtype=np.int32)
    vs = -np.ones((T, pp), dtype=np.int32)
    for t in range(T):
        for d in range(pp):
            if 0 <= t - d < M:
                mb[t, d], vs[t, d] = t - d, d
    return mb, vs


def interleave_layer_order(L: int, pp: int, v: int) -> np.ndarray:
    """Permutation placing global layer order into interleaved device
    storage: device d's local slice holds chunks (0·pp+d, 1·pp+d, ...)
    back to back. Entry j of the result is the global layer stored at
    stacked position j. (The port stores every layer on every stage and
    never permutes; the order names which layers each stage runs.)"""
    Lc = L // (v * pp)
    order = []
    for d in range(pp):
        for c in range(v):
            s = c * pp + d
            order.extend(range(s * Lc, (s + 1) * Lc))
    return np.asarray(order, dtype=np.int32)


def num_microbatches(batch: int, requested: int, data_shards: int = 1) -> int:
    """The JAX model's microbatch count for a global ``batch``: the
    largest ``m <= min(requested, batch)`` with ``batch % m == 0`` and
    ``(batch // m) % data_shards == 0`` (each microbatch still splits
    evenly over the data shards)."""
    return max(m for m in range(1, min(requested, batch) + 1)
               if batch % m == 0 and (batch // m) % data_shards == 0)


def split_microbatches(x: torch.Tensor, M: int) -> list:
    """The strided split: microbatch ``m`` holds rows ``m, m+M, m+2M, …``
    (a data shard's contiguous rows then give every microbatch the same
    share, as the JAX split keeps rows on their home device)."""
    return [x[m::M] for m in range(M)]


def merge_microbatches(parts: list) -> torch.Tensor:
    """The inverse of ``split_microbatches``."""
    return torch.stack(parts, dim=1).reshape(-1, *parts[0].shape[1:])


def check_pipeline(schedule: str, batch: int, M: int, L: int, pp: int,
                   virtual_stages: int) -> None:
    """JAX ``pipeline_apply``'s validation, in its words."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule '{schedule}' (expected {SCHEDULES})")
    if batch % M:
        raise ValueError(f"batch {batch} not divisible by microbatches {M}")
    if L % pp:
        raise ValueError(f"{L} layers not divisible by {pp} stages")
    if schedule == "interleaved" and L % (virtual_stages * pp):
        raise ValueError(
            f"{L} layers not divisible by virtual_stages*pp="
            f"{virtual_stages * pp}")


def num_chunks(pp: int, schedule: str, virtual_stages: int) -> int:
    """Virtual stages over the ring: ``pp`` for GPipe, ``v·pp``
    interleaved."""
    return pp if schedule == "gpipe" else virtual_stages * pp


def chunk_layers(L: int, pp: int, schedule: str, virtual_stages: int,
                 vstage: int) -> range:
    """The global layers of virtual stage ``vstage``."""
    n = L // num_chunks(pp, schedule, virtual_stages)
    return range(vstage * n, (vstage + 1) * n)


class Action(NamedTuple):
    """One busy tick of a stage: microbatch ``mb`` through virtual stage
    ``vstage``, its input received from stage ``recv_from`` (None: the
    first virtual stage injects it) and its output sent to stage
    ``send_to`` (None: the last virtual stage banks it)."""

    tick: int
    mb: int
    vstage: int
    recv_from: int | None
    send_to: int | None


def schedule_tables(pp: int, M: int, schedule: str,
                    virtual_stages: int) -> tuple:
    """The (T, pp) microbatch and virtual-stage tables of ``schedule``."""
    if schedule == "gpipe":
        return _gpipe_tables(pp, M)
    return _interleave_tables(pp, M, virtual_stages)


def stage_actions(pp: int, M: int, schedule: str, virtual_stages: int,
                  stage: int) -> list:
    """Stage ``stage``'s busy ticks in order, from the schedule's
    tables."""
    mb, vs = schedule_tables(pp, M, schedule, virtual_stages)
    last = num_chunks(pp, schedule, virtual_stages) - 1
    out = []
    for t in range(mb.shape[0]):
        m, s = int(mb[t, stage]), int(vs[t, stage])
        if m < 0:
            continue
        out.append(Action(t, m, s, (s - 1) % pp if s > 0 else None,
                          (s + 1) % pp if s < last else None))
    return out


class PPGroup:
    """This process's ``pp`` group: its size, this process's stage (its
    coordinate on ``pp``) and the world ranks of the stages in order.
    ``group=None`` is a group of one (no process group)."""

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

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    @property
    def is_last(self) -> bool:
        return self.rank == self.size - 1

    def exchange(self, send: tuple | None, recv: tuple | None):
        """One tick's exchange: ``send`` = (tensor, stage) goes to that
        stage, ``recv`` = (stage, shape, dtype, device) is received from
        it; both posted together. Returns the received tensor (on
        ``device``) or None."""
        if send is None and recv is None:
            return None
        t0 = time.perf_counter()
        ops, keep, buf, back = [], [], None, None
        if send is not None:
            t, to = send
            t = t.detach().contiguous()
            nbytes = t.numel() * t.element_size()
            if through_host(t, self.backend):
                t = t.cpu()
                EXCHANGES["staged_bytes"] += nbytes
            keep.append(t)
            ops.append(dist.P2POp(dist.isend, t, self.ranks[to], self.group))
            EXCHANGES["sends"] += 1
            EXCHANGES["bytes"] += nbytes
        if recv is not None:
            frm, shape, dtype, device = recv
            back = torch.device(device)
            staged = through_host(back, self.backend)
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if staged else back)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[frm],
                                  self.group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        EXCHANGES["exchanges"] += 1
        if buf is not None and buf.device != back:
            EXCHANGES["staged_bytes"] += buf.numel() * buf.element_size()
            buf = buf.to(back)
        EXCHANGES["wait_s"] += time.perf_counter() - t0
        return buf

    def _collective(self, t: torch.Tensor, fn) -> torch.Tensor:
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        host = through_host(t, self.backend)
        buf = t.detach().cpu() if host else t.detach().clone()
        fn(buf)
        EXCHANGES["wait_s"] += time.perf_counter() - t0
        return buf.to(t.device) if host else buf

    def broadcast_from_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last stage's ``t`` on every stage (``t`` gives the shape
        and dtype elsewhere)."""
        EXCHANGES["broadcasts"] += 1
        return self._collective(t, lambda b: dist.broadcast(
            b, src=self.ranks[-1], group=self.group))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the stages."""
        return self._collective(t, lambda b: dist.all_reduce(
            b, group=self.group))


class Pipeline:
    """One run of the schedule on this stage.

    ``run_chunk(vstage, x, mb) -> (y, aux)`` applies virtual stage
    ``vstage``'s layers to microbatch ``mb``'s activation ``x``.
    ``forward`` saves each action's input and nothing else (``saved``);
    ``backward`` consumes them."""

    def __init__(self, pp: PPGroup, run_chunk: Callable, num_microbatches: int,
                 schedule: str = "gpipe", virtual_stages: int = 2):
        self.pp = pp
        self.run_chunk = run_chunk
        self.M = num_microbatches
        self.actions = stage_actions(pp.size, num_microbatches, schedule,
                                     virtual_stages, pp.rank)
        self._by_tick = {a.tick: a for a in self.actions}
        self._ticks = schedule_tables(pp.size, num_microbatches, schedule,
                                      virtual_stages)[0].shape[0]
        self.saved: dict = {}

    def forward(self, inputs: list | None, like: tuple) -> tuple:
        """Run the ticks with no graph. ``inputs``: the M microbatch
        activations on the stage of virtual stage 0 (None elsewhere);
        ``like``: (shape, dtype, device) of one. Returns (outputs, aux):
        the M final activations on the last stage (None elsewhere) and
        this stage's summed aux."""
        shape, dtype, device = like
        outs: list = [None] * self.M
        aux = torch.zeros((), dtype=torch.float32, device=device)
        got = None
        for t in range(self._ticks):
            a = self._by_tick.get(t)
            send = None
            if a is not None:
                x = inputs[a.mb] if a.recv_from is None else got
                self.saved[(a.mb, a.vstage)] = x
                with torch.no_grad():
                    y, part = self.run_chunk(a.vstage, x, a.mb)
                aux = aux + part
                if a.send_to is None:
                    outs[a.mb] = y
                else:
                    send = (y, a.send_to)
            nxt = self._by_tick.get(t + 1)
            recv = (None if nxt is None or nxt.recv_from is None
                    else (nxt.recv_from, shape, dtype, device))
            got = self.pp.exchange(send, recv)
        return (outs if any(o is not None for o in outs) else None), aux

    def backward(self, grads: list | None, like: tuple,
                 g_aux: torch.Tensor | None = None) -> list | None:
        """The ticks in reverse: each action's chunk recomputed from its
        saved input with grad, ``torch.autograd.backward`` from its
        output's gradient (``grads[mb]`` on the last virtual stage, else
        received), the input's gradient sent back. ``g_aux``: the aux
        sum's gradient, applied to every chunk whose aux carries one.
        Returns the M input gradients on the stage of virtual stage 0
        (None elsewhere)."""
        shape, dtype, device = like
        g_inputs: list = [None] * self.M
        got = None
        for t in reversed(range(self._ticks)):
            a = self._by_tick.get(t)
            send = None
            if a is not None:
                g = grads[a.mb] if a.send_to is None else got
                x = self.saved.pop((a.mb, a.vstage)).detach()
                x.requires_grad_()
                with torch.enable_grad():
                    y, part = self.run_chunk(a.vstage, x, a.mb)
                outs, gs = [y], [g]
                if g_aux is not None and part.requires_grad:
                    outs.append(part)
                    gs.append(g_aux.to(part.dtype))
                torch.autograd.backward(outs, gs)
                if a.recv_from is None:
                    g_inputs[a.mb] = x.grad
                else:
                    send = (x.grad, a.recv_from)
            prv = self._by_tick.get(t - 1)
            recv = (None if prv is None or prv.send_to is None
                    else (prv.send_to, shape, dtype, device))
            got = self.pp.exchange(send, recv)
        return (g_inputs if any(g is not None for g in g_inputs) else None)


class _PipelineApply(torch.autograd.Function):
    """``pipeline_apply``'s forward and backward schedules."""

    @staticmethod
    def forward(ctx, body_fn, rebuild, pp, M, schedule, v, x, *leaves):
        L = leaves[0].shape[0]
        det = [w.detach().requires_grad_(w.requires_grad) for w in leaves]
        layer_ids = torch.arange(L, dtype=torch.int32, device=x.device)

        def run_chunk(s, xb, mb):
            r = chunk_layers(L, pp.size, schedule, v, s)
            return body_fn(rebuild([w[r.start:r.stop] for w in det]),
                           layer_ids[r.start:r.stop], xb, mb)

        pipe = Pipeline(pp, run_chunk, M, schedule, v)
        like = ((x.shape[0] // M, *x.shape[1:]), x.dtype, x.device)
        outs, aux = pipe.forward(
            split_microbatches(x.detach(), M) if pp.is_first else None, like)
        out = merge_microbatches(outs) if pp.is_last else torch.empty_like(x)
        out = pp.broadcast_from_last(out)
        aux = pp.sum(aux)
        ctx.pipe, ctx.det, ctx.like, ctx.x_like = pipe, det, like, x
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        pipe, pp = ctx.pipe, ctx.pipe.pp
        g_aux = pp.broadcast_from_last(g_aux.float())
        g_in = pipe.backward(
            split_microbatches(g_out, pipe.M) if pp.is_last else None,
            ctx.like, g_aux)
        x = ctx.x_like
        gx = (merge_microbatches(g_in) if g_in is not None
              else torch.zeros_like(x))
        grads = [None if not w.requires_grad
                 else w.grad if w.grad is not None else torch.zeros_like(w)
                 for w in ctx.det]
        return (None, None, None, None, None, None, gx, *grads)


def pipeline_apply(body_fn: Callable, stacked_params, x: torch.Tensor,
                   pp: PPGroup | None, num_microbatches: int,
                   schedule: str = "gpipe",
                   virtual_stages: int = 2) -> tuple:
    """Apply ``body_fn`` (one chunk's layers over one microbatch:
    ``(stage_params, layer_ids, x, mb_idx) -> (x, aux)``) as a pipeline
    over the ``pp`` group, the JAX ``pipeline_apply``.

    ``x``: (B, S, D) activations, B divisible by ``num_microbatches``
    (each stage passes its own; stage 0's is the one that enters).
    ``stacked_params``: a tensor or a dict tree of tensors with the
    leading layer dim on every leaf; ``stage_params`` are a chunk's rows of it and ``layer_ids``
    their global indices. Returns ``(x_out, aux_sum)``: the last stage's
    output broadcast to every stage, and the aux summed over every chunk
    and microbatch. Differentiable: the gradient of ``x_out`` is read on
    the last stage, and each stage's input and parameter gradients hold
    its own chunks' part (sum them over ``pp``)."""
    pp = pp or PPGroup()
    if isinstance(stacked_params, dict):
        flat = flatten(stacked_params)
        leaves = list(flat.values())

        def rebuild(ws):
            return unflatten(dict(zip(flat, ws)))
    else:
        leaves = [stacked_params]

        def rebuild(ws):
            return ws[0]
    check_pipeline(schedule, x.shape[0], num_microbatches,
                   leaves[0].shape[0], pp.size, virtual_stages)
    return _PipelineApply.apply(body_fn, rebuild, pp, num_microbatches,
                                schedule, virtual_stages, x, *leaves)

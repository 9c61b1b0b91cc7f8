"""Prefill/decode disaggregation: two plans, one weight store (port of
``serving/disagg.py``).

- the int8 weight-only layout: ``quantize_params_int8`` and
  ``quantized_weight_bytes`` over the sites of ``_QUANT_AXES`` (which
  the models layer keeps, beside ``cast_for_compute``). Each matmul
  weight of the stacked layers becomes ``{"qw": int8, "scale": f32}``
  with one scale per output channel, and the engine dequantizes it at
  compute, one layer at a time (``serving/engine.py::_w``);
- ``WeightStore``: a consolidated artifact loaded once to the host, its
  quantization stamp and its plan provenance checked against the
  committed plan (``ProvenanceError``, which ``Engine.swap_weights``
  also raises for a publish whose stamp differs), handed to any
  engine's device by ``params_for``;
- the KV handoff: ``export_kv``/``export_kv_batch`` (a batch of
  sequences' dense KV from their own pages, gathered over a mesh's
  processes) and ``import_kv``/``import_kv_batch`` (one scatter per
  pool);
- ``engine_config_for_plan``, the one engine geometry a plan implies,
  and ``DisaggPipeline``: prompts prefill on one engine under the
  prefill plan, their KV is handed to another under the decode plan,
  and decode ends there.

The JAX pipeline drives two meshes from one process. The port runs one
process per mesh rank: either one process holds both engines (each plan
at a mesh of 1; the card's form, where the handoff stays on the device),
or the world is cut into a prefill slice and a decode slice
(``runtime.slice_runtime``) and the KV crosses from the one to the other
by broadcasts that every process of the world enters in one order.
``plan_shardings``/``place_params`` and the serving verifier build jax
shardings or XLA programs and wait for ROADMAP.md queue A item 17; the
engine cuts its rank's weights with the trainer's placements
(``serving/engine.py::_rank_params``), which equal the plans'.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from distributed_training_tpu_torch.models.transformer import (
    _QUANT_AXES,
    _is_quant_leaf,
)
from distributed_training_tpu_torch.parallel import planner
from distributed_training_tpu_torch.runtime import MeshSpec, resolve_device
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten

logger = logging.getLogger(__name__)


class ProvenanceError(ValueError):
    """Plan provenance contradicts the committed plan or the engine's."""


def _quantize_leaf(w: torch.Tensor, axes: tuple[int, ...]) -> dict:
    """Symmetric per-channel int8: ``qw * scale ≈ w`` with one f32 scale
    per output channel (keepdims, broadcast at dequant). An all-zero
    channel keeps scale 1.0. ``torch.round`` rounds half to even, as
    ``np.round`` does."""
    w = w.detach().float()
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"qw": qw, "scale": scale}


def quantize_params_int8(params: dict) -> dict:
    """The int8 weight-only layout of a serving weight tree: every
    ``_QUANT_AXES`` site becomes a ``{"qw", "scale"}`` leaf on the
    weight's device; everything else passes through untouched."""
    out = dict(params)
    for (grp, name), axes in _QUANT_AXES.items():
        if grp not in out or name not in out[grp]:
            continue
        sub = dict(out[grp])
        sub[name] = _quantize_leaf(sub[name], axes)
        out[grp] = sub
    return out


def quant_leaves(tree: dict, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` over a weight tree, a ``{"qw", "scale"}`` dict
    counted as one leaf, in sorted key order."""
    out = {}
    for k, v in sorted(tree.items()):
        path = f"{prefix}{k}"
        if isinstance(v, dict) and not _is_quant_leaf(v):
            out.update(quant_leaves(v, path + "/"))
        else:
            out[path] = v
    return out


def quantized_weight_bytes(params: dict) -> dict:
    """``{"fp32": bytes, "int8": bytes}`` of a (possibly quantized)
    weight tree: a quant leaf counts 4 bytes an element as f32 and its
    ``qw`` and ``scale`` bytes as int8."""
    fp32 = int8 = 0
    for leaf in quant_leaves(params).values():
        if _is_quant_leaf(leaf):
            fp32 += 4 * leaf["qw"].numel()
            int8 += (leaf["qw"].numel() * leaf["qw"].element_size()
                     + leaf["scale"].numel() * leaf["scale"].element_size())
        else:
            n = leaf.numel() * leaf.element_size()
            fp32 += n
            int8 += n
    return {"fp32": fp32, "int8": int8}


# ---------------------------------------------------------------------------
# KV handoff
# ---------------------------------------------------------------------------


def export_kv(cache, seq_id) -> tuple:
    """A sequence's KV as dense CPU tensors (L, Hkv, len, hd)."""
    k, v = export_kv_batch(cache, [seq_id])
    return k[0], v[0]


def export_kv_batch(cache, seq_ids, group=None, to_host: bool = True
                    ) -> tuple[list, list]:
    """Dense KV of many sequences, ``(ks, vs)``: lists of (L, Hkv, len_i,
    hd) tensors, views of one block per pool; ``export_kv`` is this with
    a batch of one. Only the sequences' own pages move
    (``PagedKVCache.gather_pages``), never the whole pool: on the host
    (``to_host``) in one transfer per pool, else left on the device.

    On a mesh of more than one process (``group``: the process group
    over the mesh, ranks dp-major over (dp, tp)) a process holds only its
    dp group's pool at its tp rank's kv heads: each gathers its group's
    pages of the batch, padded to the largest group's count, and one
    all-gather over ``group`` gives every process every sequence's KV at
    every head, so the export is the same on every process."""
    if not seq_ids:
        return [], []
    ps = cache.cfg.page_size
    pages_of, lens = [], []
    for sid in seq_ids:
        n = cache.length(sid)
        pages_of.append((cache.group_of(sid),
                         cache.page_row(sid)[:-(-n // ps) if n else 0]
                         .astype(np.int64)))
        lens.append(n)
    if group is None:
        groups = np.concatenate([np.full(len(p), g, np.int64)
                                 for g, p in pages_of])
        blocks = {None: cache.gather_pages(
            groups, np.concatenate([p for _g, p in pages_of]), to_host)}
        key = [None] * len(seq_ids)
    else:
        blocks = _gather_group_blocks(cache, pages_of, group, to_host)
        key = [g for g, _p in pages_of]
    ks, vs = [], []
    offs = dict.fromkeys(blocks, 0)
    for (_g, p), n, b in zip(pages_of, lens, key):
        for src, dst in zip(blocks[b], (ks, vs)):
            part = src[:, :, offs[b]:offs[b] + len(p)]
            dst.append(part.reshape(*part.shape[:2], len(p) * ps,
                                    part.shape[-1])[:, :, :n])
        offs[b] += len(p)
    return ks, vs


def _gather_group_blocks(cache, pages_of: list, group, to_host: bool
                         ) -> dict:
    """``{dp group: (k, v)}``, each (L, Hkv, pages, ps, hd): the pages of
    ``pages_of`` of each group, in batch order, at every kv head, from one
    all-gather over the mesh's processes."""
    G = cache.cfg.dp_groups
    tp = dist.get_world_size(group) // G
    by_group = [np.concatenate([np.zeros(0, np.int64)]
                               + [p for g, p in pages_of if g == gg])
                for gg in range(G)]
    width = max(len(p) for p in by_group)
    mine = cache.local_group or 0
    k, v = cache.gather_pages(np.full(len(by_group[mine]), mine, np.int64),
                              by_group[mine], to_host=False)
    kv = torch.stack([k, v])
    kv = F.pad(kv, (0, 0, 0, 0, 0, width - kv.shape[3]))
    parts = [torch.empty_like(kv) for _ in range(G * tp)]
    dist.all_gather(parts, kv.contiguous(), group=group)
    out = {}
    for gg in range(G):
        whole = torch.cat(parts[gg * tp:(gg + 1) * tp], dim=2)
        whole = whole[:, :, :, :len(by_group[gg])]
        out[gg] = tuple(whole.cpu() if to_host else whole)
    return out


def import_kv(cache, seq_id, k, v) -> None:
    """Write dense (L, Hkv, len, hd) KV into ``seq_id``'s pages (already
    joined; pages are ensured here, in its own group)."""
    import_kv_batch(cache, [(seq_id, k, v)])


def import_kv_batch(cache, items) -> None:
    """Batched page-granular import of ``(seq_id, k, v)`` dense KV
    triples (every sequence already joined): every page of every
    sequence lands in one scatter per pool. Raises when a sequence's
    group cannot hold it, before the scatter: nothing is written and no
    cursor advances, but earlier items' pages stay allocated (``ensure``
    is atomic per sequence); the caller frees every item and retries, as
    ``Engine.adopt_batch`` does."""
    ps = cache.cfg.page_size
    todo = []
    for seq_id, k, v in items:
        n = k.shape[2]
        if n == 0:
            continue
        if not cache.ensure(seq_id, n):
            raise RuntimeError(
                f"KV import for {seq_id!r}: destination pool cannot hold "
                f"{n} positions")
        todo.append((seq_id, torch.as_tensor(k), torch.as_tensor(v), n))
    if not todo:
        return
    groups, pages, k_chunks, v_chunks = [], [], [], []
    for seq_id, k, v, n in todo:
        npg = -(-n // ps)
        for src, dst in ((k, k_chunks), (v, v_chunks)):
            src = src.to(cache.device)
            pad = src.new_zeros((*src.shape[:2], npg * ps, src.shape[3]))
            pad[:, :, :n] = src
            dst.append(pad.reshape(*src.shape[:2], npg, ps, src.shape[3]))
        groups += [cache.group_of(seq_id)] * npg
        pages += cache._tables[seq_id][:npg]
    cache.scatter_pages(np.asarray(groups, np.int64),
                        np.asarray(pages, np.int64),
                        torch.cat(k_chunks, dim=2), torch.cat(v_chunks, dim=2))
    for seq_id, _k, _v, n in todo:
        cache.advance(seq_id, n)


# ---------------------------------------------------------------------------
# The weight store
# ---------------------------------------------------------------------------


class WeightStore:
    """One consolidated artifact (``checkpoint/consolidate.py``), loaded
    once to host memory and handed to any number of engines.

    An unknown ``meta["quantization"]`` stamp is refused. Provenance: an
    artifact stamped ``meta["sharding_plan"] = {"name", "fingerprint"}``
    (``checkpoint/export.py``) is refused with ``ProvenanceError`` when
    the committed plan of that name no longer loads or now has another
    fingerprint; an artifact without the stamp loads with a warning."""

    def __init__(self, artifact_path: str):
        from distributed_training_tpu_torch.checkpoint.consolidate import (
            load_consolidated,
        )

        state, meta = load_consolidated(artifact_path)
        self.path = artifact_path
        self.meta = meta
        self.state = state
        self.params = state["params"] if "params" in state else state
        self.quantization = str((meta or {}).get("quantization", "none"))
        if self.quantization not in ("none", "int8"):
            raise ValueError(
                f"artifact {artifact_path} stamps unknown quantization "
                f"'{self.quantization}' (supported: none, int8)")
        self._check_provenance()

    def _check_provenance(self) -> None:
        prov = self.meta.get("sharding_plan")
        if not prov:
            logger.warning(
                "artifact %s carries no sharding-plan provenance (legacy "
                "or foreign export) — serving layout cannot be "
                "cross-checked against the training plan", self.path)
            return
        name = prov.get("name")
        try:
            committed = planner.load_plan(name)
        except (planner.PlanError, FileNotFoundError) as e:
            raise ProvenanceError(
                f"artifact {self.path} was exported from plan '{name}', "
                f"which no longer loads ({e}) — re-export from a run on a "
                "committed plan") from e
        if committed.fingerprint() != prov.get("fingerprint"):
            raise ProvenanceError(
                f"artifact {self.path} was exported from plan "
                f"'{name}'@{prov.get('fingerprint')}, but the committed "
                f"plan is now @{committed.fingerprint()} — the plan was "
                "regenerated since export; re-export the checkpoint (or "
                "restore the plan) rather than serving weights under a "
                "layout that does not match their provenance")

    @property
    def provenance(self) -> dict | None:
        """The artifact's plan stamp ``{"name", "fingerprint"}`` (None
        without one): the baseline ``Engine.swap_weights`` gates every
        later publish against."""
        prov = (self.meta or {}).get("sharding_plan")
        return dict(prov) if prov else None

    def params_for(self, mesh, plan, device=None) -> dict:
        """The whole weights on ``device`` (None: the CUDA card) for an
        engine under ``plan`` on ``mesh`` (a ``Runtime``; None for one
        process, at the plan's mesh of 1). The plan must name every leaf
        and its mesh must be the runtime's; the engine keeps its rank's
        block (``_rank_params``) and frees the rest."""
        planner.check_plan_runtime(
            plan, mesh.spec if mesh is not None else MeshSpec(),
            elastic=False)
        planner.PlannedStrategy(plan=plan).specs_for_tree(
            quant_leaves(self.params), {})
        device = resolve_device(device)
        return unflatten({k: t.to(device)
                          for k, t in flatten(self.params).items()})


# ---------------------------------------------------------------------------
# The disaggregated pipeline
# ---------------------------------------------------------------------------


def engine_config_for_plan(plan, page_size: int = 16,
                           prefill_chunk: int = 16,
                           prefill_mode: str = "batched",
                           spec_k: int = 1, resident_k: int = 1):
    """The one engine geometry a plan implies (the JAX function's):
    ``batch_per_shard`` aggregate slots dealt over the plan's dp groups,
    each group's pool sized so its slots fit at full length, grown to
    its share of the plan's ``kv_pool_tokens`` when the plan's score
    records one."""
    from distributed_training_tpu_torch.serving.engine import EngineConfig

    slots = plan.batch_per_shard
    dp = plan.mesh.get("dp", 1)
    if slots % dp:
        raise ValueError(
            f"plan '{plan.name}': batch_per_shard ({slots}) does not deal "
            f"over dp={dp} — the planner must not emit this (slots%dp "
            "feasibility)")
    pages_per_seq = -(-plan.seq_len // page_size)
    num_pages = (slots // dp) * pages_per_seq + 1
    pool_tokens = ((plan.provenance or {}).get("score") or {}).get(
        "kv_pool_tokens")
    if isinstance(pool_tokens, int) and pool_tokens > 0:
        num_pages = max(num_pages, -(-(pool_tokens // dp) // page_size) + 1)
    return EngineConfig(
        max_batch=slots, page_size=page_size, num_pages=num_pages,
        max_seq_len=plan.seq_len, prefill_chunk=prefill_chunk,
        prefill_mode=prefill_mode, spec_k=spec_k, resident_k=resident_k,
        kv_axis="tp", dp_axis="dp")


class DisaggPipeline:
    """Prefill on one engine, decode on another, one ``WeightStore``.

    ``prefill_ranks``/``decode_ranks``: the world ranks of each slice,
    two consecutive runs that cover the process group already
    initialized; this process runs the engine of its slice, over its
    plan's mesh (``runtime.slice_runtime``), and every process of the
    world calls ``generate_many`` with the same requests. Both None: this
    process holds both engines, each plan at a mesh of 1, on ``device``
    (None: the CUDA card), and the KV stays on the device.

    ``generate_many`` drives many requests through the pair, the
    handoffs of each engine step batched (``_handoff``); ``generate`` is
    one request."""

    def __init__(self, store: WeightStore, prefill_plan, decode_plan,
                 prefill_ranks=None, decode_ranks=None,
                 page_size: int = 16, prefill_chunk: int = 16,
                 device=None):
        from distributed_training_tpu_torch.runtime import slice_runtime
        from distributed_training_tpu_torch.serving.engine import Engine

        mk_p = planner.model_kwargs_for(prefill_plan)
        mk_d = planner.model_kwargs_for(decode_plan)
        if {k: v for k, v in mk_p.items() if k != "remat"} != \
                {k: v for k, v in mk_d.items() if k != "remat"}:
            raise ValueError(
                "prefill and decode plans describe different models — "
                "disaggregation requires one model, two layouts")
        self.device = resolve_device(device)
        self.model = planner.model_for_plan(decode_plan, device=self.device)
        plans = {"prefill": prefill_plan, "decode": decode_plan}
        meshes = {"prefill": None, "decode": None}
        if prefill_ranks is None and decode_ranks is None:
            for side, plan in plans.items():
                if math.prod(plan.mesh.values()) != 1:
                    raise ValueError(
                        f"{side} plan '{plan.name}' has mesh {plan.mesh}: "
                        "one process holds both engines only at a mesh of "
                        "1; pass prefill_ranks/decode_ranks for a world")
            self._first = None
            sides = ("prefill", "decode")
        else:
            ranks = {"prefill": list(prefill_ranks),
                     "decode": list(decode_ranks)}
            order = sorted(ranks, key=lambda side: ranks[side][0])
            if [r for side in order for r in ranks[side]] != list(
                    range(dist.get_world_size())):
                raise ValueError(
                    f"slices {ranks} are not consecutive runs of the "
                    f"world's {dist.get_world_size()} ranks")
            rt = slice_runtime([planner.plan_mesh_spec(plans[side])
                                for side in order], self.device)
            self._first = {side: ranks[side][0] for side in ranks}
            side = ("prefill" if dist.get_rank() in ranks["prefill"]
                    else "decode")
            meshes[side] = rt
            sides = (side,)
        self.prefill_engine = self.decode_engine = None
        for side in sides:
            plan = plans[side]
            engine = Engine(
                self.model, store.params_for(meshes[side], plan, self.device),
                engine_config_for_plan(plan, page_size, prefill_chunk),
                mesh=meshes[side], device=self.device)
            setattr(self, f"{side}_engine", engine)
        # KV handed over: engine steps that handed any, sequences, bytes.
        self.handoff_stats = {"steps": 0, "items": 0, "bytes": 0}

    def generate(self, prompt, max_new_tokens: int, req_id: str = "disagg",
                 tenant: str = "default") -> list[int]:
        """One request through the pair: its tokens."""
        from distributed_training_tpu_torch.serving.engine import Request

        req = Request(id=req_id, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, tenant=tenant)
        return self.generate_many([req])[req_id]

    def generate_many(self, requests, max_steps: int = 100_000) -> dict:
        """``{req_id: tokens}`` of ``requests`` through the pair, the same
        on every process. Each iteration: the prefill engine takes one
        step; every sequence that finished its prompt in it is exported
        in one batch and handed over (``_handoff``); the decode engine
        adopts what it can take in one batch (else one by one, holding
        the rest for the next iteration: backpressure, not failure) and
        takes one step."""
        pe, de = self.prefill_engine, self.decode_engine
        want = {r.id for r in requests}
        by_id = {r.id: r for r in requests}
        if pe is not None:
            for r in requests:
                pe.submit(r)
        held: list = []
        for _ in range(max_steps):
            ready, finished = [], {}
            if pe is not None:
                if not pe.idle:
                    pe.step()
                ready = [s for s in pe.slots
                         if s is not None and s.prefill_done]
                finished = {r["id"]: r["tokens"] for r in pe.completed
                            if r["id"] in want}
            items, finished = self._handoff(ready, finished, by_id)
            held += items
            done = None
            if de is not None:
                held = self._adopt(held)
                if not de.idle:
                    de.step()
                done = {r["id"]: r["tokens"] for r in de.completed
                        if r["id"] in want}
                done.update(finished)
                if not want <= set(done):
                    done = None
            done = self._from_decode(done)
            if done is not None:
                return {r.id: done[r.id] for r in requests}
        raise RuntimeError(
            f"disagg pipeline not drained after {max_steps} steps "
            f"({len(held)} handoff(s) held, prefill idle="
            f"{pe.idle if pe else None}, decode idle="
            f"{de.idle if de else None})")

    def _adopt(self, held: list) -> list:
        """Adopt ``held`` into the decode engine in one batch, else item by
        item; returns what is still held."""
        de = self.decode_engine
        if not held:
            return held
        try:
            de.adopt_batch(held)
            return []
        except RuntimeError:
            still = []
            for item in held:
                try:
                    de.adopt_batch([item])
                except RuntimeError:
                    still.append(item)
            return still

    def _handoff(self, ready: list, finished: dict, by_id: dict
                 ) -> tuple[list, dict]:
        """Export ``ready`` (the prefill engine's sequences that finished
        their prompt this step) in one batch, vacate them, and hand them
        with ``finished`` (requests that ended on the prefill engine) to
        the decode side: ``(items, finished)`` there, adopt_batch items
        ``(req, first token, k, v)``. In a world, the prefill slice's
        first process broadcasts them to every process."""
        items = []
        pe = self.prefill_engine
        if ready:
            ks, vs = pe.export_kv([s.req.id for s in ready],
                                  to_host=self._first is not None)
            for s, k, v in zip(ready, ks, vs):
                items.append((s.req, s.generated[0], k, v))
                pe.cache.free(s.req.id)
                pe.slots[s.slot] = None
        if self._first is not None:
            items, finished = self._broadcast_handoff(items, finished, by_id)
        if items:
            self.handoff_stats["steps"] += 1
            self.handoff_stats["items"] += len(items)
            self.handoff_stats["bytes"] += sum(
                t.numel() * t.element_size()
                for _r, _f, k, v in items for t in (k, v))
        return items, finished

    def _broadcast_handoff(self, items: list, finished: dict, by_id: dict
                           ) -> tuple[list, dict]:
        """The prefill slice's first process's ``items`` and ``finished``
        on every process of the world: one object broadcast of the ids,
        first tokens and lengths, then the KV of every item in one
        tensor."""
        src = self._first["prefill"]
        head = [[(r.id, int(t), k.shape[2]) for r, t, k, _v in items],
                finished]
        dist.broadcast_object_list(head, src=src)
        meta, finished = head
        total = sum(n for _i, _t, n in meta)
        if not total:
            return [], finished
        c = self.model.cfg
        if dist.get_rank() == src:
            kv = torch.cat([torch.stack([k, v]) for _r, _t, k, v in items],
                           dim=3).contiguous()
        else:
            kv = torch.empty((2, c.n_layers, c.n_kv_heads, total,
                              c.head_dim), dtype=getattr(torch, c.dtype))
        dist.broadcast(kv, src=src)
        out, off = [], 0
        for rid, tok, n in meta:
            out.append((by_id[rid], tok, kv[0, :, :, off:off + n],
                        kv[1, :, :, off:off + n]))
            off += n
        return out, finished

    def _from_decode(self, done: dict | None) -> dict | None:
        """The decode side's results once every request is done (None
        before), on every process: in a world, broadcast from the decode
        slice's first process."""
        if self._first is None:
            return done
        box = [done]
        dist.broadcast_object_list(box, src=self._first["decode"])
        return box[0]


"""Int8 weight-only leaves and the KV handoff primitives (port).

The part of ``distributed_training_tpu/serving/disagg.py`` that serving
weights and recovery need:

- the int8 weight-only layout: ``quantize_params_int8`` and
  ``quantized_weight_bytes`` over the sites of ``_QUANT_AXES`` (which
  the models layer keeps, beside ``cast_for_compute``). Each matmul weight of the stacked
  layers becomes ``{"qw": int8, "scale": f32}`` with one scale per
  output channel, and the engine dequantizes it at compute, one layer at
  a time (``serving/engine.py::_w``);
- ``ProvenanceError``, the refusal ``Engine.swap_weights`` raises for a
  publish whose plan provenance does not match the engine's;
- the KV handoff: ``export_kv``/``export_kv_batch`` (a batch of
  sequences' dense KV in one device-to-host transfer of their own pages)
  and ``import_kv``/``import_kv_batch`` (one scatter per pool).

``WeightStore``, the serving plans and ``DisaggPipeline`` wait for
ROADMAP.md queue A item 11 ('Serving: disaggregation').
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_training_tpu_torch.models.transformer import (
    _QUANT_AXES,
    _is_quant_leaf,
)


class ProvenanceError(ValueError):
    """A publish's plan provenance contradicts the engine's."""


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


def export_kv_batch(cache, seq_ids) -> tuple[list, list]:
    """Dense KV of many sequences in one device-to-host transfer per pool
    of their own pages (``PagedKVCache.gather_pages``, never the whole
    pool). Returns ``(ks, vs)``, lists of CPU (L, Hkv, len_i, hd)
    tensors (views of the transferred block); ``export_kv`` is this
    with a batch of one."""
    if not seq_ids:
        return [], []
    ps = cache.cfg.page_size
    pages_of, lens = [], []
    for sid in seq_ids:
        n = cache.length(sid)
        pages_of.append((cache.group_of(sid),
                         cache.page_row(sid)[:-(-n // ps) if n else 0]))
        lens.append(n)
    groups = np.concatenate([np.full(len(p), g, np.int64)
                             for g, p in pages_of])
    pages = np.concatenate([p for _g, p in pages_of]).astype(np.int64)
    k_all, v_all = cache.gather_pages(groups, pages)  # (L, Hkv, n, ps, hd)
    L, Hkv, _n, _ps, hd = k_all.shape
    ks, vs = [], []
    off = 0
    for (_g, p), n in zip(pages_of, lens):
        for src, dst in ((k_all, ks), (v_all, vs)):
            dst.append(src[:, :, off:off + len(p)]
                       .reshape(L, Hkv, len(p) * ps, hd)[:, :, :n])
        off += len(p)
    return ks, vs


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

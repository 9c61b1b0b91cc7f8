"""Weights from a seed, made on the device in one call.

The same function gives the program its starting weights and gives the
reference the same values again after the window, so neither side reads
the other's tensors. The layout is the decoder's usual pytree: stacked
``(L, ...)`` per-layer leaves under ``ln1``/``ln2``, ``attn.{wq, wk, wv,
wo}`` and ``mlp.{wi, bi, wo, bo}``, with ``tok_embed``, ``pos_embed``
(learned positions), ``final_norm`` and ``lm_head`` (untied head).
Matmul weights are normal with std 0.02, the two residual-out
projections 0.02 / sqrt(2 L) (GPT-2's scaled init); norms have unit
scales and zero biases; biases are zero.
"""

from __future__ import annotations

import math

import torch

STD = 0.02


def param_shapes(cfg: dict) -> dict:
    """Leaf shapes of the pytree for a configuration's run sizes."""
    L, D, F = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    H = cfg["n_heads"]
    Hkv = cfg.get("n_kv_heads") or H
    hd = D // H
    shapes = {
        "tok_embed": (cfg["vocab_rows"], D),
        "ln1": {"scale": (L, D), "bias": (L, D)},
        "ln2": {"scale": (L, D), "bias": (L, D)},
        "attn": {"wq": (L, D, H, hd), "wk": (L, D, Hkv, hd),
                 "wv": (L, D, Hkv, hd), "wo": (L, H, hd, D)},
        "mlp": {"wi": (L, D, F), "bi": (L, F), "wo": (L, F, D),
                "bo": (L, D)},
        "final_norm": {"scale": (D,), "bias": (D,)},
    }
    if cfg["pos_encoding"] == "learned":
        shapes["pos_embed"] = (cfg["max_seq_len"], D)
    if not cfg["tie_embeddings"]:
        shapes["lm_head"] = (D, cfg["vocab_rows"])
    return shapes


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The nested weight dict for ``cfg`` from ``seed``: one normal draw
    for every random leaf together, on ``device`` in f32, each leaf
    scaled and cast to ``dtype``."""
    shapes = _flat(param_shapes(cfg))
    normal = [k for k in shapes if not (k.endswith("/scale")
                                        or k.endswith("bias")
                                        or k in ("mlp/bi", "mlp/bo"))]
    sizes = [math.prod(shapes[k]) for k in normal]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    residual = STD / math.sqrt(2 * cfg["n_layers"])
    for k, n in zip(normal, sizes):
        std = residual if k in ("attn/wo", "mlp/wo") else STD
        out[k] = (draw[at:at + n].view(shapes[k]) * std).to(dtype)
        at += n
    del draw
    for k, shape in shapes.items():
        if k not in out:
            fill = 1.0 if k.endswith("/scale") else 0.0
            out[k] = torch.full(shape, fill, dtype=dtype, device=device)
    return nest(out)


def flat(tree: dict) -> dict:
    """``{"a/b": leaf}`` in sorted path order."""
    return _flat(tree)

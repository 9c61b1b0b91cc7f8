"""Device memory budget of training configs (port of
``utils/memory.py``).

Answers "will this config fit on this card?" before a run: params,
grads and optimizer state are exact from shapes; activations use the
JAX module's transformer accounting (per-layer residuals and block
internals, scaled by the remat policy), kept as it is so both packages
plan alike. ``state_bytes_per_device`` is the exact per-device
residency of a state tree under the port's placements
(``parallel/strategy.py::Placement``), which the HBM telemetry
(``telemetry/hbm.py``) carries beside the allocator's counters. The
planner's search over these numbers is ROADMAP.md queue A item 17's.

Estimates are per device: pass ``fsdp`` (and ``tp``) shard counts to see
the sharded footprint.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}

# Concurrent-copies multiplier on per-layer scan residuals, calibrated
# on a v5e OOM report (see estimate_transformer_memory docstring).
_SCAN_RESIDUAL_OVERHEAD = 2.0

# Known per-chip HBM capacities (GiB) for planning output.
HBM_GIB = {
    "v4": 32.0,
    "v5e": 16.0,
    "v5 lite": 16.0,
    "v5p": 95.0,
    "v6e": 32.0,
    "nvidia h100 80gb hbm3": 80.0,
}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    """Elements of a tree of tensors or of shape tuples."""
    return sum(math.prod(x.shape if hasattr(x, "shape") else x)
               for x in _leaves(params))


def state_bytes_per_device(tree, placements: dict | None = None,
                           sizes: dict | None = None,
                           device=None) -> int:
    """Exact per-device residency of a state tree (a dict of tensors):
    each leaf's bytes divided by the product of the mesh-axis sizes
    (``sizes``) its placement (``placements``, keyed by the flattened
    ``a/b`` path; None or missing: replicated) splits it over. With
    ``device``, a leaf held elsewhere counts zero (optimizer moments
    offloaded to host memory between steps).

    The model-agnostic cross-check the HBM telemetry carries beside the
    allocator's counters: a growing gap between this number and
    ``bytes_in_use`` is activations and caching, not state."""
    out = 0

    def walk(t, path):
        nonlocal out
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
            return
        if not isinstance(t, torch.Tensor):
            return
        if device is not None and t.device.type != torch.device(
                device).type:
            return
        nbytes = t.numel() * t.element_size()
        pl = (placements or {}).get(path)
        div = 1
        for axis in (pl.axes if pl is not None else ()):
            div *= (sizes or {}).get(axis, 1)
        out += -(-nbytes // div)

    walk(tree, "")
    return out


@dataclass
class MemoryEstimate:
    params_gib: float
    grads_gib: float
    opt_gib: float
    activations_gib: float

    @property
    def total_gib(self) -> float:
        return (self.params_gib + self.grads_gib + self.opt_gib
                + self.activations_gib)

    def fits(self, device_kind: str, headroom: float = 0.85) -> bool:
        """Whether the estimate fits in ``device_kind``'s HBM, leaving
        ``1 - headroom`` for allocator caching and fragmentation."""
        cap = HBM_GIB.get(device_kind.lower())
        if cap is None:
            raise ValueError(f"unknown device kind '{device_kind}'; "
                             f"known: {sorted(HBM_GIB)}")
        return self.total_gib <= cap * headroom


def estimate_transformer_memory(
        tf_cfg, batch_per_chip: int, seq_len: int,
        optimizer: str = "adamw", fsdp: int = 1, tp: int = 1,
        offload_opt: bool = False,
) -> MemoryEstimate:
    """Per-chip training footprint of a ``TransformerConfig``.

    - params/grads: n_params × dtype bytes, sharded over fsdp×tp;
    - optimizer: AdamW = two fp32 moments (+ fp32 master view is not
      kept — params are the master copy), SGD = none;
    - activations (per layer, batch B, seq S, width D, ffn F), as
      (saved-set coefficient) × ``_SCAN_RESIDUAL_OVERHEAD``. The two
      knobs encode ONE measurement jointly and must be recalibrated
      together: a v5e OOM report at B=16 (no remat) showed six live
      1.12 GiB [L,B,S,F] buffers — 3× the two logical F-wide saves,
      plus further D-wide copies below the report's top-20. The model
      here is: saved-set coefficients count logical saves ×2 for
      XLA's forward temporaries (F term: 2·F → 4·F), and the global
      ×2 overhead covers fwd-stack/bwd-consumption concurrency —
      jointly 8·F vs the ≥6·F observed live at peak, one notch
      conservative (a TPU measurement, kept so both packages plan
      alike; no card measurement has recalibrated it). Per policy (saved set before the global ×2):
        no remat:        6·D + 4·F
        remat mlp:       ≈ 8·D (everything but the F-wide MLP pair)
        remat selective: ≈ 3·D (residual + attention output)
        remat full:      ≈ 2·D (carry + saved input)
      plus the loss head: with ``loss_impl='dense'`` the B·S·V fp32
      logits buffer (often the true peak); with the default fused
      chunked xent (ops/xent.py) only a chunk_rows·V fp32 tile plus the
      per-token lse is ever alive.
    These are planning numbers, not allocator ground truth (the JAX
    module puts XLA's fusion and padding at ±20%; the port's eager
    temporaries are unmeasured against them).
    """
    c = tf_cfg
    pb = _BYTES[c.param_dtype]
    ab = _BYTES[c.dtype]
    d_ff = c.d_ff or 4 * c.d_model

    # Exact by construction: the model's own shape table.
    from distributed_training_tpu_torch.models.transformer import (
        param_shapes)
    n_params = param_count(param_shapes(c))

    model_shards = max(1, fsdp) * max(1, tp)
    params_b = n_params * pb / model_shards
    grads_b = n_params * pb / model_shards
    # offload_opt (train.offload_opt_state) moves moments to pinned
    # host RAM BETWEEN steps, but the current trainer streams the whole
    # tree back on-device for the compiled step (trainer.py
    # train_step), so the per-step peak this estimate feeds fits()
    # still includes the full optimizer state. Use
    # optimizer="adafactor" when the plan needs genuinely small moments.
    del offload_opt
    if optimizer == "adamw":
        opt_b = 2 * n_params * 4 / model_shards
    elif optimizer == "adafactor":
        # Factored second moment: rows+cols per matrix ≈ n_params /
        # min(dim); ~2% of params is a safe planning envelope.
        opt_b = 0.02 * n_params * 4 / model_shards
    else:  # sgd (no momentum)
        opt_b = 0.0

    B, S, D, F = batch_per_chip, seq_len, c.d_model, d_ff
    if not c.remat:
        act_per_layer = (6 * D + 4 * F) * B * S * ab
    elif c.remat_policy == "selective":
        act_per_layer = 3 * D * B * S * ab
    elif c.remat_policy == "mlp":
        act_per_layer = 8 * D * B * S * ab
    elif c.remat_policy == "mlp_pre":
        # "mlp" saves + the one F-wide pre-gelu tensor. The tag only
        # exists in the dense MLP branch: with MoE active the policy
        # degrades to "mlp" (transformer.py policy selection) and the
        # F-wide save must not be charged.
        moe = getattr(c, "moe_num_experts", 0)
        act_per_layer = (8 * D + (F if not moe else 0)) * B * S * ab
    else:  # full
        act_per_layer = 2 * D * B * S * ab
    acts_b = c.n_layers * act_per_layer * _SCAN_RESIDUAL_OVERHEAD
    if getattr(c, "loss_impl", "fused") == "dense":
        # fp32 logits + their softmax residual dominate.
        acts_b += B * S * c.vocab_size * 4 / max(1, tp)
    else:
        from distributed_training_tpu_torch.ops.xent import DEFAULT_CHUNK_ROWS
        acts_b += DEFAULT_CHUNK_ROWS * c.vocab_size * 4  # live tile
        acts_b += B * S * (4 + D * ab)  # lse + saved hidden states

    gib = 1 / (1024 ** 3)
    return MemoryEstimate(
        params_gib=params_b * gib,
        grads_gib=grads_b * gib,
        opt_gib=opt_b * gib,
        activations_gib=acts_b * gib,
    )

"""Optimizer construction (port of ``train/optimizer.py``).

Plain functions over the flat param dict that follow the JAX package's
optax chain step for step: ``clip_by_global_norm`` (when
``grad_clip_norm`` > 0), then ``sgd`` or ``adamw`` (decoupled weight
decay on the old params, ``eps`` outside the square root, bias
correction from the update count) scaled by the learning-rate schedule
(constant or cosine with floor ``alpha=0.1``, after a linear warmup that
gives lr 0 on the very first update). Every quantity the optax chain
computes in f32 is computed in f32 here.

``adafactor`` is ``optax.adafactor(lr, weight_decay_rate=,
weight_decay_mask=)`` step for step (optax's defaults otherwise):
``scale_by_factored_rms`` (decay ``1 - (count+1)^-0.8``, ``g² + 1e-30``;
a leaf is factored on the two largest dims of its global shape when both
are at least 128, so a stacked ``(L, D, F)`` leaf keeps its layer axis
in the statistics), ``clip_by_block_rms(1.0)`` per leaf, the learning
rate, ``scale_by_param_block_rms`` (``max(rms(param), 1e-3)``), the
masked decoupled decay (after the learning rate, so not scaled by it),
then the sign flip; all after ``clip_by_global_norm``.

The state is a dict: ``count`` (updates applied so far, a Python int,
so the schedule needs no device sync) plus ``mu``/``nu`` (AdamW) or
``v_row``/``v_col`` (factored leaves) and ``v`` (the others, shaped like
the param) for Adafactor, keyed like the params. Under a sharded
strategy each moment is this process's block: param-shaped moments are
laid out by the strategy's ``opt_spec``; a factored moment keeps the
param's split where it keeps the split dim and is whole (replicated over
the split's group) where it averaged over it (``factored_placements``).
Adafactor's row and column means and both block RMS sum over the split's
group first (``bind_layout``), as ``global_norm(groups=)`` does, so a
sharded update equals the whole one. The checkpoint saves the state as
it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.telemetry import collectives

# optax.adamw's default epsilon (outside the square root).
_EPS = 1e-8
# Leaf names that never decay under decay_mask="matrices", whatever their
# rank (stacked per-layer norms and biases are (L, D)).
_NO_DECAY_KEYS = frozenset({"b", "bi", "bo", "bias", "scale"})


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict of tensors → {"a/b": tensor} in sorted key order (a
    JAX pytree's leaf order, so sums over leaves add in the same
    order)."""
    out = {}
    for k, v in sorted(tree.items()):
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _f32(x) -> np.float32:
    return np.float32(x)


def build_schedule(cfg, total_steps: int):
    """count (int) → learning rate, evaluated in f32 as optax does."""
    base = _f32(cfg.learning_rate)
    if cfg.lr_schedule == "constant":
        def sched(count):
            return base
    elif cfg.lr_schedule == "cosine":
        decay_steps = _f32(max(total_steps - cfg.warmup_steps, 1))
        alpha = 0.1

        def sched(count):
            c = np.minimum(_f32(count), decay_steps)
            cosine = _f32(0.5) * (_f32(1) + np.cos(
                _f32(math.pi) * c / decay_steps))
            return base * (_f32(1 - alpha) * cosine + _f32(alpha))
    else:
        raise ValueError(f"unknown lr_schedule '{cfg.lr_schedule}'")
    if cfg.warmup_steps <= 0:
        return sched
    warmup = cfg.warmup_steps
    after = sched

    def joined(count):
        if count < warmup:
            # linear_schedule(0, base, warmup): lr 0 at count 0.
            frac = _f32(1) - _f32(min(max(count, 0), warmup)) / _f32(warmup)
            return (_f32(0) - base) * frac + base
        return after(count - warmup)
    return joined


def _matrices_mask(params: dict) -> dict:
    """path → decays? A leaf decays iff it is >= 2-D and its name is not
    a bias/scale name."""
    return {path: p.dim() >= 2 and path.rsplit("/", 1)[-1]
            not in _NO_DECAY_KEYS for path, p in params.items()}


def global_norm(tensors, groups=()) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32.

    One sum of squares per leaf, added in the order of ``tensors``.
    ``groups`` gives, leaf for leaf, the process group a tensor's leaf
    is split over (this process holds its block), or None for a leaf
    that is whole, or replicated on every process, and counts once. The
    sums of the leaves split over one group are summed over it first, in
    one all-reduce per group (in the order the groups first appear), so
    the norm equals the unsharded one on every process, and over groups
    of one equals it bit for bit."""
    sums = [torch.sum(t.float() ** 2) for t in tensors]
    by_group: dict = {}
    for i, g in enumerate(groups):
        if g is not None:
            by_group.setdefault(id(g), (g, []))[1].append(i)
    for group, idx in by_group.values():
        part = torch.stack([sums[i] for i in idx])
        dist.all_reduce(part, group=group)
        collectives.record("all-reduce", group, part)
        for j, i in enumerate(idx):
            sums[i] = part[j]
    return torch.sqrt(torch.as_tensor(sum(sums), dtype=torch.float32))


# optax.adafactor's defaults.
_FACTOR_MIN_DIM = 128
_FACTOR_DECAY = 0.8
_FACTOR_EPS = 1e-30
_BLOCK_RMS_CLIP = 1.0
_PARAM_MIN_RMS = 1e-3


def factored_dims(shape: tuple) -> tuple | None:
    """(d1, d0): the second-largest and largest dims of ``shape`` (numpy's
    argsort, as optax), or None when the leaf is not factored (fewer than
    two dims, or the second-largest under 128)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _without(pl, dim: int):
    """The placement of a moment that averaged ``pl``'s tensor over
    ``dim``: the other splits, their dims renumbered; None when none
    remains."""
    if pl is None:
        return None
    splits = tuple((d - (d > dim), axes) for d, axes in pl.splits
                   if d != dim)
    return type(pl)(splits) if splits else None


def factored_placements(shapes: dict, placements: dict) -> dict:
    """``{"v_row": {path: Placement | None}, "v_col": {...}}`` of the
    factored leaves of the flat global ``shapes``, whose param-shaped
    tensors sit at ``placements`` (the layout's ``opt``)."""
    out: dict = {"v_row": {}, "v_col": {}}
    for k, shape in shapes.items():
        fd = factored_dims(tuple(shape))
        if fd is not None:
            d1, d0 = fd
            out["v_row"][k] = _without(placements.get(k), d0)
            out["v_col"][k] = _without(placements.get(k), d1)
    return out


# The moments shaped like the params: AdamW's ``mu``/``nu``, Adafactor's
# ``v``.
PARAM_SHAPED_MOMENTS = ("mu", "nu", "v")


def moment_placements(state: dict, opt: dict, factored: dict) -> dict:
    """Each moment of an optimizer ``state`` with its placements: the
    param-shaped ones at ``opt`` (the layout's), Adafactor's factored
    ones at ``factored[name]`` (``Optimizer.factored_layout``)."""
    out = {n: opt for n in PARAM_SHAPED_MOMENTS if n in state}
    out.update({n: pls for n, pls in factored.items() if n in state})
    return out


def _split_dims(pl) -> dict:
    """dim → the mesh axes it is split over."""
    return dict(pl.splits) if pl is not None else {}


@dataclass
class Optimizer:
    """The optax chain as ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)`` over flat dicts
    of tensors (``params + updates`` is the new params)."""

    kind: str
    schedule: object
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.0
    decay_mask: str = "all"
    clip_norm: float = 0.0

    def __post_init__(self) -> None:
        # Adafactor over sharded tensors (bind_layout): each leaf's
        # global shape, the placement of the blocks update() is given,
        # and axes → process group.
        self._shapes: dict = {}
        self._placements: dict = {}
        self._group_of = None

    def bind_layout(self, shapes: dict, placements: dict, group_of) -> None:
        """Name the global shape (flat ``shapes``) and placement of every
        leaf ``init``/``update`` will be given blocks of, and
        ``group_of(axes)``, the process group over mesh axes."""
        self._shapes = {k: tuple(v) for k, v in shapes.items()}
        self._placements = dict(placements)
        self._group_of = group_of

    def factored_layout(self, shapes: dict, placements: dict) -> dict:
        """The placements of the moments not shaped like the params, by
        name (``factored_placements`` for Adafactor; none for the
        others), given the flat global ``shapes`` and the param-shaped
        moments' ``placements``."""
        if self.kind != "adafactor":
            return {}
        return factored_placements(shapes, placements)

    def init(self, params: dict) -> dict:
        state: dict = {"count": 0}
        if self.kind == "adamw":
            state["mu"] = {k: torch.zeros_like(p) for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        elif self.kind == "adafactor":
            state.update(v_row={}, v_col={}, v={})
            for k, p in params.items():
                fd = factored_dims(self._shapes.get(k, tuple(p.shape)))
                if fd is None:
                    state["v"][k] = torch.zeros_like(p)
                    continue
                d1, d0 = fd
                shape = list(p.shape)
                state["v_row"][k] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                state["v_col"][k] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        return state

    def _mean(self, x: torch.Tensor, dims: tuple, splits: dict,
              full: tuple, keepdim: bool = False) -> torch.Tensor:
        """Mean of ``x`` (a block of a tensor of global shape ``full``
        split at ``splits``) over ``dims``; the local sums are summed over
        the group of the splits on those dims first."""
        axes = tuple(a for d in dims for a in splits.get(d, ()))
        if not axes:
            return x.mean(dim=dims, keepdim=keepdim)
        total = x.sum(dim=dims, keepdim=keepdim)
        group = self._group_of(axes)
        dist.all_reduce(total, group=group)
        collectives.record("all-reduce", group, total)
        return total / math.prod(full[d] for d in dims)

    def _adafactor(self, k: str, g: torch.Tensor, p: torch.Tensor,
                   state: dict, new: dict, decay_t: np.float32,
                   lr: float, decay: bool) -> torch.Tensor:
        """One leaf's Adafactor update (the optax chain after the global
        clip, sign flipped)."""
        full = self._shapes.get(k, tuple(p.shape))
        pl = self._placements.get(k)
        splits = _split_dims(pl)
        every = tuple(range(len(full)))
        keep, fresh = float(decay_t), float(_f32(1) - decay_t)
        gsq = g * g + _FACTOR_EPS
        fd = factored_dims(full)
        if fd is not None:
            d1, d0 = fd
            v_row = (keep * state["v_row"][k]
                     + fresh * self._mean(gsq, (d0,), splits, full))
            v_col = (keep * state["v_col"][k]
                     + fresh * self._mean(gsq, (d1,), splits, full))
            new["v_row"][k], new["v_col"][k] = v_row, v_col
            rd1 = d1 - 1 if d1 > d0 else d1
            row_full = full[:d0] + full[d0 + 1:]
            row_mean = self._mean(v_row, (rd1,),
                                  _split_dims(_without(pl, d0)), row_full,
                                  keepdim=True)
            u = (g * ((v_row / row_mean) ** -0.5).unsqueeze(d0)
                 * (v_col ** -0.5).unsqueeze(d1))
        else:
            v = keep * state["v"][k] + fresh * gsq
            new["v"][k] = v
            u = g * v ** -0.5
        rms = torch.sqrt(self._mean(u * u, every, splits, full))
        u = u / torch.clamp(rms / _BLOCK_RMS_CLIP, min=1.0)
        u = u * lr
        p_rms = torch.sqrt(self._mean(p * p, every, splits, full))
        u = u * torch.where(p_rms <= _PARAM_MIN_RMS,
                            torch.full_like(p_rms, _PARAM_MIN_RMS), p_rms)
        if self.weight_decay and decay:
            u = u + self.weight_decay * p
        return -u

    def update(self, grads: dict, state: dict, params: dict,
               gnorm: torch.Tensor | None = None) -> tuple[dict, dict]:
        """``gnorm``: the global norm of the whole gradient tree, for the
        clip; needed when ``grads`` are shards or slices of it."""
        count = state["count"]
        if self.clip_norm > 0:
            gn = global_norm(grads.values()) if gnorm is None else gnorm
            clip = torch.tensor(self.clip_norm, dtype=torch.float32,
                                device=gn.device)
            keep = gn < clip
            grads = {k: torch.where(keep, g, (g / gn.to(g.dtype)) * clip)
                     for k, g in grads.items()}
        lr = float(self.schedule(count))
        new = {"count": count + 1}
        if self.kind == "sgd":
            updates = {k: g * -lr for k, g in grads.items()}
            return updates, new
        decay = (_matrices_mask(params) if self.decay_mask == "matrices"
                 else dict.fromkeys(params, True))
        if self.kind == "adafactor":
            decay_t = _f32(1) - _f32(count + 1) ** _f32(-_FACTOR_DECAY)
            new.update(v_row={}, v_col={}, v={})
            updates = {k: self._adafactor(k, g, params[k], state, new,
                                          decay_t, lr, decay[k])
                       for k, g in grads.items()}
            return updates, new
        n = count + 1
        bc1 = float(_f32(1) - _f32(self.b1) ** n)
        bc2 = float(_f32(1) - _f32(self.b2) ** n)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS)
            if self.weight_decay and decay[k]:
                u = u + self.weight_decay * params[k]
            updates[k] = u * -lr
        new["mu"], new["nu"] = mu, nu
        return updates, new


def build_optimizer(cfg, total_steps: int) -> Optimizer:
    """The optimizer for a ``TrainConfig``, as the JAX
    ``build_optimizer``."""
    if cfg.decay_mask not in ("all", "matrices"):
        raise ValueError(f"unknown decay_mask '{cfg.decay_mask}' "
                         "(expected 'all' or 'matrices')")
    if cfg.optimizer not in ("sgd", "adamw", "adafactor"):
        raise ValueError(f"unknown optimizer '{cfg.optimizer}'")
    return Optimizer(kind=cfg.optimizer,
                     schedule=build_schedule(cfg, total_steps),
                     b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay,
                     decay_mask=cfg.decay_mask,
                     clip_norm=cfg.grad_clip_norm or 0.0)

"""Sharded storage and its collectives: the gather-for-compute of FSDP,
the gradient reduction of every strategy, and whole-leaf gathers.

In the JAX package XLA compiles these collectives from the strategy's
specs, and the trainer binds a constraint so that weights all-gather one
layer at a time for compute (``wants_gather_for_compute``). Here they
are explicit ``torch.distributed`` calls over the mesh's groups:

- ``GatherForCompute`` is the model's binding
  (``Transformer.bind_gather_for_compute``): a layer's local shards,
  cast to the compute dtype, are all-gathered over the ``fsdp`` group in
  the forward (one collective per dtype), and the backward
  reduce-scatters their gradients (summed over the group) back to the
  shards. A leaf split on two dims (``tp_fsdp``) is gathered on its fsdp
  dim only: its tp block stays local, for the tensor-parallel block.
  ``GATHERS`` counts the gathers: ``"layer"`` one per layer per forward,
  and one per top-level leaf name; ``TRAFFIC`` their bytes:
  ``"gathered_bytes"`` the whole tensors the all-gathers give, and
  ``"reduce_scattered_bytes"`` the whole gradients the backward
  reduce-scatters. Under MoE the experts' ``expert`` dim is stored split
  (expert parallelism), gathered and reduce-scattered like any other.
- ``average_grads`` sums every gradient over the data processes and
  divides by their count: an all-reduce over (dp, fsdp) for replicated
  leaves, over the axes a sharded leaf is replicated on (dp) for the
  shards the reduce-scatter left. Under sequence parallelism each sp
  member's gradient is its slice's part of its data shard's: the sum
  runs over ``sp`` too (every leaf is replicated over it), and the count
  stays the data shards'. Under pipeline parallelism each stage's
  gradient holds its own chunks' layers (and the embedding or the head
  on the first and last stage; a tied embedding gets both): every leaf
  is replicated over ``pp`` and its gradient summed over it, the count
  still the data shards'.
- ``local_view``/``shard``/``all_gather_dims``/``gather_full`` cut and
  rebuild whole leaves (the init, ZeRO-1's param slices, the
  consolidated export), one split after another.

Gradients under tensor parallelism (tp ranks take the same batch):

- a leaf split over tp: each rank's gradient is its own block's whole
  gradient; nothing is summed over tp;
- a leaf replicated over tp and used whole by every rank (layer-norm
  scales and biases, the MLP's ``bo``, ``pos_embed``): every tp rank
  computes the same gradient, because every activation gradient that
  reaches it is whole: ``copy_to_tp`` all-reduces the gradient of each
  column-parallel product's input (``parallel/tensor.py``). Nothing is
  summed over tp, and the replicas stay alike;
- a leaf replicated over tp of which each rank uses only a part (kv
  heads that tp does not divide, under GQA: a rank projects only the kv
  heads its query heads read; the layout's ``tp_partial``): each rank's
  gradient is partial, and ``average_grads`` sums it over tp.

A leaf's shard ``r`` along a split dim is the ``r``-th equal slice,
``r`` the process's rank in the split's group (its coordinate on the
split's mesh axes, dp-major).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.runtime import BATCH_AXES

# Gathers for compute launched since the last reset: "layer" counts one
# per layer per forward, a top-level leaf's name one per gather of it.
GATHERS: collections.Counter = collections.Counter()
TRAFFIC: collections.Counter = collections.Counter()


def _by_dtype(tensors: list) -> dict:
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def all_gather_dims(shards: list, dims: list, group) -> list:
    """Each shard whole along its dim, gathered over ``group``: one
    all-gather per dtype over the shards laid end to end."""
    n = dist.get_world_size(group)
    out: list = [None] * len(shards)
    for idx in _by_dtype(shards).values():
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        buf = flat.new_empty(n * flat.numel())
        # torch 2.11's name (later versions call it all_gather_single).
        dist.all_gather_into_tensor(buf, flat, group=group)
        buf = buf.view(n, -1)
        off = 0
        for i in idx:
            s, d = shards[i], dims[i]
            k = s.numel()
            full = list(s.shape)
            full[d] *= n
            out[i] = (buf[:, off:off + k].reshape((n, *s.shape))
                      .movedim(0, d).reshape(full))
            off += k
    return out


def reduce_scatter_dims(fulls: list, dims: list, group) -> list:
    """Each whole tensor summed over ``group`` and cut to this process's
    shard along its dim: one reduce-scatter per dtype."""
    n = dist.get_world_size(group)
    out: list = [None] * len(fulls)
    for idx in _by_dtype(fulls).values():
        parts, shapes = [], []
        for i in idx:
            g, d = fulls[i], dims[i]
            shp = list(g.shape)
            a = shp[d] // n
            parts.append(g.reshape(shp[:d] + [n, a] + shp[d + 1:])
                         .movedim(d, 0).reshape(n, -1))
            shapes.append(shp[:d] + [a] + shp[d + 1:])
        flat = torch.cat(parts, dim=1)
        buf = flat.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(buf, flat.reshape(-1), group=group)
        off = 0
        for i, part, shp in zip(idx, parts, shapes):
            k = part.shape[1]
            out[i] = buf[off:off + k].view(shp)
            off += k
    return out


class _Gather(torch.autograd.Function):
    """shards → whole tensors (all-gather over ``group``); gradients →
    shards (reduce-scatter, summed over the group)."""

    @staticmethod
    def forward(ctx, dims, group, *shards):
        ctx.dims, ctx.group = dims, group
        out = tuple(all_gather_dims(list(shards), list(dims), group))
        TRAFFIC["gathered_bytes"] += sum(t.numel() * t.element_size()
                                         for t in out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        TRAFFIC["reduce_scattered_bytes"] += sum(
            g.numel() * g.element_size() for g in grads)
        return (None, None, *reduce_scatter_dims(
            [g.contiguous() for g in grads], list(ctx.dims), ctx.group))


class GatherForCompute:
    """The model's gather binding over sharded storage.

    ``placements``: flat param path → ``Placement`` or None (the
    trainer's layout); ``layer_keys``: the top-level keys of the stacked
    ``(L, …)`` per-layer leaves, whose shard dim in a layer slice is one
    less than in storage. A leaf's data split must be over ``fsdp``
    alone, and never on the layer axis; a split over ``tp`` stays
    local."""

    def __init__(self, placements: dict, runtime, layer_keys: tuple):
        self.group = runtime.group(("fsdp",))
        self.layer_dims: dict = {}
        self.leaf_dims: dict = {}
        for path, pl in placements.items():
            data = [(d, axes) for d, axes in (pl.splits if pl else ())
                    if axes != ("tp",)]
            if not data:
                continue
            (dim, axes), = data
            if axes != ("fsdp",):
                raise ValueError(
                    f"{path}: gather-for-compute needs shards over fsdp "
                    f"alone, not {axes}")
            top, _, name = path.partition("/")
            if top in layer_keys:
                if dim == 0:
                    raise ValueError(
                        f"{path}: the layer axis is sharded; the gather "
                        "runs one layer at a time")
                self.layer_dims[(top, name)] = dim - 1
            else:
                self.leaf_dims[path] = dim

    def layer(self, layer: dict) -> dict:
        """A layer's weights (a nested dict of slices) whole."""
        keys = list(self.layer_dims)
        if not keys:
            return layer
        GATHERS["layer"] += 1
        fulls = _Gather.apply(tuple(self.layer_dims[kn] for kn in keys),
                              self.group, *[layer[k][n] for k, n in keys])
        out = {k: dict(ws) for k, ws in layer.items()}
        for (k, n), w in zip(keys, fulls):
            out[k][n] = w
        return out

    def leaf(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """A top-level leaf (``tok_embed``, ``final_norm/scale``, …)
        whole."""
        d = self.leaf_dims.get(name)
        if d is None:
            return w
        GATHERS[name] += 1
        return _Gather.apply((d,), self.group, w)[0]


def local_view(t: torch.Tensor, pl, runtime) -> torch.Tensor:
    """This process's block of the whole tensor ``t`` under placement
    ``pl``, as a view (``t`` itself when replicated)."""
    for dim, axes in (pl.splits if pl else ()):
        group = runtime.group(axes)
        a = t.shape[dim] // dist.get_world_size(group)
        t = t.narrow(dim, dist.get_rank(group) * a, a)
    return t


def shard(t: torch.Tensor, pl, runtime) -> torch.Tensor:
    """This process's shard of the whole tensor ``t`` under placement
    ``pl``, in storage of its own (``t`` itself when replicated or the
    group has one process)."""
    v = local_view(t, pl, runtime)
    return t if v.shape == t.shape else v.clone()


def gather_full(flat: dict, placements: dict, runtime) -> dict:
    """Every leaf of ``flat`` whole (collective on every process): each
    leaf's last split gathered first, one all-gather per split's axes
    (and dtype) in each round."""
    out = dict(flat)
    pending = {k: list(placements[k].splits) for k in flat
               if placements.get(k) is not None}
    while pending:
        by_axes: dict = {}
        for k, splits in pending.items():
            by_axes.setdefault(splits[-1][1], []).append(k)
        for axes, keys in by_axes.items():
            fulls = all_gather_dims([out[k].detach() for k in keys],
                                    [pending[k].pop()[0] for k in keys],
                                    runtime.group(axes))
            out.update(zip(keys, fulls))
        pending = {k: s for k, s in pending.items() if s}
    return out


def _all_reduce_flat(tensors: list, group) -> None:
    """Sum each tensor over ``group`` in place: one all-reduce per dtype
    over the tensors laid end to end."""
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def replica_axes(pl) -> tuple:
    """The axes a leaf under placement ``pl`` is replicated on whose
    processes hold parts of one gradient: ``pp`` and ``sp`` (no leaf is
    split over either) and the data axes it is not split over."""
    used = () if pl is None else pl.axes
    return tuple(a for a in ("pp", *BATCH_AXES, "sp") if a not in used)


def average_grads(grads: dict, placements: dict, runtime,
                  tp_partial=()) -> dict:
    """Gradients of each process's mean loss → gradients of the mean
    over all data processes, in place. Sharded leaves arrive already
    summed over their shard group (the gather's reduce-scatter); the
    leaves of ``tp_partial`` are also summed over tp (module docstring).

    Each data shard's loss arrives weighted by its share of the global
    batch's real tokens (``make_train_step``), so the mean over the data
    shards is the global mean."""
    sizes = runtime.spec.as_dict()
    by_axes: dict = {}
    for k, g in grads.items():
        axes = replica_axes(placements.get(k))
        if k in tp_partial:
            axes += ("tp",)
        if any(sizes[a] > 1 for a in axes):
            by_axes.setdefault(axes, []).append(g)
    for axes, gs in by_axes.items():
        _all_reduce_flat(gs, runtime.group(
            tuple(a for a in axes if sizes[a] > 1)))
    n = runtime.data_shard_count
    if n > 1:
        for g in grads.values():
            g.div_(n)
    return grads


def mean_over_data(values: dict, runtime) -> dict:
    """Scalar metrics averaged over the data processes (one all-reduce
    over the data axes: the ``pp``, ``sp`` and ``tp`` members of a data
    shard hold the same values and are not counted again)."""
    if runtime.data_shard_count <= 1 or not values:
        return values
    keys = sorted(values)
    v = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(v, group=runtime.group(BATCH_AXES))
    v = v / runtime.data_shard_count
    return dict(zip(keys, v.unbind()))

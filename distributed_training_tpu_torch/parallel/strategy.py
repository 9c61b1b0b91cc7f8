"""Sharding strategies (port of ``parallel/strategy.py``).

The spec producers are copies of the JAX package's: a strategy maps each
param leaf (its shape and the model's logical axis names) to a
PartitionSpec, here a plain tuple with one entry per dimension (``None``
= replicated, a mesh axis name, or a tuple of names), trailing ``None``
entries dropped as ``jax.sharding.PartitionSpec`` prints them.

- ``ddp``: params and moments replicated; gradients all-reduced over the
  data axes (dp, fsdp).
- ``zero1``: params replicated, Adam moments sharded over (dp, fsdp)
  jointly on their largest divisible dim (``opt_spec``).
- ``fsdp``: every large param sharded over ``fsdp`` on the dim its
  logical axes route there (``rules``), else its largest divisible dim.
- ``hybrid``: the fsdp specs over a mesh with dp > 1 (sharded within
  the fsdp groups, replicated across dp).
- ``tp`` and ``tp_fsdp``: Megatron-style tensor parallelism composed
  with FSDP (``TensorParallel``): the ``vocab``, ``mlp``, ``heads`` and
  ``kv`` dims split over ``tp``, ``embed`` over ``fsdp``, so a leaf may
  be split on two dims.

Every strategy lays its leaves out the same with ``sp`` in the mesh: no
rule names ``sp``, so no leaf is split over it, and the data axes
(ZeRO-1's moments, the batch) stay (dp, fsdp); the sp members of a data
shard hold the same leaves and sum their gradients
(``fsdp.average_grads``). The same holds for ``pp``: no rule names it,
so every stage stores every leaf (as the JAX package stores the stacked
params replicated over ``pp`` and pipelines only the computation), and
the stages sum their partial gradients; under ``fsdp`` each stage
gathers the layers of its own chunks from its fsdp group.

Where XLA compiles the collectives from these specs in the JAX package,
the port runs them itself: ``placement`` turns a spec into the dims and
the mesh axes each is split over, ``parallel/fsdp.py`` gathers,
reduce-scatters and all-reduces accordingly, and ``parallel/tensor.py``
holds the collectives of the tensor-parallel block.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import warnings
from typing import NamedTuple

from distributed_training_tpu_torch.runtime import BATCH_AXES

logger = logging.getLogger(__name__)

AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
Rules = dict[str, "str | tuple[str, ...] | None"]
Spec = tuple


def logical_to_spec(logical: tuple, rules: Rules) -> Spec:
    """Map per-dimension logical axis names → mesh axes via ``rules``.

    Unknown / None logical names replicate. A mesh axis may appear at most
    once in the result (the first use keeps it)."""
    assigned: list = []
    used: set[str] = set()
    for name in logical:
        axis = rules.get(name) if name is not None else None
        if axis is None:
            assigned.append(None)
            continue
        flat = (axis,) if isinstance(axis, str) else tuple(axis)
        if any(a in used for a in flat):
            assigned.append(None)
            continue
        used.update(flat)
        assigned.append(axis)
    while assigned and assigned[-1] is None:
        assigned.pop()
    return tuple(assigned)


def prune_spec(shape: tuple, spec: Spec, axis_sizes: dict[str, int],
               min_elems: int = 0) -> Spec:
    """Drop sharding assignments a given array can't honor: dims not
    divisible by the assigned mesh-axis size, and fsdp assignments on
    arrays too small to be worth a collective."""
    if len(spec) > len(shape):
        raise ValueError(
            f"logical axis annotation {tuple(spec)} has more dims than "
            f"the array of shape {shape} — fix the model's logical_axes")
    padded = list(spec) + [None] * (len(shape) - len(spec))
    small = math.prod(shape) < min_elems if shape else True
    out: list = []
    for d, a in enumerate(padded):
        if a is None:
            out.append(None)
            continue
        flat = (a,) if isinstance(a, str) else tuple(a)
        if any(x not in axis_sizes for x in flat):
            out.append(a)
            continue
        prod = math.prod(axis_sizes[x] for x in flat)
        if shape[d] % prod != 0:
            if prod > 1:
                logger.warning(
                    "dropping sharding %s on dim %d of %s: %d not "
                    "divisible by mesh axes product %d — param will be "
                    "replicated on %s", a, d, shape, shape[d], prod, flat)
            out.append(None)
        elif small and all(x == AXIS_FSDP for x in flat):
            out.append(None)
        else:
            out.append(a)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _largest_divisible_dim(shape: tuple, size: int,
                           min_elems: int) -> int | None:
    """The dimension FSDP shards: the largest one divisible by the axis
    size, for arrays big enough to be worth sharding."""
    if size <= 1 or math.prod(shape) < min_elems or len(shape) == 0:
        return None
    candidates = [(d, shape[d]) for d in range(len(shape))
                  if shape[d] % size == 0 and shape[d] >= size]
    if not candidates:
        return None
    return max(candidates, key=lambda t: (t[1], -t[0]))[0]


def _heuristic_spec(shape: tuple, size: int, axis,
                    min_elems: int) -> Spec:
    """``axis`` on the largest divisible dim, replicated otherwise."""
    dim = _largest_divisible_dim(shape, size, min_elems)
    if dim is None:
        return ()
    spec: list = [None] * len(shape)
    spec[dim] = axis
    return tuple(spec)


class Placement(NamedTuple):
    """Where a leaf's local block sits: for each ``(dim, axes)`` of
    ``splits`` (in dim order), dimension ``dim`` is split evenly over the
    processes of mesh ``axes``, in the order of their coordinates on
    those axes (dp-major). At most two splits: one over the data axes
    (``fsdp``, or ZeRO-1's (dp, fsdp)) and one over ``tp``."""

    splits: tuple[tuple[int, tuple[str, ...]], ...]

    @property
    def axes(self) -> tuple[str, ...]:
        """Every mesh axis the leaf is split over."""
        return tuple(a for _, axes in self.splits for a in axes)


def placement(spec: Spec) -> Placement | None:
    """The port's placement of a spec: None when replicated, else each
    sharded dim and the mesh axes it is split over. Raises for a spec
    the port cannot place: more than two sharded dims, two that are not
    one over ``tp`` and one over data axes, or ``tp`` joined with another
    axis on one dim."""
    splits = tuple((d, (a,) if isinstance(a, str) else tuple(a))
                   for d, a in enumerate(spec) if a is not None)
    if not splits:
        return None
    over_tp = [axes for _, axes in splits if AXIS_TP in axes]
    if (len(splits) > 2 or any(axes != (AXIS_TP,) for axes in over_tp)
            or len(splits) - len(over_tp) > 1):
        raise ValueError(
            f"spec {spec}: the port places at most one dim over tp alone "
            "and one over data axes")
    return Placement(splits)


@dataclasses.dataclass
class DataParallel:
    """DDP: params replicated on every process; batch split on
    (dp, fsdp); gradients all-reduced over both."""

    min_shard_elems: int = 2 ** 12
    gather_on_save: bool = False
    name: str = dataclasses.field(default="ddp", init=False)

    def param_spec(self, shape: tuple, logical: tuple | None) -> Spec:
        del shape, logical
        return ()

    def opt_spec(self, shape: tuple, logical: tuple | None) -> Spec:
        """Spec of a param-shaped optimizer leaf (Adam moments)."""
        return self.param_spec(shape, logical)

    @property
    def family(self) -> str:
        """The spec generator's family: the strategy's own name here, a
        plan's base strategy for ``planner.PlannedStrategy``."""
        return self.name

    def specs_for_tree(self, shapes: dict, logical: dict) -> dict:
        """``{path: Spec}`` of the flat leaf shapes ``shapes``."""
        return {k: self.param_spec(s, logical.get(k))
                for k, s in shapes.items()}

    def opt_specs_for_tree(self, shapes: dict, logical: dict) -> dict:
        return {k: self.opt_spec(s, logical.get(k))
                for k, s in shapes.items()}


@dataclasses.dataclass
class ZeRO1(DataParallel):
    """ZeRO stage 1: params replicated (DDP compute and communication),
    optimizer moments sharded over the data axes; each process updates
    its slice of every sharded leaf and the params are all-gathered."""

    data_size: int = 1

    def __post_init__(self) -> None:
        self.name = "zero1"

    def opt_spec(self, shape: tuple, logical: tuple | None) -> Spec:
        del logical
        return _heuristic_spec(shape, self.data_size, BATCH_AXES,
                               self.min_shard_elems)


@dataclasses.dataclass
class FullyShardedDataParallel(DataParallel):
    """ZeRO-3: every large param sharded over the ``fsdp`` axis. With
    logical axes present the storage shard dim follows ``rules``;
    otherwise the largest divisible dim."""

    fsdp_size: int = 1
    rules: Rules = dataclasses.field(default_factory=lambda: {
        "embed": AXIS_FSDP,
        "vocab": AXIS_FSDP,
        "mlp": None,
        "heads": None,
        "kv": None,
        "expert": AXIS_FSDP,
    })

    def __post_init__(self) -> None:
        self.name = "fsdp"

    def param_spec(self, shape: tuple, logical: tuple | None) -> Spec:
        sizes = {AXIS_FSDP: self.fsdp_size}
        if logical is not None:
            spec = prune_spec(shape, logical_to_spec(logical, self.rules),
                              sizes, self.min_shard_elems)
            if spec != ():
                return spec
        return _heuristic_spec(shape, self.fsdp_size, AXIS_FSDP,
                               self.min_shard_elems)


@dataclasses.dataclass
class TensorParallel(DataParallel):
    """Megatron-style tensor parallelism composed with FSDP (the JAX
    ``TensorParallel``): column-parallel weights split their output dim
    over ``tp``, row-parallel ones their input dim, attention its heads,
    the embedding and head their vocab; ``embed`` dims split over
    ``fsdp``. Unannotated leaves fall back to the FSDP heuristic."""

    fsdp_size: int = 1
    tp_size: int = 1
    rules: Rules = dataclasses.field(default_factory=lambda: {
        "embed": AXIS_FSDP,
        "vocab": AXIS_TP,
        "mlp": AXIS_TP,
        "heads": AXIS_TP,
        "kv": AXIS_TP,
        "expert": AXIS_FSDP,
    })

    def __post_init__(self) -> None:
        self.name = "tp"

    def param_spec(self, shape: tuple, logical: tuple | None) -> Spec:
        sizes = {AXIS_FSDP: self.fsdp_size, AXIS_TP: self.tp_size}
        if logical is not None:
            return prune_spec(shape, logical_to_spec(logical, self.rules),
                              sizes, self.min_shard_elems)
        return _heuristic_spec(shape, self.fsdp_size, AXIS_FSDP,
                               self.min_shard_elems)


def check_strategy(name: str) -> None:
    """Raise for a strategy name the port does not run."""
    if name.lower() not in ("ddp", "zero1", "fsdp", "hybrid", "tp",
                            "tp_fsdp"):
        raise ValueError(
            f"unknown parallel_strategy '{name}'; known: ddp, zero1, "
            "fsdp, hybrid, tp")


def get_strategy(name: str, mesh_spec=None, **kwargs) -> DataParallel:
    """Strategy registry, as the JAX ``get_strategy``. ``hybrid`` is
    FSDP specs over a mesh with dp > 1; ``tp`` and ``tp_fsdp`` are one
    strategy, its sizes from the mesh."""
    check_strategy(name)
    sizes = {}
    if mesh_spec is not None:
        sizes = dict(fsdp_size=mesh_spec.fsdp, tp_size=mesh_spec.tp,
                     data_size=mesh_spec.dp * mesh_spec.fsdp)
    name = name.lower()
    if name == "ddp":
        return DataParallel(**kwargs)
    if name == "zero1":
        data_size = sizes.get("data_size", 1)
        if data_size <= 1:
            # A silent no-op hides misconfiguration: loud, not fatal.
            warnings.warn(
                "parallel_strategy='zero1' with data_size<=1: optimizer"
                " moments will be fully replicated (plain DDP). Pass a"
                " mesh with dp*fsdp > 1 for ZeRO-1 to shard anything.",
                stacklevel=2)
        return ZeRO1(data_size=data_size, **kwargs)
    if name in ("tp", "tp_fsdp"):
        return TensorParallel(fsdp_size=sizes.get("fsdp_size", 1),
                              tp_size=sizes.get("tp_size", 1), **kwargs)
    return FullyShardedDataParallel(
        fsdp_size=sizes.get("fsdp_size", 1), **kwargs)


def layout(strategy: DataParallel, shapes: dict, logical: dict) -> dict:
    """``{"params": {path: Placement | None}, "opt": {...},
    "tp_partial": (path, …)}`` for the flat (``a/b``-keyed) leaf shapes
    ``shapes`` and logical axes ``logical`` of a model.

    ``tp_partial``: under tp > 1, the leaves with a dim the rules route
    to ``tp`` that the spec left whole (kv heads that tp does not
    divide). The tensor-parallel block uses only this rank's part of
    such a leaf, so each tp rank's gradient of it is partial and
    ``fsdp.average_grads`` sums them over tp."""
    out = {"params": {k: placement(spec) for k, spec in
                      strategy.specs_for_tree(shapes, logical).items()},
           "opt": {k: placement(spec) for k, spec in
                   strategy.opt_specs_for_tree(shapes, logical).items()},
           "tp_partial": ()}
    if getattr(strategy, "tp_size", 1) > 1:
        to_tp = {n for n, a in strategy.rules.items() if a == AXIS_TP}
        out["tp_partial"] = tuple(
            k for k, pl in out["params"].items()
            if to_tp & set(logical.get(k) or ())
            and (pl is None or AXIS_TP not in pl.axes))
    return out

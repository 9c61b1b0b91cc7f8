"""Collective-traffic accounting for one train step (port of
``telemetry/collectives.py``).

The JAX package walks the compiled step's optimized HLO, where XLA's
partitioner put every collective, and accounts each one (kind, element
type, shape, bytes) against the mesh axis its replica groups run over.
Eager PyTorch compiles nothing: the collectives are the
``torch.distributed`` calls the port's own helpers make. So here each
helper on the step path calls ``record(kind, group, result)`` where it
launches its collective, and a ``recording()`` window gathers the rows of
one step:

- ``parallel/fsdp.py``: the gather for compute (``all-gather``), its
  backward (``reduce-scatter``), the gradient sync and the data mean
  (``all-reduce``), whole-leaf gathers (``all-gather``);
- ``parallel/tensor.py`` and ``ops/xent.py``: the tp ``all-reduce``\\ s
  and the vocab ``all-gather``;
- ``parallel/ring_attention.py``: each ring send (``collective-permute``,
  one per tensor), Ulysses' exchanges (``all-to-all``), the sp sums;
- ``parallel/pipeline.py``: each stage send (``collective-permute``), the
  last stage's broadcast and the stage sums (``all-reduce``: JAX
  broadcasts over ``pp`` as a masked ``psum``);
- ``parallel/expert.py``: the aux statistics (``all-reduce``) and the
  capacity counts (``all-gather``);
- ``train/optimizer.py``: the global norm's and Adafactor's partial sums;
- ``train/trainer.py``: the count of live targets (``all-reduce``);
- ``serving/engine.py``/``serving/disagg.py``: the step digest and the
  KV gathers and broadcasts of a serving mesh.

Conventions, JAX's where both can know them:

- ``bytes`` is the collective's result payload on one participant (the
  gathered tensor, the scattered shard, the reduced tensor, the tensor
  a permute delivers), not a link-level model;
- a row's ``axes`` is the mesh axes its group runs over, joined by
  ``+`` in mesh order (``mesh_axis_groupings``' labels), or
  ``"unknown"`` for a group that is none of the mesh's groupings;
- a collective over a group of one moves nothing and is not recorded
  (JAX's program has none at one device), and a gloo group's staging of
  a card's tensor through host memory is a copy, not a second
  collective;
- rows are this process's: the coordinator's, where the trainer emits
  the event. Under ``pp`` a stage's sends are its own (JAX's SPMD
  program runs every permute on every device).

Recording reads only tensor metadata and the group's member list: it
adds no host sync and no collective, and costs nothing outside a window.
``spmd_reshard_warnings`` is 0 by construction (no partitioner exists).
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import torch

# Bump when the report dict's keys change meaning — consumers
# (summarize.py, aggregate.py) check this before rendering.
SCHEMA = 1

# The stable consumer surface of a trainer-emitted ``collectives``
# event (everything except the per-row detail). Single-host and
# multi-host summaries both filter through this, so a SCHEMA bump
# cannot leave the two reports disagreeing about which keys exist.
# ``sharding_plan`` (additive, absent on unplanned runs) is the
# resolved auto-parallelism plan's provenance — name/fingerprint/
# remat/base_strategy from parallel/planner.py.
SUMMARY_KEYS = ("schema", "total_collectives", "bytes_per_step",
                "by_kind", "by_axis", "mesh", "spmd_reshard_warnings",
                "sharding_plan")

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "collective-permute", "all-to-all")

# torch dtypes under the HLO element-type names the JAX rows carry.
_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred"}


def summary_of_event(rec: dict) -> dict:
    """The SUMMARY_KEYS subset of a ``collectives`` event/report."""
    return {k: rec[k] for k in SUMMARY_KEYS if k in rec}


def render_lines(coll: dict) -> list[str]:
    """Human-readable lines for a collectives summary — one headline
    (total MB/step by kind, or the explicit none case) plus one line
    per mesh axis. Shared by the single-run summarizer and the
    multi-host report so the same event never renders two ways."""
    parts = ", ".join(
        f"{k} x{v['count']} {v['bytes'] / 1e6:.2f}MB"
        for k, v in sorted(coll.get("by_kind", {}).items(),
                           key=lambda kv: -kv[1]["bytes"]))
    lines = [
        f"collectives: {coll['bytes_per_step'] / 1e6:.2f} MB/step"
        f" ({parts})" if parts else
        "collectives: none (single-device or fully replicated)"]
    for axis, v in sorted(coll.get("by_axis", {}).items(),
                          key=lambda kv: -kv[1]["bytes"]):
        lines.append(f"  axis {axis:10s} x{v['count']:3d}  "
                     f"{v['bytes'] / 1e6:9.3f} MB")
    if coll.get("spmd_reshard_warnings"):
        lines.append(
            f"  SPMD reshard warnings: {coll['spmd_reshard_warnings']} "
            "(involuntary full rematerialization — see "
            "docs/static-analysis.md)")
    sp = coll.get("sharding_plan")
    if sp:
        lines.append(
            f"  sharding plan: {sp.get('name')}@"
            f"{sp.get('fingerprint')} ({sp.get('base_strategy')}, "
            f"remat={sp.get('remat')})")
    return lines


# The rows of the open window (None: no window, ``record`` returns at
# once).
_ROWS: list | None = None


@contextlib.contextmanager
def recording():
    """A window over which every ``record`` call appends its row to the
    yielded list (windows do not nest)."""
    global _ROWS
    if _ROWS is not None:
        raise RuntimeError("a collectives recording window is already open")
    rows: list = []
    _ROWS = rows
    try:
        yield rows
    finally:
        _ROWS = None


def record(kind: str, group, result) -> None:
    """Account one collective over ``group`` (None: the default group)
    whose result on this process is ``result``: a tensor, or a list of
    tensors (an all-gather into parts), counted as one tuple. A no-op
    outside a ``recording`` window and over a group of one."""
    if _ROWS is None:
        return
    import torch.distributed as dist

    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"collective kind {kind!r} is none of "
                         f"{COLLECTIVE_KINDS}")
    group = dist.group.WORLD if group is None else group
    if dist.get_world_size(group) <= 1:
        return
    parts = list(result) if isinstance(result, (list, tuple)) else [result]
    sizes = [t.numel() * t.element_size() for t in parts]
    big = parts[max(range(len(parts)), key=sizes.__getitem__)]
    _ROWS.append({
        "kind": kind,
        "dtype": _DTYPE_NAMES.get(big.dtype, str(big.dtype)),
        "shape": ",".join(str(d) for d in big.shape) or "scalar",
        "tuple_arity": len(parts),
        "bytes": int(sum(sizes)),
        "ranks": tuple(dist.get_process_group_ranks(group))})


def mesh_axis_groupings(mesh) -> list[tuple[str, frozenset]]:
    """Every way the mesh's processes group along combinations of its
    axes larger than 1: ``[(label, {frozenset(world ranks), ...}),
    ...]``, one entry per non-empty combination, labels ``+``-joined in
    mesh order (JAX's function over a ``ProcessMesh``)."""
    from itertools import combinations

    from distributed_training_tpu_torch.runtime import MESH_AXES

    grid = mesh.ranks
    live = [i for i, n in enumerate(grid.shape) if n > 1]
    out = []
    for r in range(1, len(live) + 1):
        for combo in combinations(live, r):
            rest = [i for i in range(grid.dim()) if i not in combo]
            n = math.prod(grid.shape[i] for i in combo)
            rows = grid.permute(rest + list(combo)).reshape(-1, n).tolist()
            out.append(("+".join(MESH_AXES[i] for i in combo),
                        frozenset(frozenset(row) for row in rows)))
    return out


def axes_label(ranks, groupings: list) -> str:
    """The label of the grouping one of whose groups is ``ranks``, else
    ``"unknown"``."""
    key = frozenset(ranks)
    for label, groups in groupings:
        if key in groups:
            return label
    return "unknown"


def report(rt, rows: list, sharding_plan=None) -> dict:
    """The ``collectives`` event of a window's ``rows`` over ``rt``'s
    mesh: JAX's report keys (``schema``, ``total_collectives``,
    ``bytes_per_step``, ``by_kind``, ``by_axis``, ``largest``, ``rows``),
    ``mesh`` (its axes above 1), ``spmd_reshard_warnings`` (0: no
    partitioner) and, with ``sharding_plan`` (a ``planner.Plan``), the
    plan's provenance."""
    groupings = (mesh_axis_groupings(rt.mesh) if rt.mesh is not None
                 else [])
    out_rows = []
    for r in rows:
        row = {k: v for k, v in r.items() if k != "ranks"}
        row["axes"] = axes_label(r["ranks"], groupings)
        out_rows.append(row)
    by_kind: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    by_axis: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for r in out_rows:
        for table, key in ((by_kind, r["kind"]), (by_axis, r["axes"])):
            table[key]["count"] += 1
            table[key]["bytes"] += r["bytes"]
    rep = {
        "schema": SCHEMA,
        "total_collectives": len(out_rows),
        "bytes_per_step": sum(r["bytes"] for r in out_rows),
        "by_kind": dict(by_kind),
        "by_axis": dict(by_axis),
        "largest": sorted(out_rows, key=lambda r: -r["bytes"])[:10],
        "rows": out_rows,
        "mesh": {a: n for a, n in rt.spec.as_dict().items() if n > 1},
        "spmd_reshard_warnings": 0,
    }
    if sharding_plan is not None:
        rep["sharding_plan"] = {
            "name": sharding_plan.name,
            "fingerprint": sharding_plan.fingerprint(),
            "remat": sharding_plan.remat,
            "base_strategy": sharding_plan.base_strategy}
    return rep

"""Sharding plans, the read side (port of ``parallel/planner.py``).

A plan is the JAX planner's resolved parallelism decision: the mesh
shape, the remat policy, the per-shard batch and the sharding map by
param path, committed as JSON under ``conf/plans/`` and shared by both
packages. This module reads and checks such files and lays a model out
by them; it does not search:

- ``Plan`` with its ``fingerprint`` (the identity of the resolved
  layout) and the document's ``integrity`` digest (provenance included),
  both byte for byte the JAX package's, so a plan written by one
  package loads in the other; ``load_plan`` refuses a hand-edited file;
- ``model_kwargs_for``/``model_for_plan``: the port's ``Transformer``
  of a plan;
- ``PlannedStrategy``: a strategy whose placements are the plan's
  sharding map, looked up by path;
- ``check_plan_runtime`` and ``apply_plan_to_config``: the trainer's
  and the CLI's side of ``train.sharding_plan``.

The search and its scoring (candidate enumeration, the cost model, the
compile verification, ``build_plan``) and the XLA overlap flags wait for
ROADMAP.md queue A item 17.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field

from distributed_training_tpu_torch.parallel.strategy import (
    DataParallel,
    get_strategy,
)
from distributed_training_tpu_torch.runtime import MESH_AXES, MeshSpec

PLAN_SCHEMA = 1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PLANS_DIR = os.path.join(REPO, "conf", "plans")

# The elastic launcher's resolved-world variable (the JAX package's
# ``resilience/elastic.py::ENV_WORLD``): set in an elastic incarnation,
# where only the dp extent may differ from the plan's.
ENV_WORLD = "DTT_ELASTIC_WORLD"


class PlanError(ValueError):
    pass


def _canon(obj):
    """JSON-canonical form (tuples become lists)."""
    return json.loads(json.dumps(obj, sort_keys=True))


def _doc_digest(doc: dict) -> str:
    """sha256 over the canonical plan document, ``integrity`` field
    excluded (it holds this digest)."""
    body = {k: v for k, v in doc.items() if k != "integrity"}
    blob = json.dumps(_canon(body), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


_IDENTITY = ("name", "devices", "mesh", "base_strategy", "remat",
             "batch_per_shard", "seq_len", "batch_axes", "sharding_map",
             "inputs")


@dataclass
class Plan:
    """A resolved parallelism decision: mesh shape, remat policy,
    per-shard batch and the sharding map by param path (each entry one
    per-dim list: ``None`` replicates, a string is a mesh axis, a list a
    tuple of axes). ``inputs`` is the planner's target, ``provenance``
    its scores and compile evidence."""

    name: str
    devices: int
    mesh: dict                  # all five axes, all >= 1
    base_strategy: str          # spec-generator family: ddp|fsdp|tp
    remat: str                  # none|mlp_pre|mlp
    batch_per_shard: int
    seq_len: int
    batch_axes: list            # batch-dim mesh axes, e.g. ["dp","fsdp"]
    sharding_map: dict          # param path -> per-dim axis entries
    inputs: dict = field(default_factory=dict)
    provenance: dict = field(default_factory=dict)

    @property
    def data_shards(self) -> int:
        return self.mesh["dp"] * self.mesh["fsdp"]

    @property
    def global_batch(self) -> int:
        return self.batch_per_shard * self.data_shards

    @property
    def candidate_key(self) -> str:
        m = ".".join(f"{a}{self.mesh[a]}" for a in MESH_AXES)
        return f"{m}/{self.remat}/b{self.batch_per_shard}"

    def fingerprint(self) -> str:
        """Identity of the resolved layout (search inputs included);
        provenance is guarded by the document's integrity digest."""
        doc = {k: getattr(self, k) for k in _IDENTITY}
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_doc(self) -> dict:
        doc = {"schema": PLAN_SCHEMA, "fingerprint": self.fingerprint(),
               **{k: getattr(self, k) for k in _IDENTITY + ("provenance",)}}
        doc["integrity"] = _doc_digest(doc)
        return doc

    @staticmethod
    def from_doc(doc: dict) -> "Plan":
        if doc.get("schema") != PLAN_SCHEMA:
            raise PlanError(
                f"plan schema {doc.get('schema')!r} != {PLAN_SCHEMA} "
                "— regenerate with planner --write")
        recorded_digest = doc.get("integrity")
        if recorded_digest and recorded_digest != _doc_digest(doc):
            raise PlanError(
                f"plan '{doc.get('name')}' integrity digest mismatch — "
                "the file (provenance included) was hand-edited; "
                "regenerate with --write")
        plan = Plan(**{k: doc[k] for k in _IDENTITY + ("provenance",)})
        recorded = doc.get("fingerprint")
        if recorded and recorded != plan.fingerprint():
            raise PlanError(
                f"plan '{plan.name}' fingerprint mismatch: file says "
                f"{recorded}, content hashes to {plan.fingerprint()} — "
                "the file was hand-edited; regenerate with --write")
        return plan


def plan_path(name: str) -> str:
    return os.path.join(PLANS_DIR, f"{name}.json")


def load_plan(name_or_path: str) -> Plan:
    """Load a committed plan by name (``conf/plans/<name>.json``) or any
    explicit path."""
    path = name_or_path
    if not os.path.exists(path):
        path = plan_path(name_or_path)
        if not os.path.exists(path):
            raise PlanError(
                f"no plan at '{name_or_path}' and no committed plan "
                f"named '{name_or_path}' in {PLANS_DIR}")
    with open(path, encoding="utf-8") as f:
        return Plan.from_doc(json.load(f))


def save_plan(plan: Plan, path: str | None = None) -> str:
    path = path or plan_path(plan.name)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(plan.to_doc(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def base_strategy_for(mesh: dict) -> str:
    if mesh.get("tp", 1) > 1:
        return "tp"
    if mesh.get("fsdp", 1) > 1:
        return "fsdp"
    return "ddp"


def model_kwargs_for(plan: Plan) -> dict:
    """The target's model kwargs plus the plan's remat decision."""
    mk = dict(plan.inputs.get("model_kwargs", {}))
    mk.pop("remat", None)
    mk.pop("remat_policy", None)
    if plan.remat == "none":
        mk["remat"] = False
    else:
        mk.update(remat=True, remat_policy=plan.remat)
    return mk


def model_for_plan(plan: Plan, device=None):
    """The port's ``Transformer`` a serving consumer builds for ``plan``:
    the target's model kwargs without the remat keys (serving runs no
    backward). ``device=None`` is the CUDA card."""
    from distributed_training_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )

    mk = model_kwargs_for(plan)
    mk.pop("remat", None)
    mk.pop("remat_policy", None)
    return Transformer(TransformerConfig(**mk), device=device)


def plan_mesh_spec(plan: Plan) -> MeshSpec:
    return MeshSpec(**{a: plan.mesh.get(a, 1) for a in MESH_AXES})


@dataclasses.dataclass
class PlannedStrategy(DataParallel):
    """A strategy whose layout is a resolved plan, not rules: every
    leaf's spec is the plan's sharding-map entry for its path, and a
    path the plan does not name raises (a model/plan mismatch fails at
    construction, not as a silently replicated layout). Optimizer
    moments take the param layout. ``family`` is the plan's base
    strategy, whose rules and tp extent the trainer's tensor-parallel
    binding and ``layout``'s tp-partial leaves read."""

    plan: Plan | None = None

    def __post_init__(self) -> None:
        self.name = "planned"
        if self.plan is None:
            raise PlanError("PlannedStrategy requires a plan")
        base = get_strategy(self.plan.base_strategy,
                            plan_mesh_spec(self.plan),
                            min_shard_elems=self.min_shard_elems)
        self.rules = getattr(base, "rules", {})
        self.tp_size = self.plan.mesh.get("tp", 1)

    @property
    def family(self) -> str:
        return self.plan.base_strategy

    def param_spec(self, shape, logical):
        raise PlanError(
            "PlannedStrategy resolves specs by param path via "
            "specs_for_tree; a path-less spec lookup would bypass the "
            "plan's sharding map")

    opt_spec = param_spec

    def _spec_for_path(self, key: str) -> tuple:
        try:
            entries = self.plan.sharding_map[key]
        except KeyError:
            raise PlanError(
                f"plan '{self.plan.name}' names no sharding for param "
                f"'{key}' — the plan was resolved against a different "
                "model; re-run the planner") from None
        spec = [tuple(e) if isinstance(e, list) else e for e in entries]
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def specs_for_tree(self, shapes: dict, logical: dict) -> dict:
        del logical  # the plan is the resolved layout
        return {k: self._spec_for_path(k) for k in shapes}

    def opt_specs_for_tree(self, shapes: dict, logical: dict) -> dict:
        return self.specs_for_tree(shapes, logical)

    def describe(self) -> str:
        live = {a: s for a, s in self.plan.mesh.items() if s > 1}
        return (f"planned({self.plan.name}@{self.plan.fingerprint()} "
                f"mesh={live} remat={self.plan.remat})")


def check_plan_runtime(plan: Plan, mesh_spec,
                       elastic: bool | None = None) -> None:
    """Raise ``PlanError`` when the runtime mesh is not the plan's mesh.
    In an elastic incarnation (``ENV_WORLD`` set) only ``dp`` may
    differ."""
    if elastic is None:
        elastic = os.environ.get(ENV_WORLD) is not None
    have = mesh_spec.as_dict()
    for a in MESH_AXES:
        if a == "dp" and elastic:
            continue
        if have.get(a, 1) != plan.mesh.get(a, 1):
            raise PlanError(
                f"runtime mesh {have} does not match plan '{plan.name}' "
                f"mesh {plan.mesh} (axis '{a}'); pass the plan through "
                "the CLI (train.sharding_plan) so the mesh is derived "
                "from it, or re-plan for this topology")


# The model kwargs of a plan's target that shape its pipeline (``pp``):
# the CLI takes them from the plan unless the config sets them.
PIPELINE_KWARGS = ("pp_microbatches", "pp_schedule", "pp_virtual_stages")


def apply_plan_to_config(cfg) -> Plan:
    """Derive ``cfg.mesh`` (and the per-shard batch) from
    ``cfg.train.sharding_plan``: every model-sharding axis pinned to the
    plan's extent (``pp`` included), ``dp`` the ``-1`` wildcard; the
    plan's per-shard batch unless ``train.global_batch_size`` owns it;
    the target's pipeline kwargs (``PIPELINE_KWARGS``) where the config
    names none. Returns the plan."""
    plan = load_plan(cfg.train.sharding_plan)
    for a in MESH_AXES:
        setattr(cfg.mesh, a, -1 if a == "dp" else plan.mesh.get(a, 1))
    target = plan.inputs.get("model_kwargs", {})
    for k in PIPELINE_KWARGS:
        if k in target:
            cfg.model.kwargs.setdefault(k, target[k])
    if not cfg.train.global_batch_size:
        cfg.train.batch_size = plan.batch_per_shard
    return plan

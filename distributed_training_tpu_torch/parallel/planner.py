"""The auto-parallelism planner (port of ``parallel/planner.py``):
search mesh x remat x batch for a target, score each candidate, verify
the winner, emit a plan; and the plans' read side.

A plan is a resolved parallelism decision: the mesh shape, the remat
policy, the per-shard batch and the sharding map by param path,
committed as JSON under ``conf/plans/`` and shared by both packages.

The search, as JAX's (every name and record key the same):

- ``PlanTarget`` (the registered ``PLAN_TARGETS``: the six targets the
  JAX planner committed plans for), ``Candidate``,
  ``enumerate_candidates``: every mesh factorization the model admits,
  times the remat policies, times the target's batches;
- ``score_candidate``/``_score_serving``/``rank_candidates``: the
  analytic cost model, term by term JAX's: HBM fit from
  ``utils/memory.py``, compute from ``Transformer.flops_per_token``,
  collective bytes by kind, each priced on the committed calibration
  table matching the chip (``calibration/``) or on nominal per-chip
  constants, and a deterministic sort. The port ranks every committed
  target exactly as JAX ranks it, float for float;
- ``resolve_sharding_map``/``build_plan``: the base strategy's specs
  (``parallel/strategy.py``) serialized as JAX serializes its
  PartitionSpecs, so the fingerprint is JAX's;
- ``plan_search``: walks the ranking best-first through a gate and
  records the winner's evidence and every disqualification.
  ``check_plan`` (``--check``) re-derives a committed plan.

The gate is where the port differs by design. JAX compiles the train
step abstractly and disqualifies a candidate with SPMD reshard
warnings; PyTorch has no partitioner and nothing compiles. The port's
``compile_verify`` keeps the name and *runs* one step of the plan
through the trainer under ``train.sharding_plan`` on the plan's mesh,
and the same step unplanned, and disqualifies the candidate when their
losses or gradient norms disagree (``GATE_LOSS_RTOL``,
``GATE_GRAD_NORM_RTOL``); its collective evidence comes from the port's
own counters. Serving targets take ``serving/disagg.py::
compile_verify_serving``. The XLA overlap flags of a plan
(``Plan.xla_overlap_flags``) and JAX's HLO evidence have no
counterpart.

The read side: ``Plan`` with its ``fingerprint`` and the document's
``integrity`` digest (both byte for byte JAX's, so a plan written by
one package loads in the other), ``load_plan``, ``model_kwargs_for``/
``model_for_plan``, ``PlannedStrategy`` (placements from the plan's
map, by path), ``check_plan_runtime`` and ``apply_plan_to_config``
(the trainer's and the CLI's side of ``train.sharding_plan``).

Everything but the gate is arithmetic on shapes: no tensor is
allocated and no device is touched, so the CLI runs anywhere::

    python -m distributed_training_tpu_torch.parallel.planner          # top 5
    python -m distributed_training_tpu_torch.parallel.planner --check  # vs conf/plans
    python -m distributed_training_tpu_torch.parallel.planner --write --out DIR
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Callable

from distributed_training_tpu_torch.parallel.strategy import (
    DataParallel,
    get_strategy,
)
from distributed_training_tpu_torch.runtime import (
    BATCH_AXES,
    MESH_AXES,
    MeshSpec,
)

PLAN_SCHEMA = 1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PLANS_DIR = os.path.join(REPO, "conf", "plans")

# The elastic launcher's resolved-world variable (the JAX package's
# ``resilience/elastic.py::ENV_WORLD``): set in an elastic incarnation,
# where only the dp extent may differ from the plan's.
ENV_WORLD = "DTT_ELASTIC_WORLD"

# Remat recompute multiplier on total step FLOPs (fwd+bwd ≈ 3x fwd):
# "mlp" recomputes the two F-wide MLP matmul/gelu tensors (~+11% of
# forward ≈ +4% of total); "mlp_pre" saves the pre-gelu tensor and
# recomputes only the elementwise gelu (~+2%). Constants, not
# measurements: they only need to rank policies correctly (none fastest
# when it fits). JAX's values.
REMAT_POLICIES = ("none", "mlp_pre", "mlp")
REMAT_RECOMPUTE = {"none": 1.0, "mlp_pre": 1.02, "mlp": 1.04}

# Nominal fallback interconnect bandwidth for the comms half of the
# roofline when no calibration table matches the target chip, per
# device kind, keyed by the calibration layer's chip slug: the JAX
# package's constants (TPU spec-sheet ICI rates; "cpu" its historical
# ranking constant), kept as the data its committed targets were scored
# from. No card has a row: an unknown kind gets ``ICI_BYTES_PER_S``.
ICI_BYTES_PER_S = 1.0e11
NOMINAL_ICI_BYTES_PER_S = {
    "v4": 3.0e11,
    "v5e": 2.0e11,
    "v5p": 6.0e11,
    "v6e": 4.48e11,
    "cpu": 1.0e11,
}


def nominal_ici_bytes_per_s(chip: str) -> float:
    """Per-kind nominal interconnect bandwidth (the same chip
    normalization as the measured-table lookup; unknown kinds get the
    one-size constant)."""
    from distributed_training_tpu_torch.calibration import chip_slug
    return NOMINAL_ICI_BYTES_PER_S.get(chip_slug(chip), ICI_BYTES_PER_S)


# Nominal peak FLOP/s for the compute half of the roofline when no
# calibration table matches: the JAX package's
# ``utils/metrics.py::TPU_PEAK_FLOPS`` rows (its "cpu" row is its
# fallback), the values its committed targets were scored from; a card
# the port's ``utils/metrics.py::PEAK_FLOPS`` names takes that entry.
# Planning data only: the port's MFU reads ``peak_flops_per_chip``.
_NOMINAL_PEAK_FLOPS = {
    "v4": 275e12,
    "v5e": 197e12,
    "v5 lite": 197e12,
    "v5p": 459e12,
    "v6e": 918e12,
    "cpu": 1e11,
}


def nominal_peak_flops_per_s(chip: str) -> float:
    """The chip's nominal peak FLOP/s (above): the port's card table
    first, then the TPU rows by substring, else the "cpu" row."""
    from distributed_training_tpu_torch.utils.metrics import (
        peak_flops_per_chip,
    )
    card = peak_flops_per_chip(chip)
    if card is not None:
        return card
    kind = chip.lower()
    for key, flops in _NOMINAL_PEAK_FLOPS.items():
        if key in kind:
            return flops
    return _NOMINAL_PEAK_FLOPS["cpu"]


class PlanError(ValueError):
    pass


def _canon(obj):
    """JSON-canonical form (tuples become lists) so in-memory targets
    compare equal to their round-tripped committed form."""
    return json.loads(json.dumps(obj, sort_keys=True))


def _doc_digest(doc: dict) -> str:
    """sha256 over the canonical plan document, ``integrity`` field
    excluded (it holds this digest)."""
    body = {k: v for k, v in doc.items() if k != "integrity"}
    blob = json.dumps(_canon(body), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Targets: named configs the repo commits plans for
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanTarget:
    """Everything that determines the search: model, devices, budget,
    candidate sets (JAX's fields and defaults). ``objective``: "train"
    (step throughput under the training memory model), "decode"
    (aggregate decode tokens/s with the KV pool's residency) or
    "prefill" (batched prompt-chunk throughput); the serving objectives
    fix remat to "none" and exclude sp and pp. ``quant``: the weight
    storage the serving objectives price ("none" or "int8").
    ``max_compiles``: how many top-ranked candidates the gate may run
    before the search gives up."""

    name: str
    devices: int
    model_kwargs: dict          # WITHOUT remat keys (the search owns them)
    seq_len: int
    optimizer: str = "adamw"
    chip: str = "v5e"           # HBM budget + peak-FLOPs lookup
    hbm_gib: float | None = None  # override the chip's HBM capacity
    headroom: float = 0.85      # usable fraction
    batch_candidates: tuple = (1, 2, 4, 8)
    remat_candidates: tuple = REMAT_POLICIES
    min_shard_elems: int = 1
    allow_pp: bool = False
    max_compiles: int = 4
    objective: str = "train"
    quant: str = "none"
    note: str = ""

    def __post_init__(self):
        if self.objective not in ("train", "decode", "prefill"):
            raise PlanError(
                f"unknown plan objective '{self.objective}' "
                "(expected 'train', 'decode' or 'prefill')")
        if self.quant not in ("none", "int8"):
            raise PlanError(
                f"unknown plan quant '{self.quant}' "
                "(expected 'none' or 'int8')")
        if self.quant != "none" and self.objective == "train":
            raise PlanError(
                "quant is a serving-objective knob (weight-only "
                "int8 has no train-objective memory model)")

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.objective == "train":
            # Back-compat: committed train plans predate the objective
            # field; their recorded inputs must keep matching.
            d.pop("objective")
        if self.quant == "none":
            # The same for the quant field.
            d.pop("quant")
        return d


PLAN_TARGETS: dict[str, PlanTarget] = {}


def _register(t: PlanTarget) -> PlanTarget:
    PLAN_TARGETS[t.name] = t
    return t


# The six targets the JAX planner committed plans for, with its kwargs
# and notes (the notes are part of each plan's recorded inputs).
_register(PlanTarget(
    name="multichip_8dev",
    devices=8,
    model_kwargs=dict(vocab_size=256, d_model=64, n_heads=4,
                      n_kv_heads=2, n_layers=2, max_seq_len=32,
                      attention_impl="ring", attention_window=24,
                      dtype="float32", param_dtype="float32"),
    seq_len=32,
    optimizer="adamw",
    chip="v5e",
    note="The MULTICHIP_r05 dryrun model (windowed GQA, ring-capable) "
         "promoted to a planned, measured 8-device benchmark — "
         "benchmarks/bench_multichip.py runs real steps against this "
         "plan and MULTICHIP_r06.json records the result.",
))


_register(PlanTarget(
    name="multichip_8dev_cpu",
    devices=8,
    model_kwargs=dict(vocab_size=256, d_model=64, n_heads=4,
                      n_kv_heads=2, n_layers=2, max_seq_len=32,
                      attention_impl="ring", attention_window=24,
                      dtype="float32", param_dtype="float32"),
    seq_len=32,
    optimizer="adamw",
    chip="cpu",
    hbm_gib=16.0,
    note="The multichip_8dev model scored against the MEASURED cpu "
         "calibration table (conf/calibration/cpu.json, "
         "benchmarks/calibrate.py) — the calibrated-cost-model path "
         "exercised end-to-end in CI: planner --check validates this "
         "plan's recorded calibration fingerprint against the "
         "committed table, and benchmarks/bench_multichip.py "
         "--plan multichip_8dev_cpu measures it (MULTICHIP_r07).",
))


# The serving-plan model: the byte-vocab tiny transformer, one kwargs
# dict shared by every serving target so prefill and decode plans
# describe one model.
SERVING_MODEL_KWARGS = dict(vocab_size=256, d_model=64, n_heads=4,
                            n_kv_heads=2, n_layers=2, max_seq_len=64,
                            pos_encoding="rope", dtype="float32",
                            param_dtype="float32")

# The chunk width the prefill objective scores the batched lane program
# at: ``serving/disagg.py::engine_config_for_plan``'s default
# ``prefill_chunk``.
SERVING_PREFILL_CHUNK = 16

_register(PlanTarget(
    name="serving_8dev_cpu_decode",
    devices=8,
    model_kwargs=dict(SERVING_MODEL_KWARGS),
    seq_len=64,
    optimizer="none",
    chip="cpu",
    # Sized so replicated params (dp8 tp1) do not fit and dp4 tp2 does.
    hbm_gib=0.0005,
    batch_candidates=(32,),
    objective="decode",
    note="The serving decode plan benchmarks/bench_serving.py lays "
         "the engine out with (SERVING_r02/r03): 32 decode slots "
         "dealt over dp4 groups of 8, paged KV pool sharded dp×tp; "
         "r03's speculative multi-token decode rides the same "
         "layout (the chunk program deals lanes over dp "
         "identically). Audited reshard-clean by the "
         "serving_decode_planned analysis target.",
))

_register(PlanTarget(
    name="serving_4dev_cpu_prefill",
    devices=4,
    model_kwargs=dict(SERVING_MODEL_KWARGS),
    seq_len=64,
    optimizer="none",
    chip="cpu",
    hbm_gib=0.002,
    batch_candidates=(8,),
    objective="prefill",
    note="Prefill-slice layout for the disaggregated pipeline "
         "(serving/disagg.py): the BATCHED multi-sequence prefill "
         "program (SERVING_r03) — 8 lanes dealt over the plan's dp "
         "groups, one prompt chunk per lane per launch — scored for "
         "aggregate prompt tokens/second over half the 8-device CPU "
         "mesh; resolved against the SAME model as "
         "serving_4dev_cpu_decode — two plans, one weight store. "
         "Audited reshard-clean by the serving_prefill_planned "
         "analysis target.",
))

_register(PlanTarget(
    name="serving_4dev_cpu_decode",
    devices=4,
    model_kwargs=dict(SERVING_MODEL_KWARGS),
    seq_len=64,
    optimizer="none",
    chip="cpu",
    hbm_gib=0.0005,
    batch_candidates=(16,),
    objective="decode",
    note="Decode-slice layout for the disaggregated pipeline: the KV "
         "cache written by the prefill slice's batched lane program "
         "is handed off onto this layout (serving/disagg.py) and "
         "decode continues there (speculative multi-token capable, "
         "SERVING_r03).",
))

_register(PlanTarget(
    name="serving_8dev_cpu_decode_int8",
    devices=8,
    model_kwargs=dict(SERVING_MODEL_KWARGS),
    seq_len=64,
    optimizer="none",
    chip="cpu",
    # The fp32 decode target's budget: int8's smaller weights let
    # layouts that budget priced out back in.
    hbm_gib=0.0005,
    batch_candidates=(32,),
    objective="decode",
    quant="int8",
    note="The serving_8dev_cpu_decode target served from an int8 "
         "weight-only store (checkpoint/export.py --quantize int8): "
         "same model, same budget, params priced at 1 byte/elem + "
         "per-channel scales. SERVING_r04's quantized bench lane "
         "lays the engine out with this plan.",
))


def resolve_targets(names=None) -> list[PlanTarget]:
    if not names:
        return list(PLAN_TARGETS.values())
    out = []
    for n in names:
        if n not in PLAN_TARGETS:
            raise KeyError(f"unknown plan target '{n}'; available: "
                           f"{sorted(PLAN_TARGETS)}")
        out.append(PLAN_TARGETS[n])
    return out


# ---------------------------------------------------------------------------
# The plan artifact
# ---------------------------------------------------------------------------


_IDENTITY = ("name", "devices", "mesh", "base_strategy", "remat",
             "batch_per_shard", "seq_len", "batch_axes", "sharding_map",
             "inputs")


@dataclass
class Plan:
    """A resolved parallelism decision: mesh shape, remat policy,
    per-shard batch and the sharding map by param path (each entry one
    per-dim list: ``None`` replicates, a string is a mesh axis, a list a
    tuple of axes). ``inputs`` is the planner's target, ``provenance``
    its scores and gate evidence."""

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
        """The candidate this plan resolves (``Candidate.key``'s
        form: ``check_plan`` matches the winner on it)."""
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


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Candidate:
    pp: int
    dp: int
    fsdp: int
    sp: int
    tp: int
    remat: str
    batch_per_shard: int

    @property
    def mesh(self) -> dict:
        return {a: getattr(self, a) for a in MESH_AXES}

    @property
    def key(self) -> str:
        m = ".".join(f"{a}{getattr(self, a)}" for a in MESH_AXES)
        return f"{m}/{self.remat}/b{self.batch_per_shard}"


def _factorizations(n: int, axes: int):
    """All ordered tuples of ``axes`` positive ints with product n."""
    if axes == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, axes - 1):
                yield (d,) + rest


def enumerate_candidates(target: PlanTarget) -> list[Candidate]:
    """Every (mesh, remat, batch) the model and device count admit, in
    JAX's order. Shape constraints only:

    - ``sp > 1`` only with a sequence-parallel attention impl (ring or
      Ulysses) and ``seq % sp == 0``;
    - ``tp > 1`` needs ``n_heads``, ``n_kv_heads`` and ``d_ff``
      divisible by tp; Ulysses ``heads % (tp*sp) == 0``;
    - ``pp > 1`` needs ``n_layers % pp == 0`` and ``allow_pp``;
    - the serving objectives take no sp or pp, and remat "none" only.
    """
    mk = dict(target.model_kwargs)
    n_heads = mk.get("n_heads", 12)
    n_kv = mk.get("n_kv_heads", 0) or n_heads
    d_model = mk.get("d_model", 768)
    d_ff = mk.get("d_ff", 0) or 4 * d_model
    n_layers = mk.get("n_layers", 12)
    impl = mk.get("attention_impl", "auto")
    seq_parallel = impl in ("ring", "ulysses")

    serving = target.objective in ("decode", "prefill")
    remat_cands = (("none",) if serving
                   else tuple(target.remat_candidates))

    out: list[Candidate] = []
    for pp, dp, fsdp, sp, tp in _factorizations(target.devices, 5):
        if serving and (pp > 1 or sp > 1):
            continue
        if pp > 1 and (not target.allow_pp or n_layers % pp):
            continue
        if sp > 1 and (not seq_parallel or target.seq_len % sp):
            continue
        if tp > 1 and (n_heads % tp or n_kv % tp or d_ff % tp):
            continue
        if impl == "ulysses" and sp > 1 and (
                n_heads % (tp * sp) or n_kv % (tp * sp)):
            continue
        for remat in remat_cands:
            for b in target.batch_candidates:
                out.append(Candidate(pp, dp, fsdp, sp, tp, remat, b))
    return out


# ---------------------------------------------------------------------------
# Cost model (stage 1: analytic, no device)
# ---------------------------------------------------------------------------


def _tf_cfg(target: PlanTarget, remat: str):
    from distributed_training_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    mk = dict(target.model_kwargs)
    mk.pop("remat", None)
    mk.pop("remat_policy", None)
    if remat == "none":
        return TransformerConfig(remat=False, **mk)
    return TransformerConfig(remat=True, remat_policy=remat, **mk)


def _shape_model(cfg):
    """The port's ``Transformer`` of ``cfg`` for its shape accounting
    (``flops_per_token``, ``logical_axes``) on the meta device: nothing
    is allocated."""
    from distributed_training_tpu_torch.models.transformer import Transformer
    return Transformer(cfg, device="meta")


def _n_params(target: PlanTarget) -> int:
    """The target model's parameter count, from its shape table (no
    weights are made: a 7b-class target costs no host memory)."""
    from distributed_training_tpu_torch.models.transformer import (
        param_shapes,
    )
    from distributed_training_tpu_torch.utils.memory import param_count
    return param_count(param_shapes(_tf_cfg(target, "none")))


def hbm_budget_gib(target: PlanTarget) -> float:
    from distributed_training_tpu_torch.utils.memory import HBM_GIB
    cap = (target.hbm_gib if target.hbm_gib is not None
           else HBM_GIB[target.chip])
    return cap * target.headroom


def resolve_calibration(target: PlanTarget):
    """The calibration feeding this target's cost model: a
    ``CalibrationLookup`` for the committed ``conf/calibration/<chip>
    .json`` matching ``target.chip`` (``table`` is None on fallback,
    ``status`` says why); one resolution shared by ``plan_search`` and
    ``check_plan``."""
    from distributed_training_tpu_torch.calibration import lookup_for_chip
    return lookup_for_chip(target.chip)


def calibration_provenance(target: PlanTarget, calib, note: str) -> dict:
    """The ``calibration`` block a plan's provenance records (source and
    fingerprint; ``nominal`` records the per-kind constants used)."""
    if calib is not None:
        return {"source": "measured", "chip": target.chip,
                "device_kind": calib.device_kind,
                "fingerprint": calib.fingerprint(), "note": note}
    return {"source": "nominal", "chip": target.chip,
            "fingerprint": None,
            "nominal_ici_bytes_per_s": nominal_ici_bytes_per_s(target.chip),
            "nominal_peak_flops_per_s": nominal_peak_flops_per_s(
                target.chip),
            "note": note}


def score_candidate(target: PlanTarget, cand: Candidate,
                    n_params: int | None = None, calib="auto") -> dict:
    """Analytic feasibility + throughput proxy for one candidate (JAX's
    record, term by term in JAX's order): ``feasible`` (False carries
    ``reason``), the per-device HBM estimate, the compute and comms
    roofline seconds, the comms bytes by collective kind and ``score``
    (tokens per second; higher is better). ``calib`` is a
    ``CalibrationTable``, ``None`` (nominal constants) or ``"auto"``
    (the committed table for ``target.chip``)."""
    from distributed_training_tpu_torch.utils.memory import (
        estimate_transformer_memory,
    )

    if calib == "auto":
        calib = resolve_calibration(target).table
    if target.objective in ("decode", "prefill"):
        return _score_serving(target, cand, n_params, calib)
    cfg = _tf_cfg(target, cand.remat)
    if n_params is None:
        n_params = _n_params(target)
    seq_local = target.seq_len // cand.sp
    est_cfg = (dataclasses.replace(cfg, n_layers=cfg.n_layers // cand.pp)
               if cand.pp > 1 else cfg)
    est = estimate_transformer_memory(
        est_cfg, batch_per_chip=cand.batch_per_shard,
        seq_len=seq_local, optimizer=target.optimizer,
        fsdp=cand.fsdp, tp=cand.tp)
    rec: dict = {
        "candidate": cand.key,
        "mesh": cand.mesh,
        "remat": cand.remat,
        "batch_per_shard": cand.batch_per_shard,
        "hbm_gib": round(est.total_gib, 4),
        "hbm_budget_gib": round(hbm_budget_gib(target), 4),
    }
    if est.total_gib > hbm_budget_gib(target):
        rec.update(feasible=False, reason="hbm", score=0.0)
        return rec

    # Compute: model FLOPs at the global batch times the remat factor,
    # over each device's achievable (calibrated) or nominal peak rate.
    model = _shape_model(cfg)
    global_batch = cand.batch_per_shard * cand.dp * cand.fsdp
    flops_step = (model.flops_per_token(target.seq_len) * target.seq_len
                  * global_batch * REMAT_RECOMPUTE[cand.remat])
    flops_per_dev = flops_step / target.devices
    if calib is not None:
        compute_s = flops_per_dev / calib.achievable_flops_per_s(
            flops_per_dev)
    else:
        compute_s = flops_per_dev / nominal_peak_flops_per_s(target.chip)

    # Comms: per-device bytes a step by collective kind; param bytes at
    # the stored dtype (gradients move masters), activations at the
    # compute dtype.
    pb = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.param_dtype]
    ab = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.dtype]
    P_store = n_params * pb / cand.pp
    B, S_l, D = cand.batch_per_shard, seq_local, cfg.d_model
    kv_width = cfg.n_kv_heads * cfg.head_dim
    by_kind = {k: 0.0 for k in ("all-gather", "reduce-scatter",
                                "all-reduce", "ppermute")}
    if cand.fsdp > 1:
        # Weights all-gather for compute + gradient reduce-scatter.
        by_kind["all-gather"] += n_params * ab / cand.pp
        by_kind["reduce-scatter"] += P_store
    if cand.dp > 1:
        # Gradient all-reduce over dp of each fsdp shard (2x: the
        # ring's two phases).
        by_kind["all-reduce"] += 2.0 * P_store / cand.fsdp
    if cand.tp > 1:
        # 4 activation all-reduces a layer (forward and backward) of a
        # (B, S, D) tensor, at the same 2x convention.
        by_kind["all-reduce"] += (2.0 * 4.0 * cfg.n_layers
                                  * B * S_l * D * ab)
    if cand.sp > 1:
        # Ring rotations: ~3 full cycles of 2 kv-width blocks.
        by_kind["ppermute"] += (6.0 * cfg.n_layers * B * S_l
                                * kv_width * ab * (cand.sp - 1))
    comms = sum(by_kind.values())
    if calib is not None:
        comms_s = sum(calib.collective_seconds(k, b)
                      for k, b in by_kind.items() if b > 0)
    else:
        comms_s = comms / nominal_ici_bytes_per_s(target.chip)

    bubble = ((cand.pp - 1) / max(1, cfg.pp_microbatches)
              if cand.pp > 1 else 0.0)
    step_s = max(compute_s, comms_s) * (1.0 + bubble)
    tokens = global_batch * target.seq_len
    rec.update(
        feasible=True,
        reason="",
        compute_s=compute_s,
        comms_s=comms_s,
        comms_bytes=int(comms),
        comms_bytes_by_kind={k: int(b) for k, b in by_kind.items()
                             if b > 0},
        calibrated=calib is not None,
        tokens_per_step=tokens,
        score=tokens / step_s if step_s > 0 else 0.0,
    )
    return rec


def _score_serving(target: PlanTarget, cand: Candidate,
                   n_params: int | None, calib) -> dict:
    """The serving objectives' record (JAX's, term by term).

    - **decode**: aggregate decode tokens/s: ``batch_per_shard`` slots
      dealt over dp (one token each a step), feasibility params plus
      this device's share of the KV pool (split over dp x tp) plus the
      step's activations; fsdp pays a whole-weight all-gather every
      decode step (``n_params`` at the compute dtype), tp two
      activation all-reduces a layer.
    - **prefill**: aggregate prompt tokens/s of the batched lane
      program: ``batch_per_shard`` lanes of ``SERVING_PREFILL_CHUNK``
      tokens a launch, dealt over dp; fsdp pays the weight all-gather
      a launch, tp its activation all-reduces.

    ``quant="int8"`` prices the attention and MLP weights at one byte
    an element plus f32 per-channel scales (feasibility only)."""
    cfg = _tf_cfg(target, "none")
    if n_params is None:
        n_params = _n_params(target)
    pb = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.param_dtype]
    ab = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.dtype]
    S = target.seq_len
    B_shard = cand.batch_per_shard
    D = cfg.d_model
    params_dev = n_params * pb / (cand.fsdp * cand.tp)
    if target.quant == "int8":
        hd = cfg.head_dim
        q_elems = cfg.n_layers * (
            2 * D * cfg.n_heads * hd          # wq + wo
            + 2 * D * cfg.n_kv_heads * hd     # wk + wv
            + 2 * D * cfg.d_ff)               # mlp wi + wo
        s_elems = cfg.n_layers * (
            cfg.n_heads * hd                  # wq scales
            + 2 * cfg.n_kv_heads * hd         # wk + wv scales
            + D                               # wo scales
            + cfg.d_ff + D)                   # mlp wi + wo scales
        params_dev = ((n_params - q_elems) * pb + q_elems
                      + 4 * s_elems) / (cand.fsdp * cand.tp)
    kv_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * ab
    budget = hbm_budget_gib(target) * 2**30

    rec: dict = {
        "candidate": cand.key,
        "mesh": cand.mesh,
        "remat": cand.remat,
        "batch_per_shard": B_shard,
        "hbm_budget_gib": round(hbm_budget_gib(target), 6),
    }
    if target.quant != "none":
        rec["quant"] = target.quant
    if target.objective == "decode":
        slots = B_shard
        if slots % cand.dp:
            rec.update(feasible=False, reason="slots%dp", score=0.0)
            return rec
        slots_local = slots // cand.dp
        kv_dev = slots * S * kv_tok / (cand.dp * cand.tp)
        act_dev = slots_local * (4 * D + 2 * cfg.d_ff) * ab
        total = params_dev + kv_dev + act_dev
        rec["hbm_gib"] = round(total / 2**30, 6)
        rec["kv_pool_gib"] = round(kv_dev / 2**30, 6)
        rec["kv_capacity_tokens"] = int(
            max(0.0, budget - params_dev - act_dev)
            * cand.dp * cand.tp / kv_tok)
        if total > budget:
            rec.update(feasible=False, reason="hbm", score=0.0)
            return rec
        # The pool the engine should size: the residual budget spent
        # on KV pages (informational; the score ignores it).
        rec["kv_pool_tokens"] = max(slots * S,
                                    rec["kv_capacity_tokens"])
        rec["kv_pool_sized_gib"] = round(
            rec["kv_pool_tokens"] * kv_tok
            / (cand.dp * cand.tp) / 2**30, 6)
        rec["kv_pool_gib_delta"] = round(
            rec["kv_pool_sized_gib"] - rec["kv_pool_gib"], 6)
        # Forward FLOPs of one token over the aggregate batch (a third
        # of the fwd+bwd accounting); dp shards rows, tp the row math.
        model = _shape_model(cfg)
        flops_step = (model.flops_per_token(S) / 3.0) * slots
        flops_per_dev = flops_step / (cand.dp * cand.tp)
        by_kind = {}
        if cand.fsdp > 1:
            by_kind["all-gather"] = n_params * ab
        if cand.tp > 1:
            by_kind["all-reduce"] = 2.0 * 2.0 * cfg.n_layers \
                * slots_local * D * ab
        tokens = slots  # one token per sequence per step
    else:  # prefill: the batched multi-sequence lane program
        slots = B_shard
        if slots % cand.dp:
            rec.update(feasible=False, reason="slots%dp", score=0.0)
            return rec
        slots_local = slots // cand.dp
        C = SERVING_PREFILL_CHUNK
        kv_dev = slots * S * kv_tok / (cand.dp * cand.tp)
        act_dev = slots_local * C * (4 * D + 2 * cfg.d_ff) * ab
        total = params_dev + kv_dev + act_dev
        rec["hbm_gib"] = round(total / 2**30, 6)
        rec["kv_pool_gib"] = round(kv_dev / 2**30, 6)
        if total > budget:
            rec.update(feasible=False, reason="hbm", score=0.0)
            return rec
        model = _shape_model(cfg)
        flops_step = (model.flops_per_token(S) / 3.0) * C * slots
        flops_per_dev = flops_step / (cand.dp * cand.tp)
        by_kind = {}
        if cand.fsdp > 1:
            by_kind["all-gather"] = n_params * ab
        if cand.tp > 1:
            by_kind["all-reduce"] = 2.0 * 2.0 * cfg.n_layers \
                * slots_local * C * D * ab
        tokens = slots * C  # full chunk occupancy per launch

    if calib is not None:
        compute_s = flops_per_dev / calib.achievable_flops_per_s(
            flops_per_dev)
    else:
        compute_s = flops_per_dev / nominal_peak_flops_per_s(target.chip)
    if calib is not None:
        comms_s = sum(calib.collective_seconds(k, b)
                      for k, b in by_kind.items() if b > 0)
    else:
        comms_s = sum(by_kind.values()) \
            / nominal_ici_bytes_per_s(target.chip)
    step_s = max(compute_s, comms_s)
    rec.update(
        feasible=True,
        reason="",
        compute_s=compute_s,
        comms_s=comms_s,
        comms_bytes=int(sum(by_kind.values())),
        comms_bytes_by_kind={k: int(b) for k, b in by_kind.items()
                             if b > 0},
        calibrated=calib is not None,
        tokens_per_step=tokens,
        score=tokens / step_s if step_s > 0 else 0.0,
    )
    return rec


def rank_candidates(target: PlanTarget, calib="auto"
                    ) -> list[tuple[Candidate, dict]]:
    """Feasible candidates best-first. Deterministic: the sort key is
    (-score, fewest sharded axes, largest batch, remat order, mesh), so
    the same (target, calibration) can never rank two ways. The table is
    resolved once for the whole ranking."""
    if calib == "auto":
        calib = resolve_calibration(target).table
    n_params = _n_params(target)
    scored = [(c, score_candidate(target, c, n_params, calib=calib))
              for c in enumerate_candidates(target)]
    feasible = [(c, s) for c, s in scored if s["feasible"]]
    remat_order = {r: i for i, r in enumerate(REMAT_POLICIES)}

    def key(cs):
        c, s = cs
        sharded_axes = sum(1 for a in MESH_AXES if getattr(c, a) > 1)
        return (-s["score"], sharded_axes, -c.batch_per_shard,
                remat_order[c.remat],
                tuple(getattr(c, a) for a in MESH_AXES))

    return sorted(feasible, key=key)


# ---------------------------------------------------------------------------
# Sharding-map resolution
# ---------------------------------------------------------------------------


def base_strategy_for(mesh: dict) -> str:
    if mesh.get("tp", 1) > 1:
        return "tp"
    if mesh.get("fsdp", 1) > 1:
        return "fsdp"
    return "ddp"


def resolve_sharding_map(target: PlanTarget, mesh: dict) -> dict:
    """The resolved by-name map for one mesh: the base strategy's specs
    (``parallel/strategy.py`` stays the generator) over the model's
    shapes and logical axes, each serialized as JAX serializes a
    PartitionSpec: a per-dim list, trailing replicated dims dropped,
    ``None`` replicates, a string is one mesh axis, a list an axis
    tuple."""
    from distributed_training_tpu_torch.train.optimizer import flatten

    spec = MeshSpec(**{a: mesh.get(a, 1) for a in MESH_AXES})
    strat = get_strategy(base_strategy_for(mesh), spec,
                         min_shard_elems=target.min_shard_elems)
    model = _shape_model(_tf_cfg(target, "none"))
    specs = strat.specs_for_tree(flatten(model.param_shapes()),
                                 flatten(model.logical_axes()))
    return {path: [list(e) if isinstance(e, tuple) else e for e in s]
            for path, s in specs.items()}


def build_plan(target: PlanTarget, cand: Candidate,
               provenance: dict | None = None) -> Plan:
    """Materialize one candidate as a full Plan (no gate)."""
    mesh = cand.mesh
    return Plan(
        name=target.name,
        devices=target.devices,
        mesh=mesh,
        base_strategy=base_strategy_for(mesh),
        remat=cand.remat,
        batch_per_shard=cand.batch_per_shard,
        seq_len=target.seq_len,
        batch_axes=list(BATCH_AXES),
        sharding_map=resolve_sharding_map(target, mesh),
        inputs=target.as_dict(),
        provenance=provenance or {},
    )


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


# ---------------------------------------------------------------------------
# Stage 2: the torch gate (runs a step where JAX compiles one)
# ---------------------------------------------------------------------------

# The gate's limits between a plan's step and the same step unplanned:
# chip_smoke.py's TP_LOSS_RTOL and TP_GRAD_NORM_RTOL, the limits the
# port's sharded training phases hold a run to against its reference.
# The two runs share the layout and the program, so on the CPU they
# agree to the bit; the card's fused backward sums dq with atomics, so
# the gradient norm may move in its last bits.
GATE_LOSS_RTOL = 1e-4
GATE_GRAD_NORM_RTOL = 3e-3
# The gates' init and data seed.
GATE_SEED = 0


def gate_runtime(plan: Plan, device=None):
    """The runtime a gate runs ``plan`` on: a world of one on ``device``
    (None: the CUDA card) for a plan of one device; otherwise the mesh
    of the plan over the process group the caller started, whose world
    must be the plan's device count (collective: every process of the
    world calls it)."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.runtime import (
        Runtime,
        resolve_device,
        slice_runtime,
    )

    dev = resolve_device(device)
    if plan.devices == 1:
        return Runtime(device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != plan.devices:
        raise PlanError(
            f"plan '{plan.name}' spans {plan.devices} devices; its gate "
            f"runs in a process group of that many processes (this one "
            f"has {world}): start one process per device, e.g. through "
            "python -m distributed_training_tpu_torch.launch --nproc "
            f"{plan.devices}")
    return slice_runtime([plan_mesh_spec(plan)], dev)


def counter_snapshot() -> dict:
    """The collective counters the gates read: the fsdp gathers and
    their bytes, the tensor-parallel collectives, and the sp and pp
    exchanges."""
    from distributed_training_tpu_torch.parallel import fsdp, pipeline
    from distributed_training_tpu_torch.parallel import (
        ring_attention,
        tensor,
    )
    return {"fsdp_gathers": dict(fsdp.GATHERS),
            "fsdp_traffic": dict(fsdp.TRAFFIC),
            "tp_all_reduces": dict(tensor.ALL_REDUCES),
            "tp_all_gathers": dict(tensor.ALL_GATHERS),
            "sp_exchanges": dict(ring_attention.EXCHANGES),
            "pp_exchanges": dict(pipeline.EXCHANGES)}


def collective_evidence(before: dict, after: dict) -> dict:
    """JAX's collective evidence keys from two ``counter_snapshot``s:
    ``collective_bytes_per_step`` the bytes the counters carry (fsdp's
    gathered and reduce-scattered tensors, the ring's and the
    pipeline's exchanged blocks), ``total_collectives`` the
    collectives they count (fsdp gathers, tp all-reduces and
    all-gathers, ring rotations and all-to-alls, pipeline sends and
    broadcasts), and ``counters`` every delta."""
    delta = {g: {k: after[g].get(k, 0) - before[g].get(k, 0)
                 for k in after[g] if after[g].get(k, 0) != before[g].get(
                     k, 0)}
             for g in after}
    nbytes = (delta["fsdp_traffic"].get("gathered_bytes", 0)
              + delta["fsdp_traffic"].get("reduce_scattered_bytes", 0)
              + delta["sp_exchanges"].get("bytes", 0)
              + delta["pp_exchanges"].get("bytes", 0))
    count = (sum(delta["fsdp_gathers"].values())
             + sum(delta["tp_all_reduces"].values())
             + sum(delta["tp_all_gathers"].values())
             + delta["sp_exchanges"].get("rotations", 0)
             + delta["sp_exchanges"].get("all_to_all", 0)
             + delta["pp_exchanges"].get("sends", 0)
             + delta["pp_exchanges"].get("broadcasts", 0))
    return {"collective_bytes_per_step": int(nbytes),
            "total_collectives": int(count), "counters": delta}


def all_agree(flag: bool, rt) -> bool:
    """``flag`` held by every process of ``rt``'s mesh (every process of
    a search takes the same decision)."""
    if rt.mesh is None:
        return flag
    import torch
    import torch.distributed as dist
    t = torch.tensor([int(flag)], dtype=torch.int64, device=rt.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=rt.group(MESH_AXES))
    return bool(t.item())


def _gate_step(target: PlanTarget, plan: Plan, rt, sharding_plan: str,
               seed: int) -> dict:
    """One training step of ``plan``'s model, config and batch on
    ``rt``: under the plan file ``sharding_plan``, or ('') under the
    plan's base strategy. Returns the step's loss, gradient norm, device
    time and (on the card) peak allocated bytes."""
    import time

    import torch

    from distributed_training_tpu_torch.config import Config
    from distributed_training_tpu_torch.data import ShardedDataLoader
    from distributed_training_tpu_torch.data.datasets import (
        SyntheticLMDataset,
    )
    from distributed_training_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.train.trainer import Trainer

    mk = model_kwargs_for(plan)
    cfg = Config()
    t = cfg.train
    t.sharding_plan = sharding_plan
    t.parallel_strategy = plan.base_strategy
    t.min_shard_elems = target.min_shard_elems
    t.batch_size = plan.batch_per_shard
    t.dtype = mk.get("dtype", "float32")
    t.optimizer = target.optimizer if target.optimizer != "none" else "sgd"
    t.seed = seed
    t.log_every = 0
    t.save_every = 0
    t.straggler_every = 0
    model = Transformer(TransformerConfig(**mk), device=rt.device)
    ds = SyntheticLMDataset(size=2 * plan.global_batch, seq_len=plan.seq_len,
                            vocab_size=mk["vocab_size"], seed=seed)
    loader = ShardedDataLoader(ds, rt, batch_size=plan.batch_per_shard,
                               shuffle=False)
    trainer = Trainer(cfg, rt, model, loader)
    batch = next(iter(loader.epoch(0)))
    cuda = rt.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(rt.device)
        torch.cuda.reset_peak_memory_stats(rt.device)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
    else:
        start = time.perf_counter()
    metrics = trainer.train_step(batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    out = {"loss": loss, "grad_norm": gnorm}
    if cuda:
        t1.record()
        torch.cuda.synchronize(rt.device)
        out["step_ms"] = t0.elapsed_time(t1)
        out["peak_bytes"] = torch.cuda.max_memory_allocated(rt.device)
    else:
        out["step_ms"] = (time.perf_counter() - start) * 1e3
    del trainer, model
    return out


def compile_verify(target: PlanTarget, plan: Plan, device=None, *,
                   planned_seed: int | None = None) -> dict:
    """The torch gate for a training plan (JAX's name; JAX compiles the
    step abstractly and counts SPMD reshard warnings).

    Trains one step of the plan through the port's trainer under
    ``train.sharding_plan`` (the plan saved to a temporary file, read
    as a run reads it) on the plan's mesh, then the same step unplanned
    (the plan's base strategy on the same mesh) with the same config,
    init and batch (``GATE_SEED``). ``device``: the gate's device (None: the
    card; ``"cpu"`` as the tests run it); a plan of more than one
    device runs in the caller's process group (``gate_runtime``).
    ``planned_seed`` gives the planned run another init (a planted
    fault; None: ``GATE_SEED``).

    Returns JAX's four evidence keys (``spmd_reshard_warnings`` is 0:
    eager PyTorch has no partitioner to warn; the collective keys from
    the port's counters over the planned step, ``collective_evidence``)
    and ``gate``: both runs' losses and gradient norms, their limits,
    and ``agree``, agreed by every process. ``plan_search``
    disqualifies a candidate whose gate disagrees."""
    import tempfile

    rt = gate_runtime(plan, device)
    with tempfile.TemporaryDirectory(prefix="dtt_plan_gate_") as td:
        path = save_plan(plan, os.path.join(td, f"{plan.name}.json"))
        before = counter_snapshot()
        planned = _gate_step(
            target, plan, rt, path,
            GATE_SEED if planned_seed is None else planned_seed)
        after = counter_snapshot()
    unplanned = _gate_step(target, plan, rt, "", GATE_SEED)

    def close(a, b, rtol):
        return abs(a - b) <= rtol * abs(b)

    agree = all_agree(
        close(planned["loss"], unplanned["loss"], GATE_LOSS_RTOL)
        and close(planned["grad_norm"], unplanned["grad_norm"],
                  GATE_GRAD_NORM_RTOL), rt)
    ev = collective_evidence(before, after)
    return {
        "spmd_reshard_warnings": 0,
        "reshard_ops": [],
        "collective_bytes_per_step": ev["collective_bytes_per_step"],
        "total_collectives": ev["total_collectives"],
        "gate": {"planned": planned, "unplanned": unplanned,
                 "loss_rtol": GATE_LOSS_RTOL,
                 "grad_norm_rtol": GATE_GRAD_NORM_RTOL,
                 "agree": agree, "device": str(rt.device),
                 "counters": ev["counters"]},
    }


def gate_failed(evidence: dict) -> bool:
    """Whether a gate's evidence disqualifies its candidate: JAX's
    reshard warnings, or the port's run gate disagreeing."""
    return bool(evidence["spmd_reshard_warnings"]) or not evidence.get(
        "gate", {}).get("agree", True)


def verify_fn_for(target: PlanTarget) -> Callable:
    """The gate matching the target's objective: the training step for
    "train" plans, the serving engine's (``serving/disagg.py::
    compile_verify_serving``) for serving plans."""
    if target.objective == "train":
        return compile_verify
    from distributed_training_tpu_torch.serving.disagg import (
        compile_verify_serving,
    )
    return compile_verify_serving


def plan_search(target: PlanTarget,
                verify_fn: Callable | None = None) -> Plan:
    """The full search: rank analytically, then walk the candidates
    best-first through the gate (``verify_fn``; default
    ``verify_fn_for(target)`` on the card) until one passes. That one
    becomes the plan, with the ranking, every disqualification and the
    winner's evidence recorded as provenance. Raises ``PlanError`` when
    nothing is feasible or every gated candidate (top
    ``target.max_compiles``) fails."""
    verify = verify_fn or verify_fn_for(target)
    lookup = resolve_calibration(target)
    calib, calib_note = lookup.table, lookup.note
    if lookup.status == "unusable":
        print(f"[planner] WARNING: {calib_note}")
    ranked = rank_candidates(target, calib=calib)
    if not ranked:
        raise PlanError(
            f"target '{target.name}': no feasible candidate "
            f"(devices={target.devices}, budget "
            f"{hbm_budget_gib(target):.2f} GiB)")
    ranking = [{"candidate": c.key, "score": s["score"]}
               for c, s in ranked]
    disqualified: list[dict] = []
    for i, (cand, score) in enumerate(ranked[:target.max_compiles]):
        plan = build_plan(target, cand)
        evidence = verify(target, plan)
        if gate_failed(evidence):
            entry = {"candidate": cand.key,
                     "spmd_reshard_warnings":
                         evidence["spmd_reshard_warnings"],
                     "reshard_ops": evidence.get("reshard_ops", [])}
            if "gate" in evidence:
                entry["gate"] = evidence["gate"]
            disqualified.append(entry)
            continue
        plan.provenance = {
            "rank": i,
            "score": score,
            "ranking": ranking,
            "disqualified": disqualified,
            "compile_evidence": evidence,
            "calibration": calibration_provenance(
                target, calib, calib_note),
        }
        return plan
    raise PlanError(
        f"target '{target.name}': every gated candidate "
        f"(top {target.max_compiles}) failed its gate (involuntary-"
        f"reshard warnings, or a run off its unplanned step): "
        f"{disqualified}")


# ---------------------------------------------------------------------------
# PlannedStrategy: the trainer-facing consumer of a plan
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# HBM plan records (benchmarks/plan_memory.py's rows)
# ---------------------------------------------------------------------------


def hbm_plan_record(name: str, preset: str, chip: str,
                    overrides: dict, layout: dict) -> dict:
    """One memory-plan record from ``utils/memory.py``'s estimate, the
    model the planner scores candidates with, in JAX's form."""
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.utils.memory import (
        HBM_GIB,
        estimate_transformer_memory,
    )

    cfg = TransformerConfig(dtype="bfloat16",
                            **{**PRESETS[preset], **overrides})
    est = estimate_transformer_memory(cfg, **layout)
    return {
        "plan": name,
        "preset": preset,
        "chip": chip,
        "hbm_gib": HBM_GIB[chip],
        "overrides": overrides,
        "layout": layout,
        "params_gib": round(est.params_gib, 2),
        "grads_gib": round(est.grads_gib, 2),
        "opt_gib": round(est.opt_gib, 2),
        "activations_gib": round(est.activations_gib, 2),
        "total_gib": round(est.total_gib, 2),
        "fits": est.fits(chip),
    }


# ---------------------------------------------------------------------------
# --check: the committed plan is still what the planner would choose
# ---------------------------------------------------------------------------


def check_plan(target: PlanTarget, compile_winner: bool = False,
               device=None) -> list[str]:
    """Ratchet-style verification of one committed plan (JAX's checks
    and problem strings). Returns problem strings (empty = clean):

    - the committed plan must load, be for this target's inputs, and
      carry a self-consistent fingerprint;
    - the calibration that scored it must still be the one the chip
      resolves to (same source, same table fingerprint);
    - the stage-1 ranking must equal the one recorded at plan time;
    - the winner (ranking minus recorded disqualifications) must be the
      committed candidate, and the re-resolved map must hash to the
      committed fingerprint;
    - the recorded evidence must say zero reshard warnings. With
      ``compile_winner`` the port's gate re-runs the winner on
      ``device`` (``verify_fn_for``) and must pass.
    """
    problems: list[str] = []
    try:
        committed = load_plan(target.name)
    except (PlanError, FileNotFoundError) as e:
        return [f"{target.name}: cannot load committed plan: {e}"]
    if _canon(committed.inputs) != _canon(target.as_dict()):
        problems.append(
            f"{target.name}: committed plan was resolved for "
            "different search inputs — re-run planner --write")
        return problems
    lookup = resolve_calibration(target)
    calib, calib_note = lookup.table, lookup.note
    if lookup.status == "unusable":
        problems.append(f"{target.name}: {calib_note}")
        return problems
    recorded_calib = committed.provenance.get("calibration", {})
    current_fp = calib.fingerprint() if calib is not None else None
    if recorded_calib.get("fingerprint") != current_fp:
        problems.append(
            f"{target.name}: calibration drift — plan was scored "
            f"from {recorded_calib.get('source', 'nominal')} "
            f"(fingerprint {recorded_calib.get('fingerprint')}), the "
            f"chip now resolves to fingerprint {current_fp} "
            f"({calib_note}) — re-run planner --write")
        return problems
    ranked = rank_candidates(target, calib=calib)
    ranking = [{"candidate": c.key, "score": s["score"]}
               for c, s in ranked]
    recorded = committed.provenance.get("ranking", [])
    if ranking != recorded:
        problems.append(
            f"{target.name}: stage-1 ranking changed (cost model or "
            "search space drift) — re-run planner --write")
        return problems
    dq = {d["candidate"]
          for d in committed.provenance.get("disqualified", [])}
    expect = next((c for c, _s in ranked if c.key not in dq), None)
    committed_key = committed.candidate_key
    if expect is None or expect.key != committed_key:
        problems.append(
            f"{target.name}: search winner is "
            f"{expect.key if expect else None}, committed plan is "
            f"{committed_key} — re-run planner --write")
        return problems
    rebuilt = build_plan(target, expect, provenance=committed.provenance)
    if rebuilt.fingerprint() != committed.fingerprint():
        problems.append(
            f"{target.name}: re-resolved sharding map no longer "
            f"matches the committed plan (fingerprint "
            f"{rebuilt.fingerprint()} != {committed.fingerprint()}) "
            "— strategy rules drifted; re-run planner --write")
        return problems
    ev = committed.provenance.get("compile_evidence", {})
    if ev.get("spmd_reshard_warnings", None) != 0:
        problems.append(
            f"{target.name}: committed plan carries no clean compile "
            "evidence — re-run planner --write")
    if compile_winner and not problems:
        fresh = verify_fn_for(target)(target, rebuilt, device)
        if gate_failed(fresh):
            problems.append(
                f"{target.name}: the winner fails the port's gate on "
                f"this machine ({fresh.get('gate')}) — the layout needs "
                "re-planning")
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _init_world(device) -> None:
    """Join the process group a launcher described (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) for the gates of
    plans over more than one device: gloo on the CPU, NCCL on cards."""
    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not dist.is_initialized():
        dist.init_process_group(
            "gloo" if device == "cpu" else "nccl")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.parallel.planner",
        description="Auto-parallelism planner: search mesh x remat x "
                    "batch, check the committed sharding plans, or write "
                    "searched plans elsewhere.")
    ap.add_argument("--targets", default="",
                    help="comma-separated plan target names (default: all)")
    ap.add_argument("--write", action="store_true",
                    help="run the full search (the gate included) and "
                         "write <name>.json for each target under --out")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="with --write: the directory to write into (not "
                         "conf/plans/, whose files are the JAX planner's "
                         "committed artifacts)")
    ap.add_argument("--check", action="store_true",
                    help="verify each committed plan is still the "
                         "deterministic search winner and carries clean "
                         "evidence (exit 1 otherwise)")
    ap.add_argument("--compile", action="store_true",
                    help="with --check: also re-run each winner through "
                         "the port's gate")
    ap.add_argument("--device", default=None,
                    help="the gates' device (default: the CUDA card; "
                         "'cpu' on a machine without one); a plan over "
                         "more than one device runs in a world of that "
                         "many processes started by a launcher")
    args = ap.parse_args(argv)

    if args.write:
        if not args.out:
            ap.error("--write needs --out DIR")
        if os.path.realpath(args.out) == os.path.realpath(PLANS_DIR):
            ap.error(f"--out {args.out}: {PLANS_DIR} holds the JAX "
                     "planner's committed plans, which the port does not "
                     "rewrite; write elsewhere")
    if args.write or args.compile:
        _init_world(args.device)
    import torch.distributed as dist
    lead = not dist.is_initialized() or dist.get_rank() == 0

    names = [n for n in args.targets.split(",") if n] or None
    targets = resolve_targets(names)
    rc = 0
    for t in targets:
        if args.write:
            plan = plan_search(
                t, lambda tt, p: verify_fn_for(tt)(tt, p, args.device))
            if not lead:
                continue
            path = save_plan(plan, os.path.join(args.out, f"{t.name}.json"))
            ev = plan.provenance["compile_evidence"]
            cal = plan.provenance.get("calibration", {})
            print(f"[planner] {t.name}: wrote {path}")
            print(f"[planner]   mesh="
                  f"{ {a: s for a, s in plan.mesh.items() if s > 1} } "
                  f"remat={plan.remat} batch/shard="
                  f"{plan.batch_per_shard} fingerprint="
                  f"{plan.fingerprint()}")
            print(f"[planner]   gate agrees="
                  f"{ev.get('gate', {}).get('agree')} collective_bytes="
                  f"{ev['collective_bytes_per_step']}")
            print(f"[planner]   cost model: "
                  f"{cal.get('source', 'nominal')} "
                  f"({cal.get('note', '')})")
        elif args.check:
            problems = check_plan(t, compile_winner=args.compile,
                                  device=args.device)
            if not lead:
                continue
            for p in problems:
                print(f"[planner] {p}")
            if problems:
                rc = 1
            else:
                plan = load_plan(t.name)
                cal = plan.provenance.get("calibration", {})
                print(f"[planner] {t.name}: OK "
                      f"(fingerprint {plan.fingerprint()}, "
                      f"reshard-clean, winner unchanged, "
                      f"cost model {cal.get('source', 'nominal')}"
                      + (f"@{cal['fingerprint']}"
                         if cal.get("fingerprint") else "") + ")")
        else:
            ranked = rank_candidates(t)
            print(f"[planner] {t.name}: "
                  f"{len(enumerate_candidates(t))} candidates, "
                  f"{len(ranked)} feasible; top 5:")
            for c, s in ranked[:5]:
                print(f"[planner]   {c.key:40s} score={s['score']:.3e}"
                      f" hbm={s['hbm_gib']:.3f}GiB")
    if dist.is_initialized():
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    import sys
    sys.exit(main())

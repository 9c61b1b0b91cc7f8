"""Named audit targets: config × strategy pairs the audit gates (port of
``analysis/targets.py``).

A target pins everything that determines the step's collectives — mesh
shape, strategy, model kwargs, batch/seq — so a finding's fingerprint is
reproducible run over run and the committed baseline
(``spmd_baseline.json``) stays meaningful. The names, fields and values
are the JAX package's, so a finding ratchets under the same fingerprint
in both packages:

- ``multichip_r05_tp_sp_fsdp``: the 8-device tp+sp+fsdp configuration
  (windowed GQA ring attention over ``sp``);
- ``single_chip_headline``: gpt2_125m at seq 1024, batch 4, bf16 (the
  single-chip headline configuration). One device: zero collectives and
  zero findings;
- ``multichip_r06_planned``: the committed plan
  ``conf/plans/multichip_8dev.json``, trained under
  ``train.sharding_plan``;
- ``serving_decode_planned``/``serving_prefill_planned``/
  ``serving_resident_planned``: the committed serving plans' engine
  launches (``serving/disagg.py::compile_verify_serving``).

JAX's ``min_overlap`` and ``compiler_options`` fields are not carried:
they score and configure XLA's latency-hiding scheduler, which eager
PyTorch does not have (ROADMAP "Differences by design"). The plan files
are read as data; nothing here imports the planner.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

PLANS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "conf", "plans")


@dataclass(frozen=True)
class AuditTarget:
    name: str
    title: str
    devices: int
    strategy: str
    model: str
    model_kwargs: dict = field(default_factory=dict)
    batch_size: int = 4
    seq_len: int = 32
    mesh_axes: dict = field(default_factory=dict)
    train_overrides: dict = field(default_factory=dict)
    # Finding codes this target pins to ZERO: unlike the baseline
    # ratchet (which lets KNOWN findings ride), a pinned code fails
    # --check even if its fingerprints are baselined.
    pin_zero: tuple = ()
    # "train": one step of the port's Trainer; "serving": the engine's
    # gated launch under the committed plan ``serving_plan``
    # (``serving_objective`` "decode", "prefill" or "resident").
    kind: str = "train"
    serving_plan: str = ""
    serving_objective: str = "decode"
    note: str = ""


TARGETS: dict[str, AuditTarget] = {}


def _register(t: AuditTarget) -> AuditTarget:
    TARGETS[t.name] = t
    return t


_register(AuditTarget(
    name="multichip_r05_tp_sp_fsdp",
    title="8-device tp+sp+fsdp dryrun (windowed GQA ring attention)",
    devices=8,
    strategy="tp",
    model="transformer",
    model_kwargs=dict(vocab_size=256, d_model=64, n_heads=4,
                      dtype="float32", max_seq_len=32, n_layers=2,
                      n_kv_heads=2, attention_impl="ring",
                      attention_window=24),
    batch_size=2,
    seq_len=32,
    mesh_axes=dict(fsdp=2, sp=2, tp=2),
    train_overrides=dict(min_shard_elems=1, dtype="float32",
                         optimizer="adamw"),
    pin_zero=("SPMD001",),
    note="The tp+sp+fsdp configuration. The ring's sends run over the "
         "sp group, so each is labelled sp (JAX's compiled permutes "
         "carry source-target pairs that match no axis grouping and "
         "are baselined there as SPMD002).",
))

_register(AuditTarget(
    name="single_chip_headline",
    title="gpt2_125m single-chip headline (0.4392 MFU config)",
    devices=1,
    strategy="ddp",
    model="gpt2_125m",
    model_kwargs=dict(remat=True, remat_policy="mlp",
                      dtype="bfloat16"),
    batch_size=4,
    seq_len=1024,
    mesh_axes={},
    train_overrides=dict(dtype="bfloat16", optimizer="adamw"),
    pin_zero=("SPMD001",),
    note="The headline configuration (seq 1024, adamw bf16). Single "
         "device: zero collectives — any finding here is a regression.",
))


def _read_plan(plan_file: str) -> dict | None:
    """A committed plan's JSON, or None when it is absent or unreadable
    (the planner's --check gate names that problem)."""
    path = os.path.join(PLANS_DIR, plan_file)
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _register_planned_target() -> None:
    """The committed plan as an audit target, its configuration pinned
    from the plan file, trained under ``train.sharding_plan``."""
    plan = _read_plan("multichip_8dev.json")
    if plan is None:
        return
    mk = dict(plan["inputs"]["model_kwargs"])
    if plan["remat"] == "none":
        mk["remat"] = False
    else:
        mk.update(remat=True, remat_policy=plan["remat"])
    _register(AuditTarget(
        name="multichip_r06_planned",
        title=f"8-device auto-planned config "
              f"(plan {plan['name']}@{plan['fingerprint']})",
        devices=plan["devices"],
        strategy=plan["base_strategy"],
        model="transformer",
        model_kwargs=mk,
        batch_size=plan["batch_per_shard"],
        seq_len=plan["seq_len"],
        mesh_axes={a: s for a, s in plan["mesh"].items() if s > 1},
        train_overrides=dict(
            sharding_plan=plan["name"],
            min_shard_elems=plan["inputs"]["min_shard_elems"],
            dtype=mk.get("dtype", "float32"),
            optimizer=plan["inputs"]["optimizer"]),
        pin_zero=("SPMD001",),
        note="The committed auto-parallelism plan (conf/plans/) trained "
             "through the trainer's PlannedStrategy path.",
    ))


def _register_serving_target(plan_file: str, name: str, objective: str,
                             title: str, note: str) -> None:
    """A committed serving plan's engine launch as an audit target."""
    plan = _read_plan(plan_file)
    if plan is None:
        return
    _register(AuditTarget(
        name=name,
        title=f"{title} (plan {plan['name']}@{plan['fingerprint']})",
        devices=plan["devices"],
        strategy=plan["base_strategy"],
        model="transformer",
        model_kwargs=dict(plan["inputs"]["model_kwargs"]),
        batch_size=plan["batch_per_shard"],
        seq_len=plan["seq_len"],
        mesh_axes={a: s for a, s in plan["mesh"].items() if s > 1},
        pin_zero=("SPMD001",),
        kind="serving",
        serving_plan=plan["name"],
        serving_objective=objective,
        note=note,
    ))


_register_planned_target()
_register_serving_target(
    "serving_8dev_cpu_decode.json", "serving_decode_planned",
    "decode", "serving paged-KV decode step",
    note="The committed serving decode plan: one decode step of the "
         "engine laid out by it (serving/disagg.py "
         "compile_verify_serving).",
)
_register_serving_target(
    "serving_4dev_cpu_prefill.json", "serving_prefill_planned",
    "prefill", "serving batched multi-sequence prefill",
    note="The committed serving prefill plan: one batched prefill "
         "launch of the engine laid out by it.",
)
_register_serving_target(
    "serving_8dev_cpu_decode.json", "serving_resident_planned",
    "resident", "serving device-resident K-step decode loop",
    note="The committed serving decode plan under the resident cadence. "
         "The port's resident burst replays one step's launches K times "
         "(one CUDA graph on the card), so its collectives per step are "
         "the decode step's: the audit runs that step.",
)


def resolve(names=None) -> list[AuditTarget]:
    """Targets by name (all when ``names`` is falsy); unknown names
    raise with the available set spelled out."""
    if not names:
        return list(TARGETS.values())
    out = []
    for n in names:
        if n not in TARGETS:
            raise KeyError(
                f"unknown audit target '{n}'; available: "
                f"{sorted(TARGETS)}")
        out.append(TARGETS[n])
    return out

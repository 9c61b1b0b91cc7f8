"""Sharding plans in the port (the read side of ``parallel/planner.py``),
held against the JAX package.

- Every committed plan in ``conf/plans/`` loads in the port with JAX's
  fingerprint, ``to_doc()``, candidate key and batch; a copy with its
  sharding map or its provenance edited by hand is refused with
  ``PlanError``, as JAX refuses it.
- ``PlannedStrategy``'s placements equal the base strategy's leaf for
  leaf on each serving plan's model, and its specs equal the plan's
  entries; an unknown path and the path-less ``param_spec`` raise.
- ``apply_plan_to_config`` and ``check_plan_runtime`` as JAX's
  ``tests/test_planner.py`` checks them (the committed plans whose model
  names ring attention run: ``tests/test_torch_ring.py``).
- ``checkpoint/export.py``'s stamp (``--plan``, auto-detected from the
  run's ``resolved_config.yaml``, or ``none``) equals JAX's
  ``_plan_provenance``, and an export carries it into the artifact.
- Training under a plan: a plan built with JAX's ``build_plan`` and
  ``save_plan`` for the model and target of JAX's
  ``test_planner_to_train_e2e_loss_parity`` at 4 devices and the
  candidate fsdp 2 x tp 2. In one spawned gloo world of 4
  (``test_torch_plan_world.py``), three steps through the port's CLI
  under ``train.sharding_plan`` give the losses of the CLI's unplanned
  ``tp_fsdp`` run within 1e-6, and those of JAX's trainer under the
  same plan, config and init (the port CLI's, from ``train.seed``) on 4
  CPU devices within 1e-5. In the same world a plan of the candidate
  fsdp 2 x sp 2 whose model names ring attention trains through the CLI
  to the losses of JAX's trainer under it within 1e-5. A plan whose mesh
  is not the runtime's raises at trainer construction.
- The planner's search with its real gate: in the same world the port's
  ``plan_search`` on JAX's e2e target at 4 devices runs the gate
  (``compile_verify``: one step of the candidate under its plan and
  unplanned, on the CPU) and chooses the plan JAX's ``build_plan`` makes
  of JAX's stage-1 winner, fingerprint for fingerprint; the gate's two
  losses agree, and every process chose alike.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import export as port_export
from distributed_training_tpu_torch.checkpoint.consolidate import (
    load_consolidated,
)
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.registry import (
    build_model as port_build,
)
from distributed_training_tpu_torch.parallel import planner as port_planner
from distributed_training_tpu_torch.parallel.strategy import (
    get_strategy,
    layout,
)
from distributed_training_tpu_torch.runtime import MeshSpec, Runtime
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten
from distributed_training_tpu_torch.train.trainer import Trainer

jax = pytest.importorskip("jax")

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.checkpoint import export as jax_export  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.data import build_dataset as jax_build_dataset  # noqa: E402
from distributed_training_tpu.models import build_model as jax_build  # noqa: E402
from distributed_training_tpu.parallel import planner as jax_planner  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_plan_world.py")
sys.path.insert(0, os.path.dirname(WORKER))
from test_torch_plan_world import STEPS, cli_overrides  # noqa: E402
PLANS = sorted(f[:-5] for f in os.listdir(port_planner.PLANS_DIR)
               if f.endswith(".json"))
SERVING = [p for p in PLANS if p.startswith("serving_")]
# JAX's test_planner.py e2e model and target, at 4 devices.
E2E_MODEL = dict(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=2,
                 n_layers=2, max_seq_len=16, dtype="float32",
                 attention_impl="naive")
E2E_MESH = {"dp": 1, "fsdp": 2, "tp": 2}
# The same model under ring attention, planned on fsdp 2 x sp 2.
E2E_RING_MODEL = dict(E2E_MODEL, attention_impl="ring")
E2E_RING_MESH = {"dp": 1, "fsdp": 2, "sp": 2}
# JAX's e2e target (test_planner.py) at the world's 4 devices.
E2E_SEARCH = dict(name="e2e_tiny", devices=4, model_kwargs=E2E_MODEL,
                  seq_len=16, optimizer="adamw", batch_candidates=(2,),
                  remat_candidates=("none",))


# -- plan files ----------------------------------------------------------------


@pytest.mark.parametrize("name", PLANS)
def test_committed_plan_loads_as_jax_loads_it(name):
    got, want = port_planner.load_plan(name), jax_planner.load_plan(name)
    assert got.fingerprint() == want.fingerprint()
    assert got.to_doc() == want.to_doc()
    with open(port_planner.plan_path(name)) as f:
        assert got.to_doc() == json.load(f)
    assert (got.candidate_key, got.data_shards, got.global_batch) == \
        (want.candidate_key, want.data_shards, want.global_batch)


def _edit_map(doc):
    key = sorted(doc["sharding_map"])[0]
    doc["sharding_map"][key] = [None] * len(doc["sharding_map"][key])


def _edit_provenance(doc):
    doc["provenance"]["rank"] = 99


@pytest.mark.parametrize("edit", [_edit_map, _edit_provenance],
                         ids=["sharding_map", "provenance"])
def test_hand_edited_plan_is_refused(edit, tmp_path):
    with open(port_planner.plan_path("serving_4dev_cpu_decode")) as f:
        doc = json.load(f)
    edit(doc)
    path = str(tmp_path / "edited.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(jax_planner.PlanError, match="integrity"):
        jax_planner.load_plan(path)
    with pytest.raises(port_planner.PlanError, match="integrity"):
        port_planner.load_plan(path)
    # Without the integrity digest the fingerprint still catches a map
    # edit.
    if edit is _edit_map:
        del doc["integrity"]
        with open(path, "w") as f:
            json.dump(doc, f)
        with pytest.raises(port_planner.PlanError, match="fingerprint"):
            port_planner.load_plan(path)


def test_save_plan_round_trips(tmp_path):
    plan = port_planner.load_plan("serving_4dev_cpu_prefill")
    path = port_planner.save_plan(plan, str(tmp_path / "p.json"))
    assert port_planner.load_plan(path).to_doc() == plan.to_doc()
    assert jax_planner.load_plan(path).fingerprint() == plan.fingerprint()
    with pytest.raises(port_planner.PlanError, match="no committed plan"):
        port_planner.load_plan("no_such_plan")


# -- PlannedStrategy -----------------------------------------------------------


@pytest.mark.parametrize("name", SERVING)
def test_planned_strategy_equals_the_base_strategy(name):
    plan = port_planner.load_plan(name)
    model = port_planner.model_for_plan(plan, device="cpu")
    shapes = flatten(model.param_shapes())
    logical = flatten(model.logical_axes())
    planned = port_planner.PlannedStrategy(plan=plan)
    base = get_strategy(plan.base_strategy, port_planner.plan_mesh_spec(plan),
                        min_shard_elems=plan.inputs["min_shard_elems"])
    assert planned.family == base.name == port_planner.base_strategy_for(
        plan.mesh)
    assert layout(planned, shapes, logical) == layout(base, shapes, logical)
    specs = planned.specs_for_tree(shapes, logical)
    assert specs == base.specs_for_tree(shapes, logical)
    for k, entries in plan.sharding_map.items():
        want = [tuple(e) if isinstance(e, list) else e for e in entries]
        while want and want[-1] is None:
            want.pop()
        assert specs[k] == tuple(want), k
    with pytest.raises(port_planner.PlanError, match="not_a_param"):
        planned.specs_for_tree({"not_a_param": (4, 4)}, {})
    with pytest.raises(port_planner.PlanError, match="path-less"):
        planned.param_spec((4, 4), None)


def test_apply_plan_to_config_derives_mesh_and_batch():
    """JAX ``tests/test_planner.py::test_apply_plan_to_config_derives_
    mesh_and_batch`` on the port's config."""
    for name in ("multichip_8dev", "serving_4dev_cpu_decode"):
        plan = port_planner.load_plan(name)
        cfg = port_config.Config()
        cfg.train.sharding_plan = name
        assert port_planner.apply_plan_to_config(cfg).fingerprint() == \
            plan.fingerprint()
        assert cfg.mesh.dp == -1
        for a in ("pp", "fsdp", "sp", "tp"):
            assert getattr(cfg.mesh, a) == plan.mesh[a]
        assert cfg.train.batch_size == plan.batch_per_shard
        cfg2 = port_config.Config()
        cfg2.train.sharding_plan = name
        cfg2.train.global_batch_size = 64
        cfg2.train.batch_size = 5
        port_planner.apply_plan_to_config(cfg2)
        assert cfg2.train.batch_size == 5


def test_check_plan_runtime_mesh_mismatch(monkeypatch):
    """JAX ``tests/test_planner.py::test_check_plan_runtime_mesh_
    mismatch``; the elastic default reads the same variable."""
    plan = port_planner.load_plan("multichip_8dev")
    good = MeshSpec(**plan.mesh)
    port_planner.check_plan_runtime(plan, good, elastic=False)
    bad = MeshSpec(pp=1, dp=2, fsdp=2, sp=1, tp=2)
    with pytest.raises(port_planner.PlanError, match="does not match plan"):
        port_planner.check_plan_runtime(plan, bad, elastic=False)
    dp_flex = MeshSpec(**{**plan.mesh, "dp": max(1, plan.mesh["dp"])})
    port_planner.check_plan_runtime(plan, dp_flex, elastic=True)
    with pytest.raises(port_planner.PlanError, match="does not match plan"):
        port_planner.check_plan_runtime(plan, bad, elastic=True)
    from distributed_training_tpu.resilience import elastic
    assert port_planner.ENV_WORLD == elastic.ENV_WORLD
    shrunk = MeshSpec(**{**plan.mesh, "dp": 2, "fsdp": plan.mesh["fsdp"]})
    monkeypatch.setenv(port_planner.ENV_WORLD, "16")
    port_planner.check_plan_runtime(plan, shrunk)
    monkeypatch.delenv(port_planner.ENV_WORLD)
    with pytest.raises(port_planner.PlanError, match="axis 'dp'"):
        port_planner.check_plan_runtime(plan, shrunk)


def test_model_kwargs_for_matches_jax():
    for name in PLANS:
        assert port_planner.model_kwargs_for(port_planner.load_plan(name)) \
            == jax_planner.model_kwargs_for(jax_planner.load_plan(name))
    plan = copy.deepcopy(port_planner.load_plan("serving_4dev_cpu_decode"))
    plan.remat = "mlp"
    assert port_planner.model_kwargs_for(plan)["remat_policy"] == "mlp"


# -- export provenance ---------------------------------------------------------


def test_export_stamps_what_jax_stamps(tmp_path):
    ckpt = str(tmp_path / "run" / "checkpoints")
    os.makedirs(os.path.join(ckpt, "1"))
    for plan in ("serving_4dev_cpu_decode", None, "none"):
        assert port_export._plan_provenance(ckpt, plan) == \
            jax_export._plan_provenance(ckpt, plan), plan
    assert port_export.plan_provenance is port_export._plan_provenance
    with open(tmp_path / "run" / "resolved_config.yaml", "w") as f:
        yaml.safe_dump({"train": {"sharding_plan":
                                  "serving_4dev_cpu_prefill"}}, f)
    want = jax_export._plan_provenance(ckpt, None)
    assert want["name"] == "serving_4dev_cpu_prefill"
    assert port_export._plan_provenance(ckpt, None) == want
    # An export carries the stamp into the artifact's meta.
    torch.save({"params": {"w": torch.ones(2)}, "opt_state": {}, "step": 1},
               os.path.join(ckpt, "1", "state.pt"))
    out = str(tmp_path / "a.pt")
    port_export.export(ckpt, out, plan="serving_4dev_cpu_decode")
    _state, meta = load_consolidated(out)
    assert meta["sharding_plan"] == jax_export._plan_provenance(
        ckpt, "serving_4dev_cpu_decode")
    port_export.export(ckpt, out)
    assert load_consolidated(out)[1]["sharding_plan"] == want
    port_export.export(ckpt, out, plan="none")
    assert "sharding_plan" not in load_consolidated(out)[1]


# -- training under a plan -----------------------------------------------------


def _e2e_plan(tmp_path, name: str = "e2e_tiny", model=None,
              mesh=None) -> str:
    model, mesh = model or E2E_MODEL, mesh or E2E_MESH
    target = jax_planner.PlanTarget(
        name=name, devices=4, model_kwargs=model, seq_len=16,
        optimizer="adamw", batch_candidates=(2,),
        remat_candidates=("none",))
    plan = jax_planner.build_plan(target, jax_planner.Candidate(
        1, mesh.get("dp", 1), mesh.get("fsdp", 1), mesh.get("sp", 1),
        mesh.get("tp", 1), "none", 2))
    return jax_planner.save_plan(plan, str(tmp_path / f"{name}.json"))


def _port_cli_init(overrides: list) -> dict:
    """The whole weights the port's CLI starts from under ``overrides``
    (its model's init from ``train.seed``), as numpy."""
    cfg = port_config.load_config(overrides=overrides)
    kw = dict(cfg.model.kwargs)
    model = port_build(cfg.model.name, loss=cfg.train.loss,
                       dtype=kw.pop("dtype", cfg.train.dtype),
                       device="cpu", **kw)
    return {k: t.numpy() for k, t in
            flatten(model.init(cfg.train.seed)).items()}


def _jax_cli_planned(overrides: list, init: dict, mesh: dict) -> list:
    """JAX's trainer as its CLI builds it from ``overrides`` (the plan
    applied to the config, the dataset, the loader, the model) on the 4
    CPU devices of ``mesh``, started from ``init``: the losses of its
    metric rows."""
    cfg = jax_config.load_config(overrides=overrides)
    jax_planner.apply_plan_to_config(cfg)
    rt = jax_runtime.fake_cpu_runtime(
        4, **{a: n for a, n in mesh.items() if a != "dp"})
    loader = JaxLoader(
        jax_build_dataset(cfg.train.dataset,
                          _defaults={"size": cfg.train.dataset_size,
                                     "seed": cfg.train.seed},
                          **cfg.train.dataset_kwargs), rt,
        batch_size=cfg.train.batch_size, shuffle=cfg.train.shuffle,
        seed=cfg.train.seed, drop_last=cfg.train.drop_last,
        max_steps_per_epoch=cfg.train.max_steps_per_epoch)
    kw = dict(cfg.model.kwargs)
    trainer = JaxTrainer(cfg, rt, jax_build(
        cfg.model.name, loss=cfg.train.loss,
        dtype=kw.pop("dtype", cfg.train.dtype), **kw), loader)
    assert trainer.strategy.name == "planned"
    trainer.state["params"] = jax.device_put(
        unflatten(init), trainer.state_shardings["params"])
    trainer.train()
    return [r["loss"] for r in trainer.metrics.history if "loss" in r]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawned world of 4's readings, and JAX's planned losses."""
    out = tmp_path_factory.mktemp("plan_world")
    plan = _e2e_plan(out)
    planned = cli_overrides(E2E_MODEL) + [f"train.sharding_plan={plan}"]
    jax_losses = _jax_cli_planned(planned, _port_cli_init(planned),
                                  E2E_MESH)
    ring_plan = _e2e_plan(out, "e2e_ring", E2E_RING_MODEL, E2E_RING_MESH)
    ring = cli_overrides(E2E_RING_MODEL) + [
        f"train.sharding_plan={ring_plan}"]
    jax_ring = _jax_cli_planned(ring, _port_cli_init(ring), E2E_RING_MESH)
    job = {"rdzv": str(out / "rdzv"), "out": str(out), "plan": plan,
           "model": E2E_MODEL, "mesh": E2E_MESH, "ring_plan": ring_plan,
           "ring_model": E2E_RING_MODEL, "search": E2E_SEARCH}
    with open(out / "job.json", "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(out / "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(
        log[-3000:] for log in logs)

    def cli_losses(run):
        with open(out / run / "default" / "metrics.jsonl") as f:
            return [r["loss"] for r in map(json.loads, f) if "loss" in r]
    searched = []
    for r in range(4):
        with open(out / f"searched.rank{r}.json") as f:
            searched.append(json.load(f))
    return {"planned": cli_losses("planned"),
            "unplanned": cli_losses("unplanned"),
            "jax_planned": jax_losses, "plan": plan,
            "ring_planned": cli_losses("ring_planned"),
            "jax_ring_planned": jax_ring, "searched": searched}


def test_cli_under_a_plan_matches_the_unplanned_layout(world):
    assert len(world["planned"]) == STEPS
    np.testing.assert_allclose(world["planned"], world["unplanned"],
                               rtol=1e-6, atol=1e-6)


def test_cli_under_a_plan_matches_jax_under_the_plan(world):
    """The port's CLI run under the plan gives the losses of JAX's
    trainer under the same plan, config and init on 4 CPU devices."""
    assert len(world["jax_planned"]) == STEPS
    np.testing.assert_allclose(world["planned"], world["jax_planned"],
                               rtol=1e-5, atol=1e-5)


def test_cli_under_a_ring_plan_matches_jax_under_the_plan(world):
    """A plan of fsdp 2 x sp 2 whose model names ring attention: the
    port's CLI under it gives the losses of JAX's trainer under it."""
    assert len(world["ring_planned"]) == STEPS
    np.testing.assert_allclose(world["ring_planned"],
                               world["jax_ring_planned"], rtol=1e-5,
                               atol=1e-5)


def test_trainer_rejects_plan_mesh_mismatch(world):
    """JAX ``tests/test_planner.py::test_trainer_rejects_plan_mesh_
    mismatch``: a world of one is not the plan's mesh."""
    cfg = port_config.Config()
    cfg.train.sharding_plan = world["plan"]
    cfg.train.batch_size = 2
    rt = Runtime(device=torch.device("cpu"))
    loader = ShardedDataLoader(
        SyntheticLMDataset(size=64, seq_len=16, vocab_size=64, seed=0), rt,
        batch_size=2)
    model = port_tf.Transformer(port_tf.TransformerConfig(**E2E_MODEL),
                                device="cpu")
    with pytest.raises(port_planner.PlanError, match="does not match plan"):
        Trainer(cfg, rt, model, loader)


def test_plan_search_with_the_real_gate_chooses_jaxs_winner(world):
    """The port's search in the world of 4, its gate run for real on the
    CPU: JAX's stage-1 winner, JAX's fingerprint, a gate that agrees."""
    target = jax_planner.PlanTarget(**E2E_SEARCH)
    winner = jax_planner.rank_candidates(target)[0][0]
    want = jax_planner.build_plan(target, winner).fingerprint()
    plans = [port_planner.Plan.from_doc(d) for d in world["searched"]]
    # Every process chose alike (their evidence holds their own timings).
    assert {p.fingerprint() for p in plans} == {want}
    plan = plans[0]
    assert plan.candidate_key == winner.key
    prov = plan.provenance
    assert (prov["rank"], prov["disqualified"]) == (0, [])
    gate = prov["compile_evidence"]["gate"]
    assert gate["agree"] and gate["device"] == "cpu"
    assert gate["planned"]["loss"] == pytest.approx(
        gate["unplanned"]["loss"], rel=port_planner.GATE_LOSS_RTOL)
    assert prov["compile_evidence"]["spmd_reshard_warnings"] == 0
    assert prov["calibration"]["source"] == "nominal"
    assert [r["candidate"] for r in prov["ranking"]] == [
        c.key for c, _s in jax_planner.rank_candidates(target)]

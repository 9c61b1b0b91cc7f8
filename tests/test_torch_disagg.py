"""Disaggregated serving of the port, held against the JAX package.

Float32 on the CPU, the committed serving plans' model
(``SERVING_MODEL_KWARGS``), the same weights on both sides (numpy,
seeded, biases drawn nonzero, the layers' weights scaled so that the
handed-over KV decides the tokens):

- ``engine_config_for_plan`` equals JAX's field for field on every
  committed serving plan, at the defaults and at other geometries;
- ``WeightStore`` gives JAX's three provenance outcomes (a matching
  stamp loads, a stale or missing plan raises ``ProvenanceError``, a
  stamp-less artifact loads with a warning), refuses an unknown
  quantization stamp, and ``params_for`` refuses a plan that does not
  name a leaf or whose mesh is not the runtime's;
- one process holding both engines (two plans at a mesh of 1, the
  card's form) gives the colocated engine's tokens and the JAX one's;
- one spawned gloo world of 8 (``test_torch_disagg_world.py``): the
  prefill slice under ``serving_4dev_cpu_prefill`` (dp 4, ranks 0–3)
  hands its KV to the decode slice under ``serving_4dev_cpu_decode``
  (dp 2 x tp 2, ranks 4–7); ``generate_many`` and ``generate`` give, on
  every rank, the tokens of the port's one-process engine and of JAX's
  one-process ``Engine`` (JAX's own pipeline is not a checked oracle on
  this container). On the decode mesh of 4, a stream stopped mid-way,
  exported and adopted back, and a drain with a deadline whose
  persisted work is adopted back, end with the uninterrupted tokens, and
  every rank persists the same requests;
- after an injected ``engine_crash`` the port server's 503 carries the
  ``Retry-After`` that JAX's does.
"""

import dataclasses
import http.client
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.checkpoint.consolidate import (
    write_artifact,
)
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
)
from distributed_training_tpu_torch.parallel import planner as port_planner
from distributed_training_tpu_torch.resilience import faults as port_faults
from distributed_training_tpu_torch.runtime import MeshSpec, Runtime
from distributed_training_tpu_torch.serving import disagg as port_disagg
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.serving.server import (
    ServingServer as PortServer,
)
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.parallel import planner as jax_planner  # noqa: E402
from distributed_training_tpu.resilience import faults as jax_faults  # noqa: E402
from distributed_training_tpu.serving import disagg as jax_disagg  # noqa: E402
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402
from distributed_training_tpu.serving.server import (  # noqa: E402
    ServingServer as JaxServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_disagg_world.py")
sys.path.insert(0, os.path.dirname(WORKER))
from test_torch_disagg_world import (  # noqa: E402
    DECODE,
    DECODE_RANKS,
    PREFILL,
    PREFILL_RANKS,
    disagg_prompts,
)

MODEL = jax_planner.SERVING_MODEL_KWARGS
NEW_TOKENS = 6
SERVING_PLANS = sorted(f[:-5] for f in os.listdir(port_planner.PLANS_DIR)
                       if f.startswith("serving_"))
SPAWN_TIMEOUT_S = 300


def _with_biases(tree: dict, rng) -> dict:
    """``tree`` (numpy) with every bias drawn from N(0, 0.1²): the init
    zeros them, and a bias added on every tp rank instead of once after
    the all-reduce must change the tokens."""
    return {k: _with_biases(v, rng) if isinstance(v, dict) else
            (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
             if k in ("bi", "bo", "bias") else v) for k, v in tree.items()}


def _sharpened(tree: dict, gain: float = 3.0) -> dict:
    """``tree`` with every layer's matmul weights and biases times
    ``gain``: at the init's scale the residual stream follows the last
    token and zeroing the handed-over KV changes one request's tokens in
    six; at 3 it changes all six."""
    return {k: _sharpened(v, gain) if isinstance(v, dict) else
            (v if k in ("tok_embed", "scale", "bias") else gain * v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    jm = Transformer(TransformerConfig(**MODEL))
    npp = _sharpened(_with_biases(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1))), np.random.default_rng(3)))
    pm = PortTransformer(PortConfig(**MODEL), device="cpu")
    pp = from_jax_params(npp, pm.cfg, device="cpu")
    return jm, jax.tree.map(jax.numpy.asarray, npp), pm, pp


def _artifact(path, params: dict, meta: dict) -> str:
    write_artifact(str(path), {"params": params}, meta)
    return str(path)


def _stamp(name: str) -> dict:
    plan = port_planner.load_plan(name)
    return {"sharding_plan": {"name": plan.name,
                              "fingerprint": plan.fingerprint()}}


# -- engine geometry -----------------------------------------------------------


@pytest.mark.parametrize("name", SERVING_PLANS)
def test_engine_config_for_plan_matches_jax(name):
    pplan = port_planner.load_plan(name)
    jplan = jax_planner.load_plan(name)
    for kw in ({}, dict(page_size=8, prefill_chunk=8),
               dict(prefill_mode="sequential"),
               dict(spec_k=4, resident_k=4)):
        want = jax_disagg.engine_config_for_plan(jplan, **kw)
        got = port_disagg.engine_config_for_plan(pplan, **kw)
        fields = [f.name for f in dataclasses.fields(want)]
        assert {f: getattr(got, f) for f in fields} == \
            dataclasses.asdict(want), (name, kw)


# -- the weight store ----------------------------------------------------------


def test_weight_store_provenance_gate(models, tmp_path, caplog):
    """JAX's three outcomes (``tests/test_serving.py``), and an unknown
    quantization stamp refused."""
    pp = models[3]
    plan = port_planner.load_plan(DECODE)
    store = port_disagg.WeightStore(
        _artifact(tmp_path / "good.pt", pp, _stamp(DECODE)))
    assert store.provenance == {"name": plan.name,
                                "fingerprint": plan.fingerprint()}
    assert store.quantization == "none"
    stale = _artifact(tmp_path / "stale.pt", pp, {"sharding_plan": {
        "name": plan.name, "fingerprint": "deadbeefdeadbeef"}})
    with pytest.raises(port_disagg.ProvenanceError, match="regenerated"):
        port_disagg.WeightStore(stale)
    gone = _artifact(tmp_path / "gone.pt", pp, {"sharding_plan": {
        "name": "no_such_plan", "fingerprint": "aa"}})
    with pytest.raises(port_disagg.ProvenanceError, match="no longer loads"):
        port_disagg.WeightStore(gone)
    legacy = _artifact(tmp_path / "legacy.pt", pp, {})
    with caplog.at_level(logging.WARNING):
        assert port_disagg.WeightStore(legacy).provenance is None
    assert any("no sharding-plan provenance" in r.message
               for r in caplog.records)
    odd = _artifact(tmp_path / "odd.pt", pp, {"quantization": "int4"})
    with pytest.raises(ValueError, match="unknown quantization 'int4'"):
        port_disagg.WeightStore(odd)
    int8 = _artifact(tmp_path / "int8.pt",
                     port_disagg.quantize_params_int8(pp),
                     {**_stamp(DECODE), "quantization": "int8"})
    assert port_disagg.WeightStore(int8).quantization == "int8"


def test_weight_store_params_for_checks_the_plan(models, tmp_path):
    """The whole weights on the device for a plan that names every leaf
    on its own mesh; a plan missing a leaf, or another mesh, raises."""
    pp = models[3]
    store = port_disagg.WeightStore(
        _artifact(tmp_path / "a.pt", pp, _stamp(DECODE)))
    plan = port_planner.load_plan(DECODE)
    rt = Runtime(device=torch.device("cpu"), spec=MeshSpec(dp=2, tp=2))
    got = flatten(store.params_for(rt, plan, "cpu"))
    assert got.keys() == flatten(pp).keys()
    assert all(torch.equal(got[k], v) for k, v in flatten(pp).items())
    with pytest.raises(port_planner.PlanError, match="does not match plan"):
        store.params_for(None, plan, "cpu")
    partial = dataclasses.replace(plan, sharding_map={
        k: v for k, v in plan.sharding_map.items() if k != "mlp/wi"})
    with pytest.raises(port_planner.PlanError, match="mlp/wi"):
        store.params_for(rt, partial, "cpu")


# -- the references ------------------------------------------------------------


def _requests(mod, prefix: str = "r") -> list:
    return [mod.Request(id=f"{prefix}{i}", prompt=p,
                        max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(disagg_prompts())]


_REFS: dict = {}


def _references(models) -> dict:
    """The tokens of the port's and JAX's one-process engines under the
    decode plan's geometry with the whole slot table and the pool of
    both dp groups, ``G·(N−1)+1``."""
    if _REFS:
        return _REFS
    jm, jp, pm, pp = models
    cfg = jax_disagg.engine_config_for_plan(jax_planner.load_plan(DECODE))
    G = 2
    kw = {**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
          "num_pages": G * (cfg.num_pages - 1) + 1}
    for name, mod, eng in (
            ("port", port_engine, port_engine.Engine(
                pm, pp, port_engine.EngineConfig(**kw), device="cpu")),
            ("jax", jax_engine, jax_engine.Engine(
                jm, jp, jax_engine.EngineConfig(**kw)))):
        for r in _requests(mod):
            eng.submit(r)
        eng.run_until_drained()
        _REFS[name] = {r["id"]: r["tokens"] for r in eng.completed}
    assert _REFS["port"] == _REFS["jax"]
    return _REFS


# -- one process, both engines -------------------------------------------------


def _mesh_one(name: str) -> port_planner.Plan:
    """A plan at a mesh of 1 with the committed plan ``name``'s model,
    slots and length, built in memory by the port's ``Plan``."""
    src = port_planner.load_plan(name)
    pm = PortTransformer(PortConfig(**MODEL), device="cpu")
    return port_planner.Plan(
        name=f"{name}_mesh1", devices=1,
        mesh={a: 1 for a in port_planner.MESH_AXES}, base_strategy="ddp",
        remat="none", batch_per_shard=src.batch_per_shard,
        seq_len=src.seq_len, batch_axes=["dp", "fsdp"],
        sharding_map={k: [] for k in flatten(pm.param_shapes())},
        inputs={"model_kwargs": dict(MODEL)})


def test_one_process_pipeline_matches_colocated_engine(models, tmp_path):
    refs = _references(models)
    store = port_disagg.WeightStore(
        _artifact(tmp_path / "a.pt", models[3], {}))
    pipe = port_disagg.DisaggPipeline(store, _mesh_one(PREFILL),
                                      _mesh_one(DECODE), device="cpu")
    assert pipe.prefill_engine.mesh is None
    assert pipe.decode_engine.mesh is None
    assert pipe.generate_many(_requests(port_engine)) == refs["port"]
    stats = dict(pipe.handoff_stats)
    c = pipe.model.cfg
    kv_tokens = sum(len(p) for p in disagg_prompts())
    assert stats["items"] == len(disagg_prompts())
    assert stats["bytes"] == 2 * 4 * c.n_layers * c.n_kv_heads * \
        c.head_dim * kv_tokens
    p0 = disagg_prompts()[0]
    assert pipe.generate(p0, NEW_TOKENS, req_id="one") == refs["port"]["r0"]
    assert pipe.prefill_engine.cache.pages_used == 0
    assert pipe.decode_engine.cache.pages_used == 0
    with pytest.raises(ValueError, match="mesh of 1"):
        port_disagg.DisaggPipeline(store, port_planner.load_plan(PREFILL),
                                   _mesh_one(DECODE), device="cpu")


# -- the world of 8 ------------------------------------------------------------


_WORLD: dict = {}


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    """Every rank's readings from the spawned world of 8, spawned once
    per test process."""
    if _WORLD:
        return _WORLD
    out = tmp_path_factory.mktemp("disagg_world")
    job = {"rdzv": str(out / "rdzv"), "out": str(out),
           "artifact": _artifact(out / "model.pt", models[3],
                                 _stamp(DECODE)),
           "new_tokens": NEW_TOKENS}
    with open(out / "job.json", "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(out / "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(8)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 8, "\n".join(
        log[-3000:] for log in logs)
    _WORLD.update({r: torch.load(out / f"rank{r}.pt", weights_only=False)
                   for r in range(8)})
    return _WORLD


def test_world_pipeline_matches_one_process_engines(models, world):
    """Prefill dp 4 → decode dp 2 x tp 2: ``generate_many`` and
    ``generate`` give every rank the one-process engines' tokens."""
    refs = _references(models)
    for rank, got in world.items():
        assert got["many"] == refs["port"] == refs["jax"], rank
        assert got["one"] == {f"g{i}": refs["port"][f"r{i}"]
                              for i in range(2)}, rank
        assert got["handoff"]["items"] == len(disagg_prompts()) + 2, rank
        side = PREFILL_RANKS if rank in PREFILL_RANKS else DECODE_RANKS
        assert f"processes=4 rank={rank - side[0]}" in got["describe"]
        # The slice's groups, never the world's: the whole mesh of 4, and
        # the dp group (all 4 ranks at prefill's dp 4; at decode's dp 2 x
        # tp 2, the 2 ranks of one tp coordinate).
        assert got["groups"] == {"mesh": (4, False), "dp": (
            (4, False) if side is PREFILL_RANKS else (2, False))}, rank
    # Each prefill export gathered the dense KV over the slice.
    for rank in PREFILL_RANKS:
        assert world[rank]["gathers"]["kv_export"] == \
            world[rank]["handoff"]["steps"]


def test_world_decode_mesh_exports_adopts_and_drains(models, world):
    """On the decode mesh of 4, export_in_flight → adopt_batch after a
    mid-stream stop, and a drain with a deadline, end with the
    uninterrupted tokens; every rank persists the same requests."""
    refs = _references(models)
    first = world[DECODE_RANKS[0]]["mesh_kv"]
    for rank in DECODE_RANKS:
        kv = world[rank]["mesh_kv"]
        for name in ("export", "deadline"):
            assert kv[name]["tokens"] == refs["port"], (rank, name)
            assert {k: kv[name][k] for k in ("adopted", "fresh",
                                             "persisted")} == \
                {k: first[name][k] for k in ("adopted", "fresh",
                                             "persisted")}, (rank, name)
        assert kv["export"]["adopted"], rank
        assert kv["deadline"]["gathers"]["deadline"] >= 1, rank


# -- C3: the crashed engine's 503 ----------------------------------------------


def _post(port: int, body: dict) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), json.loads(data)


def test_crashed_engine_503_carries_retry_after_as_jax(models):
    jm, jp, pm, pp = models
    body = {"prompt_ids": [3, 1, 4, 1, 5, 9], "max_new_tokens": 4}
    kw = dict(max_batch=4, page_size=8, num_pages=32, max_seq_len=64,
              prefill_chunk=8)
    out = {}
    for name, make, faults, server in (
            ("jax", lambda: jax_engine.Engine(
                jm, jp, jax_engine.EngineConfig(**kw)), jax_faults,
             JaxServer),
            ("port", lambda: port_engine.Engine(
                pm, pp, port_engine.EngineConfig(**kw), device="cpu"),
             port_faults, PortServer)):
        eng = make()
        eng.faults = faults.FaultInjector(
            faults.parse_fault_plan("engine_crash@1"))
        srv = server(eng, port=0, retry_after_s=2.0)
        srv.start()
        try:
            _post(srv.port, body)
            deadline = time.monotonic() + 60
            while srv.engine_error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            st, headers, reply = _post(srv.port, body)
        finally:
            srv.stop()
        out[name] = (st, headers.get("Retry-After"),
                     reply["error"].split(":")[0])
    assert out["port"] == out["jax"] == (503, "2", "engine crashed")

"""Serving over ``fsdp`` in the port (``serving/engine.py``: weights
stored split over fsdp and gathered for compute), the plan-directed
placement (``serving/disagg.py::plan_shardings``/``place_params``) and
the planner's serving gate (``compile_verify_serving``).

One spawned gloo world of 4 (``test_torch_serving_fsdp_world.py``), made
once a test run whatever the xdist workers (``_once``), on the serving
model of the committed plans with its biases drawn nonzero:

- the engine at fsdp 2 x dp 2 gives the one-process engine's greedy f32
  tokens in every form (batched and sequential prefill, ``spec_k`` 4,
  ``resident_k`` 4 eagerly), and the JAX one-process engine's batched
  ones; int8 weight-only leaves and fsdp 2 x tp 2 (leaves split on two
  dims) the same;
- its f32 logits at every request's first decode step lie within 1e-4
  of the one-process engine's, and a planted fault (one rank
  concatenating layer 0's gathered shards in the wrong order) falls
  outside;
- the all-gather bytes of one decode step equal the ``all-gather`` term
  the planner's ``_score_serving`` prices for ``pp1.dp2.fsdp2.sp1.tp1``
  (the whole weights at the compute dtype), one gather per layer and
  per top-level leaf;
- ``place_params``' blocks equal the engine's ``_rank_params`` and
  concatenate back to the whole weights, and ``plan_shardings``' leaf
  placements equal the engine's layout;
- ``compile_verify_serving`` passes on the committed
  ``serving_4dev_cpu_decode`` and ``serving_4dev_cpu_prefill`` plans.
"""

import dataclasses
import fcntl
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
)
from distributed_training_tpu_torch.parallel import planner as port_planner
from distributed_training_tpu_torch.serving import disagg as port_disagg
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.parallel.planner import (  # noqa: E402
    SERVING_MODEL_KWARGS,
)
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_serving_fsdp_world.py")
sys.path.insert(0, os.path.dirname(WORKER))
from test_torch_serving_fsdp_world import (  # noqa: E402
    CANDIDATE,
    ENGINE,
    MESH,
    MODES,
    NEW_TOKENS,
    prompts,
    target,
)

LOGITS_TOL = 1e-4
SPAWN_TIMEOUT_S = 300


def _with_biases(tree: dict, rng) -> dict:
    """``tree`` (numpy) with every bias drawn from N(0, 0.1²)."""
    return {k: _with_biases(v, rng) if isinstance(v, dict) else
            (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
             if k in ("bi", "bo", "bias") else v) for k, v in tree.items()}


def _once(root, name: str, make):
    """``make(dir)``'s result, made once for every test process of the
    run that shares ``root`` (an exclusive lock around a marker file)."""
    d = root / name
    d.mkdir(exist_ok=True)
    done = d / "done.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            with open(done, "wb") as f:
                pickle.dump(make(str(d)), f)
    with open(done, "rb") as f:
        return pickle.load(f)


def _make(out: str) -> dict:
    """The world's readings, the one-process references and JAX's."""
    jm = Transformer(TransformerConfig(**SERVING_MODEL_KWARGS))
    npp = _with_biases(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1))), np.random.default_rng(3))
    pm = PortTransformer(PortConfig(**SERVING_MODEL_KWARGS), device="cpu")
    pp = from_jax_params(npp, pm.cfg, device="cpu")
    params = os.path.join(out, "params.pt")
    torch.save(flatten(pp), params)
    job = {"rdzv": os.path.join(out, "rdzv"), "out": out,
           "model": SERVING_MODEL_KWARGS, "params": params}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    # The references while the world runs.
    G = MESH["dp"]
    one = dict(ENGINE, num_pages=G * (ENGINE["num_pages"] - 1) + 1)
    refs = {}
    for mode, over in MODES.items():
        refs[mode] = _run(port_engine.Engine(
            pm, pp, port_engine.EngineConfig(**one, **over), device="cpu"))
    refs["int8"] = _run(port_engine.Engine(
        pm, port_disagg.quantize_params_int8(pp),
        port_engine.EngineConfig(**one), device="cpu"))
    jeng = jax_engine.Engine(jm, jax.tree.map(jax.numpy.asarray, npp),
                             jax_engine.EngineConfig(**one))
    for i, p in enumerate(prompts()):
        jeng.submit(jax_engine.Request(id=f"r{i}", prompt=p,
                                       max_new_tokens=NEW_TOKENS))
    jeng.run_until_drained()
    refs["jax_batched"] = {r["id"]: r["tokens"] for r in jeng.completed}
    from test_torch_serving_fsdp_world import first_decode
    refs["first_decode"] = first_decode(port_engine.Engine(
        pm, pp, port_engine.EngineConfig(**one), device="cpu"))["logits"]
    refs["params"] = flatten(pp)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(
        log[-3000:] for log in logs)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return {"ranks": ranks, "refs": refs}


def _run(engine) -> dict:
    for i, p in enumerate(prompts()):
        engine.submit(port_engine.Request(id=f"r{i}", prompt=p,
                                          max_new_tokens=NEW_TOKENS))
    engine.run_until_drained()
    return {r["id"]: r["tokens"] for r in engine.completed}


_WORLD: dict = {}


@pytest.fixture
def world(tmp_path_factory):
    if "out" not in _WORLD:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # the run's directory, above the workers'
        _WORLD["out"] = _once(root, "serving_fsdp_world", _make)
    return _WORLD["out"]


@pytest.mark.parametrize("mode", list(MODES))
def test_fsdp_engine_tokens_match_one_process(world, mode):
    want = world["refs"][mode]
    assert len(want) == len(prompts())
    for r in world["ranks"]:
        got = r["modes"][mode]
        assert got["tokens"] == want, (r["rank"], mode)
        assert got["pages_left"] == 0
        # One lock-step gather a step over the whole mesh, the dp fetches
        # over the dp group; nothing else of the engine's own.
        assert set(got["gathers"]) == {"lockstep", "dp_fetch"}
    if mode == "batched":
        assert want == world["refs"]["jax_batched"]


@pytest.mark.parametrize("case", ["int8", "fsdp2_tp2"])
def test_fsdp_int8_and_two_dim_splits_match_one_process(world, case):
    want = world["refs"]["int8" if case == "int8" else "batched"]
    for r in world["ranks"]:
        assert r[case] == want, (r["rank"], case)


def test_fsdp_first_decode_logits_and_planted_fault(world):
    want = world["refs"]["first_decode"]
    sound, fault = 0.0, 0.0
    seen = set()
    for r in world["ranks"]:
        for k, row in r["first_decode"]["logits"].items():
            sound = max(sound, float((row - want[k]).abs().max()))
            seen.add(k)
        for k, row in r["first_decode_fault"].items():
            fault = max(fault, float((row - want[k]).abs().max()))
    assert seen == set(want) and len(want) == len(prompts())
    assert sound <= LOGITS_TOL
    assert fault > LOGITS_TOL


def test_fsdp_gather_bytes_equal_the_cost_model(world):
    """One decode step gathers the whole weights once at the compute
    dtype: the ``all-gather`` bytes ``_score_serving`` prices."""
    rec = port_planner.score_candidate(target(), CANDIDATE)
    assert rec["feasible"]
    want = rec["comms_bytes_by_kind"]["all-gather"]
    L = SERVING_MODEL_KWARGS["n_layers"]
    for r in world["ranks"]:
        fd = r["first_decode"]
        assert fd["gathered_bytes"] == want, r["rank"]
        tops = {k for k in fd["gathers"] if k != "layer"}
        assert fd["gathers"]["layer"] == L
        assert tops == {"tok_embed", "final_norm/scale", "final_norm/bias"}
        assert all(fd["gathers"][k] == 1 for k in tops)


def test_place_params_is_the_engines_layout(world):
    whole = world["refs"]["params"]
    ranks = world["ranks"]
    plan = port_planner.build_plan(target(), CANDIDATE)
    for r in ranks:
        w = r["weights"]
        assert set(w["placed"]) == set(whole)
        for k in whole:
            assert torch.equal(w["placed"][k], w["rank_params"][k]), k
        assert w["plan_shardings"] == w["layout"]
    # Ranks are dp-major over (dp, fsdp): 0 and 1 are one dp group's
    # fsdp shards.
    for k, t in whole.items():
        pl = ranks[0]["weights"]["plan_shardings"][k]
        parts = [ranks[i]["weights"]["placed"][k] for i in (0, 1)]
        if pl is None:
            assert all(torch.equal(p, t) for p in parts), k
            continue
        (dim, axes), = pl.splits
        assert axes == ("fsdp",) and plan.sharding_map[k][dim] == "fsdp"
        assert torch.equal(torch.cat(parts, dim), t), k
        assert torch.equal(ranks[2]["weights"]["placed"][k], parts[0])


@pytest.mark.parametrize("name", ["serving_4dev_cpu_decode",
                                  "serving_4dev_cpu_prefill"])
def test_serving_gate_passes_on_the_committed_plan(world, name):
    plan = port_planner.load_plan(name)
    for r in world["ranks"]:
        ev = r["gates"][name]
        assert ev["gate"]["agree"], (r["rank"], ev["gate"])
        assert ev["gate"]["max_abs_logit_diff"] <= LOGITS_TOL
        assert ev["spmd_reshard_warnings"] == 0
        assert ev["program"] == ("decode" if name.endswith("decode")
                                 else "prefill_batch")
        # Every row of this process's dp group.
        assert ev["gate"]["rows"] == (plan.batch_per_shard
                                      // plan.mesh["dp"])
        # Under tp 2 the launch's tensor-parallel collectives ran.
        if plan.mesh["tp"] > 1:
            assert ev["gate"]["counters"]["tp_all_reduces"][
                "reduce_from_tp"] > 0


def test_one_process_plan_placement_and_errors():
    """Without a mesh ``place_params`` hands the weights back whole; a
    plan of another model raises."""
    plan = port_planner.load_plan("serving_4dev_cpu_decode")
    pm = PortTransformer(PortConfig(**SERVING_MODEL_KWARGS), device="cpu")
    params = pm.init(0)
    one = dataclasses.replace(plan, mesh={a: 1 for a in plan.mesh})
    placed = port_disagg.place_params(params, None, one)
    assert all(placed_t is t for placed_t, t in zip(
        flatten(placed).values(), flatten(params).values()))
    with pytest.raises(ValueError, match="names no sharding"):
        port_disagg.plan_shardings(one, None, {"not_a_param": params[
            "tok_embed"]})

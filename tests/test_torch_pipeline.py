"""The port's pipeline parallelism (``parallel/pipeline.py``, the model's
and the trainer's pp path) held against the JAX package's.

The inputs are made from a seed with numpy. The JAX side runs on the
conftest's fake CPU devices through ``fake_cpu_runtime(4, pp=...)``,
``pipeline_apply``, ``Transformer`` and ``Trainer``; the port side runs
in one spawned gloo world of 4 processes for the whole module
(``spawned``; worker ``tests/test_torch_pp_world.py``) on the meshes pp
4, dp 2 x pp 2, fsdp 2 x pp 2, pp 2 x sp 2 (ring and Ulysses) and pp 2 x
tp 2.

- Schedules: ``schedule_stats``, the interleave tables,
  ``interleave_layer_order`` and the microbatch count equal JAX's; every
  send of a tick pairs with a receive of the same tick.
- ``pipeline_apply``: outputs, aux and gradients (each stage's partial
  gradients summed over pp) against JAX's at ``rtol=1e-5, atol=1e-6``
  in float32, on JAX's own geometries (GPipe at L 8, B 8, S 4, D 16, pp
  4, M 4; interleaved at M 2, 4 and 6); JAX's validation errors in its
  words. A stage saves only its microbatches' inputs.
- Training: loss trajectories, gradient norms and final params against
  JAX's trainer on the same mesh and the port's one-process run on the
  same global batches, in float32: GPipe and interleaved, grad accum
  over the pipeline, fsdp, ring and Ulysses inside the stages (learned
  positions and RoPE, a window that spills the local slice), tp inside
  the stages, and rows whose masked targets give the microbatches
  unequal counts.
- Dropout: pp 4 with one microbatch draws the pp 1 masks; with two it
  drops.
- Checkpoints: a save at pp 2 resumes at pp 1 to the same state and
  trajectory, and a save at pp 1 resumes at pp 2.
- The CLI: the tiny model trains over ``mesh.pp=2`` through
  ``launch/local.py`` (and under a plan with pp 2) as at world 1.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.launch import local as launch
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.parallel import pipeline as port_pp
from distributed_training_tpu_torch.parallel.ring_attention import SPGroup
from distributed_training_tpu_torch.runtime import Runtime
from distributed_training_tpu_torch.train import cli
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten
from distributed_training_tpu_torch.train.trainer import Trainer

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402
from distributed_training_tpu.parallel import pipeline as jax_pp  # noqa: E402
from distributed_training_tpu.parallel import planner as jax_planner  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

from test_torch_sp_world import DATASETS  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_pp_world.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
F32_TOL = dict(rtol=1e-5, atol=1e-6)

# pipeline_apply: JAX's geometries (tests/test_pipeline.py). name →
# (schedule, microbatches, batch).
L_PIPE, S_PIPE, D_PIPE = 8, 4, 16
PIPE_CASES = {"gpipe_m4": ("gpipe", 4, 8),
              "interleaved_m2": ("interleaved", 2, 12),
              "interleaved_m4": ("interleaved", 4, 12),
              "interleaved_m6": ("interleaved", 6, 12)}
AUX_WEIGHT = 0.5

# Training: a tiny decoder of 4 layers, float32, AdamW with warm-up,
# cosine decay, clipping and weight decay, 3 steps.
MODEL = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4,
             max_seq_len=32, dtype="float32")
TRAIN = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.1,
             warmup_steps=2, lr_schedule="cosine", grad_clip_norm=0.5,
             batch_size=2, total_epochs=1, log_every=1, dtype="float32",
             seed=7, min_shard_elems=1, save_every=0)
STEPS = 3
ARCH_KEYS = ("n_kv_heads", "pos_encoding", "tie_embeddings")
GPIPE2 = {"pp_microbatches": 2, "pp_schedule": "gpipe"}
INTERLEAVED2 = {"pp_microbatches": 2, "pp_schedule": "interleaved",
                "pp_virtual_stages": 2}
# name → (mesh, train overrides, model overrides, dataset kind, rows a
# data shard). Microbatch counts: dp 2 x pp 2 at 2 rows a shard takes M
# 2 (JAX's autodivisor over the global batch of 4); pp 4 at 4 rows M 4.
TRAIN_CASES = {
    "gpipe_dp2_pp2": ({"dp": 2, "pp": 2}, {"parallel_strategy": "ddp"},
                      GPIPE2, "synthetic_lm", 2),
    "interleaved_dp2_pp2": ({"dp": 2, "pp": 2},
                            {"parallel_strategy": "ddp"}, INTERLEAVED2,
                            "masked_lm", 2),
    "accum_dp2_pp2": ({"dp": 2, "pp": 2},
                      {"parallel_strategy": "ddp", "grad_accum_steps": 2},
                      GPIPE2, "synthetic_lm", 4),
    "gpipe_pp4_masked": ({"dp": 1, "pp": 4}, {"parallel_strategy": "ddp"},
                         {"pp_microbatches": 4}, "masked_lm", 4),
    "fsdp2_pp2": ({"dp": 1, "fsdp": 2, "pp": 2},
                  {"parallel_strategy": "fsdp"}, INTERLEAVED2,
                  "synthetic_lm", 2),
    "ring_pp2_sp2": ({"dp": 1, "pp": 2, "sp": 2},
                     {"parallel_strategy": "ddp"},
                     {**INTERLEAVED2, "attention_impl": "ring"},
                     "synthetic_lm", 2),
    "ulysses_pp2_sp2_rope": ({"dp": 1, "pp": 2, "sp": 2},
                             {"parallel_strategy": "ddp"},
                             {**GPIPE2, "attention_impl": "ulysses",
                              "pos_encoding": "rope"}, "masked_lm", 2),
    "ring_window_pp2_sp2": ({"dp": 1, "pp": 2, "sp": 2},
                            {"parallel_strategy": "ddp"},
                            {**GPIPE2, "attention_impl": "ring",
                             "pos_encoding": "rope",
                             "attention_window": 20}, "synthetic_lm", 2),
    "tp2_pp2_gqa": ({"dp": 1, "pp": 2, "tp": 2},
                    {"parallel_strategy": "tp"},
                    {**GPIPE2, "n_kv_heads": 2, "tie_embeddings": False},
                    "masked_lm", 2),
}
SAVE_STEPS = 2      # one epoch of 2 steps, saved; then a second epoch
SAVE_MESH = {"dp": 2, "pp": 2}


def _shards(mesh: dict) -> int:
    return mesh.get("dp", 1) * mesh.get("fsdp", 1)


def _dataset(kind: str, shards: int, rows: int, steps: int = STEPS) -> dict:
    return dict(kind=kind, size=steps * rows * shards,
                seq_len=MODEL["max_seq_len"], vocab_size=MODEL["vocab_size"],
                seed=TRAIN["seed"])


def _arch(model: dict) -> tuple:
    return tuple(sorted((k, v) for k, v in model.items() if k in ARCH_KEYS))


@functools.lru_cache(maxsize=None)
def jax_init(arch: tuple = ()) -> dict:
    """The JAX trainer's init (seed 7) of MODEL with ``arch``'s
    overrides, the start of every training run."""
    cfg = jax_config.Config()
    for k, v in TRAIN.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(1)
    ds = DATASETS["synthetic_lm"](**{k: v for k, v in _dataset(
        "synthetic_lm", 1, 2).items() if k != "kind"})
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **{**MODEL, **dict(arch)})), JaxLoader(ds, rt, batch_size=2,
                                                seed=TRAIN["seed"]))
    return {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray, jt.state["params"])).items()}


def jax_train(mesh: dict, train: dict, model: dict, kind: str,
              rows: int) -> tuple:
    """JAX's trainer on the fake CPU devices of ``mesh`` from
    ``jax_init``: losses, gradient norms (the first dropped, as the
    port's rows drop it) and final params."""
    cfg = jax_config.Config()
    for k, v in {**TRAIN, **train, "batch_size": rows}.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(WORLD, **mesh)
    ds = DATASETS[kind](**{k: v for k, v in _dataset(
        kind, _shards(mesh), rows).items() if k != "kind"})
    loader = JaxLoader(ds, rt, batch_size=rows, seed=TRAIN["seed"],
                       shuffle=False)
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **{**MODEL, **model})), loader)
    jt.state["params"] = jax.device_put(
        unflatten(jax_init(_arch(model))), jt.state_shardings["params"])
    norms, step = [], jt.train_step

    def train_step(batch):
        metrics = step(batch)
        norms.append(float(metrics["grad_norm"]))
        return metrics
    jt.train_step = train_step
    jt.train()
    losses = [r["loss"] for r in jt.metrics.history if "loss" in r]
    return (losses, norms[1:],
            flatten(jax.tree.map(np.asarray, jt.state["params"])))


def port_one_process(mesh: dict, train: dict, model: dict, kind: str,
                     rows: int, ckpt: str | None = None, epochs: int = 1,
                     steps: int = STEPS) -> Trainer:
    """The port's trainer in this process (no process group) over the
    same global batches as ``mesh``'s data shards, from ``jax_init``."""
    cfg = port_config.Config()
    shards = _shards(mesh)
    for k, v in {**TRAIN, **train, "parallel_strategy": "ddp",
                 "batch_size": rows * shards,
                 "total_epochs": epochs}.items():
        setattr(cfg.train, k, v)
    rt = Runtime(device=torch.device("cpu"))
    pm = port_tf.Transformer(port_tf.TransformerConfig(
        **{**MODEL, **model}), device="cpu")
    ds = DATASETS[kind](**{k: v for k, v in _dataset(
        kind, shards, rows, steps).items() if k != "kind"})
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=TRAIN["seed"], shuffle=False)
    return Trainer(cfg, rt, pm, loader,
                   Checkpointer(ckpt, runtime=rt) if ckpt else None,
                   params=from_jax_params(unflatten(jax_init(_arch(model))),
                                          pm.cfg, "cpu"))


def _rows(history: list) -> tuple:
    return ([r["loss"] for r in history],
            [r["grad_norm"] for r in history if "grad_norm" in r])


def _trajectory(trainer: Trainer) -> tuple:
    return (*_rows(trainer.metrics.history),
            {k: v.detach().numpy() for k, v in
             flatten(trainer.state["params"]).items()})


def check_trajectory(got: tuple, want: tuple, what: str) -> None:
    (gl, gn, gp), (wl, wn, wp) = got, want
    assert len(gl) == len(wl) and len(gn) == len(wn), what
    np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(gn, wn, rtol=1e-5, err_msg=what)
    for k, v in gp.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(wp[k]), rtol=0,
                                   atol=1e-4, err_msg=f"{what}: {k}")


# -- the module's world ------------------------------------------------------


def pipe_inputs(batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"w": (rng.standard_normal((L_PIPE, D_PIPE, D_PIPE)) * 0.1
                  ).astype(f32),
            "b": (rng.standard_normal((L_PIPE, D_PIPE)) * 0.1).astype(f32),
            "x": rng.standard_normal((batch, S_PIPE, D_PIPE)).astype(f32),
            "g": rng.standard_normal((batch, S_PIPE, D_PIPE)).astype(f32)}


def _pipe_cases(out: str) -> list:
    cases = []
    for i, (name, (schedule, M, batch)) in enumerate(PIPE_CASES.items()):
        path = os.path.join(out, f"{name}.npz")
        np.savez(path, **pipe_inputs(batch, i))
        cases.append({"kind": "pipe", "name": name, "mesh": {"pp": 4},
                      "inputs": path, "schedule": schedule,
                      "microbatches": M, "virtual_stages": 2,
                      "c": AUX_WEIGHT})
    return cases


def dropout_tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, MODEL["vocab_size"], (4, 17)).astype(np.int64)


DROPOUT_RNG = 9
# (rate, microbatches) of the dropout case at pp 4.
DROPOUT_RUNS = [(0.3, 1), (0.4, 2), (0.0, 2)]


def _dropout_case(out: str) -> dict:
    path = os.path.join(out, "dropout_tokens.npy")
    np.save(path, dropout_tokens())
    return {"kind": "dropout", "name": "dropout_pp4", "mesh": {"pp": 4},
            "tokens": path, "rng": DROPOUT_RNG, "runs": DROPOUT_RUNS,
            "init": os.path.join(out, "init.pt")}


def _train_cases() -> list:
    return [{"kind": "train", "name": name, "mesh": mesh,
             "train": {**train, "batch_size": rows}, "model": model,
             "dataset": _dataset(kind, _shards(mesh), rows)}
            for name, (mesh, train, model, kind, rows) in TRAIN_CASES.items()]


def _ckpt_cases(out: str) -> list:
    """A save at dp 2 x pp 2 after one epoch, its resume there for a
    second epoch, and the resume at dp 2 x pp 2 of a save this process
    made at pp 1 (``_pp1_save``)."""
    base = {"kind": "train", "mesh": SAVE_MESH, "model": GPIPE2,
            "dataset": _dataset("synthetic_lm", 2, 2, SAVE_STEPS)}
    train = {"parallel_strategy": "ddp", "save_every": 1}
    return [
        {**base, "name": "save_pp2", "ckpt": os.path.join(out, "ckpt_pp2"),
         "train": train},
        {**base, "name": "resume_pp2", "ckpt": os.path.join(out, "ckpt_pp2"),
         "train": {**train, "total_epochs": 2}},
        {**base, "name": "resume_from_pp1",
         "ckpt": os.path.join(out, "ckpt_pp1"),
         "train": {**train, "total_epochs": 2}}]


def _pp1_save(out: str) -> None:
    """One epoch at pp 1 in this process, saved, for ``resume_from_pp1``."""
    port_one_process(SAVE_MESH, {"save_every": 1}, GPIPE2, "synthetic_lm",
                     2, ckpt=os.path.join(out, "ckpt_pp1"),
                     steps=SAVE_STEPS).train()


def spawn_world(out: str, cases: list) -> None:
    """Run ``cases`` in a spawned gloo world of WORLD processes; each
    training case starts from ``jax_init`` of its architecture."""
    for case in cases:
        if case["kind"] == "train":
            case["init"] = os.path.join(out, f"init_{case['name']}.pt")
        else:
            case.setdefault("init", os.path.join(out, "init.pt"))
        if "init" in case and not os.path.exists(case["init"]):
            torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                        jax_init(_arch(case.get("model", {}))).items()},
                       case["init"])
    job = {"world": WORLD, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "model": MODEL, "dataset": {},
           "train": {**TRAIN, "device": "cpu"}, "cases": cases}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(
        log[-3000:] for log in logs)


_WORLD: dict = {}


def spawned(tmp_path_factory) -> str:
    """The module's world: every pipeline, dropout, training and
    checkpoint case, run once per test process; returns its output
    directory."""
    if "out" not in _WORLD:
        out = str(tmp_path_factory.mktemp("pp_world"))
        _pp1_save(out)
        spawn_world(out, _pipe_cases(out) + [_dropout_case(out)]
                    + _train_cases() + _ckpt_cases(out))
        _WORLD["out"] = out
    return _WORLD["out"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawned(tmp_path_factory)


# -- schedules ---------------------------------------------------------------


@pytest.mark.parametrize("pp", [2, 3, 4])
def test_schedules_equal_jax(pp):
    for M in range(1, 9):
        for v in (1, 2, 3):
            for schedule in port_pp.SCHEDULES:
                assert (port_pp.schedule_stats(pp, M, schedule, v)
                        == jax_pp.schedule_stats(pp, M, schedule, v))
            got = port_pp._interleave_tables(pp, M, v)
            want = jax_pp._interleave_tables(pp, M, v)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))
            L = 2 * v * pp
            np.testing.assert_array_equal(
                port_pp.interleave_layer_order(L, pp, v),
                jax_pp.interleave_layer_order(L, pp, v))


def _jax_microbatches(B: int, requested: int, shards: int) -> int:
    """transformer.py's inline rule, as the JAX model applies it."""
    return max(m for m in range(1, min(requested, B) + 1)
               if B % m == 0 and (B // m) % shards == 0)


def test_microbatch_count_equals_jax():
    assert port_pp.num_microbatches(6, 4) == 3      # autodivisor
    assert port_pp.num_microbatches(4, 4, 2) == 2   # dp 2 x pp 2, B 4
    for B in range(1, 13):
        for req in range(1, 9):
            for shards in (1, 2, 4):
                if B % shards:
                    continue
                assert (port_pp.num_microbatches(B, req, shards)
                        == _jax_microbatches(B, req, shards))


@pytest.mark.parametrize("schedule,pp,M", [
    ("gpipe", 2, 4), ("gpipe", 4, 3), ("interleaved", 2, 4),
    ("interleaved", 4, 6), ("interleaved", 3, 5)])
def test_every_send_pairs_with_a_receive_of_its_tick(schedule, pp, M):
    """Stage d's send after tick t is received by its target's action at
    tick t + 1, from d; each (microbatch, virtual stage) runs once; the
    last virtual stage banks every microbatch."""
    v = 2
    acts = {d: port_pp.stage_actions(pp, M, schedule, v, d)
            for d in range(pp)}
    n = port_pp.num_chunks(pp, schedule, v)
    ran = sorted((a.mb, a.vstage) for d in acts for a in acts[d])
    assert ran == sorted((m, s) for m in range(M) for s in range(n))
    by_tick = {d: {a.tick: a for a in acts[d]} for d in acts}
    for d, alist in acts.items():
        for a in alist:
            assert a.vstage % pp == d
            if a.send_to is not None:
                got = by_tick[a.send_to][a.tick + 1]
                assert (got.mb, got.vstage, got.recv_from) == (
                    a.mb, a.vstage + 1, d)
            else:
                assert a.vstage == n - 1


def test_validation_matches_jax():
    rt = jax_runtime.fake_cpu_runtime(4, pp=4)

    def body(p, lids, xb, mb):
        return xb, jnp.zeros((), jnp.float32)
    for L, B, M, schedule in ((6, 4, 2, "gpipe"), (4, 4, 3, "gpipe"),
                              (4, 4, 2, "interleaved"), (4, 4, 2, "1f1b")):
        with pytest.raises(ValueError) as want:
            jax_pp.pipeline_apply(body, jnp.zeros((L, 4, 4)),
                                  jnp.zeros((B, 2, 4)), rt.mesh,
                                  num_microbatches=M, schedule=schedule)
        with pytest.raises(ValueError) as got:
            port_pp.pipeline_apply(
                lambda *a: None, torch.zeros(L, 4, 4), torch.zeros(B, 2, 4),
                _FourStages(), M, schedule)
        assert str(got.value) == str(want.value)


class _FourStages(port_pp.PPGroup):
    """A group of 4 for the validation, which runs before any exchange."""

    def __init__(self):
        super().__init__()
        self.size = 4


def test_model_refuses_a_pipeline_as_jax():
    """Binding a pp group checks the layers as ``pipeline_apply`` does,
    and Ulysses inside a stage needs the heads divisible by sp, in the
    words of JAX's ``_attention`` under pp."""
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **{**MODEL, "n_layers": 6}), device="cpu")
    with pytest.raises(ValueError, match="6 layers not divisible by 4 "
                                         "stages"):
        model.bind_pipeline(_FourStages())
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **{**MODEL, "pp_schedule": "interleaved"}), device="cpu")
    with pytest.raises(ValueError, match=r"virtual_stages\*pp=8"):
        model.bind_pipeline(_FourStages())
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **{**MODEL, "attention_impl": "ulysses", "n_kv_heads": 2}),
        device="cpu")
    sp = SPGroup()
    sp.size = 4
    model._sp = sp
    with pytest.raises(ValueError, match=(
            r"attention_impl='ulysses' under pp with sp=4 needs n_heads "
            r"\(4\) and n_kv_heads \(2\) divisible by sp")):
        model.bind_pipeline(_FourStages())


# -- pipeline_apply ----------------------------------------------------------


def jax_pipeline(name: str) -> dict:
    schedule, M, batch = PIPE_CASES[name]
    inputs = pipe_inputs(batch, list(PIPE_CASES).index(name))
    rt = jax_runtime.fake_cpu_runtime(4, pp=4)

    def stage_body(stage_params, layer_ids, xb, mb_idx):
        def body(carry, inp):
            layer, _lid = inp
            x, aux = carry
            x = jnp.tanh(x @ layer["w"] + layer["b"])
            return (x, aux + jnp.sum(x ** 2)), None
        (xb, aux), _ = jax.lax.scan(
            body, (xb, jnp.zeros((), jnp.float32)),
            (stage_params, layer_ids))
        return xb, aux

    def loss(w, b, x):
        out, aux = jax_pp.pipeline_apply(
            stage_body, {"w": w, "b": b}, x, rt.mesh, num_microbatches=M,
            schedule=schedule, virtual_stages=2)
        return jnp.sum(out * inputs["g"]) + AUX_WEIGHT * aux, (out, aux)

    (_, (out, aux)), (dw, db, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        inputs["w"], inputs["b"], inputs["x"])
    return {n: np.asarray(t) for n, t in (
        ("out", out), ("aux", aux), ("dw", dw), ("db", db), ("dx", dx))}


@pytest.mark.parametrize("name", sorted(PIPE_CASES))
def test_pipeline_apply_matches_jax(name, world):
    ranks = [torch.load(os.path.join(world, f"{name}.rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    want = jax_pipeline(name)
    for r in ranks:     # the output and the aux are every stage's
        np.testing.assert_allclose(r["out"].numpy(), want["out"], **F32_TOL)
        np.testing.assert_allclose(float(r["aux"]), float(want["aux"]),
                                   rtol=1e-5)
    for n in ("dw", "db", "dx"):
        got = sum(r[n] for r in ranks).numpy()
        scale = max(1.0, np.abs(want[n]).max())
        np.testing.assert_allclose(got, want[n], rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * scale,
                                   err_msg=f"{name}: {n}")
    # Stage 0 alone holds the input's gradient.
    assert all(not r["dx"].any() for r in ranks[1:])


@pytest.mark.parametrize("name", sorted(PIPE_CASES))
def test_a_stage_saves_only_its_microbatch_inputs(name, world):
    """The recompute's residuals: each (microbatch, virtual stage)'s
    input of the stage's own actions, shaped (B/M, S, D), and nothing
    autograd saved during the forward."""
    schedule, M, batch = PIPE_CASES[name]
    for r in range(WORLD):
        got = torch.load(os.path.join(world, f"{name}.rank{r}.pt"),
                         weights_only=False)
        want = {f"{a.mb},{a.vstage}" for a in port_pp.stage_actions(
            WORLD, M, schedule, 2, r)}
        assert set(got["saved"]) == want, (name, r)
        assert all(s == [batch // M, S_PIPE, D_PIPE]
                   for s in got["saved"].values())
        assert got["autograd_saved"] == 0


# -- training ----------------------------------------------------------------


def _world_run(out: str, name: str) -> tuple:
    res = torch.load(os.path.join(out, f"{name}.pt"), weights_only=False)
    return (*_rows(res["rows"]), {k: v.numpy()
                                  for k, v in res["params"].items()})


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_pp_training_matches_jax_and_one_process(name, world):
    mesh, train, model, kind, rows = TRAIN_CASES[name]
    got = _world_run(world, name)
    assert len(got[0]) == STEPS
    check_trajectory(got, jax_train(mesh, train, model, kind, rows),
                     f"{name} vs JAX")
    one = port_one_process(mesh, train, model, kind, rows)
    one.train()
    check_trajectory(got, _trajectory(one), f"{name} vs one process")


def test_dropout_at_one_microbatch_draws_the_pp1_masks(world):
    """pp 4 with one microbatch and one data shard draws the masks pp 1
    draws (the same loss, bit for bit); with two microbatches it drops
    (the loss differs from the dropout-free one)."""
    losses = torch.load(os.path.join(world, "dropout_pp4.pt"))
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **MODEL, dropout=0.3), device="cpu")
    params = unflatten({k: torch.from_numpy(np.array(v))
                        for k, v in jax_init().items()})
    with torch.no_grad():
        pp1, _ = model.loss(params, {"tokens": torch.from_numpy(
            dropout_tokens())}, rng=DROPOUT_RNG, train=True)
    assert losses[0] == float(pp1)
    assert all(np.isfinite(losses))
    assert losses[1] != pytest.approx(losses[2], rel=1e-9)


def test_save_at_pp2_resumes_at_pp1(world, tmp_path):
    """A save at dp 2 x pp 2 (its first stage's files) restores at pp 1
    to the saved params, and the resumed epoch gives the pp 2 resume's
    trajectory."""
    saved = _world_run(world, "save_pp2")
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(world, "ckpt_pp2"), ckpt)
    step = ckpt / str(SAVE_STEPS)
    with open(step / "layout.json") as f:
        assert json.load(f)["replica_axes"] == ["pp"]
    # Ranks 0 and 1 are stage 0 of the two data shards (pp is the
    # mesh's first axis); stage 1 writes no file.
    assert sorted(p.name for p in step.glob("state.rank*.pt")) == [
        "state.rank0.pt", "state.rank1.pt"]
    shutil.rmtree(ckpt / str(2 * SAVE_STEPS))
    t = port_one_process(SAVE_MESH, {"save_every": 0}, GPIPE2,
                         "synthetic_lm", 2, ckpt=str(ckpt), epochs=2,
                         steps=SAVE_STEPS)
    assert t.state["step"] == SAVE_STEPS
    for k, v in flatten(t.state["params"]).items():
        assert np.array_equal(v.detach().numpy(), saved[2][k]), k
    t.train()
    check_trajectory(_trajectory(t), _world_run(world, "resume_pp2"),
                     "pp 1 resume vs pp 2 resume")


def test_save_at_pp1_resumes_at_pp2(world):
    got = _world_run(world, "resume_from_pp1")
    want = _world_run(world, "resume_pp2")
    assert len(got[0]) == SAVE_STEPS
    check_trajectory(got, want, "pp 2 resume of a pp 1 save")


# -- the CLI -----------------------------------------------------------------

CLI_MODEL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4,
                 max_seq_len=16, pp_microbatches=2)
CLI_STEPS = 3


def cli_overrides(model: dict) -> list:
    """The CLI's tiny run of ``model`` on gpt2_125m's train config."""
    return (["train.device=cpu", "model=gpt2_125m", "train=gpt2",
             "+model.remat=false", "train.dataset_size=64",
             f"train.dataset_kwargs.seq_len={model['max_seq_len']}",
             f"train.dataset_kwargs.vocab_size={model['vocab_size']}",
             "train.dtype=float32", "+model.dtype=float32",
             "train.total_epochs=1", "train.batch_size=4",
             f"train.max_steps_per_epoch={CLI_STEPS}",
             "train.log_every=1", "train.save_every=0",
             "train.min_shard_elems=1", "run.log_level=WARNING"]
            + [f"+model.{k}={v}" for k, v in model.items()])


def _cli_losses(run_dir) -> list:
    with open(os.path.join(run_dir, "default", "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def _launch(tmp_path, name: str, args: list) -> list:
    out = tmp_path / name
    report = launch.run_group(
        ["-m", "distributed_training_tpu_torch.train", *args,
         f"run.output_dir={out}", f"train.snapshot_path={out}/ckpt"],
        2, log_dir=str(tmp_path / f"{name}_logs"),
        env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}, timeout=240)
    logs = "".join(p.read_text()
                   for p in (tmp_path / f"{name}_logs").iterdir())
    assert report.returncode == 0, logs[-3000:]
    return _cli_losses(out)


def test_cli_trains_over_pp_as_at_world_1(tmp_path):
    """``mesh.pp=2`` through the launcher (two gloo processes on the
    CPU) under both schedules, and under a plan whose mesh has pp 2,
    give world 1's losses on the same batches."""
    base = cli_overrides(CLI_MODEL)
    one = tmp_path / "one"
    assert cli.main([*base, f"run.output_dir={one}",
                     f"train.snapshot_path={one}/ckpt"]) == 0
    want = _cli_losses(one)
    assert len(want) == CLI_STEPS
    for schedule in port_pp.SCHEDULES:
        got = _launch(tmp_path, schedule, [
            *base, "mesh.dp=1", "mesh.pp=2",
            f"+model.pp_schedule={schedule}"])
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=schedule)
    target = jax_planner.PlanTarget(
        name="pp2_tiny", devices=2, model_kwargs=dict(
            CLI_MODEL, dtype="float32", pp_schedule="interleaved"),
        seq_len=16, optimizer="adamw", batch_candidates=(4,),
        remat_candidates=("none",))
    plan = jax_planner.save_plan(
        jax_planner.build_plan(target, jax_planner.Candidate(
            2, 1, 1, 1, 1, "none", 4)), str(tmp_path / "pp2_tiny.json"))
    planned = [a for a in base if not a.startswith("+model.pp_")]
    got = _launch(tmp_path, "planned",
                  [*planned, f"train.sharding_plan={plan}"])
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg="planned")

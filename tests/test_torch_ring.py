"""The port's ring attention (``parallel/ring_attention.py``) and
sequence-parallel training held against the JAX package's.

The inputs are made from a seed with numpy. The JAX side runs on the
conftest's fake CPU devices through ``fake_cpu_runtime(4, ...)`` and
``make_ring_attention``; the port side runs in one spawned gloo world of
4 processes for the whole module (``spawned``; worker
``tests/test_torch_sp_world.py``) on the meshes sp 4, dp 2 x sp 2,
fsdp 2 x sp 2 and tp 2 x sp 2.

- Forward and gradients against JAX at ``rtol=1e-5, atol=1e-6`` in
  float32: causal and full, GQA, windows inside one block, of exactly
  one block, spilling one block and over several blocks (JAX's
  ``test_ring_windowed_matches_full`` geometries), the blocks forced
  through the flash kernels' plain versions; bfloat16 inputs at the
  bfloat16 limits; sp 1 degenerate. The reverse ring saves only q, k, v,
  out and lse of the local slice.
- Training: loss trajectories, gradient norms and final params of the
  port's trainer under ring attention against JAX's trainer on the same
  mesh and against the port's one-process run over the same global
  batches (JAX's ``test_sp_training_end_to_end_matches_dp``'s check),
  including rows with masked targets that give the data shards and the
  sequence slices unequal counts.
- Checkpoints: a save at sp 2 resumes at sp 1 to the same state and
  trajectory, and a save at sp 1 resumes at sp 2.
- The committed ring plans' models equal JAX's at sp 1 (loss and
  gradients).
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
from distributed_training_tpu_torch.data.loader import sequence_slice
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.parallel import planner as port_planner
from distributed_training_tpu_torch.parallel import strategy as port_strategy
from distributed_training_tpu_torch.parallel.ring_attention import (
    SPGroup,
    ring_attention,
)
from distributed_training_tpu_torch.runtime import MESH_AXES, MeshSpec, Runtime
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten
from distributed_training_tpu_torch.train.trainer import Trainer

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402
from distributed_training_tpu.parallel import planner as jax_planner  # noqa: E402
from distributed_training_tpu.parallel import ring_attention as jax_ring  # noqa: E402
from distributed_training_tpu.parallel import strategy as jax_strategy  # noqa: E402
from distributed_training_tpu.parallel import ulysses as jax_ulysses  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

from test_torch_sp_world import DATASETS  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_sp_world.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = {"sp4": {"sp": 4}, "dp2_sp2": {"dp": 2, "sp": 2},
          "fsdp2_sp2": {"fsdp": 2, "sp": 2}, "tp2_sp2": {"sp": 2, "tp": 2}}
# Global attention inputs: B 4 (two data shards of 2), S 64, D 16.
B, S, D = 4, 64, 16
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 inputs: both sides round the output and the gradients to bf16;
# they differ by a few bf16 ulps of values of order 1.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# name → (mesh, causal, H, Hkv, window, dtype, flash): the ring's
# attention cases. Windows at sp 4 (16 positions a slice): inside one
# block (5), exactly one block (16), spilling one block (20), over
# several blocks (40); at sp 2 (32 a slice) one spilling window (40).
RING_CASES = {
    "causal_sp4": ("sp4", True, 4, 4, 0, "float32", False),
    "full_sp4": ("sp4", False, 4, 4, 0, "float32", False),
    "gqa_sp4": ("sp4", True, 4, 2, 0, "float32", False),
    "full_gqa_sp4": ("sp4", False, 4, 2, 0, "float32", False),
    "window5_sp4": ("sp4", True, 4, 4, 5, "float32", False),
    "window16_sp4": ("sp4", True, 4, 4, 16, "float32", False),
    "window20_sp4": ("sp4", True, 4, 2, 20, "float32", False),
    "window40_sp4": ("sp4", True, 4, 4, 40, "float32", False),
    "causal_dp2_sp2": ("dp2_sp2", True, 4, 4, 0, "float32", False),
    "window40_dp2_sp2": ("dp2_sp2", True, 4, 2, 40, "float32", False),
    "causal_fsdp2_sp2": ("fsdp2_sp2", True, 4, 4, 0, "float32", False),
    "causal_tp2_sp2": ("tp2_sp2", True, 4, 2, 0, "float32", False),
    "full_tp2_sp2": ("tp2_sp2", False, 4, 4, 0, "float32", False),
    "bf16_sp4": ("sp4", True, 4, 4, 0, "bfloat16", False),
    "bf16_gqa_dp2_sp2": ("dp2_sp2", True, 4, 2, 0, "bfloat16", False),
}
# flash: the blocks forced through the flash kernels' wrappers, whose
# plain versions run on CPU tensors (flash_fwd_reference and the split
# backward's): local slices of 64
# positions, the kernels' tile. B 2, S 128 at sp 2.
FLASH_CASES = {
    "flash_causal_dp2_sp2": ("dp2_sp2", True, 4, 2, 0, "float32", True),
    "flash_full_sp4": ("sp4", False, 4, 4, 0, "float32", True),
}
FLASH_S = 256

# Training: a tiny decoder, float32, AdamW with warm-up, cosine decay,
# clipping and weight decay, 3 steps at 2 rows a data shard.
MODEL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             max_seq_len=32, dtype="float32")
TRAIN = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.1,
             warmup_steps=2, lr_schedule="cosine", grad_clip_norm=0.5,
             batch_size=2, total_epochs=1, log_every=1, dtype="float32",
             seed=7, min_shard_elems=1, save_every=0)
STEPS = 3
# name → (mesh, train overrides, model overrides, dataset kind).
TRAIN_CASES = {
    "train_sp4": ({"dp": 1, "sp": 4}, {"parallel_strategy": "ddp"}, {},
                  "synthetic_lm"),
    "train_dp2_sp2_masked": ({"dp": 2, "sp": 2},
                             {"parallel_strategy": "ddp"}, {}, "masked_lm"),
    "train_fsdp2_sp2": ({"dp": 1, "fsdp": 2, "sp": 2},
                        {"parallel_strategy": "fsdp"}, {}, "synthetic_lm"),
    "train_tp2_sp2_gqa": ({"dp": 1, "sp": 2, "tp": 2},
                          {"parallel_strategy": "tp"},
                          {"n_kv_heads": 2, "pos_encoding": "rope",
                           "tie_embeddings": False}, "masked_lm"),
}


def _shards(mesh: dict) -> int:
    return mesh.get("dp", 1) * mesh.get("fsdp", 1)


def _dataset(kind: str, shards: int, steps: int = STEPS) -> dict:
    return dict(kind=kind, size=steps * TRAIN["batch_size"] * shards,
                seq_len=MODEL["max_seq_len"], vocab_size=MODEL["vocab_size"],
                seed=TRAIN["seed"])


def attn_inputs(H: int, Hkv: int, seed: int = 0, seq: int = S) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"q": rng.standard_normal((B, seq, H, D)).astype(f32),
            "k": rng.standard_normal((B, seq, Hkv, D)).astype(f32),
            "v": rng.standard_normal((B, seq, Hkv, D)).astype(f32),
            "do": rng.standard_normal((B, seq, H, D)).astype(f32)}


def jax_attention(impl: str, mesh: dict, inputs: dict, causal: bool,
                  window: int, dtype: str) -> dict:
    """JAX's sequence-parallel attention (and its VJP) on the fake CPU
    devices of ``mesh``: the whole output and input gradients."""
    rt = jax_runtime.fake_cpu_runtime(WORLD, **mesh)
    head = "tp" if mesh.get("tp", 1) > 1 else None
    axes = jax_ring.usable_batch_axes(rt.mesh, inputs["q"].shape[0])
    make = (jax_ring.make_ring_attention if impl == "ring"
            else jax_ulysses.make_ulysses_attention)
    fn = make(rt.mesh, causal=causal, batch_axes=axes, head_axis=head,
              window=window)
    dt = jnp.dtype(dtype)
    q, k, v, do = (jnp.asarray(inputs[n]).astype(dt)
                   for n in ("q", "k", "v", "do"))
    out, vjp = jax.vjp(jax.jit(fn), q, k, v)
    dq, dk, dv = vjp(do)
    return {n: np.asarray(x.astype(jnp.float32))
            for n, x in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv))}


def _coords(mesh: dict) -> list:
    sizes = [mesh.get(a, 1) for a in MESH_AXES]
    return [dict(zip(MESH_AXES, np.unravel_index(r, sizes)))
            for r in range(WORLD)]


def assemble(out: str, name: str, mesh: dict, shapes: dict) -> dict:
    """The whole arrays of every process's blocks of case ``name``
    (``_block``'s layout: data shard rows, sp slice, tp heads)."""
    full = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    dp, fsdp = mesh.get("dp", 1), mesh.get("fsdp", 1)
    sp, tp = mesh.get("sp", 1), mesh.get("tp", 1)
    saved = {}
    for r, c in enumerate(_coords(mesh)):
        got = torch.load(os.path.join(out, f"{name}.rank{r}.pt"),
                         weights_only=False)
        saved[r] = got.get("saved")
        d = int(c["dp"]) * fsdp + int(c["fsdp"])
        for n, arr in full.items():
            b = arr.shape[0] // (dp * fsdp)
            s = arr.shape[1] // sp
            h = arr.shape[2] // tp
            i, t = int(c["sp"]), int(c["tp"])
            arr[d * b:(d + 1) * b, i * s:(i + 1) * s,
                t * h:(t + 1) * h] = got[n].numpy()
    full["saved"] = saved
    return full


def attn_cases(impl: str, cases: dict, inputs_dir: str,
               seq: dict | None = None) -> list:
    """The world's ``attn`` cases, with their inputs written to
    ``inputs_dir``."""
    out = []
    for name, (mesh, causal, H, Hkv, window, dtype, flash) in cases.items():
        path = os.path.join(inputs_dir, f"{name}.npz")
        np.savez(path, **attn_inputs(H, Hkv, seq=(seq or {}).get(name, S)))
        out.append({"kind": "attn", "name": name, "impl": impl,
                    "mesh": MESHES[mesh], "causal": causal,
                    "window": window, "dtype": dtype, "flash": flash,
                    "inputs": path})
    return out


@functools.lru_cache(maxsize=None)
def jax_init(variant: tuple = ()) -> dict:
    """The JAX trainer's init (seed 7) of MODEL with ``variant``'s
    overrides, the start of every training run."""
    cfg = jax_config.Config()
    for k, v in TRAIN.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(1)
    ds = DATASETS["synthetic_lm"](**{k: v for k, v in _dataset(
        "synthetic_lm", 1).items() if k != "kind"})
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **MODEL, **dict(variant))), JaxLoader(ds, rt, batch_size=2,
                                               seed=TRAIN["seed"]))
    return {k: np.asarray(v) for k, v in
            flatten(jax.tree.map(np.asarray, jt.state["params"])).items()}


def jax_train(mesh: dict, train: dict, model: dict, kind: str,
              impl: str) -> tuple:
    """JAX's trainer on the fake CPU devices of ``mesh`` from
    ``jax_init``: losses, gradient norms (from each step's metrics, the
    first dropped as the port's rows drop it) and final params."""
    cfg = jax_config.Config()
    for k, v in {**TRAIN, **train}.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(WORLD, **mesh)
    ds = DATASETS[kind](**{k: v for k, v in _dataset(
        kind, _shards(mesh)).items() if k != "kind"})
    loader = JaxLoader(ds, rt, batch_size=TRAIN["batch_size"],
                       seed=TRAIN["seed"], shuffle=False)
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **MODEL, **model, attention_impl=impl)), loader)
    jt.state["params"] = jax.device_put(
        unflatten(jax_init(tuple(sorted(model.items())))),
        jt.state_shardings["params"])
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
                     impl: str, ckpt: str | None = None,
                     epochs: int = 1) -> Trainer:
    """The port's trainer in this process (no process group) over the
    same global batches as ``mesh``'s data shards, from ``jax_init``."""
    cfg = port_config.Config()
    shards = _shards(mesh)
    for k, v in {**TRAIN, **train, "parallel_strategy": "ddp",
                 "batch_size": TRAIN["batch_size"] * shards,
                 "total_epochs": epochs}.items():
        setattr(cfg.train, k, v)
    rt = Runtime(device=torch.device("cpu"))
    pm = port_tf.Transformer(port_tf.TransformerConfig(
        **MODEL, **model, attention_impl=impl), device="cpu")
    ds = DATASETS[kind](**{k: v for k, v in _dataset(
        kind, shards, STEPS if ckpt is None else SAVE_STEPS).items()
        if k != "kind"})
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=TRAIN["seed"], shuffle=False)
    init = jax_init(tuple(sorted(model.items())))
    return Trainer(cfg, rt, pm, loader,
                   Checkpointer(ckpt, runtime=rt) if ckpt else None,
                   params=from_jax_params(unflatten(init), pm.cfg, "cpu"))


def _rows(history: list) -> tuple:
    return ([r["loss"] for r in history],
            [r["grad_norm"] for r in history if "grad_norm" in r])


def check_trajectory(got: tuple, want: tuple, what: str) -> None:
    (gl, gn, gp), (wl, wn, wp) = got, want
    assert len(gl) == len(wl) and len(gn) == len(wn), what
    np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(gn, wn, rtol=1e-5, err_msg=what)
    for k, v in gp.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(wp[k]), rtol=0,
                                   atol=1e-4, err_msg=f"{what}: {k}")


def train_cases(impl: str, cases: dict) -> list:
    return [{"kind": "train", "name": name, "mesh": mesh,
             "train": train, "model": {**model, "attention_impl": impl},
             "dataset": _dataset(kind, _shards(mesh))}
            for name, (mesh, train, model, kind) in cases.items()]


def spawn_world(out: str, cases: list) -> None:
    """Run ``cases`` in a spawned gloo world of WORLD processes; each
    training case starts from ``jax_init`` of its model variant."""
    for case in cases:
        if case["kind"] == "train":
            extra = tuple(sorted((k, v) for k, v in case["model"].items()
                                 if k != "attention_impl"))
            case["init"] = os.path.join(out, f"init_{case['name']}.pt")
            torch.save({k: torch.from_numpy(np.array(v))
                        for k, v in jax_init(extra).items()}, case["init"])
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


# -- the module's world ------------------------------------------------------

SAVE_STEPS = 2      # one epoch of 2 steps, saved; then a second epoch


def _ckpt_cases(out: str) -> list:
    """The checkpoint cases: a save at dp 2 x sp 2 after one epoch, its
    resume there for a second epoch, and the resume at dp 2 x sp 2 of a
    save this process made at sp 1 (``_sp1_save``)."""
    mesh = {"dp": 2, "sp": 2}
    data = _dataset("synthetic_lm", 2, SAVE_STEPS)
    base = {"kind": "train", "mesh": mesh, "dataset": data,
            "model": {"attention_impl": "ring"}}
    return [
        {**base, "name": "save_sp2", "ckpt": os.path.join(out, "ckpt_sp2"),
         "train": {"parallel_strategy": "ddp", "save_every": 1}},
        {**base, "name": "resume_sp2", "ckpt": os.path.join(out, "ckpt_sp2"),
         "train": {"parallel_strategy": "ddp", "save_every": 1,
                   "total_epochs": 2}},
        {**base, "name": "resume_from_sp1",
         "ckpt": os.path.join(out, "ckpt_sp1"),
         "train": {"parallel_strategy": "ddp", "save_every": 1,
                   "total_epochs": 2}}]


def _sp1_save(out: str) -> None:
    """One epoch at sp 1 in this process, saved, for ``resume_from_sp1``."""
    t = port_one_process({"dp": 2}, {"save_every": 1}, {}, "synthetic_lm",
                         "ring", ckpt=os.path.join(out, "ckpt_sp1"))
    t.train()


_WORLD: dict = {}


def spawned(tmp_path_factory) -> str:
    """The module's world: every attention, training and checkpoint case,
    run once per test process; returns its output directory."""
    if "out" not in _WORLD:
        out = str(tmp_path_factory.mktemp("ring_world"))
        _sp1_save(out)
        cases = (attn_cases("ring", RING_CASES, out)
                 + attn_cases("ring", FLASH_CASES, out,
                              seq={n: FLASH_S for n in FLASH_CASES})
                 + train_cases("ring", TRAIN_CASES) + _ckpt_cases(out))
        spawn_world(out, cases)
        _WORLD["out"] = out
    return _WORLD["out"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawned(tmp_path_factory)


def check_attention(impl: str, name: str, case: tuple, out: str,
                    seq: int = S) -> dict:
    mesh, causal, H, Hkv, window, dtype, _block = case
    inputs = attn_inputs(H, Hkv, seq=seq)
    shapes = {"out": (B, seq, H, D), "dq": (B, seq, H, D),
              "dk": (B, seq, Hkv, D), "dv": (B, seq, Hkv, D)}
    got = assemble(out, name, MESHES[mesh], shapes)
    want = jax_attention(impl, MESHES[mesh], inputs, causal, window, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for n in shapes:
        # A gradient's absolute limit scales with its largest magnitude:
        # an element that is 0 in exact arithmetic (the first query's dq,
        # whose softmax sees one key: dp - delta cancels) carries the
        # rounding of its largest terms, summed in another order by each
        # framework.
        scale = 1.0 if n == "out" else max(1.0, np.abs(want[n]).max())
        np.testing.assert_allclose(got[n], want[n], err_msg=f"{name}: {n}",
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)
    return got


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_matches_jax(name, world):
    got = check_attention("ring", name, RING_CASES[name], world)
    mesh = MESHES[RING_CASES[name][0]]
    # The reverse ring's residuals: q, k, v, out and lse of the local
    # slice, nothing rotated.
    H, Hkv = RING_CASES[name][2:4]
    b = B // _shards(mesh)
    s = S // mesh["sp"]
    h, hk = H // mesh.get("tp", 1), Hkv // mesh.get("tp", 1)
    want = sorted([[b, s, h, D], [b, s, hk, D], [b, s, hk, D], [b, s, h, D],
                   [b, h, s]])
    for r, shapes in got["saved"].items():
        assert sorted(shapes) == want, (name, r, shapes)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_ring_flash_blocks_match_jax(name, world):
    """The blocks forced through the kernels' wrappers: on CPU tensors
    the forward and the split backward's plain versions, composed by the
    ring as on the card."""
    check_attention("ring", name, FLASH_CASES[name], world, seq=FLASH_S)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 20)])
def test_ring_sp1_degenerates_as_jax(causal, window):
    inputs = attn_inputs(4, 2)
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_()
               for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, SPGroup(), causal=causal, window=window)
    out.backward(torch.from_numpy(inputs["do"]))
    want = jax_attention("ring", {"dp": 4}, inputs, causal, window,
                         "float32")
    for n, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                 ("dv", v.grad)):
        np.testing.assert_allclose(t.detach().numpy(), want[n],
                                   err_msg=n, **F32_TOL)


def test_ring_refuses_as_jax():
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="window > 0 requires causal"):
        ring_attention(q, q, q, SPGroup(), causal=False, window=4)
    with pytest.raises(ValueError, match="do not divide the local shard"):
        ring_attention(q, q, q, SPGroup(), block_q=6)
    with pytest.raises(ValueError, match="window must be >= 0"):
        ring_attention(q, q, q, SPGroup(), window=-1)


def _world_run(out: str, name: str) -> tuple:
    res = torch.load(os.path.join(out, f"{name}.pt"), weights_only=False)
    return (*_rows(res["rows"]), {k: v.numpy()
                                  for k, v in res["params"].items()})


def check_training(impl: str, name: str, case: tuple, out: str) -> None:
    mesh, train, model, kind = case
    got = _world_run(out, name)
    assert len(got[0]) == STEPS
    check_trajectory(got, jax_train(mesh, train, model, kind, impl),
                     f"{name} vs JAX")
    one = port_one_process(mesh, train, model, kind, impl)
    one.train()
    check_trajectory(got, (*_rows(one.metrics.history),
                           {k: v.detach().numpy() for k, v in
                            flatten(one.state["params"]).items()}),
                     f"{name} vs one process")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_sp_training_matches_jax_and_one_process(name, world):
    check_training("ring", name, TRAIN_CASES[name], world)


def test_save_at_sp2_resumes_at_sp1(world, tmp_path):
    """A save at dp 2 x sp 2 restores at sp 1 to the saved params, and
    the resumed epoch gives the sp 2 resume's trajectory."""
    saved = _world_run(world, "save_sp2")
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(world, "ckpt_sp2"), ckpt)
    with open(ckpt / str(SAVE_STEPS) / "layout.json") as f:
        assert json.load(f)["replica_axes"] == ["sp"]
    shutil.rmtree(ckpt / str(2 * SAVE_STEPS))
    t = port_one_process({"dp": 2}, {"save_every": 0}, {}, "synthetic_lm",
                         "ring", ckpt=str(ckpt), epochs=2)
    assert t.state["step"] == SAVE_STEPS
    for k, v in flatten(t.state["params"]).items():
        assert np.array_equal(v.detach().numpy(), saved[2][k]), k
    t.train()
    resumed = _world_run(world, "resume_sp2")
    check_trajectory((*_rows(t.metrics.history),
                      {k: v.detach().numpy() for k, v in
                       flatten(t.state["params"]).items()}), resumed,
                     "sp 1 resume vs sp 2 resume")


def test_save_at_sp1_resumes_at_sp2(world):
    got = _world_run(world, "resume_from_sp1")
    want = _world_run(world, "resume_sp2")
    assert len(got[0]) == SAVE_STEPS
    check_trajectory(got, want, "sp 2 resume of an sp 1 save")


# -- layout, loader, plans ---------------------------------------------------


@pytest.mark.parametrize("strategy,mesh", [
    ("ddp", {"dp": 2, "sp": 2}), ("zero1", {"dp": 2, "sp": 2}),
    ("fsdp", {"fsdp": 2, "sp": 2}), ("hybrid", {"dp": 2, "fsdp": 2, "sp": 2}),
    ("tp", {"sp": 2, "tp": 2}), ("tp_fsdp", {"fsdp": 2, "sp": 2, "tp": 2})])
def test_strategy_specs_with_sp_equal_jax(strategy, mesh):
    """Every strategy's param and moment specs with ``sp`` in the mesh
    equal JAX's leaf for leaf, and no leaf is split over sp."""
    spec = MeshSpec(**mesh)
    jspec = jax_runtime.MeshSpec(**mesh)
    pm = port_tf.Transformer(port_tf.TransformerConfig(**MODEL),
                             device="cpu")
    shapes, logical = flatten(pm.param_shapes()), flatten(pm.logical_axes())
    ps = port_strategy.get_strategy(strategy, spec, min_shard_elems=1)
    js = jax_strategy.get_strategy(strategy, jspec, min_shard_elems=1)
    for k, shape in shapes.items():
        got = ps.param_spec(shape, logical.get(k))
        want = tuple(js.param_spec(shape, logical.get(k)))
        assert got == want, k
        assert tuple(ps.opt_spec(shape, logical.get(k))) == tuple(
            js.opt_spec(shape, logical.get(k))), k
        assert "sp" not in str(got)


def test_loader_slices_rows_over_sp():
    """Each sp member of a data shard reads the shard's rows and keeps
    its slice: S/sp inputs and their shifted targets."""
    ds = DATASETS["synthetic_lm"](size=8, seq_len=16, vocab_size=64, seed=1)

    class Rt:
        device = torch.device("cpu")
        data_shard_count, data_shard_index = 2, 1

        def __init__(self, i, n):
            self.seq_shard_index, self.seq_shard_count = i, n

    def first(rt):
        return next(iter(ShardedDataLoader(ds, rt, batch_size=2,
                                           shuffle=False).epoch(0)))["tokens"]

    whole = first(Rt(0, 1))
    parts = [first(Rt(i, 4)) for i in range(4)]
    for i, p in enumerate(parts):
        assert torch.equal(p, whole[:, 4 * i:4 * i + 5])
        assert torch.equal(p, torch.from_numpy(
            sequence_slice(whole.numpy(), i, 4)))
    with pytest.raises(ValueError, match="does not split over sp=3"):
        sequence_slice(whole.numpy(), 0, 3)


@pytest.mark.parametrize("sp", [2, 4])
def test_dropout_masks_of_a_slice_are_the_whole_sequence_masks(sp):
    """Under sp each member draws the whole sequence's mask and keeps its
    slice: the masks of an sp run are those of a run at sp 1."""
    x = torch.randn(2, 32, 8)
    whole = port_tf._dropout(x, 0.3, 1234)
    n = 32 // sp
    for i in range(sp):
        part = port_tf._dropout(x[:, i * n:(i + 1) * n], 0.3, 1234,
                                (i * n, 32))
        assert torch.equal(part, whole[:, i * n:(i + 1) * n])


@pytest.mark.parametrize("name", ["multichip_8dev", "multichip_8dev_cpu"])
def test_ring_plan_model_matches_jax_at_sp1(name):
    """A committed plan whose model names ring attention (windowed GQA)
    builds in the port and gives JAX's loss and gradients at sp 1."""
    plan = port_planner.load_plan(name)
    pm = port_planner.model_for_plan(plan, device="cpu")
    assert pm.cfg.attention_impl == "ring" and pm.cfg.attention_window
    jcfg = jax_tf.TransformerConfig(
        **jax_planner.model_kwargs_for(jax_planner.load_plan(name)))
    jm = jax_tf.Transformer(jcfg)
    jm.bind_mesh(jax_runtime.fake_cpu_runtime(1).mesh)
    params = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, jcfg.max_seq_len + 1))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens)}, None,
                          train=False), has_aux=True)(params)
    tp_params = from_jax_params(jax.tree.map(np.asarray, params), pm.cfg,
                                "cpu")
    leaves = flatten(tp_params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = pm.loss(unflatten(leaves), {"tokens": torch.from_numpy(tokens)},
                      train=False)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jflat = flatten(jax.tree.map(np.asarray, jg))
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), jflat[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)

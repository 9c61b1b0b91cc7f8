"""The port's ResNet trained in a gloo world of 2, held against the JAX
package's one-device trainer on the same global batches.

A narrow ResNet (width 8, one block a stage, 16x16 images, float32)
trains 5 steps of a global batch of 8 under AdamW with two grad-accum
microbatches, from JAX's init carried across
(``models/convert.py::resnet_from_jax_params``), under ``ddp`` (dp 2),
``zero1`` (dp 2), ``fsdp`` (fsdp 2) and ``tp`` (tp 2, every rank the
whole model on the whole batch). GroupNorm has no batch statistics, so
each world equals one process on the global batch up to the order of
the gradient sums: losses, gradient norms and accuracies within
``LIMITS`` (1e-5) of JAX's, the final params within 1e-5. The
planted fault (ZeRO-1 with the gradient all-reduce dropped for the
leaves whose moments the heuristic slices) must fall outside the
limits. The fsdp run saves a checkpoint, which restores at world 1 bit
for bit, and its placements are JAX's strategy specs. ``mesh.sp=2`` and
``mesh.pp=2`` raise: the model has no sequence and no pipeline.

The world (worker ``tests/test_torch_resnet_worker.py``) and the JAX
run are made once for every test process of a run, under a lock in the
run's base temp dir (``_once``); ``tests/test_torch_resnet.py`` holds
the port's one-process trainer against the same JAX run.
"""

import fcntl
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.models.convert import resnet_from_jax_params
from distributed_training_tpu_torch.models.resnet import ResNet
from distributed_training_tpu_torch.runtime import Runtime
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.data import build_dataset as jax_dataset  # noqa: E402
from distributed_training_tpu.models import resnet as jax_resnet  # noqa: E402
from distributed_training_tpu.parallel import strategy as jax_strategy  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_resnet_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(width=8, stage_sizes=[1, 1, 1, 1], num_classes=10,
             dtype="float32")
STEPS, BATCH = 5, 8
# 256: the stem (216 elements) and the GroupNorm leaves stay whole, the
# convs and the head split, as at full width under the default 4096.
TRAIN = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1,
             decay_mask="matrices", grad_clip_norm=1.0, grad_accum_steps=2,
             total_epochs=1, log_every=1, dtype="float32", seed=5,
             min_shard_elems=256, save_every=0)
DATASET = dict(size=STEPS * BATCH, height=16, width=16, seed=5)
# name → (mesh, train overrides (rows a data shard), fault or "raises").
CASES = {
    "ddp": ({"dp": 2}, {"parallel_strategy": "ddp", "batch_size": 4}, None),
    "zero1": ({"dp": 2}, {"parallel_strategy": "zero1", "batch_size": 4},
              None),
    "fsdp": ({"dp": 1, "fsdp": 2},
             {"parallel_strategy": "fsdp", "batch_size": 4, "save_every": 1},
             None),
    "tp": ({"dp": 1, "tp": 2}, {"parallel_strategy": "tp", "batch_size": 8},
           None),
    "zero1_unsummed": ({"dp": 2},
                       {"parallel_strategy": "zero1", "batch_size": 4},
                       "unsummed"),
    "sp2": ({"dp": 1, "sp": 2}, {"batch_size": 8}, "raises"),
    "pp2": ({"dp": 1, "pp": 2}, {"batch_size": 8}, "raises"),
}
SOUND = [n for n, c in CASES.items() if c[2] is None]
# Differences from JAX's per-step metrics that every sound world meets
# and the fault misses: relative for the loss and the gradient norm,
# absolute for the accuracy (a multiple of 1/8, often 0). Final params
# within PARAMS_ATOL absolute: AdamW's step lr·m/(sqrt(v)+eps) is
# sensitive where a gradient is near 0, and there the f32 sums of two
# conv libraries differ (3.6e-6 at most over 5 steps of lr 1e-3; the
# fault moves params by 9e-3).
LIMITS = {"loss": 1e-5, "grad_norm": 1e-5, "accuracy": 1e-5}
PARAMS_ATOL = 1e-5


def jax_init():
    """JAX's init (seed 11) of the narrow ResNet."""
    return jax_resnet.ResNet(**MODEL).init(jax.random.PRNGKey(11))


def port_flat(jax_tree) -> dict:
    """A JAX ResNet tree as the port's flat f32 numpy leaves."""
    params = resnet_from_jax_params(jax.tree.map(np.asarray, jax_tree),
                                    ResNet(**MODEL, device="cpu"), "cpu")
    return {k: v.numpy() for k, v in flatten(params).items()}


def _jax_run() -> dict:
    """JAX's trainer on one CPU device from ``jax_init`` on the global
    batches: per step loss, gradient norm and accuracy, and the final
    params (port-flat)."""
    cfg = jax_config.Config()
    for k, v in {**TRAIN, "batch_size": BATCH}.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(1)
    loader = JaxLoader(jax_dataset("synthetic_images", **DATASET), rt,
                       batch_size=BATCH, seed=TRAIN["seed"], shuffle=False)
    jt = JaxTrainer(cfg, rt, jax_resnet.ResNet(**MODEL), loader)
    jt.state["params"] = jax.device_put(jax_init(),
                                        jt.state_shardings["params"])
    out = {k: [] for k in LIMITS}
    step = jt.train_step

    def train_step(batch):
        m = step(batch)
        for k in out:
            out[k].append(float(m[k]))
        return m
    jt.train_step = train_step
    jt.train()
    out["params"] = port_flat(jt.state["params"])
    return out


def _spawn(out: str) -> None:
    torch.save({k: torch.from_numpy(v)
                for k, v in port_flat(jax_init()).items()},
               os.path.join(out, "init.pt"))
    cases = [{"name": name, "mesh": mesh, "train": train,
              **({"raises": True} if fault == "raises"
                 else {"fault": fault} if fault else {}),
              **({"ckpt": os.path.join(out, "ckpt_fsdp")}
                 if name == "fsdp" else {})}
             for name, (mesh, train, fault) in CASES.items()]
    job = {"world": 2, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "model": MODEL, "dataset": DATASET,
           "train": {**TRAIN, "device": "cpu"},
           "init": os.path.join(out, "init.pt"), "cases": cases}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        log[-3000:] for log in logs)


def _once(root, name: str, make):
    """``make(dir)``'s result, made once for every test process of the
    run that shares ``root`` (an exclusive lock around a marker file),
    then read from ``dir``."""
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


def _run_root(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above the workers'
    return root


_MADE: dict = {}


def jax_reference(tmp_path_factory) -> dict:
    """JAX's run, once per test run (shared with tests/test_torch_resnet.py)."""
    if "jax" not in _MADE:
        _MADE["jax"] = _once(_run_root(tmp_path_factory), "resnet_jax",
                             lambda d: _jax_run())
    return _MADE["jax"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's output directory, JAX's run), once per test run."""
    if "world" not in _MADE:
        def make(d):
            _spawn(d)
            return {"dir": d}
        _MADE["world"] = {**_once(_run_root(tmp_path_factory),
                                  "resnet_world", make),
                          "jax": jax_reference(tmp_path_factory)}
    return _MADE["world"]


def _world_run(world: dict, name: str) -> dict:
    return torch.load(os.path.join(world["dir"], f"{name}.pt"),
                      weights_only=False)


def rel_diffs(rows: list, want: dict) -> dict:
    """Largest difference of each LIMITS metric over the steps (relative
    but for the accuracy's)."""
    assert len(rows) == STEPS, rows
    out = {}
    for k in LIMITS:
        diff = np.abs(np.subtract([r[k] for r in rows], want[k]))
        out[k] = float(np.max(diff if k == "accuracy"
                              else diff / np.abs(want[k])))
    return out


@pytest.mark.parametrize("name", SOUND)
def test_world_matches_jax(name, world):
    diffs = rel_diffs(_world_run(world, name)["rows"], world["jax"])
    assert all(diffs[k] <= LIMITS[k] for k in LIMITS), (name, diffs)
    got = _world_run(world, name)["params"]
    want = world["jax"]["params"]
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                   atol=PARAMS_ATOL, err_msg=f"{name}: {k}")


def test_planted_fault_fails_the_limits(world):
    diffs = rel_diffs(_world_run(world, "zero1_unsummed")["rows"],
                      world["jax"])
    assert any(diffs[k] > LIMITS[k] for k in LIMITS), diffs


@pytest.mark.parametrize("name", ["fsdp", "zero1", "tp"])
def test_placements_are_jax_specs(name, world):
    """Every leaf is placed where JAX's strategy puts it: no logical axes,
    so the shape heuristic (the fsdp params, ZeRO-1's moments; nothing
    over tp). The stem and the GroupNorm leaves stay whole; a conv with
    cin == cout splits cin, the lower of the tied dims."""
    mesh, train, _ = CASES[name]
    sizes = types.SimpleNamespace(**{"dp": 1, "fsdp": 1, "tp": 1, **mesh})
    strat = jax_strategy.get_strategy(train["parallel_strategy"], sizes,
                                      min_shard_elems=TRAIN["min_shard_elems"])
    run = _world_run(world, name)
    key = "opt_placements" if name == "zero1" else "placements"
    shapes = flatten(ResNet(**MODEL, device="cpu").param_shapes())
    spec_of = strat.opt_spec if name == "zero1" else strat.param_spec
    for path, shape in shapes.items():
        spec = tuple(spec_of(shape, None))
        want = tuple((d, (a,) if isinstance(a, str) else tuple(a))
                     for d, a in enumerate(spec) if a is not None) or None
        assert run[key][path] == want, (path, run[key][path], spec)
    if name == "fsdp":
        assert run[key]["stem/w"] is None
        assert run[key]["stage0/0/gn1/scale"] is None
        assert run[key]["stage0/0/conv2"] == ((2, ("fsdp",)),)


def test_fsdp2_save_restores_at_world_1_bit_for_bit(world):
    saved = _world_run(world, "fsdp")["params"]
    ck = Checkpointer(os.path.join(world["dir"], "ckpt_fsdp"),
                      runtime=Runtime(device=torch.device("cpu")))
    state, _ = ck.restore_latest(torch.device("cpu"), None)
    got = flatten(state["params"])
    assert set(got) == set(saved)
    for k, v in got.items():
        assert torch.equal(v, saved[k]), k


@pytest.mark.parametrize("name,axis", [("sp2", "sp"), ("pp2", "pp")])
def test_sequence_and_pipeline_meshes_raise(name, world, axis):
    error = _world_run(world, name)["error"]
    assert error is not None and f"mesh.{axis}=2" in error, error
    assert "ResNet" in error

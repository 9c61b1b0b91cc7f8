"""The port's MLP (the default config's model) held against the JAX
package's.

Model: forward, loss and gradients of a ReLU stack (12 → 16 → 8 → out)
for ``mse``, ``prob_xent`` (the reference's degenerate single-logit
loss: 0, with zero gradients, on both sides) and ``xent``, float32,
within 1e-5 relative, from the JAX init carried across
(``models/convert.py::mlp_from_jax_params``).

CLI: ``python -m distributed_training_tpu_torch.train`` with no model or
data override (``conf/config.yaml``: ``Linear(20, 1)`` on ``synthetic``
under SGD and ``ddp``), ``train.device=cpu``, 20 steps of one epoch then
a rerun to two epochs that resumes from the epoch-0 checkpoint, against
the JAX trainer's 40 steps on the same config from the same init: every
per-step loss within 1e-5 relative.

Sharded: the default MLP under ``fsdp`` (fsdp 2, ``min_shard_elems=1``
so that ``layer0/w`` really shards its 20 rows) and ``zero1`` (dp 2) in
a spawned gloo world of 2 (``tests/test_torch_mlp_world.py``), against
the JAX trainer on 2 fake CPU devices of the same mesh: losses and
gradient norms within 1e-5 relative, final params within 1e-6. The same
world runs the Adafactor cases of ``tests/test_torch_adafactor.py``
(``spawned``, once per test process).
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models import mlp as port_mlp
from distributed_training_tpu_torch.models.convert import mlp_from_jax_params
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.parallel.strategy import Placement
from distributed_training_tpu_torch.train import cli
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.data import build_dataset as jax_dataset  # noqa: E402
from distributed_training_tpu.models import build_model as jax_model  # noqa: E402
from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_mlp_world.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# conf/model/default.yaml
DEFAULT_MLP = dict(input_size=20, output_size=1, hidden_sizes=[])
STEPS = 5
BATCH = 8
# Sharded runs: name → (model, model kwargs, mesh, train settings).
ADA_MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                 d_ff=256, max_seq_len=32, dtype="float32")
ADA_TRAIN = dict(optimizer="adafactor", learning_rate=1e-2,
                 weight_decay=0.1, decay_mask="matrices", warmup_steps=2,
                 lr_schedule="cosine", grad_clip_norm=1.0)
CASES = {
    "mlp_fsdp": ("mlp", DEFAULT_MLP, {"dp": 1, "fsdp": 2},
                 {"parallel_strategy": "fsdp", "min_shard_elems": 1}),
    "mlp_zero1": ("mlp", DEFAULT_MLP, {"dp": 2},
                  {"parallel_strategy": "zero1", "min_shard_elems": 1}),
    "ada_fsdp": ("transformer", ADA_MODEL, {"dp": 1, "fsdp": 2},
                 {"parallel_strategy": "fsdp", **ADA_TRAIN}),
    "ada_zero1": ("transformer", ADA_MODEL, {"dp": 2},
                  {"parallel_strategy": "zero1", **ADA_TRAIN}),
}
BASE_TRAIN = dict(batch_size=BATCH, total_epochs=1, log_every=1,
                  dtype="float32", seed=11, save_every=1)


def _dataset(name: str, shards: int) -> tuple:
    """(registry name, kwargs) of a case's data: STEPS global batches."""
    size = STEPS * BATCH * shards
    if CASES[name][0] == "mlp":
        return "synthetic", {"size": size, "seed": BASE_TRAIN["seed"]}
    return "synthetic_lm", {"size": size, "seq_len": 32, "vocab_size": 256,
                            "seed": BASE_TRAIN["seed"]}


@functools.lru_cache(maxsize=None)
def jax_init(model: str) -> dict:
    """The JAX init (seed 11) of a case's model, flat numpy."""
    kw = DEFAULT_MLP if model == "mlp" else ADA_MODEL
    m = (jax_model("mlp", **kw) if model == "mlp"
         else jax_tf.Transformer(jax_tf.TransformerConfig(**kw)))
    return flatten(jax.tree.map(np.asarray,
                                m.init(jax.random.PRNGKey(11))))


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def jax_run(name: str) -> dict:
    """The JAX trainer on fake CPU devices of the case's mesh."""
    model, kw, mesh, over = CASES[name]
    world = int(np.prod(list(mesh.values())))
    cfg = jax_config.Config()
    for k, v in {**BASE_TRAIN, **over}.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(world, **mesh)
    ds_name, ds_kw = _dataset(name, world)
    loader = JaxLoader(jax_dataset(ds_name, **ds_kw), rt, batch_size=BATCH,
                       seed=BASE_TRAIN["seed"])
    m = (jax_model("mlp", **kw) if model == "mlp"
         else jax_tf.Transformer(jax_tf.TransformerConfig(**kw)))
    jt = JaxTrainer(cfg, rt, m, loader)
    jt.state["params"] = jax.device_put(
        _unflat({k: jnp.asarray(v) for k, v in jax_init(model).items()}),
        jt.state_shardings["params"])
    norms, step = [], jt.train_step

    def train_step(batch):
        metrics = step(batch)
        norms.append(float(metrics["grad_norm"]))
        return metrics
    jt.train_step = train_step
    jt.train()
    return {"losses": [r["loss"] for r in jt.metrics.history],
            "norms": norms,
            "params": flatten(jax.tree.map(np.asarray, jt.state["params"])),
            "opt_state": jt.state["opt_state"]}


def _spawn(tmp, world: int) -> dict:
    out = str(tmp)
    runs = []
    for name, (model, kw, mesh, over) in CASES.items():
        init = os.path.join(out, f"init_{model}.pt")
        if not os.path.exists(init):
            torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                        jax_init(model).items()}, init)
        ds_name, ds_kw = _dataset(name, world)
        runs.append({"name": name, "model": model, "model_kwargs": kw,
                     "mesh": mesh, "init": init,
                     "train": {**BASE_TRAIN, **over, "dataset": ds_name},
                     "dataset": ds_kw,
                     "ckpt": os.path.join(out, f"ckpt_{name}")})
    job = {"world": world, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "runs": runs}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(
        log[-3000:] for log in logs)
    res = {r["name"]: torch.load(os.path.join(out, r["name"] + ".pt"),
                                 weights_only=False) for r in runs}
    for r in runs:
        res[r["name"]]["ckpt"] = r["ckpt"]
    return res


_WORLD: dict = {}


def spawned(tmp_path_factory) -> dict:
    """Every run of CASES in a gloo world of 2, spawned once per test
    process."""
    if not _WORLD:
        _WORLD.update(_spawn(tmp_path_factory.mktemp("mlp_world"), 2))
    return _WORLD


def check_rows(res: dict, want: dict, what: str, atol: float) -> None:
    rows = res["rows"]
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows if "grad_norm" in r]
    assert len(losses) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5,
                               err_msg=what)
    # The port's first (warm-up) row carries no grad_norm.
    np.testing.assert_allclose(norms, want["norms"][1:], rtol=1e-5,
                               err_msg=what)
    for k, v in res["params"].items():
        np.testing.assert_allclose(v.numpy(), want["params"][k], rtol=0,
                                   atol=atol, err_msg=f"{what}: {k}")


# -- the model -----------------------------------------------------------


@pytest.mark.parametrize("loss", ["mse", "prob_xent", "xent"])
def test_mlp_forward_loss_grads_match_jax(loss):
    out = 5 if loss == "xent" else 1
    kw = dict(input_size=12, output_size=out, hidden_sizes=[16, 8])
    jm = jax_model("mlp", loss=loss, **kw)
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    y = (rng.integers(0, out, (9, 1)).astype(np.float32) if loss == "xent"
         else rng.standard_normal((9, 1)).astype(np.float32))
    batch = {"x": x, "y": y}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch, jax.random.PRNGKey(0)),
        has_aux=True)(jp)

    pm = build_model("mlp", loss=loss, device="cpu", **kw)
    params = mlp_from_jax_params(jax.tree.map(np.asarray, jp), pm, "cpu")
    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    pl, metrics = pm.loss(params, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
    grads = torch.autograd.grad(pl, list(flat.values()))
    np.testing.assert_allclose(
        pm.apply(params, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    assert float(metrics["loss"]) == float(pl.detach())
    want = flatten(jax.tree.map(np.asarray, jg))
    for (k, _), g in zip(flat.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    if loss == "prob_xent":
        # The reference's single-logit loss never moves (SURVEY.md §8 B5).
        assert float(pl.detach()) == 0.0 and all(not g.any() for g in grads)


def test_mlp_contract_and_refusals():
    m = build_model("mlp", device="cpu", **DEFAULT_MLP)
    assert m.cfg.loss_name == "mse" and m.stacked_keys == ()
    assert m.param_shapes() == {"layer0": {"w": (20, 1), "b": (1,)}}
    jm = jax_model("mlp", **DEFAULT_MLP)
    assert m.logical_axes() == jm.logical_axes()
    assert m.flops_per_sample() == jm.flops_per_sample()
    with pytest.raises(ValueError, match="unknown loss"):
        build_model("mlp", loss="hinge", device="cpu")

    class TP:
        size = 2
    # A width tp divides would be split by the strategy: refused.
    with pytest.raises(ValueError, match="tensor-parallel"):
        build_model("mlp", device="cpu", hidden_sizes=[8]
                    ).bind_tensor_parallel(TP())
    m.bind_tensor_parallel(TP())  # Linear(20, 1): nothing tp splits
    with pytest.raises(ValueError, match="shape"):
        mlp_from_jax_params({"layer0": {"w": np.zeros((2, 1)),
                                        "b": np.zeros(1)}}, m, "cpu")


# -- the default CLI -----------------------------------------------------


def test_default_cli_matches_jax_trainer(tmp_path, monkeypatch):
    over = ["train.max_steps_per_epoch=20", "train.log_every=1"]
    cfg = jax_config.load_config(overrides=over + ["train.total_epochs=2"])
    assert cfg.model.name == "mlp" and cfg.train.optimizer == "sgd"
    assert cfg.train.dataset == "synthetic"
    rt = jax_runtime.fake_cpu_runtime(1)
    ds = jax_dataset(cfg.train.dataset,
                     _defaults={"size": cfg.train.dataset_size,
                                "seed": cfg.train.seed},
                     **cfg.train.dataset_kwargs)
    loader = JaxLoader(ds, rt, batch_size=cfg.train.batch_size,
                       shuffle=cfg.train.shuffle, seed=cfg.train.seed,
                       max_steps_per_epoch=cfg.train.max_steps_per_epoch)
    jt = JaxTrainer(cfg, rt, jax_model(cfg.model.name, **cfg.model.kwargs),
                    loader)
    init = jax.tree.map(np.asarray, jt.state["params"])
    jt.train()
    want = [r["loss"] for r in jt.metrics.history]
    assert len(want) == 40

    monkeypatch.setattr(port_mlp.MLP, "init", lambda self, rng: (
        mlp_from_jax_params(init, self, self.device)))
    argv = ["train.device=cpu", "run.log_level=WARNING",
            f"run.output_dir={tmp_path}", *over]
    assert cli.main(argv + ["train.total_epochs=1"]) == 0
    ckpt = tmp_path / "default" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["20"]  # save_every 2: epoch 0
    assert cli.main(argv + ["train.total_epochs=2"]) == 0
    rows = [json.loads(line)
            for line in open(tmp_path / "default" / "metrics.jsonl")]
    assert sum(1 for r in rows if r.get("run_start")) == 2
    got = [r["loss"] for r in rows if "loss" in r]
    assert [r["step"] for r in rows if "loss" in r] == list(range(1, 41))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    events = [json.loads(line)
              for line in open(tmp_path / "default" / "events.jsonl")]
    assert [e["step"] for e in events if e.get("kind") == "resume"] == [20]


# -- sharded -------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawned(tmp_path_factory)


@pytest.mark.parametrize("name", ["mlp_fsdp", "mlp_zero1"])
def test_mlp_sharded_matches_jax_trainer(name, world):
    res = world[name]
    check_rows(res, jax_run(name), name, atol=1e-6)
    if name == "mlp_fsdp":
        assert res["layout"] == {"layer0/w": ((0, ("fsdp",)),),
                                 "layer0/b": None}
        assert Placement(res["layout"]["layer0/w"]).axes == ("fsdp",)

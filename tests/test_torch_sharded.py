"""The port's sharded training held against the JAX package's.

Layout: ``logical_axes`` and every strategy's param/optimizer specs
equal the JAX ones leaf for leaf on each preset's shapes at fsdp 1, 2
and 4; ``MeshSpec.resolve`` raises as the JAX one does; the replica
fingerprint is the JAX one.

Trajectories: a tiny decoder (2 layers, d 64, 4 heads, vocab 512, seq
128, float32) trains 5 AdamW steps (warmup, cosine, clipping, weight
decay) under ``ddp`` (dp 2), ``zero1`` (dp 2), ``fsdp`` (fsdp 2),
``hybrid`` (dp 2 x fsdp 2), ``fsdp`` with ``grad_accum_steps=2``,
``tp`` (tp 2), ``tp`` over dp 2 x tp 2 and ``tp_fsdp`` (fsdp 2 x tp
2), and a GQA/RoPE/untied variant (2 kv heads) under ``tp`` at tp 2
(kv heads split) and tp 4 (kv heads replicated, their gradients summed
over tp), from the JAX init, through the JAX trainer on fake CPU devices
of the same mesh shape and through the port's trainer in spawned gloo
worlds (``tests/test_torch_sharded_world.py``, one world of 2 and one of
4 processes, rendezvous through a file). Per-step losses and gradient
norms agree within 1e-5 relative and final params within 1e-4, against
the JAX trainer and against the port's own one-process ``ddp`` run over
the same global batches. In the same worlds: a save on preemption at
step 2 that one process alone asked for resumes to the uninterrupted
trajectory under ``fsdp`` and under ``tp_fsdp``, its consolidated
artifact (and the offline export) holds the whole params, the
replica-drift check reads 0 until one process perturbs its replica (a
``ddp`` weight, and a layer norm replicated over tp), and
optimizer-state offload leaves the trajectory as it was. In the test
process, bfloat16: ``fsdp`` in a gloo group of one gives ``ddp``'s
losses and gradient norms bit for bit.

The worlds are spawned once per test process and shared with
``tests/test_torch_tp.py`` (``spawned``), whose ``tp_ops`` runs they
also hold.
"""

import functools
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import export as port_export
from distributed_training_tpu_torch.checkpoint.consolidate import (
    load_consolidated,
)
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.parallel import strategy as port_strategy
from distributed_training_tpu_torch.parallel.planner import PlanError
from distributed_training_tpu_torch.runtime import MeshSpec as PortMeshSpec
from distributed_training_tpu_torch.runtime import MeshSpecError, Runtime
from distributed_training_tpu_torch.serving.disagg import (
    _QUANT_AXES,
    quantize_params_int8,
)
from distributed_training_tpu_torch.train import cli as port_cli
from distributed_training_tpu_torch.train.optimizer import flatten
from distributed_training_tpu_torch.train.trainer import Trainer
from distributed_training_tpu_torch.utils import diagnostics

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.data import SyntheticLMDataset as JaxLM  # noqa: E402
from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402
from distributed_training_tpu.parallel import strategy as jax_strategy  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from distributed_training_tpu.utils import diagnostics as jax_diag  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_sharded_world.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
             max_seq_len=128, dtype="float32")
# Model variants beside MODEL: GQA (2 kv heads), RoPE, an untied head.
VARIANTS = {"gqa": dict(n_kv_heads=2, pos_encoding="rope",
                        tie_embeddings=False)}
TRAIN = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.1,
             warmup_steps=2, lr_schedule="cosine", grad_clip_norm=0.5,
             batch_size=2, total_epochs=1, log_every=1, dtype="float32",
             seed=7)
STEPS = 5
# name → (mesh, train overrides): the cases held against the JAX trainer.
CASES = {
    "ddp": ({"dp": 2}, {"parallel_strategy": "ddp"}),
    "zero1": ({"dp": 2}, {"parallel_strategy": "zero1"}),
    "fsdp": ({"dp": 1, "fsdp": 2}, {"parallel_strategy": "fsdp"}),
    "hybrid": ({"dp": 2, "fsdp": 2}, {"parallel_strategy": "hybrid"}),
    "fsdp_accum": ({"dp": 1, "fsdp": 2},
                   {"parallel_strategy": "fsdp", "grad_accum_steps": 2,
                    "batch_size": 4}),
    "tp": ({"dp": 1, "tp": 2}, {"parallel_strategy": "tp"}),
    "tp_dp": ({"dp": 2, "tp": 2}, {"parallel_strategy": "tp"}),
    "tp_fsdp": ({"dp": 1, "fsdp": 2, "tp": 2},
                {"parallel_strategy": "tp_fsdp"}),
    "tp_gqa": ({"dp": 1, "tp": 2}, {"parallel_strategy": "tp"}),
    "tp4_gqa": ({"dp": 1, "tp": 4}, {"parallel_strategy": "tp"}),
}
# The cases on a variant of MODEL.
CASE_VARIANT = {"tp_gqa": "gqa", "tp4_gqa": "gqa"}
# Port-only train settings of a case (the JAX run does without them):
# the replica check each step, which compares the leaves tp leaves whole
# (layer norms; the kv heads tp 4 does not divide) across tp.
PORT_ONLY = {"tp4_gqa": {"divergence_check_every": 1}}


def _dataset_kw(batch: int, world: int) -> dict:
    return dict(size=STEPS * batch * world, seq_len=128, vocab_size=512,
                seed=TRAIN["seed"])


# Runs of the 2-process world beside the JAX cases.
EXTRA_RUNS = [
    {"name": "fsdp_resume", "kind": "resume", "mesh": {"dp": 1, "fsdp": 2},
     "train": {"parallel_strategy": "fsdp", "gather_on_save": True,
               "stop_poll_every": 1}},
    {"name": "ddp_drift", "kind": "drift", "mesh": {"dp": 2},
     "train": {"parallel_strategy": "ddp", "divergence_check_every": 1}},
    {"name": "fsdp_offload", "mesh": {"dp": 1, "fsdp": 2},
     "train": {"parallel_strategy": "fsdp", "offload_opt_state": True}},
    {"name": "tp_drift", "kind": "drift", "mesh": {"dp": 1, "tp": 2},
     "leaf": "ln1/scale", "dataset": _dataset_kw(TRAIN["batch_size"], 1),
     "train": {"parallel_strategy": "tp", "divergence_check_every": 1}},
    # Checked by tests/test_torch_tp.py.
    {"name": "tp_ops", "kind": "tp_ops", "mesh": {"dp": 1, "tp": 2}},
]
# Runs of the 4-process world beside the JAX cases.
EXTRA_RUNS_4 = [
    {"name": "tp_fsdp_resume", "kind": "resume",
     "mesh": {"dp": 1, "fsdp": 2, "tp": 2},
     "dataset": _dataset_kw(TRAIN["batch_size"], 2),
     "train": {"parallel_strategy": "tp_fsdp", "gather_on_save": True,
               "stop_poll_every": 1}},
]


def _world(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def _shards(mesh: dict) -> int:
    """The data shards of a mesh: tp ranks share their batch."""
    return _world(mesh) // mesh.get("tp", 1)


def _batch(name: str) -> int:
    return CASES[name][1].get("batch_size", TRAIN["batch_size"])


def _rows(history: list) -> tuple:
    losses = [r["loss"] for r in history]
    norms = [r["grad_norm"] for r in history if "grad_norm" in r]
    return losses, norms


def _model(variant: str = "") -> dict:
    return {**MODEL, **VARIANTS.get(variant, {})}


@functools.lru_cache(maxsize=None)
def jax_init(variant: str = "") -> dict:
    """The JAX trainer's init (seed 7) of a model variant, the start of
    every run on it."""
    cfg = jax_config.Config()
    for k, v in TRAIN.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(1)
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **_model(variant))), JaxLoader(JaxLM(**_dataset_kw(2, 1)), rt,
                                       batch_size=2, seed=TRAIN["seed"]))
    return jax.tree.map(np.asarray, jt.state["params"])


def _jax_run(name: str, init: dict) -> tuple:
    mesh, over = CASES[name]
    world = _world(mesh)
    cfg = jax_config.Config()
    for k, v in {**TRAIN, **over}.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(world, **mesh)
    loader = JaxLoader(JaxLM(**_dataset_kw(_batch(name), _shards(mesh))), rt,
                       batch_size=_batch(name), seed=TRAIN["seed"])
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **_model(CASE_VARIANT.get(name, "")))), loader)
    jt.state["params"] = jax.device_put(
        init, jt.state_shardings["params"])
    # The JAX rows carry no grad_norm: read it from each step's metrics.
    norms, step = [], jt.train_step

    def train_step(batch):
        metrics = step(batch)
        norms.append(float(metrics["grad_norm"]))
        return metrics
    jt.train_step = train_step
    jt.train()
    # As the port's rows: none for the first (warm-up) row.
    return (_rows(jt.metrics.history)[0], norms[1:],
            flatten(jax.tree.map(np.asarray, jt.state["params"])))


def _port_one_process(batch: int, init: dict, variant: str = "") -> tuple:
    """The port's ddp trainer in this process (no process group) over
    the same global batches as a world of ``world`` x ``batch``."""
    cfg = port_config.Config()
    for k, v in {**TRAIN, "batch_size": batch}.items():
        setattr(cfg.train, k, v)
    rt = Runtime(device=torch.device("cpu"))
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **_model(variant)), device="cpu")
    loader = ShardedDataLoader(SyntheticLMDataset(**_dataset_kw(batch, 1)),
                               rt, batch_size=batch, seed=TRAIN["seed"])
    t = Trainer(cfg, rt, model, loader,
                params=from_jax_params(init, model.cfg, "cpu"))
    t.train()
    return *_rows(t.metrics.history), flatten(t.state["params"])


def _spawn(tmp, world: int, runs: list) -> dict:
    """Run ``runs`` in a spawned gloo world of ``world`` processes;
    process 0's results by run name."""
    out = str(tmp)
    inits = {}
    for variant in ("", *VARIANTS):
        inits[variant] = os.path.join(out, f"init{variant}.pt")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                    flatten(jax_init(variant)).items()}, inits[variant])
    job = {"world": world, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "init": inits, "model": MODEL, "variants": VARIANTS,
           "dataset": _dataset_kw(TRAIN["batch_size"], world),
           "train": {**TRAIN, "device": "cpu"}, "runs": runs}
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
    return {r["name"]: torch.load(os.path.join(out, r["name"] + ".pt"),
                                  weights_only=False) for r in runs}


def _runs(names: list) -> list:
    runs = []
    for name in names:
        mesh, over = CASES[name]
        # STEPS steps at the case's batch.
        runs.append({"name": name, "mesh": mesh,
                     "train": {**over, **PORT_ONLY.get(name, {})},
                     "variant": CASE_VARIANT.get(name, ""),
                     "dataset": _dataset_kw(_batch(name), _shards(mesh))})
    return runs


_WORLDS: dict = {}


def spawned(world: int, tmp_path_factory) -> dict:
    """Every run of a world of ``world`` processes (the JAX cases of that
    size, then the extra runs), spawned once per test process."""
    if world not in _WORLDS:
        names = [n for n, (mesh, _) in CASES.items() if _world(mesh) == world]
        extra = {2: EXTRA_RUNS, 4: EXTRA_RUNS_4}[world]
        _WORLDS[world] = _spawn(tmp_path_factory.mktemp(f"world{world}"),
                                world, _runs(names) + extra)
    return _WORLDS[world]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawned(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawned(4, tmp_path_factory)


def _check(got: tuple, want: tuple, what: str) -> None:
    (gl, gn, gp), (wl, wn, wp) = got, want
    assert len(gl) == len(wl) == STEPS and len(gn) == len(wn) == STEPS - 1
    np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(gn, wn, rtol=1e-5, err_msg=what)
    for k, v in gp.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(wp[k]), rtol=0,
                                   atol=1e-4, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_strategy_matches_jax_trainer(name, request):
    mesh = CASES[name][0]
    world = _world(mesh)
    variant = CASE_VARIANT.get(name, "")
    init = jax_init(variant)
    res = request.getfixturevalue(f"world{world}")[name]
    got = (*_rows(res["rows"]), {k: v.numpy()
                                 for k, v in res["params"].items()})
    _check(got, _jax_run(name, init), f"{name} vs JAX")
    if name != "fsdp_accum":
        one = _port_one_process(TRAIN["batch_size"] * _shards(mesh), init,
                                variant)
        _check(got, (*one[:2], {k: v.detach().numpy()
                                for k, v in one[2].items()}),
               f"{name} vs one process")


def _check_resume(res: dict, ref: dict, world: int) -> None:
    assert [r["step"] for r in res["rows_first"]] == [1, 2]
    assert res["resumed_at"] == 2
    assert [r["step"] for r in res["rows"]] == [3, 4, 5]
    assert _rows(res["rows_first"])[0] == _rows(ref["rows"])[0][:2]
    assert _rows(res["rows"])[0] == _rows(ref["rows"])[0][2:]
    for k, v in ref["params"].items():
        assert torch.equal(res["params"][k], v), k
    steps = sorted(int(d) for d in os.listdir(res["ckpt"]) if d.isdigit())
    assert steps == [2, 5]
    files = sorted(os.listdir(os.path.join(res["ckpt"], "2")))
    assert files == ["layout.json", "manifest.dtt.json", "meta.json"] + [
        f"state.rank{r}.pt" for r in range(world)]


def test_fsdp_save_on_preemption_resumes_to_the_same_trajectory(world2):
    """Process 0 alone asked to stop after step 2; both processes agreed,
    saved (sharded) and left; the resume reruns steps 3-5 as the
    uninterrupted run did, bit for bit on gloo."""
    _check_resume(world2["fsdp_resume"], world2["fsdp"], 2)


def test_tp_fsdp_save_on_preemption_resumes_to_the_same_trajectory(world4):
    """As under fsdp, with every large weight stored in (fsdp, tp) blocks
    over fsdp 2 x tp 2: the layout records both splits of a two-dim
    leaf, and the resume matches the uninterrupted run bit for bit."""
    res = world4["tp_fsdp_resume"]
    _check_resume(res, world4["tp_fsdp"], 4)
    with open(os.path.join(res["ckpt"], "2", "layout.json")) as f:
        layout = json.load(f)
    assert layout["mesh"]["tp"] == 2 and layout["mesh"]["fsdp"] == 2
    assert layout["params"]["attn/wq"] == [[1, ["fsdp"]], [2, ["tp"]]]
    assert layout["params"]["tok_embed"] == [[0, ["tp"]], [1, ["fsdp"]]]
    assert layout["params"]["ln1/scale"] is None


def test_gather_on_save_artifact_holds_the_whole_params(world2, tmp_path):
    """The consolidated artifact of the step-2 save equals the sharded
    params gathered whole, with every key and shape of the model; the
    offline export of the sharded checkpoint writes the same params."""
    _check_artifact(world2["fsdp_resume"], tmp_path)


def test_tp_fsdp_gather_on_save_artifact_holds_the_whole_params(world4,
                                                                tmp_path):
    """As under fsdp, from (fsdp, tp) blocks: the collective gather and
    the offline export each rebuild a leaf split on two dims."""
    _check_artifact(world4["tp_fsdp_resume"], tmp_path)


def _check_artifact(res: dict, tmp_path) -> None:
    art = res["artifact"]
    shapes = flatten(port_tf.param_shapes(port_tf.TransformerConfig(
        **MODEL)))
    assert {k: tuple(v.shape) for k, v in art["params"].items()} == shapes
    for k, v in res["saved_params"].items():
        assert torch.equal(art["params"][k], v), k
    assert art["meta"]["step"] == 2 and art["meta"]["epoch"] == 0
    out = str(tmp_path / "exported.pt")
    info = port_export.export(res["ckpt"], out, step=2)
    assert info["step"] == 2
    state, meta = load_consolidated(out)
    assert meta["step"] == 2 and meta["data"]["step_in_epoch"] == 2
    for k, v in flatten(state["params"]).items():
        assert torch.equal(v, art["params"][k]), k
    qout = str(tmp_path / "exported_int8.pt")
    info = port_export.export(res["ckpt"], qout, step=2, quantize="int8")
    assert info["quantization"] == "int8"
    qstate, qmeta = load_consolidated(qout)
    assert qmeta["quantization"] == "int8" and qmeta["step"] == 2
    want = quantize_params_int8(state["params"])
    for grp, name in _QUANT_AXES:
        for part in ("qw", "scale"):
            assert torch.equal(qstate["params"][grp][name][part],
                               want[grp][name][part]), (grp, name, part)
    with pytest.raises(PlanError, match="some_plan"):
        port_export.export(res["ckpt"], out, plan="some_plan")


def test_divergence_check_reads_zero_then_the_planted_drift(world2):
    """ddp replicas fingerprint alike until process 1 perturbs one weight
    of its replica after step 3."""
    _check_drift(world2["ddp_drift"]["rows"])


def test_tp_divergence_check_reads_zero_then_the_planted_drift(world2):
    """As under ddp, across tp: a layer norm that ``tp`` leaves whole,
    perturbed on process 1 after step 3."""
    _check_drift(world2["tp_drift"]["rows"])


def _check_drift(rows: list) -> None:
    drift = [r["replica_divergence"] for r in rows]
    assert drift[:2] == [0, 0] and all(d > 0 for d in drift[2:]), drift


def test_tp_replicas_stay_alike(world4):
    """At tp 4 the layer norms, ``bo`` and the kv weights (2 kv heads,
    which tp 4 does not divide: each rank projects only the kv head its
    query head reads, and the partial gradients are summed over tp) are
    replicated over tp; their replicas stay bitwise alike every step."""
    rows = world4["tp4_gqa"]["rows"]
    assert [r["replica_divergence"] for r in rows] == [0] * STEPS


@pytest.mark.parametrize("name", ["tp", "tp_fsdp"])
def test_tp_all_reduces_per_step(name, request):
    """The tensor-parallel collectives a step launches, against the
    design's count: per layer two ``reduce_from_tp`` in the forward (the
    attention's and the MLP's row-parallel products) and two
    ``copy_to_tp`` in the backward (the q/k/v and the MLP inputs'
    gradients), one more of each for the embedding lookup and the head's
    input, and two in the cross-entropy per chunk (one chunk here)."""
    world = _world(CASES[name][0])
    got = request.getfixturevalue(f"world{world}")[name]["all_reduces"]
    L = MODEL["n_layers"]
    assert got == {"reduce_from_tp": (2 * L + 1) * STEPS,
                   "copy_to_tp": (2 * L + 1) * STEPS, "xent": 2 * STEPS}


def test_offload_opt_state_keeps_the_trajectory(world2):
    got, ref = world2["fsdp_offload"], world2["fsdp"]
    assert _rows(got["rows"]) == _rows(ref["rows"])
    for k, v in ref["params"].items():
        assert torch.equal(got["params"][k], v), k


def test_fsdp_in_a_group_of_one_equals_ddp_bitwise(tmp_path):
    """bfloat16, 4 steps through the CLI: ``fsdp`` in a gloo group of one
    process (its per-layer gathers and reduce-scatters are copies, its
    gradient norm sums per-leaf sums in leaf order over an all-reduce of
    one) gives ``ddp`` with no group's losses and gradient norms bit for
    bit."""
    tiny = ["train.device=cpu", "model=gpt2_125m", "train=gpt2",
            "+model.n_layers=2", "+model.d_model=64", "+model.n_heads=4",
            "+model.vocab_size=512", "+model.max_seq_len=128",
            "train.dataset_kwargs.seq_len=128",
            "train.dataset_kwargs.vocab_size=512", "train.dataset_size=16",
            "train.batch_size=4", "train.total_epochs=1", "train.log_every=1",
            "train.save_every=0", "run.log_level=WARNING"]

    def rows(out):
        with open(os.path.join(out, "default", "metrics.jsonl")) as f:
            return [(r["step"], r["loss"], r.get("grad_norm"))
                    for r in map(json.loads, f) if "loss" in r]

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        assert port_cli.main(tiny + ["train.parallel_strategy=fsdp",
                                f"run.output_dir={tmp_path}/fsdp"]) == 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert port_cli.main(tiny + [f"run.output_dir={tmp_path}/ddp"]) == 0
    got, want = rows(f"{tmp_path}/fsdp"), rows(f"{tmp_path}/ddp")
    assert len(want) == 4 and got == want

# -- layout, without a world -------------------------------------------------

PRESETS = sorted(port_tf.PRESETS)


@pytest.mark.parametrize("preset", PRESETS)
def test_logical_axes_match_jax(preset):
    want = jax_tf.Transformer(jax_tf.TransformerConfig(
        **jax_tf.PRESETS[preset])).logical_axes()
    got = port_tf.Transformer(port_tf.TransformerConfig(
        **port_tf.PRESETS[preset]), device="cpu").logical_axes()
    assert got == want


@pytest.mark.parametrize("strategy", ["ddp", "zero1", "fsdp", "hybrid"])
@pytest.mark.parametrize("fsdp", [1, 2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_specs_match_jax(preset, fsdp, strategy):
    dp = 2 if strategy in ("hybrid", "zero1") else 1
    _check_specs(preset, strategy, dict(dp=dp, fsdp=fsdp))


@pytest.mark.parametrize("strategy", ["tp", "tp_fsdp"])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("fsdp", [1, 2])
@pytest.mark.parametrize("preset", PRESETS)
def test_tp_specs_match_jax(preset, fsdp, tp, strategy):
    """Every leaf's spec under tensor parallelism, two-dim ones included
    (the placement takes them), and the leaves the tp block would use
    only in part: those with a dim the rules route to tp that the JAX
    spec leaves whole (the kv weights where tp does not divide the kv
    heads; the model refuses a split of the query heads, the MLP or the
    vocab that tp does not divide)."""
    layout = _check_specs(preset, strategy, dict(fsdp=fsdp, tp=tp))
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **port_tf.PRESETS[preset]), device="cpu")
    spec_of = jax_strategy.get_strategy(
        strategy, jax_runtime.MeshSpec(fsdp=fsdp, tp=tp)).param_spec
    logical = flatten(model.logical_axes())
    want = tuple(k for k, s in flatten(model.param_shapes()).items()
                 if {"heads", "kv", "mlp", "vocab"} & set(logical[k])
                 and "tp" not in str(spec_of(s, logical[k])))
    assert layout["tp_partial"] == want
    if preset == "transformer_7b":  # 8 kv heads: split at tp 2, 4, 8
        assert want == ()


def _check_specs(preset: str, strategy: str, mesh: dict) -> dict:
    cfg = port_tf.TransformerConfig(**port_tf.PRESETS[preset])
    model = port_tf.Transformer(cfg, device="cpu")
    shapes = flatten(model.param_shapes())
    logical = flatten(model.logical_axes())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_strategy.get_strategy(strategy,
                                         jax_runtime.MeshSpec(**mesh))
        got = port_strategy.get_strategy(strategy, PortMeshSpec(**mesh))
    layout = port_strategy.layout(got, shapes, logical)
    for k, s in shapes.items():
        for kind, fn in (("params", "param_spec"), ("opt", "opt_spec")):
            spec = getattr(got, fn)(s, logical[k])
            assert spec == tuple(getattr(want, fn)(s, logical[k])), (k, fn)
            assert layout[kind][k] == port_strategy.placement(spec)
    return layout


@pytest.mark.parametrize("mesh,n", [
    (dict(dp=0), 1), (dict(dp=-1, fsdp=-1), 4), (dict(dp=-1, fsdp=3), 4),
    (dict(dp=2, fsdp=2), 2), (dict(dp=1, fsdp=-1), 4)],
    ids=["zero-axis", "two-wildcards", "indivisible", "too-few", "fills"])
def test_mesh_spec_resolve_matches_jax(mesh, n):
    full = {**{a: 1 for a in ("pp", "dp", "fsdp", "sp", "tp")}, **mesh}
    jcfg, pcfg = jax_config.MeshConfig(**full), port_config.MeshConfig(**full)
    try:
        want = jax_runtime.MeshSpec.resolve(jcfg, n).as_dict()
    except jax_runtime.RuntimeError_ as e:
        with pytest.raises(MeshSpecError) as got:
            PortMeshSpec.resolve(pcfg, n)
        assert str(got.value) == str(e)
    else:
        assert PortMeshSpec.resolve(pcfg, n).as_dict() == want


def test_placement_and_refusals():
    """One split per sharded dim: a data split, a tp split, or both (one
    of each, as ``tp_fsdp`` lays weights out); ``tp`` and ``tp_fsdp``
    build the tensor-parallel strategy with the mesh's sizes."""
    P = port_strategy.Placement
    assert port_strategy.placement(()) is None
    assert port_strategy.placement((None, "fsdp")) == P(((1, ("fsdp",)),))
    assert port_strategy.placement((("dp", "fsdp"),)) == P(
        ((0, ("dp", "fsdp")),))
    two = port_strategy.placement((None, "fsdp", "tp"))
    assert two == P(((1, ("fsdp",)), (2, ("tp",))))
    assert two.axes == ("fsdp", "tp")
    assert port_strategy.placement(("tp", "fsdp")) == P(
        ((0, ("tp",)), (1, ("fsdp",))))
    for spec in (("fsdp", "tp", "dp"), (("fsdp", "tp"),), ("fsdp", "dp")):
        with pytest.raises(ValueError, match="at most one dim over tp"):
            port_strategy.placement(spec)
    for name in ("tp", "tp_fsdp"):
        got = port_strategy.get_strategy(name, PortMeshSpec(fsdp=2, tp=4))
        assert isinstance(got, port_strategy.TensorParallel)
        assert (got.name, got.fsdp_size, got.tp_size) == ("tp", 2, 4)
        assert got.rules["heads"] == got.rules["vocab"] == "tp"
    with pytest.raises(ValueError, match="unknown parallel_strategy"):
        port_strategy.get_strategy("pipeline")
    with pytest.warns(UserWarning, match="data_size<=1"):
        port_strategy.get_strategy("zero1", PortMeshSpec())
    # A world of 2 without its process group cannot train.
    cfg = port_config.Config()
    cfg.train.device = "cpu"
    rt = Runtime(device=torch.device("cpu"), process_count=2)
    model = port_tf.Transformer(port_tf.TransformerConfig(**MODEL),
                                device="cpu")
    loader = ShardedDataLoader(SyntheticLMDataset(**_dataset_kw(2, 1)),
                               Runtime(device=torch.device("cpu")),
                               batch_size=2)
    with pytest.raises(RuntimeError, match="without a process group"):
        Trainer(cfg, rt, model, loader)


@pytest.mark.parametrize("shape", [(7,), (33, 65), (4, 300, 300)])
def test_fingerprint_matches_jax(shape):
    """The port's fingerprint is the JAX one, int32 wrap-around included
    (the largest case wraps)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = int(jax_diag._fingerprint(jnp.asarray(x)))
    assert diagnostics.fingerprint(torch.from_numpy(x)) == want

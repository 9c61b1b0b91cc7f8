"""The port's ResNet (``models/resnet.py``) held against the JAX
package's, on the CPU in float32 (and bfloat16 for GroupNorm).

Inputs are made from a seed with numpy; whole models carry JAX's
weights across through ``resnet_from_jax_params``. Tolerances:

- ``_conv``: XLA's SAME padding at strides 1 and 2, even and odd sizes,
  3x3 and 1x1, within 1e-5 of the largest output (a conv padded
  ``(1, 1)`` where XLA pads ``(0, 1)`` is off by far more);
- ``_group_norm`` at C 64, 48 and 8 (48 takes 24 groups, not
  ``min(32, C)``): 1e-5 at f32, one bf16 rounding (2^-7 relative) at
  bf16; an f64 input keeps f64 (the numpy formula to 1e-12);
- ResNet-18 at full width: logits of 2 images within 1e-5 of the
  largest, and JAX's 11,172,170 parameters;
- a narrow model (width 8, one block a stage, 16x16): the loss within
  1e-5 relative, the accuracy equal, every leaf's gradient within 1e-5
  of the leaf's largest;
- ``flops_per_sample`` equal to JAX's;
- 5 trainer steps (AdamW, grad accumulation 2) against JAX's trainer:
  the limits of ``tests/test_torch_resnet_world.py``, whose JAX run this
  shares.

Then the CLI on the CPU: ``model=resnet18`` on ``synthetic_images``
trains, saves, resumes, exports consolidated, and ``eval.py --run-dir``
scores it.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch import eval as port_eval
from distributed_training_tpu_torch.checkpoint import export
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticImageDataset
from distributed_training_tpu_torch.models import resnet as port_resnet
from distributed_training_tpu_torch.models.base import count_params
from distributed_training_tpu_torch.models.convert import resnet_from_jax_params
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.runtime import NoCudaDeviceError, Runtime
from distributed_training_tpu_torch.train import cli
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten
from distributed_training_tpu_torch.train.trainer import Trainer

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models import resnet as jax_resnet  # noqa: E402
from distributed_training_tpu.models.base import count_params as jax_count  # noqa: E402

from test_torch_resnet_world import (  # noqa: E402
    BATCH,
    DATASET,
    LIMITS,
    MODEL,
    PARAMS_ATOL,
    TRAIN,
    jax_init,
    jax_reference,
    port_flat,
    rel_diffs,
)

TOL = 1e-5
RESNET18_PARAMS = 11_172_170


def _normal(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the helpers ---------------------------------------------------------------


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_conv_same_padding_matches_jax(size, k, stride):
    x, w = _normal((2, size, size, 5), size), _normal((k, k, 5, 6), k)
    want = np.asarray(jax_resnet._conv(jnp.asarray(x), jnp.asarray(w),
                                       stride))
    got = port_resnet._conv(torch.from_numpy(x), torch.from_numpy(w),
                            stride).numpy()
    assert got.shape == want.shape
    assert _max_rel(got, want) <= TOL
    if (k, stride, size % 2) == (3, 2, 0):
        # XLA pads (0, 1) here: a symmetric (1, 1) samples a shifted grid.
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                       padding=1).permute(0, 2, 3, 1).numpy()
        assert sym.shape == want.shape and _max_rel(sym, want) > 0.1


@pytest.mark.parametrize("C", [64, 48, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(C, dtype):
    x = _normal((2, 4, 4, C), C) * 3.0 + 1.0
    scale, bias = _normal((C,), C + 1), _normal((C,), C + 2)
    want = jax_resnet._group_norm(jnp.asarray(x).astype(dtype),
                                  jnp.asarray(scale), jnp.asarray(bias))
    got = port_resnet._group_norm(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_group_norm_keeps_float64_for_a_reference_run():
    """An f64 input (the card's f64 reference model) keeps f64
    statistics, the numpy formula to 1e-12."""
    x = _normal((2, 4, 4, 48), 5).astype(np.float64) * 3.0 + 1.0
    scale, bias = _normal((48,), 6), _normal((48,), 7)
    got = port_resnet._group_norm(torch.from_numpy(x),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(bias))
    xg = x.reshape(2, 4, 4, 24, 2)
    want = ((xg - xg.mean(axis=(1, 2, 4), keepdims=True))
            / np.sqrt(xg.var(axis=(1, 2, 4), keepdims=True) + 1e-5))
    want = want.reshape(x.shape) * scale + bias
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# -- the model -----------------------------------------------------------------


def test_full_width_logits_and_count_match_jax():
    jm = jax_resnet.ResNet()
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model("resnet18", device="cpu")
    params = resnet_from_jax_params(jax.tree.map(np.asarray, jp), pm, "cpu")
    assert count_params(params) == jax_count(jp) == RESNET18_PARAMS
    assert count_params(pm.init(0)) == RESNET18_PARAMS
    x = _normal((2, 32, 32, 3), 1)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = pm.apply(params, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    assert _max_rel(got, want) <= TOL
    assert port_resnet.LAYOUTS["channels_last"] > 0


def test_narrow_loss_accuracy_and_every_gradient_match_jax():
    jm, jp = jax_resnet.ResNet(**MODEL), jax_init()
    x = _normal((4, 16, 16, 3), 2)
    y = np.random.default_rng(3).integers(0, 10, (4,)).astype(np.int32)
    (jloss, jm_metrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                          jax.random.PRNGKey(0)), has_aux=True))(jp)
    jgrads = port_flat(jgrads)
    pm = port_resnet.ResNet(**MODEL, device="cpu")
    params = resnet_from_jax_params(jax.tree.map(np.asarray, jp), pm, "cpu")
    flat = flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    loss, metrics = pm.loss(params, {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y)})
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    assert float(metrics["accuracy"]) == float(jm_metrics["accuracy"])
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert _max_rel(g.numpy(), jgrads[k]) <= TOL, k


@pytest.mark.parametrize("kw", [{}, MODEL,
                                dict(width=32, stage_sizes=[3, 4, 6, 3])])
def test_flops_per_sample_equals_jax(kw):
    got = port_resnet.ResNet(**kw, device="cpu").flops_per_sample()
    assert got == jax_resnet.ResNet(**kw).flops_per_sample()
    if not kw:
        assert got == 3_294_756_864


@pytest.mark.parametrize("fault", ["key", "shape"])
def test_converter_rejects_a_wrong_key_or_shape(fault):
    model = port_resnet.ResNet(**MODEL, device="cpu")
    tree = jax.tree.map(np.asarray, jax_init())
    assert set(resnet_from_jax_params(tree, model, "cpu")["stage1"]) == {"0"}
    if fault == "key":
        tree["stage1"][0]["conv3"] = tree["stage1"][0].pop("conv2")
        match = "stage1/0"
    else:
        tree["stage2"][0]["proj"] = tree["stage2"][0]["proj"][:, :, :3]
        match = "stage2/0/proj"
    with pytest.raises(ValueError, match=match):
        resnet_from_jax_params(tree, model, "cpu")


def test_build_model_takes_the_card_unless_told():
    """``build_model("resnet18")`` is on the card by default (raises
    without one) and on the CPU when asked."""
    if torch.cuda.is_available():
        assert build_model("resnet18").device.type == "cuda"
    else:
        with pytest.raises(NoCudaDeviceError):
            build_model("resnet18")
    assert build_model("resnet", device="cpu").device.type == "cpu"


# -- training --------------------------------------------------------------------


def test_trainer_matches_jax_trainer(tmp_path_factory):
    """5 steps of one process under AdamW with 2 grad-accum microbatches
    against JAX's trainer: losses, gradient norms and accuracies (the
    microbatches' mean) within LIMITS, final params within PARAMS_ATOL."""
    want = jax_reference(tmp_path_factory)
    cfg = port_config.Config()
    for k, v in {**TRAIN, "batch_size": BATCH}.items():
        setattr(cfg.train, k, v)
    rt = Runtime(device=torch.device("cpu"))
    loader = ShardedDataLoader(SyntheticImageDataset(**DATASET), rt,
                               batch_size=BATCH, seed=TRAIN["seed"],
                               shuffle=False)
    init = {k: torch.from_numpy(v.copy())
            for k, v in port_flat(jax_init()).items()}
    trainer = Trainer(cfg, rt, port_resnet.ResNet(**MODEL, device="cpu"),
                      loader, params=unflatten(init))
    rows, step = [], trainer.train_step

    def record(batch):
        m = step(batch)
        rows.append({k: float(v) for k, v in m.items()})
        return m
    trainer.train_step = record
    trainer.train()
    diffs = rel_diffs(rows, want)
    assert all(diffs[k] <= LIMITS[k] for k in LIMITS), diffs
    for k, v in flatten(trainer.state["params"]).items():
        np.testing.assert_allclose(v.detach().numpy(), want["params"][k],
                                   rtol=0, atol=PARAMS_ATOL, err_msg=k)


def _cli(out: str, epochs: int) -> None:
    assert cli.main([
        "train.device=cpu", "model=resnet18", "+model.width=8",
        "+model.stage_sizes=[1,1,1,1]", "train.dataset=synthetic_images",
        "train.dataset_kwargs.height=16", "train.dataset_kwargs.width=16",
        "train.dataset_size=16", "train.batch_size=4",
        "train.optimizer=adamw", "train.dtype=float32", "train.log_every=1",
        "train.save_every=1", f"train.total_epochs={epochs}",
        f"train.snapshot_path={out}/ckpt", f"run.output_dir={out}"]) == 0


def test_cli_trains_resumes_exports_and_eval_scores(tmp_path, capsys):
    out = str(tmp_path)
    run_dir = os.path.join(out, "default")
    _cli(out, 1)
    _cli(out, 2)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if "loss" in r]
    assert steps == list(range(1, 9)), steps
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        resumes = [e for e in map(json.loads, f) if e["kind"] == "resume"]
    assert resumes and resumes[-1]["step"] == 4, resumes
    capsys.readouterr()
    assert port_eval.main(["--run-dir", run_dir, "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(rec["loss"]) and rec["step"] == 8
    # JAX's count: the elements of the first batch key, x (4x16x16x3).
    assert rec["tokens"] == rec["batches"] * 4 * 16 * 16 * 3
    art = os.path.join(out, "resnet.pt")
    assert export.main(["--ckpt", f"{out}/ckpt", "--out", art]) == 0
    state = torch.load(art, weights_only=False)["state"]
    assert state["step"] == 8
    shapes = flatten(port_resnet.ResNet(**MODEL, device="cpu").param_shapes())
    assert {k: tuple(v.shape) for k, v in flatten(state["params"]).items()
            } == shapes

"""The port's optimizer chain held against optax, step for step.

The same params, gradients and TrainConfig through the JAX package's
``build_optimizer`` (optax) and the port's, for several steps: sgd,
adamw under both decay masks, warmup + cosine, global-norm clipping (on
and off). float32; tolerance 1e-6 relative plus 1e-7 absolute (op order
in the update; the schedules are evaluated in f32 on both sides).
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.config import TrainConfig as PortTrainConfig
from distributed_training_tpu_torch.train import optimizer as port_opt

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distributed_training_tpu.config import TrainConfig  # noqa: E402
from distributed_training_tpu.train import optimizer as jax_opt  # noqa: E402

SHAPES = {"attn": {"wq": (2, 8, 2, 4)}, "ln1": {"scale": (2, 8),
                                                "bias": (2, 8)},
          "mlp": {"wi": (2, 8, 16), "bi": (2, 16)}, "tok_embed": (32, 8)}


def _tree(rng, shapes, scale):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}


CASES = {
    "sgd-constant": dict(optimizer="sgd", learning_rate=0.1),
    "adamw-all-warmup-cosine-clip": dict(
        optimizer="adamw", learning_rate=3e-3, weight_decay=0.1,
        warmup_steps=2, lr_schedule="cosine", grad_clip_norm=1.0),
    "adamw-matrices-cosine": dict(
        optimizer="adamw", learning_rate=1e-2, weight_decay=0.1,
        decay_mask="matrices", lr_schedule="cosine", b2=0.99),
    "sgd-warmup-clip": dict(optimizer="sgd", learning_rate=0.5,
                            warmup_steps=3, grad_clip_norm=0.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_optax(name):
    steps = 7
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES, 1.0)
    # Gradients of mixed size, so clipping triggers on some steps only.
    grads = [_tree(rng, SHAPES, 0.05 * (1 + 3 * (i % 3)))
             for i in range(steps)]
    jcfg, pcfg = TrainConfig(**CASES[name]), PortTrainConfig(**CASES[name])

    jo = jax_opt.build_optimizer(jcfg, total_steps=steps)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    po = port_opt.build_optimizer(pcfg, total_steps=steps)
    pp = {k: torch.from_numpy(v.copy())
          for k, v in port_opt.flatten(params).items()}
    ps = po.init(pp)
    for i in range(steps):
        upd, js = jo.update(jax.tree.map(jnp.asarray, grads[i]), js, jp)
        jp = optax.apply_updates(jp, upd)
        g = {k: torch.from_numpy(v) for k, v in
             port_opt.flatten(grads[i]).items()}
        pupd, ps = po.update(g, ps, pp)
        pp = {k: pp[k] + pupd[k] for k in pp}
        for k, v in port_opt.flatten(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(pp[k].numpy(), v, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {i}")
    assert ps["count"] == steps


def test_schedule_matches_optax():
    """lr 0 on the very first update, the cosine offset by the warmup,
    the alpha=0.1 floor at the end."""
    cfg = dict(learning_rate=6e-4, warmup_steps=10, lr_schedule="cosine")
    want = jax_opt.build_schedule(TrainConfig(**cfg), total_steps=50)
    got = port_opt.build_schedule(PortTrainConfig(**cfg), total_steps=50)
    counts = list(range(0, 60, 3)) + [9, 10, 11, 50]
    np.testing.assert_allclose([float(got(c)) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=1e-6, atol=0)
    assert float(got(0)) == 0.0
    assert abs(float(got(59)) - 6e-5) < 1e-10


def test_matrices_mask_is_name_aware():
    flat = {k: torch.from_numpy(v) for k, v in
            port_opt.flatten(_tree(np.random.default_rng(1), SHAPES,
                                   1.0)).items()}
    mask = port_opt._matrices_mask(flat)
    assert mask == {"attn/wq": True, "ln1/bias": False, "ln1/scale": False,
                    "mlp/bi": False, "mlp/wi": True, "tok_embed": True}


def test_unported_optimizer_raises():
    # Every optimizer of the JAX package builds; a name it does not know
    # raises, as the JAX build_optimizer does.
    assert port_opt.build_optimizer(PortTrainConfig(optimizer="adafactor"),
                                    10).kind == "adafactor"
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_opt.build_optimizer(PortTrainConfig(optimizer="lamb"), 10)
    with pytest.raises(ValueError, match="decay_mask"):
        port_opt.build_optimizer(PortTrainConfig(decay_mask="odd"), 10)

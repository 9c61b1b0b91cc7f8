"""The port's Adafactor held against ``optax.adafactor`` through the JAX
package's ``build_optimizer``.

Whole: 10 updates of a tree with factored 2-D leaves ((256, 128), (160,
300)), stacked 3-D leaves ((2, 128, 256) and (2, 256, 128), factored with
the layer axis kept), leaves under 128 on a dim ((2, 64), (32, 128),
(100, 300), (2, 128, 2, 64), (256,)), under a warmup-cosine schedule, weight decay under both masks
(``all``, ``matrices``) and with and without ``grad_clip_norm``, float32:
every update of every leaf within 1e-5 of the largest update optax gives
that leaf, and at the end the params and the moments within 1e-5
relative.

Sharded: a tiny decoder (d 128, d_ff 256, vocab 256, so its embedding
and MLP leaves factor) under ``fsdp`` (fsdp 2) and ``zero1`` (dp 2) in
the spawned gloo world of ``tests/test_torch_mlp.py``, against the JAX
trainer on 2 fake CPU devices of the same mesh: losses and gradient
norms within 1e-5 relative, params within 1e-5; the fsdp run's sharded
checkpoint, consolidated offline, holds the JAX trainer's factored
moments.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import export as port_export
from distributed_training_tpu_torch.train import optimizer as port_opt

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu.train import optimizer as jax_opt  # noqa: E402

from test_torch_mlp import check_rows, jax_run, spawned  # noqa: E402

SHAPES = {"attn/wq": (2, 128, 2, 64), "emb/tok": (256, 128),
          "mlp/wi": (2, 128, 256), "mlp/wo": (2, 256, 128),
          "mlp/bi": (2, 64), "pos/embed": (32, 128), "x/wide": (160, 300),
          "x/narrow": (100, 300), "ln/scale": (256,)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        a, b = k.split("/")
        out.setdefault(a, {})[b] = v
    return out


def _jax_moments(state) -> dict:
    """{"v_row"/"v_col"/"v": {path: array}} of the FactoredState inside an
    optax adafactor chain's state. optax keeps a (1,) placeholder where a
    leaf has no such moment (no leaf here is (1,) itself)."""
    fs = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: hasattr(s, "v_row")) if hasattr(s, "v_row"))
    return {name: {k: v for k, v in port_opt.flatten(jax.tree.map(
        np.asarray, getattr(fs, name))).items() if v.shape != (1,)}
        for name in ("v_row", "v_col", "v")}


@pytest.mark.parametrize("decay_mask", ["all", "matrices"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_adafactor_matches_optax(decay_mask, clip):
    over = dict(optimizer="adafactor", learning_rate=1e-2, warmup_steps=2,
                lr_schedule="cosine", weight_decay=0.1,
                decay_mask=decay_mask, grad_clip_norm=clip)
    jcfg, pcfg = jax_config.TrainConfig(), port_config.TrainConfig()
    for k, v in over.items():
        setattr(jcfg, k, v)
        setattr(pcfg, k, v)
    jtx = jax_opt.build_optimizer(jcfg, 10)
    jupdate = jax.jit(jtx.update)
    ptx = port_opt.build_optimizer(pcfg, 10)
    rng = np.random.default_rng(0)
    start = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
             for k, s in SHAPES.items()}
    jp = _nest({k: jnp.asarray(v) for k, v in start.items()})
    js = jtx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    ps = ptx.init(pp)
    assert set(ps["v_row"]) == {"emb/tok", "mlp/wi", "mlp/wo", "x/wide"}
    assert ps["v_row"]["mlp/wo"].shape == (2, 128)   # d0 = 1 (256)
    assert ps["v_col"]["mlp/wo"].shape == (2, 256)
    for _ in range(10):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        gn = port_opt.global_norm([torch.from_numpy(v) for v in g.values()])
        ju, js = jupdate(_nest({k: jnp.asarray(v) for k, v in g.items()}),
                            js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ps, pp, gnorm=gn)
        pp = {k: pp[k] + pu[k] for k in pp}
        want = port_opt.flatten(jax.tree.map(np.asarray, ju))
        for k, u in pu.items():
            err = np.abs(u.numpy() - want[k]).max()
            assert err <= 1e-5 * np.abs(want[k]).max(), (k, err)
    want = port_opt.flatten(jax.tree.map(np.asarray, jp))
    for k, v in pp.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    moments = _jax_moments(js)
    for name in ("v_row", "v_col", "v"):
        assert set(ps[name]) == set(moments[name])
        for k, v in ps[name].items():
            np.testing.assert_allclose(v.numpy(), moments[name][k],
                                       rtol=1e-5, err_msg=f"{name} {k}")


def test_factored_placements():
    from distributed_training_tpu_torch.parallel.strategy import Placement

    shapes = {"a": (2, 128, 256), "b": (256, 128), "c": (2, 64)}
    pls = {"a": Placement(((1, ("fsdp",)),)),
           "b": Placement(((0, ("fsdp",)),)), "c": None}
    got = port_opt.factored_placements(shapes, pls)
    # a: d1 = 1, d0 = 2. v_row drops d0 and keeps the split; v_col
    # averaged over the split dim and is whole.
    assert got["v_row"] == {"a": Placement(((1, ("fsdp",)),)), "b": None}
    assert got["v_col"] == {"a": None, "b": Placement(((0, ("fsdp",)),))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawned(tmp_path_factory)


@pytest.mark.parametrize("name", ["ada_fsdp", "ada_zero1"])
def test_adafactor_sharded_matches_jax_trainer(name, world):
    want = jax_run(name)
    check_rows(world[name], want, name, atol=1e-5)
    if name != "ada_fsdp":
        return
    # The sharded checkpoint, consolidated: params and every moment.
    state, step = port_export.restore_step_local(world[name]["ckpt"])
    assert step == 5
    moments = _jax_moments(want["opt_state"])
    for nm in ("v_row", "v_col", "v"):
        assert set(state["opt_state"][nm]) == set(moments[nm])
        for k, v in state["opt_state"][nm].items():
            np.testing.assert_allclose(v.numpy(), moments[nm][k], rtol=1e-4,
                                       atol=1e-10, err_msg=f"{nm} {k}")


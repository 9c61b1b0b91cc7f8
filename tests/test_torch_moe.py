"""The port's MoE (``models/transformer.py``'s ``_moe_*`` helpers and the
MoE transformer) held against the JAX package's, on the CPU in float32.

The inputs are made from a seed with numpy; whole models carry JAX's
weights across through ``from_jax_params``. Every behaviour of JAX's
``tests/test_moe.py``: the routing group pads up; ragged sequences,
routed against dense; routed equal to dense at ample capacity (k 1 and
2, values and gradients); capacity drops at JAX's token positions; the
routed FLOPs (``torch.utils.flop_counter.FlopCounterMode``) do not grow
with E, the dense ones do; ``_topk_by_argmax``'s values, indices and
gradient, ties included; a routed model trains. Then the model: loss,
``moe_aux`` and every gradient leaf of a 2-layer MoE transformer under
each ``moe_impl`` within 1e-5 of JAX's; remat ``mlp`` and ``mlp_pre``
give the no-remat gradients and save nothing F-wide (as JAX's
``test_remat_mlp_policy_covers_moe``); ``flops_per_token`` and greedy
``generate`` tokens equal JAX's; the ``moe_transformer`` preset is
JAX's. Last, one spawned gloo world of 2 (below) holds every
composition against JAX's trainer, with planted faults that must fail.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.parallel import expert
from distributed_training_tpu_torch.runtime import Runtime
from distributed_training_tpu_torch.train.optimizer import flatten
from distributed_training_tpu_torch.train.trainer import Trainer
from torch.utils.flop_counter import FlopCounterMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
             max_seq_len=32, dtype="float32", param_dtype="float32",
             attention_impl="naive", moe_num_experts=4, moe_top_k=2,
             moe_group_size=8)


def _cfg(side, **kw):
    base = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4,
                max_seq_len=16, dtype="float32", param_dtype="float32",
                moe_num_experts=4, moe_top_k=2)
    base.update(kw)
    return side.TransformerConfig(**base)


def _mlp_params(E=4, D=32, F=128, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((D, E)).astype(np.float32),
            "wi": (rng.standard_normal((E, D, F)) * 0.05).astype(np.float32),
            "wo": (rng.standard_normal((E, F, D)) * 0.05).astype(np.float32)}


def _h(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_mlp(fn, h, mlp, c, grads=False):
    """(out, aux[, grads by leaf]) of a port helper on numpy inputs."""
    m = {k: torch.from_numpy(v).requires_grad_(grads) for k, v in mlp.items()}
    out, aux = fn(torch.from_numpy(h), m, c)
    if not grads:
        return out.detach().numpy(), float(aux.detach())
    g = torch.autograd.grad(out.sum(), list(m.values()))
    return (out.detach().numpy(), float(aux.detach()),
            {k: v.numpy() for k, v in zip(m, g)})


def _jax_mlp(fn, h, mlp, c, grads=False):
    m = {k: jnp.asarray(v) for k, v in mlp.items()}
    out, aux = fn(jnp.asarray(h), m, c)
    if not grads:
        return np.asarray(out), float(aux)
    g = jax.grad(lambda p: jnp.sum(fn(jnp.asarray(h), p, c)[0]))(m)
    return np.asarray(out), float(aux), {k: np.asarray(v)
                                         for k, v in g.items()}


# -- the helpers ---------------------------------------------------------------


@pytest.mark.parametrize("S,cap", [(1024, 1024), (2048, 1024), (992, 1024),
                                   (992, 500), (7, 4), (2 * 1031, 1024),
                                   (1, 1024)])
def test_group_size_pads_up_as_jax(S, cap):
    assert port_tf._moe_group_size(S, cap) == jax_tf._moe_group_size(S, cap)


def test_routed_ragged_tokens_match_dense():
    """T=13 in groups of 5 pads to 15: pad positions claim no capacity,
    and routed equals dense and JAX's routed."""
    kw = dict(moe_top_k=2, moe_capacity_factor=4.0, moe_group_size=5)
    mlp, h = _mlp_params(), _h((1, 13, 32), 4)
    out_r, aux_r = _port_mlp(port_tf._moe_mlp_routed, h, mlp,
                             _cfg(port_tf, **kw))
    out_d, aux_d = _port_mlp(port_tf._moe_mlp_dense, h, mlp,
                             _cfg(port_tf, **kw))
    np.testing.assert_allclose(out_r, out_d, **TOL)
    np.testing.assert_allclose(aux_r, aux_d, rtol=1e-5, atol=0)
    jout, jaux = _jax_mlp(jax_tf._moe_mlp_routed, h, mlp, _cfg(jax_tf, **kw))
    np.testing.assert_allclose(out_r, jout, **TOL)
    np.testing.assert_allclose(aux_r, jaux, **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routed_matches_dense_at_ample_capacity(top_k):
    """C = k·g: nothing drops, so routed equals dense (values and
    gradients), and both equal JAX's."""
    kw = dict(moe_top_k=top_k, moe_capacity_factor=4.0, moe_group_size=32)
    mlp, h = _mlp_params(), _h((2, 8, 32), 1)
    got = {name: _port_mlp(getattr(port_tf, f"_moe_mlp_{name}"), h, mlp,
                           _cfg(port_tf, **kw), grads=True)
           for name in ("routed", "dense")}
    want = _jax_mlp(jax_tf._moe_mlp_dense, h, mlp, _cfg(jax_tf, **kw),
                    grads=True)
    for name in ("routed", "dense"):
        out, aux, g = got[name]
        np.testing.assert_allclose(out, want[0], **TOL)
        np.testing.assert_allclose(aux, want[1], rtol=1e-6, atol=0)
        for key in ("router", "wi", "wo"):
            np.testing.assert_allclose(g[key], want[2][key], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {key}")


@pytest.mark.parametrize("top_k,cf,gs", [(1, 1e-6, 16), (2, 0.5, 16),
                                         (2, 1.0, 8), (1, 0.75, 5)])
def test_capacity_drops_at_the_tokens_jax_drops(top_k, cf, gs):
    """At a capacity that overflows, the port drops the (token, slot)
    pairs JAX drops: equal outputs (zero rows where every slot dropped),
    aux and gradients; nothing is NaN."""
    kw = dict(moe_top_k=top_k, moe_capacity_factor=cf, moe_group_size=gs)
    mlp, h = _mlp_params(), _h((2, 16, 32), 2)
    out, aux, g = _port_mlp(port_tf._moe_mlp_routed, h, mlp,
                            _cfg(port_tf, **kw), grads=True)
    jout, jaux, jg = _jax_mlp(jax_tf._moe_mlp_routed, h, mlp,
                              _cfg(jax_tf, **kw), grads=True)
    assert np.all(np.isfinite(out)) and np.isfinite(aux)
    np.testing.assert_array_equal(np.all(out == 0, -1), np.all(jout == 0, -1))
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    for key in ("router", "wi", "wo"):
        np.testing.assert_allclose(g[key], jg[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    if cf == 1e-6:
        # C = 1 per expert: at most E rows of a group got an expert.
        assert np.sum(np.any(out[0] != 0.0, axis=-1)) <= 4


def test_dropped_share_counts_the_capacity_drops():
    expert.ROUTING.clear()
    kw = dict(moe_top_k=1, moe_capacity_factor=1e-6, moe_group_size=16)
    _port_mlp(port_tf._moe_mlp_routed, _h((1, 16, 32), 2), _mlp_params(),
              _cfg(port_tf, **kw))
    # 16 tokens, one slot each, 4 experts of capacity 1.
    assert expert.ROUTING["pairs"] == 16
    assert expert.dropped_share() == pytest.approx(12 / 16)
    expert.ROUTING.clear()


def _port_flops(E: int, impl: str) -> int:
    model = build_model("transformer", vocab_size=128, d_model=64,
                        n_layers=2, n_heads=4, max_seq_len=64,
                        dtype="float32", param_dtype="float32",
                        moe_num_experts=E, moe_top_k=2, moe_impl=impl,
                        moe_group_size=256, attention_impl="naive",
                        device="cpu")
    params = model.init(0)
    with FlopCounterMode(display=False) as counter:
        model.apply(params, torch.zeros((4, 64), dtype=torch.long))
    return counter.get_total_flops()


def test_routed_flops_independent_of_expert_count():
    r4, r16 = _port_flops(4, "routed"), _port_flops(16, "routed")
    d4, d16 = _port_flops(4, "dense"), _port_flops(16, "dense")
    assert d16 / d4 > 2.0, f"dense should scale with E: {d4} -> {d16}"
    assert r16 / r4 < 1.5, f"routed should not: {r4} -> {r16}"


@pytest.mark.parametrize("case", ["ties", "all_tied", "random"])
@pytest.mark.parametrize("k", [1, 2])
def test_topk_by_argmax_matches_jax(case, k):
    """Selection, order and gradient equal JAX's ``_topk_by_argmax`` (and
    ``lax.top_k``), ties included: the gradient reaches only the
    selected entries."""
    x = {"ties": np.array([0.5, 0.5, 0.1, 0.5], np.float32),
         "all_tied": np.full(4, 0.25, np.float32),
         "random": np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                                 (3, 5, 7)))}[case]
    jv, ji = jax_tf._topk_by_argmax(jnp.asarray(x), k)
    lv, li = jax.lax.top_k(jnp.asarray(x), k)
    jg = jax.grad(lambda p: jnp.sum(jax_tf._topk_by_argmax(p, k)[0] ** 2))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    v, i = port_tf._topk_by_argmax(t, k)
    (g,) = torch.autograd.grad((v ** 2).sum(), t)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(li))
    np.testing.assert_array_equal(v.detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(v.detach().numpy(), np.asarray(lv))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)


# -- the model -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pair(**over):
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**{**MODEL, **over}))
    return jm, jm.init(jax.random.PRNGKey(3))


def _tokens(seed=0, batch=2, seq=24) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, (batch, seq + 1))


def _port(jp, **over):
    pm = port_tf.Transformer(port_tf.TransformerConfig(**{**MODEL, **over}),
                             device="cpu")
    return pm, from_jax_params(jax.tree.map(np.asarray, jp), pm.cfg, "cpu")


def _port_loss_grads(pm, params, tokens) -> tuple:
    flat = flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    loss, metrics = pm.loss(params, {"tokens": torch.from_numpy(tokens)})
    g = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), metrics, dict(zip(flat, g))


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(impl: str, cf: float) -> tuple:
    jm, jp = _jax_pair(moe_impl=impl, moe_capacity_factor=cf)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(_tokens(), jnp.int32)},
                          jax.random.PRNGKey(0)), has_aux=True)(jp)
    return (float(loss), float(metrics["moe_aux"]), float(metrics["loss"]),
            flatten(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("impl,cf", [("routed", 1.25), ("routed", 0.5),
                                     ("dense", 1.25)])
def test_loss_aux_and_every_gradient_match_jax(impl, cf):
    """A 2-layer MoE transformer: the loss (with the weighted aux), the
    ``moe_aux`` metric, the next-token loss and every gradient leaf
    within 1e-5 of JAX's (cf 0.5 drops tokens)."""
    _, jp = _jax_pair(moe_impl=impl, moe_capacity_factor=cf)
    pm, params = _port(jp, moe_impl=impl, moe_capacity_factor=cf)
    loss, metrics, grads = _port_loss_grads(pm, params, _tokens())
    jloss, jaux, jnll, jgrads = _jax_loss_grads(impl, cf)
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    np.testing.assert_allclose(float(metrics["moe_aux"]), jaux, **TOL)
    np.testing.assert_allclose(float(metrics["loss"]), jnll, **TOL)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], **TOL, err_msg=k)


@pytest.mark.parametrize("policy", ["mlp", "mlp_pre", "full", "selective"])
def test_remat_gives_the_same_gradients_and_saves_nothing_f_wide(policy):
    """Each remat policy gives the no-remat loss and gradients; ``mlp``
    and ``mlp_pre`` (which degrades to ``mlp`` under MoE) save no F-wide
    activation (the experts' hiddens), where no remat saves them."""
    _, jp = _jax_pair()
    F = 4 * MODEL["d_model"]
    W = MODEL["moe_num_experts"] * MODEL["d_model"] * F  # a layer's wi

    def run(**over):
        pm, params = _port(jp, **over)
        wide = []

        def pack(t):
            if F in t.shape and t.numel() != W:
                wide.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = _port_loss_grads(pm, params, _tokens())
        return out, wide

    (ref_loss, _, ref), ref_wide = run()
    (loss, _, grads), wide = run(remat=True, remat_policy=policy)
    assert ref_wide, "the no-remat run saves the experts' hiddens"
    if policy in ("mlp", "mlp_pre"):
        assert wide == [], wide
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("over", [{}, dict(moe_top_k=1, moe_num_experts=8),
                                  dict(n_layers=8, d_model=512, n_heads=8,
                                       max_seq_len=512, vocab_size=50257,
                                       moe_num_experts=8, moe_top_k=2)])
def test_flops_per_token_equals_jax(over):
    kw = {**MODEL, **over}
    pm = port_tf.Transformer(port_tf.TransformerConfig(**kw), device="cpu")
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**kw))
    assert pm.num_params() == jm.num_params()
    assert pm.flops_per_token() == jm.flops_per_token()
    assert pm.flops_per_token(64) == jm.flops_per_token(64)


def test_moe_transformer_preset_is_jax():
    pm = port_tf.build_transformer("moe_transformer", device="cpu")
    jm = jax_tf.build_transformer("moe_transformer")
    for k in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
              "max_seq_len", "moe_num_experts", "moe_top_k",
              "moe_capacity_factor", "moe_group_size", "moe_aux_weight",
              "moe_impl", "dtype", "tie_embeddings", "pos_encoding"):
        assert getattr(pm.cfg, k) == getattr(jm.cfg, k), k
    # 168.65M parameters, 67.99M of them active per token (top 2 of 8).
    assert pm.num_params() == jm.num_params() == 168_650_240
    c = pm.cfg
    experts = c.moe_num_experts * 2 * c.d_model * c.d_ff * c.n_layers
    assert pm.num_params() - experts + experts * 2 // 8 == 67_986_944
    assert pm.flops_per_token() == jm.flops_per_token()


def test_from_jax_params_checks_the_moe_leaves():
    _, jp = _jax_pair()
    pm, params = _port(jp)
    assert {k: tuple(v.shape) for k, v in params["mlp"].items()} == {
        "router": (2, 32, 4), "wi": (2, 4, 32, 128), "wo": (2, 4, 128, 32)}
    bad = jax.tree.map(np.asarray, jp)
    bad["mlp"]["wi"] = bad["mlp"]["wi"][:, :3]
    with pytest.raises(ValueError, match="mlp/wi"):
        from_jax_params(bad, pm.cfg, "cpu")
    assert pm.logical_axes()["mlp"] == jax_tf.Transformer(
        jax_tf.TransformerConfig(**MODEL)).logical_axes()["mlp"]


@pytest.mark.parametrize("impl", ["routed", "dense"])
def test_greedy_generate_equals_jax(impl):
    """Greedy tokens of a MoE model (prefill routes the prompt; each
    decoded token is a group of one) equal JAX's ``generate``. The
    weights are scaled by 3 so that the tiny model's tokens follow the
    routing."""
    jm, jp = _jax_pair(moe_impl=impl)
    jp = jax.tree.map(lambda w: w * 3.0, jp)
    prompt = np.random.default_rng(5).integers(0, 64, (2, 6))
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt, jnp.int32), 10))
    pm, params = _port(jp, moe_impl=impl)
    got = pm.generate(params, prompt, 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_routed_model_trains():
    """The port's Trainer on a routed MoE transformer: finite losses that
    fall over a few steps on one batch, ``moe_aux`` in every row."""
    cfg = port_config.Config()
    for k, v in dict(batch_size=4, total_epochs=1, log_every=1,
                     dtype="float32", learning_rate=3e-3, warmup_steps=0,
                     optimizer="adamw", save_every=0).items():
        setattr(cfg.train, k, v)
    rt = Runtime(device=torch.device("cpu"))
    model = port_tf.Transformer(port_tf.TransformerConfig(**MODEL),
                                device="cpu")
    ds = SyntheticLMDataset(size=4, seq_len=16, vocab_size=64, seed=0)
    loader = ShardedDataLoader(ds, rt, batch_size=4, shuffle=False)
    trainer = Trainer(cfg, rt, model, loader)
    batch = next(iter(loader.epoch(0)))
    rows = [trainer.train_step(batch) for _ in range(5)]
    losses = [float(m["loss"]) for m in rows]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(0.9 < float(m["moe_aux"]) < 4.0 for m in rows)


# -- the gloo worlds -------------------------------------------------------------
#
# One spawned gloo world of 2 (worker ``tests/test_torch_moe_world.py``)
# trains the tiny routed MoE model under dp 2, fsdp 2 (the experts
# split), tp 2, sp 2 (Ulysses and the ring) and pp 2 (GPipe, M 4), and
# the planted faults, from one init on the same global batches, at a
# capacity that drops tokens (C 4 for 32 assignments a group; one group
# a row, across both sequence slices). JAX's trainer runs the same steps
# in one process (and on a pp 2 mesh of fake devices for the pp case).
# The world runs once for every test process of a run: the first to
# need it spawns it under a lock and the others read its output.

import fcntl  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from distributed_training_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from distributed_training_tpu_torch.train.optimizer import unflatten  # noqa: E402

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu import runtime as jax_runtime  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

from test_torch_moe_world import DATASETS  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_moe_world.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The aux at weight 1 (JAX's default 0.01 would leave its gradient, and
# a fault in it, below the readings' resolution).
W_MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
               max_seq_len=16, dtype="float32", moe_num_experts=4,
               moe_top_k=2, moe_capacity_factor=0.5, moe_group_size=16,
               moe_aux_weight=1.0)
W_TRAIN = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.1,
               warmup_steps=2, lr_schedule="cosine", grad_clip_norm=0.5,
               total_epochs=1, log_every=1, dtype="float32", seed=7,
               min_shard_elems=1, save_every=0)
W_STEPS, W_BATCH = 3, 4
W_DATASET = dict(size=W_STEPS * W_BATCH, seq_len=16, vocab_size=64, seed=7)
PP_MODEL = {"pp_microbatches": 4, "pp_schedule": "gpipe"}
DP2 = {"parallel_strategy": "ddp", "batch_size": 2}
# Masked rows and two grad-accum microbatches: the shards' live-target
# weights differ from 1 and the aux is averaged over the microbatches.
MASKED = {"dataset": "masked", "train": {"grad_accum_steps": 2}}
# name → (mesh, train overrides (rows a data shard), model overrides,
# planted fault[, MASKED]).
WORLD_CASES = {
    "dp2": ({"dp": 2}, DP2, {}, None),
    "fsdp2": ({"dp": 1, "fsdp": 2},
              {"parallel_strategy": "fsdp", "batch_size": 2}, {}, None),
    "tp2": ({"dp": 1, "tp": 2}, {"parallel_strategy": "tp"}, {}, None),
    "sp2_ulysses": ({"dp": 1, "sp": 2}, {"parallel_strategy": "ddp"},
                    {"attention_impl": "ulysses"}, None),
    "sp2_ring": ({"dp": 1, "sp": 2}, {"parallel_strategy": "ddp"},
                 {"attention_impl": "ring"}, None),
    "tp2_dense": ({"dp": 1, "tp": 2}, {"parallel_strategy": "tp"},
                  {"moe_impl": "dense"}, None),
    "dp2_masked_accum": ({"dp": 2}, DP2, {}, None, MASKED),
    "pp2_gpipe": ({"dp": 1, "pp": 2}, {"parallel_strategy": "ddp"},
                  PP_MODEL, None),
    "dp2_local_aux": ({"dp": 2}, DP2, {}, "local_aux"),
    "sp2_ring_no_offset": ({"dp": 1, "sp": 2}, {"parallel_strategy": "ddp"},
                           {"attention_impl": "ring"}, "sp_offset"),
    "tp2_seam_twice": ({"dp": 1, "tp": 2}, {"parallel_strategy": "tp"}, {},
                       "tp_seam"),
    "dp2_masked_weight_twice": ({"dp": 2}, DP2, {}, "shard_weight", MASKED),
}
SOUND = [n for n, case in WORLD_CASES.items() if case[3] is None]
FAULTS = [n for n, case in WORLD_CASES.items() if case[3] is not None]


def _ref(name: str) -> tuple:
    """The JAX run a world case is held against: (JAX's mesh, dataset,
    grad accum steps, model overrides). One device, but pp 2 for the
    pipeline (its aux is the microbatches' mean) and dp 2 under grad
    accumulation (JAX's strided microbatches of the sharded global
    batch take the port's rows)."""
    mesh, _, model, _, *masked = WORLD_CASES[name]
    extra = masked[0] if masked else {}
    accum = extra.get("train", {}).get("grad_accum_steps", 1)
    jax_mesh = ((("pp", 2),) if "pp" in mesh
                else (("dp", 2),) if accum > 1 else ())
    impl = {k: v for k, v in model.items() if k == "moe_impl"}
    return (jax_mesh, extra.get("dataset", "skewed"), accum,
            tuple(sorted(impl.items())))


REFS = sorted({_ref(n) for n in WORLD_CASES})
# The limits every sound world meets and every fault misses: relative
# differences from JAX's losses, gradient norms and moe_aux.
LIMITS = {"loss": 1e-5, "grad_norm": 1e-5, "moe_aux": 1e-5}


def _jax_init() -> dict:
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(
        **W_MODEL, attention_impl="naive"))
    return flatten(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(11))))


def _jax_run(ref: tuple) -> dict:
    """JAX's trainer from ``_jax_init`` on the world's global batches (the
    ``_ref`` tuple): in one process, or on a pp 2 mesh of fake devices.
    Per step: losses, gradient norms, moe_aux."""
    jax_mesh, dataset, accum, model = ref
    mesh = dict(jax_mesh)
    pp = "pp" in mesh
    cfg = jax_config.Config()
    for k, v in {**W_TRAIN, "grad_accum_steps": accum,
                 "batch_size": W_BATCH // mesh.get("dp", 1)}.items():
        setattr(cfg.train, k, v)
    rt = jax_runtime.fake_cpu_runtime(max(1, len(mesh) * 2), **mesh)
    loader = JaxLoader(DATASETS[dataset](**W_DATASET), rt,
                       batch_size=cfg.train.batch_size, seed=W_TRAIN["seed"],
                       shuffle=False)
    jt = JaxTrainer(cfg, rt, jax_tf.Transformer(jax_tf.TransformerConfig(
        **W_MODEL, attention_impl="naive", **dict(model),
        **(PP_MODEL if pp else {}))), loader)
    jt.state["params"] = jax.device_put(unflatten(_jax_init()),
                                        jt.state_shardings["params"])
    out = {"loss": [], "grad_norm": [], "moe_aux": []}
    step = jt.train_step

    def train_step(batch):
        m = step(batch)
        for k in out:
            out[k].append(float(m[k]))
        return m
    jt.train_step = train_step
    jt.train()
    out["params"] = flatten(jax.tree.map(np.asarray, jt.state["params"]))
    return out


def _spawn(out: str) -> None:
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in _jax_init().items()},
               os.path.join(out, "init.pt"))
    cases = [{"name": name, "mesh": mesh, "model": model, "fault": fault,
              "train": {**train, **(masked[0]["train"] if masked else {})},
              "dataset": masked[0]["dataset"] if masked else "skewed",
              **({"ckpt": os.path.join(out, "ckpt_fsdp2")}
                 if name == "fsdp2" else {})}
             for name, (mesh, train, model, fault, *masked)
             in WORLD_CASES.items()]
    cases[[c["name"] for c in cases].index("fsdp2")]["train"] = {
        **WORLD_CASES["fsdp2"][1], "save_every": 1}
    job = {"world": 2, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "model": W_MODEL, "dataset": W_DATASET,
           "train": {**W_TRAIN, "batch_size": W_BATCH, "device": "cpu"},
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
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        log[-3000:] for log in logs)


_WORLD: dict = {}


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's output directory, JAX's one-process run, JAX's pp
    run), once per test run."""
    if "out" not in _WORLD:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # the run's directory, above the workers'

        def make(d):
            _spawn(d)
            return {"dir": d, "jax": {ref: _jax_run(ref) for ref in REFS}}
        _WORLD["out"] = _once(root, "moe_world", make)
    return _WORLD["out"]


def _world_run(world: dict, name: str) -> dict:
    return torch.load(os.path.join(world["dir"], f"{name}.pt"),
                      weights_only=False)


def _readings(world: dict, name: str) -> dict:
    """The world run's per-step metrics and their largest relative
    difference from JAX's (the pp case from JAX's pp mesh)."""
    rows = _world_run(world, name)["rows"]
    got = {"loss": [r["loss"] for r in rows],
           "grad_norm": [r["grad_norm"] for r in rows if "grad_norm" in r],
           "moe_aux": [r["moe_aux"] for r in rows]}
    want = world["jax"][_ref(name)]
    # The port's warm-up row carries no gradient norm.
    want = {k: want[k] for k in LIMITS} | {"grad_norm": want["grad_norm"][1:]}
    assert len(got["loss"]) == W_STEPS, (name, got)
    return {k: float(np.max(np.abs(np.subtract(got[k], want[k]))
                            / np.abs(want[k]))) for k in LIMITS}


@pytest.mark.parametrize("name", SOUND)
def test_world_matches_jax(name, world):
    """Each composition's losses, gradient norms and moe_aux within
    LIMITS of JAX's over the same global batches, and its final params
    (every update's gradients) within 1e-6 of JAX's."""
    diffs = _readings(world, name)
    assert all(diffs[k] <= LIMITS[k] for k in LIMITS), (name, diffs)
    got = _world_run(world, name)["params"]
    want = world["jax"][_ref(name)]["params"]
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", FAULTS)
def test_planted_fault_fails_the_limits(name, world):
    diffs = _readings(world, name)
    assert any(diffs[k] > LIMITS[k] for k in LIMITS), (name, diffs)


def test_local_aux_misses_the_global_aux(world):
    """The skewed shards route differently, so the mean of the per-shard
    aux is not the global one, which the sound world's first aux is."""
    sound = _world_run(world, "dp2")["rows"][0]["moe_aux"]
    local = _world_run(world, "dp2_local_aux")["rows"][0]["moe_aux"]
    assert sound == pytest.approx(world["jax"][_ref("dp2")]["moe_aux"][0],
                                  rel=1e-6)
    assert abs(local - sound) > 1e-4 * sound


def test_fsdp2_splits_the_experts(world):
    """Expert parallelism: under fsdp 2 the expert leaves are stored with
    their ``expert`` dim (dim 1 of the stacked leaf) split over fsdp,
    the router on its ``embed`` dim."""
    placements = _world_run(world, "fsdp2")["placements"]
    assert placements["mlp/wi"] == ((1, ("fsdp",)),)
    assert placements["mlp/wo"] == ((1, ("fsdp",)),)
    assert placements["mlp/router"] == ((1, ("fsdp",)),)


def test_fsdp2_save_restores_at_world_1_bit_for_bit(world, tmp_path):
    """The fsdp 2 save (the experts split) restores in one process to the
    world's final params, bit for bit."""
    saved = _world_run(world, "fsdp2")["params"]
    ck = Checkpointer(os.path.join(world["dir"], "ckpt_fsdp2"),
                      runtime=Runtime(device=torch.device("cpu")))
    state, _ = ck.restore_latest(torch.device("cpu"), None)
    got = flatten(state["params"])
    assert set(got) == set(saved)
    for k, v in got.items():
        assert torch.equal(v, saved[k]), k


def test_pp_aux_equals_jax_pp_and_is_near_dp(world):
    """Under pp the aux is the microbatches' mean, as JAX's pp value
    (not only within 2% of the whole batch's, JAX's own test)."""
    pp = [r["moe_aux"] for r in _world_run(world, "pp2_gpipe")["rows"]]
    np.testing.assert_allclose(pp, world["jax"][_ref("pp2_gpipe")]["moe_aux"],
                               rtol=1e-5)
    dp = [r["moe_aux"] for r in _world_run(world, "dp2")["rows"]]
    np.testing.assert_allclose(pp[0], dp[0], rtol=0.02)
    assert pp[0] != dp[0]

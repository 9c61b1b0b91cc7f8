"""The port's Transformer held against the JAX package's.

Weights made by the JAX ``init`` are carried across with
``from_jax_params``; token ids are seeded numpy. Logits, the training
loss and its gradients must agree to 1e-4 in float32 (summation order
differs across twelve matmuls per layer and the softmax).
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.registry import build_model

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402

CONFIGS = {
    "rope-gqa-untied": dict(vocab_size=256, d_model=64, n_layers=2,
                            n_heads=4, n_kv_heads=2, max_seq_len=128,
                            pos_encoding="rope", tie_embeddings=False),
    "learned-tied-mha": dict(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=4, max_seq_len=128),
    "window-rope-gqa": dict(vocab_size=256, d_model=64, n_layers=2,
                            n_heads=4, n_kv_heads=1, max_seq_len=128,
                            pos_encoding="rope", tie_embeddings=False,
                            attention_window=7),
}


def _pair(name):
    kw = dict(CONFIGS[name], dtype="float32", param_dtype="float32")
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(1))
    pm = port_tf.Transformer(port_tf.TransformerConfig(**kw), device="cpu")
    return jm, jp, pm, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_logits_match_jax(name):
    jm, jp, pm, np_params = _pair(name)
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 24))
    want, _ = jm.apply(jp, jnp.asarray(tokens, jnp.int32))
    got, aux = pm.apply(from_jax_params(np_params, pm.cfg, device="cpu"),
                        torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_init_has_the_jax_structure(name):
    """Same keys and stacked shapes as the JAX init (tied: no lm_head);
    the converter rejects a tree that does not fit."""
    _, _, pm, np_params = _pair(name)
    mine = pm.init(0)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(mine) == shapes(np_params)
    assert ("lm_head" in mine) is (not pm.cfg.tie_embeddings)
    assert float(mine["ln1"]["scale"].min()) == 1.0
    assert not mine["mlp"]["bi"].any()
    bad = dict(np_params, tok_embed=np_params["tok_embed"][:-1])
    with pytest.raises(ValueError, match="tok_embed"):
        from_jax_params(bad, pm.cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(dict(np_params, extra=np.zeros(1)), pm.cfg,
                        device="cpu")


def test_gpt2_125m_preset_is_the_jax_one():
    assert port_tf.PRESETS["gpt2_125m"] == jax_tf.PRESETS["gpt2_125m"]
    cfg = port_tf.TransformerConfig(**port_tf.PRESETS["gpt2_125m"])
    assert (cfg.head_dim, cfg.n_kv_heads, cfg.d_ff) == (64, 12, 3072)


def test_deferred_model_features_raise():
    # MoE runs (item 16c): the model builds, and so does ResNet-18
    # (item 16d), on the CPU when asked.
    moe = port_tf.Transformer(port_tf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2,
        moe_num_experts=4), device="cpu")
    assert set(moe.init(0)["mlp"]) == {"router", "wi", "wo"}
    resnet = build_model("resnet18", device="cpu")
    assert resnet.device.type == "cpu" and resnet.width == 64
    cfg = port_tf.TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                                    n_heads=2, dtype="float32")
    params = port_tf.Transformer(cfg, device="cpu").init(0)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    # Ring attention runs (item 16a): without an sp group it is the
    # degenerate ring, the full attention of one process.
    ring = port_tf.Transformer(port_tf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, dtype="float32",
        attention_impl="ring"), device="cpu")
    np.testing.assert_allclose(
        ring.apply(params, tokens)[0].numpy(),
        port_tf.Transformer(cfg, device="cpu").apply(params,
                                                     tokens)[0].numpy(),
        rtol=1e-5, atol=1e-6)


def _flat(tree, prefix=""):
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("loss_impl", ["fused", "dense"])
@pytest.mark.parametrize("name", ["learned-tied-mha", "rope-gqa-untied"])
def test_loss_and_grads_match_jax(name, loss_impl):
    """``Transformer.loss`` and its gradients (autograd through the
    stacked leaves, the tied embedding taking both gradients) against
    ``jax.value_and_grad`` of the JAX loss; masked targets included.
    float32, 1e-4 (as the logits above)."""
    kw = dict(loss_impl=loss_impl, xent_chunk_rows=16)
    jm, jp, pm, np_params = _pair(name)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**{**vars(jm.cfg),
                                                        **kw}))
    pm = port_tf.Transformer(port_tf.TransformerConfig(**{**vars(pm.cfg),
                                                          **kw}),
                             device="cpu")
    tokens = np.random.default_rng(5).integers(0, 256, size=(2, 21))
    tokens[1, -4:] = -1
    (want, _), want_g = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)},
                          jax.random.PRNGKey(0)), has_aux=True)(jp)
    params = from_jax_params(np_params, pm.cfg, device="cpu")
    leaves = _flat(params)
    for v in leaves.values():
        v.requires_grad_(True)
    got, metrics = pm.loss(params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(got, list(leaves.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(metrics["loss"]) == float(got.detach())
    want_flat = _flat(jax.tree.map(np.asarray, want_g))
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_flat[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_every_remat_policy_gives_the_same_grads_and_one_attention_pass(
        monkeypatch):
    """Remat changes what is saved, not the gradients; and no policy
    wraps attention, so the flash forward (its plain version on CPU)
    runs once per layer per step."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    calls = []
    plain = fa.flash_fwd_reference

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd_reference", counted)
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, 256, size=(2, 129)))
    base = dict(CONFIGS["rope-gqa-untied"], dtype="float32",
                attention_impl="flash")
    ref = None
    for policy in (None, "mlp", "mlp_pre", "selective", "full"):
        cfg = port_tf.TransformerConfig(**base, remat=policy is not None,
                                        remat_policy=policy or "mlp")
        model = port_tf.Transformer(cfg, device="cpu")
        params = model.init(3)
        flat = list(_flat(params).values())
        for p in flat:
            p.requires_grad_(True)
        calls.clear()
        loss, _ = model.loss(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, flat)
        assert len(calls) == cfg.n_layers, (policy, len(calls))
        if ref is None:
            ref = (loss, grads)
            continue
        torch.testing.assert_close(loss, ref[0], rtol=1e-6, atol=1e-6)
        for a, b in zip(grads, ref[1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

"""The port's Transformer held against the JAX package's.

Weights made by the JAX ``init`` are carried across with
``from_jax_params``; token ids are seeded numpy. Logits must agree to
1e-4 in float32 (summation order differs across twelve matmuls per
layer and the softmax).
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params

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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_tf.Transformer(port_tf.TransformerConfig(
            vocab_size=64, d_model=32, n_layers=1, n_heads=2,
            moe_num_experts=4), device="cpu")
    cfg = port_tf.TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                                    n_heads=2, dropout=0.1,
                                    dtype="float32")
    model = port_tf.Transformer(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.apply(params, tokens, train=True)
    ring = port_tf.Transformer(port_tf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, dtype="float32",
        attention_impl="ring"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ring.apply(params, tokens)

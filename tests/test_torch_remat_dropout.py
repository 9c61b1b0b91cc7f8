"""Remat allow-lists and dropout: the port's Transformer against JAX's.

Remat: the matrix products the backward runs (a ``TorchDispatchMode``
count on the port; ``dot_general`` equations outside the Pallas kernels
in JAX's gradient jaxpr, whose scan body holds one layer) differ from
the no-remat backward by the ``wi`` product under ``mlp`` (one a layer)
and by nothing under ``mlp_pre``, on both sides; losses and gradients
under ``none``/``mlp``/``mlp_pre`` agree with JAX's to 1e-5.

Dropout: torch cannot replay ``jax.random``, so the test patches both
sides' ``_dropout`` (in this test only) to take the same masks from a
seeded numpy table keyed by (layer, site, microbatch): the port's by the
seed ``dropout_seed`` gives each site, JAX's by the ``fold_in`` key its
trunk derives. Loss and gradients agree to 1e-5. The port's own masks
differ across sites and layers, repeat for the same seed, and
``train=False`` draws none. float32 throughout.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402

MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
             max_seq_len=128, dtype="float32", param_dtype="float32",
             attention_impl="naive")
SEQ = 32
RATE = 0.25
TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _pair(**over):
    kw = dict(MODEL, **over)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(1))
    pm = port_tf.Transformer(port_tf.TransformerConfig(**kw), device="cpu")
    return jm, jp, pm


def _tokens(seed=0, batch=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, 64, (batch, seq + 1))


def _port_loss_and_grads(pm, jp, tokens, rng=None, train=True):
    params = from_jax_params(jax.tree.map(np.asarray, jp), pm.cfg,
                             device="cpu")
    leaves = _flat(params)
    for v in leaves.values():
        v.requires_grad_(True)
    loss, _ = pm.loss(params, {"tokens": torch.from_numpy(tokens)}, rng=rng,
                      train=train)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


def _jax_loss_and_grads(jm, jp, tokens, rng):
    (loss, _), grads = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)},
                          rng), has_aux=True)(jp)
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


def _assert_match(got, want):
    (loss, grads), (jloss, jgrads) = got, want
    np.testing.assert_allclose(float(loss.detach()), jloss, **TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], err_msg=k, **TOL)


# -- remat --------------------------------------------------------------------


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched inside it."""

    OPS = ("mm", "bmm", "addmm", "baddbmm")

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _jax_dots(jaxpr) -> int:
    """``dot_general`` equations of a jaxpr and its sub-jaxprs (a scan
    body once), not entering Pallas kernels."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "dot_general"
        if eqn.primitive.name == "pallas_call":
            continue
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    n += _jax_dots(sub)
    return n


POLICIES = {"none": {}, "mlp": dict(remat=True, remat_policy="mlp"),
            "mlp_pre": dict(remat=True, remat_policy="mlp_pre")}


def test_remat_recompute_set_is_jax_allow_lists():
    """With the flash kernels (JAX's traced, not run: its saved flash
    residuals keep attention out of the recompute, as the port's Function
    does), one whole-tile sequence of 128."""
    tokens = _tokens(seq=128)
    port, jaxc = {}, {}
    for name, over in POLICIES.items():
        jm, jp, pm = _pair(attention_impl="flash", **over)
        params = pm.init(3)
        leaves = list(_flat(params).values())
        for v in leaves:
            v.requires_grad_(True)
        loss, _ = pm.loss(params, {"tokens": torch.from_numpy(tokens)})
        with _Products() as count:
            torch.autograd.grad(loss, leaves)
        port[name] = count.n
        jaxpr = jax.make_jaxpr(jax.grad(lambda p: jm.loss(
            p, {"tokens": jnp.asarray(tokens, jnp.int32)},
            jax.random.PRNGKey(0))[0]))(jp)
        jaxc[name] = _jax_dots(jaxpr.jaxpr)
    layers = MODEL["n_layers"]
    # JAX: the wi product re-runs under "mlp" only (per scan body).
    assert jaxc["mlp"] - jaxc["none"] == 1
    assert jaxc["mlp_pre"] == jaxc["none"]
    assert port["mlp"] - port["none"] == layers * (jaxc["mlp"] - jaxc["none"])
    assert port["mlp_pre"] == port["none"]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_remat_losses_and_grads_match_jax(policy):
    jm, jp, pm = _pair(**POLICIES[policy])
    tokens = _tokens(4)
    _assert_match(_port_loss_and_grads(pm, jp, tokens),
                  _jax_loss_and_grads(jm, jp, tokens, jax.random.PRNGKey(0)))


# -- dropout ------------------------------------------------------------------


def _mask_table(batch, micro):
    """(layer, site, microbatch) → keep mask (B, S, D); the embedding is
    layer None, site 0."""
    rng = np.random.default_rng(11)
    shape = (batch, SEQ, MODEL["d_model"])
    keys = [(None, 0)] + [(lid, s) for lid in range(MODEL["n_layers"])
                          for s in (0, 1)]
    return {(lid, s, mb): rng.random(shape) >= RATE
            for mb in range(micro) for lid, s in keys}


def _jax_key_rows(rng, mb):
    """The key JAX's trunk hands each dropout site for the loss rng
    ``rng`` (its embedding key; each layer's fold_in(rng, 7), layer id,
    microbatch 0, shard 0, then the site)."""
    out = {(None, 0, mb): jax.random.fold_in(rng, 1_000_003)}
    rng7 = jax.random.fold_in(rng, 7)
    for lid in range(MODEL["n_layers"]):
        lrng = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(rng7, lid), 0), 0)
        for site in (0, 1):
            out[(lid, site, mb)] = jax.random.fold_in(lrng, site)
    return out


def test_dropout_with_fed_masks_matches_jax(monkeypatch):
    batch, micro = 2, 2
    table = _mask_table(batch, micro)
    base = jax.random.PRNGKey(3)
    jax_keys = {}
    for mb in range(micro):
        jax_keys.update(_jax_key_rows(jax.random.fold_in(base, mb), mb))
    order = sorted(table, key=str)
    key_rows = jnp.stack([jax_keys[k] for k in order])
    masks = jnp.asarray(np.stack([table[k] for k in order]))

    def jax_dropout(x, rng, rate):
        hit = jnp.all(key_rows == rng[None], axis=1)
        keep = masks[jnp.argmax(hit)]
        return jnp.where(keep, x / (1.0 - rate),
                         jnp.zeros((), x.dtype)).astype(x.dtype)

    step_seed = 123
    port_seeds = {}
    for mb in range(micro):
        rng = port_tf.fold_seed(step_seed, 1, mb, 0)
        port_seeds[port_tf.dropout_seed(rng, None)] = (None, 0, mb)
        for lid in range(MODEL["n_layers"]):
            for site in (0, 1):
                port_seeds[port_tf.dropout_seed(rng, lid, site)] = (
                    lid, site, mb)
    assert len(port_seeds) == len(table)

    def port_dropout(x, rate, seed):
        keep = torch.from_numpy(table[port_seeds[seed]])
        return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)

    monkeypatch.setattr(jax_tf, "_dropout", jax_dropout)
    monkeypatch.setattr(port_tf, "_dropout", port_dropout)
    jm, jp, pm = _pair(dropout=RATE, remat=True, remat_policy="mlp")
    for mb in range(micro):
        tokens = _tokens(20 + mb, batch)
        got = _port_loss_and_grads(pm, jp, tokens,
                                   rng=port_tf.fold_seed(step_seed, 1, mb, 0))
        want = _jax_loss_and_grads(jm, jp, tokens,
                                   jax.random.fold_in(base, mb))
        _assert_match(got, want)
        # The masks bit: without them the losses part.
        plain = _jax_loss_and_grads(jm, jp, tokens, None)[0]
        assert abs(plain - want[0]) > 1e-3


def test_port_masks_differ_by_site_and_repeat_per_seed(monkeypatch):
    seen = []
    real = port_tf._dropout

    def recording(x, rate, seed):
        y = real(x, rate, seed)
        seen.append((seed, (y == 0).clone()))
        return y

    monkeypatch.setattr(port_tf, "_dropout", recording)
    _, jp, pm = _pair(dropout=RATE)
    tokens = _tokens(7)

    def draw(rng):
        seen.clear()
        loss, _ = _port_loss_and_grads(pm, jp, tokens, rng=rng)
        return loss, list(seen)

    loss_a, a = draw(5)
    loss_b, b = draw(5)
    loss_c, c = draw(6)
    assert len(a) == 1 + 2 * MODEL["n_layers"]
    assert len({s for s, _ in a}) == len(a)
    for i in range(len(a)):
        assert torch.equal(a[i][1], b[i][1])
        assert not torch.equal(a[i][1], c[i][1])
        zero_share = float(a[i][1].float().mean())
        assert 0.15 < zero_share < 0.35
    for i in range(len(a)):
        for j in range(i):
            assert not torch.equal(a[i][1], a[j][1]), (i, j)
    assert torch.equal(loss_a, loss_b) and not torch.equal(loss_a, loss_c)
    seen.clear()
    off, _ = _port_loss_and_grads(pm, jp, tokens, rng=5, train=False)
    assert seen == []
    _, _, still = _pair()
    want, _ = _port_loss_and_grads(still, jp, tokens)
    assert torch.equal(off, want)


def test_apply_dropout_only_in_training_with_an_rng():
    _, jp, pm = _pair(dropout=RATE)
    params = from_jax_params(jax.tree.map(np.asarray, jp), pm.cfg,
                             device="cpu")
    tokens = torch.from_numpy(_tokens(8)[:, :64])
    base, _ = pm.apply(params, tokens)
    assert torch.equal(pm.apply(params, tokens, rng=4)[0], base)
    assert torch.equal(pm.apply(params, tokens, rng=None, train=True)[0],
                       base)
    dropped, _ = pm.apply(params, tokens, rng=4, train=True)
    assert not torch.equal(dropped, base)
    assert torch.equal(pm.apply(params, tokens, rng=4, train=True)[0],
                       dropped)

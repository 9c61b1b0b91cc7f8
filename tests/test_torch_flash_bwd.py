"""The port's flash-attention backward held against the JAX package's.

- ``flash_bwd`` on CPU tensors runs ``flash_bwd_reference``, the plain
  version of the backward kernels; it is held against the JAX
  ``_flash_bwd`` Pallas kernels in interpret mode, on the fused path and
  (with the JAX switch forced in the test) on the split path.
- ``flash_attention``'s autograd gradients against ``jax.vjp`` of the
  JAX ``flash_attention``.

float32, S=128, D=16; tolerance 1e-5 abs/rel (the frameworks sum in
different orders). bf16 inputs with f32 gradients: 1e-2 of each
gradient's largest magnitude (bf16 rounding of p and ds, then sums of
up to S terms in another order).
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.ops import flash_attention as port_fa

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.ops import flash_attention as jax_fa  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(4, 4, True, 0), (4, 4, True, 40), (4, 2, True, 0),
         (4, 1, True, 30), (4, 2, False, 0)]
IDS = ["causal", "window", "gqa", "gqa-window", "noncausal"]


def _inputs(seed, H, Hkv, S=128, D=16, B=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _jax_fwd(q, k, v, causal, window, dtype=jnp.float32):
    return jax_fa._flash_fwd(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                             causal=causal, block_q=64, block_k=32,
                             window=window)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("H,Hkv,causal,window", CASES, ids=IDS)
def test_flash_bwd_plain_matches_jax_interpret(monkeypatch, split, H, Hkv,
                                               causal, window):
    q, k, v, do = _inputs(1, H, Hkv)
    monkeypatch.setattr(jax_fa, "_FORCE_SPLIT_BWD", split)
    out, lse = _jax_fwd(q, k, v, causal, window)
    want = jax_fa._flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
        jnp.asarray(do), causal=causal, block_q=64, block_k=32,
        window=window)
    t = torch.from_numpy
    got = port_fa.flash_bwd(t(q), t(k), t(v), t(np.array(out)),
                            t(np.array(lse)), t(do), causal=causal,
                            window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_flash_bwd_delta_and_grads_dtype_hooks(monkeypatch, split):
    """The ring callers' hooks: ``out=None`` with a precomputed delta,
    and ``grads_dtype``: f32 gradients from f32 inputs (1e-5) and from
    bf16 inputs (1e-2 of the largest magnitude)."""
    monkeypatch.setattr(jax_fa, "_FORCE_SPLIT_BWD", split)
    q, k, v, do = _inputs(2, 4, 2)
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
        out, lse = _jax_fwd(q, k, v, True, 0, dtype)
        delta = jnp.sum(jdo.astype(jnp.float32) * out.astype(jnp.float32),
                        axis=-1, keepdims=True)
        want = jax_fa._flash_bwd(jq, jk, jv, None, lse, jdo, causal=True,
                                 block_q=64, block_k=32, delta=delta,
                                 grads_dtype=jnp.float32)

        def t(x):
            return torch.from_numpy(np.array(x, np.float32)).to(tdtype)

        got = port_fa.flash_bwd(
            t(jq), t(jk), t(jv), None, t(lse).float(), t(jdo), causal=True,
            delta=t(delta).float(), grads_dtype=torch.float32)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            w = np.asarray(w)
            if dtype == jnp.float32:
                np.testing.assert_allclose(g.numpy(), w, **TOL)
            else:
                err = np.abs(g.numpy() - w).max()
                assert err <= 1e-2 * np.abs(w).max(), err


@pytest.mark.parametrize("H,Hkv,causal,window", CASES, ids=IDS)
def test_flash_attention_grads_match_jax_vjp(H, Hkv, causal, window):
    """The autograd Function (plain versions on CPU, each side once)
    against ``jax.vjp`` of the JAX flash_attention, in (B, S, H, D)."""
    q, k, v, do = (x.transpose(0, 2, 1, 3).copy()
                   for x in _inputs(3, H, Hkv))

    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, causal=causal, block_q=64,
                                      block_k=32, window=window)

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    f0, b0 = port_fa.flash_fwd.launches, port_fa.flash_bwd_fused.launches
    got = port_fa.flash_attention(*xs, causal=causal, window=window)
    grads = torch.autograd.grad(got, xs, torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # CPU tensors never launch a kernel.
    assert (port_fa.flash_fwd.launches, port_fa.flash_bwd_fused.launches) \
        == (f0, b0)

"""The port's chunked LM cross-entropy held against the JAX op.

Values and gradients (dx, dhead) of ``lm_cross_entropy`` against
``jax.vjp`` of the JAX op on the same numpy inputs, in float32,
tolerance 1e-5 abs/rel (summation order). Cases: several chunks, a
sequence that needs padding to the chunk, masked (negative) targets, and
the no-residual contract of the forward.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.ops import xent as port_xent

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.ops import xent as jax_xent  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,chunk_rows,masked", [
    (2, 16, 8, False), (2, 13, 8, True), (3, 7, 2048, True)],
    ids=["chunks", "padded-masked", "one-chunk-masked"])
def test_lm_cross_entropy_matches_jax(B, S, chunk_rows, masked):
    D, V = 16, 50
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    t = rng.integers(0, V, size=(B, S)).astype(np.int32)
    if masked:
        t[0, -3:] = -1
        t[-1, 0] = -1
    dnll = rng.standard_normal((B, S)).astype(np.float32)

    want, vjp = jax.vjp(
        lambda x, h: jax_xent.lm_cross_entropy(x, h, jnp.asarray(t),
                                               chunk_rows=chunk_rows),
        jnp.asarray(x), jnp.asarray(head))
    want_dx, want_dh = vjp(jnp.asarray(dnll))

    xs = torch.from_numpy(x).requires_grad_()
    hs = torch.from_numpy(head).requires_grad_()
    got = port_xent.lm_cross_entropy(xs, hs, torch.from_numpy(t),
                                     chunk_rows=chunk_rows)
    dx, dh = torch.autograd.grad(got, (xs, hs), torch.from_numpy(dnll))
    assert got.shape == (B, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), **TOL)
    if masked:
        mask = t < 0
        assert not got.detach().numpy()[mask].any()
        # A masked position contributes no gradient to its hidden state.
        assert not dx.numpy()[mask].any()


def test_forward_keeps_no_logits_buffer():
    """Only x, head, targets and the per-token lse are saved: no tensor
    with a vocab-sized last axis survives the forward."""
    B, S, D, V = 2, 32, 8, 97
    x = torch.randn(B, S, D, requires_grad=True)
    head = torch.randn(D, V, requires_grad=True)
    t = torch.randint(0, V, (B, S))
    saved = []

    def pack(tensor):
        saved.append(tuple(tensor.shape))
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        nll = port_xent.lm_cross_entropy(x, head, t, chunk_rows=16)
    assert nll.shape == (B, S)
    assert all(s[-1] != V or s == (D, V) for s in saved), saved


def test_bf16_logits_keep_f32_accumulators():
    """bf16 hidden states and head at a training-like shape: the chunk
    logits are f32 products as in the JAX op, so the per-token nll
    agrees to 1e-4 (rounding the logits to bf16 first moved it by
    2.8e-2 on these inputs)."""
    B, S, D, V = 4, 256, 64, 2048
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    t = rng.integers(0, V, size=(B, S)).astype(np.int32)
    xb, hb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16)
    want, vjp = jax.vjp(
        lambda x, h: jax_xent.lm_cross_entropy(x, h, jnp.asarray(t),
                                               chunk_rows=256), xb, hb)
    _, want_dh = vjp(jnp.ones((B, S), jnp.float32))

    xs = torch.from_numpy(x).bfloat16().requires_grad_()
    hs = torch.from_numpy(head).bfloat16().requires_grad_()
    got = port_xent.lm_cross_entropy(xs, hs, torch.from_numpy(t),
                                     chunk_rows=256)
    (dh,) = torch.autograd.grad(got.sum(), (hs,))
    assert got.dtype == torch.float32 and dh.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    # dhead: f32 sums of products of bf16 dlogits, rounded to bf16: one
    # bf16 ulp, plus a dlogit on a rounding boundary that rounds the
    # other way (its softmax differs in the last f32 bits), which moves
    # an entry by one ulp of that dlogit times x (about 1e-4 here).
    np.testing.assert_allclose(dh.float().numpy(),
                               np.asarray(want_dh, np.float32),
                               rtol=2 ** -7, atol=1e-3)

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

The interpret-mode comparison once failed inside a full parallel test
run (about 500 of 16384 dq elements off by up to 1e-4, where a fresh
process agrees to 1.7e-6) and passed alone. So its JAX reference runs
in a fresh interpreter of its own, on one XLA thread, and twice there,
bit for bit: nothing an earlier test left in the worker reaches it, and
each side's determinism is checked apart from their agreement.
"""

import os
import subprocess
import sys

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


# The JAX side of test_flash_bwd_plain_matches_jax_interpret, run as
# ``python -c _REFERENCE <inputs.npz> <split> <causal> <window> <out.npz>``.
_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from distributed_training_tpu.ops import flash_attention as jax_fa
src, split, causal, window, dst = sys.argv[1:]
x = np.load(src)
jax_fa._FORCE_SPLIT_BWD = split == "1"
kw = dict(causal=causal == "1", block_q=64, block_k=32, window=int(window))
runs = []
for _ in range(2):
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))
    out, lse = jax_fa._flash_fwd(q, k, v, **kw)
    runs.append([np.asarray(a) for a in
                 (out, lse) + tuple(jax_fa._flash_bwd(q, k, v, out, lse, do,
                                                      **kw))])
for a, b in zip(*runs):
    assert np.array_equal(a, b), "the JAX reference differs between runs"
np.savez(dst, **dict(zip(("out", "lse", "dq", "dk", "dv"), runs[0])))
"""


def _jax_reference(tmp_path, q, k, v, do, split, causal, window) -> dict:
    src, dst = tmp_path / "inputs.npz", tmp_path / "reference.npz"
    np.savez(src, q=q, k=k, v=v, do=do)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(src),
                    str(int(split)), str(int(causal)), str(window), str(dst)],
                   env=env, check=True, timeout=300)
    return dict(np.load(dst))


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("H,Hkv,causal,window", CASES, ids=IDS)
def test_flash_bwd_plain_matches_jax_interpret(tmp_path, split, H, Hkv,
                                               causal, window):
    q, k, v, do = _inputs(1, H, Hkv)
    ref = _jax_reference(tmp_path, q, k, v, do, split, causal, window)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), t(ref["out"]), t(ref["lse"]), t(do))
    got = port_fa.flash_bwd(*args, causal=causal, window=window)
    again = port_fa.flash_bwd(*args, causal=causal, window=window)
    for g, a, name in zip(got, again, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        assert torch.equal(g, a), f"the port's {name} differs between runs"
        np.testing.assert_allclose(g.numpy(), ref[name], **TOL)


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

"""The port's attention ops held against the JAX package's.

Each kernel's plain PyTorch version — what the wrappers run on CPU
tensors — against the JAX function it replaces, on the same numpy
inputs in float32. Tolerance 1e-5 abs/rel: the two frameworks sum in
different orders. The JAX flash forward runs in interpret mode, as the
JAX package itself runs it off a TPU, in a fresh interpreter of its own
on one XLA thread, twice there and bit for bit, as
``tests/test_torch_flash_bwd.py`` runs the backward: inside a full
parallel test run it once disagreed with the port by up to 5.7e-5 on 53
of 8192 elements, and agreed alone.

The kernels themselves only run on the card: tests/test_torch_kernels_gpu.py
holds them against these plain versions there.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.ops import attention as port_attn
from distributed_training_tpu_torch.ops import flash_attention as port_fa
from distributed_training_tpu_torch.ops import paged_attention as port_pa

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.ops import attention as jax_attn  # noqa: E402
from distributed_training_tpu.ops import paged_attention as jax_pa  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, B, H, Hkv, S, D, Sk=None):
    Sk = Sk or S
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32))


FWD_CASES = {"causal": (True, 0), "window": (True, 40),
             "noncausal": (False, 0)}
# The JAX side of test_flash_plain_matches_jax_flash_fwd_interpret, every
# case, run as ``python -c _FWD_REFERENCE <inputs.npz> <out.npz>``.
_FWD_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from distributed_training_tpu.ops import flash_attention as jax_fa
src, dst = sys.argv[1:]
x = np.load(src)
out = {}
for name, causal, window in zip(x["names"], x["causal"], x["window"]):
    runs = [[np.asarray(a) for a in jax_fa._flash_fwd(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v")), causal=bool(causal),
        block_q=64, block_k=32, window=int(window))] for _ in range(2)]
    for a, b in zip(*runs):
        assert np.array_equal(a, b), "the JAX reference differs between runs"
    out[f"{name}_o"], out[f"{name}_lse"] = runs[0]
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def flash_fwd_reference(tmp_path_factory):
    """(q, k, v) and the JAX forward's (O, lse) by case name."""
    q, k, v = _qkv(np.random.default_rng(1), 1, 4, 2, 128, 16)
    tmp = tmp_path_factory.mktemp("flash_fwd")
    src, dst = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(src, q=q, k=k, v=v, names=list(FWD_CASES),
             causal=[c for c, _ in FWD_CASES.values()],
             window=[w for _, w in FWD_CASES.values()])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    subprocess.run([sys.executable, "-c", _FWD_REFERENCE, str(src),
                    str(dst)], env=env, check=True, timeout=300)
    return (q, k, v), dict(np.load(dst))


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_flash_plain_matches_jax_flash_fwd_interpret(case,
                                                     flash_fwd_reference):
    """B1's plain version (O and lse) against the JAX ``_flash_fwd``
    Pallas kernel in interpret mode."""
    causal, window = FWD_CASES[case]
    (q, k, v), ref = flash_fwd_reference
    po, pl = port_fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window)
    np.testing.assert_allclose(po.numpy(), ref[f"{case}_o"], **TOL)
    np.testing.assert_allclose(pl.numpy(), ref[f"{case}_lse"], **TOL)


@pytest.mark.parametrize("H,Hkv,Sq,Sk,causal,window", [
    (4, 2, 24, 24, True, 0), (4, 4, 24, 24, True, 5),
    (4, 1, 8, 24, True, 0), (6, 3, 24, 24, False, 0)],
    ids=["gqa", "window", "offset", "noncausal"])
def test_naive_attention_matches_jax(H, Hkv, Sq, Sk, causal, window):
    """``_naive_attention`` (incl. the Sk - Sq offset and the window)
    and, where the flash gate's shapes apply, B1's plain version."""
    q, k, v = _qkv(np.random.default_rng(2), 2, H, Hkv, Sq, 8, Sk)
    t = (0, 2, 1, 3)  # bhsd <-> bshd
    want = np.asarray(jax_attn._naive_attention(
        jnp.asarray(q.transpose(t)), jnp.asarray(k.transpose(t)),
        jnp.asarray(v.transpose(t)), causal=causal, window=window))
    got = port_attn._naive_attention(
        torch.from_numpy(q.transpose(t)), torch.from_numpy(k.transpose(t)),
        torch.from_numpy(v.transpose(t)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain, _ = port_fa.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    np.testing.assert_allclose(plain.numpy().transpose(t), want, **TOL)


def test_dot_product_attention_on_cpu_never_launches_a_kernel():
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
               for x in _qkv(np.random.default_rng(3), 1, 4, 2, 128, 16))
    before = port_fa.flash_fwd.launches
    for impl in ("auto", "flash", "naive"):
        out = port_attn.dot_product_attention(q, k, v, impl=impl)
        np.testing.assert_allclose(
            out.numpy(), port_attn._naive_attention(q, k, v).numpy(), **TOL)
    assert port_fa.flash_fwd.launches == before
    # Sequence-parallel attention is the model's (parallel/), not this
    # dispatcher's: it refuses "ring" as the JAX one does.
    with pytest.raises(ValueError, match="unknown attention impl 'ring'"):
        port_attn.dot_product_attention(q, k, v, impl="ring")


def _paged_case(rng, B, H, Hkv, hd, ps, P, lengths):
    """Pools whose pages are deliberately shuffled, built the way
    tests/test_serving.py builds them."""
    N = 1 + B * P
    k_pages = np.zeros((Hkv, N, ps, hd), np.float32)
    v_pages = np.zeros((Hkv, N, ps, hd), np.float32)
    tables = np.zeros((B, P), np.int32)
    dense_k = rng.standard_normal((B, P * ps, Hkv, hd)).astype(np.float32)
    dense_v = rng.standard_normal((B, P * ps, Hkv, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N))
    pi = 0
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            pid = int(perm[pi])
            pi += 1
            tables[b, j] = pid
            chunk = slice(j * ps, (j + 1) * ps)
            k_pages[:, pid] = dense_k[b, chunk].transpose(1, 0, 2)
            v_pages[:, pid] = dense_v[b, chunk].transpose(1, 0, 2)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    return q, k_pages, v_pages, tables


@pytest.mark.parametrize("H,Hkv,hd,ps", [(4, 2, 16, 8), (6, 3, 24, 5),
                                         (4, 4, 8, 16)],
                         ids=["gqa", "odd-page", "mha"])
def test_paged_decode_plain_matches_jax(H, Hkv, hd, ps):
    """B4's plain version against JAX ``paged_attention(impl="ref")``
    on shuffled pages with ragged lengths, one of them 0."""
    lengths = np.asarray([5, 0, 17, 32], np.int32)
    q, kp, vp, tables = _paged_case(np.random.default_rng(4), 4, H, Hkv,
                                    hd, ps, -(-32 // ps), lengths)
    want = np.asarray(jax_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(tables), impl="ref"))
    args = [torch.from_numpy(x) for x in (q, kp, vp, lengths, tables)]
    before = port_pa.paged_attention.launches
    for impl in ("auto", "ref"):
        got = port_pa.paged_attention(*args, impl=impl).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert not got[1].any(), "a length-0 row must be zeros"
    assert port_pa.paged_attention.launches == before
    with pytest.raises(ValueError):
        port_pa.paged_attention(*args, impl="kernel")


def test_paged_attention_chunk_matches_jax():
    rng = np.random.default_rng(5)
    lengths = np.asarray([12, 20, 3], np.int32)
    _, kp, vp, tables = _paged_case(rng, 3, 4, 2, 16, 8, 3, lengths)
    q = rng.standard_normal((3, 6, 4, 16)).astype(np.float32)
    qpos = np.asarray([[6, 7, 8, 9, 10, 11], [14, 15, 16, 17, 18, 19],
                       [0, 1, 2, -1, -1, -1]], np.int32)
    want = np.asarray(jax_pa.paged_attention_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(qpos)))
    got = port_pa.paged_attention_chunk(
        *(torch.from_numpy(x) for x in (q, kp, vp, tables, qpos)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _fake(shape, dtype=torch.float32, cuda=True):
    """Shape/dtype/device stand-in for the gates (no card here)."""
    return SimpleNamespace(shape=shape, dtype=dtype, is_cuda=cuda)


@pytest.mark.parametrize("q,k,ok", [
    (_fake((2, 256, 12, 64)), _fake((2, 256, 12, 64)), True),
    (_fake((2, 256, 12, 64), torch.bfloat16), _fake((2, 256, 4, 64)), True),
    (_fake((2, 256, 12, 64), cuda=False), _fake((2, 256, 12, 64)), False),
    (_fake((2, 256, 12, 64), torch.float16), _fake((2, 256, 12, 64)), False),
    (_fake((2, 64, 12, 64)), _fake((2, 64, 12, 64)), False),
    (_fake((2, 160, 12, 64)), _fake((2, 160, 12, 64)), False),
    (_fake((2, 256, 12, 64)), _fake((2, 128, 12, 64)), False),
    (_fake((2, 256, 4, 320)), _fake((2, 256, 4, 320)), False),
    (_fake((2, 256, 12, 64)), _fake((2, 256, 5, 64)), False)],
    ids=["mha", "gqa-bf16", "cpu", "fp16", "short", "ragged", "sq!=sk",
         "wide-head", "heads"])
def test_flash_supported_gate(q, k, ok):
    """The JAX gate with ``is_cuda`` for the TPU check: f32/bf16,
    Sq == Sk, S >= 128, tiles dividing S, D <= 256, H % Hkv == 0."""
    assert port_fa.supported(q, k, k) is ok


@pytest.mark.parametrize("q,pool,ok", [
    (_fake((8, 12, 64)), _fake((12, 513, 16, 64)), True),
    (_fake((8, 12, 8), torch.bfloat16),
     _fake((4, 9, 5, 8), torch.bfloat16), True),
    (_fake((8, 12, 64), cuda=False), _fake((12, 9, 16, 64)), False),
    (_fake((8, 12, 60)), _fake((12, 9, 16, 60)), False),
    (_fake((8, 12, 264)), _fake((12, 9, 16, 264)), False),
    (_fake((8, 12, 64), torch.float16),
     _fake((12, 9, 16, 64), torch.float16), False),
    (_fake((8, 12, 64)), _fake((5, 9, 16, 64)), False)],
    ids=["gpt2", "gqa-any-page", "cpu", "hd%8", "wide", "fp16", "heads"])
def test_paged_kernel_supported_gate(q, pool, ok):
    """hd <= 256 in multiples of 8, any page size, f32/bf16 — no TPU
    ``hd % 128`` or ``ps % 16`` rule (gpt2_125m has hd 64)."""
    assert port_pa.kernel_supported(q, pool) is ok

"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test decides at run time whether a card is there
and skips without one. On a machine with a card run

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

(no JAX needed). Tolerances: 2e-2 for bf16 (output rounding, one bf16
ulp is 2**-7 relative, plus summation order), 1e-4 for f32 (summation
order). The backward kernels' gradients are held with the same
tolerances relative to each gradient's largest magnitude: dq sums over
up to S keys, and the fused kernel's atomic dq sums in an order that
changes from run to run. Each case also checks that the launch took the
design ``_design`` names (bf16 at head dim 64/128: the tensor-core
kernels; the rest: the SIMT kernels). The split kernels use no atomics:
two launches give the same bits.

f32 gradients of bf16 inputs: 1e-4 of the largest gradient on the SIMT
kernels at head dim 96, which sum the logits in the plain version's
order there; 1e-3 on the tensor-core kernels (fused and split), which
sum them in another: p and ds are rounded to bf16 at the same points,
but a value on a rounding boundary may round the other way, and the
plain version against itself with the head-dim sum permuted already
moves these gradients past 1e-4 (tests/test_torch_flash_design.py). The
plain version's gradients rounded to bf16 (half a bf16 ulp, 2e-3 or more
of the largest) fail it.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu_torch.ops import flash_attention as fa
from distributed_training_tpu_torch.ops import paged_attention as pa
from distributed_training_tpu_torch.serving.engine import (
    Engine,
    EngineConfig,
)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
WGMMA_GRADS_F32_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,S,D,causal,window,block_k", [
    (8, 4, 256, 64, True, 100, 64), (4, 4, 128, 16, False, 0, 32),
    (4, 2, 192, 256, True, 0, 64), (12, 12, 1024, 64, True, 0, 64)])
def test_flash_fwd_matches_plain(cuda, dtype, H, Hkv, S, D, causal,
                                 window, block_k):
    q = torch.randn(2, H, S, D, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(2, Hkv, S, D, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(2, Hkv, S, D, generator=cuda, device="cuda").to(dtype)
    before = fa.flash_fwd.launches
    design = fa._design(dtype, D)
    by_design = fa.flash_fwd.launches_by_design[design]
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window,
                          block_k=block_k)
    ro, rl = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    assert fa.flash_fwd.launches == before + 1
    assert fa.flash_fwd.launches_by_design[design] == by_design + 1
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,Hkv,Sq,Sk,D,causal,window,out_dtype", [
    (4, 4, 200, 200, 64, True, 0, None),
    (8, 2, 300, 300, 128, True, 0, None),
    (4, 2, 256, 256, 128, True, 70, None),
    (4, 4, 100, 260, 64, False, 0, None),
    (4, 1, 192, 192, 64, True, 33, torch.float32),
    (16, 16, 1024, 1024, 128, True, 0, torch.float32)],
    ids=["ragged", "gqa-d128-ragged", "window-d128", "noncausal-sq-sk",
         "f32-out-window-gqa", "d128-long-f32-out"])
def test_flash_fwd_wgmma_route(cuda, H, Hkv, Sq, Sk, D, causal, window,
                               out_dtype):
    """The tensor-core forward on bf16: GQA, window, non-causal Sq != Sk,
    lengths that are not a multiple of its 64-row tile, f32 output."""
    bf16 = torch.bfloat16
    q = torch.randn(2, H, Sq, D, generator=cuda, device="cuda").to(bf16)
    k = torch.randn(2, Hkv, Sk, D, generator=cuda, device="cuda").to(bf16)
    v = torch.randn(2, Hkv, Sk, D, generator=cuda, device="cuda").to(bf16)
    before = dict(fa.flash_fwd.launches_by_design)
    kw = dict(causal=causal, window=window, out_dtype=out_dtype)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rl = fa.flash_fwd_reference(q, k, v, **kw)
    assert fa.flash_fwd.launches_by_design == dict(
        before, wgmma=before["wgmma"] + 1)
    assert o.dtype == (out_dtype or bf16)
    tol = TOL[bf16]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,hd,ps", [(12, 12, 64, 16), (8, 2, 128, 7),
                                         (4, 1, 256, 16), (6, 3, 24, 5)])
def test_paged_decode_matches_plain(cuda, dtype, H, Hkv, hd, ps):
    rng = np.random.default_rng(1)
    B, max_len = 6, 300
    lengths = rng.integers(1, max_len, size=B).astype(np.int32)
    lengths[2] = 0
    P = -(-max_len // ps)
    N = 1 + B * P
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = perm[used:used + n]
        used += n
    kp = torch.randn(Hkv, N, ps, hd, generator=cuda, device="cuda").to(dtype)
    vp = torch.randn(Hkv, N, ps, hd, generator=cuda, device="cuda").to(dtype)
    q = torch.randn(B, H, hd, generator=cuda, device="cuda").to(dtype)
    args = (q, kp, vp, torch.from_numpy(lengths).cuda(),
            torch.from_numpy(tables).cuda())
    out = pa.paged_attention(*args)
    ref = pa.paged_attention(*args, impl="ref")
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert out[2].abs().max().item() == 0.0


@pytest.mark.parametrize("mode,chunk", [("batched", 16),
                                        ("sequential", 128)])
def test_engine_greedy_matches_dense_on_gpu(cuda, mode, chunk):
    """float32 end to end on the card: both kernels on the engine's
    path, tokens equal to the dense full-context greedy."""
    model = Transformer(TransformerConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        max_seq_len=512, pos_encoding="rope", tie_embeddings=False,
        dtype="float32"))
    params = model.init(cuda)
    eng = Engine(model, params, EngineConfig(
        max_batch=4, page_size=16, num_pages=64, max_seq_len=256,
        prefill_chunk=chunk, prefill_mode=mode))
    prompt = np.random.default_rng(2).integers(0, 512, 140).astype(np.int32)
    f0, p0 = fa.flash_fwd.launches, pa.paged_attention.launches
    got = eng.generate(prompt, 8)
    ids, want = prompt.tolist(), []
    for _ in range(8):
        logits, _ = model.apply(params, torch.tensor([ids]))
        want.append(int(torch.argmax(logits[0, -1])))
        ids.append(want[-1])
    assert got == want
    assert pa.paged_attention.launches > p0
    assert (fa.flash_fwd.launches > f0) is (mode == "sequential")


def _bwd_inputs(cuda, B, H, Hkv, S, D, dtype, causal, window):
    q = torch.randn(B, H, S, D, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=cuda, device="cuda").to(dtype)
    do = torch.randn(B, H, S, D, generator=cuda, device="cuda").to(dtype)
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    return q, k, v, out, lse, do


def _rel_err(got, want):
    scale = max(want.float().abs().max().item(), 1.0)
    return (got.float() - want.float()).abs().max().item() / scale


def _close(got, want, tol):
    err = _rel_err(got, want)
    assert err <= tol, f"max err {err} of the largest > {tol}"


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,S,D,causal,window", [
    (8, 4, 256, 64, True, 100), (4, 4, 128, 16, False, 0),
    (4, 2, 192, 256, True, 0), (12, 12, 1024, 64, True, 0),
    (4, 1, 256, 128, True, 0)])
def test_flash_bwd_matches_plain(cuda, monkeypatch, split, dtype, H, Hkv,
                                 S, D, causal, window):
    """B2 (fused) and B3a/B3b (split) against flash_bwd_reference."""
    monkeypatch.setattr(fa, "FORCE_SPLIT_BWD", split)
    q, k, v, out, lse, do = _bwd_inputs(cuda, 2, H, Hkv, S, D, dtype,
                                        causal, window)
    wrappers = (fa.flash_bwd_fused, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    counts = [f.launches for f in wrappers]
    design = fa._design(dtype, D)
    by_design = [f.launches_by_design[design] for f in wrappers]
    got = fa.flash_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                  window=window)
    moved = (0, 1, 1) if split else (1, 0, 0)
    assert tuple(f.launches - n for f, n in zip(wrappers, counts)) == moved
    assert tuple(f.launches_by_design[design] - n
                 for f, n in zip(wrappers, by_design)) == moved
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("H,Hkv,Sq,Sk,D,causal,window,grads_dtype", [
    (4, 4, 200, 200, 64, True, 0, None),
    (8, 2, 300, 300, 128, True, 90, None),
    (4, 2, 192, 192, 128, True, 0, torch.float32),
    (4, 4, 100, 260, 64, False, 0, None),
    (4, 1, 256, 256, 64, True, 50, torch.float32),
    (16, 16, 1024, 1024, 128, True, 0, None)],
    ids=["ragged", "gqa-window-d128-ragged", "gqa-d128-f32-grads",
         "noncausal-sq-sk", "gqa-window-f32-grads", "d128-long"])
def test_flash_bwd_fused_wgmma_route(cuda, H, Hkv, Sq, Sk, D, causal,
                                     window, grads_dtype):
    """The tensor-core fused backward on bf16: GQA, window, lengths that
    are not a multiple of its 64-row tiles, non-causal Sq != Sk, f32
    gradients; dq through its vector reductions."""
    bf16 = torch.bfloat16
    q = torch.randn(2, H, Sq, D, generator=cuda, device="cuda").to(bf16)
    k = torch.randn(2, Hkv, Sk, D, generator=cuda, device="cuda").to(bf16)
    v = torch.randn(2, Hkv, Sk, D, generator=cuda, device="cuda").to(bf16)
    do = torch.randn(2, H, Sq, D, generator=cuda, device="cuda").to(bf16)
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta)
    kw = dict(causal=causal, window=window, grads_dtype=grads_dtype)
    before = dict(fa.flash_bwd_fused.launches_by_design)
    got = fa.flash_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_bwd_fused.launches_by_design == dict(
        before, wgmma=before["wgmma"] + 1)
    want = fa.flash_bwd_reference(q, k, v, None, lse, do, delta=delta, **kw)
    tol = TOL[bf16] if grads_dtype is None else WGMMA_GRADS_F32_TOL
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == (grads_dtype or bf16)
        assert g.shape == w.shape
        _close(g, w, tol)
    if grads_dtype is not None:
        # The control: gradients rounded to bf16 fail the limit.
        assert max(_rel_err(w.to(bf16), w) for w in want) > tol


@pytest.mark.parametrize("H,Hkv,Sq,Sk,D,causal,window,grads_dtype", [
    (4, 4, 200, 200, 64, True, 0, None),
    (8, 2, 300, 300, 128, True, 90, None),
    (4, 2, 192, 192, 128, True, 0, torch.float32),
    (4, 4, 100, 260, 64, False, 0, None),
    (4, 1, 256, 256, 64, True, 50, torch.float32),
    (16, 16, 1024, 1024, 128, True, 0, None),
    (8, 2, 1000, 1000, 128, True, 300, torch.float32)],
    ids=["ragged", "gqa-window-d128-ragged", "gqa-d128-f32-grads",
         "noncausal-sq-sk", "gqa-window-f32-grads", "d128-long",
         "gqa-window-ragged-d128-f32-grads"])
def test_flash_bwd_split_wgmma_route(cuda, H, Hkv, Sq, Sk, D, causal,
                                     window, grads_dtype):
    """The tensor-core split backward on bf16 (B3a dq, B3b dk/dv): GQA,
    window, lengths that are not a multiple of its 64-row tiles,
    non-causal Sq != Sk, f32 gradients; each kernel gives the same bits
    on a second launch."""
    bf16 = torch.bfloat16
    q = torch.randn(2, H, Sq, D, generator=cuda, device="cuda").to(bf16)
    k = torch.randn(2, Hkv, Sk, D, generator=cuda, device="cuda").to(bf16)
    v = torch.randn(2, Hkv, Sk, D, generator=cuda, device="cuda").to(bf16)
    do = torch.randn(2, H, Sq, D, generator=cuda, device="cuda").to(bf16)
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta)
    kw = dict(causal=causal, window=window, grads_dtype=grads_dtype)
    before = [dict(f.launches_by_design)
              for f in (fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    again = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    for f, b in zip((fa.flash_bwd_dq, fa.flash_bwd_dkv), before):
        assert f.launches_by_design == dict(b, wgmma=b["wgmma"] + 2)
    want = fa.flash_bwd_reference(q, k, v, None, lse, do, delta=delta, **kw)
    tol = TOL[bf16] if grads_dtype is None else WGMMA_GRADS_F32_TOL
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype == (grads_dtype or bf16)
        assert g.shape == w.shape
        _close(g, w, tol)
        assert torch.equal(g, a), "a second launch gave other bits"
    if grads_dtype is not None:
        # The control: gradients rounded to bf16 fail the limit.
        assert max(_rel_err(w.to(bf16), w) for w in want) > tol


def test_flash_bwd_hooks_delta_and_grads_dtype(cuda, monkeypatch):
    """The ring callers' hooks: a precomputed delta with out=None, and
    f32 gradients from bf16 inputs, on every kernel: split and fused on
    the tensor cores at head dim 64 (1e-3), split and fused on SIMT at
    head dim 96 (1e-4)."""
    for D, split, tol in ((64, True, WGMMA_GRADS_F32_TOL),
                          (64, False, WGMMA_GRADS_F32_TOL),
                          (96, True, 1e-4), (96, False, 1e-4)):
        q, k, v, out, lse, do = _bwd_inputs(cuda, 2, 8, 2, 256, D,
                                            torch.bfloat16, True, 0)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        want = fa.flash_bwd_reference(q, k, v, None, lse, do, causal=True,
                                      delta=delta, grads_dtype=torch.float32)
        monkeypatch.setattr(fa, "FORCE_SPLIT_BWD", split)
        wrappers = ((fa.flash_bwd_dq, fa.flash_bwd_dkv) if split
                    else (fa.flash_bwd_fused,))
        design = fa._design(torch.bfloat16, D)
        before = [dict(f.launches_by_design) for f in wrappers]
        got = fa.flash_bwd(q, k, v, None, lse, do, causal=True, delta=delta,
                           grads_dtype=torch.float32)
        for f, b in zip(wrappers, before):
            assert f.launches_by_design == dict(b, **{design: b[design] + 1})
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g, w, tol)
        if tol == WGMMA_GRADS_F32_TOL:
            assert max(_rel_err(w.to(torch.bfloat16), w) for w in want) > tol


def test_flash_attention_autograd_on_gpu(cuda):
    """The autograd Function: one forward launch, one backward launch,
    gradients equal to the naive attention's in f32."""
    from distributed_training_tpu_torch.ops.attention import _naive_attention
    x = [torch.randn(2, 256, h, 32, generator=cuda, device="cuda",
                     requires_grad=True) for h in (8, 2, 2)]
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd_fused.launches
    out = fa.flash_attention(*x, causal=True, window=50)
    g = torch.randn(out.shape, generator=cuda, device="cuda")
    got = torch.autograd.grad(out, x, g)
    assert (fa.flash_fwd.launches - f0, fa.flash_bwd_fused.launches - b0) \
        == (1, 1)
    ref = _naive_attention(*x, causal=True, window=50)
    want = torch.autograd.grad(ref, x, g)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)

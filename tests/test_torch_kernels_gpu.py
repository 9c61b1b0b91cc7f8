"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test decides at run time whether a card is there
and skips without one. On a machine with a card run

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

(no JAX needed). Tolerances: 2e-2 for bf16 (output rounding, one bf16
ulp is 2**-7 relative, plus summation order), 1e-4 for f32 (summation
order).
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
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window,
                          block_k=block_k)
    ro, rl = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    assert fa.flash_fwd.launches == before + 1
    tol = TOL[dtype]
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

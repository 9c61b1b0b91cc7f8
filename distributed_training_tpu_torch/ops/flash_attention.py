"""Flash-attention forward on Hopper: the port of ``ops/flash_attention.py``.

``flash_fwd`` is the counterpart of the JAX package's ``_flash_fwd``: it
launches the hand-written CUDA kernel ``csrc/flash_fwd.cu`` (which
replaces the Pallas ``_fwd_kernel``) on CUDA tensors and runs
``flash_fwd_reference``, its plain PyTorch version, on CPU tensors. For a
CUDA tensor it launches the kernel or raises; there is no fallback.

Layout contract as in the JAX package: the public ``flash_attention``
takes (B, S, H, D) or, with ``layout="bhsd"``, the kernel's own
(B, H, S, D); GQA keeps K/V at Hkv heads (q-head h reads kv-head
h // (H / Hkv)). Only the forward is ported in this slice: the backward
kernels and the autograd wrapper wait for the training slice
(ROADMAP.md queue B).
"""

from __future__ import annotations

import ctypes

import torch

from distributed_training_tpu_torch.kernels import build

# Hopper tiles. The kernel's q-tile is fixed at 64 rows (four threads
# per row, 256 threads); the k-tile is a template choice. Both were
# timed on the card by chip_smoke.py (PERF.md); unlike the TPU's VMEM
# the 227 KB of shared memory holds a 64 x 64 f32 logits tile plus the
# q/k/v tiles at head_dim <= 256.
BLOCK_Q = 64
BLOCK_K_CHOICES = (64, 32)
DEFAULT_BLOCK_K = 64
NO_KEY_LSE = -1e30    # lse of a row with no live key (as the TPU kernel)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def default_blocks(seq_q: int, seq_k: int,
                   head_dim: int) -> tuple[int, int]:
    """The kernel's tiles. Unlike the TPU defaults they do not grow with
    the sequence: the q-tile is a kernel constant and the k-tile the
    measured default."""
    del seq_q, seq_k, head_dim
    return BLOCK_Q, DEFAULT_BLOCK_K


def _resolve_blocks(block_q: int, block_k: int, seq_q: int, seq_k: int,
                    head_dim: int) -> tuple[int, int]:
    """Effective tiles: explicit overrides win; zeros take the defaults."""
    dq, dk = default_blocks(seq_q, seq_k, head_dim)
    return (block_q or dq, block_k or dk)


def _tiles_ok(bq: int, bk: int) -> bool:
    return bq == BLOCK_Q and bk in BLOCK_K_CHOICES


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block_q: int = 0, block_k: int = 0,
              layout: str = "bshd") -> bool:
    """Should auto-dispatch route here? (Else: naive.)

    The JAX gate with ``q.is_cuda`` in place of its TPU-platform check:
    f32/bf16, Sq == Sk, S >= 128, tiles that divide the sequences,
    head_dim <= 256, H divisible by Hkv."""
    del v
    s_ax, h_ax = (2, 1) if layout == "bhsd" else (1, 2)
    if not q.is_cuda:
        return False
    if q.dtype not in _DTYPE_CODE:
        return False
    if q.shape[s_ax] != k.shape[s_ax]:
        return False
    if q.shape[s_ax] < 128:
        return False
    bq, bk = _resolve_blocks(block_q, block_k, q.shape[s_ax],
                             k.shape[s_ax], q.shape[3])
    if not _tiles_ok(bq, bk) or q.shape[s_ax] % bq or k.shape[s_ax] % bk:
        return False
    if q.shape[3] > 256:
        return False
    if q.shape[h_ax] % k.shape[h_ax]:
        return False
    return True


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        out_dtype: torch.dtype | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: naive attention in (B, H, S, D)
    that also returns the per-row logsumexp (B, H, S, 1) in f32. f32
    logits and softmax; the weights are rounded to v.dtype before the
    value product, as the TPU kernel and ``_naive_attention`` do. A row
    with no live key gives zeros and lse ``NO_KEY_LSE``."""
    out_dtype = out_dtype or q.dtype
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, S, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                          k.float()) * D ** -0.5
    if causal:
        rows = torch.arange(S, device=q.device)[:, None] + (Sk - S)
        cols = torch.arange(Sk, device=q.device)[None, :]
        live = cols <= rows
        if window > 0:
            live = live & (cols >= rows - (window - 1))
        logits = logits.masked_fill(~live, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    has = torch.isfinite(lse)
    probs = torch.exp(logits - torch.where(has, lse, 0.0))
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(),
                       v.float())
    out = out.reshape(B, H, S, D).to(out_dtype)
    lse = torch.where(has, lse, NO_KEY_LSE).reshape(B, H, S, 1)
    return out, lse


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_fwd")
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, block_q: int = 0, block_k: int = 0,
              out_dtype: torch.dtype | None = None, window: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, S, D); k/v (B, Hkv, Sk, D) → (out (B, H, S, D) in
    ``out_dtype`` (default q.dtype), lse (B, H, S, 1) f32).

    CPU tensors run ``flash_fwd_reference``. CUDA tensors launch the
    kernel on the current stream (``flash_fwd.launches`` counts those
    launches) or raise if it cannot take them."""
    out_dtype = out_dtype or q.dtype
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, causal=causal, window=window,
                                   out_dtype=out_dtype)
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    bq, bk = _resolve_blocks(block_q, block_k, S, Sk, D)
    if not _tiles_ok(bq, bk):
        raise ValueError(
            f"flash kernel tiles ({bq}, {bk}) unsupported: block_q must be "
            f"{BLOCK_Q} and block_k one of {BLOCK_K_CHOICES}")
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.shape[0] != B or t.shape[3] != D:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernel takes f32/bf16, got {q.dtype} -> "
                         f"{out_dtype}")
    if q.dtype == torch.float32 and out_dtype != torch.float32:
        raise ValueError("f32 inputs give f32 output")
    if H % Hkv or D > 256:
        raise ValueError(f"unsupported heads/head_dim: H={H} Hkv={Hkv} "
                         f"D={D}")
    if causal and S != Sk:
        raise ValueError(f"causal flash needs Sq == Sk, got {S} vs {Sk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, H, S, D), dtype=out_dtype, device=q.device)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
    lib = _lib()
    code = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, S, Sk, D, int(causal), int(window),
        bk, D ** -0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_fwd", code)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 0,
                    block_k: int = 0, window: int = 0,
                    layout: str = "bshd") -> torch.Tensor:
    """Flash attention over (B, S, H, D) inputs (GQA allowed), forward
    only. ``window`` > 0 = sliding-window attention (query i attends keys
    in [i - window + 1, i]); requires ``causal``. ``layout="bhsd"``:
    inputs and output in the kernel's (B, H, S, D)."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown layout '{layout}'")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash backward kernels wait for ROADMAP.md queue B "
            "(B2/B3 and the autograd wrapper)")
    native = layout == "bhsd"
    s_ax, h_ax = (2, 1) if native else (1, 2)
    S, Sk = q.shape[s_ax], k.shape[s_ax]
    H, Hkv = q.shape[h_ax], k.shape[h_ax]
    if S != Sk and causal:
        raise ValueError(
            f"flash kernel's causal mask requires Sq == Sk, got {S} vs "
            f"{Sk}; use impl='naive'")
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    bq, bk = _resolve_blocks(block_q, block_k, S, Sk, q.shape[3])
    if not _tiles_ok(bq, bk) or S % bq or Sk % bk:
        raise ValueError(
            f"sequence lengths ({S}, {Sk}) must be divisible by block "
            f"sizes ({bq}, {bk}) of the kernel; pad or use impl='naive'")
    if native:
        return flash_fwd(q, k, v, causal=causal, block_q=bq, block_k=bk,
                         window=window)[0]

    def t(x):
        return x.transpose(1, 2)

    out, _ = flash_fwd(t(q), t(k), t(v), causal=causal, block_q=bq,
                       block_k=bk, window=window)
    return t(out)

"""Paged attention over the serving KV pool (port of ``ops/paged_attention.py``).

Pool layout per layer: ``k_pages``/``v_pages`` of shape
``(n_kv_heads, num_pages, page_size, head_dim)``; a sequence's
``page_indices`` row maps logical page ``j`` to a physical page, and
logical position ``p`` is slot ``p % page_size`` of logical page
``p // page_size``.

Two entry points, as in the JAX package:

- ``paged_attention`` — single-token decode. On CUDA tensors it launches
  the hand-written kernel ``csrc/paged_decode.cu`` (which replaces the
  TPU Pallas paged-attention kernel) or raises; on CPU tensors it runs
  ``paged_attention_reference``, the gather-and-mask plain version.
- ``paged_attention_chunk`` — the multi-query (prefill-chunk) form. It is
  gather code in the JAX package too, with no kernel, and stays plain
  PyTorch here.

Numerics contract of ops/attention.py: f32 logits and softmax, output in
q.dtype, GQA via hkv-major grouping, all-masked rows give zeros.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_training_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def kernel_supported(q: torch.Tensor, k_pages: torch.Tensor,
                     page_size: int | None = None) -> bool:
    """Can single-token decode launch the CUDA kernel?

    CUDA tensors, f32 or bf16, head_dim <= 256 in multiples of 8, any
    page size, H divisible by Hkv. The TPU gate's ``head_dim % 128`` and
    ``page_size % 16`` rules come from the TPU's 128-lane tiling and the
    Pallas kernel's DMA blocks; the Hopper kernel has neither."""
    del page_size
    head_dim = q.shape[-1]
    if not (q.is_cuda and k_pages.is_cuda):
        return False
    if head_dim > 256 or head_dim % 8:
        return False
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype:
        return False
    return q.shape[1] % k_pages.shape[0] == 0


def _gather_pages(pages: torch.Tensor,
                  page_indices: torch.Tensor) -> torch.Tensor:
    """(Hkv, N, ps, hd) pool + (B, P) tables → (B, P*ps, Hkv, hd) dense
    per-sequence KV, logical order."""
    Hkv, _N, ps, hd = pages.shape
    B, P = page_indices.shape
    g = pages[:, page_indices.long()]        # (Hkv, B, P, ps, hd)
    return g.permute(1, 2, 3, 0, 4).reshape(B, P * ps, Hkv, hd)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      visible: torch.Tensor) -> torch.Tensor:
    """GQA attention with an explicit visibility mask.

    q (B, S, H, hd); k/v (B, Sk, Hkv, hd); visible (B, S, Sk) bool. f32
    logits and softmax, output in q.dtype. Rows with zero visible keys
    produce zeros, not NaN."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    group = H // Hkv
    qg = q.reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bshgd,bkhd->bhgsk", qg.float(), k.float())
    logits = logits * (hd ** -0.5)
    neg = torch.finfo(torch.float32).min
    logits = logits.masked_fill(~visible[:, None, None], neg)
    probs = torch.softmax(logits, dim=-1)
    any_visible = visible.any(dim=-1)                # (B, S)
    probs = torch.where(any_visible[:, None, None, :, None], probs, 0.0)
    out = torch.einsum("bhgsk,bkhd->bshgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor,
                          page_indices: torch.Tensor,
                          q_positions: torch.Tensor) -> torch.Tensor:
    """Multi-query paged attention (prefill chunks), plain PyTorch.

    q (B, S, H, hd); pools (Hkv, N, ps, hd); page_indices (B, P);
    q_positions (B, S) int — each query's absolute position. Query
    (b, s) attends logical positions ``<= q_positions[b, s]`` of
    sequence b (the chunk's own KV must already be in the pool).
    Negative q_positions mark padding queries (zero output)."""
    kd = _gather_pages(k_pages, page_indices)
    vd = _gather_pages(v_pages, page_indices)
    Sk = kd.shape[1]
    slot = torch.arange(Sk, device=q.device)
    qp = q_positions[:, :, None]
    visible = (slot[None, None, :] <= qp) & (qp >= 0)
    return _masked_attention(q, kd, vd, visible)


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              lengths: torch.Tensor,
                              page_indices: torch.Tensor) -> torch.Tensor:
    """The decode kernel's plain PyTorch version: gather the pages dense
    and mask by length (the JAX package's reference path)."""
    out = paged_attention_chunk(
        q[:, None], k_pages, v_pages, page_indices,
        (lengths.long() - 1)[:, None])
    return out[:, 0]


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    lib.paged_decode.restype = ctypes.c_int
    lib.paged_decode.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_indices: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Single-token decode attention against the paged pool.

    q (B, H, hd); pools (Hkv, N, ps, hd); lengths (B,) int32 — valid kv
    entries per sequence, the current token's included (0 = inactive
    slot, zero output); page_indices (B, P) int32. ``impl``: "auto" (the
    kernel for CUDA tensors, the plain version for CPU tensors),
    "kernel" (CUDA only), "ref" (the plain version on any device).
    ``paged_attention.launches`` counts kernel launches."""
    if impl not in ("auto", "kernel", "ref"):
        raise ValueError(f"unknown paged-attention impl '{impl}'")
    if impl == "ref" or (impl == "auto" and not q.is_cuda):
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                         page_indices)
    if not kernel_supported(q, k_pages):
        raise ValueError(
            f"paged decode kernel cannot take q {tuple(q.shape)} "
            f"{q.dtype} on {q.device} with pools {tuple(k_pages.shape)} "
            f"{k_pages.dtype} on {k_pages.device}")
    B, H, hd = q.shape
    Hkv, N, ps, _ = k_pages.shape
    P = page_indices.shape[1]
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and "
                         "dtype")
    if k_pages.shape[3] != hd:
        raise ValueError(f"pool head_dim {k_pages.shape[3]} != q {hd}")
    if lengths.shape != (B,) or page_indices.shape[0] != B:
        raise ValueError("lengths (B,) and page_indices (B, P) must match "
                         f"q's batch {B}")
    for name, t in (("v_pages", v_pages), ("lengths", lengths),
                    ("page_indices", page_indices)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
    for name, t in (("lengths", lengths), ("page_indices", page_indices)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the pool layer "
                             "view the engine passes is)")
    q = q.contiguous()
    lengths, page_indices = lengths.contiguous(), page_indices.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        B, H, Hkv, N, ps, hd, P, hd ** -0.5, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "paged_decode", code)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

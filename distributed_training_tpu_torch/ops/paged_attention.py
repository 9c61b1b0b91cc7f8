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
  ``paged_attention_reference``, the gather-and-mask plain version. The
  kernel's design, ``split_kv``, cuts each sequence's KV walk into
  splits of whole pages (``split_kv_plan``, from shapes only), one block
  per (split, kv head, sequence), and a combine pass merges the splits'
  partial softmax results (FlashDecoding).
- ``paged_attention_chunk`` — the multi-query (prefill-chunk) form. It is
  gather code in the JAX package too, with no kernel, and stays plain
  PyTorch here.
- ``paged_decode_chain`` — the chunk form's contract for a decode chain
  (speculative verification, resident decode iterations): C queries a
  sequence at consecutive positions whose own KV is already written.
  Query c attends exactly the positions up to its own, which is
  single-token decode with ``length = position + 1``, so the chain
  flattens to S·C rows of ``paged_attention`` (the kernel on the card).

Numerics contract of ops/attention.py: f32 logits and softmax, output in
q.dtype, GQA via hkv-major grouping, all-masked rows give zeros.
"""

from __future__ import annotations

import ctypes
import functools
import math

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


def paged_decode_chain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_indices: torch.Tensor,
                       q_positions: torch.Tensor,
                       impl: str = "auto") -> torch.Tensor:
    """A decode chain through single-token decode.

    The arguments of ``paged_attention_chunk`` (its plain version): q
    (S, C, H, hd); page_indices (S, P) int32; q_positions (S, C) — each
    query's absolute position, negative for padding or dead positions.
    Every query becomes one row of ``paged_attention`` with its
    sequence's page row and ``length = q_position + 1`` (0 for padding:
    the kernel's zero-output rule), so the walk stops at the query's own
    position. No device value is read on the host."""
    S, C, H, hd = q.shape
    lengths = (q_positions + 1).clamp(min=0).reshape(S * C).int()
    rows = page_indices.repeat_interleave(C, dim=0)
    out = paged_attention(q.reshape(S * C, H, hd), k_pages, v_pages,
                          lengths, rows, impl=impl)
    return out.reshape(S, C, H, hd)


# The split-count rule of the split_kv design. A split is a whole number
# of pages holding about SPLIT_TOKENS tokens, and there are enough of
# them that B * Hkv * splits blocks fill the card's SMS streaming
# multiprocessors (H100 SXM) about BLOCKS_PER_SM times over when every
# sequence is full; the pages per split are rounded to a power of two,
# so that splits tile a table of a power of two of pages (every engine
# configuration's) with no short last split. Only shapes go in: reading
# ``lengths`` would cost a device-to-host sync on every decode step of
# every layer.
SMS = 132
BLOCKS_PER_SM = 6
SPLIT_TOKENS = (64, 256)


@functools.lru_cache(maxsize=64, typed=True)
def split_kv_plan(batch: int, n_kv_heads: int, pages_per_seq: int,
                  page_size: int) -> tuple[int, int]:
    """(splits, pages per split) of the decode kernel's KV walk.

    Split ``s`` of a sequence walks its logical pages ``[s * pages,
    (s + 1) * pages)``; ``splits * pages >= pages_per_seq`` and every
    split starts inside the table. Python ints only: a tensor here
    would mean a device read on the decode path (the cache is typed, so
    an int of another type misses it and raises)."""
    for name, x in (("batch", batch), ("n_kv_heads", n_kv_heads),
                    ("pages_per_seq", pages_per_seq),
                    ("page_size", page_size)):
        if type(x) is not int:
            raise TypeError(f"split_kv_plan takes Python ints, got {name}="
                            f"{x!r} ({type(x).__name__})")
        if x <= 0:
            raise ValueError(f"split_kv_plan: {name}={x} must be positive")
    lo = -(-SPLIT_TOKENS[0] // page_size)
    hi = max(lo, SPLIT_TOKENS[1] // page_size)
    want = -(-SMS * BLOCKS_PER_SM // (batch * n_kv_heads))
    pages = -(-pages_per_seq // want)
    pages = 1 << round(math.log2(pages))
    pages = min(max(pages, lo), hi)
    return -(-pages_per_seq // pages), pages


def workspace_numel(batch: int, n_heads: int, head_dim: int,
                    splits: int) -> int:
    """f32 elements of the combine's workspace: each (sequence, query
    head, split) keeps an unnormalised accumulator (head_dim) and its
    running max and sum (2). One split needs none: the kernel writes the
    output itself."""
    return batch * n_heads * splits * (head_dim + 2) if splits > 1 else 0


def _check_kernel_args(q, k_pages, v_pages, lengths, page_indices, out,
                       workspace, splits: int) -> None:
    """Everything the kernel assumes about its operands and cannot
    check itself, but what the wrapper makes so (q contiguous, out and
    the workspace fresh allocations); raises ValueError. (Runs on every
    decode launch, so the common case takes few Python steps.)"""
    B, H, hd = q.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and "
                         "dtype")
    if k_pages.shape[3] != hd:
        raise ValueError(f"pool head_dim {k_pages.shape[3]} != q {hd}")
    if lengths.shape != (B,) or page_indices.shape[0] != B:
        raise ValueError("lengths (B,) and page_indices (B, P) must match "
                         f"q's batch {B}")
    if not (q.device == v_pages.device == lengths.device
            == page_indices.device):
        raise ValueError(f"v_pages, lengths and page_indices must be on "
                         f"{q.device}")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError(f"lengths and page_indices must be int32, got "
                         f"{lengths.dtype} and {page_indices.dtype}")
    # The kernel copies whole pages and reads q in 16-byte vectors.
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("k_pages and v_pages must be contiguous (the pool "
                         "layer view the engine passes is)")
    ws_ptr = 0 if workspace is None else workspace.data_ptr()
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()
            | out.data_ptr() | ws_ptr) % 16:
        ops = {"q": q, "k_pages": k_pages, "v_pages": v_pages, "out": out,
               "workspace": workspace}
        bad = [n for n, t in ops.items()
               if t is not None and t.data_ptr() % 16]
        raise ValueError(f"{', '.join(bad)} must start on a 16-byte "
                         "boundary")
    need = workspace_numel(B, H, hd, splits)
    if need and (workspace is None or workspace.numel() < need
                 or workspace.dtype != torch.float32):
        have = 0 if workspace is None else workspace.numel()
        raise ValueError(f"workspace holds {have} elements, the combine "
                         f"of {splits} splits needs {need} float32")


_ENTRY = None


def _entry():
    """(library, C entry point) of the kernel, loaded (and built) on the
    first launch, its argument types declared once."""
    global _ENTRY
    if _ENTRY is None:
        lib = build.load("paged_decode")
        fn = lib.paged_decode
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _ENTRY = (lib, fn)
    return _ENTRY


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
    ``paged_attention.launches`` counts kernel launches and
    ``paged_attention.launches_by_design`` the same under the design's
    name. The kernel reads no device value on the host: the split count
    comes from shapes (``split_kv_plan``)."""
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
    q = q.contiguous()
    lengths, page_indices = lengths.contiguous(), page_indices.contiguous()
    B, H, hd = q.shape
    Hkv, N, ps, _ = k_pages.shape
    P = page_indices.shape[1]
    splits, pages = split_kv_plan(B, Hkv, P, ps)
    out = torch.empty_like(q)
    workspace = None
    if splits > 1:
        workspace = q.new_empty(workspace_numel(B, H, hd, splits),
                                dtype=torch.float32)
    _check_kernel_args(q, k_pages, v_pages, lengths, page_indices, out,
                       workspace, splits)
    lib, fn = _entry()
    code = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(),
        B, H, Hkv, N, ps, hd, P, splits, pages, hd ** -0.5,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if code:
        build.check(lib, "paged_decode", code)
    paged_attention.launches += 1
    paged_attention.launches_by_design["split_kv"] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_design = {"split_kv": 0}

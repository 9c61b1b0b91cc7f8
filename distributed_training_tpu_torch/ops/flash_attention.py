"""Flash attention on Hopper: the port of ``ops/flash_attention.py``.

- ``flash_fwd`` is the counterpart of the JAX package's ``_flash_fwd``:
  it launches a kernel that replaces the Pallas ``_fwd_kernel``.
- ``flash_bwd`` is the counterpart of ``_flash_bwd``: by default the
  fused kernel (``flash_bwd_fused``: dk/dv with an f32 dq added in
  device memory, replacing ``_bwd_fused_kernel``), or with
  ``DTT_FLASH_SPLIT_BWD=1`` the split pair (``flash_bwd_dq`` and
  ``flash_bwd_dkv``, replacing ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``). It keeps the JAX hooks ring callers use: a
  precomputed ``delta`` and ``grads_dtype``.
- ``_design`` picks every one of these kernels by input dtype and head
  dim: "wgmma" (bf16 tensor-core products: ``csrc/flash_fwd_sm90.cu``;
  ``csrc/flash_bwd_sm90.cu`` for the fused kernel and the split dk/dv;
  ``csrc/flash_bwd_dq_sm90.cu`` for the split dq) for bf16 at head dim
  64 or 128, "simt" (f32 FMAs: ``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``) for f32 and every other head dim.
- ``flash_attention`` is a ``torch.autograd.Function`` over the two that
  saves (q, k, v, out, lse), so the backward never re-runs the forward.

Each runs its plain PyTorch version (``flash_fwd_reference``,
``flash_bwd_reference``) on CPU tensors; for a CUDA tensor it launches
the kernels or raises. There is no fallback.

Layout contract as in the JAX package: the public ``flash_attention``
takes (B, S, H, D) or, with ``layout="bhsd"``, the kernel's own
(B, H, S, D); GQA keeps K/V at Hkv heads (q-head h reads kv-head
h // (H / Hkv)).
"""

from __future__ import annotations

import ctypes
import os

import torch

from distributed_training_tpu_torch.kernels import build

# Tiles of the SIMT forward. Its q-tile is fixed at 64 rows (four threads
# per row, 256 threads); the k-tile is a template choice. Both were
# timed on the card by chip_smoke.py (PERF.md); unlike the TPU's VMEM
# the 227 KB of shared memory holds a 64 x 64 f32 logits tile plus the
# q/k/v tiles at head_dim <= 256. The tensor-core kernels choose their
# own tiles (64 queries x 64 keys, SM90_TILE), as the backward does.
BLOCK_Q = 64
BLOCK_K_CHOICES = (64, 32)
DEFAULT_BLOCK_K = 64
SM90_TILE = 64
# Head dims the tensor-core kernels are built for; read by ``_design``
# alone. f32 stays on the SIMT kernels by design: TF32 tensor cores keep
# about three decimal digits, and the f32 paths are held to 1e-4.
_WGMMA_HEAD_DIMS = (64, 128)
NO_KEY_LSE = -1e30    # lse of a row with no live key (as the TPU kernel)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# DTT_FLASH_SPLIT_BWD=1 takes the split backward (dq kernel + dk/dv
# kernel) in place of the fused one, the JAX package's switch, read once
# at import. ``flash_bwd`` reads this attribute at each call, so a caller
# that compares the two paths in one process sets it. The port has no
# counterpart of ``_fused_bwd_fits``: the fused kernel keeps dq in
# device memory, so no on-chip size limit gates it.
FORCE_SPLIT_BWD = os.environ.get("DTT_FLASH_SPLIT_BWD", "0") not in ("", "0")


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


def _design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel every flash wrapper (forward, fused backward, split dq
    and dk/dv) launches for inputs of ``dtype`` at ``head_dim``: "wgmma"
    or "simt". A declared choice, not a fallback: a tensor-core kernel
    that fails raises."""
    if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _live_mask(S: int, Sk: int, causal: bool, window: int, device):
    """(S, Sk) bool: the (query, key) pairs the mask keeps, or None."""
    if not causal:
        return None
    rows = torch.arange(S, device=device)[:, None] + (Sk - S)
    cols = torch.arange(Sk, device=device)[None, :]
    live = cols <= rows
    if window > 0:
        live = live & (cols >= rows - (window - 1))
    return live


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
    live = _live_mask(S, Sk, causal, window, q.device)
    if live is not None:
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


def _sm90_lib() -> ctypes.CDLL:
    lib = build.load("flash_fwd_sm90")
    lib.flash_fwd_sm90.restype = ctypes.c_int
    lib.flash_fwd_sm90.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, block_q: int = 0, block_k: int = 0,
              out_dtype: torch.dtype | None = None, window: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, S, D); k/v (B, Hkv, Sk, D) → (out (B, H, S, D) in
    ``out_dtype`` (default q.dtype), lse (B, H, S, 1) f32).

    CPU tensors run ``flash_fwd_reference``. CUDA tensors launch the
    kernel ``_design`` picks on the current stream (``flash_fwd.launches``
    counts those launches, ``flash_fwd.launches_by_design`` each
    design's) or raise if it cannot take them. ``block_q``/``block_k``
    are the SIMT kernel's tiles; the tensor-core kernel has its own."""
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    design = _design(q.dtype, D)
    if design == "wgmma":
        lib, name = _sm90_lib(), "flash_fwd_sm90"
        code = lib.flash_fwd_sm90(
            *ptrs, B, H, Hkv, S, Sk, D, int(causal), int(window), D ** -0.5,
            _DTYPE_CODE[out_dtype], stream)
    else:
        lib, name = _lib(), "flash_fwd"
        code = lib.flash_fwd(
            *ptrs, B, H, Hkv, S, Sk, D, int(causal), int(window), bk,
            D ** -0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype], stream)
    build.check(lib, name, code)
    flash_fwd.launches += 1
    flash_fwd.launches_by_design[design] += 1
    return out, lse


flash_fwd.launches = 0
flash_fwd.launches_by_design = {"wgmma": 0, "simt": 0}


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor | None, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool, window: int = 0,
                        delta: torch.Tensor | None = None,
                        grads_dtype: torch.dtype | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain PyTorch version, with their rounding
    points: do in v's dtype, p rounded to do's dtype before the dv
    product, ds rounded to q's dtype before the dk and dq products, every
    sum in f32. dk/dv are summed over each GQA group in f32, then cast to
    ``grads_dtype`` (default: the inputs' dtype)."""
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = D ** -0.5
    gdt = grads_dtype or q.dtype
    if delta is None:
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
    do = do.to(v.dtype)
    qg = q.reshape(B, Hkv, group, S, D).float()
    dog = do.reshape(B, Hkv, group, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    p = torch.exp(s - lse.reshape(B, Hkv, group, S, 1))
    live = _live_mask(S, Sk, causal, window, q.device)
    if live is not None:
        p = torch.where(live, p, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(do.dtype).float(),
                      dog.float())
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog.float(), v.float())
    ds = p * (dp - delta.reshape(B, Hkv, group, S, 1)) * scale
    ds = ds.to(q.dtype).float()
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    return (dq.reshape(B, H, S, D).to(gdt), dk.to(gdt), dv.to(gdt))


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_bwd")
    lib.flash_bwd_dkv.restype = ctypes.c_int
    lib.flash_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_bwd_dq.restype = ctypes.c_int
    lib.flash_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib


def _bwd_sm90_lib() -> ctypes.CDLL:
    lib = build.load("flash_bwd_sm90")
    lib.flash_bwd_sm90.restype = ctypes.c_int
    lib.flash_bwd_sm90.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_bwd_dkv_sm90.restype = ctypes.c_int
    lib.flash_bwd_dkv_sm90.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _bwd_dq_sm90_lib() -> ctypes.CDLL:
    lib = build.load("flash_bwd_dq_sm90")
    lib.flash_bwd_dq_sm90.restype = ctypes.c_int
    lib.flash_bwd_dq_sm90.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _bwd_args(q, k, v, do, lse, delta, causal, window, grads_dtype):
    """Check what the backward kernels take; return the (contiguous)
    launch operands and the kernel's shape/dtype arguments."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v), ("do", do), ("lse", lse),
                    ("delta", delta)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.shape != (B, Hkv, Sk, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)} / k")
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.numel() != B * H * S:
            raise ValueError(f"{name} must be f32 (B, H, S, 1)")
    gdt = grads_dtype or q.dtype
    if q.dtype not in _DTYPE_CODE or gdt not in _DTYPE_CODE:
        raise ValueError(f"flash backward takes f32/bf16, got {q.dtype} -> "
                         f"{gdt}")
    if q.dtype == torch.float32 and gdt != torch.float32:
        raise ValueError("f32 inputs give f32 gradients")
    if H % Hkv or D > 256:
        raise ValueError(f"unsupported heads/head_dim: H={H} Hkv={Hkv} "
                         f"D={D}")
    if causal and S != Sk:
        raise ValueError(f"causal flash needs Sq == Sk, got {S} vs {Sk}")
    ops = [t.contiguous() for t in (q, k, v, do.to(v.dtype), lse, delta)]
    dims = [B, H, Hkv, S, Sk, D, int(causal), int(window)]
    return ops, dims, gdt


def _dkv_out(q, k, gdt):
    """Per-q-head dk/dv buffers: f32 when a GQA group is summed after
    the kernel, else the gradient dtype itself."""
    B, H, _, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dt = gdt if H == Hkv else torch.float32
    return (torch.empty((B, H, Sk, D), dtype=dt, device=q.device),
            torch.empty((B, H, Sk, D), dtype=dt, device=q.device))


def _group_sum(g, Hkv: int, gdt):
    B, H, Sk, D = g.shape
    if H != Hkv:
        g = g.reshape(B, Hkv, H // Hkv, Sk, D).sum(2)
    return g.to(gdt)


def _launch_dkv(ops, dims, dq_acc, dk, dv, design):
    """The dk/dv kernel of ``design``: with an f32 dq accumulator the
    fused kernel, without one (None) the split path's dk/dv kernel."""
    q = ops[0]
    ptrs = [t.data_ptr() for t in ops]
    tail = (*dims, q.shape[3] ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    gcode = _DTYPE_CODE[dk.dtype]
    if design == "wgmma":
        lib, name = _bwd_sm90_lib(), "flash_bwd_sm90"
        if dq_acc is None:
            code = lib.flash_bwd_dkv_sm90(*ptrs, dk.data_ptr(),
                                          dv.data_ptr(), *tail, gcode, stream)
        else:
            code = lib.flash_bwd_sm90(*ptrs, dq_acc.data_ptr(),
                                      dk.data_ptr(), dv.data_ptr(), *tail,
                                      gcode, stream)
    else:
        lib, name = _bwd_lib(), "flash_bwd"
        code = lib.flash_bwd_dkv(
            *ptrs, dq_acc.data_ptr() if dq_acc is not None else None,
            dk.data_ptr(), dv.data_ptr(), *tail, _DTYPE_CODE[q.dtype], gcode,
            stream)
    build.check(lib, name, code)


def _launch_dq(ops, dims, dq, design):
    """The split path's dq kernel of ``design``."""
    q = ops[0]
    ptrs = [t.data_ptr() for t in ops] + [dq.data_ptr()]
    tail = (*dims, q.shape[3] ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if design == "wgmma":
        lib, name = _bwd_dq_sm90_lib(), "flash_bwd_dq_sm90"
        code = lib.flash_bwd_dq_sm90(*ptrs, *tail, _DTYPE_CODE[dq.dtype],
                                     stream)
    else:
        lib, name = _bwd_lib(), "flash_bwd"
        code = lib.flash_bwd_dq(*ptrs, *tail, _DTYPE_CODE[q.dtype],
                                _DTYPE_CODE[dq.dtype], stream)
    build.check(lib, name, code)


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal: bool,
                    window: int = 0, grads_dtype=None):
    """The fused backward kernel (B2's counterpart) that ``_design``
    picks: (dq, dk, dv), dk/dv group-summed to Hkv heads. dq is added
    into a zeroed f32 buffer by atomics (vector reductions on the wgmma
    route), cast to the gradient dtype after. Counts its launches in
    ``flash_bwd_fused.launches`` and ``flash_bwd_fused.launches_by_design``.
    CPU tensors run ``flash_bwd_reference``."""
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                   window=window, delta=delta,
                                   grads_dtype=grads_dtype)
    ops, dims, gdt = _bwd_args(q, k, v, do, lse, delta, causal, window,
                               grads_dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = _dkv_out(q, k, gdt)
    design = _design(q.dtype, q.shape[3])
    _launch_dkv(ops, dims, dq, dk, dv, design)
    flash_bwd_fused.launches += 1
    flash_bwd_fused.launches_by_design[design] += 1
    Hkv = k.shape[1]
    return dq.to(gdt), _group_sum(dk, Hkv, gdt), _group_sum(dv, Hkv, gdt)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                  window: int = 0, grads_dtype=None):
    """The split path's dk/dv kernel (B3b's counterpart) that
    ``_design`` picks: (dk, dv) group-summed to Hkv heads; no atomics,
    the same bits on every run. Counts its launches in
    ``flash_bwd_dkv.launches`` and ``flash_bwd_dkv.launches_by_design``.
    CPU tensors run ``flash_bwd_reference``."""
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                   window=window, delta=delta,
                                   grads_dtype=grads_dtype)[1:]
    ops, dims, gdt = _bwd_args(q, k, v, do, lse, delta, causal, window,
                               grads_dtype)
    dk, dv = _dkv_out(q, k, gdt)
    design = _design(q.dtype, q.shape[3])
    _launch_dkv(ops, dims, None, dk, dv, design)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.launches_by_design[design] += 1
    Hkv = k.shape[1]
    return _group_sum(dk, Hkv, gdt), _group_sum(dv, Hkv, gdt)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                 window: int = 0, grads_dtype=None) -> torch.Tensor:
    """The split path's dq kernel (B3a's counterpart) that ``_design``
    picks; no atomics, the same bits on every run. Counts its launches
    in ``flash_bwd_dq.launches`` and ``flash_bwd_dq.launches_by_design``.
    CPU tensors run ``flash_bwd_reference``."""
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                   window=window, delta=delta,
                                   grads_dtype=grads_dtype)[0]
    ops, dims, gdt = _bwd_args(q, k, v, do, lse, delta, causal, window,
                               grads_dtype)
    dq = torch.empty(q.shape, dtype=gdt, device=q.device)
    design = _design(q.dtype, q.shape[3])
    _launch_dq(ops, dims, dq, design)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_by_design[design] += 1
    return dq


flash_bwd_fused.launches = 0
flash_bwd_fused.launches_by_design = {"wgmma": 0, "simt": 0}
flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_by_design = {"wgmma": 0, "simt": 0}
flash_bwd_dq.launches = 0
flash_bwd_dq.launches_by_design = {"wgmma": 0, "simt": 0}


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor | None, lse: torch.Tensor, do: torch.Tensor,
              *, causal: bool, block_q: int = 0, block_k: int = 0,
              window: int = 0, delta: torch.Tensor | None = None,
              grads_dtype: torch.dtype | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq (B, H, S, D), dk/dv (B, Hkv, Sk, D)) of flash
    attention from its saved residuals; the counterpart of the JAX
    ``_flash_bwd``. ``out`` is read only to derive ``delta =
    rowsum(dO * O)`` (plain torch, f32, outside the kernels); callers that
    precompute ``delta`` pass ``out=None``. ``grads_dtype`` overrides the
    gradients' dtype (default: the inputs'). ``FORCE_SPLIT_BWD`` picks
    the split kernels over the fused one. ``block_q``/``block_k`` are the
    forward's tiles; the backward kernels choose their own by head dim.

    CPU tensors run ``flash_bwd_reference``; CUDA tensors launch the
    kernels or raise."""
    del block_q, block_k
    if delta is None:
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
    if not q.is_cuda:
        return flash_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                   window=window, delta=delta,
                                   grads_dtype=grads_dtype)
    kw = dict(causal=causal, window=window, grads_dtype=grads_dtype)
    if FORCE_SPLIT_BWD:
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv
    return flash_bwd_fused(q, k, v, do, lse, delta, **kw)


class _FlashAttention(torch.autograd.Function):
    """Flash attention over (B, H, S, D) with the kernels on both sides:
    the forward saves (q, k, v, out, lse), as the JAX ``_flash_bhsd_fwd``
    does, so the backward never re-runs the forward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, causal=causal, block_q=block_q,
                             block_k=block_k, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block_q, block_k, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k, window = ctx.args
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               causal=causal, block_q=block_q,
                               block_k=block_k, window=window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 0,
                    block_k: int = 0, window: int = 0,
                    layout: str = "bshd") -> torch.Tensor:
    """Flash attention over (B, S, H, D) inputs (GQA allowed), with
    gradients through the backward kernels. ``window`` > 0 =
    sliding-window attention (query i attends keys in
    [i - window + 1, i]); requires ``causal``. ``layout="bhsd"``: inputs
    and output in the kernel's (B, H, S, D)."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown layout '{layout}'")
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
        return _FlashAttention.apply(q, k, v, causal, bq, bk, window)

    def t(x):
        return x.transpose(1, 2)

    return t(_FlashAttention.apply(t(q), t(k), t(v), causal, bq, bk,
                                   window))

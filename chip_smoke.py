#!/usr/bin/env python
"""On-card smoke run of the PyTorch port (distributed_training_tpu_torch).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``distributed_training_tpu_torch/
csrc/`` (one ``nvcc`` per source, all at once) and holds each kernel
against its plain PyTorch version at the shapes its path gives it,
timing both beside a PyTorch library call where one exists. Every flash
kernel (forward, fused backward, split dq and dk/dv) has two designs
(``_design``): bf16 at head dim 64/128 takes the tensor-core kernels,
f32 and other head dims the SIMT ones, and each case reports the design
its launch took. Then it
drives both main paths at full width of gpt2_125m, random weights from
a seed:

- serving: ``Engine`` + ``ServingServer`` over HTTP (batched prefill,
  paged decode), the sequential prefill whose first chunk takes the
  flash forward, float32 greedy tokens against the dense forward, and a
  ``torch.profiler`` trace of one burst;
- training: the trainer CLI (``python -m distributed_training_tpu_torch.
  train model=gpt2_125m train=gpt2``) for 20 steps with the fused flash
  backward and 10 with the split one (every bf16 flash launch on the
  tensor-core design), float32 losses of flash (fused, split; the SIMT
  design) and bfloat16 losses and gradient norms of flash (fused, split;
  tensor cores) against naive attention at reduced depth, with a
  planted fault that must fail the same limits, and profiler traces of
  training steps with each backward.

Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA card, or without the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate and
# HBM3 bandwidth; f32 outside the tensor cores for f32 operands.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Tolerances against the plain versions: bf16 output rounding (one bf16
# ulp is 2**-7 relative) plus a different summation order; f32 differs
# only in summation order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-3
# The backward kernels' gradients are held with the same tolerances
# relative to each gradient's largest magnitude: bf16 rounds the outputs
# and p/ds, dq sums up to S terms, and the fused kernel's atomic dq sums
# in an order that changes from run to run. f32 gradients of bf16 inputs
# from the fused kernel: GRADS_F32_OF_BF16_TOL. p and ds are rounded to
# bf16 at the plain version's points, but from logits summed in another
# order, so a value on a rounding boundary may round the other way: the
# plain version against itself with its head-dim sum permuted moves
# these gradients past 1e-4 but not past 1e-3
# (tests/test_torch_flash_design.py), and the SIMT kernel at head dim
# 32 by 2.2e-4 on the card (PERF.md). 1e-3 lies
# above that and below the control, the plain version's gradients
# rounded to bf16, which err by half a bf16 ulp of the largest gradient
# (2e-3 to 3.9e-3 of it, wherever it falls in its binade). The split
# pair takes the same limit on the tensor cores (it sums the logits in
# the fused kernel's order); on SIMT, at head dim 96, it keeps 1e-4.
GRADS_F32_OF_BF16_TOL = 1e-3
# f32 training parity: flash (fused or split) against naive attention,
# same weights and batches; the losses differ by summation order only
# (atomics in the fused dq), 1e-4 relative after a few steps.
TRAIN_PARITY_RTOL = 1e-4
# bf16 training parity: flash on the tensor-core kernels against naive
# attention, same weights and batches, bf16 compute; the 4 losses and
# the 3 unclipped gradient norms logged after the warm-up step, relative.
# The two paths round at different places (the kernels round the
# unnormalised p and ds to bf16, naive the normalised weights) and the
# fused dq sums by atomics in a varying order. Readings on the H100
# (PERF.md): the sound run within 8.8e-6 (losses) and 1.5e-4 (norms);
# the control with the attention gradients zeroed 3.7e-4 and 0.108. Each
# limit lies between the two.
TRAIN_BF16_PARITY_RTOL = 1e-4
TRAIN_BF16_GRAD_NORM_RTOL = 1e-3
SEED = 0
KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
           "paged_decode")
# gpt2_125m training at full width (conf/train/gpt2.yaml: batch 8, seq
# 1024, bf16 compute, f32 params, AdamW, remat "mlp").
TRAIN_STEPS = 20
TRAIN_SPLIT_STEPS = 10


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


class Timer:
    """Median device time of single launches (CUDA events), each after
    an L2 flush and a short device sleep, so the card is busy while the
    host enqueues the launch and its inputs are not cache-warm."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, runs: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.flush.zero_()
            torch.cuda._sleep(200_000)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def phase_device() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # f32 references stay in full f32: no TF32 in matmuls or cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "card": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32": False}
    emit(info)
    return info


def phase_build() -> None:
    from distributed_training_tpu_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build()
    regs = {name: sorted({line.split(":", 1)[1].strip()
                          for line in log.splitlines()
                          if "registers" in line})
            for name, log in build.build_logs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": regs})


def _design_taken(fn, before: dict) -> str:
    """The design whose launch count moved since ``before``: exactly one
    launch of one design."""
    moved = {d: n - before[d] for d, n in fn.launches_by_design.items()
             if n != before[d]}
    check(len(moved) == 1 and list(moved.values()) == [1],
          f"{fn.__name__}: launches by design moved by {moved}")
    return next(iter(moved))


def _flash_case(timer, B, H, Hkv, S, D, dtype, window=0, out_dtype=None,
                block_k=0, library=False) -> dict:
    from distributed_training_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    kw = dict(causal=True, window=window, out_dtype=out_dtype)
    before = dict(fa.flash_fwd.launches_by_design)
    o, lse = fa.flash_fwd(q, k, v, block_k=block_k, **kw)
    torch.cuda.synchronize()
    design = _design_taken(fa.flash_fwd, before)
    ro, rl = fa.flash_fwd_reference(q, k, v, **kw)
    err = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rl).abs().max().item()
    # The plain version rounds the softmax weights to the input type.
    tol = TOL[dtype]
    check(torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol),
          f"flash_fwd {B}x{H}/{Hkv}x{S}x{D} {dtype} w={window}: max err "
          f"{err} > {tol}")
    check(err_lse <= LSE_TOL, f"flash_fwd lse max err {err_lse}")
    # Live (query, key) pairs of this mask: what the work needs.
    rows = torch.arange(S, device="cuda")[:, None]
    cols = torch.arange(S, device="cuda")[None, :]
    live = cols <= rows
    if window:
        live &= cols >= rows - (window - 1)
    pairs = int(live.sum()) * B * H
    out_size = torch.empty((), dtype=out_dtype or dtype).element_size()
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() \
        + o.numel() * out_size + lse.numel() * 4
    bound_ms, bound_by = bound(4.0 * pairs * D, nbytes, dtype)
    res = {"shape": [B, H, Hkv, S, D], "dtype": str(dtype).split(".")[1],
           "design": design, "window": window,
           "out_dtype": str(out_dtype or dtype).split(".")[1],
           "block_k": block_k or fa.DEFAULT_BLOCK_K,
           "max_abs_err": err, "max_abs_err_lse": err_lse,
           "ms": timer.ms(lambda: fa.flash_fwd(q, k, v, block_k=block_k,
                                               **kw)),
           "plain_ms": timer.ms(lambda: fa.flash_fwd_reference(q, k, v,
                                                               **kw)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if library:
        # Yardstick only: the port never calls SDPA.
        res["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hkv != H))
    return res


def _paged_case(timer, B, H, Hkv, hd, ps, max_len, dtype) -> dict:
    from distributed_training_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, max_len + 1, size=B).astype(np.int32)
    lengths[-1] = 0
    P = max_len // ps
    N = 1 + B * P
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        tables[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kp = torch.randn(Hkv, N, ps, hd, generator=g, device="cuda").to(dtype)
    vp = torch.randn(Hkv, N, ps, hd, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    L = torch.from_numpy(lengths).cuda()
    T = torch.from_numpy(tables).cuda()
    out = pa.paged_attention(q, kp, vp, L, T)
    torch.cuda.synchronize()
    ref = pa.paged_attention(q, kp, vp, L, T, impl="ref")
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"paged_decode max err {err} > {tol}")
    check(out[-1].abs().max().item() == 0.0, "length-0 row is not zero")
    toks = int(lengths.sum())
    nbytes = (2 * toks * Hkv * hd + 2 * q.numel()) * q.element_size() \
        + 4 * (B + sum(-(-int(n) // ps) for n in lengths))
    bound_ms, bound_by = bound(4.0 * toks * H * hd, nbytes, dtype)
    return {"shape": [B, H, Hkv, hd, ps], "dtype": str(dtype).split(".")[1],
            "lengths": lengths.tolist(), "max_abs_err": err,
            "ms": timer.ms(lambda: pa.paged_attention(q, kp, vp, L, T)),
            "plain_ms": timer.ms(lambda: pa.paged_attention(
                q, kp, vp, L, T, impl="ref")),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error relative to the largest magnitude of ``want`` (at
    least 1), the measure the gradients are held to."""
    scale = max(want.float().abs().max().item(), 1.0)
    return (got.float() - want.float()).abs().max().item() / scale


def _bwd_case(timer, B, H, Hkv, S, D, dtype, split, window=0,
              grads_dtype=None, library=False) -> dict:
    """The backward kernels on one shape: fused (B2) or the split pair
    (B3a dq, B3b dk/dv), each held against flash_bwd_reference, with the
    design each launch took. Where the limit is GRADS_F32_OF_BF16_TOL,
    the plain version's gradients rounded to bf16 must fail it (the
    control). The split kernels use no atomics: a second launch must
    give the same bits. ``pair_ms`` times dq and dk/dv back to back, as
    ``flash_bwd`` runs them."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(B, h, S, D, generator=g, device="cuda").to(dtype)
               for h in (H, Hkv, Hkv))
    do = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
    kw = dict(causal=True, window=window)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta)
    kw["grads_dtype"] = grads_dtype
    ref = fa.flash_bwd_reference(q, k, v, None, lse, do, delta=delta, **kw)
    if split:
        runs = {"flash_bwd_dq": (fa.flash_bwd_dq,
                                 lambda: (fa.flash_bwd_dq(*args, **kw),),
                                 ref[:1], 6),
                "flash_bwd_dkv": (fa.flash_bwd_dkv,
                                  lambda: fa.flash_bwd_dkv(*args, **kw),
                                  ref[1:], 8)}
    else:
        runs = {"flash_bwd_fused": (fa.flash_bwd_fused,
                                    lambda: fa.flash_bwd_fused(*args, **kw),
                                    ref, 10)}
    live = fa._live_mask(S, S, True, window, "cuda")
    pairs = int(live.sum()) * B * H
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    gsize = torch.empty((), dtype=grads_dtype or dtype).element_size()
    res = {"shape": [B, H, Hkv, S, D], "dtype": str(dtype).split(".")[1],
           "window": window, "grads_dtype": str(grads_dtype or dtype)
           .split(".")[1]}
    for name, (wrapper, fn, want, flops_per_dim) in runs.items():
        before = dict(wrapper.launches_by_design)
        got = fn()
        torch.cuda.synchronize()
        entry = {"design": _design_taken(wrapper, before)}
        tol = TOL[grads_dtype or dtype]
        # f32 gradients of bf16 inputs: GRADS_F32_OF_BF16_TOL on the
        # tensor cores and on the fused SIMT kernel; the split SIMT pair
        # keeps TOL.
        if dtype == torch.bfloat16 and grads_dtype == torch.float32 \
                and (entry["design"] == "wgmma" or not split):
            tol = GRADS_F32_OF_BF16_TOL
            # The control: a kernel that rounded its f32 gradients to
            # bf16 must fail this limit.
            ctrl = max(_rel_err(w.to(torch.bfloat16), w) for w in want)
            check(ctrl > tol, f"{name}: bf16-rounded control {ctrl} within "
                  f"the limit {tol}")
            entry["bf16_rounded_control_rel_err"] = ctrl
        errs = [_rel_err(a, b) for a, b in zip(got, want)]
        check(max(errs) <= tol,
              f"{name} {B}x{H}/{Hkv}x{S}x{D} {dtype} w={window}: error "
              f"{max(errs)} of the largest gradient > {tol}")
        if split:
            again = fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: a second launch gave other bits")
            entry["bit_identical"] = True
        out_bytes = sum(t.numel() for t in got) * gsize
        bound_ms, bound_by = bound(flops_per_dim * D * pairs,
                                   in_bytes + out_bytes, dtype)
        res[name] = dict(
            entry, tol=tol,
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)),
            max_rel_err=max(errs), ms=timer.ms(fn), bound_ms=bound_ms,
            bound_by=bound_by)
    if split:
        dq_fn, dkv_fn = runs["flash_bwd_dq"][1], runs["flash_bwd_dkv"][1]
        res["pair_ms"] = timer.ms(lambda: (dq_fn(), dkv_fn()))
    plain = timer.ms(lambda: fa.flash_bwd_reference(
        q, k, v, None, lse, do, delta=delta, **kw), runs=10)
    lib = None
    if library:
        # Yardstick only: the backward of one SDPA call at the same
        # shape (the port never calls SDPA).
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*xs, is_causal=True,
                                           enable_gqa=Hkv != H)
        lib = timer.ms(lambda: torch.autograd.grad(o, xs, do,
                                                   retain_graph=True))
    for name in runs:
        res[name].update(plain_ms=plain, library_ms=lib)
    return res


def phase_kernels() -> dict:
    timer = Timer()
    bf16, f32 = torch.bfloat16, torch.float32
    flash = {
        "main": _flash_case(timer, 4, 12, 12, 1024, 64, bf16, library=True),
        "gqa": _flash_case(timer, 4, 12, 4, 1024, 64, bf16, library=True),
        "window": _flash_case(timer, 4, 12, 12, 1024, 64, bf16,
                              window=256),
        "f32_out": _flash_case(timer, 4, 12, 12, 1024, 64, bf16,
                               out_dtype=f32),
        "ragged": _flash_case(timer, 4, 12, 12, 1000, 64, bf16),
        "f32": _flash_case(timer, 2, 12, 12, 256, 64, f32),
        # bf16 at a head dim outside (64, 128): the SIMT kernel, with
        # its 32-key tile.
        "simt_d32_block_k32": _flash_case(timer, 4, 12, 12, 1024, 32, bf16,
                                          block_k=32),
        # transformer_1b's attention: B 2, H 16, S 2048, D 128.
        "d128": _flash_case(timer, 2, 16, 16, 2048, 128, bf16, library=True),
        "d128_gqa_window": _flash_case(timer, 2, 16, 4, 2048, 128, bf16,
                                       window=512),
    }
    flash["train"] = _flash_case(timer, 8, 12, 12, 1024, 64, bf16,
                                 library=True)
    paged = {"main": _paged_case(timer, 8, 12, 12, 64, 16, 1024, bf16),
             "f32_gqa": _paged_case(timer, 8, 12, 4, 64, 16, 1024, f32)}
    emit({"phase": "kernels", "flash_fwd": flash, "paged_decode": paged})
    bwd = {}
    for split in (False, True):
        tag = "split" if split else "fused"
        bwd[f"{tag}_train"] = _bwd_case(timer, 8, 12, 12, 1024, 64, bf16,
                                        split, library=True)
        bwd[f"{tag}_gqa"] = _bwd_case(timer, 8, 12, 4, 1024, 64, bf16, split)
        bwd[f"{tag}_window"] = _bwd_case(timer, 8, 12, 12, 1024, 64, bf16,
                                         split, window=256)
        bwd[f"{tag}_f32"] = _bwd_case(timer, 2, 12, 12, 256, 64, f32, split)
        # bf16 in, f32 gradients: on the tensor cores at
        # GRADS_F32_OF_BF16_TOL, with its control.
        bwd[f"{tag}_grads_f32"] = _bwd_case(timer, 8, 12, 12, 1024, 64, bf16,
                                            split, grads_dtype=f32)
        bwd[f"{tag}_ragged"] = _bwd_case(timer, 4, 12, 12, 1000, 64, bf16,
                                         split)
        # transformer_1b's attention: B 2, H 16, S 2048, D 128.
        bwd[f"{tag}_d128"] = _bwd_case(timer, 2, 16, 16, 2048, 128, bf16,
                                       split, library=True)
        bwd[f"{tag}_d128_gqa_window_grads_f32"] = _bwd_case(
            timer, 2, 16, 4, 2048, 128, bf16, split, window=512,
            grads_dtype=f32)
    # The SIMT kernels on bf16 inputs with f32 gradients: fused at head
    # dim 32 (GRADS_F32_OF_BF16_TOL), the split pair at head dim 96 (TOL,
    # 1e-4).
    bwd["fused_simt_d32_grads_f32"] = _bwd_case(
        timer, 8, 12, 12, 1024, 32, bf16, False, grads_dtype=f32)
    bwd["split_simt_d96_grads_f32"] = _bwd_case(
        timer, 2, 8, 2, 256, 96, bf16, True, grads_dtype=f32)
    emit({"phase": "kernels_bwd", **bwd})
    return {"flash_fwd": flash["train"], "paged_decode": paged["main"],
            "flash_bwd_fused": bwd["fused_train"]["flash_bwd_fused"],
            "flash_bwd_dq": bwd["split_train"]["flash_bwd_dq"],
            "flash_bwd_dkv": bwd["split_train"]["flash_bwd_dkv"]}


def _gpt2(dtype: str):
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )

    model = Transformer(TransformerConfig(**PRESETS["gpt2_125m"],
                                          dtype=dtype, param_dtype=dtype))
    return model, model.init(SEED)


def _engine(model, params, **over):
    from distributed_training_tpu_torch.serving.engine import (
        Engine,
        EngineConfig,
    )

    kw = dict(max_batch=8, page_size=16, num_pages=513, max_seq_len=1024,
              prefill_chunk=16, prefix_sharing=True, prefill_mode="batched",
              policy="prefill", temperature=0.0)
    kw.update(over)
    return Engine(model, params, EngineConfig(**kw))


def _wrappers() -> dict:
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.ops import paged_attention as pa

    return {"flash_fwd": fa.flash_fwd, "flash_bwd_fused": fa.flash_bwd_fused,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv,
            "paged_decode": pa.paged_attention}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        for design in getattr(fn, "launches_by_design", {}):
            fn.launches_by_design[design] = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _read_designs() -> dict:
    """Launches per design of the wrappers that have two designs."""
    return {name: dict(fn.launches_by_design)
            for name, fn in _wrappers().items()
            if hasattr(fn, "launches_by_design")}


def _check_designs(designs: dict, want: str, what: str) -> None:
    for name, counts in designs.items():
        check(counts[want] > 0 and sum(counts.values()) == counts[want],
              f"{what}: {name} launches by design {counts}, not all "
              f"{want}")


def _post(port: int, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read().decode()
    if body.get("stream"):
        return [json.loads(line) for line in data.splitlines()]
    return json.loads(data)


def phase_serving(prompts: list, new_tokens: int) -> tuple[tuple, dict]:
    from distributed_training_tpu_torch.serving.server import ServingServer

    torch.cuda.reset_peak_memory_stats()
    model, params = _gpt2("bfloat16")
    eng = _engine(model, params)
    counts = eng.warmup()
    srv = ServingServer(eng, port=0).start()
    check(srv is not None, "server did not start")
    results: dict = {}
    # The streamed request repeats prompt 0, so its tokens are held
    # against a plain request for the same prompt.
    bodies = [{"prompt_ids": p.tolist(), "max_new_tokens": new_tokens}
              for p in prompts]
    bodies.append(dict(bodies[0], stream=True))

    def client(i):
        results[i] = _post(srv.port, bodies[i])

    try:
        decode0 = eng.decode_launches
        _reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, designs = _read_counts(), _read_designs()
        decode_launches = eng.decode_launches - decode0
    finally:
        srv.stop()
    check(len(results) == len(bodies), "not every request completed")
    lines = results[len(bodies) - 1]
    streamed = [x["token"] for x in lines if "token" in x]
    final = lines[-1]
    check(final.get("done") and final["tokens"] == streamed,
          "stream's token lines differ from its final line")
    check(streamed == results[0]["tokens"],
          "streamed tokens differ from the plain request's")
    plain = [results[i] for i in range(len(prompts))]
    check(all(len(r["tokens"]) == new_tokens for r in plain),
          "a request returned the wrong number of tokens")
    check(eng.compile_counts() == counts, "kernel builds after warmup")
    check(launches["paged_decode"] >= 12 * decode_launches > 0,
          f"paged decode launches {launches['paged_decode']} < 12 x "
          f"{decode_launches} decode launches")
    generated = sum(len(r["tokens"]) for r in plain) + len(streamed)
    ttfts = [r["ttft_s"] for r in plain] + [final["ttft_s"]]
    info = {"phase": "serving", "model": "gpt2_125m", "dtype": "bfloat16",
            "requests": len(bodies), "prompt_lens": [len(p) for p in prompts],
            "new_tokens": new_tokens, "wall_s": wall,
            "tokens_per_s": generated / wall,
            "mean_ttft_s": float(np.mean(ttfts)),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "decode_launches": decode_launches,
            "prefill_launches": eng.prefill_launches,
            "host_syncs": eng.host_syncs, "launches": launches,
            "launches_by_design": designs, "compile_counts": counts,
            "leaked_threads": srv.leaked_threads}
    emit(info)
    return (launches, designs), {i: r["tokens"]
                                 for i, r in enumerate(plain)}


def phase_sequential(prompts: dict, new_tokens: int,
                     batched_tokens: dict) -> tuple:
    from distributed_training_tpu_torch.serving.engine import Request

    model, params = _gpt2("bfloat16")
    eng = _engine(model, params, prefill_mode="sequential",
                  prefill_chunk=128)
    counts = eng.warmup()
    _reset_counts()
    for i, p in prompts.items():
        eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
    eng.run_until_drained()
    torch.cuda.synchronize()
    launches, designs = _read_counts(), _read_designs()
    got = {int(r["id"]): r["tokens"] for r in eng.completed}
    check(len(got) == len(prompts), "sequential: not every request done")
    check(launches["flash_fwd"] == 12 * len(prompts),
          f"flash launches {launches['flash_fwd']} != 12 x "
          f"{len(prompts)} first chunks")
    _check_designs({"flash_fwd": designs["flash_fwd"]}, "wgmma",
                   "sequential (bf16, head dim 64)")
    check(launches["paged_decode"] > 0, "sequential: no decode launch")
    check(eng.compile_counts() == counts, "kernel builds after warmup")
    same = sum(int(a == b) for i in got
               for a, b in zip(got[i], batched_tokens[i]))
    emit({"phase": "sequential", "dtype": "bfloat16", "prefill_chunk": 128,
          "requests": len(prompts), "launches": launches,
          "launches_by_design": designs,
          "tokens_matching_batched": same,
          "tokens_total": sum(len(t) for t in got.values())})
    return launches, designs


def phase_parity(prompts: list, n: int) -> None:
    """float32 engine greedy vs the dense full-context greedy of
    Transformer.apply, in both prefill modes."""
    from distributed_training_tpu_torch.serving.engine import Request

    model, params = _gpt2("float32")
    dense = []
    for p in prompts:
        ids, toks, margins = [int(t) for t in p], [], []
        for _ in range(n):
            logits, _ = model.apply(params, torch.tensor([ids]))
            top2 = torch.topk(logits[0, -1], 2).values
            margins.append(float(top2[0] - top2[1]))
            toks.append(int(torch.argmax(logits[0, -1])))
            ids.append(toks[-1])
        dense.append((toks, margins))
    report = {}
    for mode, chunk in (("batched", 16), ("sequential", 128)):
        eng = _engine(model, params, prefill_mode=mode,
                      prefill_chunk=chunk)
        _reset_counts()
        for i, p in enumerate(prompts):
            eng.submit(Request(id=str(i), prompt=p, max_new_tokens=n))
        eng.run_until_drained()
        got = {int(r["id"]): r["tokens"] for r in eng.completed}
        near_ties = []
        for i, (want, margins) in enumerate(dense):
            for t, (a, b) in enumerate(zip(got[i], want)):
                if a != b:
                    check(margins[t] < 1e-3,
                          f"{mode} prompt {i} token {t}: engine {a} != "
                          f"dense {b} at top-2 margin {margins[t]}")
                    near_ties.append({"prompt": i, "token": t,
                                      "margin": margins[t]})
                    break
        report[mode] = {"identical": all(got[i] == dense[i][0]
                                         for i in range(len(prompts))),
                        "near_ties": near_ties, "launches": _read_counts()}
    check(report["sequential"]["launches"]["flash_fwd"] > 0,
          "parity: flash kernel not on the compared path")
    emit({"phase": "parity", "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts], "tokens": n,
          **report})


def phase_trace(prompts: list, new_tokens: int) -> None:
    """Where a serving burst's time goes: the phase-4 requests through
    the engine directly (no HTTP) under ``torch.profiler``. Device busy
    time is the union of the kernel and copy intervals; the idle share
    is the rest of the host wall time (profiling slows the host, so the
    share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.serving.engine import Request

    model, params = _gpt2("bfloat16")
    eng = _engine(model, params)
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "trace", "dtype": "bfloat16", "requests": len(prompts),
          **_device_time(prof, wall_us),
          "decode_launches": eng.decode_launches,
          "prefill_launches": eng.prefill_launches})


def _device_time(prof, wall_us: float, top_n: int = 8) -> dict:
    """Device busy time (the union of kernel and copy intervals), the
    idle share of the host wall time, and the kernels that took the most
    device time. ``record_function`` ranges (the telemetry spans) also
    appear on the device's timeline as annotations; they are not work."""
    events = prof.events()
    ranges = {"step", "compile", "data_wait", "data_assemble", "ckpt_save",
              "ckpt_restore"}
    ranges |= {e.name for e in events
               if getattr(e, "is_user_annotation", False)}
    spans, per_name = [], {}
    for e in events:
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.name not in ranges):
            spans.append((e.time_range.start, e.time_range.end))
            tot, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    check(busy > 0, "the trace holds no device time")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": 1.0 - busy / wall_us,
            "flash_us": sum(v[0] for k, v in per_name.items()
                            if "flash_" in k),
            "top_kernels": [{"name": k[:80], "us": v[0], "count": v[1],
                             "share": v[0] / busy} for k, v in top]}


def _train_overrides(out_dir: str, steps: int, batch: int = 8,
                     extra: tuple = ()) -> list:
    """The trainer CLI on gpt2_125m / conf/train/gpt2.yaml, cut to
    ``steps`` steps of one epoch."""
    return ["model=gpt2_125m", "train=gpt2",
            f"train.batch_size={batch}",
            f"train.dataset_size={steps * batch}", "train.total_epochs=1",
            "train.log_every=1", "run.log_level=WARNING",
            f"run.output_dir={out_dir}", *extra]


def _metrics_rows(out_dir: str) -> list:
    path = os.path.join(out_dir, "default", "metrics.jsonl")
    with open(path) as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def phase_train(tmp: str) -> tuple:
    """The trainer CLI's main at full width for TRAIN_STEPS steps."""
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.train import cli

    out = os.path.join(tmp, "train")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    check(cli.main(_train_overrides(out, TRAIN_STEPS)) == 0, "train failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    designs = _read_designs()
    rows = _metrics_rows(out)
    losses = [r["loss"] for r in rows]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} loss rows")
    _check_designs({n: designs[n] for n in ("flash_fwd", "flash_bwd_fused")},
                   "wgmma", "train (bf16, head dim 64)")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    for name in ("flash_fwd", "flash_bwd_fused"):
        check(launches[name] == 12 * TRAIN_STEPS,
              f"{name} launched {launches[name]} times, not 12 x "
              f"{TRAIN_STEPS}")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          "fused train took the split kernels")
    ckpt = os.path.join(out, "default", "checkpoints", str(TRAIN_STEPS),
                        "state.pt")
    check(os.path.exists(ckpt), "no checkpoint written")
    # Each metrics row reads its loss (a device sync), so a row's rate
    # covers one whole step; the first rows hold the first launches.
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows[3:]]))
    tokens = 8 * 1024
    model = Transformer(TransformerConfig(**PRESETS["gpt2_125m"]))
    flops = model.flops_per_sample() * 8
    info = {"phase": "train", "model": "gpt2_125m", "config": "gpt2.yaml",
            "batch": 8, "seq": 1024, "steps": TRAIN_STEPS, "wall_s": wall,
            "median_step_s": step_s, "tokens_per_s": tokens / step_s,
            "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
            "mfu_logged_median": float(np.median(
                [r.get("mfu", float("nan")) for r in rows[3:]])),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "first_loss": losses[0], "last_loss": losses[-1],
            "grad_norm_last": rows[-1].get("grad_norm"),
            "launches": launches, "launches_by_design": designs,
            "checkpoint": ckpt}
    emit(info)
    return launches, designs


def phase_train_split(tmp: str) -> tuple:
    """The same CLI at full width with the split backward (B3a + B3b),
    every flash launch on the tensor-core design, for
    TRAIN_SPLIT_STEPS steps."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.train import cli

    out = os.path.join(tmp, "train_split")
    fa.FORCE_SPLIT_BWD = True
    try:
        _reset_counts()
        check(cli.main(_train_overrides(out, TRAIN_SPLIT_STEPS)) == 0,
              "split train failed")
        torch.cuda.synchronize()
        launches, designs = _read_counts(), _read_designs()
    finally:
        fa.FORCE_SPLIT_BWD = False
    rows = _metrics_rows(out)
    losses = [r["loss"] for r in rows]
    check(len(losses) == TRAIN_SPLIT_STEPS, f"{len(losses)} loss rows")
    check(all(math.isfinite(x) for x in losses), f"non-finite {losses}")
    split = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for name in split:
        check(launches[name] == 12 * TRAIN_SPLIT_STEPS,
              f"split: {name} launched {launches[name]} times")
    check(launches["flash_bwd_fused"] == 0, "split run took the fused kernel")
    _check_designs({n: designs[n] for n in split}, "wgmma",
                   "train_split (bf16, head dim 64)")
    # As in phase train: each row's rate covers one whole step.
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows[3:]]))
    emit({"phase": "train_split", "steps": TRAIN_SPLIT_STEPS,
          "batch": 8, "seq": 1024, "median_step_s": step_s,
          "tokens_per_s": 8 * 1024 / step_s, "losses": losses,
          "launches": launches, "launches_by_design": designs})
    return launches, designs


def phase_train_parity(tmp: str) -> None:
    """float32, 2 layers at full width, batch 4: the same 4 steps (lr 0
    on the first, then the full rate) with flash (fused), flash (split)
    and naive attention."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.train import cli

    runs = {}
    for name, impl, split in (("naive", "naive", False),
                              ("flash_fused", "flash", False),
                              ("flash_split", "flash", True)):
        out = os.path.join(tmp, f"parity_{name}")
        fa.FORCE_SPLIT_BWD = split
        try:
            _reset_counts()
            check(cli.main(_train_overrides(
                out, 4, batch=4,
                extra=("train.dtype=float32", "+model.n_layers=2",
                       "train.warmup_steps=1",
                       f"model.attention_impl={impl}"))) == 0,
                f"parity run {name} failed")
            launches = _read_counts()
            designs = _read_designs()
        finally:
            fa.FORCE_SPLIT_BWD = False
        runs[name] = {"losses": [r["loss"] for r in _metrics_rows(out)],
                      "launches": launches, "launches_by_design": designs}
        if impl == "flash":
            names = (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if split
                     else ("flash_fwd", "flash_bwd_fused"))
            _check_designs({n: designs[n] for n in names}, "simt",
                           f"parity {name} (f32)")
    want = runs["naive"]["losses"]
    check(runs["naive"]["launches"]["flash_fwd"] == 0, "naive took flash")
    for name in ("flash_fused", "flash_split"):
        got = runs[name]["losses"]
        check(len(got) == len(want) == 4, f"{name}: {got}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        runs[name]["max_rel_diff"] = rel
        check(rel <= TRAIN_PARITY_RTOL,
              f"{name} losses {got} vs naive {want}: rel {rel}")
        check(runs[name]["launches"]["flash_fwd"] == 2 * 4,
              f"{name} flash forward launches")
    emit({"phase": "train_parity", "dtype": "float32", "n_layers": 2,
          "batch": 4, "steps": 4, "warmup_steps": 1,
          "rtol": TRAIN_PARITY_RTOL, **runs})


def _zeroed(fn):
    """``fn`` with every gradient it returns replaced by zeros: the
    planted fault of the bf16 parity phase's control run."""
    def zeroed(*args, **kwargs):
        return tuple(torch.zeros_like(g) for g in fn(*args, **kwargs))
    return zeroed


def _rel_diffs(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_train_bf16_parity(tmp: str) -> None:
    """bfloat16, 2 layers at full width, batch 4: the same 4 steps (lr 0
    on the first, then the full rate) with flash on the tensor-core
    kernels (the fused backward, then the split pair) and with naive
    attention; then the control, flash with the backward's gradients
    zeroed, which must fail the limits."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.train import cli

    runs = {}
    for name in ("naive", "flash", "flash_split", "zeroed_attention_grads"):
        impl = "naive" if name == "naive" else "flash"
        out = os.path.join(tmp, f"bf16_parity_{name}")
        _reset_counts()
        real = fa.flash_bwd
        if name == "zeroed_attention_grads":
            fa.flash_bwd = _zeroed(real)
        fa.FORCE_SPLIT_BWD = name == "flash_split"
        try:
            check(cli.main(_train_overrides(
                out, 4, batch=4,
                extra=("+model.n_layers=2", "train.warmup_steps=1",
                       f"model.attention_impl={impl}"))) == 0,
                f"bf16 parity run {name} failed")
        finally:
            fa.flash_bwd = real
            fa.FORCE_SPLIT_BWD = False
        rows = _metrics_rows(out)
        runs[name] = {"losses": [r["loss"] for r in rows],
                      # The first row (the warm-up step) logs none.
                      "grad_norms": [r["grad_norm"] for r in rows
                                     if "grad_norm" in r],
                      "launches": _read_counts(),
                      "launches_by_design": _read_designs()}
    want = runs["naive"]
    for name in ("flash", "flash_split", "zeroed_attention_grads"):
        got = runs[name]
        check(len(got["losses"]) == len(want["losses"]) == 4
              and len(got["grad_norms"]) == len(want["grad_norms"]) == 3,
              f"bf16 parity {name}: {got['losses']} vs {want['losses']}")
        check(all(math.isfinite(x) for x in got["losses"] + want["losses"]),
              f"bf16 parity {name}: non-finite {got['losses']}")
        got["loss_rel_diff"] = _rel_diffs(got["losses"], want["losses"])
        got["grad_norm_rel_diff"] = _rel_diffs(got["grad_norms"],
                                               want["grad_norms"])
        got["within"] = (got["loss_rel_diff"] <= TRAIN_BF16_PARITY_RTOL
                         and got["grad_norm_rel_diff"]
                         <= TRAIN_BF16_GRAD_NORM_RTOL)
    check(runs["naive"]["launches"]["flash_fwd"] == 0, "naive took flash")
    for run, names in (("flash", ("flash_fwd", "flash_bwd_fused")),
                       ("flash_split", ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv"))):
        designs = runs[run]["launches_by_design"]
        _check_designs({n: designs[n] for n in names}, "wgmma",
                       f"bf16 parity {run}")
        for name in names:
            check(designs[name]["wgmma"] == 2 * 4,
                  f"bf16 parity {run}: {name} wgmma launches "
                  f"{designs[name]}")
    emit({"phase": "train_bf16_parity", "dtype": "bfloat16", "n_layers": 2,
          "batch": 4, "steps": 4, "warmup_steps": 1,
          "loss_rtol": TRAIN_BF16_PARITY_RTOL,
          "grad_norm_rtol": TRAIN_BF16_GRAD_NORM_RTOL, **runs})
    for run in ("flash", "flash_split"):
        check(runs[run]["within"],
              f"bf16 parity: {run} vs naive outside the limits: {runs[run]}")
    check(not runs["zeroed_attention_grads"]["within"],
          "bf16 parity: the control with zeroed attention gradients passed")


def phase_train_trace(split: bool = False) -> None:
    """Where a training step's time goes: 3 steps at full width under
    ``torch.profiler``, after 2 unprofiled ones, with the fused backward
    or (``split``) the split pair. ``host_attention_bwd_us`` is the host
    time of the attention backward's autograd nodes (dispatch and
    launches; the profiler inflates it alike on both paths)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.runtime import initialize_runtime
    from distributed_training_tpu_torch.train.trainer import Trainer

    cfg = load_config(overrides=["model=gpt2_125m", "train=gpt2",
                                 "train.dataset_size=40"])
    rt = initialize_runtime(cfg)
    loader = ShardedDataLoader(
        build_dataset(cfg.train.dataset, _defaults={"size": 40, "seed": 0},
                      **cfg.train.dataset_kwargs), rt, batch_size=8)
    model = build_model(cfg.model.name, dtype=cfg.train.dtype,
                        device=rt.device, **cfg.model.kwargs)
    trainer = Trainer(cfg, rt, model, loader)
    batches = iter(loader.epoch(0))
    fa.FORCE_SPLIT_BWD = split
    try:
        for _ in range(2):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        _reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(next(batches))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        fa.FORCE_SPLIT_BWD = False
    batches.close()
    launches = _read_counts()
    bwd = ("flash_bwd_dq", "flash_bwd_dkv") if split else ("flash_bwd_fused",)
    check(all(launches[n] == 12 * 3 for n in bwd),
          f"train_trace split={split}: backward launches {launches}")
    dev = _device_time(prof, wall_us, top_n=12)
    host_bwd = sum(e.cpu_time_total for e in prof.events()
                   if e.name.startswith("autograd::engine::evaluate_function")
                   and "_FlashAttentionBackward" in e.name)
    emit({"phase": "train_trace_split" if split else "train_trace",
          "steps": 3, "batch": 8, "seq": 1024, **dev,
          "host_ms_per_step": wall_us / 3e3,
          "device_ms_per_step": dev["device_busy_us"] / 3e3,
          "attention_share": dev["flash_us"] / dev["device_busy_us"],
          "host_attention_bwd_us": host_bwd, "launches": launches})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import distributed_training_tpu_torch  # noqa: F401 — needs the repo

    device = phase_device()
    phase_build()
    measured = phase_kernels()
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, size=8)
    prompts = [rng.integers(0, 50257, size=int(n)).astype(np.int32)
               for n in lens]
    serve_launches, batched = phase_serving(prompts, 64)
    long = {i: p for i, p in enumerate(prompts) if len(p) >= 128}
    check(len(long) >= 2, "fewer than two prompts of >= 128 tokens")
    seq_launches = phase_sequential(long, 64, batched)
    phase_parity([p for p in prompts if len(p) >= 128][:2], 16)
    phase_trace(prompts, 64)
    with tempfile.TemporaryDirectory(prefix="dtt_chip_smoke_") as tmp:
        train_launches = phase_train(tmp)
        split_launches = phase_train_split(tmp)
        phase_train_parity(tmp)
        phase_train_bf16_parity(tmp)
    phase_train_trace()
    phase_train_trace(split=True)
    # The sources of the designs the main paths' launches took (checked
    # below from their counts).
    sources = {
        "flash_fwd": (
            "distributed_training_tpu_torch/csrc/flash_fwd_sm90.cu",
            "distributed_training_tpu/ops/flash_attention.py:187"),
        "flash_bwd_fused": (
            "distributed_training_tpu_torch/csrc/flash_bwd_sm90.cu",
            "distributed_training_tpu/ops/flash_attention.py:398"),
        "flash_bwd_dq": (
            "distributed_training_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
            "distributed_training_tpu/ops/flash_attention.py:296"),
        "flash_bwd_dkv": (
            "distributed_training_tpu_torch/csrc/flash_bwd_sm90.cu",
            "distributed_training_tpu/ops/flash_attention.py:346"),
        "paged_decode": (
            "distributed_training_tpu_torch/csrc/paged_decode.cu",
            "distributed_training_tpu/ops/paged_attention.py:152")}
    # Launches: the sum over the paths driven above, each counted from 0
    # (serving, sequential prefill, training, split-backward training).
    paths = (serve_launches, seq_launches, train_launches, split_launches)
    kernels = []
    for name in KERNELS:
        src, replaces = sources[name]
        m = measured[name]
        by_design = {"simt": sum(p[name] for p, _ in paths)}
        if name in paths[0][1]:
            by_design = {d: sum(ds[name][d] for _, ds in paths)
                         for d in paths[0][1][name]}
        taken = [d for d, n in by_design.items() if n]
        check(len(taken) == 1 and (taken[0] == "wgmma") == ("_sm90" in src),
              f"{name}: main-path launches by design {by_design}, source "
              f"{src}")
        kernels.append({
            "name": name, "route": "cuda", "design": taken[0],
            "source": src, "replaces": replaces,
            "launches": sum(p[name] for p, _ in paths),
            "launches_by_design": by_design,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the path was never launched")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
its launch took. Paged decode has one design, ``split_kv`` (the KV walk
split over blocks, a combine pass): gpt2_125m's serving geometry,
an f32 GQA case, and transformer_7b's and transformer_1b's attention
heads over 2048 cached tokens, each also checked for the same bits on a
second launch, and at the geometries of one serving mesh rank (8 rows
at 6 kv heads, 4 rows at 12). The cross-entropy's bf16 GEMMs with f32
outputs are held against the same products on operands widened to f32.
Then it
drives both main paths at full width of gpt2_125m, random weights from
a seed:

- serving: ``Engine`` + ``ServingServer`` over HTTP (batched prefill,
  paged decode), the sequential prefill whose first chunk takes the
  flash forward, speculative decode over HTTP (spec_k 4: each launch
  verifies a chain of drafted tokens through paged decode at 32 rows),
  device-resident decode (resident_k 8, each burst one replay of a CUDA
  graph captured at warmup, its first burst held against the eager body
  bit for bit), float32 greedy tokens of every decode form against the
  dense forward, and ``torch.profiler`` traces of one burst with
  one-token and with resident decode;
- training: the trainer CLI (``python -m distributed_training_tpu_torch.
  train model=gpt2_125m train=gpt2``) for 20 steps with the fused flash
  backward and 10 with the split one (every bf16 flash launch on the
  tensor-core design), float32 losses of flash (fused, split; the SIMT
  design) and bfloat16 losses and gradient norms of flash (fused, split;
  tensor cores) against naive attention at reduced depth, with a
  planted fault that must fail the same limits, and profiler traces of
  training steps with each backward;
- sharded training: transformer_1b at full width (1.41 B params, head
  dim 128) for 10 steps through the CLI under ``fsdp`` in a NCCL process
  group of one rank (weights sharded over an fsdp group of one and
  gathered a layer at a time, the flash kernels at head dim 128 on the
  tensor cores), with a profiler trace of two steps; and gpt2_125m under
  ``fsdp`` with a sharded save at step 2, its consolidated artifact, and
  a resume from it that matches the uninterrupted run bit for bit, as
  do ``ddp`` with no process group and ``ddp`` with its optimizer state
  offloaded to pinned host memory;
- serving on a mesh (``serving_dp2``, ``serving_tp2``): two processes
  on ``cuda:0`` in a gloo group, each one rank of the mesh dp 2 (a dp
  group of 4 slots with its own pool) or tp 2 (6 of the 12 heads, half
  the MLP and the vocab), through ``Engine(..., mesh=runtime)``: the
  float32 logits of every request's first decoded position held against
  one process, with a planted fault that must fail the same limit; then
  bf16, the serving prompts batched and the long ones sequential, token
  agreement reported, collectives and launches held to the design;
- tensor parallelism: transformer_1b at full width under ``tp_fsdp``
  (tp 1, fsdp 1) through the CLI in a NCCL group of one rank, every
  tensor-parallel collective over a group of one, its losses held
  against ``train_1b``'s; and gpt2_125m at full width under ``tp`` at
  tp 2 on the one card (``train_tp2``): two processes on ``cuda:0`` in a
  gloo group, each on 6 of the 12 heads and half the vocab, the Trainer
  driven directly, its losses and gradient norms held against one
  process under ``ddp``, with a planted fault (layer 0's attention
  all-reduce dropped) that must fail the same limits;
- serving weights and recovery: gpt2_125m served from int8 weight-only
  leaves (``serving_int8``: batched and sequential prefill, one-token
  and resident decode beside the bf16 engine, and float32 first-decode
  logits against the plain forward on the dequantized weights); a live
  weight swap on a resident engine (``serving_swap``: an identical-value
  host publish mid-stream gives the unswapped tokens bit for bit with
  one graph capture, and a swap to second-seed weights at the staleness
  bound 0 equals a fresh engine on them at float32); and
  ``engine_crash`` under ``supervise_serving`` (``serving_recovery``,
  float32: the KV of every request exported and re-adopted, each stream
  delivered once and equal to the uncrashed run, with a planted fault,
  the high-water marks dropped, that must fail the same check);
- disaggregated serving (``serving_disagg``): the weights written as an
  artifact and loaded through ``WeightStore``, a prefill plan and a
  decode plan at a mesh of 1 built in memory, ``DisaggPipeline`` handing
  each step's finished prompts' KV from the prefill engine to the decode
  engine on the card, against one colocated engine under the decode
  plan's geometry: tokens/s, TTFT, handoff time (CUDA events) and bytes,
  B4 launches, token agreement at bf16 and equality at float32.

Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA card, or without the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import signal
import socket
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
# transformer_1b under fsdp: batch 4 x seq 2048, bf16 compute.
TRAIN_1B_STEPS = 10
# Tensor parallelism against a run without it: the losses and the
# unclipped gradient norms, relative. train_tp_1b repeats train_1b under
# tp_fsdp at tp 1, the same operations: its first two losses (the first
# update moves no weight, lr 0) are train_1b's bits, and later steps part
# by the fused backward's atomic dq order. train_tp2: gpt2_125m,
# conf/train/gpt2.yaml, tp 2 in two processes sharing the card over
# gloo, against one process under ddp, TRAIN_TP2_STEPS steps; the
# row-parallel products also sum two bf16-rounded halves where ddp rounds
# once. Readings on the H100 (PERF.md, PR 8, three calls): train_tp_1b
# within 2.8e-5 (losses) and 8.1e-4 (norms), train_tp2 within 1.2e-5 and
# 6.6e-4, and train_tp2's planted fault (layer 0's attention all-reduce
# dropped) 2.1e-4 to 2.2e-4 and 1.04e-2 to 1.06e-2. Each limit lies above
# every sound reading and below the fault's.
TRAIN_TP2_STEPS = 5
TP_LOSS_RTOL = 1e-4
TP_GRAD_NORM_RTOL = 3e-3
# Serving on a mesh (serving_dp2, serving_tp2): two processes on cuda:0
# over gloo, each one mesh rank. At float32 the logits of the first
# decoded position of every request, mesh engine against one process,
# max abs difference; the sound engine differs from the one-process one
# only in summation order (tp's split sums, paged decode's split plan at
# B_local rows or Hkv/tp heads). The planted faults (dp2: rank 1 launches
# group 0's rows; tp2: layer 0's attention all-reduce dropped) must fall
# outside the limit. Readings on the H100 (PERF.md, PR 9): sound 2.1e-6
# for both meshes, faults 2.96 (dp2) and 1.97 (tp2), the largest logit
# 2.93; the limit lies between.
MESH_LOGITS_TOL = 1e-4
SERVING_MESHES = {"dp2": {"dp": 2}, "tp2": {"tp": 2}}
# serving_int8: float32 logits of the int8 engine's first decoded
# position against the plain forward on the dequantized weights, max
# abs; the two differ in summation order only (paged attention and the
# per-layer dequantization inside the programs against the dense
# forward), as the f32 mesh engines differ from one process (2.1e-6
# on the H100; PERF.md). Read on the H100: 3.58e-6.
INT8_LOGITS_TOL = 1e-4
# serving_int8: device bytes an engine may hold beyond its pools and
# ``weight_bytes`` (its slot tables, generator and scratch: well under a
# MiB at gpt2_125m), far below a second copy of the int8 weights
# (164 MB).
HELD_SLACK_BYTES = 16 << 20
# serving_recovery: the engine crashes after this many decode launches,
# every request then holding decoded tokens to salvage.
RECOVERY_DECODES = 8


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


def paged_inputs(B, H, Hkv, hd, ps, max_len, dtype, lengths=None) -> tuple:
    """Paged-decode operands on the card: shuffled pages, random lengths
    in [1, max_len] from SEED with the last row 0 (or ``lengths``), page
    ids past a sequence's pages 0 (the scratch page)."""
    rng = np.random.default_rng(SEED)
    if lengths is None:
        lengths = rng.integers(1, max_len + 1, size=B).astype(np.int32)
        lengths[-1] = 0
    lengths = np.asarray(lengths, np.int32)
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
    return (q, kp, vp, torch.from_numpy(lengths).cuda(),
            torch.from_numpy(tables).cuda()), lengths


def paged_bound(args, lengths, dtype) -> tuple[float, str]:
    """Bytes: the live K/V rows, q and out, lengths and the live table
    entries; operations: q.k and p.v over the live keys."""
    q, kp = args[0], args[1]
    Hkv, _, ps, hd = kp.shape
    toks = int(lengths.sum())
    nbytes = (2 * toks * Hkv * hd + 2 * q.numel()) * q.element_size() \
        + 4 * (len(lengths) + sum(-(-int(n) // ps) for n in lengths))
    return bound(4.0 * toks * q.shape[1] * hd, nbytes, dtype)


def _paged_case(timer, B, H, Hkv, hd, ps, max_len, dtype,
                lengths=None) -> dict:
    """Paged decode against its plain version; a second launch must give
    the same bits (no atomics), and zero-length rows exact zeros."""
    from distributed_training_tpu_torch.ops import paged_attention as pa

    args, lengths = paged_inputs(B, H, Hkv, hd, ps, max_len, dtype, lengths)
    before = dict(pa.paged_attention.launches_by_design)
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    design = _design_taken(pa.paged_attention, before)
    again = pa.paged_attention(*args)
    ref = pa.paged_attention(*args, impl="ref")
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"paged_decode {B}x{H}/{Hkv} hd {hd} ps {ps} {dtype}: max err "
          f"{err} > {tol}")
    check(torch.equal(out, again), "paged_decode: a second launch gave "
          "other bits")
    empty = [b for b in range(B) if lengths[b] == 0]
    check(all(out[b].abs().max().item() == 0.0 for b in empty),
          "a length-0 row is not zero")
    splits, pages = pa.split_kv_plan(B, Hkv, max_len // ps, ps)
    bound_ms, bound_by = paged_bound(args, lengths, dtype)
    return {"shape": [B, H, Hkv, hd, ps], "dtype": str(dtype).split(".")[1],
            "design": design, "splits": splits, "pages_per_split": pages,
            "lengths": lengths.tolist(), "max_abs_err": err,
            "bit_identical": True,
            "ms": timer.ms(lambda: pa.paged_attention(*args)),
            "plain_ms": timer.ms(lambda: pa.paged_attention(
                *args, impl="ref")),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _chain_case(timer, S, C, H, hd, ps, max_len, dtype, starts) -> dict:
    """Paged decode at the decode chain's geometry (speculative and
    resident decode): S slots of C queries at positions start + c, one
    launch over S * C rows with lengths start + c + 1 and each slot's
    page row repeated (``paged_decode_chain``), against the paged chunk
    form (its plain version); a dead slot (start < 0) and its zeros; the
    same bits on a second launch. The bound moves each slot's live K/V
    rows once (its C rows share them)."""
    from distributed_training_tpu_torch.ops import paged_attention as pa

    live = [s + C if s >= 0 else 0 for s in starts]
    (_, kp, vp, _, rows), _ = paged_inputs(S, H, H, hd, ps, max_len, dtype,
                                           lengths=live)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q = torch.randn(S, C, H, hd, generator=g, device="cuda").to(dtype)
    start = torch.tensor(starts, device="cuda")
    q_pos = torch.where(start[:, None] >= 0,
                        start[:, None] + torch.arange(C, device="cuda"), -1)
    lengths = (q_pos + 1).reshape(-1).int()
    rows_flat = rows.repeat_interleave(C, dim=0)
    qf = q.reshape(S * C, H, hd)
    before = dict(pa.paged_attention.launches_by_design)
    out = pa.paged_decode_chain(q, kp, vp, rows, q_pos)
    torch.cuda.synchronize()
    design = _design_taken(pa.paged_attention, before)
    again = pa.paged_decode_chain(q, kp, vp, rows, q_pos)
    ref = pa.paged_attention_chunk(q, kp, vp, rows, q_pos)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
          f"paged_decode chain {S}x{C}: max err {err} > {tol}")
    check(torch.equal(out, again), "paged_decode chain: a second launch "
          "gave other bits")
    dead = [i for i, s in enumerate(starts) if s < 0]
    check(all(out[i].abs().max().item() == 0.0 for i in dead),
          "a dead slot's chain is not zero")
    toks = int(lengths.sum())
    nbytes = (2 * sum(live) * H * hd + 2 * q.numel()) * q.element_size() \
        + 4 * (S * C + sum(-(-n // ps) for n in live))
    bound_ms, bound_by = bound(4.0 * toks * H * hd, nbytes, dtype)
    splits, pages = pa.split_kv_plan(S * C, H, max_len // ps, ps)
    return {"slots": S, "chain": C, "rows": S * C,
            "shape": [S * C, H, H, hd, ps], "dtype": str(dtype).split(".")[1],
            "design": design, "splits": splits, "pages_per_split": pages,
            "starts": list(starts), "max_abs_err": err, "bit_identical": True,
            "ms": timer.ms(lambda: pa.paged_attention(qf, kp, vp, lengths,
                                                      rows_flat)),
            "plain_ms": timer.ms(lambda: pa.paged_attention_chunk(
                q, kp, vp, rows, q_pos)),
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
        # transformer_1b's attention as train_1b gives it: B 4, H 16,
        # S 2048, D 128.
        "d128": _flash_case(timer, 4, 16, 16, 2048, 128, bf16, library=True),
        "d128_gqa_window": _flash_case(timer, 2, 16, 4, 2048, 128, bf16,
                                       window=512),
    }
    flash["train"] = _flash_case(timer, 8, 12, 12, 1024, 64, bf16,
                                 library=True)
    # gpt2_125m's attention under tp 2 (train_tp2): each rank's 6 heads.
    flash["tp2"] = _flash_case(timer, 8, 6, 6, 1024, 64, bf16, library=True)
    paged = {"main": _paged_case(timer, 8, 12, 12, 64, 16, 1024, bf16),
             "f32_gqa": _paged_case(timer, 8, 12, 4, 64, 16, 1024, f32),
             # transformer_7b's attention heads (H 32, Hkv 8, hd 128) over
             # up to 2048 cached tokens a sequence.
             "long_gqa": _paged_case(timer, 8, 32, 8, 128, 16, 2048, bf16),
             # transformer_1b's (H = Hkv 16, hd 128): one sequence of 2048
             # tokens, which only a split walk spreads over the card.
             "long_single": _paged_case(timer, 1, 16, 16, 128, 16, 2048,
                                        bf16, lengths=[2048]),
             # The decode chain of serving_spec and serving_resident: 8
             # slots x spec_k 4 = 32 rows, the main case's lengths as
             # each chain's first position, one dead slot.
             "chain": _chain_case(timer, 8, 4, 12, 64, 16, 1024, bf16,
                                  [871, 652, 523, 276, 315, 41, 77, -1]),
             # One mesh rank's decode (serving_tp2, serving_dp2): the 8
             # slots at tp 2's 6 kv heads, and a dp group's 4 slots at
             # all 12.
             "tp2_rank": _paged_case(timer, 8, 6, 6, 64, 16, 1024, bf16),
             "dp2_rank": _paged_case(timer, 4, 12, 12, 64, 16, 1024, bf16)}
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
        # transformer_1b's attention as train_1b gives it: B 4, H 16,
        # S 2048, D 128.
        bwd[f"{tag}_d128"] = _bwd_case(timer, 4, 16, 16, 2048, 128, bf16,
                                       split, library=True)
        bwd[f"{tag}_d128_gqa_window_grads_f32"] = _bwd_case(
            timer, 2, 16, 4, 2048, 128, bf16, split, window=512,
            grads_dtype=f32)
    # gpt2_125m under tp 2 (train_tp2, the fused backward): each rank's 6
    # heads.
    bwd["fused_tp2"] = _bwd_case(timer, 8, 6, 6, 1024, 64, bf16, False,
                                 library=True)
    # The SIMT kernels on bf16 inputs with f32 gradients: fused at head
    # dim 32 (GRADS_F32_OF_BF16_TOL), the split pair at head dim 96 (TOL,
    # 1e-4).
    bwd["fused_simt_d32_grads_f32"] = _bwd_case(
        timer, 8, 12, 12, 1024, 32, bf16, False, grads_dtype=f32)
    bwd["split_simt_d96_grads_f32"] = _bwd_case(
        timer, 2, 8, 2, 256, 96, bf16, True, grads_dtype=f32)
    emit({"phase": "kernels_bwd", **bwd})
    return {"flash_fwd": flash["train"], "paged_decode": paged["main"],
            "paged_decode_chain": paged["chain"],
            "paged_decode_tp2": paged["tp2_rank"],
            "paged_decode_dp2": paged["dp2_rank"],
            "flash_fwd_tp2": flash["tp2"],
            "flash_bwd_fused_tp2": bwd["fused_tp2"]["flash_bwd_fused"],
            "flash_bwd_fused": bwd["fused_train"]["flash_bwd_fused"],
            "flash_bwd_dq": bwd["split_train"]["flash_bwd_dq"],
            "flash_bwd_dkv": bwd["split_train"]["flash_bwd_dkv"]}


def _xent_widened(x, head, t) -> tuple:
    """The cross-entropy's nll, dx and dhead (for dnll = 1, no masked
    targets) with every product taken on bf16 operands widened to f32,
    in one chunk: the arithmetic the op keeps on the CPU."""
    D = x.shape[-1]
    xf, hf = x.reshape(-1, D).float(), head.float()
    logits = xf @ hf
    lse = torch.logsumexp(logits, dim=-1)
    tt = t.reshape(-1, 1).long()
    nll = lse - logits.gather(-1, tt)[:, 0]
    p = torch.exp(logits - lse[:, None])
    p.scatter_add_(-1, tt, torch.full(tt.shape, -1.0, device=p.device))
    dl = p.to(x.dtype).float()
    return (nll.view(t.shape), (dl @ hf.T).to(x.dtype).view(x.shape),
            (xf.T @ dl).to(head.dtype), logits)


def phase_xent() -> None:
    """``lm_cross_entropy`` on bf16 inputs on the card, whose products
    are bf16 GEMMs with f32 outputs (``torch.mm(..., out_dtype=f32)``),
    against the same products on operands widened to f32, at the
    limits of tests/test_torch_xent.py's bf16 case: nll within 1e-4;
    dx and dhead within one bf16 ulp (rtol 2**-7) plus 1e-3, for a
    dlogit on a rounding boundary. At that case's shape and at
    gpt2_125m's training shape (B 8, S 1024, D 768, V 50304, the head at
    its init scale). The control: the nll from logits rounded to bf16,
    the fault this repaired, must miss the 1e-4."""
    from distributed_training_tpu_torch.ops.xent import lm_cross_entropy

    res = {}
    for name, (B, S, D, V, scale) in {
            "c1_case": (4, 256, 64, 2048, 0.3),
            "gpt2_train": (8, 1024, 768, 50304, 0.02)}.items():
        rng = np.random.default_rng(SEED)
        x = torch.from_numpy(rng.standard_normal((B, S, D), np.float32))
        head = torch.from_numpy(
            (scale * rng.standard_normal((D, V))).astype(np.float32))
        t = torch.from_numpy(rng.integers(0, V, size=(B, S))).cuda()
        x = x.to("cuda", torch.bfloat16).requires_grad_()
        head = head.to("cuda", torch.bfloat16).requires_grad_()
        nll = lm_cross_entropy(x, head, t)
        dx, dh = torch.autograd.grad(nll.sum(), (x, head))
        with torch.no_grad():
            w_nll, w_dx, w_dh, logits = _xent_widened(x, head, t)
            err = (nll - w_nll).abs().max().item()
            lb = logits.bfloat16().float()
            ctrl_nll = (torch.logsumexp(lb, dim=-1)
                        - lb.gather(-1, t.reshape(-1, 1))[:, 0])
            ctrl = (ctrl_nll.view(t.shape) - w_nll).abs().max().item()
        check(err <= 1e-4, f"xent {name}: nll off the widened products by "
              f"{err}")
        check(ctrl > 1e-4, f"xent {name}: the bf16-logits control {ctrl} "
              "within 1e-4")
        for what, got, want in (("dx", dx, w_dx), ("dhead", dh, w_dh)):
            check(torch.isclose(got.float(), want.float(), rtol=2 ** -7,
                                atol=1e-3).all().item(),
                  f"xent {name}: {what} off the widened products by more "
                  "than rtol 2**-7 + atol 1e-3")
        res[name] = {
            "shape": [B, S, D, V], "nll_max_abs_err": err,
            "bf16_logits_control_err": ctrl,
            "dx_max_abs_err": (dx.float() - w_dx.float()).abs().max().item(),
            "dhead_max_abs_err": (dh.float() - w_dh.float()).abs().max()
            .item()}
        del x, head, nll, dx, dh, w_dx, w_dh, logits, lb
    emit({"phase": "xent", **res})


def _gpt2(dtype: str):
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )

    model = Transformer(TransformerConfig(**PRESETS["gpt2_125m"],
                                          dtype=dtype, param_dtype=dtype))
    return model, model.init(SEED)


def _engine_config(**over):
    """The serving phases' engine geometry: 8 slots of 1024 tokens, the
    one ``conf/serving/default.yaml`` gives a plan at a mesh of 1 with 8
    slots of 1024 tokens (phase serving_cli checks it)."""
    from distributed_training_tpu_torch.serving.engine import EngineConfig

    kw = dict(max_batch=8, page_size=16, num_pages=513, max_seq_len=1024,
              prefill_chunk=16, prefix_sharing=True, prefill_mode="batched",
              policy="prefill", temperature=0.0)
    kw.update(over)
    return EngineConfig(**kw)


def _engine(model, params, mesh=None, **over):
    from distributed_training_tpu_torch.serving.engine import Engine

    return Engine(model, params, _engine_config(**over), mesh=mesh)


def _smoke_prompts() -> list:
    """The serving phases' 8 prompts of 64–512 tokens, from SEED."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, size=8)
    return [rng.integers(0, 50257, size=int(n)).astype(np.int32)
            for n in lens]


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


def _http_burst(eng, prompts: list, new_tokens: int, what: str) -> dict:
    """The prompts as concurrent HTTP requests through ``ServingServer``,
    plus one streamed repeat of prompt 0 (its tokens are held against
    the plain request's), with the launch counts and the engine's decode
    launches and host syncs counted from 0 around the burst. Paged
    decode must run at least once per layer per decode launch, all on
    ``split_kv``."""
    from distributed_training_tpu_torch.serving.server import ServingServer

    srv = ServingServer(eng, port=0).start()
    check(srv is not None, "server did not start")
    results: dict = {}
    bodies = [{"prompt_ids": p.tolist(), "max_new_tokens": new_tokens}
              for p in prompts]
    bodies.append(dict(bodies[0], stream=True))

    def client(i):
        results[i] = _post(srv.port, bodies[i])

    try:
        decode0, syncs0 = eng.decode_launches, eng.host_syncs
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
        syncs = eng.host_syncs - syncs0
    finally:
        srv.stop()
    check(len(results) == len(bodies), f"{what}: not every request "
          "completed")
    lines = results[len(bodies) - 1]
    streamed = [x["token"] for x in lines if "token" in x]
    final = lines[-1]
    check(final.get("done") and final["tokens"] == streamed,
          f"{what}: stream's token lines differ from its final line")
    check(streamed == results[0]["tokens"],
          f"{what}: streamed tokens differ from the plain request's")
    plain = [results[i] for i in range(len(prompts))]
    check(all(len(r["tokens"]) == new_tokens for r in plain),
          f"{what}: a request returned the wrong number of tokens")
    check(launches["paged_decode"] >= 12 * decode_launches > 0,
          f"{what}: paged decode launches {launches['paged_decode']} < 12 "
          f"x {decode_launches} decode launches")
    _check_designs({"paged_decode": designs["paged_decode"]}, "split_kv",
                   what)
    generated = sum(len(r["tokens"]) for r in plain) + len(streamed)
    ttfts = [r["ttft_s"] for r in plain] + [final["ttft_s"]]
    return {"wall_s": wall, "tokens_per_s": generated / wall,
            "mean_ttft_s": float(np.mean(ttfts)),
            "decode_launches": decode_launches, "host_syncs": syncs,
            "launches": launches, "launches_by_design": designs,
            "leaked_threads": srv.leaked_threads,
            "tokens": {i: r["tokens"] for i, r in enumerate(plain)}}


def _matching(got: dict, want: dict) -> int:
    """Tokens at the same place in the same request's stream."""
    return sum(int(a == b) for i in got for a, b in zip(got[i], want[i]))


def phase_serving(prompts: list, new_tokens: int) -> tuple[tuple, dict]:
    torch.cuda.reset_peak_memory_stats()
    model, params = _gpt2("bfloat16")
    eng = _engine(model, params)
    counts = eng.warmup()
    res = _http_burst(eng, prompts, new_tokens, "serving")
    check(eng.compile_counts() == counts, "kernel builds after warmup")
    info = {"phase": "serving", "model": "gpt2_125m", "dtype": "bfloat16",
            "requests": len(prompts) + 1,
            "prompt_lens": [len(p) for p in prompts],
            "new_tokens": new_tokens, "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens_per_s"],
            "mean_ttft_s": res["mean_ttft_s"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "decode_launches": res["decode_launches"],
            "prefill_launches": eng.prefill_launches,
            "host_syncs": res["host_syncs"], "launches": res["launches"],
            "launches_by_design": res["launches_by_design"],
            "compile_counts": counts,
            "leaked_threads": res["leaked_threads"]}
    emit(info)
    return (res["launches"], res["launches_by_design"]), res["tokens"]


def phase_serving_spec(prompts: list, new_tokens: int,
                       batched_tokens: dict) -> tuple:
    """phase_serving's requests with speculative decode (spec_k 4): each
    decode launch verifies every slot's last token and three drafted
    ones in one chain through paged decode (32 rows), eager, and may
    emit several tokens a slot, streamed as they come."""
    model, params = _gpt2("bfloat16")
    eng = _engine(model, params, spec_k=4)
    counts = eng.warmup()
    res = _http_burst(eng, prompts, new_tokens, "serving_spec")
    check(eng.compile_counts() == counts, "serving_spec: kernel builds "
          "after warmup")
    st = eng.spec_stats
    emit({"phase": "serving_spec", "dtype": "bfloat16", "spec_k": 4,
          "requests": len(prompts) + 1, "new_tokens": new_tokens,
          **{k: res[k] for k in ("wall_s", "tokens_per_s", "mean_ttft_s",
                                 "decode_launches", "host_syncs",
                                 "launches", "launches_by_design",
                                 "leaked_threads")},
          "spec_stats": st,
          "spec_accepted_mean": st["emitted"] / max(1, st["launches"]),
          "compile_counts": counts,
          "tokens_matching_serving": _matching(res["tokens"],
                                               batched_tokens),
          "tokens_total": sum(len(t) for t in res["tokens"].values())})
    return res["launches"], res["launches_by_design"]


def _check_replay_equals_eager(eng) -> dict:
    """Wrap the engine's resident graph so that its first burst is also
    run through the eager body (``_resident_program`` on the same static
    inputs) on clones of the pools taken before the replay: ``out``,
    ``n_emitted`` and ``steps`` must be identical, the pools bitwise
    equal over pages >= 1 (dead lanes all write the scratch page 0
    through one scatter with duplicate indices, so its bytes are not
    deterministic). The eager run's launches are not counted."""
    from distributed_training_tpu_torch.ops import paged_attention as pa

    g, report = eng._resident, {}
    replay = g.run

    def run_checked(*arrays):
        if report:
            return replay(*arrays)
        kp, vp = eng.cache.k_pages.clone(), eng.cache.v_pages.clone()
        got = [t.clone() for t in replay(*arrays)]
        n0, d0 = pa.paged_attention.launches, dict(
            pa.paged_attention.launches_by_design)
        want = g.eager(kp, vp)
        torch.cuda.synchronize()
        pa.paged_attention.launches = n0
        pa.paged_attention.launches_by_design.update(d0)
        live = (slice(None),) * 3 + (slice(1, None),)
        report.update(
            out=torch.equal(got[0], want[0]),
            n_emitted=torch.equal(got[1], want[1]),
            steps=torch.equal(got[2], want[2]),
            k_pages=torch.equal(eng.cache.k_pages[live], kp[live]),
            v_pages=torch.equal(eng.cache.v_pages[live], vp[live]),
            emitted=int(got[1].sum()))
        return got

    g.run = run_checked
    return report


def _time_bursts(eng) -> list:
    """Wrap the engine's resident graph so that each burst's device time
    (its input copies and the replay) is taken by CUDA events; read the
    returned (start, end) pairs after a synchronize."""
    g, events = eng._resident, []
    run = g.run

    def timed(*arrays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(*arrays)
        end.record()
        events.append((start, end))
        return out

    g.run = timed
    return events


def phase_serving_resident(prompts: list, new_tokens: int,
                           batched_tokens: dict) -> tuple:
    """phase_serving's prompts through the engine (no HTTP) with
    device-resident decode, resident_k 8, at spec_k 1 and 4: each burst
    is one replay of the CUDA graph captured at warmup (8 chain
    iterations, every layer's attention through paged decode), one host
    sync a burst. The first burst of the first engine is also run
    through the eager body and must match the replay exactly."""
    from distributed_training_tpu_torch.serving.engine import Request

    model, params = _gpt2("bfloat16")
    K = 8
    runs, launches_all, designs_all = {}, None, None
    for sk in (1, 4):
        what = f"serving_resident spec_k={sk}"
        eng = _engine(model, params, resident_k=K, spec_k=sk)
        counts = eng.warmup()
        check(counts["decode_graph"] == 1, f"{what}: {counts['decode_graph']} "
              "graph captures at warmup")
        events = _time_bursts(eng)
        replay_check = _check_replay_equals_eager(eng) if sk == 1 else None
        _reset_counts()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
        recs = []
        while not eng.idle:
            recs.append(eng.step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, designs = _read_counts(), _read_designs()
        st = eng.resident_stats
        bursts = [r for r in recs if r["op"] == "decode" and r["tokens"]]
        check(len(bursts) == st["launches"] > 0
              and all(r["host_syncs"] == 1 for r in bursts),
              f"{what}: decode steps' host syncs "
              f"{[r['host_syncs'] for r in bursts]}, {st['launches']} bursts")
        check(launches["paged_decode"] == 12 * K * st["launches"],
              f"{what}: paged decode launches {launches['paged_decode']} "
              f"!= 12 x {K} x {st['launches']} replays")
        _check_designs({"paged_decode": designs["paged_decode"]}, "split_kv",
                       what)
        check(eng.compile_counts() == counts, f"{what}: a build or a capture "
              "after warmup")
        got = {int(r["id"]): r["tokens"] for r in eng.completed}
        check(len(got) == len(prompts) and all(
            len(t) == new_tokens for t in got.values()),
            f"{what}: not every request completed in full")
        if replay_check is not None:
            check(replay_check and all(
                replay_check[k] for k in ("out", "n_emitted", "steps",
                                          "k_pages", "v_pages")),
                f"{what}: graph replay differs from the eager body: "
                f"{replay_check}")
        burst_ms = [a.elapsed_time(b) for a, b in events]
        wall_by_op = {op: sum(r["dur_s"] for r in recs if r["op"] == op)
                      for op in ("prefill", "decode")}
        runs[f"spec_k_{sk}"] = {
            "wall_s": wall,
            # The first burst also ran the replay check's clones.
            "burst_device_ms": burst_ms,
            "iteration_device_ms": float(np.median(burst_ms[1:] or burst_ms))
            / K,
            "prefill_wall_s": wall_by_op["prefill"],
            "decode_wall_s": wall_by_op["decode"],
            "prefill_share_of_steps": wall_by_op["prefill"]
            / sum(wall_by_op.values()),
            "tokens_per_s": sum(len(t) for t in got.values()) / wall,
            "mean_ttft_s": float(np.mean([r["ttft_s"]
                                          for r in eng.completed])),
            "resident_stats": dict(st),
            "resident_steps_per_launch": st["steps"] / st["launches"],
            "bursts": st["launches"], "host_syncs": eng.host_syncs,
            "prefill_launches": eng.prefill_launches,
            "launches": launches, "launches_by_design": designs,
            "compile_counts": counts,
            "tokens_matching_serving": _matching(got, batched_tokens),
            "tokens_total": sum(len(t) for t in got.values()),
            **({"replay_equals_eager": replay_check} if replay_check
               else {})}
        if launches_all is None:
            launches_all, designs_all = launches, designs
        else:
            launches_all = {k: launches_all[k] + launches[k]
                            for k in launches}
            designs_all = {n: {d: designs_all[n][d] + c
                               for d, c in ds.items()}
                           for n, ds in designs.items()}
        del eng
        _free_memory()
    emit({"phase": "serving_resident", "dtype": "bfloat16", "resident_k": K,
          "requests": len(prompts), "new_tokens": new_tokens, **runs})
    return launches_all, designs_all


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
    _check_designs({"paged_decode": designs["paged_decode"]}, "split_kv",
                   "sequential")
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
    Transformer.apply, in both prefill modes, and with speculative
    (spec_k 4) and resident (resident_k 8) decode. A token may differ
    only where the dense top-2 margin is below 1e-3 (a near tie that
    another summation order may flip); the stream is compared up to
    there."""
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
    engines = (("batched", dict(prefill_mode="batched", prefill_chunk=16)),
               ("sequential", dict(prefill_mode="sequential",
                                   prefill_chunk=128)),
               ("spec_k_4", dict(spec_k=4)),
               ("resident_k_8", dict(resident_k=8)))
    for mode, over in engines:
        eng = _engine(model, params, **over)
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
    for mode in ("spec_k_4", "resident_k_8"):
        check(report[mode]["launches"]["paged_decode"] > 0,
              f"parity {mode}: paged decode not on the compared path")
    emit({"phase": "parity", "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts], "tokens": n,
          **report})


def _summed_launches(runs: list) -> tuple:
    """The kernel launches and launches by design of several runs."""
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    designs = {n: {d: sum(r["launches_by_design"][n][d] for r in runs)
                   for d in ds}
               for n, ds in runs[0]["launches_by_design"].items()}
    return launches, designs


def _dequantized(tree: dict) -> dict:
    """An int8 weight tree with each ``{"qw", "scale"}`` leaf replaced by
    ``qw * scale`` in f32: the weights the plain forward runs on."""
    return {k: (v["qw"].float() * v["scale"] if "qw" in v
                else _dequantized(v)) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _host_copy(tree: dict) -> dict:
    """The same values in host memory: a publish from the host."""
    from distributed_training_tpu_torch.train.optimizer import (
        flatten,
        unflatten,
    )

    return unflatten({k: t.cpu() for k, t in flatten(tree).items()})


def phase_serving_int8(prompts: list, new_tokens: int,
                       batched_tokens: dict) -> tuple:
    """gpt2_125m served from int8 weight-only leaves (every q/k/v/o and
    MLP weight, dequantized to bf16 one layer at a time inside the
    programs), engine only: batched prefill with one-token decode and
    with resident_k 8 (each beside the same run on the bf16 weights, in
    this call), and sequential prefill (chunk 128) over the long prompts,
    whose first chunks take the flash forward on int8-dequantized q/k/v.
    Then float32: every request's first-decode logits of the int8 engine
    against the plain forward on the dequantized weights."""
    from distributed_training_tpu_torch.serving.disagg import (
        quantize_params_int8,
        quantized_weight_bytes,
    )

    model, params = _gpt2("bfloat16")
    qparams = quantize_params_int8(params)
    long = [i for i, p in enumerate(prompts) if len(p) >= 128]
    K = 8
    runs, counted = {}, []
    for name, tree, over, ids in (
            ("bf16_one_token", params, {}, range(len(prompts))),
            ("int8_one_token", qparams, {}, range(len(prompts))),
            ("bf16_resident_k_8", params, {"resident_k": K},
             range(len(prompts))),
            ("int8_resident_k_8", qparams, {"resident_k": K},
             range(len(prompts))),
            ("int8_sequential", qparams,
             {"prefill_mode": "sequential", "prefill_chunk": 128}, long)):
        ids = list(ids)
        eng = _engine(model, tree, **over)
        events = _time_bursts(eng) if "resident_k" in over else None
        res = _mesh_serve(eng, [prompts[i] for i in ids], new_tokens)
        what = f"serving_int8 {name}"
        check(res["compile_counts_stable"], f"{what}: a build or capture "
              "after warmup")
        check(res["pages_left"] == [0], f"{what}: pages left")
        got = {ids[j]: t for j, t in res["tokens"].items()}
        check(len(got) == len(ids) and all(len(t) == new_tokens
                                           for t in got.values()),
              f"{what}: not every request completed in full")
        launches = res["launches"]
        if "resident_k" in over:
            check(launches["paged_decode"] == 12 * K
                  * eng.resident_stats["launches"] > 0,
                  f"{what}: paged decode launches {launches['paged_decode']}")
        else:
            check(launches["paged_decode"] >= 12 * res["decode_launches"]
                  > 0, f"{what}: paged decode launches "
                  f"{launches['paged_decode']}")
        _check_designs({"paged_decode": res["launches_by_design"]
                        ["paged_decode"]}, "split_kv", what)
        if name == "int8_sequential":
            check(launches["flash_fwd"] == 12 * len(ids),
                  f"{what}: flash launches {launches['flash_fwd']} != 12 x "
                  f"{len(ids)} first chunks")
            _check_designs({"flash_fwd": res["launches_by_design"]
                            ["flash_fwd"]}, "wgmma", what)
        bf16 = runs.get(name.replace("int8", "bf16"), {}).get("tokens",
                                                              batched_tokens)
        runs[name] = {
            "wall_s": res["wall_s"], "tokens_per_s": res["tokens_per_s"],
            "weight_bytes": eng.weight_bytes,
            "decode_launches": res["decode_launches"],
            "launches": launches,
            "tokens_matching_bf16": _matching(got, {i: bf16[i]
                                                    for i in ids}),
            "tokens_total": sum(len(t) for t in got.values()),
            "tokens": got}
        if events is not None:
            burst_ms = [a.elapsed_time(b) for a, b in events]
            runs[name]["iteration_device_ms"] = float(
                np.median(burst_ms)) / K
        if name.startswith("int8"):
            counted.append(res)
        del eng
        _free_memory()
    check(runs["int8_one_token"]["weight_bytes"]
          == quantized_weight_bytes(qparams)["int8"],
          "serving_int8: engine weight bytes differ from the int8 count")
    # One device copy: with the caller's tree dropped after the build,
    # an engine holds its pools and its own weights, at most
    # ``weight_bytes`` (an int8 leaf's scales are held in bf16).
    held = {}
    for name, make in (("int8", lambda: quantize_params_int8(params)),
                       ("bf16", lambda: params)):
        _free_memory()
        base = torch.cuda.memory_allocated()
        tree = make()
        eng = _engine(model, tree)
        del tree
        _free_memory()
        held[name] = (torch.cuda.memory_allocated() - base
                      - eng.cache.pool_bytes)
        check(held[name] <= eng.weight_bytes + HELD_SLACK_BYTES,
              f"serving_int8: a {name} engine holds {held[name]} weight "
              f"bytes on the device, more than its {eng.weight_bytes} "
              f"(+{HELD_SLACK_BYTES}): a second copy")
        del eng
    # float32: the first decoded position's logits of every request.
    m32, p32 = _gpt2("float32")
    q32 = quantize_params_int8(p32)
    eng = _engine(m32, q32)
    few = prompts[:3]
    logits = _first_decode_logits(eng, few)
    deq = _dequantized(q32)
    errs = {}
    with torch.no_grad():
        for rid, lg in logits.items():
            seq = next(s for s in eng.slots
                       if s is not None and s.req.id == rid)
            ids = [int(t) for t in few[int(rid)]] + [seq.generated[0]]
            dense, _ = m32.apply(deq, torch.tensor([ids]))
            errs[rid] = (lg - dense[0, -1].float().cpu()).abs().max().item()
    sizes = quantized_weight_bytes(q32)
    f32_int8_bytes = eng.weight_bytes
    del eng, deq
    _free_memory()
    check(len(errs) == len(few) and max(errs.values()) <= INT8_LOGITS_TOL,
          f"serving_int8: f32 first-decode logits off the dequantized "
          f"forward by {errs} (limit {INT8_LOGITS_TOL})")
    emit({"phase": "serving_int8", "dtype": "bfloat16", "requests":
          len(prompts), "new_tokens": new_tokens,
          **{k: {f: v for f, v in r.items() if f != "tokens"}
             for k, r in runs.items()},
          "weight_bytes": {"int8_bf16_tree": runs["int8_one_token"]
                           ["weight_bytes"],
                           "bf16": runs["bf16_one_token"]["weight_bytes"],
                           "int8_f32_tree": f32_int8_bytes,
                           "fp32": sizes["fp32"],
                           "int8_over_fp32": f32_int8_bytes
                           / sizes["fp32"]},
          "device_bytes_held_beyond_pools": held,
          "f32_first_decode_logits_max_abs_err": max(errs.values()),
          "f32_logits_tol": INT8_LOGITS_TOL})
    return _summed_launches(counted)


def _serve_until_burst(eng, prompts: list, new_tokens: int) -> None:
    """Submit the prompts and step until the first decode launch."""
    from distributed_training_tpu_torch.serving.engine import Request

    for i, p in enumerate(prompts):
        eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
    while eng.decode_launches == 0:
        eng.step()


def phase_serving_swap(prompts: list, new_tokens: int) -> tuple:
    """Live weight swap on a resident engine (resident_k 8, one CUDA
    graph captured at warmup): after the first burst every request is
    in flight, and a host-resident copy of the same bf16 weights is
    published; the tokens must equal the unswapped run's bit for bit,
    with still one capture. Then a swap to second-seed weights with the
    staleness bound 0 (every request preempted and regenerated on the
    new weights) must equal a fresh engine on those weights at float32;
    at bf16 the matching tokens are reported."""
    K = 8
    report = {}
    model, params = _gpt2("bfloat16")
    ref = _mesh_serve(_engine(model, params, resident_k=K), prompts,
                      new_tokens)["tokens"]
    _free_memory()
    eng = _engine(model, params, resident_k=K)
    counts = eng.warmup()
    _reset_counts()
    t0 = time.perf_counter()
    _serve_until_burst(eng, prompts, new_tokens)
    check(eng.in_flight == len(prompts), "serving_swap: a request finished "
          "before the swap")
    host = _host_copy(params)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    stale = eng.swap_weights(host, "v1")
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - s0) * 1e3
    while not eng.idle:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, designs = _read_counts(), _read_designs()
    got = {int(r["id"]): r["tokens"] for r in eng.completed}
    versions = {int(r["id"]): r["weights_versions"] for r in eng.completed}
    check(stale == 0 and eng.swap_stats["installed"] == 1,
          f"serving_swap: {eng.swap_stats}")
    check(got == ref, "serving_swap: tokens after an identical-value swap "
          f"differ from the unswapped run's in {_matching(got, ref)} of "
          f"{sum(len(t) for t in ref.values())} places")
    check(eng.compile_counts() == counts and eng._resident.captures == 1,
          f"serving_swap: captures {eng.compile_counts()} after {counts}")
    check(all([v for v, _n in vs] == ["v0", "v1"] for vs in versions.values()),
          f"serving_swap: weight versions {versions}")
    report["identical_bf16"] = {"swap_ms": swap_ms, "wall_s": wall,
                                "captures": eng._resident.captures,
                                "tokens_equal": True,
                                "swap_bytes": eng.weight_bytes}
    del eng
    _free_memory()
    # Second-seed weights at the staleness bound 0.
    for dtype in ("float32", "bfloat16"):
        model, params = _gpt2(dtype)
        params2 = model.init(SEED + 1)
        want = _mesh_serve(_engine(model, params2, resident_k=K), prompts,
                           new_tokens)["tokens"]
        _free_memory()
        eng = _engine(model, params, resident_k=K, swap_staleness_tokens=0)
        eng.warmup()
        _serve_until_burst(eng, prompts, new_tokens)
        host = _host_copy(params2)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        stale = eng.swap_weights(host, "v1")
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - s0) * 1e3
        while not eng.idle:
            eng.step()
        got = {int(r["id"]): r["tokens"] for r in eng.completed}
        check(stale == len(prompts), f"serving_swap {dtype}: {stale} "
              "requests preempted for staleness")
        check(all(r["weights_versions"] == [["v1", new_tokens]]
                  for r in eng.completed),
              f"serving_swap {dtype}: a completed request carries "
              "superseded tokens")
        same = _matching(got, want)
        if dtype == "float32":
            check(got == want, f"serving_swap: f32 tokens after a swap at "
                  f"staleness 0 differ from a fresh engine's ({same} of "
                  f"{sum(len(t) for t in want.values())} match)")
        report[f"second_seed_{dtype}"] = {
            "swap_ms": swap_ms, "stale_preempted": stale,
            "tokens_matching_fresh": same,
            "tokens_total": sum(len(t) for t in want.values())}
        del eng, params, params2
        _free_memory()
    emit({"phase": "serving_swap", "resident_k": K,
          "requests": len(prompts), "new_tokens": new_tokens, **report,
          "launches": launches})
    return launches, designs


def _exactly_once(streams: dict, want: dict) -> bool:
    """Every stream delivered each of its request's tokens once, in
    order: equal to the uncrashed run's tokens."""
    return streams == {str(i): t for i, t in want.items()}


def _supervised_serve(model, params, prompts: list, new_tokens: int,
                      crash_at: int, ledger: str, drop_hwm: bool) -> dict:
    """The prompts under ``supervise_serving`` with ``engine_crash@N``
    on one shared injector, streams collected from listeners; each
    ``export_in_flight`` and ``adopt_batch`` timed (CUDA synchronized)
    with the KV bytes it moved. ``drop_hwm`` plants a fault: the
    successor imports the listeners but not the high-water marks."""
    from distributed_training_tpu_torch.resilience.faults import (
        FaultInjector,
    )
    from distributed_training_tpu_torch.resilience.supervisor import (
        RestartPolicy,
        supervise_serving,
    )
    from distributed_training_tpu_torch.serving.engine import Request

    inj = FaultInjector(f"engine_crash@{crash_at}", ledger_path=ledger)
    streams: dict = {}
    moves: list = []

    def timed(fn, what):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            items = out["adoptable"] if what == "export" else args[0]
            moves.append({"op": what, "ms": (time.perf_counter() - t0) * 1e3,
                          "sequences": len(items),
                          "kv_bytes": sum(k.numel() * k.element_size() * 2
                                          for _r, _t, k, _v in items)})
            return out
        return call

    def make_engine():
        eng = _engine(model, params)
        eng.warmup()
        eng.faults = inj
        eng.export_in_flight = timed(eng.export_in_flight, "export")
        eng.adopt_batch = timed(eng.adopt_batch, "adopt")
        if drop_hwm:
            imp = eng.import_emission_state
            eng.import_emission_state = lambda st: imp(
                {"listeners": st["listeners"]})
        return eng

    def run(eng, incarnation):
        if incarnation == 0:
            for i, p in enumerate(prompts):
                rid = str(i)
                eng.submit(Request(id=rid, prompt=p,
                                   max_new_tokens=new_tokens))
                eng.add_token_listener(rid, (
                    lambda r: lambda t, d: streams.setdefault(r, []).append(
                        t))(rid))
        eng.run_until_drained()
        return eng.finished_total

    t0 = time.perf_counter()
    res = supervise_serving(make_engine, run, policy=RestartPolicy(
        max_restarts=2, backoff_base_s=0.0, backoff_max_s=0.0))
    torch.cuda.synchronize()
    eng = res["engine"]
    return {"wall_s": time.perf_counter() - t0, "res": res,
            "streams": streams, "moves": moves,
            "tokens": {int(r["id"]): r["tokens"] for r in eng.completed},
            "pages_used": eng.cache.pages_used,
            "launch_count": eng.launch_count}


def phase_serving_recovery(prompts: list, tmp: str) -> tuple:
    """``engine_crash@N`` under ``supervise_serving``, float32, one-token
    decode: the crash lands after every request decoded a few tokens;
    the supervisor salvages every sequence's dense KV
    (``export_in_flight``), a fresh engine re-adopts it
    (``adopt_batch``), and the run finishes. Every stream must deliver
    each token once and equal the uncrashed run; the same run with the
    successor's high-water marks dropped (a planted fault) must fail
    that check."""
    new_tokens = 32
    model, params = _gpt2("float32")
    ref_eng = _engine(model, params)
    ref = _mesh_serve(ref_eng, prompts, new_tokens)["tokens"]
    # The launch after which the longest prompt is prefilled and every
    # request has decoded RECOVERY_DECODES tokens.
    crash_at = ref_eng.prefill_launches + RECOVERY_DECODES
    del ref_eng
    _free_memory()
    _reset_counts()
    run = _supervised_serve(model, params, prompts, new_tokens, crash_at,
                            os.path.join(tmp, "ledger.json"), False)
    torch.cuda.synchronize()
    launches, designs = _read_counts(), _read_designs()
    res = run["res"]
    check(not res["gave_up"] and res["incarnations"] == 2
          and len(res["crashes"]) == 1
          and "InjectedCrash" in res["crashes"][0]["error"],
          f"serving_recovery: {res['crashes']}, {res['incarnations']} "
          "incarnations")
    exports = [m for m in run["moves"] if m["op"] == "export"]
    adopts = [m for m in run["moves"] if m["op"] == "adopt"]
    check(len(exports) == len(adopts) == 1
          and exports[0]["sequences"] == len(prompts),
          f"serving_recovery: KV moves {run['moves']}")
    check(run["tokens"] == ref, "serving_recovery: tokens differ from the "
          "uncrashed run")
    check(_exactly_once(run["streams"], ref), "serving_recovery: a stream "
          "lost or repeated a token")
    check(run["pages_used"] == 0, "serving_recovery: pages left")
    check(launches["paged_decode"] > 0, "serving_recovery: no decode")
    _check_designs({"paged_decode": designs["paged_decode"]}, "split_kv",
                   "serving_recovery")
    _free_memory()
    fault = _supervised_serve(model, params, prompts, new_tokens, crash_at,
                              os.path.join(tmp, "ledger_fault.json"), True)
    check(not _exactly_once(fault["streams"], ref),
          "serving_recovery: the planted fault (high-water marks dropped) "
          "passed the exactly-once check")
    repeated = sum(len(fault["streams"][str(i)]) - len(t)
                   for i, t in ref.items())
    emit({"phase": "serving_recovery", "dtype": "float32",
          "requests": len(prompts), "new_tokens": new_tokens,
          "crash_at_launch": crash_at, "wall_s": run["wall_s"],
          "incarnations": res["incarnations"],
          "export_ms": exports[0]["ms"], "adopt_ms": adopts[0]["ms"],
          "kv_bytes": exports[0]["kv_bytes"],
          "sequences_moved": exports[0]["sequences"],
          "exactly_once": True, "tokens_equal_uncrashed": True,
          "fault_tokens_repeated": repeated, "launches": launches})
    del model, params
    _free_memory()
    return launches, designs


def _mesh_one_plan(name: str, model, model_kwargs: dict) -> object:
    """A plan at a mesh of 1 for ``model`` (every leaf replicated), 8
    slots of 1024 tokens, built in memory by the port's ``Plan``."""
    from distributed_training_tpu_torch.parallel.planner import (
        MESH_AXES,
        Plan,
    )
    from distributed_training_tpu_torch.train.optimizer import flatten

    return Plan(name=name, devices=1, mesh={a: 1 for a in MESH_AXES},
                base_strategy="ddp", remat="none", batch_per_shard=8,
                seq_len=1024, batch_axes=["dp", "fsdp"],
                sharding_map={k: [] for k in flatten(model.param_shapes())},
                inputs={"model_kwargs": model_kwargs})


def _disagg_serve(store, plans: tuple, prompts: list,
                  new_tokens: int) -> dict:
    """The prompts through ``DisaggPipeline.generate_many`` (both engines
    on the card, warmed up), timed, with the launch counts from 0 and
    each handoff's export and adopt timed by CUDA events."""
    from distributed_training_tpu_torch.serving.disagg import DisaggPipeline
    from distributed_training_tpu_torch.serving.engine import Request

    pipe = DisaggPipeline(store, *plans)
    pipe.prefill_engine.warmup()
    pipe.decode_engine.warmup()
    spans: list = []
    on_card: list = []

    def timed(fn, op):
        def call(*args):
            if not args[0]:
                return fn(*args)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            spans.append((op, start, end))
            if op == "export":
                on_card.extend(k.device.type == "cuda"
                               for _r, _t, k, _v in out[0])
            return out
        return call

    pipe._handoff = timed(pipe._handoff, "export")
    pipe._adopt = timed(pipe._adopt, "adopt")
    _reset_counts()
    t0 = time.perf_counter()
    got = pipe.generate_many([Request(id=str(i), prompt=p,
                                      max_new_tokens=new_tokens)
                              for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = {op: [a.elapsed_time(b) for o, a, b in spans if o == op]
          for op in ("export", "adopt")}
    de, pe = pipe.decode_engine, pipe.prefill_engine
    return {"wall_s": wall,
            "tokens": {int(k): v for k, v in got.items()},
            "tokens_per_s": sum(len(t) for t in got.values()) / wall,
            "mean_ttft_s": float(np.mean([r["ttft_s"]
                                          for r in de.completed])),
            "handoff": dict(pipe.handoff_stats), "handoff_ms": ms,
            "kv_on_card": bool(on_card) and all(on_card),
            "prefill_decode_launches": pe.decode_launches,
            "decode_launches": de.decode_launches,
            "pages_left": pe.cache.pages_used + de.cache.pages_used,
            "launches": _read_counts(), "launches_by_design": _read_designs()}


def _colocated_serve(model, params, cfg, prompts: list,
                     new_tokens: int) -> dict:
    """The prompts through one engine under ``cfg``, warmed up, timed."""
    from distributed_training_tpu_torch.serving.engine import Engine, Request

    eng = Engine(model, params, cfg)
    eng.warmup()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {int(r["id"]): r["tokens"] for r in eng.completed}
    return {"wall_s": wall, "tokens": got,
            "tokens_per_s": sum(len(t) for t in got.values()) / wall,
            "mean_ttft_s": float(np.mean([r["ttft_s"]
                                          for r in eng.completed]))}


def phase_serving_disagg(prompts: list, new_tokens: int, tmp: str) -> tuple:
    """Disaggregated serving of gpt2_125m at full width: the weights
    written as an artifact and loaded once through ``WeightStore``, two
    plans at a mesh of 1 (8 slots of 1024 tokens), the prefill engine
    handing each step's finished prompts' KV to the decode engine on the
    card (``DisaggPipeline.generate_many``), against one colocated engine
    under the decode plan's ``engine_config_for_plan``. bf16: throughput,
    TTFT, handoff time and bytes, B4 launches and the tokens that match
    the colocated engine; float32 on the two longest prompts: tokens
    equal to the colocated engine's."""
    from distributed_training_tpu_torch.checkpoint.consolidate import (
        write_artifact,
    )
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.serving.disagg import (
        WeightStore,
        engine_config_for_plan,
    )

    out: dict = {}
    longest = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))[:2]
    for dtype in ("bfloat16", "float32"):
        model, params = _gpt2(dtype)
        path = os.path.join(tmp, f"disagg_{dtype}.pt")
        write_artifact(path, {"params": _host_copy(params)}, {})
        mk = {**PRESETS["gpt2_125m"], "dtype": dtype, "param_dtype": dtype}
        plans = (_mesh_one_plan("gpt2_prefill", model, mk),
                 _mesh_one_plan("gpt2_decode", model, mk))
        store = WeightStore(path)
        use = prompts if dtype == "bfloat16" else [prompts[i]
                                                   for i in longest]
        ref = _colocated_serve(model, params,
                               engine_config_for_plan(plans[1]), use,
                               new_tokens)
        del params
        _free_memory()
        run = _disagg_serve(store, plans, use, new_tokens)
        del store
        _free_memory()
        check(run["kv_on_card"], f"serving_disagg {dtype}: the handed-over "
              "KV left the card")
        check(run["prefill_decode_launches"] == 0
              and run["decode_launches"] > 0 and run["pages_left"] == 0,
              f"serving_disagg {dtype}: decode launches "
              f"{run['prefill_decode_launches']} (prefill) "
              f"{run['decode_launches']} (decode), pages left "
              f"{run['pages_left']}")
        check(run["launches"]["paged_decode"] >= 12 * run["decode_launches"],
              f"serving_disagg {dtype}: paged decode launches "
              f"{run['launches']['paged_decode']}")
        _check_designs({"paged_decode": run["launches_by_design"][
            "paged_decode"]}, "split_kv", f"serving_disagg {dtype}")
        check(all(len(t) == new_tokens for t in run["tokens"].values()),
              f"serving_disagg {dtype}: a request returned the wrong "
              "number of tokens")
        matching = _matching(run["tokens"], ref["tokens"])
        if dtype == "float32":
            check(run["tokens"] == ref["tokens"], "serving_disagg float32: "
                  "tokens differ from the colocated engine's")
        steps = run["handoff"]["steps"]
        check(steps == len(run["handoff_ms"]["export"]) > 0,
              f"serving_disagg {dtype}: {steps} handoff steps, timings "
              f"{run['handoff_ms']}")
        out[dtype] = {
            "prompt_lens": [len(p) for p in use],
            "tokens_per_s": run["tokens_per_s"],
            "colocated_tokens_per_s": ref["tokens_per_s"],
            "mean_ttft_s": run["mean_ttft_s"],
            "colocated_mean_ttft_s": ref["mean_ttft_s"],
            "wall_s": run["wall_s"], "colocated_wall_s": ref["wall_s"],
            "handoff_steps": steps,
            "handoff_ms_per_step": sum(map(sum, run["handoff_ms"].values()))
            / steps,
            "handoff_ms": run["handoff_ms"],
            "kv_bytes": run["handoff"]["bytes"],
            "sequences_handed": run["handoff"]["items"],
            "decode_launches": run["decode_launches"],
            "b4_launches": run["launches"]["paged_decode"],
            "tokens_matching": matching,
            "tokens_total": sum(len(t) for t in ref["tokens"].values())}
        if dtype == "bfloat16":
            launches = (run["launches"], run["launches_by_design"])
        del model
        _free_memory()
    emit({"phase": "serving_disagg", "model": "gpt2_125m",
          "new_tokens": new_tokens, "plans_mesh": 1, "batch_per_shard": 8,
          "seq_len": 1024, **out})
    return launches


class _ServerCLI:
    """One ``python -m distributed_training_tpu_torch.serving.server``
    process on the card: its working directory ``cwd``, standard error in
    ``<cwd>/server.log``, its JSON status lines read from standard output
    on a thread."""

    def __init__(self, artifact: str, plan: str, cwd: str):
        repo = os.path.dirname(os.path.abspath(__file__))
        self.cwd = cwd
        self.log = open(os.path.join(cwd, "server.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributed_training_tpu_torch.serving.server",
             "--artifact", artifact, "--plan", plan,
             "--config", os.path.join(repo, "conf", "serving",
                                      "default.yaml"),
             "--port", "0", "--metrics-port", "0"],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=repo),
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        self.lines: list = []
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("{"):
                self.lines.append(json.loads(line))
                if self.lines[-1].get("serving") == "ready":
                    self._ready.set()
        self._ready.set()

    def _tail(self) -> str:
        with open(os.path.join(self.cwd, "server.log")) as f:
            return f.read()[-4000:]

    def ready(self, timeout: float = 300) -> dict:
        self._ready.wait(timeout)
        got = [x for x in self.lines if x.get("serving") == "ready"]
        check(bool(got), f"serving_cli: the server did not start: "
              f"{self._tail()}")
        return got[0]

    def stop(self) -> tuple:
        """SIGINT, then (exit code, the stop line)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._reader.join(timeout=10)
        self.log.close()
        stopped = [x for x in self.lines if x.get("serving") == "stopped"]
        return rc, (stopped[0] if stopped else None)


def _get(port: int, path: str) -> tuple:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


def _cli_burst(port: int, prompts: list, new_tokens: int) -> dict:
    """The prompts as concurrent POST /generate requests, timed."""
    results: dict = {}

    def client(i):
        results[i] = _post(port, {"prompt_ids": prompts[i].tolist(),
                                  "max_new_tokens": new_tokens})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(len(results) == len(prompts), "serving_cli: not every request "
          "completed")
    tokens = {i: r["tokens"] for i, r in results.items()}
    return {"tokens": tokens, "wall_s": wall,
            "tokens_per_s": sum(map(len, tokens.values())) / wall,
            "mean_ttft_s": float(np.mean([r["ttft_s"]
                                          for r in results.values()]))}


def phase_serving_cli(prompts: list, new_tokens: int, batched: dict,
                      tmp: str) -> tuple:
    """gpt2_125m served through the server's own entry point: the weights
    written as an artifact, a plan at a mesh of 1 saved with the port's
    ``save_plan`` (8 slots of 1024 tokens), and ``python -m
    distributed_training_tpu_torch.serving.server --artifact A --plan P
    --config conf/serving/default.yaml --port 0`` started as a process of
    its own, on the card. bf16: the smoke's prompts as concurrent POST
    /generate requests, tokens/s and mean TTFT over HTTP, B4 and B1
    launches counted in the server process (its status lines at ready and
    at stop), token agreement with phase serving's engine, whose config is
    the one ``engine_config_from_yaml`` derives; float32 on the two
    longest prompts: tokens equal to an in-process Engine under that
    config. ``GET /metrics`` counts the requests and their TTFTs, ``GET
    /debug/requests`` answers, and SIGINT ends the server with 0."""
    import yaml

    from distributed_training_tpu_torch.checkpoint.consolidate import (
        write_artifact,
    )
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.parallel.planner import save_plan
    from distributed_training_tpu_torch.serving.server import (
        engine_config_from_yaml,
    )

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "conf", "serving", "default.yaml")) as f:
        block = yaml.safe_load(f)["engine"]
    longest = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))[:2]
    servers, cfgs = {}, {}
    try:
        for dtype in ("bfloat16", "float32"):
            model, params = _gpt2(dtype)
            cwd = os.path.join(tmp, f"cli_{dtype}")
            os.makedirs(cwd)
            artifact = os.path.join(cwd, "model.pt")
            write_artifact(artifact, {"params": _host_copy(params)}, {})
            mk = {**PRESETS["gpt2_125m"], "dtype": dtype,
                  "param_dtype": dtype}
            plan = _mesh_one_plan(f"gpt2_cli_{dtype}", model, mk)
            cfgs[dtype] = engine_config_from_yaml(plan, block)
            servers[dtype] = _ServerCLI(
                artifact, save_plan(plan, os.path.join(cwd, "plan.json")),
                cwd)
            if dtype == "float32":
                # The in-process reference while the servers start.
                ref = _colocated_serve(model, params, cfgs[dtype],
                                       [prompts[i] for i in longest],
                                       new_tokens)
            del model, params
            _free_memory()
        check(cfgs["bfloat16"] == _engine_config(),
              f"serving_cli: engine_config_from_yaml gives "
              f"{cfgs['bfloat16']}, not phase serving's engine config")
        out: dict = {}
        for dtype in ("float32", "bfloat16"):
            srv = servers[dtype]
            ready = srv.ready()
            use = prompts if dtype == "bfloat16" else [prompts[i]
                                                       for i in longest]
            run = _cli_burst(ready["port"], use, new_tokens)
            st_m, metrics = _get(ready["port"], "/metrics")
            st_d, _debug = _get(ready["port"], "/debug/requests")
            rc, stopped = srv.stop()
            check(rc == 0 and stopped is not None,
                  f"serving_cli {dtype}: the server exited {rc}, stop "
                  f"line {stopped}: {srv._tail()}")
            n = len(use)
            check(st_m == 200 and st_d == 200
                  and f"dtt_serving_requests_total {n}\n" in metrics
                  and 'dtt_serving_time_to_first_token_seconds_count'
                      f'{{tenant="default"}} {n}\n' in metrics,
                  f"serving_cli {dtype}: /metrics does not count {n} "
                  f"requests:\n{metrics[-2000:]}")
            check(all(len(t) == new_tokens for t in run["tokens"].values()),
                  f"serving_cli {dtype}: a request returned the wrong "
                  "number of tokens")
            served = {k: {d: stopped["kernel_launches"][k]["by_design"][d]
                          - ready["kernel_launches"][k]["by_design"][d]
                          for d in ready["kernel_launches"][k]["by_design"]}
                      for k in ready["kernel_launches"]}
            if dtype == "float32":
                want = {j: ref["tokens"][j] for j in range(n)}
                check(run["tokens"] == want, "serving_cli float32: tokens "
                      "over HTTP differ from the in-process engine's")
            else:
                want = {j: batched[j] for j in range(n)}
            out[dtype] = {
                "prompt_lens": [len(p) for p in use],
                "wall_s": run["wall_s"], "tokens_per_s": run["tokens_per_s"],
                "mean_ttft_s": run["mean_ttft_s"],
                "b4_launches": sum(served["paged_decode"].values()),
                "b1_launches": sum(served["flash_fwd"].values()),
                "launches_by_design": served,
                "requests_finished": stopped["requests_finished"],
                "tokens_matching": _matching(run["tokens"], want),
                "tokens_total": sum(len(t) for t in want.values())}
            check(out[dtype]["b4_launches"] > 0,
                  f"serving_cli {dtype}: paged decode never launched in "
                  "the server process")
            _check_designs({"paged_decode": served["paged_decode"]},
                           "split_kv", f"serving_cli {dtype}")
    finally:
        for srv in servers.values():
            if srv.proc.poll() is None:
                srv.proc.kill()
                srv.proc.wait()
    emit({"phase": "serving_cli", "model": "gpt2_125m",
          "new_tokens": new_tokens, "plans_mesh": 1,
          "config": "conf/serving/default.yaml", **out})
    bf16 = out["bfloat16"]["launches_by_design"]
    launches = {name: 0 for name in KERNELS}
    designs = {name: dict.fromkeys(fn.launches_by_design, 0)
               for name, fn in _wrappers().items()}
    for name, by_design in bf16.items():
        launches[name] = sum(by_design.values())
        designs[name].update(by_design)
    return launches, designs


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


def phase_trace_resident(prompts: list, new_tokens: int) -> None:
    """phase_trace for the resident engine (resident_k 8, spec_k 1): the
    same requests under ``torch.profiler``, the decode bursts as graph
    replays."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.serving.engine import Request

    model, params = _gpt2("bfloat16")
    eng = _engine(model, params, resident_k=8)
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
    recs = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while not eng.idle:
            recs.append(eng.step())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "trace_resident", "dtype": "bfloat16", "resident_k": 8,
          "requests": len(prompts), **_device_time(prof, wall_us),
          **{f"{op}_wall_s": sum(r["dur_s"] for r in recs if r["op"] == op)
             for op in ("prefill", "decode")},
          "decode_launches": eng.decode_launches,
          "prefill_launches": eng.prefill_launches,
          "resident_stats": eng.resident_stats})


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
            # Paged decode's split kernel and its combine.
            "paged_decode_us": sum(v[0] for k, v in per_name.items()
                                   if "paged_" in k),
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


def _capture_first_decode(eng) -> tuple:
    """Wrap ``eng`` so that its first one-token decode launch keeps the
    float32 logits it samples from (this process's rows: its dp group's
    slots, the whole vocab) and the request in each row. Returns the box
    they land in and the function that undoes the wrapping."""
    from distributed_training_tpu_torch.serving import engine as em

    box: dict = {}
    logits_fn, decode = em._logits, eng._decode

    def logits(*args, **kw):
        out = logits_fn(*args, **kw)
        if box.pop("armed", False):
            box["logits"] = out.float().cpu()
        return out

    def first_decode(tokens, positions, rows, active):
        if "logits" not in box:
            # The slots of this process's dp group: the rows its fetch
            # returns for them, whichever rows it launched.
            B, g = eng.batch_local, eng.cache.local_group or 0
            box["armed"] = True
            box["ids"] = [s.req.id if s is not None and a else None
                          for s, a in zip(eng.slots[g * B:(g + 1) * B],
                                          active)]
        return decode(tokens, positions, rows, active)

    em._logits = logits
    eng._decode = first_decode

    def undo():
        em._logits = logits_fn
        eng._decode = decode
    return box, undo


def _first_decode_logits(eng, prompts: list) -> dict:
    """Every request's float32 logits at its first decoded position:
    the prompts submitted, the engine stepped until its first decode
    launch (every prompt prefilled first, policy "prefill")."""
    from distributed_training_tpu_torch.serving.engine import Request

    box, undo = _capture_first_decode(eng)
    try:
        for i, p in enumerate(prompts):
            eng.submit(Request(id=str(i), prompt=p, max_new_tokens=4))
        while "logits" not in box:
            eng.step()
    finally:
        undo()
    return {rid: box["logits"][i] for i, rid in enumerate(box["ids"])
            if rid is not None}


def _mesh_serve(eng, prompts: list, new_tokens: int) -> dict:
    """The prompts through the engine (no HTTP) to the end, timed, with
    the kernel launches, the tensor-parallel collectives and the
    engine's own gathers counted from 0."""
    from distributed_training_tpu_torch.parallel import tensor as tp_lib
    from distributed_training_tpu_torch.serving.engine import Request

    counts = eng.warmup()
    _reset_counts()
    tp_lib.ALL_REDUCES.clear()
    tp_lib.ALL_GATHERS.clear()
    eng.gathers.clear()
    syncs0, slots_active = eng.host_syncs, []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(id=str(i), prompt=p, max_new_tokens=new_tokens))
    while not eng.idle:
        slots_active.append(eng.step().get("group_slots_active"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {int(r["id"]): r["tokens"] for r in eng.completed}
    return {"wall_s": wall,
            "tokens_per_s": sum(len(t) for t in got.values()) / wall,
            "tokens": got, "groups": {int(r["id"]): r["group"]
                                      for r in eng.completed},
            "steps": len(slots_active),
            "group_slots_active": [a for a in slots_active if a],
            "prefill_launches": eng.prefill_launches,
            "decode_launches": eng.decode_launches,
            "host_syncs": eng.host_syncs - syncs0,
            "gathers": dict(eng.gathers),
            "all_reduces": dict(tp_lib.ALL_REDUCES),
            "all_gathers": dict(tp_lib.ALL_GATHERS),
            "launches": _read_counts(), "launches_by_design": _read_designs(),
            "compile_counts_stable": eng.compile_counts() == counts,
            "pages_left": [eng.cache.pages_used_in(g)
                           for g in range(eng.dp_groups)]}


def serving_mesh_rank(rank: int, port: int, out_path: str,
                      name: str) -> int:
    """One of phase serving_<name>'s two processes: on ``cuda:0``, in a
    gloo group of 2 over ``127.0.0.1:port``, a runtime over the mesh
    SERVING_MESHES[name] built here, gpt2_125m at full width through
    ``Engine(..., mesh=runtime)``: the float32 logits of the first
    decoded position, sound and with the planted fault; then bf16, the
    smoke's prompts batched and the long ones sequential, to the end.
    Writes its readings to ``out_path``."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.parallel.tensor import TPGroup
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        rt = slice_runtime([MeshSpec(**SERVING_MESHES[name])],
                           torch.device("cuda", 0))
        prompts = _smoke_prompts()
        result = {"rank": rank, "describe": rt.describe()}
        model, params = _gpt2("float32")
        for run in ("sound", "fault"):
            eng = _engine(model, params, mesh=rt)
            if run == "fault" and name == "tp2":
                layers = model.cfg.n_layers

                class DropLayer0AttentionReduce(TPGroup):
                    calls = 0

                    def reduce(self, x):
                        self.calls += 1
                        if self.calls % (2 * layers) == 1:
                            return x
                        return super().reduce(x)
                eng._tp = DropLayer0AttentionReduce(rt.group(("tp",)))
            elif run == "fault" and rank == 1:
                eng._g = 0   # rank 1 launches group 0's rows
            result[f"f32_{run}"] = _first_decode_logits(eng, prompts)
            del eng
        if name == "tp2":
            # The resident burst is a CUDA graph, which cannot capture
            # gloo's all-reduces: the engine must refuse it.
            try:
                _engine(model, params, mesh=rt, resident_k=8)
                result["resident_refusal"] = None
            except NotImplementedError as e:
                result["resident_refusal"] = str(e)
        del model, params
        _free_memory()
        model, params = _gpt2("bfloat16")
        eng = _engine(model, params, mesh=rt)
        torch.cuda.reset_peak_memory_stats()
        result["bf16"] = _mesh_serve(eng, prompts, 64)
        result["bf16"]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        result["pool_bytes"] = eng.cache.pool_bytes
        result["pool_shape"] = list(eng.cache.k_pages.shape)
        result["weight_bytes"] = eng.weight_bytes
        del eng
        _free_memory()
        long = [p for p in prompts if len(p) >= 128]
        eng = _engine(model, params, mesh=rt, prefill_mode="sequential",
                      prefill_chunk=128)
        result["bf16_sequential"] = _mesh_serve(eng, long, 64)
        result["long_ids"] = [i for i, p in enumerate(prompts)
                              if len(p) >= 128]
        del eng
        torch.save(result, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def _logit_diffs(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max()) for k in got)


def phase_serving_mesh(name: str, prompts: list, batched_tokens: dict,
                       tmp: str) -> tuple:
    """Serving gpt2_125m at full width on a mesh of two processes sharing
    ``cuda:0`` over gloo (SERVING_MESHES[name]: dp 2, each process one
    dp group of 4 slots and its own pool; or tp 2, each process 6 of the
    12 heads, half the MLP and half the vocab), against one process: the
    float32 logits of every request's first decoded position within
    MESH_LOGITS_TOL and the planted fault outside it; at bf16 the
    smoke's 8 prompts batched (64 new tokens) and its long ones
    sequential (B1 at the rank's heads), token agreement with the
    one-process engine reported, the collectives and launches held to
    the design. The kernels are built (by phase_build) before the
    processes start."""
    from distributed_training_tpu_torch.models.transformer import PRESETS

    mesh = SERVING_MESHES[name]
    G = mesh.get("dp", 1)
    _free_memory()
    model, params = _gpt2("float32")
    want = _first_decode_logits(
        _engine(model, params, num_pages=G * 512 + 1), prompts)
    del model, params
    _free_memory()
    port = _free_port()
    outs = [os.path.join(tmp, f"serving_{name}.rank{r}.pt") for r in range(2)]
    logs = [open(os.path.join(tmp, f"serving_{name}.rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serving-mesh-rank",
         str(r), str(port), outs[r], name], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if codes != [0, 0]:
        for r in range(2):
            with open(logs[r].name) as f:
                print(f"serving_{name} rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"serving_{name}: ranks exited {codes}")
    ranks = [torch.load(path, weights_only=False) for path in outs]
    L = PRESETS["gpt2_125m"]["n_layers"]
    tp = mesh.get("tp", 1)
    sound = max(_logit_diffs(r["f32_sound"], want) for r in ranks)
    fault = max(_logit_diffs(r["f32_fault"], want) for r in ranks)
    scale = max(float(v.abs().max()) for v in want.values())
    per_rank = []
    for r in ranks:
        rank = r["rank"]
        runs = {}
        for run in ("bf16", "bf16_sequential"):
            got = r[run]
            what = f"serving_{name} rank {rank} {run}"
            forwards = got["prefill_launches"] + got["decode_launches"]
            # Per forward under tp: the lookup's and each layer's two
            # row-parallel all-reduces, and one all-gather of the
            # logits; per fetch one all-gather over dp; per step one
            # lock-step gather over the mesh.
            design = {
                "all_reduces": ({"reduce_from_tp": (2 * L + 1) * forwards}
                                if tp > 1 else {}),
                "all_gathers": ({"gather_from_tp": forwards}
                                if tp > 1 else {}),
                "gathers": {"lockstep": got["steps"],
                            **({"dp_fetch": got["host_syncs"]}
                               if G > 1 else {})}}
            for k, v in design.items():
                check(got[k] == v, f"{what}: {k} {got[k]}, design {v}")
            check(got["launches"]["paged_decode"]
                  == L * got["decode_launches"] > 0,
                  f"{what}: paged decode launches "
                  f"{got['launches']['paged_decode']} != {L} x "
                  f"{got['decode_launches']} decode launches")
            _check_designs({"paged_decode":
                            got["launches_by_design"]["paged_decode"]},
                           "split_kv", what)
            check(got["pages_left"] == [0] * G, f"{what}: pages left "
                  f"{got['pages_left']}")
            check(got["compile_counts_stable"], f"{what}: kernel builds "
                  "after warmup")
            n = len(got["tokens"])
            check(all(len(t) == 64 for t in got["tokens"].values()),
                  f"{what}: a request returned the wrong number of tokens")
            if run == "bf16_sequential":
                # Every process launches every first chunk (its own
                # group's live, the others' all-scratch).
                check(got["launches"]["flash_fwd"] == L * n,
                      f"{what}: flash launches {got['launches']['flash_fwd']}"
                      f" != {L} x {n} first chunks")
                _check_designs({"flash_fwd":
                                got["launches_by_design"]["flash_fwd"]},
                               "wgmma", what)
            if G > 1:
                check(sorted(set(got["groups"].values())) == list(range(G)),
                      f"{what}: completed groups {got['groups']}")
            runs[run] = {
                k: got[k] for k in (
                    "wall_s", "tokens_per_s", "steps", "prefill_launches",
                    "decode_launches", "host_syncs", "gathers",
                    "all_reduces", "all_gathers", "launches",
                    "launches_by_design")}
            runs[run].update(
                forwards=forwards, design=design,
                per_step={k: {c: v / got["steps"] for c, v in got[k].items()}
                          for k in ("gathers", "all_reduces",
                                    "all_gathers")},
                group_slots_active_max=(
                    [max(a[g] for a in got["group_slots_active"])
                     for g in range(G)] if G > 1 else None),
                tokens_matching_one_process=_matching(
                    got["tokens"], batched_tokens),
                tokens_total=sum(len(t) for t in got["tokens"].values()))
        check(r["bf16"]["tokens"] == ranks[0]["bf16"]["tokens"],
              f"serving_{name}: the two ranks read different tokens")
        per_rank.append({"rank": rank, "describe": r["describe"],
                         "pool_shape": r["pool_shape"],
                         "pool_bytes": r["pool_bytes"],
                         "weight_bytes": r["weight_bytes"],
                         "peak_mem_bytes": r["bf16"]["peak_mem_bytes"],
                         **runs})
    emit({"phase": f"serving_{name}", "model": "gpt2_125m", "mesh": mesh,
          "backend": "gloo", "processes_on_card": 2,
          "requests": len(prompts), "new_tokens": 64, "wall_s": wall,
          "f32_first_decode_logits": {
              "max_abs_diff": sound, "fault_max_abs_diff": fault,
              "limit": MESH_LOGITS_TOL, "max_abs_logit": scale,
              "fault": ("layer 0's attention all-reduce dropped"
                        if tp > 1 else "rank 1 launches group 0's rows")},
          "resident_refusal": ranks[0].get("resident_refusal"),
          "ranks": per_rank})
    if tp > 1:
        check(all("item 7" in (r["resident_refusal"] or "") for r in ranks),
              f"serving_{name}: the resident burst under tp over gloo was "
              f"not refused: {[r['resident_refusal'] for r in ranks]}")
    check(sound <= MESH_LOGITS_TOL, f"serving_{name}: f32 logits off the "
          f"one-process engine's by {sound} > {MESH_LOGITS_TOL}")
    check(fault > MESH_LOGITS_TOL, f"serving_{name}: the planted fault "
          f"{fault} within {MESH_LOGITS_TOL}")
    # Both ranks' launches are the card's.
    launches, designs = {}, {}
    for r in ranks:
        for run in ("bf16", "bf16_sequential"):
            for k, v in r[run]["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for k, ds in r[run]["launches_by_design"].items():
                for d, v in ds.items():
                    designs.setdefault(k, {}).setdefault(d, 0)
                    designs[k][d] += v
    return launches, designs


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


def _free_memory() -> None:
    """Drop what the previous phase left (a trainer and its metrics
    logger hold each other, so only the cycle collector frees them)."""
    gc.collect()
    torch.cuda.empty_cache()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _nccl_world_of_one():
    """torchrun's environment for a NCCL process group of one rank
    (address 127.0.0.1, a free port): the trainer CLI's runtime starts
    the group from it and destroys it on exit."""
    port = _free_port()
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _events(out_dir: str) -> list:
    path = os.path.join(out_dir, "default", "events.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_nccl_runtime(out_dir: str, what: str) -> dict:
    rt = [e for e in _events(out_dir) if e["kind"] == "runtime"]
    check(len(rt) == 1 and rt[0]["backend"] == "nccl"
          and rt[0]["world"] == 1, f"{what}: runtime events {rt}")
    return rt[0]


def phase_train_1b(tmp: str) -> tuple:
    """transformer_1b at full width (vocab 50304, d_model 2048, 24
    layers, 16 heads of 128, RoPE, untied head) through the trainer CLI
    under fsdp, bf16 compute and f32 params, batch 4 x seq 2048 of
    synthetic_lm, TRAIN_1B_STEPS steps, in a NCCL group of one rank: the
    weights are stored sharded over an fsdp group of one and gathered a
    layer at a time. No checkpoint (the f32 state is 22.6 GB)."""
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.parallel import fsdp
    from distributed_training_tpu_torch.train import cli

    out = os.path.join(tmp, "train_1b")
    steps, batch, seq = TRAIN_1B_STEPS, 4, 2048
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    fsdp.GATHERS.clear()
    t0 = time.perf_counter()
    with _nccl_world_of_one():
        check(cli.main([
            "model=transformer_1b", "train=gpt2",
            "train.parallel_strategy=fsdp", f"train.batch_size={batch}",
            f"train.dataset_kwargs.seq_len={seq}",
            f"train.dataset_size={steps * batch}", "train.total_epochs=1",
            "train.save_every=0", "train.log_every=1",
            "run.log_level=WARNING", f"run.output_dir={out}"]) == 0,
            "train_1b failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, designs = _read_counts(), _read_designs()
    gathers = dict(fsdp.GATHERS)
    runtime = _check_nccl_runtime(out, "train_1b")
    rows = _metrics_rows(out)
    losses = [r["loss"] for r in rows]
    cfg = TransformerConfig(**PRESETS["transformer_1b"])
    L = cfg.n_layers
    check(len(losses) == steps, f"train_1b: {len(losses)} loss rows")
    check(all(math.isfinite(x) for x in losses), f"non-finite {losses}")
    # One gather per layer per forward, and one of each sharded
    # top-level leaf (tok_embed on vocab, lm_head on embed); final_norm
    # is below min_shard_elems and stays whole. No remat: the backward
    # gathers nothing.
    want = {"layer": L * steps, "tok_embed": steps, "lm_head": steps}
    check(gathers == want, f"train_1b: gathers {gathers}, want {want}")
    for name in ("flash_fwd", "flash_bwd_fused"):
        check(designs[name]["wgmma"] == L * steps == launches[name],
              f"train_1b: {name} launches {designs[name]}, want "
              f"{L} x {steps} on wgmma")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          "train_1b took the split kernels")
    # Each row reads its loss (a device sync): a row's rate is one step.
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows[3:]]))
    flops = Transformer(cfg, device="cpu").flops_per_sample() * batch
    info = {"phase": "train_1b", "model": "transformer_1b",
            "strategy": "fsdp", "runtime": runtime,
            "params": Transformer(cfg, device="cpu").num_params(),
            "batch": batch, "seq": seq, "steps": steps, "wall_s": wall,
            "median_step_s": step_s, "tokens_per_s": batch * seq / step_s,
            "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
            "mfu_logged_median": float(np.median(
                [r.get("mfu", float("nan")) for r in rows[3:]])),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "gathers": gathers,
            "launches": launches, "launches_by_design": designs}
    emit(info)
    return (launches, designs), rows


def phase_train_tp_1b(tmp: str, rows_1b: list) -> tuple:
    """transformer_1b at full width through the trainer CLI under
    ``tp_fsdp`` at tp 1 and fsdp 1, in a NCCL group of one rank: the
    tensor-parallel block, the vocab-parallel lookup and cross-entropy
    and the per-layer gathers, every collective over a group of one.
    The same data, seed and steps as ``train_1b``: the first two losses
    equal its bit for bit, the rest within the TP limits."""
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.parallel import fsdp
    from distributed_training_tpu_torch.parallel import tensor as tp_lib
    from distributed_training_tpu_torch.train import cli

    out = os.path.join(tmp, "train_tp_1b")
    steps, batch, seq = TRAIN_1B_STEPS, 4, 2048
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    fsdp.GATHERS.clear()
    tp_lib.ALL_REDUCES.clear()
    t0 = time.perf_counter()
    with _nccl_world_of_one():
        check(cli.main([
            "model=transformer_1b", "train=gpt2",
            "train.parallel_strategy=tp_fsdp", "mesh.dp=1", "mesh.fsdp=1",
            "mesh.tp=1", f"train.batch_size={batch}",
            f"train.dataset_kwargs.seq_len={seq}",
            f"train.dataset_size={steps * batch}", "train.total_epochs=1",
            "train.save_every=0", "train.log_every=1",
            "run.log_level=WARNING", f"run.output_dir={out}"]) == 0,
            "train_tp_1b failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, designs = _read_counts(), _read_designs()
    gathers, reduces = dict(fsdp.GATHERS), dict(tp_lib.ALL_REDUCES)
    runtime = _check_nccl_runtime(out, "train_tp_1b")
    rows = _metrics_rows(out)
    cfg = TransformerConfig(**PRESETS["transformer_1b"])
    L = cfg.n_layers
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows if "grad_norm" in r]
    want_losses = [r["loss"] for r in rows_1b]
    want_norms = [r["grad_norm"] for r in rows_1b if "grad_norm" in r]
    check(len(losses) == len(want_losses) == steps
          and len(norms) == len(want_norms) == steps - 1,
          f"train_tp_1b: {len(losses)} loss rows")
    check(all(math.isfinite(x) for x in losses), f"non-finite {losses}")
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows[3:]]))
    flops = Transformer(cfg, device="cpu").flops_per_sample() * batch
    # Per step: two reduce_from_tp a layer and the lookup's; two
    # copy_to_tp a layer and the head input's; two all-reduces per
    # cross-entropy chunk (4 x 2048 rows in chunks of 2048).
    chunks = batch * seq // 2048
    want_reduces = {"reduce_from_tp": (2 * L + 1) * steps,
                    "copy_to_tp": (2 * L + 1) * steps,
                    "xent": 2 * chunks * steps}
    info = {"phase": "train_tp_1b", "model": "transformer_1b",
            "strategy": "tp_fsdp", "mesh": {"tp": 1, "fsdp": 1},
            "runtime": runtime, "batch": batch, "seq": seq, "steps": steps,
            "wall_s": wall, "median_step_s": step_s,
            "median_step_s_train_1b": float(np.median(
                [1.0 / r["steps_per_sec"] for r in rows_1b[3:]])),
            "tokens_per_s": batch * seq / step_s,
            "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "losses": losses, "losses_train_1b": want_losses,
            "grad_norms": norms, "grad_norms_train_1b": want_norms,
            "first_losses_bitwise": losses[:2] == want_losses[:2],
            "loss_rel_diff": _rel_diffs(losses, want_losses),
            "grad_norm_rel_diff": _rel_diffs(norms, want_norms),
            "gathers": gathers, "all_reduces": reduces,
            "all_reduces_predicted": want_reduces,
            "launches": launches, "launches_by_design": designs}
    emit(info)
    check(info["first_losses_bitwise"],
          f"train_tp_1b: losses {losses[:2]} != train_1b's "
          f"{want_losses[:2]}")
    check(info["loss_rel_diff"] <= TP_LOSS_RTOL
          and info["grad_norm_rel_diff"] <= TP_GRAD_NORM_RTOL,
          f"train_tp_1b against train_1b outside the limits: {info}")
    want_gathers = {"layer": L * steps, "tok_embed": steps, "lm_head": steps}
    check(gathers == want_gathers,
          f"train_tp_1b: gathers {gathers}, want {want_gathers}")
    check(reduces == want_reduces,
          f"train_tp_1b: all-reduces {reduces}, want {want_reduces}")
    for name in ("flash_fwd", "flash_bwd_fused"):
        check(designs[name]["wgmma"] == L * steps == launches[name],
              f"train_tp_1b: {name} launches {designs[name]}")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          "train_tp_1b took the split kernels")
    return launches, designs


def _tp2_trainer(rt, strategy: str, fault: bool = False):
    """A Trainer on gpt2_125m / conf/train/gpt2.yaml for TRAIN_TP2_STEPS
    steps of batch 8 under ``strategy`` over ``rt``, and its loader.
    ``fault``: the tp group's first ``reduce`` of each forward (layer 0's
    attention output) skips its all-reduce."""
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.parallel.tensor import TPGroup
    from distributed_training_tpu_torch.train.trainer import Trainer

    batch = 8
    cfg = load_config(overrides=[
        "model=gpt2_125m", "train=gpt2",
        f"train.parallel_strategy={strategy}", f"train.batch_size={batch}",
        f"train.dataset_size={TRAIN_TP2_STEPS * batch}",
        "train.total_epochs=1", "train.log_every=0"])
    kwargs = dict(cfg.model.kwargs)
    dtype = kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(cfg.model.name, loss=cfg.train.loss, dtype=dtype,
                        device=rt.device, **kwargs)
    loader = ShardedDataLoader(
        build_dataset(cfg.train.dataset,
                      _defaults={"size": cfg.train.dataset_size,
                                 "seed": cfg.train.seed},
                      **cfg.train.dataset_kwargs),
        rt, batch_size=batch, shuffle=cfg.train.shuffle,
        seed=cfg.train.seed)
    trainer = Trainer(cfg, rt, model, loader)
    if fault:
        layers = model.cfg.n_layers

        class DropLayer0AttentionReduce(TPGroup):
            calls = 0

            def reduce(self, x):
                self.calls += 1
                if self.calls % (2 * layers) == 1:
                    return x
                return super().reduce(x)

        model.bind_tensor_parallel(
            DropLayer0AttentionReduce(rt.group(("tp",))))
    return trainer, loader


def _tp2_steps(trainer, loader) -> dict:
    """Every step of the loader's epoch 0, each synchronised: losses,
    gradient norms and step wall times."""
    out = {"losses": [], "grad_norms": [], "step_s": []}
    for batch in loader.epoch(0):
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    return out


def train_tp2_rank(rank: int, port: int, out_path: str) -> int:
    """One of phase train_tp2's two processes: on ``cuda:0``, in a gloo
    group of 2 over ``127.0.0.1:port``, a runtime over the mesh tp 2
    built here (the CLI's runtime would ask for NCCL on a card), the
    sound run then the planted fault's; writes its readings to
    ``out_path``."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.parallel import tensor as tp_lib
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        rt = slice_runtime([MeshSpec(tp=2)],
                           torch.device("cuda", 0))
        result = {"rank": rank, "describe": rt.describe()}
        for run in ("sound", "fault"):
            trainer, loader = _tp2_trainer(rt, "tp", fault=run == "fault")
            _free_memory()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            tp_lib.ALL_REDUCES.clear()
            result[run] = {**_tp2_steps(trainer, loader),
                           "all_reduces": dict(tp_lib.ALL_REDUCES),
                           "launches": _read_counts(),
                           "launches_by_design": _read_designs(),
                           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            del trainer, loader
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def phase_train_tp2(tmp: str) -> tuple:
    """gpt2_125m at full width under ``tp`` at tp 2 on the one card: two
    processes on ``cuda:0`` in a gloo group (every collective of pure tp
    at dp = fsdp = 1 is an all-reduce, or a gather over a group of one),
    each running 6 of the 12 heads (B1/B2 on the tensor cores) and half
    the vocab, TRAIN_TP2_STEPS steps of conf/train/gpt2.yaml, against the
    same steps in this process under ``ddp``. The kernels are built (by
    phase_build) before the processes start. Step times are gloo's,
    every all-reduce staged through the host: a correctness reading."""
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.runtime import Runtime

    _free_memory()
    trainer, loader = _tp2_trainer(Runtime(device=torch.device("cuda", 0)),
                                   "ddp")
    want = _tp2_steps(trainer, loader)
    del trainer, loader
    _free_memory()
    port = _free_port()
    outs = [os.path.join(tmp, f"train_tp2.rank{r}.json") for r in range(2)]
    logs = [open(os.path.join(tmp, f"train_tp2.rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-tp2-rank",
         str(r), str(port), outs[r]], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if codes != [0, 0]:
        for r in range(2):
            with open(logs[r].name) as f:
                print(f"train_tp2 rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"train_tp2: ranks exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    L = PRESETS["gpt2_125m"]["n_layers"]
    steps = TRAIN_TP2_STEPS
    # Per step: 2L + 1 reduce_from_tp and copy_to_tp, two per
    # cross-entropy chunk (8 x 1024 rows in chunks of 2048).
    want_reduces = {"reduce_from_tp": (2 * L + 1) * steps,
                    "copy_to_tp": (2 * L + 1) * steps,
                    "xent": 2 * (8 * 1024 // 2048) * steps}
    readings = {}
    for run in ("sound", "fault"):
        got = ranks[0][run]
        check(len(got["losses"]) == len(want["losses"]) == steps,
              f"train_tp2 {run}: {got['losses']} vs {want['losses']}")
        readings[run] = {
            "loss_rel_diff": _rel_diffs(got["losses"], want["losses"]),
            "grad_norm_rel_diff": _rel_diffs(got["grad_norms"],
                                             want["grad_norms"])}
        readings[run]["within"] = (
            readings[run]["loss_rel_diff"] <= TP_LOSS_RTOL
            and readings[run]["grad_norm_rel_diff"] <= TP_GRAD_NORM_RTOL)
    per_rank = [{
        "rank": r["rank"], "describe": r["describe"],
        "losses": r["sound"]["losses"],
        "grad_norms": r["sound"]["grad_norms"],
        "median_step_s": float(np.median(r["sound"]["step_s"][1:])),
        "step_s": r["sound"]["step_s"],
        "peak_mem_bytes": r["sound"]["peak_mem_bytes"],
        "all_reduces": r["sound"]["all_reduces"],
        "all_reduces_per_step": {k: v / steps for k, v in
                                 r["sound"]["all_reduces"].items()},
        "launches": r["sound"]["launches"],
        "launches_by_design": r["sound"]["launches_by_design"],
        "fault_losses": r["fault"]["losses"]} for r in ranks]
    emit({"phase": "train_tp2", "model": "gpt2_125m", "strategy": "tp",
          "mesh": {"tp": 2}, "backend": "gloo", "processes_on_card": 2,
          "batch": 8, "seq": 1024, "steps": steps, "wall_s": wall,
          "ddp_losses": want["losses"],
          "ddp_grad_norms": want["grad_norms"],
          "ddp_median_step_s": float(np.median(want["step_s"][1:])),
          "loss_rtol": TP_LOSS_RTOL, "grad_norm_rtol": TP_GRAD_NORM_RTOL,
          "fault": "layer 0's attention all-reduce dropped",
          "readings": readings, "all_reduces_predicted": want_reduces,
          "ranks": per_rank})
    for r in per_rank:
        check(all(math.isfinite(x) for x in r["losses"]),
              f"train_tp2: non-finite {r['losses']}")
        check(r["losses"] == per_rank[0]["losses"]
              and r["grad_norms"] == per_rank[0]["grad_norms"],
              "train_tp2: the two ranks report different metrics")
        check(r["all_reduces"] == want_reduces,
              f"train_tp2: rank {r['rank']} all-reduces "
              f"{r['all_reduces']}, want {want_reduces}")
        designs = r["launches_by_design"]
        for name in ("flash_fwd", "flash_bwd_fused"):
            check(designs[name]["wgmma"] == L * steps
                  == r["launches"][name],
                  f"train_tp2: rank {r['rank']} {name} launches "
                  f"{designs[name]}")
    check(readings["sound"]["within"],
          f"train_tp2: tp 2 against ddp outside the limits: {readings}")
    check(not readings["fault"]["within"],
          f"train_tp2: the planted fault passed the limits: {readings}")
    # Both ranks' launches are the card's.
    launches = {k: sum(r["launches"][k] for r in per_rank)
                for k in per_rank[0]["launches"]}
    designs = {k: {d: sum(r["launches_by_design"][k][d] for r in per_rank)
                   for d in per_rank[0]["launches_by_design"][k]}
               for k in per_rank[0]["launches_by_design"]}
    return launches, designs


def phase_train_1b_trace() -> None:
    """Where a transformer_1b fsdp step's time goes: 2 steps under
    ``torch.profiler`` after 2 unprofiled ones, through the Trainer in
    a NCCL group of one rank."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.runtime import (
        initialize_runtime,
        shutdown_runtime,
    )
    from distributed_training_tpu_torch.train.trainer import Trainer

    _free_memory()
    with _nccl_world_of_one():
        cfg = load_config(overrides=[
            "model=transformer_1b", "train=gpt2",
            "train.parallel_strategy=fsdp", "train.batch_size=4",
            "train.dataset_kwargs.seq_len=2048", "train.dataset_size=16"])
        rt = initialize_runtime(cfg)
        try:
            loader = ShardedDataLoader(
                build_dataset(cfg.train.dataset,
                              _defaults={"size": 16, "seed": 0},
                              **cfg.train.dataset_kwargs), rt, batch_size=4)
            model = build_model(cfg.model.name, dtype=cfg.train.dtype,
                                device=rt.device, **cfg.model.kwargs)
            trainer = Trainer(cfg, rt, model, loader)
            batches = iter(loader.epoch(0))
            for _ in range(2):
                trainer.train_step(next(batches))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    trainer.train_step(next(batches))
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            batches.close()
            del trainer
        finally:
            shutdown_runtime(rt)
    dev = _device_time(prof, wall_us, top_n=12)
    nccl_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and "nccl" in e.name.lower())
    emit({"phase": "train_1b_trace", "steps": 2, "batch": 4, "seq": 2048,
          **dev, "host_ms_per_step": wall_us / 2e3,
          "device_ms_per_step": dev["device_busy_us"] / 2e3,
          "attention_share": dev["flash_us"] / dev["device_busy_us"],
          "nccl_us": nccl_us})


def _same_tree(a, b) -> bool:
    """Nested dicts of tensors (and plain values) equal bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def phase_train_fsdp_ckpt(tmp: str) -> None:
    """gpt2_125m, batch 8 (the training shape the kernels phases check),
    4 steps (2 epochs of 2) with a save at step 2, four runs, all with
    the split flash backward, whose dq sums in a fixed order (the fused
    one adds dq tiles by atomics in an order that varies, so two runs
    with it part after their first update):

    - fsdp in a NCCL group of one rank, a sharded save and the
      consolidated artifact at step 2;
    - the same, resumed from a copy of that step-2 checkpoint: steps 3-4
      equal the uninterrupted run's bit for bit;
    - ddp with no process group: at fsdp 1 the per-layer gathers and
      reduce-scatters are copies over the card's NCCL group of one, so
      the fsdp run's losses and gradient norms equal these bit for bit;
    - ddp with ``offload_opt_state``: the moments in pinned host memory,
      copied to the card and back around every update, give the same
      bits, and so does its step-2 checkpoint (params and moments).

    The artifact loads through ``load_consolidated`` with every key and
    shape of the model."""
    import shutil

    from distributed_training_tpu_torch.checkpoint.consolidate import (
        load_consolidated,
    )
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        TransformerConfig,
        param_shapes,
    )
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.train import cli
    from distributed_training_tpu_torch.train.optimizer import flatten

    batch = 8
    fsdp_args = ("train.parallel_strategy=fsdp", "train.gather_on_save=true")
    _free_memory()

    def run(out, *extra, group=True):
        """{step: (loss, grad_norm)} of one CLI run."""
        fa.FORCE_SPLIT_BWD = True
        try:
            with (_nccl_world_of_one() if group
                  else contextlib.nullcontext()):
                check(cli.main(_train_overrides(out, 2, batch=batch, extra=(
                    "train.total_epochs=2", "train.save_every=2",
                    *extra))) == 0, f"train_fsdp_ckpt run {out} failed")
        finally:
            fa.FORCE_SPLIT_BWD = False
        if group:
            _check_nccl_runtime(out, "train_fsdp_ckpt")
        return {r["step"]: (r["loss"], r.get("grad_norm"))
                for r in _metrics_rows(out)}

    def step2(out, name):
        return torch.load(os.path.join(out, "default", "checkpoints", "2",
                                       name),
                          map_location="cpu", weights_only=True)

    a, c, d, e = (os.path.join(tmp, f"fsdp_{x}") for x in "acde")
    la = run(a, *fsdp_args)
    ckpt_a = os.path.join(a, "default", "checkpoints")
    files = sorted(os.listdir(os.path.join(ckpt_a, "2")))
    check(files == ["layout.json", "meta.json", "state.rank0.pt"],
          f"train_fsdp_ckpt: step-2 checkpoint holds {files}")
    shutil.copytree(os.path.join(ckpt_a, "2"),
                    os.path.join(c, "default", "checkpoints", "2"))
    lc = run(c, *fsdp_args)
    resume = [ev for ev in _events(c) if ev["kind"] == "resume"]
    check(len(resume) == 1 and resume[0]["step"] == 2,
          f"train_fsdp_ckpt: resume events {resume}")
    check(sorted(la) == [1, 2, 3, 4] and sorted(lc) == [3, 4],
          f"train_fsdp_ckpt: steps {sorted(la)} and {sorted(lc)}")
    # A run's first row is a warm-up row without a gradient norm.
    check(lc[3][0] == la[3][0] and lc[4] == la[4],
          f"train_fsdp_ckpt: resumed {lc} != uninterrupted {la}")
    ld = run(d, group=False)
    check(la == ld, f"train_fsdp_ckpt: fsdp in a group of one {la} != "
          f"ddp with no group {ld}")
    le = run(e, "train.offload_opt_state=true", group=False)
    check(le == ld, f"train_fsdp_ckpt: ddp with offload_opt_state {le} "
          f"!= without {ld}")
    check(_same_tree(step2(e, "state.pt"), step2(d, "state.pt")),
          "train_fsdp_ckpt: the offloaded run's step-2 checkpoint differs")
    state, meta = load_consolidated(
        os.path.join(ckpt_a, "consolidated_step2.pt"))
    want = flatten(param_shapes(TransformerConfig(**PRESETS["gpt2_125m"])))
    got = {k: tuple(v.shape) for k, v in flatten(state["params"]).items()}
    check(got == want, f"train_fsdp_ckpt: artifact shapes {got}")
    shard = step2(a, "state.rank0.pt")
    check(_same_tree(flatten(state["params"]), flatten(shard["params"]))
          and meta["step"] == 2,
          "train_fsdp_ckpt: the artifact is not the step-2 params")
    emit({"phase": "train_fsdp_ckpt", "model": "gpt2_125m",
          "strategy": "fsdp", "batch": batch, "seq": 1024,
          "losses_uninterrupted": [la[k][0] for k in sorted(la)],
          "losses_resumed": [lc[k][0] for k in sorted(lc)],
          "grad_norms": [la[k][1] for k in sorted(la)],
          "bitwise": True, "backward": "split",
          "fsdp_equals_ddp_no_group": True,
          "offload_equals_ddp": True, "offload_ckpt_equal": True,
          "artifact_bytes": os.path.getsize(
              os.path.join(ckpt_a, "consolidated_step2.pt"))})


def main() -> int:
    if sys.argv[1:2] == ["--train-tp2-rank"]:
        return train_tp2_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
    if sys.argv[1:2] == ["--serving-mesh-rank"]:
        return serving_mesh_rank(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4], sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import distributed_training_tpu_torch  # noqa: F401 — needs the repo

    device = phase_device()
    phase_build()
    measured = phase_kernels()
    phase_xent()
    prompts = _smoke_prompts()
    serve_launches, batched = phase_serving(prompts, 64)
    long = {i: p for i, p in enumerate(prompts) if len(p) >= 128}
    check(len(long) >= 2, "fewer than two prompts of >= 128 tokens")
    seq_launches = phase_sequential(long, 64, batched)
    spec_launches = phase_serving_spec(prompts, 64, batched)
    resident_launches = phase_serving_resident(prompts, 64, batched)
    int8_launches = phase_serving_int8(prompts, 64, batched)
    swap_launches = phase_serving_swap(prompts, 64)
    phase_parity([p for p in prompts if len(p) >= 128][:2], 16)
    phase_trace(prompts, 64)
    phase_trace_resident(prompts, 64)
    with tempfile.TemporaryDirectory(prefix="dtt_chip_smoke_") as tmp:
        mesh_launches = {name: phase_serving_mesh(name, prompts, batched, tmp)
                         for name in SERVING_MESHES}
        recovery_launches = phase_serving_recovery(prompts, tmp)
        disagg_launches = phase_serving_disagg(prompts, 64, tmp)
        cli_launches = phase_serving_cli(prompts, 64, batched, tmp)
        train_launches = phase_train(tmp)
        split_launches = phase_train_split(tmp)
        phase_train_parity(tmp)
        phase_train_bf16_parity(tmp)
        train_1b_launches, rows_1b = phase_train_1b(tmp)
        tp_1b_launches = phase_train_tp_1b(tmp, rows_1b)
        tp2_launches = phase_train_tp2(tmp)
        phase_train_fsdp_ckpt(tmp)
    phase_train_trace()
    phase_train_trace(split=True)
    phase_train_1b_trace()
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
    # (serving, sequential prefill, speculative serving, resident serving,
    # int8 serving, the swapped resident engine, the supervised recovery,
    # the disaggregated pipeline's bf16 run, the CLI-started server's bf16
    # run (counted in its process), training, split-backward
    # training, transformer_1b under fsdp and under tp_fsdp, gpt2_125m
    # under tp at tp 2, serving on the meshes dp 2 and tp 2: both
    # processes).
    paths = (serve_launches, seq_launches, spec_launches, resident_launches,
             int8_launches, swap_launches, recovery_launches, disagg_launches,
             cli_launches,
             *mesh_launches.values(), train_launches, split_launches,
             train_1b_launches, tp_1b_launches, tp2_launches)
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
        if name in ("flash_fwd", "flash_bwd_fused"):
            # The same kernel at train_tp2's geometry (6 heads a rank).
            kernels[-1]["tp2_case"] = {
                k: measured[f"{name}_tp2"][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}
        if name == "paged_decode":
            # The same kernel at the decode chain's geometry (32 rows),
            # the case speculative and resident decode launch.
            kernels[-1]["chain_case"] = {
                k: measured["paged_decode_chain"][k]
                for k in ("shape", "max_abs_err", "ms", "plain_ms",
                          "bound_ms", "bound_by", "library_ms")}
            # And at the geometries of one mesh rank (serving_tp2: 8
            # rows, 6 kv heads; serving_dp2: 4 rows, 12), with their
            # launches there (both processes).
            for mesh in SERVING_MESHES:
                kernels[-1][f"{mesh}_rank_case"] = {
                    **{k: measured[f"paged_decode_{mesh}"][k]
                       for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
                    "launches": mesh_launches[mesh][0][name]}
            # Its launches on the disaggregated pipeline's decode engine.
            kernels[-1]["serving_disagg_launches"] = disagg_launches[0][name]
        if name in ("paged_decode", "flash_fwd"):
            # Its launches in the server process started through the CLI.
            kernels[-1]["serving_cli_launches"] = cli_launches[0][name]
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the path was never launched")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

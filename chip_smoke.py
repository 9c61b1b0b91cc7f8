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
- serving on a mesh (``serving_dp2``, ``serving_tp2``,
  ``serving_fsdp2``): two processes on ``cuda:0`` in a gloo group, each
  one rank of the mesh dp 2 (a dp group of 4 slots with its own pool),
  tp 2 (6 of the 12 heads, half the MLP and the vocab) or fsdp 2 (half
  of every weight, gathered whole a layer at a time in every launch),
  through ``Engine(..., mesh=runtime)``: the float32 logits of every
  request's first decoded position held against one process, with a
  planted fault that must fail the same limit; then bf16, the serving
  prompts batched and the long ones sequential, token agreement
  reported, collectives and launches held to the design; under fsdp the
  bytes one decode step gathers equal the planner's price of that
  layout (``_score_serving``'s ``all-gather`` term);
- the planner (``plan``): ``parallel/planner.py --check`` against the
  committed plans (five clean, and JAX's ranking drift on
  ``multichip_8dev_cpu``), then the search over gpt2_125m at full width
  on the card (12 candidates) whose gate trains the winner one step
  under its plan and one unplanned (B1, B2), the estimate's memory and
  compute time beside the step's peak allocation and device time, and a
  planted fault (the first candidate's planned run from another seed)
  that must be disqualified;
- the static analysis (``audit``): the pitfall rules (DTT0xx) over the
  tree, and the ``single_chip_headline`` target (gpt2_125m, seq 1024,
  batch 4, bf16) audited, one step of its Trainer on the card whose
  recorded collectives and findings must both be none (B1, B2); and the
  calibration's matmul ladder (``calibrate``: f32, 256 to 2048 square)
  beside the card's name and power limit;
- tensor parallelism: transformer_1b at full width under ``tp_fsdp``
  (tp 1, fsdp 1) through the CLI in a NCCL group of one rank, every
  tensor-parallel collective over a group of one, its losses held
  against ``train_1b``'s; and gpt2_125m at full width under ``tp`` at
  tp 2 on the one card (``train_tp2``): two processes on ``cuda:0`` in a
  gloo group, each on 6 of the 12 heads and half the vocab, the Trainer
  driven directly, its losses and gradient norms held against one
  process under ``ddp``, with a planted fault (layer 0's attention
  all-reduce dropped) that must fail the same limits, and its first
  step's ``collectives`` event (rank 0's alone) held against the
  phase's all-reduce counts;
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
  B4 launches, token agreement at bf16 and equality at float32;
- the default config and the real-text path: the C++ gather and fill
  against NumPy (``native``); the trainer CLI with no override, the MLP
  on ``synthetic`` under SGD, and its resume (``train_mlp``); a byte
  corpus of the repository's own text (``data/prepare.py``), the byte LM
  of ``conf/model/byte_lm.yaml`` trained on it at full width with its
  held-out split, ``eval.py`` on the run, and ``generate.py`` with paged
  and fused decode, their greedy tokens equal at float32
  (``train_bytes_lm``); gpt2_125m under Adafactor (``adafactor``); the
  local launcher at one process on the card and two on the CPU, and the
  DDP playground at world 2 on the card over gloo
  (``launch_playground``);
- resilience and exactly-once data, gpt2_125m at full width on a stream
  of two sources (the repository's text as bytes and synthetic
  documents) packed into blocks of 1025: the save stalls of a
  synchronous and an asynchronous checkpoint of its 1.49 GB train state,
  its manifest, and an update right behind an async save that leaves the
  saved bits alone; ``launch --supervise`` with ``corrupt_ckpt@8,
  crash@10`` under the split backward, whose restarted run quarantines
  step 8, resumes from step 4 and ends bit-identical to an uninterrupted
  run (``train_supervised``); ``sigterm@6`` mid-epoch, whose resume
  takes the uninterrupted run's batches (by sha256) from step 7 on, its
  losses bit for bit under the split backward and, under the fused one,
  within the bf16 parity limits over the steps before the stream's loss
  spike, with one step's gradients under both backwards reported
  (``train_preempt_stream``); and a world of 2 under
  ``fsdp`` (two processes on ``cuda:0`` over gloo, split backward),
  held against world 1 over those steps beside a control with unsummed
  gradients that must fail, resumed at world 1 through the resharded
  restore, every batch taken once (``train_elastic``);
- the training run's own observability, gpt2_125m at full width
  through the CLI: an in-run ``torch.profiler`` capture whose
  ``attribution`` event names the flash kernels and whose device-busy
  time agrees with ``_device_time``'s reading of the same trace file,
  the goodput ledger's run event (buckets summing to its wall, MFU
  beside the metrics stream's), HBM samples against the state's bytes,
  the live ``/metrics`` endpoint read during the run, and the summarizer
  and the doctor on the run dir (``train_telemetry``); the hang
  watchdog's abort on a planted data stall, exit 42 with the loader's
  stacks and an incident bundle the doctor reads (``train_watchdog``);
  and GPT-2's dropout, a fused run and two split reruns equal bit for
  bit, the fused run with a planted slow host that the anomaly detector
  must flag (``train_dropout``);
- sequence parallelism at sp 2, gpt2_125m at full width (batch 8,
  sequence 1024, conf/train/gpt2.yaml) in two processes on ``cuda:0``
  over gloo, each holding 512 positions of every row, against world 1 on
  the same batches with a planted fault (gradients left unsummed over
  sp) that must fall outside the limits: ring attention, its blocks on
  B1 (the diagonal causal, the past block non-causal, f32 out) and the
  split backward B3a/B3b, with a rerun that repeats its bits
  (``train_sp2_ring``); Ulysses, its local attention on B1 and B2 over 6
  heads and the whole sequence (``train_sp2_ulysses``); and the ring
  under a window of 256, the diagonal block's band on the kernels and
  the offset block on the plain path (``train_sp2_ring_window``). The
  kernel phase holds the ring's blocks at that shard (B 8, H 12, S 512)
  against their plain versions;
- pipeline parallelism at pp 2, gpt2_125m at full width (batch 8,
  sequence 1024, conf/train/gpt2.yaml, 4 microbatches of 2 rows) in two
  processes on ``cuda:0`` over gloo, each a stage of 6 layers, under the
  GPipe schedule (``train_pp2_gpipe``) and the interleaved one with two
  chunks of 3 layers a stage (``train_pp2_interleaved``): each against
  world 1 on the same batches, with a planted fault (the tied
  embedding's gradient left unsummed over pp) that must fall outside the
  limits, and two runs under the split backward that repeat their bits.
  Each stage's attention runs B1 twice a layer and microbatch (the
  forward and the backward's recompute) and B2 (or B3a/B3b); the kernel
  phase holds them at the microbatch shape (B 2, H 12, S 1024);
- MoE and expert parallelism, moe_transformer at full width (8 experts,
  top-2, d_ff 2048, 168.65M params) on conf/train/gpt2.yaml at sequence
  512: the trainer CLI for 20 steps and 10 under the split backward,
  with its step time, tokens/s, MFU from ``flops_per_token``, peak
  memory and the share of (token, slot) pairs capacity dropped
  (``train_moe``); one MoE layer in f32, routed against dense at ample
  capacity, and in bf16 against its f32 run (``moe_parity``); the model
  under ``fsdp`` at fsdp 2, the experts split 4 a process, in two
  processes on ``cuda:0`` over gloo against world 1, with a planted
  fault (the expert leaves' gradients unsummed over fsdp) that must fall
  outside the limits, and the gathered and reduce-scattered bytes a step
  (``train_moe_ep2``); and ``generate.py`` on its checkpoint, the fused
  decode (``generate_moe``). The kernel phase holds B1, B2, B3a and B3b
  at its attention's shape (B 8, H 8, S 512);
- ResNet-18 (BASELINE.json config 2) at full width, 11,172,170 params,
  with no flash or paged kernel on its path (cuDNN's convs, eager
  GroupNorm): JAX's resnet18_ddp configuration through the trainer CLI
  for an epoch of 32 steps, resumed for a second, then ``eval.py`` on the
  run, every conv input channels_last (``train_resnet18``); one batch of
  64 at f32 on the card against the CPU and an f64 run, with cuDNN's
  TF32 allowed beside it, and bf16 against f32, with a planted fault
  (the 3x3 stride-2 convs padded (1, 1)) that must fail
  (``resnet_parity``); and f32 under ``ddp`` and ``fsdp`` in two
  processes on ``cuda:0`` over gloo against world 1, with a planted
  fault (every gradient unsummed) that must fall outside the limits,
  and each first step's ``collectives`` event held against the leaves'
  bytes and the gathered and reduce-scattered traffic
  (``train_resnet_dp2``).

Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA card, or without the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import math
import os
import shutil
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
# Sequence parallelism at sp 2 (train_sp2_ring, train_sp2_ulysses,
# train_sp2_ring_window): gpt2_125m in two processes on cuda:0 over gloo,
# each holding 512 of the 1024 positions of every row. The sound run
# takes TRAIN_SP2_STEPS steps and is held over its first SP2_HELD_STEPS
# against one process with the single-process flash attention on the
# same batches, at the tp 2 limits; a ring rerun repeats the sound run's
# losses and gradient norms bit for bit over SP2_HELD_STEPS steps; the
# planted fault (each process's gradients left unsummed over sp) runs
# SP2_HELD_STEPS steps and must fall outside the limits. The windowed
# ring takes SP2_WINDOW_STEPS steps at window SP2_WINDOW. (Cut from 10,
# 5 and 4 steps to keep the whole smoke inside its time limit: each
# gloo step costs 2-2.5 s.)
TRAIN_SP2_STEPS = 4
SP2_HELD_STEPS = 3
SP2_WINDOW = 256
SP2_WINDOW_STEPS = 3
SP_LOSS_RTOL = TP_LOSS_RTOL
SP_GRAD_NORM_RTOL = TP_GRAD_NORM_RTOL
# Pipeline parallelism at pp 2 (train_pp2_gpipe, train_pp2_interleaved):
# gpt2_125m in two processes on cuda:0 over gloo, each a stage of 6 of
# the 12 layers (interleaved: two chunks of 3), PP2_MICROBATCHES
# microbatches of 2 rows. The sound run (fused backward) takes
# TRAIN_PP2_STEPS steps and is held over its first PP2_HELD_STEPS against
# one process on the same batches at the tp 2 limits; the planted fault
# (the tied embedding's gradient left unsummed over pp: stage 0 keeps
# the lookup's part, the last stage the head's) runs PP2_HELD_STEPS steps
# and must fall outside them; two runs under the split backward repeat
# their losses bit for bit over PP2_HELD_STEPS steps. (Cut from 10 and 5
# steps to keep the whole smoke inside its time limit.)
TRAIN_PP2_STEPS = 4
PP2_HELD_STEPS = 3
PP2_MICROBATCHES = 4
PP2_VIRTUAL_STAGES = 2
PP_LOSS_RTOL = TP_LOSS_RTOL
PP_GRAD_NORM_RTOL = TP_GRAD_NORM_RTOL
# MoE (train_moe, moe_parity, train_moe_ep2, generate_moe):
# moe_transformer at full width (d_model 512, 8 layers, 8 heads, 8
# experts top-2, d_ff 2048, capacity factor 1.25, routing groups of up to
# 1024 tokens: one group of 512 a row, C 160), trained on
# conf/train/gpt2.yaml at sequence 512 (batch 8, bf16 compute, f32
# params, AdamW, gpt2_125m.yaml's remat "mlp") through the CLI, then
# TRAIN_MOE_SPLIT_STEPS under the split backward. Its attention is B1
# and B2 (B3a/B3b) at (B 8, H 8, S 512, D 64).
MOE_OVERRIDES = ("model.name=moe_transformer",
                 "train.dataset_kwargs.seq_len=512")
# train_moe takes one batch of synthetic_lm again every step (an epoch of
# one batch) with the warm-up cut from gpt2.yaml's 100 steps to 2, so
# that its losses fall inside the run: on fresh uniform random tokens
# they only wander (PR 19's first two chip calls, warm-up 100 and 2).
TRAIN_MOE_WARMUP = 2
MOE_SEQ = 512
TRAIN_MOE_STEPS = 20
TRAIN_MOE_SPLIT_STEPS = 10
# moe_parity: one MoE layer with its residual at full width (B 8, S 512)
# in f32, routed against dense at ample capacity (capacity factor E/k:
# C is the group's length, nothing drops): outputs relative to the
# largest and the aux within MOE_PARITY_TOL, each gradient within
# MOE_PARITY_GRAD_TOL of its largest; then the bf16 routed layer against
# its f32 run at the bf16 training parity limits (the mean square of the
# layer's output, the gradients' norms).
MOE_PARITY_TOL = 1e-5
MOE_PARITY_GRAD_TOL = 1e-4
# train_moe_ep2: moe_transformer under fsdp at fsdp 2 (the experts'
# dim split: 4 of 8 a process) in two processes on cuda:0 over gloo,
# batch 4 a process, held against world 1 (batch 8) over
# TRAIN_MOE_EP2_STEPS at the tp 2 limits; the planted fault leaves the
# expert leaves' gradients unsummed over fsdp (each process keeps its
# own part of its shard). Both sides run float32 compute and the split
# backward (SIMT kernels at f32): the routing turns any rounding
# difference into other experts for a few tokens, so in bf16 two world-1
# runs under the fused backward part by 1.3e-4 (losses) and 4.2e-3
# (norms) over 5 steps, and fsdp 2 under the split one (its halves of
# each gradient summed in bf16) by 1.3e-4 and 6.4e-3, against 8.7e-8 and
# 9.6e-8 at f32 (PR 19's second chip call, PERF.md).
TRAIN_MOE_EP2_STEPS = 5
MOE_EP2_OVERRIDES = ("train.dtype=float32",)
EP_LOSS_RTOL = TP_LOSS_RTOL
EP_GRAD_NORM_RTOL = TP_GRAD_NORM_RTOL
# Serving on a mesh (serving_dp2, serving_tp2, serving_fsdp2): two
# processes on cuda:0 over gloo, each one mesh rank. At float32 the
# logits of the first decoded position of every request, mesh engine
# against one process, max abs difference; the sound engine differs from
# the one-process one only in summation order (tp's split sums, paged
# decode's split plan at B_local rows or Hkv/tp heads; fsdp's gathered
# weights are the whole weights, bit for bit). The planted faults (dp2:
# rank 1 launches group 0's rows; tp2: layer 0's attention all-reduce
# dropped; fsdp2: rank 1 concatenates layer 0's gathered shards in the
# wrong order) must fall outside the limit. Readings on the H100
# (PERF.md, PR 9): sound 2.1e-6 for both meshes, faults 2.96 (dp2) and
# 1.97 (tp2), the largest logit 2.93; the limit lies between.
MESH_LOGITS_TOL = 1e-4
SERVING_MESHES = {"dp2": {"dp": 2}, "tp2": {"tp": 2}, "fsdp2": {"fsdp": 2}}
# Phase plan: the committed targets ``planner --check`` must find clean,
# and the one whose JAX ranking drifted from its committed file in the
# last bit of a few scores (ROADMAP.md, "Reference caveats"), for which
# the check must print JAX's ranking-drift line and nothing else.
PLAN_CLEAN = ("multichip_8dev", "serving_8dev_cpu_decode",
              "serving_4dev_cpu_prefill", "serving_4dev_cpu_decode",
              "serving_8dev_cpu_decode_int8")
PLAN_DRIFTED = "multichip_8dev_cpu"
# The card target the phase searches: gpt2_125m at full width, bf16
# compute, 12 candidates (3 remat x 4 batch) on one device, every comms
# term 0; the scores tie over batch and the largest batch wins.
PLAN_WINNER = "pp1.dp1.fsdp1.sp1.tp1/none/b8"
# New tokens a request in the mesh phases' bf16 bursts and in the
# profiled bursts of trace and trace_resident (cut from 64 to keep the
# whole smoke inside its time limit; the other serving phases keep 64).
MESH_NEW_TOKENS = 16
TRACE_NEW_TOKENS = 16
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
# native: the C++ gather's source rows (int32, 64 bytes a row) and the
# fill's tokens.
NATIVE_ROWS = 1_000_000
NATIVE_FILL = 10_000_000
# train_bytes_lm: steps in each of its 2 epochs, eval.py's batches, the
# bytes of generate.py's prompt and the tokens it decodes. 128 bytes: the
# model's attention gate takes the flash forward for a prompt of at least
# 128 positions in whole tiles, the naive path below that (as the JAX
# gate does).
BYTES_STEPS_PER_EPOCH = 100
BYTES_EVAL_BATCHES = 50
GEN_PROMPT_BYTES = 128
GEN_TOKENS = 64
# generate's bf16 decodes against the f32 forward of the same prefix
# (_bf16_decode_logits): the paged decode's largest logit error may be at
# most this multiple of the fused decode's. Both round the same weights
# and activations to bf16 at different points; a fault in the paged
# decode's attention errs on the scale of the logits themselves.
DECODE_LOGITS_RATIO = 4.0
# adafactor: gpt2_125m steps.
ADAFACTOR_STEPS = 10
# train_telemetry: the in-run capture's first step and length, the HBM
# sampling cadence, and the largest difference allowed between the
# attribution event's device-busy time and _device_time's reading of the
# same trace file (relative). The goodput run event's buckets must sum
# to its wall within GOODPUT_SUM_RTOL.
PROFILE_AT, PROFILE_STEPS, HBM_EVERY = 12, 2, 5
ATTRIBUTION_BUSY_RTOL = 0.05
GOODPUT_SUM_RTOL = 1e-6
# train_watchdog: the watchdog's timeout and the data stall (longer)
# planted at step 4; the abort's exit code.
WATCHDOG_TIMEOUT_S, WATCHDOG_STALL = 5, "data_stall@4:20s"
WATCHDOG_EXIT = 42
# train_dropout: steps of each run and GPT-2's dropout rate; the slow
# host planted in its first run (300 ms a step from step 7, against
# steps of about 75 ms) and the anomaly detector's baseline length there.
DROPOUT_STEPS, DROPOUT_RATE = 10, 0.1
ANOMALY_SLOW_AT = 7
ANOMALY_SLOW_FAULT = f"slow_host@{ANOMALY_SLOW_AT}:host=0:300ms"
ANOMALY_MIN_SAMPLES = 4
# ResNet-18 (BASELINE.json config 2): the JAX package's own resnet18_ddp
# configuration (benchmarks/run.py): CIFAR-shaped synthetic images
# (32x32x3, 10 classes), batch 64, AdamW at 1e-3, ddp, bf16, unshuffled.
# One epoch of its 2048 images is 32 steps; a second, resumed from the
# first's checkpoint, is 32 more.
RESNET_OVERRIDES = ("model=resnet18", "+model.num_classes=10",
                    "train.dataset=synthetic_images",
                    "train.dataset_kwargs.size=2048", "train.batch_size=64",
                    "train.optimizer=adamw", "train.learning_rate=1e-3",
                    "train.parallel_strategy=ddp", "train.shuffle=false")
RESNET_BATCH, RESNET_STEPS = 64, 32
# resnet_parity, on one batch of 64 from one init. f32: the card's
# logits and loss against the port's CPU run, relative; each leaf's
# gradient against an f64 run on the card (its largest difference over
# its largest magnitude), the card's worst leaf at most
# RESNET_GRAD_ERR_RATIO times the CPU f32 run's worst. f32 rounding alone
# parts this model's gradients from f64 by 4.6e-3 (CPU) and 4.7e-3
# (card) of a leaf's largest, so the two f32 runs cannot agree to 1e-4
# leaf by leaf; with cuDNN's TF32 allowed the card's reads 0.072. bf16
# against f32 on the card: the loss and the global gradient norm; the
# bf16 logits alone (2^-9 each) part the loss by 9.2e-4 and the norm by
# 4.4e-3, past the bf16-against-bf16 limits of the transformer phases
# (1e-4, 1e-3). The planted fault (the 3x3 stride-2 convs padded (1, 1))
# reads 0.21 (f32 logits) and 8.6e-3 and 6.3e-2 (bf16). Readings on the
# H100, PERF.md PR 20; each limit lies between the sound run and the
# fault.
RESNET_PARITY_RTOL = 1e-4
RESNET_GRAD_ERR_RATIO = 2.0
RESNET_BF16_LOSS_RTOL = 3e-3
RESNET_BF16_GRAD_NORM_RTOL = 2e-2
# train_resnet_dp2: steps of each f32 run at the global batch of 64. The
# first step's gradient norm (the same params on both sides) within
# RESNET_DP2_FIRST_NORM_RTOL of world 1's; over the 5 steps the losses
# and norms within the limits below. A process's convs see 32 images
# where world 1's see 64, and at this model's f32 conditioning (above)
# that parts the losses by up to 2.8e-4 and the norms by 1.2e-3 in 5
# steps; the planted fault (every gradient unsummed) 0.2 and 0.6.
RESNET_DP2_STEPS = 5
RESNET_DP2_FIRST_NORM_RTOL = 1e-5
RESNET_DP2_LOSS_RTOL = 1e-3
RESNET_DP2_GRAD_NORM_RTOL = TP_GRAD_NORM_RTOL
# Readings one phase reports beside another's (train's median step).
READINGS: dict = {}


# The script's clock: every phase line carries its seconds since start
# (``t_s``), so a phase's wall is the step from the line before it.
T0 = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


class Timer:
    """Median device time of single calls (CUDA events), each after an
    L2 flush and a device sleep, so that the inputs are not cache-warm
    and the card is busy while the host enqueues the call: the sleep
    lasts at least twice the host's enqueue time of the call (its
    slowest warm-up, at up to 2e9 cycles a second), so the timed span
    opens with the call's work already queued. ``hide_host=False``
    keeps the fixed sleep of 200k cycles (about 0.1 ms) that earlier
    readings used, which a call enqueued more slowly than that times
    together with the host."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, runs: int = 30, warmup: int = 3,
           hide_host: bool = True) -> float:
        host = 0.0
        for i in range(warmup):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if i:
                host = max(host, time.perf_counter() - t0)
        torch.cuda.synchronize()
        cycles = 200_000
        if hide_host:
            cycles = min(max(cycles, int(2 * host * 2e9)), 40_000_000)
        events = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.flush.zero_()
            torch.cuda._sleep(cycles)
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
                block_k=0, library=False, causal=True) -> dict:
    from distributed_training_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, out_dtype=out_dtype)
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
          f"flash_fwd {B}x{H}/{Hkv}x{S}x{D} {dtype} w={window} "
          f"causal={causal}: max err {err} > {tol}")
    check(err_lse <= LSE_TOL, f"flash_fwd lse max err {err_lse}")
    # Live (query, key) pairs of this mask: what the work needs.
    live = fa._live_mask(S, S, causal, window, "cuda")
    pairs = (int(live.sum()) if live is not None else S * S) * B * H
    out_size = torch.empty((), dtype=out_dtype or dtype).element_size()
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() \
        + o.numel() * out_size + lse.numel() * 4
    bound_ms, bound_by = bound(4.0 * pairs * D, nbytes, dtype)
    res = {"shape": [B, H, Hkv, S, D], "dtype": str(dtype).split(".")[1],
           "design": design, "window": window, "causal": causal,
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
            q, k, v, is_causal=causal, enable_gqa=Hkv != H))
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
              grads_dtype=None, library=False, causal=True) -> dict:
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
    kw = dict(causal=causal, window=window)
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
    live = fa._live_mask(S, S, causal, window, "cuda")
    pairs = (int(live.sum()) if live is not None else S * S) * B * H
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    gsize = torch.empty((), dtype=grads_dtype or dtype).element_size()
    res = {"shape": [B, H, Hkv, S, D], "dtype": str(dtype).split(".")[1],
           "window": window, "causal": causal,
           "grads_dtype": str(grads_dtype or dtype).split(".")[1]}
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
              f"{name} {B}x{H}/{Hkv}x{S}x{D} {dtype} w={window} "
              f"causal={causal}: error {max(errs)} of the largest "
              f"gradient > {tol}")
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
        o = F.scaled_dot_product_attention(*xs, is_causal=causal,
                                           enable_gqa=Hkv != H)

        def lib_bwd():
            return torch.autograd.grad(o, xs, do, retain_graph=True)

        lib = timer.ms(lib_bwd)
        # The same call under the fixed 0.1 ms sleep: autograd's host
        # dispatch, when slower than that, lands inside the timed span.
        res["library_ms_fixed_sleep"] = timer.ms(lib_bwd, hide_host=False)
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
    # byte_lm's attention (train_bytes_lm, eval.py): B 16, H 8, S 512.
    flash["byte_lm"] = _flash_case(timer, 16, 8, 8, 512, 64, bf16,
                                   library=True)
    # Ring attention's blocks at gpt2_125m's sp 2 shard (train_sp2_ring):
    # B 8, H 12, S_local 512, f32 out; the past block non-causal, the
    # diagonal causal. Ulysses' local attention (B 8, H 6, S 1024) is the
    # tp2 case's shape.
    flash["ring_past"] = _flash_case(timer, 8, 12, 12, 512, 64, bf16,
                                     out_dtype=f32, causal=False,
                                     library=True)
    flash["ring_diag"] = _flash_case(timer, 8, 12, 12, 512, 64, bf16,
                                     out_dtype=f32, library=True)
    # One pipeline microbatch of gpt2_125m (train_pp2_*): B 2 of 8.
    flash["pp_microbatch"] = _flash_case(timer, 2, 12, 12, 1024, 64, bf16,
                                         library=True)
    # moe_transformer's attention (train_moe, train_moe_ep2's world 1):
    # B 8, H 8, S 512.
    flash["moe"] = _flash_case(timer, 8, 8, 8, MOE_SEQ, 64, bf16,
                               library=True)
    # generate.py --decode fused on byte_lm: its prompt's prefill.
    flash["generate"] = _flash_case(timer, 1, 8, 8, GEN_PROMPT_BYTES, 64,
                                    bf16, library=True)
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
             "dp2_rank": _paged_case(timer, 4, 12, 12, 64, 16, 1024, bf16),
             # generate.py --decode paged on byte_lm: one slot, H = Hkv 8,
             # pages of 16 for the prompt and GEN_TOKENS, at the first
             # and the last decode's length.
             **{f"generate_{at}": _paged_case(
                 timer, 1, 8, 8, 64, 16, GEN_PROMPT_BYTES + GEN_TOKENS,
                 bf16, lengths=[GEN_PROMPT_BYTES + n])
                for at, n in (("first", 1), ("last", GEN_TOKENS - 1))}}
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
    # The ring's reverse pass at its sp 2 shard: the split pair with the
    # final delta and f32 gradients, past block (non-causal) and diagonal.
    for tag, causal in (("past", False), ("diag", True)):
        bwd[f"split_ring_{tag}"] = _bwd_case(
            timer, 8, 12, 12, 512, 64, bf16, True, grads_dtype=f32,
            causal=causal, library=True)
    # One pipeline microbatch (train_pp2_*): the fused backward and the
    # split pair, B 2.
    for split in (False, True):
        tag = "split" if split else "fused"
        bwd[f"{tag}_pp_microbatch"] = _bwd_case(
            timer, 2, 12, 12, 1024, 64, bf16, split, library=True)
    # moe_transformer (train_moe): the fused backward and the split pair.
    for split in (False, True):
        tag = "split" if split else "fused"
        bwd[f"{tag}_moe"] = _bwd_case(timer, 8, 8, 8, MOE_SEQ, 64, bf16,
                                      split, library=True)
    # gpt2_125m under tp 2 (train_tp2, the fused backward): each rank's 6
    # heads.
    bwd["fused_tp2"] = _bwd_case(timer, 8, 6, 6, 1024, 64, bf16, False,
                                 library=True)
    # byte_lm's training (train_bytes_lm): B 16, H 8, S 512, the fused
    # backward.
    bwd["fused_byte_lm"] = _bwd_case(timer, 16, 8, 8, 512, 64, bf16, False,
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
            # An fsdp rank decodes every slot at every head: the main
            # case's geometry.
            "paged_decode_fsdp2": paged["main"],
            "flash_fwd_tp2": flash["tp2"],
            "flash_bwd_fused_tp2": bwd["fused_tp2"]["flash_bwd_fused"],
            "flash_fwd_byte_lm": flash["byte_lm"],
            "flash_fwd_generate": flash["generate"],
            "paged_decode_generate_first": paged["generate_first"],
            "paged_decode_generate_last": paged["generate_last"],
            "flash_bwd_fused_byte_lm": bwd["fused_byte_lm"]["flash_bwd_fused"],
            "flash_bwd_fused": bwd["fused_train"]["flash_bwd_fused"],
            "flash_bwd_library_fixed_sleep":
                bwd["fused_train"]["library_ms_fixed_sleep"],
            "flash_bwd_byte_lm_library_fixed_sleep":
                bwd["fused_byte_lm"]["library_ms_fixed_sleep"],
            "flash_bwd_dq": bwd["split_train"]["flash_bwd_dq"],
            "flash_bwd_dkv": bwd["split_train"]["flash_bwd_dkv"],
            **{f"flash_fwd_ring_{tag}": flash[f"ring_{tag}"]
               for tag in ("past", "diag")},
            "flash_fwd_pp": flash["pp_microbatch"],
            "flash_fwd_moe": flash["moe"],
            "flash_bwd_fused_moe": bwd["fused_moe"]["flash_bwd_fused"],
            "flash_bwd_dq_moe": bwd["split_moe"]["flash_bwd_dq"],
            "flash_bwd_dkv_moe": bwd["split_moe"]["flash_bwd_dkv"],
            "flash_bwd_fused_pp": bwd["fused_pp_microbatch"]["flash_bwd_fused"],
            "flash_bwd_dq_pp": bwd["split_pp_microbatch"]["flash_bwd_dq"],
            "flash_bwd_dkv_pp": bwd["split_pp_microbatch"]["flash_bwd_dkv"],
            **{f"{k}_ring_{tag}": bwd[f"split_ring_{tag}"][k]
               for k in ("flash_bwd_dq", "flash_bwd_dkv")
               for tag in ("past", "diag")}}


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
    from distributed_training_tpu_torch.parallel import fsdp as fsdp_lib
    from distributed_training_tpu_torch.parallel import tensor as tp_lib
    from distributed_training_tpu_torch.serving.engine import Request

    counts = eng.warmup()
    _reset_counts()
    tp_lib.ALL_REDUCES.clear()
    tp_lib.ALL_GATHERS.clear()
    fsdp_lib.GATHERS.clear()
    fsdp_lib.TRAFFIC.clear()
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
            "fsdp_gathers": dict(fsdp_lib.GATHERS),
            "fsdp_gathered_bytes": fsdp_lib.TRAFFIC["gathered_bytes"],
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
            if name == "fsdp2" and run == "sound":
                result["f32_decode_gathers"] = _measure_first_decode_gathers(
                    eng)
            if run == "fault" and name == "fsdp2":
                if rank == 1:
                    eng._fsdp.__class__ = _swap_layer0_halves(
                        type(eng._fsdp))
            elif run == "fault" and name == "tp2":
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
        if name in ("tp2", "fsdp2"):
            # The resident burst is a CUDA graph, which cannot capture
            # gloo's all-reduces or all-gathers: the engine must refuse it.
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
        result["bf16"] = _mesh_serve(eng, prompts, MESH_NEW_TOKENS)
        result["bf16"]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        result["pool_bytes"] = eng.cache.pool_bytes
        result["pool_shape"] = list(eng.cache.k_pages.shape)
        result["weight_bytes"] = eng.weight_bytes
        del eng
        _free_memory()
        long = [p for p in prompts if len(p) >= 128]
        eng = _engine(model, params, mesh=rt, prefill_mode="sequential",
                      prefill_chunk=128)
        result["bf16_sequential"] = _mesh_serve(eng, long, MESH_NEW_TOKENS)
        result["long_ids"] = [i for i, p in enumerate(prompts)
                              if len(p) >= 128]
        del eng
        torch.save(result, out_path)
    finally:
        dist.destroy_process_group()
    return 0


def _swap_layer0_halves(cls):
    """serving_fsdp2's planted fault: the engine's fsdp gather (``cls``,
    ``serving/engine.py::_FsdpWeights``) with layer 0's gathered shards
    concatenated in the wrong order."""

    class SwapLayer0Halves(cls):
        def layer(self, layer, i):
            out = super().layer(layer, i)
            if i == 0:
                for g, n, m, d in self.layer_parts:
                    w = out[g][n] if m is None else out[g][n][m]
                    w = torch.cat(list(reversed(w.chunk(2, d))), d)
                    out[g][n] = w if m is None else {**out[g][n], m: w}
            return out
    return SwapLayer0Halves


def _measure_first_decode_gathers(eng) -> dict:
    """Wrap ``eng``'s decode launch so that its first one records the
    fsdp gathers and gathered bytes of that one launch (filled in the
    returned dict)."""
    from distributed_training_tpu_torch.parallel import fsdp as fsdp_lib

    box: dict = {}
    decode = eng._decode

    def measured(*args):
        b0, g0 = fsdp_lib.TRAFFIC["gathered_bytes"], dict(fsdp_lib.GATHERS)
        out = decode(*args)
        if "bytes" not in box:
            box["bytes"] = fsdp_lib.TRAFFIC["gathered_bytes"] - b0
            box["gathers"] = {k: n - g0.get(k, 0)
                              for k, n in fsdp_lib.GATHERS.items()
                              if n != g0.get(k, 0)}
        return out

    eng._decode = measured
    return box


def _fsdp2_decode_target(dtype: str):
    """serving_fsdp2's layout as a planner target: gpt2_125m at full
    width at ``dtype`` (params and compute, as ``_gpt2``), the decode
    objective over 2 devices, 8 slots of 1024 tokens; and its candidate
    fsdp 2."""
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.parallel import planner

    target = planner.PlanTarget(
        name=f"gpt2_125m_fsdp2_decode_{dtype}", devices=2,
        model_kwargs=dict(PRESETS["gpt2_125m"], dtype=dtype,
                          param_dtype=dtype),
        seq_len=1024, optimizer="none", chip="nvidia h100 80gb hbm3",
        batch_candidates=(8,), objective="decode")
    return target, planner.Candidate(1, 1, 2, 1, 1, "none", 8)


def _logit_diffs(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max()) for k in got)


def phase_serving_mesh(name: str, prompts: list, batched_tokens: dict,
                       tmp: str) -> tuple:
    """Serving gpt2_125m at full width on a mesh of two processes sharing
    ``cuda:0`` over gloo (SERVING_MESHES[name]: dp 2, each process one
    dp group of 4 slots and its own pool; tp 2, each process 6 of the
    12 heads, half the MLP and half the vocab; or fsdp 2, each process
    half of every weight, gathered whole a layer at a time, every slot
    on both), against one process: the
    float32 logits of every request's first decoded position within
    MESH_LOGITS_TOL and the planted fault outside it; at bf16 the
    smoke's 8 prompts batched (MESH_NEW_TOKENS new tokens) and its long
    ones sequential (B1 at the rank's heads), token agreement with the
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
    tp, fs = mesh.get("tp", 1), mesh.get("fsdp", 1)
    # Under fsdp the planner's price of one decode step's weight
    # all-gather (_score_serving, the whole weights at the compute
    # dtype) at float32 and at bf16.
    priced = {}
    if fs > 1:
        from distributed_training_tpu_torch.parallel import planner
        for dt in ("float32", "bfloat16"):
            rec = planner.score_candidate(*_fsdp2_decode_target(dt))
            check(rec["feasible"], f"serving_{name}: the cost model finds "
                  f"its layout infeasible at {dt}: {rec}")
            priced[dt] = rec["comms_bytes_by_kind"]["all-gather"]
        top = ("tok_embed", "pos_embed", "final_norm/scale",
               "final_norm/bias")
        for r in ranks:
            got = r["f32_decode_gathers"]
            check(got["bytes"] == priced["float32"],
                  f"serving_{name} rank {r['rank']}: one f32 decode step "
                  f"gathered {got['bytes']} bytes, the cost model prices "
                  f"{priced['float32']}")
            check(got["gathers"] == {"layer": L, **dict.fromkeys(top, 1)},
                  f"serving_{name} rank {r['rank']}: one decode step's "
                  f"gathers {got['gathers']}")
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
            # Under fsdp: per forward one gather of each layer and of
            # each top-level leaf, the whole weights' bytes.
            design = {
                "all_reduces": ({"reduce_from_tp": (2 * L + 1) * forwards}
                                if tp > 1 else {}),
                "all_gathers": ({"gather_from_tp": forwards}
                                if tp > 1 else {}),
                "gathers": {"lockstep": got["steps"],
                            **({"dp_fetch": got["host_syncs"]}
                               if G > 1 else {})},
                "fsdp_gathers": ({"layer": L * forwards,
                                  **dict.fromkeys(top, forwards)}
                                 if fs > 1 else {}),
                "fsdp_gathered_bytes": (priced["bfloat16"] * forwards
                                        if fs > 1 else 0)}
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
            check(all(len(t) == MESH_NEW_TOKENS
                      for t in got["tokens"].values()),
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
                    "all_reduces", "all_gathers", "fsdp_gathers",
                    "fsdp_gathered_bytes", "launches",
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
          "requests": len(prompts), "new_tokens": MESH_NEW_TOKENS,
          "wall_s": wall,
          "f32_first_decode_logits": {
              "max_abs_diff": sound, "fault_max_abs_diff": fault,
              "limit": MESH_LOGITS_TOL, "max_abs_logit": scale,
              "fault": ("layer 0's attention all-reduce dropped"
                        if tp > 1 else
                        "rank 1 concatenates layer 0's gathered shards in "
                        "the wrong order" if fs > 1 else
                        "rank 1 launches group 0's rows")},
          **({"fsdp_all_gather": {
              "f32_decode_step_bytes": [r["f32_decode_gathers"]["bytes"]
                                        for r in ranks],
              "cost_model_bytes": priced,
              "bf16_bytes_per_forward": [
                  r["bf16"]["fsdp_gathered_bytes"]
                  / (r["bf16"]["prefill_launches"]
                     + r["bf16"]["decode_launches"]) for r in ranks]}}
             if fs > 1 else {}),
          "resident_refusal": ranks[0].get("resident_refusal"),
          "ranks": per_rank})
    if tp > 1 or fs > 1:
        from distributed_training_tpu_torch.serving.engine import (
            FSDP_RESIDENT_NOTE,
            TP_RESIDENT_ITEM,
        )
        note = TP_RESIDENT_ITEM if tp > 1 else FSDP_RESIDENT_NOTE
        check(all(note in (r["resident_refusal"] or "") for r in ranks),
              f"serving_{name}: the resident burst over gloo was not "
              f"refused: {[r['resident_refusal'] for r in ranks]}")
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


def _plan_target():
    """phase plan's target, built in memory (no plan is committed)."""
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.parallel.planner import PlanTarget

    return PlanTarget(name="gpt2_125m_h100", devices=1,
                      model_kwargs=dict(PRESETS["gpt2_125m"],
                                        dtype="bfloat16"),
                      seq_len=1024, chip="nvidia h100 80gb hbm3")


def phase_audit() -> tuple:
    """The port's analysis gate on the card: the pitfall rules (DTT0xx)
    over the tree, and the ``single_chip_headline`` target (gpt2_125m,
    seq 1024, batch 4, bf16, remat ``mlp``) audited: one step of its
    Trainer on the card with its collectives recorded, which must give
    zero collectives and zero findings. The step runs B1 and B2 on the
    tensor cores, once a layer."""
    from distributed_training_tpu_torch.analysis import (
        audit,
        pitfalls,
        targets,
    )
    from distributed_training_tpu_torch.models.transformer import PRESETS

    t0 = time.perf_counter()
    problems = pitfalls.run_rules()
    rules_s = time.perf_counter() - t0
    _free_memory()
    _reset_counts()
    t0 = time.perf_counter()
    rec = audit.audit_target(targets.TARGETS["single_chip_headline"], "cuda")
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    launches, designs = _read_counts(), _read_designs()
    pins = audit.pinned_violations(audit.assemble_doc([rec]))
    emit({"phase": "audit", "rules": {"files": len(list(
              pitfalls.iter_py_files())), "violations": problems,
              "seconds": rules_s},
          "target": rec["target"], "mesh": rec["mesh"],
          "collectives": rec["collectives"], "findings": rec["findings"],
          "pin_violations": pins, "audit_s": audit_s,
          "launches": launches})
    check(problems == [], f"audit: rule violations {problems}")
    check(rec["collectives"]["total_collectives"] == 0
          and rec["collectives"]["bytes_per_step"] == 0
          and rec["findings"] == [] and pins == [],
          f"audit: single_chip_headline {rec}")
    L = PRESETS["gpt2_125m"]["n_layers"]
    check(launches["flash_fwd"] == launches["flash_bwd_fused"] == L,
          f"audit: the headline step launched {launches}")
    _check_designs({k: designs[k] for k in ("flash_fwd", "flash_bwd_fused")},
                   "wgmma", "audit")
    return launches, designs


def phase_calibrate(device: dict) -> None:
    """The calibration's matmul ladder on the card
    (``calibration/microbench.py::bench_matmul``: square f32 matmuls,
    TF32 off, 2n³ FLOPs a point, CUDA events over 10 back-to-back
    launches after one warm-up), beside the card's name and power
    limit. No collective curve: gloo between processes on one card
    measures the host."""
    from distributed_training_tpu_torch.calibration import microbench

    t0 = time.perf_counter()
    pts = microbench.bench_matmul(microbench.DEFAULT_MATMUL_SIZES, iters=10,
                                  device="cuda")
    ladder = [{"edge": n, "flops": f, "flops_per_s": r, "tflops": r / 1e12,
               "of_f32_peak": r / PEAK_FLOPS[torch.float32]}
              for n, (f, r) in zip(microbench.DEFAULT_MATMUL_SIZES, pts)]
    emit({"phase": "calibrate", "card": device["card"],
          "kind": device["kind"], "dtype": "float32", "tf32": False,
          "matmul": ladder, "seconds": time.perf_counter() - t0})
    check(all(p["flops"] == 2.0 * p["edge"] ** 3 and 0 < p["flops_per_s"]
              < PEAK_FLOPS[torch.float32] * 1.05 for p in ladder),
          f"calibrate: matmul ladder {ladder}")


def phase_plan(device: dict) -> tuple:
    """The planner's search on the card.

    1. ``python -m distributed_training_tpu_torch.parallel.planner
       --check`` in a subprocess: an OK line for each of PLAN_CLEAN and
       JAX's ranking-drift line, alone, for PLAN_DRIFTED (whose live
       ranking, re-derived here, keeps the committed keys, order and
       winner; its largest relative score gap is printed).
    2. ``plan_search`` on gpt2_125m at full width with the torch gate on
       ``cuda:0``: every candidate scored, the winner's gate (one step
       under its plan through the trainer and one unplanned, B1 and B2
       on the card) agreeing; the estimate's HBM and compute time beside
       the step's peak allocation and device time (CUDA events).
    3. Planted fault: the same search with a gate whose first planned
       run starts from another init seed must disqualify that candidate
       and settle on the next.

    Returns the launches and designs of step 2's gate."""
    from distributed_training_tpu_torch.parallel import planner

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_training_tpu_torch.parallel."
         "planner", "--check"], cwd=here, capture_output=True, text=True,
        timeout=300)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[planner] ")]
    drift = (f"[planner] {PLAN_DRIFTED}: stage-1 ranking changed (cost "
             "model or search space drift) — re-run planner --write")
    ok = {n for n in PLAN_CLEAN for ln in lines
          if ln.startswith(f"[planner] {n}: OK (")}
    check(ok == set(PLAN_CLEAN) and drift in lines and len(lines) == 6,
          f"plan: planner --check printed {lines} (rc {proc.returncode}, "
          f"stderr {proc.stderr[-2000:]})")
    committed = planner.load_plan(PLAN_DRIFTED)
    live = planner.rank_candidates(planner.PLAN_TARGETS[PLAN_DRIFTED])
    recorded = committed.provenance["ranking"]
    check([c.key for c, _s in live] == [r["candidate"] for r in recorded]
          and live[0][0].key == committed.candidate_key,
          f"plan: {PLAN_DRIFTED}'s live ranking moved keys or winner")
    gaps = [abs(s["score"] - r["score"]) / r["score"]
            for (_c, s), r in zip(live, recorded)]

    target = _plan_target()
    cands = planner.enumerate_candidates(target)
    ranked = planner.rank_candidates(target)
    _free_memory()
    _reset_counts()
    plan = planner.plan_search(
        target, lambda t, p: planner.compile_verify(t, p, device="cuda:0"))
    launches, designs = _read_counts(), _read_designs()
    rec = plan.provenance["score"]
    gate = plan.provenance["compile_evidence"]["gate"]
    check(len(cands) == 12 and len(ranked) == 12,
          f"plan: {len(cands)} candidates, {len(ranked)} feasible")
    check(plan.candidate_key == ranked[0][0].key == PLAN_WINNER,
          f"plan: winner {plan.candidate_key}, ranked first "
          f"{ranked[0][0].key}, expected {PLAN_WINNER}")
    check(gate["agree"] and plan.provenance["disqualified"] == [],
          f"plan: the winner's gate disagrees: {gate}")
    check(launches["flash_fwd"] > 0 and launches["flash_bwd_fused"] > 0,
          f"plan: the gate's steps launched {launches}")
    _check_designs({k: designs[k] for k in ("flash_fwd", "flash_bwd_fused")},
                   "wgmma", "plan")
    # Planted fault: the first candidate's planned run from another seed.
    calls: list = []

    def faulty(t, p):
        calls.append(p.candidate_key)
        return planner.compile_verify(
            t, p, device="cuda:0",
            planned_seed=planner.GATE_SEED + 1 if len(calls) == 1 else None)

    _free_memory()
    fplan = planner.plan_search(target, faulty)
    dq = fplan.provenance["disqualified"]
    check([d["candidate"] for d in dq] == [ranked[0][0].key]
          and fplan.candidate_key == ranked[1][0].key
          and fplan.provenance["rank"] == 1 and len(calls) == 2,
          f"plan: the planted fault's search chose {fplan.candidate_key} "
          f"after {calls}, disqualified {dq}")
    _free_memory()
    emit({"phase": "plan", "card": device["card"],
          "check": {"lines": lines, "rc": proc.returncode,
                    "drifted": PLAN_DRIFTED,
                    "drifted_scores": sum(g > 0 for g in gaps),
                    "max_rel_score_gap": max(gaps)},
          "target": target.name, "candidates": len(cands),
          "feasible": len(ranked), "winner": plan.candidate_key,
          "calibration": plan.provenance["calibration"]["source"],
          "hbm_gib_estimate": rec["hbm_gib"],
          "peak_allocated_gib": gate["planned"]["peak_bytes"] / 2**30,
          "compute_s_estimate": rec["compute_s"],
          "step_ms_planned": gate["planned"]["step_ms"],
          "step_ms_unplanned": gate["unplanned"]["step_ms"],
          "losses": [gate["planned"]["loss"], gate["unplanned"]["loss"]],
          "grad_norms": [gate["planned"]["grad_norm"],
                         gate["unplanned"]["grad_norm"]],
          "launches": launches, "launches_by_design": designs,
          "fault": {"disqualified": [d["candidate"] for d in dq],
                    "losses": [dq[0]["gate"]["planned"]["loss"],
                               dq[0]["gate"]["unplanned"]["loss"]],
                    "grad_norms": [dq[0]["gate"]["planned"]["grad_norm"],
                                   dq[0]["gate"]["unplanned"]["grad_norm"]],
                    "winner": fplan.candidate_key}})
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
    READINGS["train_median_step_s"] = step_s
    READINGS["train_first_loss"] = losses[0]
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
        check(cli.main(_train_overrides(out, TRAIN_SPLIT_STEPS, extra=(
            "train.save_every=0",))) == 0, "split train failed")
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
    """The run's event stream: process 0's (``host_0/`` in a world of
    several processes)."""
    path = os.path.join(out_dir, "default", "events.jsonl")
    if not os.path.exists(path):
        path = os.path.join(out_dir, "default", "host_0", "events.jsonl")
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


def _gpt2_trainer(rt, overrides: list, steps: int, total: int):
    """A Trainer on gpt2_125m / conf/train/gpt2.yaml over ``rt`` for the
    first ``steps`` of ``total`` steps of batch 8 (the data and the
    learning rates of ``total``), with ``overrides``, and its loader."""
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.train.trainer import Trainer

    batch = 8
    cfg = load_config(overrides=[
        "model=gpt2_125m", "train=gpt2", f"train.batch_size={batch}",
        f"train.dataset_size={total * batch}", f"train.total_steps={total}",
        "train.total_epochs=1", "train.log_every=0", *overrides])
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
        seed=cfg.train.seed, max_steps_per_epoch=steps)
    return Trainer(cfg, rt, model, loader), loader


def _tp2_trainer(rt, strategy: str, fault: bool = False):
    """A Trainer on gpt2_125m / conf/train/gpt2.yaml for TRAIN_TP2_STEPS
    steps of batch 8 under ``strategy`` over ``rt``, and its loader.
    ``fault``: the tp group's first ``reduce`` of each forward (layer 0's
    attention output) skips its all-reduce."""
    from distributed_training_tpu_torch.parallel.tensor import TPGroup

    trainer, loader = _gpt2_trainer(
        rt, [f"train.parallel_strategy={strategy}"], TRAIN_TP2_STEPS,
        TRAIN_TP2_STEPS)
    model = trainer.model
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
    gradient norms, step wall times and the step's host seconds in its
    synchronisation (``sync_s``)."""
    out = {"losses": [], "grad_norms": [], "step_s": [], "sync_s": []}
    for batch in loader.epoch(0):
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["sync_s"].append(trainer._step_fn.sync_s)
        if "moe_aux" in m:
            out.setdefault("moe_aux", []).append(float(m["moe_aux"]))
    return out


@contextlib.contextmanager
def _event_sink(path: str, rank: int):
    """An event sink writing ``path``, installed for the block: the
    trainer emits its ``collectives`` event only while a sink records
    (and only on the coordinator). Yields the sink."""
    from distributed_training_tpu_torch.telemetry import events

    tel = events.install(events.Telemetry(path, host_id=rank))
    try:
        yield tel
    finally:
        tel.close()
        events.uninstall()


def _collectives_events(path: str) -> list:
    """The ``collectives`` events of the stream at ``path``."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("kind") == "collectives"]


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
            # The sound run records its events: the collectives audit.
            events = f"{out_path}.events.jsonl"
            with (_event_sink(events, rank) if run == "sound"
                  else contextlib.nullcontext()):
                trainer, loader = _tp2_trainer(rt, "tp",
                                               fault=run == "fault")
                _free_memory()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                tp_lib.ALL_REDUCES.clear()
                result[run] = {
                    **_tp2_steps(trainer, loader),
                    "all_reduces": dict(tp_lib.ALL_REDUCES),
                    "launches": _read_counts(),
                    "launches_by_design": _read_designs(),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            if run == "sound":
                result[run]["collectives"] = _collectives_events(events)
                result[run]["tp_split_leaves"] = sum(
                    1 for pl in trainer.layout["params"].values()
                    if pl is not None and "tp" in pl.axes)
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
    _check_tp2_collectives(ranks, want_reduces, steps)
    # Both ranks' launches are the card's.
    launches = {k: sum(r["launches"][k] for r in per_rank)
                for k in per_rank[0]["launches"]}
    designs = {k: {d: sum(r["launches_by_design"][k][d] for r in per_rank)
                   for d in per_rank[0]["launches_by_design"][k]}
               for k in per_rank[0]["launches_by_design"]}
    return launches, designs


def _check_tp2_collectives(ranks: list, want_reduces: dict,
                           steps: int) -> None:
    """train_tp2's ``collectives`` event (the first step's, emitted by
    rank 0 alone) against the counts the phase holds: every collective
    an all-reduce over tp, the tp all-reduces of one step (``ALL_REDUCES``
    over the steps) and the gradient norm's one all-reduce of the
    tp-split leaves' partial sums (f32, one per leaf)."""
    events = [r["sound"]["collectives"] for r in ranks]
    check([len(e) for e in events] == [1, 0],
          f"train_tp2: collectives events per rank {[len(e) for e in events]}")
    ev = events[0][0]
    per_step = sum(want_reduces.values()) // steps
    split = ranks[0]["sound"]["tp_split_leaves"]
    norm = [r for r in ev["rows"] if r["shape"] == str(split)
            and r["dtype"] == "f32"]
    emit({"phase": "train_tp2_collectives",
          **{k: ev[k] for k in ("total_collectives", "bytes_per_step",
                                "by_kind", "by_axis", "mesh",
                                "spmd_reshard_warnings")},
          "all_reduces_per_step": per_step, "tp_split_leaves": split})
    check(ev["mesh"] == {"tp": 2} and set(ev["by_axis"]) == {"tp"}
          and set(ev["by_kind"]) == {"all-reduce"},
          f"train_tp2: collectives event {ev['by_kind']} {ev['by_axis']}")
    check(ev["by_kind"]["all-reduce"]["count"] == per_step + 1
          and len(norm) == 1 and norm[0]["bytes"] == 4 * split,
          f"train_tp2: {ev['by_kind']} against {per_step} tp all-reduces "
          f"and one norm all-reduce of {split} leaves")


def _sp_trainer(rt, impl: str, steps: int, window: int = 0):
    """A Trainer on gpt2_125m / conf/train/gpt2.yaml for the first
    ``steps`` of TRAIN_SP2_STEPS steps of batch 8 (every run sees the
    same batches and learning rates) under ``ddp`` over ``rt`` with
    ``attention_impl=impl`` (and ``attention_window=window``), and its
    loader."""
    return _gpt2_trainer(rt, [
        "train.parallel_strategy=ddp", f"+model.attention_impl={impl}",
        f"+model.attention_window={window}"], steps, TRAIN_SP2_STEPS)


def _sp_runs(impl: str, window: int) -> list:
    """(name, steps, fault) of one train_sp2 phase's runs in each
    process."""
    if window:
        return [("sound", SP2_WINDOW_STEPS, False)]
    runs = [("sound", TRAIN_SP2_STEPS, False)]
    if impl == "ring":
        runs.append(("rerun", SP2_HELD_STEPS, False))
    return runs + [("fault", SP2_HELD_STEPS, True)]


def train_sp2_rank(rank: int, port: int, out_path: str, impl: str,
                   window: int) -> int:
    """One of a train_sp2 phase's two processes: on ``cuda:0``, in a
    gloo group of 2 over ``127.0.0.1:port``, a runtime over the mesh sp
    2 built here (the CLI's runtime would ask for NCCL on a card), each
    run of ``_sp_runs``; writes its readings to ``out_path``. The fault
    run leaves each process's gradients unsummed over sp."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.parallel import fsdp
    from distributed_training_tpu_torch.parallel.ring_attention import (
        EXCHANGES,
    )
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    replica_axes = fsdp.replica_axes
    try:
        rt = slice_runtime([MeshSpec(sp=2)], torch.device("cuda", 0))
        result = {"rank": rank, "describe": rt.describe()}
        for run, steps, fault in _sp_runs(impl, window):
            trainer, loader = _sp_trainer(rt, impl, steps, window)
            _free_memory()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            EXCHANGES.clear()
            if fault:
                fsdp.replica_axes = (lambda pl: tuple(
                    a for a in replica_axes(pl) if a != "sp"))
            try:
                got = _tp2_steps(trainer, loader)
            finally:
                fsdp.replica_axes = replica_axes
            result[run] = {**got, "exchanges": dict(EXCHANGES),
                           "launches": _read_counts(),
                           "launches_by_design": _read_designs(),
                           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            del trainer, loader
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def phase_train_sp2(tmp: str, impl: str, window: int = 0) -> tuple:
    """gpt2_125m at full width under sequence parallelism at sp 2 on the
    one card (``attention_impl=impl``; ring or Ulysses): two processes
    on ``cuda:0`` in a gloo group, each holding 512 of every row's 1024
    positions, against the same batches in this process at world 1 with
    the single-process flash attention. The ring's blocks run B1 (the
    diagonal causal, the past block non-causal, f32 out) and the split
    backward B3a/B3b; Ulysses' local attention runs B1 and the fused B2
    on each process's 6 of the 12 heads over all 1024 positions. Step
    times are gloo's, every exchange and the gradient sum staged through
    the host: a correctness reading."""
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.runtime import Runtime

    name = f"train_sp2_{impl}" + ("_window" if window else "")
    runs = {r: (steps, fault) for r, steps, fault in _sp_runs(impl, window)}
    steps = runs["sound"][0]
    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    trainer, loader = _sp_trainer(Runtime(device=torch.device("cuda", 0)),
                                  "auto", steps, window)
    want = _tp2_steps(trainer, loader)
    want_peak = torch.cuda.max_memory_allocated()
    del trainer, loader
    _free_memory()
    port = _free_port()
    outs = [os.path.join(tmp, f"{name}.rank{r}.json") for r in range(2)]
    logs = [open(os.path.join(tmp, f"{name}.rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-sp2-rank",
         str(r), str(port), outs[r], impl, str(window)], stdout=logs[r],
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
                print(f"{name} rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"{name}: ranks exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    held = min(SP2_HELD_STEPS, steps)
    readings = {}
    for run in runs:
        if run == "rerun":
            continue
        got = ranks[0][run]
        check(len(got["losses"]) == runs[run][0],
              f"{name} {run}: {got['losses']}")
        readings[run] = {
            "loss_rel_diff": _rel_diffs(got["losses"][:held],
                                        want["losses"][:held]),
            "grad_norm_rel_diff": _rel_diffs(got["grad_norms"][:held],
                                             want["grad_norms"][:held])}
        readings[run]["within"] = (
            readings[run]["loss_rel_diff"] <= SP_LOSS_RTOL
            and readings[run]["grad_norm_rel_diff"] <= SP_GRAD_NORM_RTOL)
    L = PRESETS["gpt2_125m"]["n_layers"]
    per_rank = []
    for r in ranks:
        sound = r["sound"]
        per_rank.append({
            "rank": r["rank"], "describe": r["describe"],
            "losses": sound["losses"], "grad_norms": sound["grad_norms"],
            "median_step_s": float(np.median(sound["step_s"][1:])),
            "step_s": sound["step_s"],
            "median_sync_s": float(np.median(sound["sync_s"][1:])),
            "peak_mem_bytes": sound["peak_mem_bytes"],
            "exchanges_per_step": {k: v / steps for k, v in
                                   sound["exchanges"].items()},
            "launches": sound["launches"],
            "launches_by_design": sound["launches_by_design"],
            **({"rerun_losses": r["rerun"]["losses"],
                "rerun_grad_norms": r["rerun"]["grad_norms"]}
               if "rerun" in r else {}),
            **({"fault_losses": r["fault"]["losses"],
                "fault_grad_norms": r["fault"]["grad_norms"]}
               if "fault" in r else {})})
    median_s = max(p["median_step_s"] for p in per_rank)
    emit({"phase": name, "model": "gpt2_125m", "strategy": "ddp",
          "attention_impl": impl, "window": window, "mesh": {"sp": 2},
          "backend": "gloo", "processes_on_card": 2, "batch": 8,
          "seq": 1024, "steps": steps, "held_steps": held, "wall_s": wall,
          "world1_losses": want["losses"],
          "world1_grad_norms": want["grad_norms"],
          "world1_median_step_s": float(np.median(want["step_s"][1:])),
          "world1_peak_mem_bytes": want_peak,
          "median_step_s": median_s,
          # Both processes share the one card and the host (gloo).
          "tokens_per_s_two_processes_one_card_gloo": 8 * 1024 / median_s,
          "loss_rtol": SP_LOSS_RTOL, "grad_norm_rtol": SP_GRAD_NORM_RTOL,
          "fault": ("each process's gradients left unsummed over sp"
                    if "fault" in runs else None),
          "readings": readings, "ranks": per_rank})
    sound0 = per_rank[0]
    for r in per_rank:
        check(all(math.isfinite(x) for x in r["losses"]),
              f"{name}: non-finite {r['losses']}")
        check(r["losses"] == sound0["losses"]
              and r["grad_norms"] == sound0["grad_norms"],
              f"{name}: the two processes report different metrics")
        check(r["exchanges_per_step"].get("staged_bytes", 0) > 0,
              f"{name}: rank {r['rank']} staged no exchange")
        if "rerun_losses" in r:
            n = len(r["rerun_losses"])
            check(r["rerun_losses"] == r["losses"][:n]
                  and r["rerun_grad_norms"] == r["grad_norms"][:n],
                  f"{name}: the rerun's bits differ: {r['rerun_losses']} "
                  f"vs {r['losses'][:n]}")
    # Both processes' launches are the card's: per step the ring runs
    # 3L forward blocks (process 0 its diagonal, process 1 its diagonal
    # and its past block) and as many of each split backward kernel, or
    # 2L under the window (process 1's past block on the plain path);
    # Ulysses runs one B1 and one B2 a layer on each process.
    launches = {k: sum(r["launches"][k] for r in per_rank)
                for k in sound0["launches"]}
    designs = {k: {d: sum(r["launches_by_design"][k][d] for r in per_rank)
                   for d in sound0["launches_by_design"][k]}
               for k in sound0["launches_by_design"]}
    blocks = (2 if window else 3) * L * steps
    want_launches = ({"flash_fwd": blocks, "flash_bwd_dq": blocks,
                      "flash_bwd_dkv": blocks, "flash_bwd_fused": 0}
                     if impl == "ring" else
                     {"flash_fwd": 2 * L * steps, "flash_bwd_fused": 2 * L * steps,
                      "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    for k, n in want_launches.items():
        check(launches[k] == designs[k]["wgmma"] == n,
              f"{name}: {k} launches {designs[k]}, want {n} on wgmma")
    check(readings["sound"]["within"],
          f"{name}: sp 2 against world 1 outside the limits: {readings}")
    if "fault" in readings:
        check(not readings["fault"]["within"],
              f"{name}: the planted fault passed the limits: {readings}")
    return launches, designs


def _pp_trainer(rt, schedule: str, steps: int):
    """A Trainer on gpt2_125m / conf/train/gpt2.yaml for the first
    ``steps`` of TRAIN_PP2_STEPS steps of batch 8 under ``ddp`` over
    ``rt``, pipelined by ``schedule`` over the runtime's pp (a world of
    one ignores the pp fields), and its loader."""
    return _gpt2_trainer(rt, [
        "train.parallel_strategy=ddp",
        f"+model.pp_microbatches={PP2_MICROBATCHES}",
        f"+model.pp_schedule={schedule}",
        f"+model.pp_virtual_stages={PP2_VIRTUAL_STAGES}"], steps,
        TRAIN_PP2_STEPS)


# (name, steps, split backward, planted fault) of one train_pp2 phase's
# runs in each process.
PP2_RUNS = (("sound", TRAIN_PP2_STEPS, False, False),
            ("fault", PP2_HELD_STEPS, False, True),
            ("split_a", PP2_HELD_STEPS, True, False),
            ("split_b", PP2_HELD_STEPS, True, False))


def train_pp2_rank(rank: int, port: int, out_path: str,
                   schedule: str) -> int:
    """One of a train_pp2 phase's two processes: on ``cuda:0``, in a
    gloo group of 2 over ``127.0.0.1:port``, a runtime over the mesh pp
    2 built here (the CLI's runtime would ask for NCCL on a card), each
    run of PP2_RUNS; writes its readings to ``out_path``. The fault run
    leaves each stage's part of the tied embedding's gradient unsummed
    over pp."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.parallel import fsdp
    from distributed_training_tpu_torch.parallel import pipeline
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    average_grads = fsdp.average_grads

    def embedding_unsummed(grads, placements, runtime, tp_partial=()):
        own = grads["tok_embed"].clone()
        average_grads(grads, placements, runtime, tp_partial)
        grads["tok_embed"].copy_(own / runtime.data_shard_count)
        return grads

    try:
        rt = slice_runtime([MeshSpec(pp=2)], torch.device("cuda", 0))
        result = {"rank": rank, "describe": rt.describe()}
        for run, steps, split, fault in PP2_RUNS:
            trainer, loader = _pp_trainer(rt, schedule, steps)
            _free_memory()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            pipeline.EXCHANGES.clear()
            fa.FORCE_SPLIT_BWD = split
            if fault:
                fsdp.average_grads = embedding_unsummed
            try:
                got = _tp2_steps(trainer, loader)
            finally:
                fsdp.average_grads = average_grads
                fa.FORCE_SPLIT_BWD = False
            result[run] = {**got, "exchanges": dict(pipeline.EXCHANGES),
                           "launches": _read_counts(),
                           "launches_by_design": _read_designs(),
                           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            del trainer, loader
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def phase_train_pp2(tmp: str, schedule: str, want: dict) -> tuple:
    """gpt2_125m at full width under pipeline parallelism at pp 2 on the
    one card (``pp_schedule=schedule``): two processes on ``cuda:0`` in
    a gloo group, stage 0 embedding the batch and the last stage holding
    the final norm, the head and the loss, PP2_MICROBATCHES microbatches
    of 2 rows, against ``want`` (world 1 on the same batches,
    ``_pp_world1``). Each stage's attention runs B1 twice a layer and
    microbatch (the forward and the backward's recompute) and B2, or
    under the split backward B3a/B3b, at B 2, H 12, S 1024. Step times
    are gloo's, the activations, their gradients and the gradient sum
    staged through the host: a correctness reading."""
    from distributed_training_tpu_torch.models.transformer import PRESETS
    from distributed_training_tpu_torch.parallel.pipeline import (
        schedule_stats,
    )

    name = f"train_pp2_{schedule}"
    port = _free_port()
    outs = [os.path.join(tmp, f"{name}.rank{r}.json") for r in range(2)]
    logs = [open(os.path.join(tmp, f"{name}.rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-pp2-rank",
         str(r), str(port), outs[r], schedule], stdout=logs[r],
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
                print(f"{name} rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"{name}: ranks exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    held = PP2_HELD_STEPS
    readings = {}
    for run in ("sound", "fault"):
        got = ranks[0][run]
        readings[run] = {
            "loss_rel_diff": _rel_diffs(got["losses"][:held],
                                        want["losses"][:held]),
            "grad_norm_rel_diff": _rel_diffs(got["grad_norms"][:held],
                                             want["grad_norms"][:held])}
        readings[run]["within"] = (
            readings[run]["loss_rel_diff"] <= PP_LOSS_RTOL
            and readings[run]["grad_norm_rel_diff"] <= PP_GRAD_NORM_RTOL)
    L = PRESETS["gpt2_125m"]["n_layers"]
    M, steps = PP2_MICROBATCHES, TRAIN_PP2_STEPS
    per_rank = []
    for r in ranks:
        sound = r["sound"]
        per_rank.append({
            "rank": r["rank"], "describe": r["describe"],
            "losses": sound["losses"], "grad_norms": sound["grad_norms"],
            "median_step_s": float(np.median(sound["step_s"][1:])),
            "step_s": sound["step_s"],
            "median_sync_s": float(np.median(sound["sync_s"][1:])),
            "peak_mem_bytes": sound["peak_mem_bytes"],
            "peak_mem_of_world1": sound["peak_mem_bytes"] / want["peak"],
            "exchanges_per_step": {k: v / steps for k, v in
                                   sound["exchanges"].items()},
            "launches": sound["launches"],
            "launches_by_design": sound["launches_by_design"],
            "split_launches": {k: r["split_a"]["launches"][k]
                               + r["split_b"]["launches"][k]
                               for k in sound["launches"]},
            "split_losses": [r["split_a"]["losses"], r["split_b"]["losses"]],
            "split_grad_norms": [r["split_a"]["grad_norms"],
                                 r["split_b"]["grad_norms"]],
            "fault_losses": r["fault"]["losses"],
            "fault_grad_norms": r["fault"]["grad_norms"]})
    median_s = max(p["median_step_s"] for p in per_rank)
    stats = schedule_stats(2, M, schedule, PP2_VIRTUAL_STAGES)
    emit({"phase": name, "model": "gpt2_125m", "strategy": "ddp",
          "schedule": schedule, "mesh": {"pp": 2}, "microbatches": M,
          "virtual_stages": PP2_VIRTUAL_STAGES, "backend": "gloo",
          "processes_on_card": 2, "batch": 8, "seq": 1024, "steps": steps,
          "held_steps": held, "wall_s": wall,
          "schedule_stats": stats,
          "world1_losses": want["losses"],
          "world1_grad_norms": want["grad_norms"],
          "world1_median_step_s": want["median_step_s"],
          "world1_peak_mem_bytes": want["peak"],
          "median_step_s": median_s,
          # Both processes share the one card and the host (gloo).
          "tokens_per_s_two_processes_one_card_gloo": 8 * 1024 / median_s,
          "loss_rtol": PP_LOSS_RTOL, "grad_norm_rtol": PP_GRAD_NORM_RTOL,
          "fault": "the tied embedding's gradient left unsummed over pp",
          "readings": readings, "ranks": per_rank})
    sound0 = per_rank[0]
    for r in per_rank:
        check(all(math.isfinite(x) for x in r["losses"]),
              f"{name}: non-finite {r['losses']}")
        check(r["losses"] == sound0["losses"]
              and r["grad_norms"] == sound0["grad_norms"],
              f"{name}: the two stages report different metrics")
        check(r["exchanges_per_step"].get("staged_bytes", 0) > 0,
              f"{name}: rank {r['rank']} staged no exchange")
        check(r["split_losses"][0] == r["split_losses"][1]
              and r["split_grad_norms"][0] == r["split_grad_norms"][1],
              f"{name}: the split reruns' bits differ: {r['split_losses']}")
    # Both processes' launches are the card's: per step each stage runs
    # B1 twice per layer and microbatch (forward, recompute) over its 6
    # layers, and one backward per layer and microbatch.
    runs = [(run["launches"], run["launches_by_design"]) for rk in ranks
            for run in (rk["sound"], rk["split_a"], rk["split_b"])]
    launches = {k: sum(c[k] for c, _ in runs) for k in runs[0][0]}
    designs = {k: {d: sum(ds[k][d] for _, ds in runs)
                   for d in runs[0][1][k]} for k in runs[0][1]}
    split_steps = 2 * PP2_HELD_STEPS
    want_launches = {"flash_fwd": 2 * L * M * (steps + split_steps),
                     "flash_bwd_fused": L * M * steps,
                     "flash_bwd_dq": L * M * split_steps,
                     "flash_bwd_dkv": L * M * split_steps}
    for k, n in want_launches.items():
        check(launches[k] == designs[k]["wgmma"] == n,
              f"{name}: {k} launches {designs[k]}, want {n} on wgmma")
    check(readings["sound"]["within"],
          f"{name}: pp 2 against world 1 outside the limits: {readings}")
    check(not readings["fault"]["within"],
          f"{name}: the planted fault passed the limits: {readings}")
    return launches, designs


def _pp_world1() -> dict:
    """The train_pp2 phases' reference: TRAIN_PP2_STEPS steps at world 1
    in this process on their batches, with its median step and peak
    memory."""
    from distributed_training_tpu_torch.runtime import Runtime

    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    trainer, loader = _pp_trainer(Runtime(device=torch.device("cuda", 0)),
                                  "gpipe", TRAIN_PP2_STEPS)
    want = _tp2_steps(trainer, loader)
    want["peak"] = torch.cuda.max_memory_allocated()
    want["median_step_s"] = float(np.median(want["step_s"][1:]))
    del trainer, loader
    _free_memory()
    return want


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


def _state_digests(state: dict) -> dict:
    """The sha256 of every tensor of a train state's params and moments
    (with its dtype and shape), by path; plain values by repr."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, torch.Tensor):
            c = t.detach().cpu().contiguous().reshape(-1)
            out[path] = (f"{c.dtype}{tuple(t.shape)}:" + hashlib.sha256(
                c.view(torch.uint8).numpy().tobytes()).hexdigest())
        else:
            out[path] = repr(t)

    walk({k: state[k] for k in ("params", "opt_state")}, "")
    return out


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
    check(files == ["layout.json", "manifest.dtt.json", "meta.json",
                    "state.rank0.pt"],
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


# -- the default config and the real-text path -----------------------------


def _repo() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def _run_module(args: list, timeout: float = 900) -> str:
    """``python -m <args>`` from the repository root (on the card unless
    the arguments say otherwise); its standard output. A nonzero exit
    fails the phase with the tail of both streams."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=_repo(),
                          env=dict(os.environ, PYTHONPATH=_repo()),
                          capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"python -m {' '.join(args[:3])} exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def _last_json(text: str) -> dict:
    return json.loads([line for line in text.splitlines()
                       if line.startswith("{")][-1])


def _subprocess_launches(report: dict) -> tuple:
    """A CLI's ``kernel_launches`` as (counts, by design), the shape of
    ``_read_counts``/``_read_designs``."""
    return ({k: v["launches"] for k, v in report.items()},
            {k: dict(v["by_design"]) for k, v in report.items()})


def _best_s(fn, runs: int = 3) -> tuple:
    """(result, fastest wall seconds of ``runs`` calls)."""
    best, out = float("inf"), None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def phase_native() -> None:
    """The C++ gather and fill (``native/dtt_native.cpp``, built with g++
    at first use) against NumPy's, byte for byte: a gather of every row of
    a NATIVE_ROWS-row int32 source in a random order, and a NATIVE_FILL-
    token SplitMix64 fill. Host times, the fastest of three."""
    from distributed_training_tpu_torch import native

    t0 = time.perf_counter()
    check(native.available(), "native: the C++ library did not build")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    src = rng.integers(0, 2 ** 31 - 1, (NATIVE_ROWS, 16), dtype=np.int32)
    idx = rng.permutation(NATIVE_ROWS)
    got, gather_s = _best_s(lambda: native.gather_rows(src, idx))
    want, gather_np_s = _best_s(lambda: src[idx])
    check(got.tobytes() == want.tobytes(), "native gather != NumPy")
    fill, fill_s = _best_s(lambda: native.fill_tokens(SEED, 50304,
                                                      NATIVE_FILL))
    ref, fill_np_s = _best_s(lambda: native._fill_tokens_numpy(
        SEED, 50304, NATIVE_FILL))
    check(fill.tobytes() == ref.tobytes(), "native fill != NumPy")
    emit({"phase": "native", "available": True, "build_or_load_s": build_s,
          "gather_rows": NATIVE_ROWS, "row_bytes": 64,
          "gather_s": gather_s, "gather_numpy_s": gather_np_s,
          "fill_tokens": NATIVE_FILL, "fill_s": fill_s,
          "fill_numpy_s": fill_np_s, "equal_bytes": True,
          "host_cpus": os.cpu_count()})


def _runtime_event(out_dir: str) -> dict:
    rt = [e for e in _events(out_dir) if e["kind"] == "runtime"]
    check(bool(rt), f"no runtime event under {out_dir}")
    return rt[-1]


def phase_train_mlp(tmp: str) -> None:
    """The trainer CLI with no model or data override (conf/config.yaml:
    the MLP Linear(20, 1) on ``synthetic``, SGD, ``ddp``) on the card for
    2 epochs of 64 steps, then a rerun to 3 epochs that resumes from the
    epoch-0 checkpoint (``save_every`` 2)."""
    out = os.path.join(tmp, "mlp")
    argv = ["distributed_training_tpu_torch.train", "run.log_level=WARNING",
            f"run.output_dir={out}",
            f"train.snapshot_path={out}/checkpoints"]
    t0 = time.perf_counter()
    _run_module(argv + ["train.total_epochs=2"])
    wall = time.perf_counter() - t0
    rows = _metrics_rows(out)
    check({r["epoch"] for r in rows} == {0, 1}, f"mlp rows {rows}")
    check(all(math.isfinite(r["loss"]) for r in rows),
          f"mlp: non-finite loss {rows}")
    rt = _runtime_event(out)
    check(rt["device"].startswith("cuda"), f"mlp ran on {rt['device']}")
    steps = sorted(int(d) for d in os.listdir(os.path.join(
        out, "checkpoints")) if d.isdigit())
    check(steps == [64], f"mlp checkpoints {steps}")
    first_steps = steps
    _run_module(argv + ["train.total_epochs=3"])
    resumed = [e for e in _events(out) if e["kind"] == "resume"]
    check([e["step"] for e in resumed] == [64], f"mlp resume {resumed}")
    rows2 = _metrics_rows(out)
    steps = sorted(int(d) for d in os.listdir(os.path.join(
        out, "checkpoints")) if d.isdigit())
    check(steps == [64, 192] and rows2[-1]["step"] == 190
          and all(math.isfinite(r["loss"]) for r in rows2),
          f"mlp rerun: checkpoints {steps}, rows {rows2[-3:]}")
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows
                              if "steps_per_sec" in r]))
    emit({"phase": "train_mlp", "config": "config.yaml (model default, "
          "train default)", "steps": 128, "wall_s": wall,
          "median_step_s": step_s,
          "samples_per_s": 32 / step_s, "first_loss": rows[0]["loss"],
          "last_loss": rows[-1]["loss"], "checkpoints": first_steps,
          "resumed_at": 64, "rerun_checkpoints": steps,
          "device": rt["device"]})


def _byte_corpus(tmp: str) -> str:
    """The repository's own text as a byte corpus (data/prepare.py)."""
    corpus = os.path.join(tmp, "bytes", "corpus.bin")
    repo = _repo()
    meta = _last_json(_run_module([
        "distributed_training_tpu_torch.data.prepare", "--out", corpus,
        os.path.join(repo, "README.md"), os.path.join(repo, "SURVEY.md"),
        os.path.join(repo, "distributed_training_tpu", "**", "*.py"),
        os.path.join(repo, "distributed_training_tpu_torch", "**",
                     "*.py")]))
    check(meta["n_tokens"] > 1_000_000 and meta["vocab_size"] == 256,
          f"corpus {meta}")
    emit({"phase": "prepare", **meta})
    return corpus


def _generate(src: list, decode: str, prompt: str,
              here: bool = False) -> dict:
    """generate.py's ``--json`` report: in a process of its own, or
    (``here``) through its ``main`` in this one, the launch counters
    from 0 (a process start saved, for the f32 checks' runs)."""
    args = [*src, "--prompt", prompt, "-n", str(GEN_TOKENS), "--decode",
            decode, "--json"]
    if not here:
        return _last_json(_run_module(
            ["distributed_training_tpu_torch.generate", *args]))
    from distributed_training_tpu_torch import generate as gen

    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(gen.main(args) == 0, f"generate {args[:4]} failed")
    _free_memory()
    return _last_json(out.getvalue())


def _bf16_decode_logits(run_dir: str, prompt: str) -> dict:
    """generate.py's two bf16 greedy decodes of ``prompt`` rerun in this
    process, each keeping the f32 logits it took every token from, and
    the f32 model's forward over the prompt and the fused tokens (teacher
    forcing). Up to the first token where the decodes part, both read the
    same prefix: over those decode steps, each decode's largest logit
    error against f32, and the paged decode's against the fused. The
    paged decode's error must stay within DECODE_LOGITS_RATIO of the
    fused decode's: bf16 rounding, not a fault of its attention. At the
    first difference, how close a call it was: the fused decode's top-2
    gap, and each path's and f32's margin between the two tokens."""
    from distributed_training_tpu_torch import generate as gen
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.serving import engine as em

    dev = torch.device("cuda:0")
    cfg = gen._load_run_config(run_dir)
    params, _ = gen._restore_params(run_dir, cfg.train.snapshot_path, None,
                                    dev)
    model = gen._build_model_from_cfg(cfg, dev)
    ids = np.frombuffer(prompt.encode(), np.uint8).astype(np.int32)
    kept = {"fused": [], "paged": []}
    head = model._lm_head

    def fused_head(p, x):
        out = head(p, x)
        kept["fused"].append(out[0].cpu())
        return out

    model._lm_head = fused_head
    fused = model.generate(params, ids[None], GEN_TOKENS)[0].tolist()
    del model._lm_head
    eng = gen._paged_engine(model, params, ids.size + GEN_TOKENS, dev)
    logits_fn, decode, armed = em._logits, eng._decode, []

    def logits(*args, **kw):
        out = logits_fn(*args, **kw)
        if armed:
            armed.pop()
            kept["paged"].append(out[0].cpu())
        return out

    def paged_decode(*args, **kw):
        armed.append(True)
        return decode(*args, **kw)

    em._logits, eng._decode = logits, paged_decode
    try:
        paged = [int(t) for t in eng.generate(ids, GEN_TOKENS)]
    finally:
        em._logits, eng._decode = logits_fn, decode
    kwargs = dict(cfg.model.kwargs)
    kwargs.pop("dtype", None)
    ref_model = build_model(cfg.model.name, loss=cfg.train.loss,
                            dtype="float32", device=dev, **kwargs)
    seq = np.concatenate([ids, np.asarray(fused[:-1], np.int32)])
    # Row i: the logits token i is taken from.
    ref = ref_model.apply(params, seq[None])[0][0, ids.size - 1:].cpu()
    fl = torch.stack(kept["fused"])
    pl = torch.stack(kept["paged"])
    check(fl.shape[0] == GEN_TOKENS and pl.shape[0] == GEN_TOKENS - 1,
          f"kept logits {fl.shape} {pl.shape}")
    first = next((i for i, (a, b) in enumerate(zip(fused, paged))
                  if a != b), None)
    # Tokens 1.. come from decode steps (token 0 from the prefill): the
    # paged decode's step i - 1 gave token i.
    steps = range(1, GEN_TOKENS if first is None else first + 1)

    def worst(rows):
        return max(((a - b).abs().max().item() for a, b in rows),
                   default=None)

    err_fused = worst((fl[i], ref[i]) for i in steps)
    err_paged = worst((pl[i - 1], ref[i]) for i in steps)
    out = {"fused_tokens": fused, "paged_tokens": paged,
           "first_difference": first, "decode_steps_compared": len(steps),
           "fused_vs_f32_max_abs": err_fused,
           "paged_vs_f32_max_abs": err_paged,
           "paged_vs_fused_max_abs": worst((pl[i - 1], fl[i])
                                           for i in steps),
           "logit_scale": fl.abs().max().item()}
    if steps:
        check(err_paged <= DECODE_LOGITS_RATIO * err_fused,
              f"generate bf16: the paged decode's logits err {err_paged} "
              f"against f32, more than {DECODE_LOGITS_RATIO} x the fused "
              f"decode's {err_fused}")
    if first is not None:
        a, b = fused[first], paged[first]
        top2 = torch.topk(fl[first], 2).values
        out["at_first_difference"] = {
            "fused_token": a, "paged_token": b,
            "fused_top2_gap": (top2[0] - top2[1]).item(),
            "fused_margin": (fl[first][a] - fl[first][b]).item(),
            "paged_margin": (pl[first - 1][b] - pl[first - 1][a]).item()
            if first else None,
            "f32_margin": (ref[first][a] - ref[first][b]).item()}
    return out


def phase_train_bytes_lm(tmp: str, corpus: str) -> dict:
    """The real-text path at the config's full width (conf/model/
    byte_lm.yaml: vocab 256, d 512, 8 layers of 8 heads, seq 512; conf/
    train/bytes_lm.yaml: batch 16, bf16, AdamW) on the repository's own
    text: BYTES_STEPS_PER_EPOCH steps in each of 2 epochs with the
    held-out split (5%) scored after each, then ``eval.py`` on the run,
    then ``generate.py`` with both decodes, bf16 from the run and f32
    from its consolidated artifact."""
    from distributed_training_tpu_torch.data import (
        build_dataset,
        train_eval_split,
    )
    from distributed_training_tpu_torch.train import cli

    _free_memory()
    out = os.path.join(tmp, "bytes_lm")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    check(cli.main([
        "train=bytes_lm", "model=byte_lm",
        f"train.dataset_kwargs.path={corpus}",
        f"train.max_steps_per_epoch={BYTES_STEPS_PER_EPOCH}",
        "train.total_epochs=2", "train.warmup_steps=10",
        "train.eval_fraction=0.05", "train.eval_every=1",
        "train.log_every=1", "run.log_level=WARNING",
        f"run.output_dir={out}",
        f"train.snapshot_path={out}/checkpoints"]) == 0,
        "bytes_lm training failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = (_read_counts(), _read_designs())
    with open(os.path.join(out, "default", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r for r in rows if "loss" in r]
    vals = [r["val_loss"] for r in rows if "val_loss" in r]
    steps = 2 * BYTES_STEPS_PER_EPOCH
    check(len(losses) == steps and len(vals) == 2
          and all(math.isfinite(x) for x in vals)
          and all(math.isfinite(r["loss"]) for r in losses),
          f"bytes_lm rows: {len(losses)} losses, val {vals}")
    _, held = train_eval_split(build_dataset("bytes", path=corpus,
                                             seq_len=512), 0.05, seed=42,
                               multiple_of=16)
    eval_batches = len(held) // 16
    n_layers = 8
    _check_designs({n: train[1][n] for n in ("flash_fwd",
                                             "flash_bwd_fused")},
                   "wgmma", "bytes_lm (bf16, head dim 64)")
    check(train[0]["flash_fwd"] == n_layers * (steps + 2 * eval_batches)
          and train[0]["flash_bwd_fused"] == n_layers * steps
          and train[0]["flash_bwd_dq"] == train[0]["flash_bwd_dkv"] == 0,
          f"bytes_lm launches {train[0]} (eval batches {eval_batches})")
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in losses[3:]
                              if "steps_per_sec" in r]))
    emit({"phase": "train_bytes_lm", "model": "byte_lm", "batch": 16,
          "seq": 512, "steps": steps, "eval_batches": eval_batches,
          "wall_s": wall, "median_step_s": step_s,
          "tokens_per_s": 16 * 512 / step_s,
          "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
          "val_loss": vals, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": train[0], "launches_by_design": train[1]})

    run_dir = os.path.join(out, "default")
    ev = _last_json(_run_module([
        "distributed_training_tpu_torch.eval", "--run-dir", run_dir,
        "--max-batches", str(BYTES_EVAL_BATCHES)]))
    evl = _subprocess_launches(ev["kernel_launches"])
    check(math.isfinite(ev["loss"]) and ev["batches"] == BYTES_EVAL_BATCHES
          and evl[0]["flash_fwd"] == n_layers * BYTES_EVAL_BATCHES,
          f"eval.py: {ev}")
    emit({"phase": "eval_bytes_lm", "loss": ev["loss"],
          "batches": ev["batches"], "tokens": ev["tokens"],
          "seconds": ev["seconds"],
          "tokens_per_s": ev["tokens"] / ev["seconds"],
          "launches": evl[0], "launches_by_design": evl[1]})

    prompt = ("def main(argv: list[str] | None = None) -> int:\n"
              "    args = build_argparser().parse_args(argv)\n"
              "    cfg = load_config(args.config_dir, args.config_name, "
              "args.overrides)\n")[:GEN_PROMPT_BYTES]
    check(len(prompt.encode()) == GEN_PROMPT_BYTES, "generate prompt size")
    art = os.path.join(out, "byte_lm.pt")
    _run_module(["distributed_training_tpu_torch.checkpoint.export",
                 "--ckpt", os.path.join(out, "checkpoints"), "--out", art])
    gens = {}
    for dtype, src in (("bfloat16", ["--run-dir", run_dir]),
                       ("float32", ["--artifact", art, "--model-kwargs",
                                    '{"dtype": "float32"}'])):
        for decode in ("paged", "fused"):
            gens[(dtype, decode)] = _generate(src, decode, prompt,
                                              here=dtype == "float32")
            check(gens[(dtype, decode)]["decode"] == decode,
                  f"generate {dtype} {decode}: {gens[(dtype, decode)]}")
    same = {d: sum(a == b for a, b in zip(gens[(d, "paged")]["tokens"],
                                          gens[(d, "fused")]["tokens"]))
            for d in ("bfloat16", "float32")}
    check(same["float32"] == GEN_TOKENS,
          f"generate f32: paged and fused greedy tokens differ "
          f"({same['float32']}/{GEN_TOKENS} equal)")
    launches = {k: _subprocess_launches(g["kernel_launches"])
                for k, g in gens.items()}
    for (dtype, decode), (counts, _) in launches.items():
        if decode == "paged":
            check(counts["paged_decode"] == n_layers * (GEN_TOKENS - 1),
                  f"generate {dtype} paged: B4 launches {counts}")
    # The bf16 fused prefill is the design phase_kernels' generate case
    # holds against its plain version.
    _check_designs({"flash_fwd": launches[("bfloat16", "fused")][1][
        "flash_fwd"]}, "wgmma", "generate --decode fused (bf16) prefill")
    logits = _bf16_decode_logits(run_dir, prompt)
    emit({"phase": "generate_bytes_lm", "prompt_tokens": len(prompt),
          "tokens_bf16_fused": gens[("bfloat16", "fused")]["tokens"],
          "new_tokens": GEN_TOKENS, "tokens_equal_paged_vs_fused": same,
          "distinct_tokens": {f"{d}_{m}": len(set(g["tokens"]))
                              for (d, m), g in gens.items()},
          "tokens_per_s": {f"{d}_{m}": g["tokens_per_s"]
                           for (d, m), g in gens.items()},
          "launches": {f"{d}_{m}": c for (d, m), (c, _) in
                       launches.items()},
          "bf16_logits": {**logits, "same_tokens_as_cli": {
              m: logits[f"{m}_tokens"] == gens[("bfloat16", m)]["tokens"]
              for m in ("paged", "fused")}}})
    # The bf16 runs are the path's; the f32 ones (the SIMT design of the
    # flash forward in the fused prefill) are the check's.
    return {"train_bytes_lm": train, "eval": evl,
            **{f"generate_{m}": v for (d, m), v in launches.items()
               if d == "bfloat16"}}


def _state_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_state_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def phase_adafactor(tmp: str, corpus: str) -> tuple:
    """gpt2_125m at full width (conf/train/gpt2.yaml, batch 8 x seq 1024,
    bf16) under ``train.optimizer=adafactor`` (lr 3e-3, constant, no
    weight decay: optax's Adafactor adds the decay after the learning
    rate, so gpt2.yaml's 0.1 would shrink every weight by a tenth a
    step) on the byte corpus for ADAFACTOR_STEPS steps: finite losses
    that fall. Then the optimizer state of gpt2_125m's f32 params under
    Adafactor and under AdamW, in bytes."""
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.train import cli
    from distributed_training_tpu_torch.train.optimizer import (
        Optimizer,
        flatten,
    )

    _free_memory()
    out = os.path.join(tmp, "adafactor")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    check(cli.main(_train_overrides(out, ADAFACTOR_STEPS, extra=(
        "train.optimizer=adafactor", "train.learning_rate=0.003",
        "train.weight_decay=0", "train.warmup_steps=0",
        "train.lr_schedule=constant",
        "train.dataset=bytes", f"train.dataset_kwargs.path={corpus}",
        f"train.max_steps_per_epoch={ADAFACTOR_STEPS}", "train.save_every=0",
        f"train.snapshot_path={out}/checkpoints"))) == 0,
        "adafactor training failed")
    torch.cuda.synchronize()
    launches = (_read_counts(), _read_designs())
    peak = torch.cuda.max_memory_allocated()
    rows = _metrics_rows(out)
    losses = [r["loss"] for r in rows]
    check(len(losses) == ADAFACTOR_STEPS
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"adafactor losses {losses}")
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows[3:]]))
    _free_memory()
    model = Transformer(TransformerConfig(**PRESETS["gpt2_125m"]))
    flat = flatten(model.init(SEED))
    state = {}
    for kind in ("adafactor", "adamw"):
        opt = Optimizer(kind=kind, schedule=lambda count: 0.0)
        opt.bind_layout({k: tuple(v.shape) for k, v in flat.items()}, {},
                        None)
        state[kind] = _state_bytes(opt.init(flat))
    param_bytes = _state_bytes(flat)
    del flat
    emit({"phase": "adafactor", "model": "gpt2_125m", "batch": 8,
          "seq": 1024, "steps": ADAFACTOR_STEPS, "losses": losses,
          "median_step_s": step_s, "peak_mem_bytes": peak,
          "param_bytes": param_bytes,
          "opt_state_bytes": state,
          "opt_state_ratio": state["adafactor"] / state["adamw"],
          "launches": launches[0]})
    return launches


def phase_launch_playground(tmp: str) -> None:
    """The local launcher: ``--nproc 1`` on the card (the default MLP for
    one epoch, a NCCL group of one rank on cuda:0) and ``--nproc 2`` with
    CPU children (gloo); then the DDP playground at world 2, two
    processes on cuda:0 over gloo: both ranks end with the same params."""
    times = {}
    for n, extra, backend, device in ((1, [], "nccl", "cuda:0"),
                                      (2, ["train.device=cpu"], "gloo",
                                       "cpu")):
        out = os.path.join(tmp, f"launch{n}")
        t0 = time.perf_counter()
        _run_module(["distributed_training_tpu_torch.launch", "--nproc",
                     str(n), "--log-dir", os.path.join(out, "logs"), "--",
                     "-m", "distributed_training_tpu_torch.train",
                     "train.total_epochs=1", "run.log_level=WARNING",
                     f"run.output_dir={out}",
                     f"train.snapshot_path={out}/checkpoints", *extra])
        times[f"nproc{n}_s"] = time.perf_counter() - t0
        rt = _runtime_event(out)
        check(rt["backend"] == backend and rt["world"] == n
              and rt["device"] == device, f"launch --nproc {n}: {rt}")
        rows = _metrics_rows(out)
        check(rows and all(math.isfinite(r["loss"]) for r in rows),
              f"launch --nproc {n}: rows {rows}")
    logs = os.path.join(tmp, "playground")
    t0 = time.perf_counter()
    text = _run_module(["distributed_training_tpu_torch.playground."
                        "ddp_from_primitives", "--world-size", "2",
                        "--epochs", "4", "--lr", "0.05", "--log-dir", logs])
    times["playground_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(logs, f"ddp_rank_{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(x["device"] == "cuda:0" for x in ranks)
          and ranks[0]["params"] == ranks[1]["params"]
          and ranks[0]["history"] == ranks[1]["history"]
          and "final mean_loss" in text, f"playground ranks {ranks}")
    hist = [h["mean_loss"] for h in ranks[0]["history"]]
    check(all(math.isfinite(x) for x in hist) and hist[-1] < hist[0],
          f"playground losses {hist}")
    emit({"phase": "launch_playground", **times, "playground_losses": hist,
          "playground_ranks_equal": True})


# -- resilience and exactly-once data ----------------------------------------

# Two sources packed into blocks of 1025: the repository's text as bytes
# (weight 3) and synthetic documents at gpt2's vocab. Epochs of
# RESILIENCE_SPE steps, RESILIENCE_EPOCHS of them, a save at every epoch.
RESILIENCE_SPE = 4
RESILIENCE_EPOCHS = 3
# On this stream the loss spikes at step 5, where the 4-step warm-up
# ends, and from there any difference in summation order grows: one
# step's gradients under two fused backwards (B2 adds dq by atomics in a
# varying order) differ by 1.3e-3 of their norm, a rounding; the
# world-2 half's gloo sums round in another order too. Both runs stay
# within 1.2e-5 of a split world-1 run's losses over steps 1-4 and part
# from it by 1e-3 to 4% after (H100, PERF.md, PR 16). So a run that sums
# in another order is held over the first PRE_SPIKE_STEPS steps, losses
# and gradient norms, against the split run; the split backward, whose
# sums have a fixed order, holds a resume bit for bit. The limits lie
# between the sound readings there (fused and world 2: losses 7.5e-6 and
# 1.2e-5, norms 5.3e-4 and 1.5e-3, all at step 3 or 4) and the control
# world 2 whose processes keep their gradients unsummed (losses 3.8e-4
# at step 3 and 1.7e-3 at step 4, norms 0.43 to 0.48), which must fail.
PRE_SPIKE_STEPS = 4
PRE_SPIKE_LOSS_RTOL = 1e-4
PRE_SPIKE_GRAD_NORM_RTOL = 1e-2


def _stream_overrides(out: str, corpus: str, *extra) -> list:
    snap = os.path.join(out, "ckpt")
    return ["model=gpt2_125m", "train=gpt2", "train.global_batch_size=8",
            "train.data_sources={text: {dataset: bytes, weight: 3, "
            f"path: {corpus}, seq_len: 1024}}, docs: {{dataset: "
            "synthetic_doc, vocab_size: 50304, min_len: 128, "
            "max_len: 2048}}",
            "train.pack_seq_len=1024",
            f"train.max_steps_per_epoch={RESILIENCE_SPE}",
            f"train.total_epochs={RESILIENCE_EPOCHS}",
            "train.save_every=1", "train.warmup_steps=4",
            "train.log_every=1", "run.log_level=WARNING",
            f"run.output_dir={out}", f"train.snapshot_path={snap}", *extra]


def _digests(out_dir: str) -> dict:
    """step → (samples, sha256) of the batches a run took (the last
    record of each step: a resumed run takes the steps it replays
    again)."""
    return {e["step"]: (e["samples"], e["sha256"]) for e in _events(out_dir)
            if e["kind"] == "data_batch"}


def _losses(out_dir: str) -> dict:
    return {r["step"]: r["loss"] for r in _metrics_rows(out_dir)}


def _grad_norms(rows: list) -> dict:
    """step → gradient norm of the metrics rows that log one (a
    process's first row does not)."""
    return {r["step"]: r["grad_norm"] for r in rows if "grad_norm" in r}


def _pre_spike(got: dict, want: dict) -> dict:
    """The relative distances, step by step and at most, of a run's
    losses and gradient norms (``got``: {"loss": {step: x}, "grad_norm":
    {step: x}}) from ``want``'s over the steps up to PRE_SPIKE_STEPS that
    both logged, and whether both maxima lie within their limits."""
    out = {}
    for key, limit in (("loss", PRE_SPIKE_LOSS_RTOL),
                       ("grad_norm", PRE_SPIKE_GRAD_NORM_RTOL)):
        steps = [s for s in sorted(want[key]) if s <= PRE_SPIKE_STEPS
                 and s in got[key]]
        check(len(steps) >= PRE_SPIKE_STEPS - 1,
              f"{key} logged at steps {sorted(got[key])} and "
              f"{sorted(want[key])}")
        out[f"{key}_by_step"] = _per_step_rel(
            {s: got[key][s] for s in steps}, want[key])
        out[key] = max(out[f"{key}_by_step"].values())
        out[f"{key}_rtol"] = limit
    out["within"] = (out["loss"] <= PRE_SPIKE_LOSS_RTOL
                     and out["grad_norm"] <= PRE_SPIKE_GRAD_NORM_RTOL)
    return out


def _per_step_rel(got: dict, want: dict) -> dict:
    return {s: abs(got[s] - want[s]) / abs(want[s]) for s in sorted(got)}


def _launch_events(out_dir: str) -> tuple:
    """The summed ``kernel_launches`` events of a run's processes (one
    per incarnation) as (counts, by design)."""
    counts, designs = {}, {}
    for e in _events(out_dir):
        if e["kind"] != "kernel_launches":
            continue
        for name in KERNELS:
            counts[name] = counts.get(name, 0) + e[name]["launches"]
            d = designs.setdefault(name, {})
            for k, v in e[name]["by_design"].items():
                d[k] = d.get(k, 0) + v
    return counts, designs


def _save_stalls(tmp: str) -> dict:
    """gpt2_125m's train state on the card (f32 params and AdamW moments,
    about 1.5 GB): the caller's stall at a synchronous save and at an
    asynchronous one (its first, which pins the host buffers, and its
    second), the manifest's time and bytes, and an update written in
    place right after an async save: the restored bits are the saved
    ones."""
    from distributed_training_tpu_torch.checkpoint import Checkpointer
    from distributed_training_tpu_torch.models.transformer import (
        PRESETS,
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.train.optimizer import flatten

    _free_memory()
    model = Transformer(TransformerConfig(**PRESETS["gpt2_125m"]),
                        device="cuda")
    params = flatten(model.init(SEED))
    state = {"params": params,
             "opt_state": {"count": 3,
                           "mu": {k: torch.randn_like(p) * 1e-3
                                  for k, p in params.items()},
                           "nu": {k: torch.rand_like(p) * 1e-6
                                  for k, p in params.items()}},
             "step": 3}
    nbytes = _state_bytes(state)
    out = {"state_bytes": nbytes}
    torch.cuda.synchronize()
    with Checkpointer(os.path.join(tmp, "stall_sync"),
                      async_save=False) as ck:
        ck.save(1, state)
        out["sync_stall_s"] = ck.last_save_stall_s
        out["sync_manifest"] = ck.last_manifest
    want = {k: t.detach().cpu() for k, t in flatten(state).items()
            if isinstance(t, torch.Tensor)}
    with Checkpointer(os.path.join(tmp, "stall_async"),
                      async_save=True) as ck:
        for step in (1, 2):
            torch.cuda.synchronize()
            ck.save(step, state)
            out[f"async_stall_s_save{step}"] = ck.last_save_stall_s
            if step == 1:
                # The update right behind the save, in place, as the
                # optimizer's (the fence orders it after the copy).
                ck.fence()
                with torch.no_grad():
                    for t in params.values():
                        t.add_(1.0)
                    for t in state["opt_state"]["mu"].values():
                        t.mul_(-1.0)
            t0 = time.perf_counter()
            ck.wait()
            out[f"async_drain_s_save{step}"] = time.perf_counter() - t0
        out["async_manifest"] = ck.last_manifest
    saved = torch.load(os.path.join(tmp, "stall_async", "1", "state.pt"),
                       map_location="cpu", weights_only=True)
    got = {k: t for k, t in flatten(saved).items()
           if isinstance(t, torch.Tensor)}
    check(got.keys() == want.keys()
          and all(torch.equal(got[k], want[k]) for k in want),
          "save_stalls: an async save raced the update after it")
    out["async_racing_update_bitwise"] = True
    del model, params, state, saved
    _free_memory()
    return out


def phase_train_supervised(tmp: str, corpus: str) -> tuple:
    """gpt2_125m at full width on the two-source stream with the split
    backward (``DTT_FLASH_SPLIT_BWD=1``: dq sums in a fixed order, so a
    resume is held bit for bit), through ``launch --nproc 1 --supervise``
    with ``corrupt_ckpt@8,crash@10``: the step-8 save is damaged once its
    manifest is written, the crash after step 10 restarts the run, the
    restore quarantines step 8 and resumes from step 4, and the finished
    run's params and moments equal an uninterrupted supervised run's bit
    for bit. Also the save stalls, sync and async, and the manifest."""
    from distributed_training_tpu_torch.checkpoint.export import (
        restore_step_local,
    )
    from distributed_training_tpu_torch.resilience.integrity import (
        checkpoint_steps_on_disk,
    )

    stalls = _save_stalls(tmp)
    env = dict(os.environ, DTT_FLASH_SPLIT_BWD="1")
    runs = {}
    for name, plan in (("clean", ()),
                       ("faulty", ("train.fault_plan=corrupt_ckpt@8,"
                                   "crash@10",))):
        out = os.path.join(tmp, f"supervised_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "distributed_training_tpu_torch.launch",
             "--nproc", "1", "--log-dir", os.path.join(out, "logs"),
             "--supervise", "--max-restarts", "2", "--backoff-base-s",
             "0.5", "--ckpt-dir", os.path.join(out, "ckpt"), "--", "-m",
             "distributed_training_tpu_torch.train",
             *_stream_overrides(out, corpus, *plan)],
            cwd=_repo(), env=dict(env, PYTHONPATH=_repo()),
            capture_output=True, text=True, timeout=900)
        runs[name] = {"out": out, "wall_s": time.perf_counter() - t0}
        if proc.returncode != 0:
            logs = os.path.join(out, "logs")
            for d in sorted(os.listdir(logs)):
                p = os.path.join(logs, d, "proc_0.log")
                if os.path.exists(p):
                    with open(p) as f:
                        print(f"{name} {d}:\n{f.read()[-4000:]}",
                              file=sys.stderr)
        check(proc.returncode == 0,
              f"train_supervised {name}: launcher exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
    faulty, clean = runs["faulty"]["out"], runs["clean"]["out"]
    with open(os.path.join(faulty, "logs", "supervisor",
                           "events.jsonl")) as f:
        sup_events = [json.loads(line) for line in f]
    restarts = [e for e in sup_events if e["kind"] == "restart"]
    check(len(restarts) == 1 and restarts[0]["outcome"] == "crash",
          f"train_supervised: supervisor restarts {restarts}")
    events = _events(faulty)
    fired = {e["fault"]: e for e in events if e["kind"] == "fault_injected"}
    check(set(fired) == {"corrupt_ckpt@8", "crash@10"}
          and fired["corrupt_ckpt@8"]["target_step"] == 8,
          f"train_supervised: faults {fired}")
    quarantined = [e for e in events if e["kind"] == "ckpt_quarantined"]
    check(len(quarantined) == 1 and quarantined[0]["step"] == 8,
          f"train_supervised: quarantined {quarantined}")
    resumes = [e for e in events if e["kind"] == "resume"]
    check(len(resumes) == 1 and resumes[0]["step"] == 4
          and resumes[0]["samples_consumed"] == 4 * 8,
          f"train_supervised: resumes {resumes}")
    ckpt = os.path.join(faulty, "ckpt")
    check(os.path.isdir(os.path.join(ckpt, "step_8.corrupt")),
          "train_supervised: step 8 was not quarantined")
    got, got_step = restore_step_local(ckpt)
    want, want_step = restore_step_local(os.path.join(clean, "ckpt"))
    last = RESILIENCE_SPE * RESILIENCE_EPOCHS
    check(got_step == want_step == last,
          f"train_supervised: final steps {got_step}, {want_step}")
    check(_same_tree(got["params"], want["params"])
          and _same_tree(got["opt_state"], want["opt_state"]),
          "train_supervised: the restarted run's params or moments differ "
          "from the uninterrupted run's")
    check(_digests(faulty) == _digests(clean)
          and sorted(_digests(clean)) == list(range(1, last + 1)),
          "train_supervised: the batches differ from the uninterrupted run")
    check(_losses(faulty) == _losses(clean),
          "train_supervised: the losses differ from the uninterrupted run")
    # Restart wall: the crash to the restarted run's first finished step
    # (its first metrics row reads the loss, a sync).
    t_crash = fired["crash@10"]["t"]
    first = next(e for e in events if e["kind"] == "train_metrics"
                 and e["t"] > resumes[0]["t"])
    saves = [e for e in events if e.get("name") == "ckpt_save"
             and e["kind"] == "span"]
    launches, designs = _launch_events(faulty)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(designs[name]["wgmma"] == launches[name] > 0,
              f"train_supervised: {name} launches {designs[name]}")
    check(launches["flash_bwd_fused"] == 0,
          "train_supervised: the split run took the fused kernel")
    manifests = {}
    for step in checkpoint_steps_on_disk(ckpt):
        with open(os.path.join(ckpt, str(step), "manifest.dtt.json")) as f:
            files = json.load(f)["files"]
        manifests[step] = sum(v["bytes"] for v in files.values())
    emit({"phase": "train_supervised", "model": "gpt2_125m",
          "backward": "split", "batch": 8, "seq": 1024,
          "steps": last, "plan": "corrupt_ckpt@8,crash@10",
          "restarts": len(restarts), "quarantined_step": 8,
          "resumed_at": resumes[0]["step"],
          "steps_lost": 10 - resumes[0]["step"],
          "restart_wall_s": first["t"] - t_crash,
          "restore": resumes[0].get("restore"),
          "cli_async_save_stall_s": [e.get("dur_s") for e in saves],
          "manifest_bytes": manifests, "bitwise": True,
          "wall_s": {k: v["wall_s"] for k, v in runs.items()},
          **stalls, "launches": launches, "launches_by_design": designs})
    return launches, designs


def _first_step_grads(tmp: str, corpus: str) -> dict:
    """The gradients of the stream's first batch at the run's initial
    weights (gpt2_125m, the stream's config, no process group), twice
    under each backward: the relative distance, over all leaves in f32,
    of split from split, fused from fused and fused from split, and the
    leaf farthest apart. What B2's atomic dq does to one step's
    gradients, before any update can amplify it."""
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        StreamingDataLoader,
        build_stream_sources,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.runtime import initialize_runtime
    from distributed_training_tpu_torch.train.optimizer import flatten
    from distributed_training_tpu_torch.train.trainer import Trainer

    _free_memory()
    cfg = load_config(overrides=_stream_overrides(
        os.path.join(tmp, "first_step_grads"), corpus))
    rt = initialize_runtime(cfg)
    cfg.train.batch_size = 8
    loader = StreamingDataLoader(
        build_stream_sources(cfg.train.data_sources,
                             defaults={"size": cfg.train.dataset_size,
                                       "seed": cfg.train.seed}),
        rt, batch_size=8, pack_len=cfg.train.pack_seq_len,
        seed=cfg.train.seed, steps_per_epoch=cfg.train.max_steps_per_epoch)
    kwargs = dict(cfg.model.kwargs)
    dtype = kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(cfg.model.name, loss=cfg.train.loss, dtype=dtype,
                        device=rt.device, **kwargs)
    trainer = Trainer(cfg, rt, model, loader)
    batches = iter(loader.epoch(0))
    batch = next(batches)
    batches.close()
    params = trainer.state["params"]
    flat = flatten(params)

    def grads(split: bool) -> list:
        fa.FORCE_SPLIT_BWD = split
        try:
            loss, _ = model.loss(params, batch, train=True)
            return [g.float() for g in torch.autograd.grad(
                loss, list(flat.values()))]
        finally:
            fa.FORCE_SPLIT_BWD = False

    g = {name: grads(name.startswith("split"))
         for name in ("split_a", "split_b", "fused_a", "fused_b")}
    torch.cuda.synchronize()

    def dist(a: list, b: list) -> dict:
        per = {k: float((x - y).norm() / y.norm().clamp_min(1e-30))
               for k, x, y in zip(flat, a, b)}
        worst = max(per, key=per.get)
        num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
        den = sum(float(y.square().sum()) for y in b)
        return {"rel": math.sqrt(num / den), "worst_leaf": worst,
                "worst_leaf_rel": per[worst]}

    out = {"split_vs_split": dist(g["split_a"], g["split_b"]),
           "fused_vs_fused": dist(g["fused_a"], g["fused_b"]),
           "fused_vs_split": dist(g["fused_a"], g["split_a"])}
    check(out["split_vs_split"]["rel"] == 0.0,
          f"the split backward's gradients differ between two calls: "
          f"{out['split_vs_split']}")
    del g, trainer, params, flat
    _free_memory()
    return out


def phase_train_preempt_stream(tmp: str, corpus: str) -> tuple:
    """gpt2_125m on the stream through the CLI in this process:
    ``sigterm@6`` stops the run after step 6, mid-epoch, with a save,
    and the rerun resumes at step 6 with 48 samples consumed. First under
    the split backward, whose batches (by sha256) and losses equal an
    uninterrupted split run's step for step, bit for bit; then under the
    fused backward (the default path), whose batches equal it too and
    whose losses and gradient norms over the first PRE_SPIKE_STEPS steps
    lie within the bf16 parity limits of it. The fused run's distance
    from it at every step, and one step's gradients under both backwards
    (``_first_step_grads``), are reported. Returns the launches of both
    preempted runs and the uninterrupted run's directory (train_elastic's
    reference)."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.train import cli

    _free_memory()
    last = RESILIENCE_SPE * RESILIENCE_EPOCHS
    ref = os.path.join(tmp, "preempt_clean")
    runs = {}
    for backward in ("split", "fused"):
        out = os.path.join(tmp, f"preempt_{backward}")
        fa.FORCE_SPLIT_BWD = backward == "split"
        try:
            _reset_counts()
            t0 = time.perf_counter()
            for what in ("preempted", "resumed"):
                check(cli.main(_stream_overrides(
                    out, corpus, "train.fault_plan=sigterm@6")) == 0,
                    f"train_preempt_stream: the {backward} {what} run "
                    "failed")
            torch.cuda.synchronize()
            runs[backward] = {"out": out,
                              "wall_s": time.perf_counter() - t0,
                              "launches": _read_counts(),
                              "launches_by_design": _read_designs()}
            if backward == "split":
                check(cli.main(_stream_overrides(ref, corpus)) == 0,
                      "train_preempt_stream: the uninterrupted run failed")
        finally:
            fa.FORCE_SPLIT_BWD = False
        # The checkpoints are read no more: free the chip machine's disk.
        shutil.rmtree(os.path.join(out, "ckpt"), ignore_errors=True)
    shutil.rmtree(os.path.join(ref, "ckpt"), ignore_errors=True)
    want_digests = _digests(ref)
    check(sorted(want_digests) == list(range(1, last + 1)),
          f"train_preempt_stream: the uninterrupted run took batches at "
          f"{sorted(want_digests)}")
    ref_rows = _metrics_rows(ref)
    want = {"loss": _losses(ref), "grad_norm": _grad_norms(ref_rows)}
    for backward, run in runs.items():
        out, what = run.pop("out"), f"train_preempt_stream ({backward})"
        events = _events(out)
        fired = [e["fault"] for e in events if e["kind"] == "fault_injected"]
        check(fired == ["sigterm@6"], f"{what}: faults {fired}")
        resumes = [e for e in events if e["kind"] == "resume"]
        check(len(resumes) == 1 and resumes[0]["step"] == 6
              and resumes[0]["epoch"] == 1
              and resumes[0]["samples_consumed"] == 6 * 8,
              f"{what}: resumes {resumes}")
        check(_digests(out) == want_digests,
              f"{what}: the batches differ from the uninterrupted run's")
        steps = [e["step"] for e in events if e["kind"] == "data_batch"]
        check(steps == list(range(1, last + 1)),
              f"{what}: batches taken at steps {steps}")
        got = {"loss": _losses(out), "grad_norm": _grad_norms(
            _metrics_rows(out))}
        check(sorted(got["loss"]) == sorted(want["loss"]),
              f"{what}: losses at steps {sorted(got['loss'])}")
        run["loss_rel_diff_by_step"] = _per_step_rel(got["loss"],
                                                     want["loss"])
        run["grad_norm_rel_diff_by_step"] = _per_step_rel(
            got["grad_norm"], want["grad_norm"])
        run["restore"] = resumes[0].get("restore")
        run["realized_mixture"] = resumes[0].get("realized_mixture")
        if backward == "split":
            check(got["loss"] == want["loss"],
                  f"{what}: losses {got['loss']} vs {want['loss']}")
            run["losses_equal"] = True
        else:
            run["pre_spike"] = _pre_spike(got, want)
        names = (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 if backward == "split" else ("flash_fwd", "flash_bwd_fused"))
        _check_designs({n: run["launches_by_design"][n] for n in names},
                       "wgmma", what)
        check(all(run["launches"][n] == (12 * last if n in names else 0)
                  for n in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                            "flash_bwd_dkv")),
              f"{what}: launches {run['launches']}")
    grads = _first_step_grads(tmp, corpus)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["split"]["launches"]}
    designs = {k: {d: sum(r["launches_by_design"][k][d]
                          for r in runs.values())
                   for d in runs["split"]["launches_by_design"][k]}
               for k in runs["split"]["launches_by_design"]}
    emit({"phase": "train_preempt_stream", "model": "gpt2_125m",
          "batch": 8, "seq": 1024, "steps": last, "plan": "sigterm@6",
          "resumed_at": 6, "samples_consumed": 48, "batches_equal": True,
          "reference": "uninterrupted, split backward",
          "pre_spike_steps": PRE_SPIKE_STEPS, "runs": runs,
          "reference_losses": [want["loss"][k] for k in sorted(want["loss"])],
          "first_step_grads": grads, "launches": launches,
          "launches_by_design": designs})
    check(runs["fused"]["pre_spike"]["within"],
          f"train_preempt_stream (fused): steps 1-{PRE_SPIKE_STEPS} outside "
          f"the limits of the split run's: {runs['fused']['pre_spike']}")
    return (launches, designs), ref


def _unsynced_grads() -> None:
    """The planted fault of train_elastic's control: each process keeps
    its own gradients, unsummed over the group (the reduce-scatter of
    the sharded leaves cuts this process's shard of its own gradient,
    the all-reduce of the replicated ones does nothing)."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.parallel import fsdp

    def own_shards(fulls, dims, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return [g.narrow(d, r * (g.shape[d] // n), g.shape[d] // n)
                .contiguous() for g, d in zip(fulls, dims)]

    fsdp.reduce_scatter_dims = own_shards
    fsdp._all_reduce_flat = lambda tensors, group: None


def train_elastic_rank(rank: int, port: int, out: str, corpus: str,
                       control: bool = False) -> int:
    """One of phase train_elastic's two processes: on ``cuda:0`` in a gloo
    group of 2 over ``127.0.0.1:port``, ``fsdp`` over the mesh fsdp 2 (a
    runtime built here: the CLI's would ask for NCCL on a card), the
    stream at a global batch of 8 (4 rows a process), ``sigterm@6`` for a
    mid-epoch save; wires the run as the train CLI does. ``control``:
    PRE_SPIKE_STEPS steps with the gradients left unsynchronised
    (``_unsynced_grads``), no fault and no checkpoint."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.checkpoint import Checkpointer
    from distributed_training_tpu_torch.checkpoint.consolidate import (
        gather_full_state,
    )
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        StreamingDataLoader,
        build_stream_sources,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.resilience import faults
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime
    from distributed_training_tpu_torch.telemetry import events as tel_lib
    from distributed_training_tpu_torch.train.trainer import Trainer
    from distributed_training_tpu_torch.utils.preemption import (
        PreemptionGuard,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    guard = PreemptionGuard.install()
    if control:
        _unsynced_grads()
    try:
        rt = slice_runtime([MeshSpec(dp=1, fsdp=2)], torch.device("cuda", 0))
        extra = (("train.total_epochs=1",
                  f"train.max_steps_per_epoch={PRE_SPIKE_STEPS}")
                 if control else ())
        cfg = load_config(overrides=_stream_overrides(
            out, corpus, "train.parallel_strategy=fsdp", "mesh.dp=1",
            "mesh.fsdp=2", "train.stop_poll_every=1", *extra))
        cfg.train.batch_size = 8 // rt.data_shard_count
        run_dir = os.path.join(out, "default")
        os.makedirs(run_dir, exist_ok=True)
        inj = faults.FaultInjector(
            "" if control else "sigterm@6", ledger_path=os.path.join(
                run_dir, f"host_{rank}", "faults_fired.json"),
            ckpt_dir=cfg.train.snapshot_path, host=rank)
        loader = StreamingDataLoader(
            build_stream_sources(cfg.train.data_sources,
                                 defaults={"size": cfg.train.dataset_size,
                                           "seed": cfg.train.seed}),
            rt, batch_size=cfg.train.batch_size,
            pack_len=cfg.train.pack_seq_len, seed=cfg.train.seed,
            steps_per_epoch=cfg.train.max_steps_per_epoch)
        kwargs = dict(cfg.model.kwargs)
        dtype = kwargs.pop("dtype", cfg.train.dtype)
        model = build_model(cfg.model.name, loss=cfg.train.loss, dtype=dtype,
                            device=rt.device, **kwargs)
        tel = tel_lib.install(tel_lib.Telemetry(
            events_jsonl=(os.path.join(run_dir, "events.jsonl")
                          if rank == 0 else None)))
        _reset_counts()
        with contextlib.ExitStack() as stack:
            ck = None if control else stack.enter_context(Checkpointer(
                cfg.train.snapshot_path, runtime=rt, fault_injector=inj))
            trainer = Trainer(cfg, rt, model, loader, ck,
                              preemption_guard=guard, fault_injector=inj)
            trainer.train()
        torch.cuda.synchronize()
        tel_lib.uninstall()
        tel.close()
        # The whole state at the stop (the step just saved), gathered by
        # the collectives: what the restore at world 1 must re-cut.
        whole = (None if control else
                 gather_full_state(trainer.state, trainer.layout, rt))
        rows = trainer.metrics.history
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "step": trainer.global_step,
                       "state_digests": (None if whole is None
                                         else _state_digests(whole)),
                       "stopped": guard.should_stop,
                       "losses": [r["loss"] for r in rows if "loss" in r],
                       "grad_norms": _grad_norms(rows),
                       "launches": _read_counts(),
                       "launches_by_design": _read_designs()}, f)
    finally:
        guard.uninstall()
        dist.destroy_process_group()
    return 0


def _world2(tmp: str, out: str, corpus: str, control: bool) -> tuple:
    """train_elastic's world of 2 (``train_elastic_rank`` in two
    processes): the ranks' reports and the wall seconds."""
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    tag = "elastic_control" if control else "elastic"
    logs = [open(os.path.join(tmp, f"{tag}.rank{r}.log"), "w")
            for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-elastic-rank",
         str(r), str(port), out, corpus, *(["control"] if control else [])],
        stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, DTT_FLASH_SPLIT_BWD="1")) for r in range(2)]
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
                print(f"{tag} rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"{tag}: world-2 ranks exited {codes}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r in ranks:
        r["grad_norms"] = {int(k): v for k, v in r["grad_norms"].items()}
    return ranks, wall


def _world2_rows(rank0: dict) -> dict:
    """Process 0's losses and gradient norms by step."""
    return {"loss": {i + 1: x for i, x in enumerate(rank0["losses"])},
            "grad_norm": rank0["grad_norms"]}


def phase_train_elastic(tmp: str, corpus: str, ref: str) -> tuple:
    """gpt2_125m on the stream with the split backward, resized: a world
    of 2 (two processes on ``cuda:0``, gloo, ``fsdp`` over fsdp 2) stops
    after step 6 with a sharded mid-epoch save, and digests its live
    state gathered by the collectives; the state the restore at world 1
    re-cuts from the sharded step has those digests, bit for bit. The
    world-2 run's losses and gradient norms over the first
    PRE_SPIKE_STEPS steps lie within the bf16 parity limits of the
    uninterrupted world-1 run's (``ref``, train_preempt_stream); a
    control world of 2 whose processes keep their gradients unsummed
    (``_unsynced_grads``) must not. The CLI in this process then
    resumes the run at world 1 on ``cuda:0`` (no process group); the
    batches taken by both worlds (by sha256) equal the uninterrupted
    run's step for step, each sample once, and the losses after the
    resize are finite (they part from the reference's where the stream
    amplifies the world-2 half's other summation order; the distance is
    reported)."""
    from distributed_training_tpu_torch.train import cli

    _free_memory()
    last = RESILIENCE_SPE * RESILIENCE_EPOCHS
    out = os.path.join(tmp, "elastic")
    ranks, world2_s = _world2(tmp, out, corpus, control=False)
    check(all(r["step"] == 6 and r["stopped"] for r in ranks),
          f"train_elastic: world 2 stopped at {[r['step'] for r in ranks]}")
    ckpt = os.path.join(out, "ckpt")
    with open(os.path.join(ckpt, "6", "layout.json")) as f:
        layout = json.load(f)
    check(layout["world"] == 2 and layout["mesh"]["fsdp"] == 2,
          f"train_elastic: step-6 layout {layout['mesh']}")
    with open(os.path.join(ckpt, "6", "manifest.dtt.json")) as f:
        files = sorted(json.load(f)["files"])
    check(files == ["layout.json", "meta.json", "state.rank0.pt",
                    "state.rank1.pt"], f"train_elastic: manifest {files}")
    from distributed_training_tpu_torch.checkpoint import Checkpointer

    t0 = time.perf_counter()
    restored, _ = Checkpointer(ckpt).restore_latest(torch.device("cuda", 0))
    restore_s = time.perf_counter() - t0
    digests = _state_digests(restored)
    check(all(digests == r["state_digests"] for r in ranks),
          "train_elastic: the state re-cut at world 1 differs from the "
          "world-2 run's gathered state")
    del restored
    _free_memory()
    want = {"loss": _losses(ref), "grad_norm": _grad_norms(
        _metrics_rows(ref))}
    pre_spike = _pre_spike(_world2_rows(ranks[0]), want)
    control, control_s = _world2(tmp, os.path.join(tmp, "elastic_control"),
                                 corpus, control=True)
    check(all(r["step"] == PRE_SPIKE_STEPS for r in control),
          f"train_elastic: the control stopped at "
          f"{[r['step'] for r in control]}")
    control_pre_spike = _pre_spike(_world2_rows(control[0]), want)
    from distributed_training_tpu_torch.ops import flash_attention as fa

    fa.FORCE_SPLIT_BWD = True
    try:
        _reset_counts()
        t0 = time.perf_counter()
        check(cli.main(_stream_overrides(out, corpus)) == 0,
              "train_elastic: the world-1 resume failed")
        torch.cuda.synchronize()
        world1_s = time.perf_counter() - t0
        launches1, designs1 = _read_counts(), _read_designs()
    finally:
        fa.FORCE_SPLIT_BWD = False
    shutil.rmtree(ckpt, ignore_errors=True)
    events = _events(out)
    resumes = [e for e in events if e["kind"] == "resume"]
    check(len(resumes) == 1 and resumes[0]["step"] == 6
          and resumes[0]["world_size"] == 1
          and resumes[0]["samples_consumed"] == 6 * 8
          and resumes[0]["restore"]["resharded"],
          f"train_elastic: resumes {resumes}")
    at = events.index(resumes[0])
    before = [e["step"] for e in events[:at] if e["kind"] == "data_batch"]
    after = [e["step"] for e in events[at:] if e["kind"] == "data_batch"]
    check(before == list(range(1, 7)) and after == list(range(7, last + 1)),
          f"train_elastic: batches at steps {before} then {after}")
    check(_digests(out) == _digests(ref),
          "train_elastic: the batches differ from the uninterrupted run's")
    a = _losses(out)
    a.update(_world2_rows(ranks[0])["loss"])
    check(sorted(a) == sorted(want["loss"])
          and all(math.isfinite(x) for x in a.values()),
          f"train_elastic: losses {a}")
    check(len(ranks[0]["losses"]) == 6,
          f"train_elastic: world 2 logged {ranks[0]['losses']}")
    launches = {k: launches1[k] + sum(r["launches"][k] for r in ranks)
                for k in launches1}
    designs = {k: {d: designs1[k][d] + sum(r["launches_by_design"][k][d]
                                           for r in ranks)
                   for d in designs1[k]} for k in designs1}
    split = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    _check_designs({n: designs[n] for n in split}, "wgmma", "train_elastic")
    check(launches["flash_bwd_fused"] == 0,
          f"train_elastic: the fused backward ran: {launches}")
    emit({"phase": "train_elastic", "model": "gpt2_125m",
          "backward": "split", "batch": 8, "seq": 1024, "steps": last,
          "world_history": [2, 1], "strategy_world2": "fsdp (gloo)",
          "saved_at": 6, "restore": resumes[0]["restore"],
          "batches_equal": True, "restored_state_equal": True,
          "restore_s": restore_s, "pre_spike": pre_spike,
          "control_unsynced_grads_pre_spike": control_pre_spike,
          "control_losses": control[0]["losses"],
          "loss_rel_diff_by_step": _per_step_rel(a, want["loss"]),
          "losses": [a[k] for k in sorted(a)], "world2_wall_s": world2_s,
          "control_wall_s": control_s, "world1_wall_s": world1_s,
          "launches": launches, "launches_by_design": designs})
    check(pre_spike["within"],
          f"train_elastic: world 2's steps 1-{PRE_SPIKE_STEPS} outside the "
          f"limits of world 1's: {pre_spike}")
    check(not control_pre_spike["within"],
          "train_elastic: the control with unsynchronised gradients passed "
          f"the limits: {control_pre_spike}")
    return launches, designs


class _TraceFile:
    """A Chrome-trace file as ``_device_time`` reads a profiler: its
    events with a name, a device type (the card's lanes, annotations
    included, are CUDA), a time range in microseconds and whether the
    event is an annotation."""

    def __init__(self, path: str):
        with open(path) as f:
            self.records = [r for r in json.load(f)["traceEvents"]
                            if r.get("ph") == "X"]

    def events(self) -> list:
        from types import SimpleNamespace
        device = {"kernel", "gpu_memcpy", "gpu_memset",
                  "gpu_user_annotation"}
        out = []
        for r in self.records:
            start, dur = float(r["ts"]), float(r["dur"])
            out.append(SimpleNamespace(
                name=r.get("name", ""),
                device_type=("DeviceType.CUDA" if r.get("cat") in device
                             else "DeviceType.CPU"),
                is_user_annotation=r.get("cat") in (
                    "user_annotation", "gpu_user_annotation"),
                time_range=SimpleNamespace(
                    start=start, end=start + dur,
                    elapsed_us=lambda dur=dur: dur)))
        return out


def _poll_metrics(run_dir: str, want: tuple, box: dict,
                  stop: threading.Event) -> None:
    """Read the run's live ``/metrics`` (port from ``metrics.port``)
    until a body holds every name in ``want``; the last body read goes
    to ``box``."""
    path = os.path.join(run_dir, "metrics.port")
    while not stop.is_set():
        try:
            with open(path) as f:
                port = int(f.read().strip())
            _, body = _get(port, "/metrics")
        except (OSError, ValueError):
            stop.wait(0.1)
            continue
        box["body"] = body
        if all(w in body for w in want):
            box["ok"] = True
            return
        stop.wait(0.1)


def phase_train_telemetry(tmp: str) -> tuple:
    """gpt2_125m through the trainer CLI for TRAIN_STEPS steps with the
    run's own observability on: an in-run ``torch.profiler`` capture of
    PROFILE_STEPS steps from PROFILE_AT and its ``attribution`` event,
    HBM samples every HBM_EVERY steps, the hang watchdog armed, the live
    metrics endpoint read during the run, the anomaly detector at its
    default; then the summarizer and the doctor on the run dir."""
    from distributed_training_tpu_torch.train import cli

    out = os.path.join(tmp, "train_telemetry")
    run_dir = os.path.join(out, "default")
    want = ("dtt_mfu", "dtt_goodput", "dtt_step_time_seconds")
    box, stop = {}, threading.Event()
    poller = threading.Thread(target=_poll_metrics,
                              args=(run_dir, want, box, stop), daemon=True)
    overrides = _train_overrides(out, TRAIN_STEPS, extra=(
        f"train.profile_at={PROFILE_AT}",
        f"train.profile_steps={PROFILE_STEPS}",
        f"train.hbm_sample_every={HBM_EVERY}",
        "train.watchdog_timeout_s=120", f"train.metrics_port={_free_port()}",
        # No checkpoint: the chip machine's disk takes 45 GiB of writes a
        # call, and gpt2_125m's train state is 1.49 GB a save.
        "train.save_every=0"))
    _reset_counts()
    poller.start()
    try:
        check(cli.main(overrides) == 0, "train_telemetry failed")
    finally:
        stop.set()
        poller.join(timeout=60)
    torch.cuda.synchronize()
    launches, designs = _read_counts(), _read_designs()
    _check_designs({n: designs[n] for n in ("flash_fwd", "flash_bwd_fused")},
                   "wgmma", "train_telemetry (bf16, head dim 64)")
    for name in ("flash_fwd", "flash_bwd_fused"):
        check(launches[name] == 12 * TRAIN_STEPS,
              f"train_telemetry: {name} launched {launches[name]} times")
    check(box.get("ok"), f"/metrics during the run lacked {want}: "
          f"{box.get('body', '')[:2000]}")
    events = _events(out)
    kinds = {e["kind"] for e in events}
    check("anomaly_detect" not in kinds,
          "train_telemetry: the placeholder anomaly_detect event is back")
    att = [e for e in events if e["kind"] == "attribution"]
    check(len(att) == 1 and "error" not in att[0],
          f"train_telemetry: attribution events {att}")
    att = att[0]
    ops = [o["name"] for o in att["top_ops"]]
    check(att["source"] == "device" and any("flash_fwd" in n for n in ops)
          and any("flash_bwd" in n for n in ops), f"attribution ops {ops}")
    dev = _device_time(_TraceFile(att["trace"]), att["window_s"] * 1e6,
                       top_n=12)
    busy_rel = abs(att["busy_s"] * 1e6 - dev["device_busy_us"]) \
        / dev["device_busy_us"]
    check(busy_rel <= ATTRIBUTION_BUSY_RTOL,
          f"attribution busy {att['busy_s']} s against _device_time "
          f"{dev['device_busy_us']} us")
    run = [e for e in events if e["kind"] == "goodput"
           and e["scope"] == "run"]
    check(len(run) == 1, f"goodput run events {run}")
    run = run[0]
    bucket_sum = sum(run["buckets"].values())
    check(abs(bucket_sum - run["wall_s"]) <= GOODPUT_SUM_RTOL * run["wall_s"],
          f"goodput buckets sum {bucket_sum} against wall {run['wall_s']}")
    hbm = [e for e in events if e["kind"] == "hbm"]
    check(len(hbm) == TRAIN_STEPS // HBM_EVERY, f"{len(hbm)} hbm samples")
    ratios = []
    for e in hbm:
        stats = e["devices"][0]["stats"] or {}
        check(e["estimate_bytes"] < stats.get("bytes_in_use", 0)
              < stats.get("bytes_limit", 0), f"hbm sample {e}")
        ratios.append(stats.get("bytes_in_use", 0) / e["estimate_bytes"])
    summary = json.loads(_run_module(
        ["distributed_training_tpu_torch.telemetry", run_dir, "--json"]))
    check(summary["goodput"]["steps"] == run["steps"],
          f"summarizer goodput {summary['goodput']}")
    doctor = _run_module(["distributed_training_tpu_torch.telemetry",
                          run_dir, "--doctor"])
    check("VERDICT:" in doctor, f"doctor printed {doctor[-2000:]}")
    rows = _metrics_rows(out)
    step_s = float(np.median([1.0 / r["steps_per_sec"] for r in rows[3:]]))
    emit({"phase": "train_telemetry", "steps": TRAIN_STEPS,
          "median_step_s": step_s,
          "train_median_step_s": READINGS.get("train_median_step_s"),
          "goodput_run": run, "goodput_bucket_sum_s": bucket_sum,
          "mfu_goodput_wall": run.get("mfu_wall"),
          "mfu_goodput_step": run.get("mfu_step"),
          "mfu_metrics_median": float(np.median(
              [r.get("mfu", float("nan")) for r in rows[3:]])),
          "attribution": {k: att[k] for k in (
              "step", "steps_captured", "window_s", "busy_s",
              "compute_frac", "collective_frac", "host_frac",
              "overlap_frac", "events", "start_s", "stop_s")},
          "attribution_flash_ops": [o for o in att["top_ops"]
                                    if "flash_" in o["name"]],
          "attribution_top_ops": att["top_ops"][:8],
          "device_time_of_trace": dev,
          "attribution_busy_rel_diff": busy_rel,
          "hbm_bytes_in_use_over_estimate": ratios,
          "hbm_last": hbm[-1],
          "doctor_verdict": doctor.split("VERDICT:")[1].split("\n")[0],
          "launches": launches, "launches_by_design": designs})
    return launches, designs


def phase_train_watchdog(tmp: str) -> None:
    """The trainer CLI (a subprocess on the card) with the hang
    watchdog's abort on and a data stall longer than its timeout at
    step 4: it exits WATCHDOG_EXIT with a postmortem whose stacks show
    the loader's stall; the incident recorder's bundle of the firing is
    read by the doctor, and the supervisor classifies the exit."""
    from distributed_training_tpu_torch.resilience import supervisor as sup

    out = os.path.join(tmp, "train_watchdog")
    run_dir = os.path.join(out, "default")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_training_tpu_torch.train",
         *_train_overrides(out, 8, extra=(
             f"train.watchdog_timeout_s={WATCHDOG_TIMEOUT_S}",
             "train.watchdog_abort=true",
             f"train.fault_plan={WATCHDOG_STALL}"))],
        cwd=_repo(), env=dict(os.environ, PYTHONPATH=_repo()),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == WATCHDOG_EXIT,
          f"train_watchdog exited {proc.returncode}: {proc.stderr[-3000:]}")
    check(sup.classify_exit(proc.returncode, []) == sup.WATCHDOG_ABORT,
          "the supervisor does not classify the exit as watchdog_abort")
    pm_dir = os.path.join(run_dir, "postmortem")
    bundles = sorted(os.listdir(pm_dir))
    check(len(bundles) == 1, f"postmortems {bundles}")
    with open(os.path.join(pm_dir, bundles[0], "stacks.txt")) as f:
        stacks = f.read()
    check("on_data" in stacks and "_prefetch" in stacks,
          f"the stacks do not show the loader's wait: {stacks[-3000:]}")
    inc_dir = os.path.join(run_dir, "incidents")
    incidents = [d for d in sorted(os.listdir(inc_dir))
                 if os.path.isdir(os.path.join(inc_dir, d))]
    metas = []
    for d in incidents:
        with open(os.path.join(inc_dir, d, "meta.json")) as f:
            metas.append(json.load(f))
    fired = [(d, m) for d, m in zip(incidents, metas)
             if m.get("trigger", {}).get("kind") == "watchdog_fired"]
    check(len(fired) == 1, f"incident bundles {metas}")
    doctor = _run_module(["distributed_training_tpu_torch.telemetry",
                          os.path.join(inc_dir, fired[0][0]), "--doctor"])
    check("kind=watchdog" in doctor and "VERDICT:" in doctor,
          f"doctor on the bundle: {doctor[-2000:]}")
    emit({"phase": "train_watchdog", "exit": proc.returncode,
          "wall_s": wall, "timeout_s": WATCHDOG_TIMEOUT_S,
          "fault": WATCHDOG_STALL, "postmortem": bundles[0],
          "incident": fired[0][1],
          "doctor": doctor.strip().splitlines()[:4]})


def phase_train_dropout(tmp: str) -> tuple:
    """gpt2_125m through the trainer CLI with GPT-2's dropout for
    DROPOUT_STEPS steps on the train phase's batches: losses finite, the
    first apart from the dropout-free run's on the same seed and batch;
    then twice under the split backward (deterministic), whose losses
    must repeat bit for bit. Every flash launch on the tensor-core
    design. The first run also carries a planted slow host from step
    ANOMALY_SLOW_AT (ANOMALY_SLOW_FAULT), which the anomaly detector,
    on by default, must flag in an ``anomaly`` event that the incident
    recorder bundles."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.train import cli

    runs, counts = {}, []
    for name, split in (("fused", False), ("split_a", True),
                        ("split_b", True)):
        out = os.path.join(tmp, f"train_dropout_{name}")
        slow = (() if split else (
            f"train.fault_plan={ANOMALY_SLOW_FAULT}",
            f"train.anomaly_min_samples={ANOMALY_MIN_SAMPLES}"))
        fa.FORCE_SPLIT_BWD = split
        try:
            _reset_counts()
            check(cli.main(_train_overrides(out, TRAIN_STEPS, extra=(
                f"+model.dropout={DROPOUT_RATE}", "train.save_every=0",
                f"train.max_steps_per_epoch={DROPOUT_STEPS}", *slow))) == 0,
                f"train_dropout {name} failed")
            torch.cuda.synchronize()
            counts.append((_read_counts(), _read_designs()))
        finally:
            fa.FORCE_SPLIT_BWD = False
        runs[name] = [r["loss"] for r in _metrics_rows(out)]
        check(len(runs[name]) == DROPOUT_STEPS
              and all(math.isfinite(x) for x in runs[name]),
              f"train_dropout {name}: losses {runs[name]}")
    ref = READINGS.get("train_first_loss")
    check(ref is not None and runs["fused"][0] != ref,
          f"dropout's first loss {runs['fused'][0]} equals the "
          f"dropout-free run's {ref}")
    check(runs["split_a"] == runs["split_b"],
          f"split reruns differ: {runs['split_a']} {runs['split_b']}")
    events = _events(os.path.join(tmp, "train_dropout_fused"))
    flagged = [e for e in events if e["kind"] == "anomaly"
               and e["signal"] == "step_time"
               and e["step"] >= ANOMALY_SLOW_AT]
    bundles = [e for e in events if e["kind"] == "incident"
               and e["incident_kind"] == "anomaly"]
    seen = [e for e in events if e["kind"] in ("anomaly", "incident")]
    check(flagged and bundles, "train_dropout: the anomaly detector did not "
          f"flag the slow host: {seen}")
    launches = {k: sum(c[k] for c, _ in counts) for k in counts[0][0]}
    designs = {k: {d: sum(ds[k][d] for _, ds in counts)
                   for d in counts[0][1][k]} for k in counts[0][1]}
    for k in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
              "flash_bwd_dkv"):
        check(launches[k] > 0, f"train_dropout: {k} never launched")
    _check_designs({k: designs[k] for k in ("flash_fwd", "flash_bwd_fused",
                                            "flash_bwd_dq",
                                            "flash_bwd_dkv")},
                   "wgmma", "train_dropout (bf16, head dim 64)")
    emit({"phase": "train_dropout", "rate": DROPOUT_RATE,
          "steps": DROPOUT_STEPS, "losses": runs,
          "first_loss_without_dropout": ref,
          "anomaly_fault": ANOMALY_SLOW_FAULT, "anomaly": flagged[0],
          "incident": bundles[0]["path"], "launches": launches,
          "launches_by_design": designs})
    return launches, designs

# -- MoE ---------------------------------------------------------------------


def _moe_model(dtype: str = "bfloat16"):
    from distributed_training_tpu_torch.models.transformer import (
        build_transformer,
    )

    return build_transformer("moe_transformer", dtype=dtype)


def phase_train_moe(tmp: str) -> tuple:
    """moe_transformer at full width through the trainer CLI on
    ``cuda:0``: TRAIN_MOE_STEPS fused steps (saved, for generate_moe),
    then TRAIN_MOE_SPLIT_STEPS under the split backward. Returns the
    launches of both runs and the fused run's directory."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.parallel import expert
    from distributed_training_tpu_torch.train import cli

    L = _moe_model().cfg.n_layers
    flops = _moe_model().flops_per_sample() * 8
    runs, launches, designs = {}, [], []
    for name, steps, split in (("fused", TRAIN_MOE_STEPS, False),
                               ("split", TRAIN_MOE_SPLIT_STEPS, True)):
        out = os.path.join(tmp, f"train_moe_{name}")
        _free_memory()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        expert.ROUTING.clear()
        fa.FORCE_SPLIT_BWD = split
        t0 = time.perf_counter()
        try:
            check(cli.main(_train_overrides(out, steps, extra=(
                *MOE_OVERRIDES, f"train.warmup_steps={TRAIN_MOE_WARMUP}",
                "train.dataset_size=8", f"train.total_epochs={steps}",
                f"train.save_every={0 if split else steps}"))) == 0,
                f"train_moe {name} failed")
            torch.cuda.synchronize()
        finally:
            fa.FORCE_SPLIT_BWD = False
        wall = time.perf_counter() - t0
        launches.append(_read_counts())
        designs.append(_read_designs())
        rows = _metrics_rows(out)
        losses = [r["loss"] for r in rows]
        check(len(losses) == steps, f"train_moe {name}: {len(losses)} rows")
        check(all(math.isfinite(x) for x in losses),
              f"train_moe {name}: non-finite loss {losses}")
        check(all("moe_aux" in r and math.isfinite(r["moe_aux"])
                  for r in rows), f"train_moe {name}: a row lacks moe_aux")
        kernels = (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if split
                   else ("flash_fwd", "flash_bwd_fused"))
        _check_designs({n: designs[-1][n] for n in kernels}, "wgmma",
                       f"train_moe {name} (bf16, head dim 64)")
        for n in kernels:
            check(launches[-1][n] == L * steps,
                  f"train_moe {name}: {n} launched {launches[-1][n]} "
                  f"times, not {L} x {steps}")
        others = ({"flash_bwd_fused"} if split
                  else {"flash_bwd_dq", "flash_bwd_dkv"})
        check(all(launches[-1][n] == 0 for n in others),
              f"train_moe {name}: launches {launches[-1]}")
        step_s = float(np.median([1.0 / r["steps_per_sec"]
                                  for r in rows[3:]]))
        runs[name] = {
            "steps": steps, "wall_s": wall, "median_step_s": step_s,
            "tokens_per_s": 8 * MOE_SEQ / step_s,
            "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
            "mfu_logged_median": float(np.median(
                [r.get("mfu", float("nan")) for r in rows[3:]])),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "dropped_share": expert.dropped_share(),
            "losses": losses, "moe_aux": [r["moe_aux"] for r in rows],
            "grad_norms": [r["grad_norm"] for r in rows if "grad_norm" in r],
            "launches": launches[-1], "launches_by_design": designs[-1]}
    fused = runs["fused"]["losses"]
    check(np.mean(fused[-5:]) < np.mean(fused[:5]),
          f"train_moe: losses not falling {fused}")
    emit({"phase": "train_moe", "model": "moe_transformer",
          "config": "gpt2.yaml", "batch": 8, "seq": MOE_SEQ,
          "flops_per_token": _moe_model().flops_per_token(),
          "params": _moe_model().num_params(), **runs})
    return ((_sum_counts(launches), _sum_designs(designs)),
            os.path.join(tmp, "train_moe_fused", "default"))


def _sum_counts(counts: list) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _sum_designs(designs: list) -> dict:
    return {k: {d: sum(ds[k][d] for ds in designs) for d in designs[0][k]}
            for k in designs[0]}


def _moe_layer_run(mlp: dict, x: torch.Tensor, cfg, dt, routed: bool):
    """One MoE layer with its residual, ``x + moe(layer_norm(x))``, in
    ``dt``: (output, aux, loss = mean square of the output, gradients of
    the loss by x, router, wi, wo, in f32)."""
    from distributed_training_tpu_torch.models import transformer as tf

    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              {"x": x, **mlp}.items()}
    xd = leaves["x"].to(dt)
    h = F.layer_norm(xd.float(), (xd.shape[-1],), eps=1e-5).to(dt)
    fn = tf._moe_mlp_routed if routed else tf._moe_mlp_dense
    out, aux = fn(h, {k: leaves[k] for k in mlp}, cfg)
    loss = ((xd + out).float() ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (out.detach().float(), float(aux), float(loss),
            dict(zip(leaves, grads)))


def phase_moe_parity() -> None:
    """One MoE layer of moe_transformer at full width (B 8, S 512, the
    init's scales), on the card: the f32 routed dispatch against the
    dense one at ample capacity, then the bf16 routed layer against its
    f32 run."""
    import dataclasses

    cfg = _moe_model().cfg
    B, D, E, Fw = 8, cfg.d_model, cfg.moe_num_experts, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    std = 0.02
    mlp = {"router": normal(D, E, std=std), "wi": normal(E, D, Fw, std=std),
           "wo": normal(E, Fw, D, std=std / (2 * cfg.n_layers) ** 0.5)}
    x = normal(B, MOE_SEQ, D)
    ample = dataclasses.replace(cfg, moe_capacity_factor=E / cfg.moe_top_k)
    f32 = torch.float32
    routed = _moe_layer_run(mlp, x, ample, f32, True)
    dense = _moe_layer_run(mlp, x, ample, f32, False)
    out_err = float((routed[0] - dense[0]).abs().max()
                    / dense[0].abs().max())
    aux_err = abs(routed[1] - dense[1]) / dense[1]
    grad_err = {k: float((routed[3][k] - dense[3][k]).abs().max()
                         / dense[3][k].abs().max()) for k in dense[3]}
    bf16 = _moe_layer_run(mlp, x, cfg, torch.bfloat16, True)
    want = _moe_layer_run(mlp, x, cfg, f32, True)
    loss_rel = abs(bf16[2] - want[2]) / abs(want[2])
    norm_rel = {k: float(abs(bf16[3][k].norm() - want[3][k].norm())
                         / want[3][k].norm()) for k in want[3]}

    def global_norm(grads):
        return torch.stack([grads[k].norm() for k in mlp]).norm()
    # The training parity phase's reading: the global norm of the
    # weights' gradients (each leaf's is reported beside it).
    gnorm_rel = float(abs(global_norm(bf16[3]) - global_norm(want[3]))
                      / global_norm(want[3]))
    emit({"phase": "moe_parity", "shape": [B, MOE_SEQ, D], "experts": E,
          "top_k": cfg.moe_top_k,
          "f32_routed_vs_dense": {"capacity_factor": E / cfg.moe_top_k,
                                  "out_rel_err": out_err,
                                  "aux": [routed[1], dense[1]],
                                  "aux_rel_err": aux_err,
                                  "grad_rel_err": grad_err},
          "bf16_vs_f32_routed": {"capacity_factor": cfg.moe_capacity_factor,
                                 "loss": [bf16[2], want[2]],
                                 "loss_rel_diff": loss_rel,
                                 "aux": [bf16[1], want[1]],
                                 "grad_norm_rel_diff": gnorm_rel,
                                 "leaf_grad_norm_rel_diff": norm_rel},
          "tol": MOE_PARITY_TOL, "grad_tol": MOE_PARITY_GRAD_TOL,
          "bf16_loss_rtol": TRAIN_BF16_PARITY_RTOL,
          "bf16_grad_norm_rtol": TRAIN_BF16_GRAD_NORM_RTOL})
    check(out_err <= MOE_PARITY_TOL and aux_err <= MOE_PARITY_TOL,
          f"moe_parity: routed vs dense outputs {out_err}, aux {aux_err}")
    check(all(e <= MOE_PARITY_GRAD_TOL for e in grad_err.values()),
          f"moe_parity: routed vs dense gradients {grad_err}")
    check(loss_rel <= TRAIN_BF16_PARITY_RTOL
          and gnorm_rel <= TRAIN_BF16_GRAD_NORM_RTOL,
          f"moe_parity: bf16 vs f32 loss {loss_rel}, norm {gnorm_rel}")


def _moe_trainer(rt, strategy: str):
    """A Trainer on moe_transformer / conf/train/gpt2.yaml at sequence 512
    for TRAIN_MOE_EP2_STEPS steps of a global batch of 8 under
    ``strategy`` over ``rt`` (8 / data shards rows a process), with
    MOE_EP2_OVERRIDES, and its loader."""
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.train.trainer import Trainer

    steps, batch = TRAIN_MOE_EP2_STEPS, 8 // rt.data_shard_count
    cfg = load_config(overrides=[
        "model=gpt2_125m", "train=gpt2", *MOE_OVERRIDES,
        f"train.batch_size={batch}", f"train.dataset_size={steps * 8}",
        f"train.total_steps={steps}", "train.total_epochs=1",
        "train.log_every=0", f"train.parallel_strategy={strategy}",
        *MOE_EP2_OVERRIDES])
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
    return Trainer(cfg, rt, model, loader), loader


def _experts_unreduced(real):
    """``fsdp.reduce_scatter_dims`` with each expert leaf's gradient
    (E, D, F) or (E, F, D) cut to this process's shard unsummed: the
    planted fault of train_moe_ep2."""
    import torch.distributed as dist

    cfg = _moe_model().cfg

    def cut(fulls, dims, group):
        out = real(fulls, dims, group)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        for i, (g, d) in enumerate(zip(fulls, dims)):
            if (g.dim() == 3 and g.shape[0] == cfg.moe_num_experts
                    and cfg.d_ff in g.shape):
                a = g.shape[d] // n
                out[i] = g.narrow(d, r * a, a).contiguous()
        return out
    return cut


def train_moe_ep2_rank(rank: int, port: int, out_path: str) -> int:
    """One of phase train_moe_ep2's two processes: on ``cuda:0``, in a
    gloo group of 2 over ``127.0.0.1:port``, a runtime over the mesh
    fsdp 2 built here, the sound run then the planted fault's, under the
    split backward and MOE_EP2_OVERRIDES; writes its readings to
    ``out_path``."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.parallel import fsdp
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    real = fsdp.reduce_scatter_dims
    try:
        rt = slice_runtime([MeshSpec(fsdp=2)], torch.device("cuda", 0))
        result = {"rank": rank, "describe": rt.describe()}
        for run in ("sound", "fault"):
            trainer, loader = _moe_trainer(rt, "fsdp")
            _free_memory()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            fsdp.TRAFFIC.clear()
            if run == "fault":
                fsdp.reduce_scatter_dims = _experts_unreduced(real)
            fa.FORCE_SPLIT_BWD = True
            try:
                got = _tp2_steps(trainer, loader)
            finally:
                fsdp.reduce_scatter_dims = real
                fa.FORCE_SPLIT_BWD = False
            mlp = trainer.state["params"]["mlp"]
            result[run] = {
                **got, "traffic": dict(fsdp.TRAFFIC),
                "placements": {k: list(pl.splits) for k, pl in
                               trainer.layout["params"].items()
                               if k.startswith("mlp/") and pl is not None},
                "local_shapes": {k: list(v.shape) for k, v in mlp.items()},
                "launches": _read_counts(),
                "launches_by_design": _read_designs(),
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            del trainer, loader
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def phase_train_moe_ep2(tmp: str) -> tuple:
    """moe_transformer at full width under ``fsdp`` at fsdp 2, the
    experts split 4 a process (expert parallelism), in two processes on
    ``cuda:0`` over gloo, against world 1 on the same batches, both
    under the split backward and MOE_EP2_OVERRIDES; the planted fault
    (the expert leaves' gradients unsummed over fsdp) must fall outside
    the limits."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.runtime import Runtime

    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    trainer, loader = _moe_trainer(Runtime(device=torch.device("cuda", 0)),
                                   "ddp")
    fa.FORCE_SPLIT_BWD = True
    try:
        want = _tp2_steps(trainer, loader)
    finally:
        fa.FORCE_SPLIT_BWD = False
    want["peak"] = torch.cuda.max_memory_allocated()
    del trainer, loader
    _free_memory()
    port = _free_port()
    outs = [os.path.join(tmp, f"train_moe_ep2.rank{r}.json")
            for r in range(2)]
    logs = [open(os.path.join(tmp, f"train_moe_ep2.rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-moe-ep2-rank",
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
                print(f"train_moe_ep2 rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"train_moe_ep2: ranks exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    steps = TRAIN_MOE_EP2_STEPS
    L = _moe_model().cfg.n_layers
    readings = {}
    for run in ("sound", "fault"):
        got = ranks[0][run]
        check(len(got["losses"]) == len(want["losses"]) == steps,
              f"train_moe_ep2 {run}: {got['losses']} vs {want['losses']}")
        readings[run] = {
            "loss_rel_diff": _rel_diffs(got["losses"], want["losses"]),
            "grad_norm_rel_diff": _rel_diffs(got["grad_norms"],
                                             want["grad_norms"]),
            "moe_aux_rel_diff": _rel_diffs(got["moe_aux"], want["moe_aux"])}
        readings[run]["within"] = (
            readings[run]["loss_rel_diff"] <= EP_LOSS_RTOL
            and readings[run]["grad_norm_rel_diff"] <= EP_GRAD_NORM_RTOL)
    per_rank = [{
        "rank": r["rank"], "describe": r["describe"],
        "losses": r["sound"]["losses"], "moe_aux": r["sound"]["moe_aux"],
        "grad_norms": r["sound"]["grad_norms"],
        "median_step_s": float(np.median(r["sound"]["step_s"][1:])),
        "median_sync_s": float(np.median(r["sound"]["sync_s"][1:])),
        "peak_mem_bytes": r["sound"]["peak_mem_bytes"],
        "placements": r["sound"]["placements"],
        "local_shapes": r["sound"]["local_shapes"],
        "gathered_bytes_per_step":
            r["sound"]["traffic"]["gathered_bytes"] / steps,
        "reduce_scattered_bytes_per_step":
            r["sound"]["traffic"]["reduce_scattered_bytes"] / steps,
        "launches": r["sound"]["launches"],
        "launches_by_design": r["sound"]["launches_by_design"],
        "fault_losses": r["fault"]["losses"],
        "fault_grad_norms": r["fault"]["grad_norms"]} for r in ranks]
    emit({"phase": "train_moe_ep2", "model": "moe_transformer",
          "strategy": "fsdp", "mesh": {"fsdp": 2}, "backend": "gloo",
          "processes_on_card": 2, "batch": 8, "seq": MOE_SEQ,
          "steps": steps, "split_backward": True,
          "overrides": list(MOE_EP2_OVERRIDES), "wall_s": wall,
          "world1_losses": want["losses"],
          "world1_grad_norms": want["grad_norms"],
          "world1_moe_aux": want["moe_aux"],
          "world1_median_step_s": float(np.median(want["step_s"][1:])),
          "world1_peak_mem_bytes": want["peak"],
          "loss_rtol": EP_LOSS_RTOL, "grad_norm_rtol": EP_GRAD_NORM_RTOL,
          "fault": "expert leaves' gradients unsummed over fsdp",
          "readings": readings, "ranks": per_rank})
    E = _moe_model().cfg.moe_num_experts
    for r in per_rank:
        check(r["losses"] == per_rank[0]["losses"]
              and r["grad_norms"] == per_rank[0]["grad_norms"],
              "train_moe_ep2: the two ranks report different metrics")
        check(r["local_shapes"]["wi"][1] == E // 2
              and r["local_shapes"]["wo"][1] == E // 2,
              f"train_moe_ep2: experts not split {r['local_shapes']}")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(r["launches"][name] == L * steps,
                  f"train_moe_ep2: rank {r['rank']} {name} launches "
                  f"{r['launches'][name]}")
    check(readings["sound"]["within"],
          f"train_moe_ep2: fsdp 2 against world 1 outside the limits: "
          f"{readings}")
    check(not readings["fault"]["within"],
          f"train_moe_ep2: the planted fault passed the limits: {readings}")
    return (_sum_counts([r["launches"] for r in per_rank]),
            _sum_designs([r["launches_by_design"] for r in per_rank]))


def phase_generate_moe(run_dir: str) -> tuple:
    """generate.py on train_moe's checkpoint: greedy ``--decode paged``
    falls back to the fused decode for MoE (the serving engine has none);
    its prompt of 128 ids takes B1 once a layer."""
    ids = np.random.default_rng(SEED).integers(
        0, _moe_model().cfg.vocab_size, GEN_PROMPT_BYTES)
    report = _last_json(_run_module([
        "distributed_training_tpu_torch.generate", "--run-dir", run_dir,
        "--prompt-ids", ",".join(str(int(i)) for i in ids),
        "-n", str(GEN_TOKENS), "--decode", "paged", "--json"]))
    launches = _subprocess_launches(report["kernel_launches"])
    L = _moe_model().cfg.n_layers
    emit({"phase": "generate_moe", "decode": report["decode"],
          "prompt_tokens": report["prompt_tokens"],
          "new_tokens": len(report["tokens"]),
          "seconds": report["seconds"],
          "tokens_per_s": report["tokens_per_s"],
          "launches": launches[0], "launches_by_design": launches[1]})
    check(report["decode"] == "fused",
          f"generate_moe: decode {report['decode']}, not the fused fallback")
    check(len(report["tokens"]) == GEN_TOKENS
          and all(0 <= t < _moe_model().cfg.vocab_size
                  for t in report["tokens"]),
          f"generate_moe: tokens {report['tokens']}")
    check(launches[0]["flash_fwd"] == L and launches[0]["paged_decode"] == 0,
          f"generate_moe: launches {launches[0]}")
    return launches


# -- ResNet-18 (BASELINE.json config 2) ---------------------------------------


def _resnet(dtype: str = "bfloat16", device="cuda"):
    from distributed_training_tpu_torch.models.registry import build_model

    return build_model("resnet18", num_classes=10, dtype=dtype, device=device)


def phase_train_resnet18(tmp: str) -> tuple:
    """ResNet-18 at full width through the trainer CLI on ``cuda:0``:
    JAX's resnet18_ddp configuration (RESNET_OVERRIDES) for one epoch of
    RESNET_STEPS steps, saved, then resumed for a second epoch, then
    ``eval.py --run-dir`` on the run in a subprocess. No flash or paged
    kernel is on ResNet's path: every launch count must stay 0. Returns
    the launches of both runs and of eval.py."""
    from distributed_training_tpu_torch.models import resnet
    from distributed_training_tpu_torch.train import cli
    from distributed_training_tpu_torch.train.optimizer import flatten

    out = os.path.join(tmp, "train_resnet18")
    model = _resnet()
    params = sum(math.prod(s) for s in flatten(model.param_shapes()).values())
    flops = model.flops_per_sample() * RESNET_BATCH
    runs, launches, designs = {}, [], []
    for name, epochs in (("epoch_1", 1), ("resumed", 2)):
        _free_memory()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _reset_counts()
        resnet.LAYOUTS.clear()
        t0 = time.perf_counter()
        check(cli.main([*RESNET_OVERRIDES, "train.dtype=bfloat16",
                        f"train.total_epochs={epochs}", "train.save_every=1",
                        "train.log_every=1", "run.log_level=WARNING",
                        f"run.output_dir={out}"]) == 0,
              f"train_resnet18 {name} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(_read_counts())
        designs.append(_read_designs())
        rows = _metrics_rows(out)[(epochs - 1) * RESNET_STEPS:]
        losses = [r["loss"] for r in rows]
        check(len(losses) == RESNET_STEPS,
              f"train_resnet18 {name}: {len(losses)} rows")
        check(all(math.isfinite(x) for x in losses),
              f"train_resnet18 {name}: non-finite loss {losses}")
        step_s = float(np.median([1.0 / r["steps_per_sec"]
                                  for r in rows[3:]]))
        runs[name] = {
            "steps": len(rows), "first_step": rows[0]["step"],
            "wall_s": wall, "median_step_s": step_s,
            "images_per_s": RESNET_BATCH / step_s,
            "mfu": flops / step_s / PEAK_FLOPS[torch.bfloat16],
            "mfu_logged_median": float(np.median(
                [r.get("mfu", float("nan")) for r in rows[3:]])),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            # What earlier phases still hold is in the peak: the run's
            # own is the difference.
            "held_before_bytes": held,
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses, "conv_input_layouts": dict(resnet.LAYOUTS),
            "launches": launches[-1]}
    events = _events(out)
    devices = {e["device"] for e in events if e["kind"] == "runtime"}
    resumes = [e for e in events if e["kind"] == "resume"]
    run_dir = os.path.join(out, "default")
    report = _last_json(_run_module([
        "distributed_training_tpu_torch.eval", "--run-dir", run_dir]))
    eval_launches = _subprocess_launches(report["kernel_launches"])
    every = runs["epoch_1"]["losses"] + runs["resumed"]["losses"]
    emit({"phase": "train_resnet18", "model": "resnet18",
          "config": "benchmarks/run.py resnet18_ddp", "params": params,
          "batch": RESNET_BATCH, "image": [32, 32, 3], "dtype": "bfloat16",
          "flops_per_sample": model.flops_per_sample(),
          "devices": sorted(devices),
          "resume": [{k: e.get(k) for k in ("step", "epoch")}
                     for e in resumes],
          "first_rows_mean": float(np.mean(every[:5])),
          "last_rows_mean": float(np.mean(every[-5:])),
          **runs, "eval": {k: report[k] for k in
                           ("loss", "tokens", "batches", "step", "seconds")},
          "eval_launches": eval_launches[0]})
    check(params == 11_172_170, f"train_resnet18: {params} params")
    check(len(devices) == 1 and next(iter(devices)).startswith("cuda"),
          f"train_resnet18: runtime devices {devices}")
    check(len(resumes) == 1 and resumes[0]["step"] == RESNET_STEPS
          and runs["resumed"]["first_step"] == RESNET_STEPS + 1,
          f"train_resnet18: resume events {resumes}")
    check(np.mean(every[:5]) > np.mean(every[-5:]),
          f"train_resnet18: losses not falling {every}")
    check(math.isfinite(report["loss"])
          and report["step"] == 2 * RESNET_STEPS,
          f"train_resnet18: eval.py reported {report}")
    for name, run in runs.items():
        check(run["conv_input_layouts"].get("other", 0) == 0,
              f"train_resnet18 {name}: conv inputs "
              f"{run['conv_input_layouts']}")
    for counts in (*launches, eval_launches[0]):
        check(all(n == 0 for n in counts.values()),
              f"train_resnet18: a flash or paged kernel ran: {counts}")
    return (_sum_counts([*launches, eval_launches[0]]),
            _sum_designs([*designs, eval_launches[1]]))


def _resnet_run(model, params: dict, x, y) -> tuple:
    """(f32 logits on the host, loss, {leaf: f32 gradient on the host})
    of one forward and backward of ``model`` from ``params``."""
    from distributed_training_tpu_torch.train.optimizer import flatten

    flat = flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    loss, _ = model.loss(params, {"x": x, "y": y})
    grads = torch.autograd.grad(loss, list(flat.values()))
    with torch.no_grad():
        logits = model.apply(params, x)
    return (logits.float().cpu(), float(loss.detach()),
            {k: g.float().cpu() for k, g in zip(flat, grads)})


def _leaf_errs(got: dict, want: dict) -> dict:
    """Each leaf's largest difference over its largest magnitude."""
    return {k: float((g.double() - want[k].double()).abs().max()
                     / want[k].double().abs().max()) for k, g in got.items()}


def _worst(errs: dict) -> list:
    k = max(errs, key=errs.get)
    return [errs[k], k]


def _rel(a, b) -> float:
    """|a - b| over |b| for scalars; largest difference over the largest
    magnitude of ``b`` for tensors."""
    if torch.is_tensor(a):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())
    return abs(a - b) / abs(b)


def _gnorm(grads: dict) -> float:
    return float(torch.stack([g.double().norm() for g in grads.values()])
                 .norm())


def phase_resnet_parity() -> None:
    """ResNet-18 at full width on one batch of RESNET_BATCH images from
    one init. f32 on the card (TF32 off, as every port process sets it)
    against the port's CPU run: the logits and the loss within
    RESNET_PARITY_RTOL; the gradients against an f64 run on the card,
    the card's worst leaf error at most RESNET_GRAD_ERR_RATIO times the
    CPU f32 run's (f32 rounding alone parts this model's gradients from
    f64 by about 5e-3 of a leaf's largest, on either device). The same
    f32 run with cuDNN's TF32 allowed is reported beside it. Then bf16
    against f32 on the card, the loss and the global gradient norm
    within RESNET_BF16_LOSS_RTOL and RESNET_BF16_GRAD_NORM_RTOL. A
    planted fault (every 3x3 stride-2 conv padded (1, 1), where XLA pads
    (0, 1)) must fall outside both, at f32 and at bf16."""
    from distributed_training_tpu_torch.models import resnet

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((RESNET_BATCH, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, (RESNET_BATCH,))
    cpu_model = _resnet("float32", "cpu")
    init = cpu_model.init(SEED)
    t0 = time.perf_counter()
    cpu = _resnet_run(cpu_model, init, x, y)
    cpu_s = time.perf_counter() - t0
    f64, f32, bf16 = (_resnet(dt) for dt in ("float64", "float32",
                                             "bfloat16"))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ref = _resnet_run(f64, _tree_to(init, "cuda", torch.float64), x, y)
    card = _resnet_run(f32, _tree_to(init, "cuda"), x, y)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _resnet_run(f32, _tree_to(init, "cuda"), x, y)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    low = _resnet_run(bf16, _tree_to(init, "cuda"), x, y)
    same_pads = resnet._same_pads
    resnet._same_pads = lambda size, k, stride: (k // 2, k // 2)
    try:
        fault = {"f32": _resnet_run(f32, _tree_to(init, "cuda"), x, y),
                 "bf16": _resnet_run(bf16, _tree_to(init, "cuda"), x, y)}
    finally:
        resnet._same_pads = same_pads
    cpu_err = _worst(_leaf_errs(cpu[2], ref[2]))

    def f32_reading(run):
        err = _worst(_leaf_errs(run[2], ref[2]))
        out = {"logits_vs_cpu": _rel(run[0], cpu[0]),
               "loss_vs_cpu": _rel(run[1], cpu[1]),
               "grad_err_vs_f64": err, "grad_err_ratio": err[0] / cpu_err[0]}
        out["within"] = (out["logits_vs_cpu"] <= RESNET_PARITY_RTOL
                         and out["loss_vs_cpu"] <= RESNET_PARITY_RTOL
                         and out["grad_err_ratio"] <= RESNET_GRAD_ERR_RATIO)
        return out

    def bf16_reading(run):
        out = {"loss": [run[1], card[1]],
               "loss_rel_diff": _rel(run[1], card[1]),
               "grad_norm": [_gnorm(run[2]), _gnorm(card[2])],
               "grad_norm_rel_diff": _rel(_gnorm(run[2]), _gnorm(card[2]))}
        out["within"] = (out["loss_rel_diff"] <= RESNET_BF16_LOSS_RTOL
                         and out["grad_norm_rel_diff"]
                         <= RESNET_BF16_GRAD_NORM_RTOL)
        return out

    readings = {"f32": f32_reading(card), "tf32": f32_reading(tf32),
                "f32_fault": f32_reading(fault["f32"]),
                "bf16": bf16_reading(low),
                "bf16_fault": bf16_reading(fault["bf16"])}
    emit({"phase": "resnet_parity", "batch": RESNET_BATCH,
          "tf32_flags_on_card": {"matmul": flags[0], "cudnn": flags[1]},
          "cpu_s": cpu_s, "cpu_f32_grad_err_vs_f64": cpu_err,
          "f64_loss": ref[1], "rtol": RESNET_PARITY_RTOL,
          "grad_err_ratio": RESNET_GRAD_ERR_RATIO,
          "bf16_loss_rtol": RESNET_BF16_LOSS_RTOL,
          "bf16_grad_norm_rtol": RESNET_BF16_GRAD_NORM_RTOL,
          "fault": "3x3 stride-2 convs padded (1, 1)", **readings})
    check(flags == (False, False), f"resnet_parity: TF32 flags {flags}")
    check(readings["f32"]["within"],
          f"resnet_parity: f32 card outside the limits {readings['f32']}")
    check(readings["bf16"]["within"],
          f"resnet_parity: bf16 outside the limits {readings['bf16']}")
    check(not readings["f32_fault"]["within"]
          and not readings["bf16_fault"]["within"],
          f"resnet_parity: the planted fault passed the limits {readings}")


def _tree_to(tree: dict, device, dtype=None) -> dict:
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict)
            else v.detach().to(device, dtype) for k, v in tree.items()}


def _resnet_trainer(rt, strategy: str):
    """A Trainer on ResNet-18 at f32 for RESNET_DP2_STEPS steps of a
    global batch of RESNET_BATCH (RESNET_OVERRIDES otherwise) under
    ``strategy`` over ``rt``, and its loader."""
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.train.trainer import Trainer

    batch = RESNET_BATCH // rt.data_shard_count
    cfg = load_config(overrides=[
        *RESNET_OVERRIDES, "train.dtype=float32",
        f"train.dataset_kwargs.size={RESNET_DP2_STEPS * RESNET_BATCH}",
        f"train.batch_size={batch}", "train.total_epochs=1",
        "train.log_every=0", f"train.parallel_strategy={strategy}"])
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
    return Trainer(cfg, rt, model, loader), loader


def train_resnet_dp2_rank(rank: int, port: int, out_path: str,
                          strategies: str) -> int:
    """One of phase train_resnet_dp2's two processes: on ``cuda:0``, in a
    gloo group of 2 over ``127.0.0.1:port``, for each of the
    comma-separated ``strategies`` a runtime over the mesh dp 2
    (``ddp``) or fsdp 2 (``fsdp``) built here and its sound run, and
    under ``ddp`` then the planted fault's (every gradient unsummed);
    writes its readings to ``out_path``."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.parallel import fsdp
    from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime
    from distributed_training_tpu_torch.train.optimizer import flatten

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        result = {"rank": rank}
        # The fault run patches the collectives for good: ddp runs last.
        for strategy in sorted(strategies.split(","), key="ddp".__eq__):
            spec = MeshSpec(fsdp=2) if strategy == "fsdp" else MeshSpec(dp=2)
            rt = slice_runtime([spec], torch.device("cuda", 0))
            runs = {"describe": rt.describe()}
            for run in (("sound", "fault") if strategy == "ddp"
                        else ("sound",)):
                events = f"{out_path}.{strategy}.events.jsonl"
                with (_event_sink(events, rank) if run == "sound"
                      else contextlib.nullcontext()):
                    trainer, loader = _resnet_trainer(rt, strategy)
                    _free_memory()
                    torch.cuda.reset_peak_memory_stats()
                    _reset_counts()
                    fsdp.TRAFFIC.clear()
                    if run == "fault":
                        _unsynced_grads()
                    t0 = time.perf_counter()
                    got = _tp2_steps(trainer, loader)
                runs[run] = {
                    **got, "wall_s": time.perf_counter() - t0,
                    "traffic": dict(fsdp.TRAFFIC),
                    "placements": {k: list(pl.splits) for k, pl in
                                   trainer.layout["params"].items()
                                   if pl is not None},
                    "tf32": [torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32],
                    "launches": _read_counts(),
                    "launches_by_design": _read_designs(),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated()}
                if run == "sound":
                    runs[run]["collectives"] = _collectives_events(events)
                    runs[run]["param_bytes"] = sum(
                        math.prod(s) * 4 for s in
                        flatten(trainer.model.param_shapes()).values())
                del trainer, loader
            result[strategy] = runs
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def _resnet_dp2_world(tmp: str, strategies: str) -> tuple:
    """(both ranks' readings, wall seconds) of one world of 2."""
    port = _free_port()
    outs = [os.path.join(tmp, f"train_resnet_dp2.rank{r}.json")
            for r in range(2)]
    logs = [open(os.path.join(tmp, f"train_resnet_dp2.rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-resnet-dp2-rank",
         str(r), str(port), outs[r], strategies], stdout=logs[r],
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
                print(f"train_resnet_dp2 rank {r}:\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(codes == [0, 0], f"train_resnet_dp2: ranks exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks, wall


def _check_resnet_dp2_collectives(both: list, steps: int) -> None:
    """train_resnet_dp2's ``collectives`` events (the first step's, from
    rank 0 alone) against the leaves' bytes and the phase's counts:
    under ddp every collective an all-reduce over dp, the largest the
    whole gradient (every f32 leaf); under fsdp every one over fsdp, the
    all-gathers the whole tensors ``fsdp.TRAFFIC`` counts in a step and
    the reduce-scatters their shards (half)."""
    out = {}
    for strategy, axis in (("ddp", "dp"), ("fsdp", "fsdp")):
        events = [r[strategy]["sound"]["collectives"] for r in both]
        check([len(e) for e in events] == [1, 0],
              f"train_resnet_dp2 {strategy}: collectives events per rank "
              f"{[len(e) for e in events]}")
        ev = events[0][0]
        sound = both[0][strategy]["sound"]
        out[strategy] = {k: ev[k] for k in (
            "total_collectives", "bytes_per_step", "by_kind", "by_axis",
            "mesh")}
        out[strategy]["param_bytes"] = sound["param_bytes"]
        check(ev["mesh"] == {axis: 2} and set(ev["by_axis"]) == {axis},
              f"train_resnet_dp2 {strategy}: {ev['mesh']} {ev['by_axis']}")
        kinds = ev["by_kind"]
        if strategy == "ddp":
            check(set(kinds) == {"all-reduce"}
                  and max(r["bytes"] for r in ev["rows"])
                  == sound["param_bytes"],
                  f"train_resnet_dp2 ddp: {kinds} against "
                  f"{sound['param_bytes']} param bytes")
        else:
            traffic = sound["traffic"]
            check(kinds["all-gather"]["bytes"] * steps
                  == traffic["gathered_bytes"]
                  and 2 * kinds["reduce-scatter"]["bytes"] * steps
                  == traffic["reduce_scattered_bytes"],
                  f"train_resnet_dp2 fsdp: {kinds} against {traffic} over "
                  f"{steps} steps")
    emit({"phase": "train_resnet_dp2_collectives", **out})


def phase_train_resnet_dp2(tmp: str) -> tuple:
    """ResNet-18 at full width and f32 in two processes on ``cuda:0``
    over gloo, under ``ddp`` (dp 2) and ``fsdp`` (fsdp 2), against world
    1 on the same global batches (TF32 off in every process); the
    planted fault (every gradient left unsummed) must fall outside the
    limits."""
    from distributed_training_tpu_torch.runtime import Runtime

    _free_memory()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    trainer, loader = _resnet_trainer(Runtime(device=torch.device("cuda", 0)),
                                      "ddp")
    want = _tp2_steps(trainer, loader)
    want["peak"] = torch.cuda.max_memory_allocated()
    del trainer, loader
    _free_memory()
    steps = RESNET_DP2_STEPS
    readings, per_strategy, counts, designs = {}, {}, [], []
    both, wall = _resnet_dp2_world(tmp, "ddp,fsdp")
    for strategy in ("ddp", "fsdp"):
        ranks = [r[strategy] for r in both]
        for run in [r for r in ("sound", "fault") if r in ranks[0]]:
            got = ranks[0][run]
            check(len(got["losses"]) == len(want["losses"]) == steps,
                  f"train_resnet_dp2 {strategy} {run}: {got['losses']}")
            d = {"first_grad_norm_rel_diff": _rel(got["grad_norms"][0],
                                                  want["grad_norms"][0]),
                 "loss_rel_diff": _rel_diffs(got["losses"], want["losses"]),
                 "grad_norm_rel_diff": _rel_diffs(got["grad_norms"],
                                                  want["grad_norms"])}
            d["within"] = (d["first_grad_norm_rel_diff"]
                           <= RESNET_DP2_FIRST_NORM_RTOL
                           and d["loss_rel_diff"] <= RESNET_DP2_LOSS_RTOL
                           and d["grad_norm_rel_diff"]
                           <= RESNET_DP2_GRAD_NORM_RTOL)
            readings[f"{strategy}_{run}"] = d
        sound = [r["sound"] for r in ranks]
        per_strategy[strategy] = {
            "wall_s": [s["wall_s"] for s in sound],
            "describe": [r["describe"] for r in ranks],
            "losses": sound[0]["losses"], "grad_norms": sound[0]["grad_norms"],
            "median_step_s": [float(np.median(s["step_s"][1:]))
                              for s in sound],
            "median_sync_s": [float(np.median(s["sync_s"][1:]))
                              for s in sound],
            "peak_mem_bytes": [s["peak_mem_bytes"] for s in sound],
            "tf32": [s["tf32"] for s in sound],
            "gathered_bytes_per_step": [
                s["traffic"].get("gathered_bytes", 0) / steps for s in sound],
            "reduce_scattered_bytes_per_step": [
                s["traffic"].get("reduce_scattered_bytes", 0) / steps
                for s in sound],
            "placements": sound[0]["placements"],
            "launches": [s["launches"] for s in sound]}
        if "fault" in ranks[0]:
            per_strategy[strategy]["fault_losses"] = ranks[0]["fault"][
                "losses"]
            per_strategy[strategy]["fault_grad_norms"] = ranks[0]["fault"][
                "grad_norms"]
        for s in sound:
            check(s["losses"] == sound[0]["losses"]
                  and s["grad_norms"] == sound[0]["grad_norms"],
                  f"train_resnet_dp2 {strategy}: the ranks disagree")
            check(s["tf32"] == [False, False],
                  f"train_resnet_dp2 {strategy}: TF32 flags {s['tf32']}")
            counts.append(s["launches"])
            designs.append(s["launches_by_design"])
    emit({"phase": "train_resnet_dp2", "model": "resnet18",
          "backend": "gloo", "processes_on_card": 2, "wall_s": wall,
          "batch": RESNET_BATCH, "steps": steps, "dtype": "float32",
          "world1_losses": want["losses"],
          "world1_grad_norms": want["grad_norms"],
          "world1_median_step_s": float(np.median(want["step_s"][1:])),
          "world1_peak_mem_bytes": want["peak"],
          "world1_held_before_bytes": held,
          "first_grad_norm_rtol": RESNET_DP2_FIRST_NORM_RTOL,
          "loss_rtol": RESNET_DP2_LOSS_RTOL,
          "grad_norm_rtol": RESNET_DP2_GRAD_NORM_RTOL,
          "fault": "ddp with every gradient unsummed",
          "readings": readings, **per_strategy})
    fsdp_pl = per_strategy["fsdp"]["placements"]
    check(per_strategy["ddp"]["placements"] == {}
          and "stem/w" not in fsdp_pl
          and "stage0/0/gn1/scale" not in fsdp_pl
          and fsdp_pl.get("stage3/1/conv2") == [[2, ["fsdp"]]],
          f"train_resnet_dp2: placements {fsdp_pl}")
    check(all(n == 0 for c in counts for n in c.values()),
          f"train_resnet_dp2: a flash or paged kernel ran: {counts}")
    _check_resnet_dp2_collectives(both, steps)
    for name in ("ddp_sound", "fsdp_sound"):
        check(readings[name]["within"],
              f"train_resnet_dp2: {name} outside the limits: {readings}")
    check(not readings["ddp_fault"]["within"],
          f"train_resnet_dp2: the planted fault passed the limits: "
          f"{readings}")
    return _sum_counts(counts), _sum_designs(designs)


def main() -> int:
    if sys.argv[1:2] == ["--train-resnet-dp2-rank"]:
        return train_resnet_dp2_rank(int(sys.argv[2]), int(sys.argv[3]),
                                     sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--train-tp2-rank"]:
        return train_tp2_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
    if sys.argv[1:2] == ["--train-sp2-rank"]:
        return train_sp2_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5], int(sys.argv[6]))
    if sys.argv[1:2] == ["--train-pp2-rank"]:
        return train_pp2_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--train-moe-ep2-rank"]:
        return train_moe_ep2_rank(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4])
    if sys.argv[1:2] == ["--train-elastic-rank"]:
        return train_elastic_rank(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4], sys.argv[5],
                                  control=sys.argv[6:7] == ["control"])
    if sys.argv[1:2] == ["--serving-mesh-rank"]:
        return serving_mesh_rank(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4], sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import distributed_training_tpu_torch  # noqa: F401 — needs the repo

    # A bytecode cache for the processes this script starts: the chip
    # machine's Python writes none (PYTHONDONTWRITEBYTECODE) and its
    # packages ship none, so every child compiled torch's sources again.
    # Under the prefix the first child writes the cache and the others
    # read it; it goes with this directory.
    with tempfile.TemporaryDirectory(prefix="dtt_chip_smoke_pyc_") as pyc:
        os.environ["PYTHONPYCACHEPREFIX"] = pyc
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        return _smoke()


def _smoke() -> int:
    """Every phase of the smoke, in order; the last line is the
    contract's."""
    device = phase_device()
    phase_build()
    phase_native()
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
    phase_trace(prompts, TRACE_NEW_TOKENS)
    phase_trace_resident(prompts, TRACE_NEW_TOKENS)
    with tempfile.TemporaryDirectory(prefix="dtt_chip_smoke_") as tmp:
        mesh_launches = {name: phase_serving_mesh(name, prompts, batched, tmp)
                         for name in SERVING_MESHES}
        plan_launches = phase_plan(device)
        audit_launches = phase_audit()
        phase_calibrate(device)
        recovery_launches = phase_serving_recovery(prompts, tmp)
        disagg_launches = phase_serving_disagg(prompts, 64, tmp)
        cli_launches = phase_serving_cli(prompts, 64, batched, tmp)
        train_launches = phase_train(tmp)
        split_launches = phase_train_split(tmp)
        slice16 = {"train_telemetry": phase_train_telemetry(tmp)}
        phase_train_watchdog(tmp)
        slice16["train_dropout"] = phase_train_dropout(tmp)
        phase_train_parity(tmp)
        phase_train_bf16_parity(tmp)
        train_1b_launches, rows_1b = phase_train_1b(tmp)
        tp_1b_launches = phase_train_tp_1b(tmp, rows_1b)
        tp2_launches = phase_train_tp2(tmp)
        phase_train_fsdp_ckpt(tmp)
        phase_train_mlp(tmp)
        corpus = _byte_corpus(tmp)
        slice14 = phase_train_bytes_lm(tmp, corpus)
        slice14["adafactor"] = phase_adafactor(tmp, corpus)
        phase_launch_playground(tmp)
        slice15 = {"train_supervised": phase_train_supervised(tmp, corpus)}
        slice15["train_preempt_stream"], ref = phase_train_preempt_stream(
            tmp, corpus)
        slice15["train_elastic"] = phase_train_elastic(tmp, corpus, ref)
        slice17 = {"train_sp2_ring": phase_train_sp2(tmp, "ring"),
                   "train_sp2_ulysses": phase_train_sp2(tmp, "ulysses"),
                   "train_sp2_ring_window": phase_train_sp2(
                       tmp, "ring", window=SP2_WINDOW)}
        world1 = _pp_world1()
        slice18 = {f"train_pp2_{s}": phase_train_pp2(tmp, s, world1)
                   for s in ("gpipe", "interleaved")}
        moe_launches, moe_run = phase_train_moe(tmp)
        phase_moe_parity()
        # train_moe_ep2 runs f32 (MOE_EP2_OVERRIDES), its launches on the
        # SIMT kernels: a correctness phase, reported beside the paths.
        ep2_launches = phase_train_moe_ep2(tmp)
        slice19 = {"train_moe": moe_launches,
                   "generate_moe": phase_generate_moe(moe_run)}
        # ResNet-18 runs no flash or paged kernel: its launches, all 0,
        # are counted like any other path's.
        slice20 = {"train_resnet18": phase_train_resnet18(tmp)}
        phase_resnet_parity()
        slice20["train_resnet_dp2"] = phase_train_resnet_dp2(tmp)
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
    # under tp at tp 2, serving on the meshes dp 2, tp 2 and fsdp 2: both
    # processes, the plan phase's gate (its planned and unplanned step),
    # the audit phase's headline step;
    # then byte_lm's training, eval.py and generate.py's bf16
    # runs, each in its process, and gpt2_125m under Adafactor; then the
    # resilience paths: the supervised crash-restart, the preempted
    # stream under each backward and the elastic resize; then the observability paths: the
    # telemetry run and the three dropout runs; then sequence parallelism
    # at sp 2: the ring, Ulysses and the windowed ring, both processes'
    # sound runs; then pipeline parallelism at pp 2 under each schedule,
    # both processes' sound and split runs; then MoE: moe_transformer's
    # fused and split runs and generate.py's fused decode on it; then
    # ResNet-18's CLI runs, eval.py and its world-2 runs, where nothing
    # launches).
    paths = (serve_launches, seq_launches, spec_launches, resident_launches,
             int8_launches, swap_launches, recovery_launches, disagg_launches,
             cli_launches,
             *mesh_launches.values(), plan_launches, audit_launches,
             train_launches,
             split_launches,
             train_1b_launches, tp_1b_launches, tp2_launches,
             *slice14.values(), *slice15.values(), *slice16.values(),
             *slice17.values(), *slice18.values(), *slice19.values(),
             *slice20.values())
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
            # The same kernel at train_tp2's geometry (6 heads a rank)
            # and at byte_lm's (B 16, H 8, S 512).
            for case in ("tp2", "byte_lm"):
                kernels[-1][f"{case}_case"] = {
                    k: measured[f"{name}_{case}"][k]
                    for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}
        if name == "flash_bwd_fused":
            # SDPA's backward under the old fixed sleep, beside its device
            # time (library_ms), at gpt2's shape and byte_lm's.
            kernels[-1]["library_ms_fixed_sleep"] = measured[
                "flash_bwd_library_fixed_sleep"]
            kernels[-1]["byte_lm_case"]["library_ms_fixed_sleep"] = \
                measured["flash_bwd_byte_lm_library_fixed_sleep"]
        if name == "flash_fwd":
            # And at generate.py's fused prefill (B 1, H 8, S 128).
            kernels[-1]["generate_case"] = {
                k: measured["flash_fwd_generate"][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}
        # Its launches on the paths of the default config and the real
        # text (train_bytes_lm, eval.py, generate.py, adafactor).
        kernels[-1]["real_text_launches"] = {
            path: counts[name] for path, (counts, _) in slice14.items()}
        # And on the resilience paths (train_supervised: both supervised
        # incarnations; train_preempt_stream: both runs under each
        # backward; train_elastic: both world-2 processes and the world-1
        # resume, not the control).
        kernels[-1]["resilience_launches"] = {
            path: counts[name] for path, (counts, _) in slice15.items()}
        # And on the observability paths (train_telemetry; train_dropout:
        # its fused run and both split reruns).
        kernels[-1]["observability_launches"] = {
            path: counts[name] for path, (counts, _) in slice16.items()}
        # And on the sequence-parallel paths (both processes' sound run).
        kernels[-1]["sequence_parallel_launches"] = {
            path: counts[name] for path, (counts, _) in slice17.items()}
        # And on the pipeline paths (both processes' sound run and both
        # split runs).
        kernels[-1]["pipeline_launches"] = {
            path: counts[name] for path, (counts, _) in slice18.items()}
        # And on the MoE paths (train_moe's fused and split runs,
        # generate_moe), and in train_moe_ep2's f32 sound run (both
        # processes, the SIMT design, not in the total).
        kernels[-1]["moe_launches"] = {
            path: counts[name] for path, (counts, _) in slice19.items()}
        kernels[-1]["moe_ep2_f32_launches_by_design"] = ep2_launches[1].get(
            name, {"simt": ep2_launches[0][name]})
        # And on ResNet-18's paths (train_resnet18's two CLI runs and
        # eval.py; train_resnet_dp2's sound runs, both processes): 0.
        kernels[-1]["resnet_launches"] = {
            path: counts[name] for path, (counts, _) in slice20.items()}
        if name.startswith("flash_"):
            # The same kernel at moe_transformer's shape (B 8, H 8, S
            # 512, D 64).
            kernels[-1]["moe_case"] = {
                k: measured[f"{name}_moe"][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}
            # The same kernel at the pipeline's microbatch shape (B 2, H
            # 12, S 1024, D 64).
            kernels[-1]["pp_microbatch_case"] = {
                k: measured[f"{name}_pp"][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}
        if name.startswith("flash_") and name != "flash_bwd_fused":
            # The ring's blocks at the sp 2 shard: the past block
            # (non-causal) and the diagonal, f32 out or f32 gradients.
            for tag in ("past", "diag"):
                kernels[-1][f"ring_{tag}_case"] = {
                    k: measured[f"{name}_ring_{tag}"][k]
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
            # And at generate.py's paged decode on byte_lm (one slot, 8
            # heads, 12 pages), its first and last decode.
            for at in ("first", "last"):
                kernels[-1][f"generate_{at}_case"] = {
                    k: measured[f"paged_decode_generate_{at}"][k]
                    for k in ("shape", "lengths", "splits", "max_abs_err",
                              "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}
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

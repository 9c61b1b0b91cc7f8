#!/usr/bin/env python
"""On-card smoke run of the PyTorch port (distributed_training_tpu_torch).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``distributed_training_tpu_torch/
csrc/`` (one ``nvcc`` per source, all at once), holds each kernel
against its plain PyTorch version at the serving shapes and times both,
serves gpt2_125m at full width over HTTP through ``Engine`` +
``ServingServer`` (random weights from a seed, batched prefill, paged
decode), runs the sequential prefill whose first chunk takes the flash
kernel, checks float32 greedy tokens against the dense full-context
forward, and traces one serving burst with ``torch.profiler`` (device
busy and idle share, top kernels). Each phase prints one JSON line;
any failure raises and exits non-zero. The last line is ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA card, or without the
repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
SEED = 0


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


def _flash_case(timer, B, H, Hkv, S, D, dtype, window=0, out_dtype=None,
                block_k=0, library=False) -> dict:
    from distributed_training_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    kw = dict(causal=True, window=window, out_dtype=out_dtype)
    o, lse = fa.flash_fwd(q, k, v, block_k=block_k, **kw)
    torch.cuda.synchronize()
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
           "window": window, "out_dtype": str(out_dtype or dtype)
           .split(".")[1], "block_k": block_k or fa.DEFAULT_BLOCK_K,
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


def phase_kernels() -> dict:
    timer = Timer()
    bf16, f32 = torch.bfloat16, torch.float32
    flash = {
        "main": _flash_case(timer, 4, 12, 12, 1024, 64, bf16, library=True),
        "main_block_k32": _flash_case(timer, 4, 12, 12, 1024, 64, bf16,
                                      block_k=32),
        "gqa": _flash_case(timer, 4, 12, 4, 1024, 64, bf16, library=True),
        "window": _flash_case(timer, 4, 12, 12, 1024, 64, bf16,
                              window=256),
        "f32_out": _flash_case(timer, 4, 12, 12, 1024, 64, bf16,
                               out_dtype=f32),
        "f32": _flash_case(timer, 2, 12, 12, 256, 64, f32),
    }
    paged = {"main": _paged_case(timer, 8, 12, 12, 64, 16, 1024, bf16),
             "f32_gqa": _paged_case(timer, 8, 12, 4, 64, 16, 1024, f32)}
    emit({"phase": "kernels", "flash_fwd": flash, "paged_decode": paged})
    return {"flash_fwd": flash["main"], "paged_decode": paged["main"]}


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


def _reset_counts():
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.ops import paged_attention as pa

    fa.flash_fwd.launches = 0
    pa.paged_attention.launches = 0


def _read_counts() -> dict:
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.ops import paged_attention as pa

    return {"flash_fwd": fa.flash_fwd.launches,
            "paged_decode": pa.paged_attention.launches}


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


def phase_serving(prompts: list, new_tokens: int) -> tuple[dict, dict]:
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
        launches = _read_counts()
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
            "compile_counts": counts, "leaked_threads": srv.leaked_threads}
    emit(info)
    return launches, {i: r["tokens"] for i, r in enumerate(plain)}


def phase_sequential(prompts: dict, new_tokens: int,
                     batched_tokens: dict) -> dict:
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
    launches = _read_counts()
    got = {int(r["id"]): r["tokens"] for r in eng.completed}
    check(len(got) == len(prompts), "sequential: not every request done")
    check(launches["flash_fwd"] == 12 * len(prompts),
          f"flash launches {launches['flash_fwd']} != 12 x "
          f"{len(prompts)} first chunks")
    check(launches["paged_decode"] > 0, "sequential: no decode launch")
    check(eng.compile_counts() == counts, "kernel builds after warmup")
    same = sum(int(a == b) for i in got
               for a, b in zip(got[i], batched_tokens[i]))
    emit({"phase": "sequential", "dtype": "bfloat16", "prefill_chunk": 128,
          "requests": len(prompts), "launches": launches,
          "tokens_matching_batched": same,
          "tokens_total": sum(len(t) for t in got.values())})
    return launches


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
    spans, per_name = [], {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            spans.append((e.time_range.start, e.time_range.end))
            tot, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "trace", "dtype": "bfloat16", "requests": len(prompts),
          "wall_us": wall_us, "device_busy_us": busy,
          "device_idle_share": 1.0 - busy / wall_us,
          "decode_launches": eng.decode_launches,
          "prefill_launches": eng.prefill_launches,
          "top_kernels": [{"name": k[:80], "us": v[0], "count": v[1]}
                          for k, v in top]})


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
    sources = {
        "flash_fwd": ("distributed_training_tpu_torch/csrc/flash_fwd.cu",
                      "distributed_training_tpu/ops/flash_attention.py:187"),
        "paged_decode": (
            "distributed_training_tpu_torch/csrc/paged_decode.cu",
            "distributed_training_tpu/ops/paged_attention.py:152")}
    kernels = []
    for name, (src, replaces) in sources.items():
        m = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": serve_launches[name] + seq_launches[name],
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

"""The frozen yardstick against the program as it stands: the FLOP
count, the kernels' bounds (PERF.md's kernel table) and the timeline
arithmetic (``telemetry/kineto.py``)."""

from __future__ import annotations

import json
import math

import pytest

from distributed_training_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu_torch.telemetry import kineto
from portbench import harness
from portbench.yardstick import bounds, flops, timeline


def _program_cfg(run: dict) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=run["vocab_rows"], d_model=run["d_model"],
        n_layers=run["n_layers"], n_heads=run["n_heads"], d_ff=run["d_ff"],
        max_seq_len=run["max_seq_len"], pos_encoding=run["pos_encoding"],
        tie_embeddings=run["tie_embeddings"])


@pytest.mark.parametrize("name", ["gpt2_125m", "transformer_1b"])
def test_flops_match_program_matmul_part(name):
    """The program's 6 N + attention, less 6 x the weights that no matmul
    reads for every token (lookups, norms, biases; the untied embedding)
    is the frozen count."""
    run = harness.load_cell(next(
        w["name"] for w in harness.benchmark()["workloads"]
        if w["config"] == name)).run_cfg
    model = Transformer(_program_cfg(run), device="cpu")
    S = run["max_seq_len"]
    shapes = model.param_shapes()
    not_matmul = sum(math.prod(shapes[k]) for k in ("pos_embed",)
                     if k in shapes)
    not_matmul += sum(math.prod(s) for g in ("ln1", "ln2", "final_norm")
                      for s in shapes[g].values())
    not_matmul += sum(math.prod(shapes["mlp"][k]) for k in ("bi", "bo"))
    if not run["tie_embeddings"]:
        not_matmul += math.prod(shapes["tok_embed"])
    want = model.flops_per_token(S) - 6.0 * not_matmul
    assert flops.train_flops_per_token(run, S) == pytest.approx(want,
                                                                rel=1e-12)


def test_gpt2_step_flops():
    run = harness.load_cell("gpt2_125m.pretrain_b32").run_cfg
    step = flops.train_flops_per_sample(run, 1024) * 32
    assert step == pytest.approx(26.1e12, rel=5e-3)


def test_bounds_match_kernel_table():
    """PERF.md's bound column at B 8, H 12, S 1024, D 64 (B1 0.0151 ms by
    bytes, B2 0.0326 by operations) and B4's main case (0.00254 ms)."""
    import numpy as np

    assert bounds.flash_fwd(8, 12, 1024, 64) * 1e3 == pytest.approx(
        0.0151, abs=5e-5)
    assert bounds.flash_bwd(8, 12, 1024, 64) * 1e3 == pytest.approx(
        0.0326, abs=5e-5)
    lengths = np.random.default_rng(0).integers(1, 1025, size=8)
    lengths[-1] = 0
    assert bounds.paged_decode(lengths, 12, 12, 64, 16) * 1e3 == \
        pytest.approx(0.00254, abs=5e-6)


# Every flash kernel the program's csrc/ defines, with demangled launch
# names as a trace gives them and the part each books under.
FLASH_LAUNCHES = {
    "flash_fwd_sm90_kernel": [
        ("void flash_fwd_sm90_kernel<64, __nv_bfloat16>(__nv_bfloat16 "
         "const*, __nv_bfloat16 const*, int, float)", "fwd")],
    "flash_fwd_kernel": [
        ("void flash_fwd_kernel<float, float, 64, 2>(float const*, int)",
         "fwd")],
    "flash_bwd_dq_sm90_kernel": [
        ("void flash_bwd_dq_sm90_kernel<128, float>(__nv_bfloat16 const*, "
         "float*, int)", "dq")],
    "flash_bwd_dq_kernel": [
        ("void flash_bwd_dq_kernel<float, float, 32, 4>(float const*, "
         "float*)", "dq")],
    "flash_bwd_sm90_kernel": [
        ("void flash_bwd_sm90_kernel<64, __nv_bfloat16, true>("
         "__nv_bfloat16 const*, float*, bool)", "fused"),
        ("void flash_bwd_sm90_kernel<128, float, false>(__nv_bfloat16 "
         "const*, float*, bool)", "dkv"),
        ("void flash_bwd_sm90_kernel<64, float, (bool)0>(float*)", "dkv")],
    "flash_bwd_dkv_kernel": [
        ("void flash_bwd_dkv_kernel<float, float, 64, 2, true>(float "
         "const*, float*)", "fused"),
        ("void flash_bwd_dkv_kernel<__nv_bfloat16, float, 32, 4, false>("
         "__nv_bfloat16 const*, float*)", "dkv")],
}


def _csrc_flash_kernels() -> set:
    import glob
    import os
    import re

    src = os.path.join(harness.ROOT, "distributed_training_tpu_torch",
                       "csrc")
    found = set()
    for path in glob.glob(os.path.join(src, "*.cu")):
        with open(path, encoding="utf-8") as f:
            found |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(flash_\w+)\s*\(", f.read()))
    return found


def test_flash_roofline_books_each_kernel_by_part():
    """Each flash kernel of csrc/ is booked under its own part: B2 (the
    fused backward) and B3b (dk/dv alone) by the template's dq flag."""
    reader = harness.load_module("metrics", "flash_roofline.train")
    assert set(FLASH_LAUNCHES) == _csrc_flash_kernels()
    for launches in FLASH_LAUNCHES.values():
        for name, part in launches:
            assert reader._part(name) == part, name
    assert reader._part("void paged_split_kv_kernel<__nv_bfloat16>("
                        "float*)") is None
    assert bounds.flash_bwd(8, 12, 1024, 64, part="dkv") < \
        bounds.flash_bwd(8, 12, 1024, 64, part="fused")


def _synthetic_trace(path):
    ev = []

    def x(name, cat, ts, dur, tid=1):
        ev.append({"ph": "X", "name": name, "cat": cat, "ts": ts,
                   "dur": dur, "pid": 0, "tid": tid})

    x("gemm", "kernel", 10.0, 5.5)
    x("ncclKernel_AllReduce", "kernel", 14.0, 6.25, tid=2)
    x("gemm2", "kernel", 30.125, 2.0)
    x("memcpy", "gpu_memcpy", 40.0, 1.0)
    x("ncclKernel_AllGather", "kernel", 45.0, 3.0, tid=2)
    x("train_step", "user_annotation", 5.0, 50.0)
    x("aten::mm", "cpu_op", 6.0, 1.0)
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_timeline_matches_kineto(tmp_path):
    path = str(tmp_path / "t.json")
    _synthetic_trace(path)
    device, host = timeline.load(path)
    recs = kineto.load_trace(path)
    events, _, _ = kineto.timeline_events(recs)
    window = (min(h.start_ps for h in host), max(h.end_ps for h in host))
    mine = timeline.attribution(device, window)
    theirs = kineto.attribution_of_events(events, window=window)
    assert mine["busy_s"] == pytest.approx(theirs["busy_s"], abs=1e-12)
    assert mine["compute_s"] == pytest.approx(theirs["compute_s"],
                                              abs=1e-12)
    assert mine["collective_s"] == pytest.approx(theirs["collective_s"],
                                                 abs=1e-12)
    assert mine["exposed_collective_s"] == pytest.approx(
        theirs["collective_s"] - theirs["overlap_s"], abs=1e-12)
    assert mine["window_s"] == pytest.approx(theirs["window_s"], abs=1e-12)

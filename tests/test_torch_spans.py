"""The port's telemetry spans and counters inside the train step, the
fsdp gathers and the serving engine.

- ``span()`` with nothing recording and no profiler running is a shared
  null context: no ``record_function`` is entered; under a running
  profiler each span enters one;
- ``SpanTotals`` (the in-memory sink) keeps per name the count, the total
  and the self seconds, per thread, and named counters; ``reset()``
  clears them;
- a train step opens ``forward``, ``backward`` (once a microbatch) and
  ``optimizer`` (once a step) inside ``step``; under fsdp ``fsdp.gather``
  opens inside ``forward`` and ``fsdp.reduce_scatter`` inside
  ``backward`` (the CPU's autograd engine runs the backward on the
  calling thread);
- each engine step opens ``engine.step`` and ``engine.schedule``, and a
  prefill or decode step its phase span and the phase's four children
  once; ``kv_pages_used`` sums the pool's pages in use at each step's
  start.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.serving import engine as engine_lib
from distributed_training_tpu_torch.telemetry import events
from distributed_training_tpu_torch.train.trainer import Trainer

MODEL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
             max_seq_len=32)
PHASES = ("prepare", "launch", "fetch", "emit")


@pytest.fixture(autouse=True)
def _no_sink():
    events.uninstall()
    yield
    events.uninstall()


class _Counting:
    """``record_function`` entries, counted by name."""

    def __init__(self, real):
        self.real, self.names = real, []

    def __call__(self, name):
        self.names.append(name)
        return self.real(name)


def test_off_span_is_free_and_profiled_span_opens_one_range(monkeypatch):
    counting = _Counting(events._profiled)
    monkeypatch.setattr(events, "_profiled", counting)
    quiet = events.Telemetry(enabled=False)
    for _ in range(3):
        with events.span("off"), quiet.span("off_too"):
            pass
    assert events.span("off") is events.span("other") is events._OFF
    assert counting.names == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with events.span("outer"):
            with quiet.span("inner"):
                pass
        events.install(events.SpanTotals())
        with events.span("kept"):
            pass
    assert counting.names == ["outer", "inner", "kept"]
    seen = [e.name for e in prof.events()
            if e.name in ("outer", "inner", "kept")]
    assert sorted(seen) == ["inner", "kept", "outer"]


def test_span_totals_self_time_threads_counters_and_reset():
    tel = events.install(events.SpanTotals())
    assert events.current() is tel and not tel.enabled

    def worker():
        with events.span("other_thread"):
            time.sleep(0.02)

    with events.span("outer"):
        time.sleep(0.01)
        with events.span("inner"):
            time.sleep(0.02)
        with pytest.raises(ValueError):
            with events.span("inner"):
                raise ValueError("kept anyway")
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        events.count("pages", 3)
        events.count("pages")
        events.event("dropped", x=1)
    got = tel.totals()
    spans = got["spans"]
    assert {k: v["count"] for k, v in spans.items()} == {
        "outer": 1, "inner": 2, "other_thread": 1}
    assert spans["inner"]["self_s"] == spans["inner"]["total_s"]
    # Another thread's span is never a child of this thread's.
    assert spans["outer"]["self_s"] == pytest.approx(
        spans["outer"]["total_s"] - spans["inner"]["total_s"], abs=1e-12)
    assert spans["outer"]["self_s"] >= 0.03
    assert got["counters"] == {"pages": 4}
    assert tel.tail() == []
    tel.reset()
    assert tel.totals() == {"spans": {}, "counters": {}}


def test_span_totals_lose_no_update_across_threads():
    """More threads than cores, each opening nested spans and counting,
    with a short switch interval: every count and span is kept."""
    tel = events.install(events.SpanTotals())
    n_threads, n = 2 * (os.cpu_count() or 2) + 2, 300

    def worker():
        for _ in range(n):
            with events.span("outer"), events.span("inner"):
                events.count("hits")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = tel.totals()
    assert got["counters"] == {"hits": n_threads * n}
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "outer": n_threads * n, "inner": n_threads * n}
    outer, inner = got["spans"]["outer"], got["spans"]["inner"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], rel=1e-6, abs=1e-9)


def test_count_without_a_counting_sink_is_dropped(tmp_path):
    events.count("nobody")
    tel = events.install(events.Telemetry(str(tmp_path / "e.jsonl")))
    events.count("nobody")
    tel.close()
    with open(tmp_path / "e.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["run_start"]


def _trainer(strategy="ddp", grad_accum=1):
    cfg = port_config.Config()
    for k, v in dict(batch_size=4, dtype="float32", log_every=0,
                     device="cpu", grad_accum_steps=grad_accum,
                     parallel_strategy=strategy, min_shard_elems=1,
                     learning_rate=1e-3, warmup_steps=1).items():
        setattr(cfg.train, k, v)
    rt = initialize_runtime(cfg)
    model = build_model("transformer", device="cpu", **MODEL)
    ds = SyntheticLMDataset(size=16, seq_len=16,
                            vocab_size=MODEL["vocab_size"], seed=0)
    loader = ShardedDataLoader(ds, rt, batch_size=4, shuffle=False)
    trainer = Trainer(cfg, rt, model, loader)
    return trainer, list(loader.epoch(0))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_phases_nest_in_step(grad_accum):
    tel = events.install(events.SpanTotals())
    trainer, batches = _trainer(grad_accum=grad_accum)
    trainer.train_step(batches[0])  # the "compile" step
    tel.reset()
    for b in batches[1:3]:
        trainer.train_step(b)
    spans = tel.totals()["spans"]
    assert {k: v["count"] for k, v in spans.items()} == {
        "step": 2, "forward": 2 * grad_accum, "backward": 2 * grad_accum,
        "optimizer": 2}
    inside = sum(spans[k]["self_s"]
                 for k in ("forward", "backward", "optimizer"))
    assert spans["step"]["self_s"] + inside == pytest.approx(
        spans["step"]["total_s"], rel=1e-9)
    assert spans["step"]["self_s"] > 0


def test_fsdp_spans_nest_in_forward_and_backward(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    path = str(tmp_path / "e.jsonl")
    tel = events.install(events.Telemetry(path))
    try:
        trainer, batches = _trainer(strategy="fsdp")
        for b in batches[:2]:
            trainer.train_step(b)
    finally:
        tel.close()
        dist.destroy_process_group()
    with open(path) as f:
        spans = [r for r in map(json.loads, f) if r["kind"] == "span"]
    parents = {}
    for r in spans:
        parents.setdefault(r["name"], set()).add(r["parent"])
    assert parents["fsdp.gather"] == {"forward"}
    assert parents["fsdp.reduce_scatter"] == {"backward"}
    assert parents["forward"] == parents["backward"] == {"compile", "step"}
    n = {k: sum(1 for r in spans if r["name"] == k) for k in parents}
    # One gather a layer and one a top-level sharded leaf, each a step;
    # each reduce-scatters its gradient once.
    assert n["fsdp.gather"] == n["fsdp.reduce_scatter"] >= 2 * (
        MODEL["n_layers"] + 1)


TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
            max_seq_len=64, dtype="float32", param_dtype="float32")
DECODES = {"one_token": {}, "speculative": {"spec_k": 2},
           "resident": {"resident_k": 2}}


@pytest.mark.parametrize("decode", sorted(DECODES))
def test_engine_step_spans_and_kv_counter(decode):
    model = Transformer(TransformerConfig(**TINY), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = engine_lib.Engine(model, params, engine_lib.EngineConfig(
        max_batch=4, page_size=4, num_pages=40, max_seq_len=48,
        prefill_chunk=16, prefill_mode="batched", policy="prefill",
        **DECODES[decode]), device="cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(engine_lib.Request(
            id=f"r{i}", prompt=rng.integers(0, 128, 5 + 3 * i).astype(
                np.int32), max_new_tokens=6))
    tel = events.install(events.SpanTotals())
    used, ops = [], []
    while not eng.idle:
        tel.reset()
        used.append(eng.cache.pages_used)
        rec = eng.step()
        ops.append(rec["op"])
        got = {k: v["count"] for k, v in tel.totals()["spans"].items()}
        want = {"engine.step": 1, "engine.schedule": 1}
        if rec["op"] != "idle":
            want[f"engine.{rec['op']}"] = 1
            want.update({f"engine.{rec['op']}.{p}": 1 for p in PHASES})
        assert got == want, rec["op"]
    assert ops[0] == "prefill" and "decode" in ops
    assert eng.engine_steps == len(used)
    assert eng.kv_pages_used == sum(used) > 0

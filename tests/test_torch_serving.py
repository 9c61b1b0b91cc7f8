"""The PyTorch port's serving stack held against the JAX engine.

Same weights (carried across with ``from_jax_params``), same prompts
(numpy, seeded), float32 on the CPU: the port's ``Engine`` must emit the
JAX ``Engine``'s greedy tokens token for token — batched and sequential
prefill, prefix sharing with a copy-on-write fork mid-page, session
re-attach — and match its own dense full-context greedy. The JAX engine
runs with ``mesh=None``, the replicated single-group reference.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
)
from distributed_training_tpu_torch.runtime import MeshSpec, Runtime
from distributed_training_tpu_torch.serving import disagg as port_disagg
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.serving.kv_cache import (
    PagedCacheConfig,
    PagedKVCache,
)
from distributed_training_tpu_torch.serving.server import ServingServer

jax = pytest.importorskip("jax")

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, max_seq_len=128, dtype="float32",
            param_dtype="float32", pos_encoding="rope",
            tie_embeddings=False)
ENGINE = dict(max_batch=4, page_size=8, num_pages=64, max_seq_len=64,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    jm = Transformer(TransformerConfig(**TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = PortTransformer(PortConfig(**TINY), device="cpu")
    pp = from_jax_params(jax.tree.map(np.asarray, jp), pm.cfg,
                         device="cpu")
    return jm, jp, pm, pp


def _port(pm, pp, **over):
    return port_engine.Engine(
        pm, pp, port_engine.EngineConfig(**{**ENGINE, **over}),
        device="cpu")


def _jax(jm, jp, **over):
    return jax_engine.Engine(jm, jp,
                             jax_engine.EngineConfig(**{**ENGINE, **over}))


def _dense_greedy(pm, pp, prompt, n):
    """Re-run the full context through the port's Transformer.apply for
    every token, argmax — the reference the paged path must match."""
    ids = [int(t) for t in prompt]
    out = []
    for _ in range(n):
        logits, _ = pm.apply(pp, torch.tensor([ids]))
        out.append(int(torch.argmax(logits[0, -1])))
        ids.append(out[-1])
    return out


def _tokens(eng) -> dict:
    return {r["id"]: r["tokens"] for r in eng.completed}


def _storm(eng, R):
    rng = np.random.default_rng(3)
    for i in range(6):
        p = rng.integers(0, 256, size=int(rng.integers(3, 20)))
        eng.submit(R(id=f"r{i}", prompt=p.astype(np.int32),
                     max_new_tokens=8))
    eng.run_until_drained()
    return _tokens(eng), {"host_syncs": eng.host_syncs}


def _cow(eng, R):
    """Two prompts share a header and diverge mid-page, then a
    page-aligned twin admits with zero prefill and forks the shared
    boundary page on its first decode write."""
    rng = np.random.default_rng(47)
    common = rng.integers(0, 256, size=12).astype(np.int32)
    pa = np.concatenate([common, rng.integers(0, 256, 4).astype(np.int32)])
    pb = np.concatenate([common, rng.integers(0, 256, 4).astype(np.int32)])
    eng.submit(R(id="a", prompt=pa, max_new_tokens=6))
    for _ in range(3):
        eng.step()
    eng.submit(R(id="b", prompt=pb, max_new_tokens=6))
    eng.run_until_drained()
    p16 = rng.integers(0, 256, size=16).astype(np.int32)
    eng.submit(R(id="x", prompt=p16, max_new_tokens=10))
    for _ in range(4):
        eng.step()
    pt0 = eng.prefill_tokens_computed
    eng.submit(R(id="y", prompt=p16.copy(), max_new_tokens=4))
    eng.run_until_drained()
    stats = dict(eng.prefix_stats, y_prefill=eng.prefill_tokens_computed
                 - pt0, pages_used=eng.cache.pages_used)
    return _tokens(eng), stats


def _session(eng, R):
    """A session turn retained, resumed exactly (zero prefill), resumed
    extended, then dropped by a mismatched prompt."""
    rng = np.random.default_rng(53)
    p1 = rng.integers(0, 256, size=12).astype(np.int32)
    eng.submit(R(id="t1", prompt=p1, max_new_tokens=4, session="s"))
    eng.run_until_drained()
    hist = np.concatenate([p1, np.asarray(_tokens(eng)["t1"], np.int32)])
    launches = eng.prefill_launches
    eng.submit(R(id="t2", prompt=hist, max_new_tokens=4, session="s"))
    eng.run_until_drained()
    exact_launches = eng.prefill_launches - launches
    hist2 = np.concatenate([hist, np.asarray(_tokens(eng)["t2"], np.int32),
                            rng.integers(0, 256, 3).astype(np.int32)])
    eng.submit(R(id="t3", prompt=hist2, max_new_tokens=4, session="s"))
    eng.run_until_drained()
    other = rng.integers(0, 256, size=6).astype(np.int32)
    eng.submit(R(id="t4", prompt=other, max_new_tokens=2, session="s"))
    eng.run_until_drained()
    stats = dict(eng.prefix_stats, exact_launches=exact_launches,
                 sessions=len(eng.sessions))
    return _tokens(eng), stats


@pytest.mark.parametrize("scenario,mode", [
    (_storm, "batched"), (_storm, "sequential"), (_cow, "batched"),
    (_cow, "sequential"), (_session, "batched")],
    ids=["storm-batched", "storm-sequential", "cow-batched",
         "cow-sequential", "session-batched"])
def test_engine_tokens_match_jax_engine(models, scenario, mode):
    jm, jp, pm, pp = models
    want, want_stats = scenario(_jax(jm, jp, prefill_mode=mode),
                                jax_engine.Request)
    got, got_stats = scenario(_port(pm, pp, prefill_mode=mode),
                              port_engine.Request)
    assert got == want
    assert got_stats == want_stats
    if scenario is _cow:
        assert got_stats["cow_pages"] >= 1 and got_stats["y_prefill"] == 0
        assert got_stats["pages_used"] == 0
    if scenario is _session:
        assert got_stats["session_resumes"] == 2
        assert got_stats["exact_launches"] == 0


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_engine_matches_dense_full_context_greedy(models, mode):
    _, _, pm, pp = models
    prompt = np.asarray([5, 7, 11, 13, 17, 19, 23, 29, 31, 37], np.int32)
    eng = _port(pm, pp, prefill_mode=mode)
    assert eng.generate(prompt, 12) == _dense_greedy(pm, pp, prompt, 12)


def test_batch_composition_independence(models):
    _, _, pm, pp = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=int(rng.integers(3, 16)))
               .astype(np.int32) for _ in range(6)]
    eng = _port(pm, pp, max_batch=6, num_pages=96)
    for i, p in enumerate(prompts):
        eng.submit(port_engine.Request(id=f"r{i}", prompt=p,
                                       max_new_tokens=8))
    eng.run_until_drained()
    batched = _tokens(eng)
    solo = _port(pm, pp, max_batch=1)
    assert solo.generate(prompts[2], 8) == batched["r2"]
    assert solo.generate(prompts[5], 8) == batched["r5"]


def test_pool_exhaustion_is_backpressure_not_corruption(models):
    _, _, pm, pp = models
    eng = _port(pm, pp, num_pages=10)
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(5)]
    for i, p in enumerate(prompts):
        eng.submit(port_engine.Request(id=f"r{i}", prompt=p,
                                       max_new_tokens=12))
    eng.run_until_drained(max_steps=2000)
    assert len(eng.completed) == 5 and eng.cache.pages_used == 0
    solo = _port(pm, pp, max_batch=1)
    for i, p in enumerate(prompts):
        assert solo.generate(p, 12) == _tokens(eng)[f"r{i}"]


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_compile_counts_unchanged_across_join_evict_storm(models, mode):
    _, _, pm, pp = models
    eng = _port(pm, pp, max_batch=3, num_pages=96, prefill_mode=mode)
    counts = eng.warmup()
    rng = np.random.default_rng(5)
    for i in range(7):
        eng.submit(port_engine.Request(
            id=f"r{i}",
            prompt=rng.integers(0, 256, size=int(rng.integers(2, 20)))
            .astype(np.int32),
            max_new_tokens=int(rng.integers(1, 10))))
    eng.run_until_drained()
    assert len(eng.completed) == 7
    assert eng.compile_counts() == counts
    assert eng.cache.pages_used == 0


def test_sampled_decode_is_seeded_and_in_vocab(models):
    _, _, pm, pp = models
    prompt = np.arange(9, dtype=np.int32)
    runs = [_port(pm, pp, temperature=0.8, top_k=5, seed=7,
                  prefill_mode=mode).generate(prompt, 6)
            for mode in ("batched", "batched", "sequential")]
    assert runs[0] == runs[1]
    assert all(0 <= t < 256 for r in runs for t in r)


def test_page_accounting_never_leaks_under_random_join_evict():
    cfg = PagedCacheConfig(n_layers=2, n_kv_heads=2, head_dim=16,
                           page_size=8, num_pages=32, max_seq_len=64)
    cache = PagedKVCache(cfg, device="cpu")
    rng = np.random.default_rng(7)
    live: dict[int, int] = {}
    next_id = 0
    for _ in range(500):
        total = sum(-(-n // cfg.page_size) for n in live.values() if n)
        assert cache.pages_used == total
        assert cache.pages_used + cache.free_pages == cfg.usable_pages
        op = rng.integers(0, 3)
        if op == 0 and len(live) < 8:
            cache.join(next_id)
            live[next_id] = 0
            next_id += 1
        elif op == 1 and live:
            sid = int(rng.choice(list(live)))
            want = min(live[sid] + int(rng.integers(1, 20)),
                       cfg.max_seq_len)
            if cache.ensure(sid, want):
                cache.advance(sid, want - live[sid])
                live[sid] = want
        elif op == 2 and live:
            sid = int(rng.choice(list(live)))
            cache.free(sid)
            del live[sid]
    for sid in list(live):
        cache.free(sid)
    assert cache.pages_used == 0
    assert cache.free_pages == cfg.usable_pages


def _post(port: int, body: dict) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_server_round_trip_streamed_equals_plain(models):
    _, _, pm, pp = models
    eng = _port(pm, pp)
    eng.warmup()
    srv = ServingServer(eng, port=0).start()
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
        plain = json.loads(_post(srv.port, {"prompt_ids": prompt,
                                            "max_new_tokens": 7}))
        lines = [json.loads(x) for x in _post(
            srv.port, {"prompt_ids": prompt, "max_new_tokens": 7,
                       "stream": True}).decode().splitlines()]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
    streamed = [x["token"] for x in lines if "token" in x]
    assert lines[-1]["done"] and lines[-1]["tokens"] == streamed
    assert plain["tokens"] == streamed
    assert plain["tokens"] == _dense_greedy(pm, pp, prompt, 7)
    assert health["status"] == "ok"
    assert srv.leaked_threads == 0


def test_deferred_mesh_int8_and_server_options_raise(models):
    _, _, pm, pp = models
    cfg = port_engine.EngineConfig(**ENGINE)
    # A mesh axis the engine does not serve over (dp, fsdp and tp it
    # does).
    sp_mesh = Runtime(device=torch.device("cpu"), spec=MeshSpec(sp=2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        port_engine.Engine(pm, pp, cfg, mesh=sp_mesh, device="cpu")
    # int8 weight-only leaves serve (tests/test_torch_int8.py holds
    # their tokens against the JAX int8 engine).
    int8 = port_disagg.quantize_params_int8(pp)
    q = port_engine.Engine(pm, int8, cfg, device="cpu")
    assert q.weight_bytes == \
        port_disagg.quantized_weight_bytes(int8)["int8"]
    assert len(q.generate(np.arange(1, 9, dtype=np.int32), 4)) == 4
    # The server options serve since ROADMAP.md item 12 landed
    # (tests/test_torch_server_ops.py holds them against JAX's server).
    eng = port_engine.Engine(pm, pp, cfg, device="cpu")
    srv = ServingServer(eng, port=0, metrics_port=0, max_queue_depth=4,
                        incident_dir="x")
    assert (srv.max_queue_depth, srv.incident_dir, srv.is_front) == \
        (4, "x", True)

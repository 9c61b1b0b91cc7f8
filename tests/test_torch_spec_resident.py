"""Speculative and device-resident decode of the port, held against the
JAX package.

Same weights (``from_jax_params``), same inputs (numpy, seeded), float32
on the CPU:

- drafting: ``draft_tokens``/``NgramIndex`` and the in-program
  ``_draft_cols`` give JAX's drafts exactly;
- programs: ``_chunk_program(emit="all")`` gives JAX's argmax chains and
  one ``_resident_program`` burst JAX's ``out``/``n_emitted``/``steps``,
  both with the pools within 1e-5 (summation order); the chain through
  single-token decode (``paged_decode_chain``, its plain route here)
  equals the paged chunk form within 1e-6;
- engines: ``spec_k`` and ``resident_k`` engines emit the JAX engine's
  tokens for the same config and the port's one-token engine's, with
  JAX's ``spec_stats``/``resident_stats``, through a storm, a
  copy-on-write fork and a chat session, at the budget and
  ``max_seq_len`` edges, with an EOS mid-burst and in a tight pool, and
  over HTTP.

On the CPU the resident burst runs its body eagerly (the CUDA graph is
the card's; ``tests/test_torch_kernels_gpu.py`` holds a captured paged
decode against the eager call).
"""

import json
import types
import urllib.request

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
    cast_for_compute,
)
from distributed_training_tpu_torch.ops import paged_attention as port_pa
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.serving.server import ServingServer

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, max_seq_len=128, dtype="float32",
            param_dtype="float32", pos_encoding="rope",
            tie_embeddings=False)
ENGINE = dict(max_batch=4, page_size=8, num_pages=96, max_seq_len=64,
              prefill_chunk=8)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _tokens(eng) -> dict:
    return {r["id"]: r["tokens"] for r in eng.completed}


def _ragged_prompts():
    """The JAX serving tests' prompts: shorter than a chunk, one chunk,
    one chunk + tail, several chunks + tail (a repetitive one)."""
    return [np.asarray([5, 7, 11], np.int32),
            np.asarray(np.arange(8), np.int32),
            np.asarray([5, 7, 11, 13, 17, 19, 23, 29, 31, 37], np.int32),
            np.asarray(([3, 9, 27] * 7)[:20], np.int32)]


def _ragged(eng, R):
    counts = eng.warmup()
    for i, p in enumerate(_ragged_prompts()):
        eng.submit(R(id=f"r{i}", prompt=p, max_new_tokens=12))
    eng.run_until_drained()
    assert eng.compile_counts() == counts
    assert eng.cache.pages_used == 0
    return _tokens(eng)


# -- drafting ----------------------------------------------------------------


def _histories(kind: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return [rng.integers(0, 256, size=int(rng.integers(1, 40)))
                .astype(np.int32) for _ in range(40)]
    # Few symbols: many repeated n-grams, so most drafts come from a
    # match, some from the longest n only.
    return [rng.integers(0, 4, size=int(rng.integers(1, 40)))
            .astype(np.int32) for _ in range(40)]


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_draft_tokens_and_ngram_index_match_jax(kind):
    rng = np.random.default_rng(11)
    for hist in _histories(kind, 5):
        n = int(rng.integers(1, 4))
        idx = port_engine.NgramIndex(n)
        for j, t in enumerate(hist):
            idx.append(int(t))
            m = int(rng.integers(0, 7))
            want = jax_engine.draft_tokens(hist[:j + 1], m, n).tolist()
            assert port_engine.draft_tokens(hist[:j + 1], m,
                                            n).tolist() == want
            assert idx.draft(m).tolist() == want


def _jax_draft_cols(B, C, Lmax, ngram):
    """JAX's in-program ``draft_cols``, which is nested inside
    ``_resident_program``: rebuilt from its code object with its closure
    (the JAX package stays untouched)."""
    code = next(c for c in jax_engine._resident_program.__code__.co_consts
                if getattr(c, "co_name", None) == "draft_cols")
    env = {"B": B, "C": C, "Lmax": Lmax, "jnp": jnp, "ngram": ngram,
           "pos": jnp.arange(Lmax, dtype=jnp.int32)}
    cells = tuple(types.CellType(env[n]) for n in code.co_freevars)
    return types.FunctionType(code, jax_engine.__dict__, "draft_cols",
                              None, cells)


@pytest.mark.parametrize("kind", ["random", "repetitive"])
@pytest.mark.parametrize("C,ngram", [(4, 3), (3, 1), (6, 2)])
def test_draft_cols_match_jax(kind, C, ngram):
    B, Lmax = 6, 48
    rng = np.random.default_rng(C * 10 + ngram)
    hist = np.zeros((B, Lmax), np.int32)
    hlen = np.zeros((B,), np.int32)
    for b, h in enumerate(_histories(kind, 7)[:B]):
        h = h[:Lmax]
        hist[b, :len(h)] = h
        hlen[b] = len(h)
    hlen[-1] = Lmax  # a full row
    hist[-1] = rng.integers(0, 4, size=Lmax)
    last = hist[np.arange(B), hlen - 1]
    want = _jax_draft_cols(B, C, Lmax, ngram)(
        jnp.asarray(hist), jnp.asarray(hlen), jnp.asarray(last))
    got = port_engine._draft_cols(torch.from_numpy(hist).long(),
                                  torch.from_numpy(hlen).long(),
                                  torch.from_numpy(last).long(), C, ngram)
    assert got.tolist() == np.asarray(want).tolist()


# -- programs ----------------------------------------------------------------


def _pools(seed: int, n_pages: int = 48):
    """Random pools in the (1, L, Hkv, N, ps, hd) layout, numpy."""
    rng = np.random.default_rng(seed)
    shape = (1, TINY["n_layers"], TINY["n_kv_heads"], n_pages,
             ENGINE["page_size"], TINY["d_model"] // TINY["n_heads"])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rows(B: int, P: int, seed: int) -> np.ndarray:
    """Disjoint page rows over pages 1.. (page 0 is scratch)."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + B * P))
    return perm.reshape(B, P).astype(np.int32)


def test_paged_decode_chain_plain_equals_chunk_form():
    rng = np.random.default_rng(2)
    S, C, H, Hkv, hd, ps, P = 3, 4, 4, 2, 16, 8, 5
    kp = torch.from_numpy(rng.standard_normal((Hkv, 1 + S * P, ps, hd))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((Hkv, 1 + S * P, ps, hd))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((S, C, H, hd))
                         .astype(np.float32))
    rows = torch.from_numpy(_rows(S, P, 3))
    start = np.array([0, 17, 35])
    q_pos = torch.from_numpy(start[:, None] + np.arange(C)[None, :])
    q_pos[1, 2:] = -1            # padding past n_valid
    q_pos[2] = -1                # a dead lane
    before = port_pa.paged_attention.launches
    got = port_pa.paged_decode_chain(q, kp, vp, rows, q_pos)
    want = port_pa.paged_attention_chunk(q, kp, vp, rows, q_pos)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert got[2].abs().max() == 0 and got[1, 2:].abs().max() == 0
    assert port_pa.paged_attention.launches == before  # CPU: no kernel


def test_chunk_program_emit_all_matches_jax(models):
    jm, jp, pm, pp = models
    S, C, P = 4, 5, 8
    kp, vp = _pools(4)
    rows = _rows(S, P, 5)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 256, size=(S, C)).astype(np.int32)
    start = np.array([3, 0, 40, 21], np.int32)
    n_valid = np.array([5, 1, 3, 4], np.int32)
    active = np.array([True, True, True, False])
    want, jk, jv = jax_engine._chunk_program(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(rows[None]),
        jnp.asarray(tokens[None]), jnp.asarray(start[None]),
        jnp.asarray(n_valid[None]), jnp.asarray(active[None]),
        jnp.zeros((1, 2), jnp.uint32), cfg=jm.cfg, temperature=0.0,
        top_k=0, paged_impl="auto", emit="all")
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t = torch.from_numpy
    got = port_engine._chunk_program(
        cast_for_compute(pp, pm.cfg), tk, tv, t(rows), t(tokens).long(),
        t(start).long(), t(n_valid).long(), t(active), None, cfg=pm.cfg,
        temperature=0.0, top_k=0, emit="all")
    assert got.shape == (S, C)
    assert got.tolist() == np.asarray(want[0]).tolist()
    assert (got[3] == 0).all() and (got[1, 1:] == 0).all()
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **POOL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POOL_TOL)


@pytest.mark.parametrize("K,C,eos", [(4, 3, -1), (3, 1, -1), (4, 2, 7)],
                         ids=["spec3", "one-token", "eos"])
def test_resident_program_burst_matches_jax(models, K, C, eos):
    """One burst on the same inputs: four running slots with histories
    that repeat (drafts accepted), budgets that stop some slots inside
    the burst, and a dead slot."""
    jm, jp, pm, pp = models
    B, P, Lmax = 5, 8, ENGINE["max_seq_len"]
    kp, vp = _pools(8)
    rows = _rows(B, P, 9)
    rng = np.random.default_rng(10)
    history = np.zeros((B, Lmax), np.int32)
    kv_len = np.array([6, 19, 11, 30, 0], np.int32)
    for b in range(B):
        n = kv_len[b] + 1
        history[b, :n] = (rng.integers(0, 4, size=n) if b % 2
                          else rng.integers(0, 256, size=n))
    budget = np.array([K * C, 3, K * C - 1, 1, 0], np.int32)
    active = np.array([True, True, True, True, False])
    kw = dict(K=K, C=C, ngram=3, eos_id=eos, paged_impl="auto")
    want = jax_engine._resident_program(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(rows[None]),
        jnp.asarray(history[None]), jnp.asarray(kv_len[None]),
        jnp.asarray(budget[None]), jnp.asarray(active[None]), cfg=jm.cfg,
        **kw)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t = torch.from_numpy
    out, n_em, steps = port_engine._resident_program(
        cast_for_compute(pp, pm.cfg), tk, tv, t(rows), t(history).long(),
        t(kv_len).long(), t(budget).long(), t(active), cfg=pm.cfg, **kw)
    assert out.tolist() == np.asarray(want[0][0]).tolist()
    assert n_em.tolist() == np.asarray(want[1][0]).tolist()
    assert int(steps) == int(want[2][0])
    assert 0 < int(steps) <= K and n_em[-1] == 0
    np.testing.assert_allclose(tk.numpy(), np.asarray(want[3]), **POOL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(want[4]), **POOL_TOL)


# -- engines -----------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_runs(models):
    """``plain_runs(key, fn)``: ``fn(pm, pp)``, a run of the port's
    one-token engine, computed once per key (several tests hold their
    engines against the same one)."""
    _, _, pm, pp = models
    cache = {}

    def run(key, fn):
        if key not in cache:
            cache[key] = fn(pm, pp)
        return cache[key]

    return run


def _ragged_one_token(pm, pp):
    eng = _port(pm, pp)
    return _ragged(eng, port_engine.Request), eng.host_syncs

CONFIGS = [dict(spec_k=3), dict(spec_k=5), dict(resident_k=4),
           dict(resident_k=8), dict(resident_k=2, spec_k=3),
           dict(resident_k=4, spec_k=4)]
IDS = ["spec3", "spec5", "res4", "res8", "res2-spec3", "res4-spec4"]


@pytest.mark.parametrize("over", CONFIGS, ids=IDS)
def test_engine_tokens_and_stats_match_jax(models, plain_runs, over):
    jm, jp, pm, pp = models
    je = _jax(jm, jp, **over)
    want = _ragged(je, jax_engine.Request)
    pe = _port(pm, pp, **over)
    got = _ragged(pe, port_engine.Request)
    plain, plain_syncs = plain_runs("ragged", _ragged_one_token)
    assert got == want == plain
    assert pe.spec_stats == je.spec_stats
    assert pe.resident_stats == je.resident_stats
    decode_tokens = sum(len(t) - 1 for t in got.values())
    if over.get("resident_k", 1) > 1:
        st = pe.resident_stats
        assert st["emitted"] == decode_tokens
        assert st["launches"] <= st["steps"] <= \
            st["launches"] * over["resident_k"]
        assert pe.compile_counts()["decode_graph"] == 0  # eager on CPU
        assert pe.host_syncs < plain_syncs
    else:
        st = pe.spec_stats
        assert st["emitted"] == decode_tokens
        assert st["launches"] < decode_tokens  # drafts were accepted
        # The slowest sequence sets the launches; it may accept none.
        assert pe.host_syncs <= plain_syncs


def _storm(eng, R):
    rng = np.random.default_rng(3)
    for i in range(6):
        p = rng.integers(0, 256, size=int(rng.integers(3, 20)))
        eng.submit(R(id=f"s{i}", prompt=p.astype(np.int32),
                     max_new_tokens=int(rng.integers(1, 14))))
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
    eng.submit(R(id="a", prompt=pa, max_new_tokens=10))
    for _ in range(3):
        eng.step()
    eng.submit(R(id="b", prompt=pb, max_new_tokens=10))
    eng.run_until_drained()
    p16 = rng.integers(0, 256, size=16).astype(np.int32)
    eng.submit(R(id="x", prompt=p16, max_new_tokens=12))
    for _ in range(3):
        eng.step()
    pt0 = eng.prefill_tokens_computed
    eng.submit(R(id="y", prompt=p16.copy(), max_new_tokens=9))
    eng.run_until_drained()
    stats = dict(eng.prefix_stats, y_prefill=eng.prefill_tokens_computed
                 - pt0, pages_used=eng.cache.pages_used)
    return _tokens(eng), stats


def _session(eng, R):
    """A session turn retained, resumed exactly (zero prefill), resumed
    extended, then dropped by a mismatched prompt."""
    rng = np.random.default_rng(53)
    p1 = rng.integers(0, 256, size=12).astype(np.int32)
    eng.submit(R(id="t1", prompt=p1, max_new_tokens=7, session="s"))
    eng.run_until_drained()
    hist = np.concatenate([p1, np.asarray(_tokens(eng)["t1"], np.int32)])
    eng.submit(R(id="t2", prompt=hist, max_new_tokens=9, session="s"))
    eng.run_until_drained()
    hist2 = np.concatenate([hist, np.asarray(_tokens(eng)["t2"], np.int32),
                            rng.integers(0, 256, 3).astype(np.int32)])
    eng.submit(R(id="t3", prompt=hist2, max_new_tokens=6, session="s"))
    eng.run_until_drained()
    other = rng.integers(0, 256, size=6).astype(np.int32)
    eng.submit(R(id="t4", prompt=other, max_new_tokens=5, session="s"))
    eng.run_until_drained()
    return _tokens(eng), dict(eng.prefix_stats, sessions=len(eng.sessions))


@pytest.mark.parametrize("over", [dict(spec_k=3),
                                  dict(resident_k=4, spec_k=3)],
                         ids=["spec3", "res4-spec3"])
@pytest.mark.parametrize("scenario", [_storm, _cow, _session],
                         ids=["storm", "cow", "session"])
def test_scenarios_match_jax_and_one_token(models, plain_runs, scenario,
                                           over):
    jm, jp, pm, pp = models
    pe = _port(pm, pp, **over)
    want, want_stats = scenario(_jax(jm, jp, **over), jax_engine.Request)
    got, got_stats = scenario(pe, port_engine.Request)
    plain, plain_stats = plain_runs(
        scenario.__name__,
        lambda pm, pp: scenario(_port(pm, pp), port_engine.Request))
    assert got == want == plain
    if scenario is _storm:
        assert got_stats["host_syncs"] < plain_stats["host_syncs"]
        got_stats["host_syncs"] = want_stats["host_syncs"]
    assert got_stats == want_stats
    if scenario is _cow:
        assert got_stats["cow_pages"] >= 1 and got_stats["y_prefill"] == 0
        assert got_stats["pages_used"] == 0
    if scenario is _session:
        assert got_stats["session_resumes"] == 2
    assert pe.spec_stats["launches"] + pe.resident_stats["launches"] > 0


@pytest.mark.parametrize("over", [dict(spec_k=6),
                                  dict(resident_k=4, spec_k=3)],
                         ids=["spec6", "res4-spec3"])
def test_budget_and_seq_cap(models, plain_runs, over):
    """A request one token from its budget, and one whose prompt +
    budget fills max_seq_len exactly, finish as the one-token engine's
    (chain positions past either ride as padding, never as writes)."""
    _, _, pm, pp = models
    prompt = np.asarray([5, 7, 11, 13], np.int32)

    def run(pm, pp, n_new, max_seq, **o):
        eng = _port(pm, pp, max_seq_len=max_seq, **o)
        eng.warmup()
        eng.submit(port_engine.Request(id="edge", prompt=prompt,
                                       max_new_tokens=n_new))
        eng.run_until_drained()
        (rec,) = eng.completed
        assert eng.cache.pages_used == 0
        return rec["tokens"]

    for n_new, max_seq in ((1, 64), (2, 64), (12, 16), (11, 16)):
        assert run(pm, pp, n_new, max_seq, **over) == plain_runs(
            ("edge", n_new, max_seq),
            lambda pm, pp: run(pm, pp, n_new, max_seq))


@pytest.mark.parametrize("over", [dict(resident_k=4),
                                  dict(resident_k=2, spec_k=3),
                                  dict(spec_k=4)],
                         ids=["res4", "res2-spec3", "spec4"])
def test_eos_stops_mid_burst(models, over):
    """A stop token landing inside a burst (or a chain) ends the stream
    there, EOS included, as in the one-token engine."""
    _, _, pm, pp = models
    prompt = np.asarray([5, 7, 11, 13, 17], np.int32)

    def run(eos, **o):
        eng = _port(pm, pp, eos_id=eos, **o)
        eng.submit(port_engine.Request(id="e", prompt=prompt,
                                       max_new_tokens=12))
        eng.run_until_drained()
        (rec,) = eng.completed
        assert eng.cache.pages_used == 0
        return rec["tokens"]

    free = run(-1)
    assert len(free) == 12
    eos = free[5]
    want = free[:free.index(eos) + 1]
    got = run(eos, **over)
    assert got == want == run(eos)
    assert got[-1] == eos and len(got) < 12


def test_resident_tight_pool_still_progresses(models):
    """A pool too tight for a whole burst shrinks the burst to the
    pages a slot can claim (``token_capacity``) instead of stalling."""
    _, _, pm, pp = models
    prompts = [np.asarray([3 + i, 5, 7, 9], np.int32) for i in range(2)]

    def run(rk, pages):
        eng = _port(pm, pp, max_batch=2, page_size=4, num_pages=pages,
                    max_seq_len=32, prefill_chunk=4, resident_k=rk)
        for i, p in enumerate(prompts):
            eng.submit(port_engine.Request(id=f"t{i}", prompt=p,
                                           max_new_tokens=16))
        eng.run_until_drained(max_steps=300)
        assert eng.cache.pages_used == 0
        return _tokens(eng), eng

    # 9 usable pages of 4 tokens for two sequences of 4 + 16 = 5 pages
    # each: neither can hold its whole horizon at once.
    want, _ = run(1, 10)
    got, eng = run(8, 10)
    assert got == want
    roomy, roomy_eng = run(8, 64)
    assert roomy == want
    assert eng.resident_stats["launches"] > \
        roomy_eng.resident_stats["launches"]


def test_token_capacity_counts_own_and_free_pages(models):
    _, _, pm, pp = models
    eng = _port(pm, pp, num_pages=10, max_seq_len=64)
    cache = eng.cache
    cache.join("a")
    assert cache.ensure("a", 20)                 # 3 pages of 8
    assert cache.token_capacity("a") == min(9 * 8, 64)
    cache.join("b")
    assert cache.ensure("b", 40)                 # 5 more
    assert cache.token_capacity("a") == (3 + 1) * 8
    assert cache.token_capacity("b") == (5 + 1) * 8


def _post(port: int, body: dict) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_server_round_trip_resident(models, plain_runs):
    _, _, pm, pp = models
    eng = _port(pm, pp, resident_k=4, spec_k=2)
    eng.warmup()
    srv = ServingServer(eng, port=0).start()
    try:
        prompt = _ragged_prompts()[3].tolist()
        plain = json.loads(_post(srv.port, {"prompt_ids": prompt,
                                            "max_new_tokens": 12}))
        lines = [json.loads(x) for x in _post(
            srv.port, {"prompt_ids": prompt, "max_new_tokens": 12,
                       "stream": True}).decode().splitlines()]
    finally:
        srv.stop()
    streamed = [x["token"] for x in lines if "token" in x]
    assert lines[-1]["done"] and lines[-1]["tokens"] == streamed
    assert plain["tokens"] == streamed == \
        plain_runs("ragged", _ragged_one_token)[0]["r3"]
    assert eng.resident_stats["launches"] > 0
    assert srv.leaked_threads == 0

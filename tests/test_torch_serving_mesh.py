"""Serving on a mesh (the port's dp groups and kv-head shard over tp),
held against the JAX package.

- The grouped allocator: the port's ``PagedKVCache(dp_groups=4)`` and
  JAX's, driven by the same seeded sequence of join, ensure, advance,
  register_prefix, match_prefix, attach, privatize, rename and free,
  hold the same tables, free lists, refcounts, prefix index, page keys,
  ``page_rows_grouped`` and occupancy after every operation; JAX's
  per-group leak and group-local prefix tests, on the port.
- The engine on a mesh: one spawned gloo world per mesh (dp 2, tp 2,
  dp 2 x tp 2; ``test_torch_serving_mesh_world.py`` is one process of
  it), float32 on the CPU, the JAX sharded-engine test's 12 prompts.
  For batched and sequential prefill, ``spec_k`` 4 and ``resident_k`` 4,
  every process's greedy tokens equal the port's one-process engine's
  and the replicated JAX engine's, each with the whole slot table and
  the same total pool, ``num_pages = G·(N−1)+1``
  (``tests/test_serving.py::test_dp_sharded_engine_matches_replicated``).
  In the same worlds: the skewed burst spreads evenly over the groups,
  a sequence decodes alike whichever group it lands in, every group
  returns to zero pages, completed records name every group, the
  collectives equal the design, the weight slices equal the tp
  trainer's, and a process given one extra submission raises at the
  first step instead of hanging. And the serving lifecycle on the mesh:
  int8 weight-only leaves (``qw`` cut like its weight, ``scale`` only on
  its dims above 1) give the one-process int8 engine's and the JAX int8
  engine's tokens; an identical-value ``swap_weights`` mid-stream, a
  ``preempt`` and a ``drain``, in lock-step on every process, give the
  unswapped run's tokens; a stream stopped mid-way, exported with
  ``export_in_flight`` (one all-gather of the dense KV over the mesh)
  and adopted back with ``adopt_batch``, and a drain with a deadline
  (the first process's clock) whose persisted work is adopted back,
  each end with the uninterrupted run's tokens, and every process
  persists the same requests.
"""

import dataclasses
import os
import subprocess
import sys
import types

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
from distributed_training_tpu_torch.serving import kv_cache as port_kv
from distributed_training_tpu_torch.serving.server import ServingServer
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.parallel.planner import (  # noqa: E402
    SERVING_MODEL_KWARGS,
)
from distributed_training_tpu.serving import disagg as jax_disagg  # noqa: E402
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402
from distributed_training_tpu.serving import kv_cache as jax_kv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_serving_mesh_world.py")
sys.path.insert(0, os.path.dirname(WORKER))
from test_torch_serving_mesh_world import MODES, mesh_prompts  # noqa: E402

# Per dp group: 4 slots (8 over 2 groups), each able to hold a whole
# sequence of max_seq_len (8 pages of 8 tokens) — the JAX plan's sizing.
ENGINE = dict(max_batch=8, page_size=8, num_pages=33, max_seq_len=64,
              prefill_chunk=8)
NEW_TOKENS = 8
WORLDS = {"dp2": {"dp": 2}, "tp2": {"tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}}
SPAWN_TIMEOUT_S = 300


def _with_biases(tree: dict, rng) -> dict:
    """``tree`` (numpy) with every bias drawn from N(0, 0.1²): the init
    zeros them, and a bias added on every tp rank instead of once after
    the all-reduce must change the tokens."""
    return {k: _with_biases(v, rng) if isinstance(v, dict) else
            (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
             if k in ("bi", "bo", "bias") else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    jm = Transformer(TransformerConfig(**SERVING_MODEL_KWARGS))
    npp = _with_biases(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1))), np.random.default_rng(3))
    jp = jax.tree.map(jax.numpy.asarray, npp)
    pm = PortTransformer(PortConfig(**SERVING_MODEL_KWARGS), device="cpu")
    pp = from_jax_params(npp, pm.cfg, device="cpu")
    return jm, jp, pm, pp


# -- the grouped allocator -----------------------------------------------------


def _cache_cfg(mod, **over):
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=16, page_size=8,
              num_pages=16, max_seq_len=64)
    return mod.PagedCacheConfig(**{**kw, **over})


def _state(c, ids_by_group) -> dict:
    G = c.cfg.dp_groups
    return {"tables": c._tables, "lengths": c._lengths, "groups": c._groups,
            "frees": c._frees, "refs": c._refs, "index": c._index,
            "page_keys": c._page_keys, "registered": c._registered,
            "occupancy": c.occupancy(),
            "free_in": [c.free_pages_in(g) for g in range(G)],
            "used_in": [c.pages_used_in(g) for g in range(G)],
            "shared_in": [c.shared_pages_in(g) for g in range(G)],
            "seqs_in": [c.seqs_in(g) for g in range(G)],
            "rows": c.page_rows_grouped(ids_by_group).tolist()}


def test_grouped_allocator_matches_jax_op_for_op():
    G = 4
    port = port_kv.PagedKVCache(_cache_cfg(port_kv, dp_groups=G),
                                device="cpu")
    ref = jax_kv.PagedKVCache(_cache_cfg(jax_kv, dp_groups=G))
    ps = port.cfg.page_size
    rng = np.random.default_rng(31)
    # Histories drawn from three shared bases, so prefixes repeat and
    # admissions attach (and later privatize) indexed pages.
    bases = [rng.integers(0, 5, size=48).astype(np.int32) for _ in range(3)]
    hist: dict = {}
    counts: dict = {}
    serial = 0

    def both(name, *args, **kw):
        got = getattr(port, name)(*args, **kw)
        want = getattr(ref, name)(*args, **kw)
        if isinstance(want, tuple):
            got, want = (tuple(got[0]), got[1]), (tuple(want[0]), want[1])
        assert got == want, (name, args, got, want)
        counts[name] = counts.get(name, 0) + 1
        return got

    for step in range(800):
        op = rng.choice(["join", "grow", "register", "privatize", "free",
                         "rename"], p=[0.25, 0.3, 0.2, 0.05, 0.15, 0.05])
        live = sorted(hist)
        if op == "join" and len(hist) < 12:
            g = int(rng.integers(G))
            sid = f"s{serial}"
            serial += 1
            cut = int(rng.integers(16, 41))
            hist[sid] = np.concatenate([
                bases[int(rng.integers(3))][:cut],
                rng.integers(0, 5, size=48 - cut).astype(np.int32)])
            both("join", sid, group=g)
            assert port.can_admit(8, group=g) == ref.can_admit(8, group=g)
            pages, m = both("match_prefix", g, hist[sid])
            if m and rng.random() < 0.8:
                # A full cover attaches one position short (the engine's
                # boundary replay), else the whole matched pages.
                n = m * ps - int(rng.integers(0, 2))
                both("attach", sid, list(pages), n)
                if rng.random() < 0.5 and both("privatize", sid):
                    counts["forks"] = counts.get("forks", 0) + 1
        elif op == "grow" and live:
            sid = live[int(rng.integers(len(live)))]
            n = port.length(sid)
            want = min(n + int(rng.integers(1, 20)), len(hist[sid]))
            if both("ensure", sid, want) and want > n:
                both("advance", sid, want - n)
        elif op == "register" and live:
            sid = live[int(rng.integers(len(live)))]
            if both("needs_register", sid):
                both("register_prefix", sid, hist[sid])
        elif op == "privatize" and live:
            sid = live[int(rng.integers(len(live)))]
            if both("privatize", sid):
                counts["forks"] = counts.get("forks", 0) + 1
        elif op == "free" and live:
            sid = live[int(rng.integers(len(live)))]
            both("free", sid)
            del hist[sid]
        elif op == "rename" and live:
            sid = live[int(rng.integers(len(live)))]
            both("rename", sid, sid + "r")
            hist[sid + "r"] = hist.pop(sid)
        by_group = [[s for s in sorted(hist) if port.group_of(s) == g]
                    for g in range(G)]
        assert _state(port, by_group) == _state(ref, by_group), (step, op)
        for s in hist:
            assert port.token_capacity(s) == ref.token_capacity(s)
    for sid in sorted(hist):
        both("free", sid)
    assert _state(port, [[]] * G) == _state(ref, [[]] * G)
    assert port.pages_used == 0
    assert [port.free_pages_in(g) for g in range(G)] == \
        [port.cfg.usable_pages] * G
    # Every operation ran, sharing included.
    assert {"attach", "forks", "register_prefix", "rename",
            "advance"} <= set(counts), counts


def test_per_shard_allocator_leak_freedom_random_join_evict():
    """JAX's per-group leak invariant on the port: any join/evict order
    keeps every group's ``used + free == usable`` exact, allocations
    never bleed across groups, and a full drain returns every group to
    zero."""
    G = 4
    cfg = _cache_cfg(port_kv, dp_groups=G)
    cache = port_kv.PagedKVCache(cfg, device="cpu")
    rng = np.random.default_rng(23)
    live: dict[int, tuple[int, int]] = {}   # sid -> (group, tokens)
    next_id = 0
    for _ in range(600):
        per_group = [0] * G
        for sid, (g, n) in live.items():
            per_group[g] += -(-n // cfg.page_size) if n else 0
        for g in range(G):
            assert cache.pages_used_in(g) == per_group[g]
            assert cache.pages_used_in(g) + \
                cache.free_pages_in(g) == cfg.usable_pages
        assert cache.pages_used == sum(per_group)
        op = rng.integers(0, 3)
        if op == 0 and len(live) < 12:
            g = int(rng.integers(0, G))
            cache.join(next_id, group=g)
            assert cache.group_of(next_id) == g
            live[next_id] = (g, 0)
            next_id += 1
        elif op == 1 and live:
            sid = int(rng.choice(list(live)))
            g, n = live[sid]
            want = min(n + int(rng.integers(1, 20)), cfg.max_seq_len)
            if cache.ensure(sid, want):
                cache.advance(sid, want - n)
                live[sid] = (g, want)
        elif op == 2 and live:
            sid = int(rng.choice(list(live)))
            cache.free(sid)
            del live[sid]
    for sid in list(live):
        cache.free(sid)
    assert cache.pages_used == 0
    for g in range(G):
        assert cache.free_pages_in(g) == cfg.usable_pages


def test_prefix_index_is_dp_group_local():
    """JAX's: a prefix registered in group 0 never matches admission into
    group 1 (each group's pool is its own memory)."""
    cache = port_kv.PagedKVCache(_cache_cfg(port_kv, dp_groups=2),
                                 device="cpu")
    toks = np.arange(16, dtype=np.int32)
    cache.join("a", group=0)
    assert cache.ensure("a", 16)
    cache.advance("a", 16)
    cache.register_prefix("a", toks)
    pages, m = cache.match_prefix(0, toks)
    assert m == 2 and len(pages) == 2
    assert cache.match_prefix(1, toks) == ((), 0)
    assert cache.match_prefix(0, toks[:7]) == ((), 0)
    cache.free("a")
    assert cache.match_prefix(0, toks) == ((), 0)
    assert cache.pages_used == 0


def test_pool_shard_rules_follow_jax():
    """``pool_shard`` raises where the JAX ``pool_sharding`` does (a kv
    axis that does not divide the kv heads, allocator groups that are
    not the dp extent), and the engine refuses mesh axes it does not
    serve over. ``ServingServer`` over an engine on a mesh of more than
    one process fronts it from the mesh's first process only (ROADMAP.md
    item 13; tests/test_torch_server_cli.py serves a world of 4)."""
    with pytest.raises(ValueError, match="cannot shard 2 kv heads"):
        port_kv.pool_shard(types.SimpleNamespace(spec=MeshSpec(tp=4)), 2, 1,
                           "tp", "dp")
    with pytest.raises(ValueError, match="dp group"):
        port_kv.pool_shard(types.SimpleNamespace(spec=MeshSpec(dp=2)), 2, 4,
                           "tp", "dp")
    assert port_kv.pool_shard(None, 2, 1, "tp", "dp") is None
    # A group dim not split over dp (extent 1): every group held.
    assert port_kv.pool_shard(types.SimpleNamespace(spec=MeshSpec()), 2, 4,
                              "tp", "dp") == (None, 0, 2)
    with pytest.raises(ValueError, match="kv heads"):
        jax_kv.pool_sharding(types.SimpleNamespace(
            axis_names=("tp",), devices=np.zeros((4,)), shape={"tp": 4}),
            2, 1, "tp", "dp")
    pm = PortTransformer(PortConfig(**SERVING_MODEL_KWARGS), device="cpu")
    params = pm.init(0)
    cfg = port_engine.EngineConfig(**ENGINE)
    with pytest.raises(ValueError, match="cannot shard 2 kv heads"):
        port_engine.Engine(pm, params, cfg, device="cpu", mesh=Runtime(
            device=torch.device("cpu"), spec=MeshSpec(tp=4)))
    # fsdp serves (tests/test_torch_serving_fsdp.py); sp and pp wait.
    for axis, item in (("sp", "item 16a"), ("pp", "item 16b's remainder")):
        with pytest.raises(NotImplementedError, match=item):
            port_engine.Engine(pm, params, cfg, device="cpu", mesh=Runtime(
                device=torch.device("cpu"), spec=MeshSpec(**{axis: 2})))
    with pytest.raises(ValueError, match="must divide over the 3 dp"):
        port_engine.Engine(pm, params, cfg, device="cpu", mesh=Runtime(
            device=torch.device("cpu"), spec=MeshSpec(dp=3)))
    engine = types.SimpleNamespace(mesh=types.SimpleNamespace(
        process_count=2, process_index=1))
    srv = ServingServer(engine, port=0)
    assert not srv.is_front
    with pytest.raises(RuntimeError, match="first process"):
        srv.drain()


# -- the engine on a mesh ------------------------------------------------------


_REFS: dict = {}


def _references(models, G: int) -> dict:
    """Per mode, the tokens of the port's one-process engine and of the
    replicated JAX engine, each with the whole slot table and the pool
    ``G·(N−1)+1``."""
    if G in _REFS:
        return _REFS[G]
    jm, jp, pm, pp = models
    kw = dict(ENGINE, num_pages=G * (ENGINE["num_pages"] - 1) + 1)
    out = {}
    for mode, over in MODES.items():
        got = {}
        for name, eng in (
                ("port", port_engine.Engine(
                    pm, pp, port_engine.EngineConfig(**kw, **over),
                    device="cpu")),
                ("jax", jax_engine.Engine(
                    jm, jp, jax_engine.EngineConfig(**kw, **over)))):
            for i, p in enumerate(mesh_prompts()):
                eng.submit(jax_engine.Request(
                    id=f"r{i}", prompt=p, max_new_tokens=NEW_TOKENS)
                    if name == "jax" else port_engine.Request(
                        id=f"r{i}", prompt=p, max_new_tokens=NEW_TOKENS))
            eng.run_until_drained()
            got[name] = {r["id"]: r["tokens"] for r in eng.completed}
            assert eng.cache.pages_used == 0
        out[mode] = got
    out["int8"] = {}
    for name, eng in (
            ("port", port_engine.Engine(
                pm, port_disagg.quantize_params_int8(pp),
                port_engine.EngineConfig(**kw), device="cpu")),
            ("jax", jax_engine.Engine(
                jm, jax_disagg.quantize_params_int8(
                    jax.tree.map(np.asarray, jp)),
                jax_engine.EngineConfig(**kw)))):
        mod = port_engine if name == "port" else jax_engine
        for i, p in enumerate(mesh_prompts()):
            eng.submit(mod.Request(id=f"r{i}", prompt=p,
                                   max_new_tokens=NEW_TOKENS))
        eng.run_until_drained()
        out["int8"][name] = {r["id"]: r["tokens"] for r in eng.completed}
    _REFS[G] = out
    return out


def _spawn(tmp, mesh: dict, pp: dict) -> list:
    """Every process's readings from a gloo world over ``mesh``."""
    import json

    world = int(np.prod(list(mesh.values())))
    out = str(tmp)
    params = os.path.join(out, "params.pt")
    torch.save(flatten(pp), params)
    job = {"world": world, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "mesh": mesh, "model": SERVING_MODEL_KWARGS, "params": params,
           "engine": ENGINE, "new_tokens": NEW_TOKENS}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(
        log[-3000:] for log in logs)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_engine_matches_one_process_and_jax(world, models,
                                                 tmp_path):
    mesh = WORLDS[world]
    G, tp = mesh.get("dp", 1), mesh.get("tp", 1)
    _, _, pm, pp = models
    ranks = _spawn(tmp_path, mesh, pp)
    refs = _references(models, G)
    c = pm.cfg
    L = c.n_layers
    for r in ranks:
        rank = r["rank"]
        what = f"{world} rank {rank}"
        for mode, got in r["modes"].items():
            # Tokens: the one-process engine's and the JAX engine's.
            assert got["tokens"] == refs[mode]["port"], (what, mode)
            assert got["tokens"] == refs[mode]["jax"], (what, mode)
            assert got["pages_left"] == [0] * G, (what, mode)
            assert sorted(set(got["groups"].values())) == list(range(G)), \
                (what, mode, got["groups"])
            # This process's block: its group's pool at its tp rank's
            # contiguous kv heads.
            dp_idx, tp_idx = divmod(rank, tp)
            hkv = c.n_kv_heads // tp
            assert got["pool_shape"] == [1, L, hkv, ENGINE["num_pages"],
                                         ENGINE["page_size"], c.head_dim]
            assert got["kv_heads"] == [tp_idx * hkv, hkv]
            assert got["local_group"] == (dp_idx if G > 1 else None)
            assert got["batch_local"] == ENGINE["max_batch"] // G
            # Collectives by design: each forward 2L + 1 all-reduces over
            # tp (the lookup, each layer's two row-parallel outputs) and
            # one all-gather of the logits; every fetch one all-gather
            # over dp; every step one lock-step gather over the mesh.
            K = 4 if mode == "resident_k_4" else 1
            forwards = got["prefill_launches"] + K * got["decode_launches"]
            assert got["all_reduces"] == (
                {"reduce_from_tp": (2 * L + 1) * forwards} if tp > 1
                else {}), (what, mode)
            assert got["all_gathers"] == (
                {"gather_from_tp": forwards} if tp > 1 else {}), (what, mode)
            want_gathers = {"lockstep": got["n_steps"]}
            if G > 1:
                want_gathers["dp_fetch"] = got["host_syncs"]
            assert got["gathers"] == want_gathers, (what, mode)
            if G > 1:
                assert all(len(s["group_slots_active"]) == G
                           for s in got["steps"])
                assert any(s.get("group_prefill_slots_active")
                           for s in got["steps"]) == (mode != "sequential")
                assert all(len(s["kv_pages_shared"]) == G
                           for s in got["steps"] if "kv_pages_shared" in s)
        # The JAX skewed burst: two admitted a group.
        assert r["burst"]["active"] == [2] * G, what
        assert r["burst"]["groups"] == sorted(list(range(G)) * 2), what
        assert r["burst"]["pages_left"] == [0] * G, what
        # Batch composition: alone or batched, in whatever group.
        comp = r["composition"]
        for i, solo in comp["solo"].items():
            assert solo["tokens"] == comp["batched"][i]["tokens"], (what, i)
        assert r["weights_match_trainer"], what
        assert r["lockstep"] is not None and \
            "out of lock-step at step 0" in r["lockstep"], (what,
                                                            r["lockstep"])
        _check_lifecycle(r["lifecycle"], refs, pm.cfg, G, tp, what)
    # Every process read the same tokens, and stopped and persisted the
    # same requests.
    for r in ranks[1:]:
        for name in ("export", "deadline"):
            mine, first = (x["lifecycle"]["mesh_kv"][name]
                           for x in (r, ranks[0]))
            assert {k: mine[k] for k in ("adopted", "fresh", "persisted")} \
                == {k: first[k] for k in ("adopted", "fresh", "persisted")}
        assert {m: g["tokens"] for m, g in r["modes"].items()} == \
            {m: g["tokens"] for m, g in ranks[0]["modes"].items()}
    if G > 1:
        groups = {i: s["group"] for i, s in
                  ranks[0]["composition"]["solo"].items()}
        assert set(groups.values()) == {0}
        assert any(ranks[0]["composition"]["batched"][i]["group"] != 0
                   for i in groups)


def _check_lifecycle(life: dict, refs: dict, c, G: int, tp: int,
                     what: str) -> None:
    assert life["int8"] == refs["int8"]["port"] == refs["int8"]["jax"], what
    L, D, H, Hkv, hd, F = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                           c.head_dim, c.d_ff)
    want = {"attn/wq": ([L, D, H // tp, hd], [L, 1, H // tp, hd]),
            "attn/wk": ([L, D, Hkv // tp, hd], [L, 1, Hkv // tp, hd]),
            "attn/wv": ([L, D, Hkv // tp, hd], [L, 1, Hkv // tp, hd]),
            "attn/wo": ([L, H // tp, hd, D], [L, 1, 1, D]),
            "mlp/wi": ([L, D, F // tp], [L, 1, F // tp]),
            "mlp/wo": ([L, F // tp, D], [L, 1, D])}
    assert life["int8_shapes"] == {
        k: {"qw": qw, "scale": sc} for k, (qw, sc) in want.items()}, what
    swap = life["swap"]
    assert swap["tokens"] == refs["batched"]["port"], what
    assert swap["swap_stats"] == {"installed": 1, "refused": 0,
                                  "stale_preempted": 0}, what
    assert swap["lost"] and swap["persisted"] == [], what
    assert sorted(swap["lost"]) == swap["drained"], what
    assert swap["requeued"], what
    assert swap["pages_left"] == [0] * G, what
    assert all(v[-1][0] == "v1" for v in swap["versions"].values()), what
    for name, kv in life["mesh_kv"].items():
        assert kv["tokens"] == refs["batched"]["port"], (what, name)
        assert kv["gathers"]["kv_export"] == 1, (what, name)
    assert life["mesh_kv"]["export"]["adopted"], what
    assert life["mesh_kv"]["deadline"]["gathers"]["deadline"] >= 1, what


def test_one_process_engine_keeps_its_single_group_surface(models):
    """With no mesh the engine holds every group's pool (one group), and
    its records and counters keep their single-group form."""
    _, _, pm, pp = models
    eng = port_engine.Engine(pm, pp, port_engine.EngineConfig(**ENGINE),
                             device="cpu")
    assert eng.dp_groups == 1 and eng.cache.local_group is None
    assert tuple(eng.cache.k_pages.shape) == (
        1, pm.cfg.n_layers, pm.cfg.n_kv_heads, ENGINE["num_pages"],
        ENGINE["page_size"], pm.cfg.head_dim)
    recs = []
    for i, p in enumerate(mesh_prompts(n=3)):
        eng.submit(port_engine.Request(id=f"r{i}", prompt=p,
                                       max_new_tokens=4))
    while not eng.idle:
        recs.append(eng.step())
    assert not eng.gathers
    assert all("group_slots_active" not in r for r in recs)
    assert {r["group"] for r in eng.completed} == {0}
    ref = port_engine.Engine(pm, pp, dataclasses.replace(
        eng.cfg, num_pages=65), device="cpu")
    for i, p in enumerate(mesh_prompts(n=3)):
        ref.submit(port_engine.Request(id=f"r{i}", prompt=p,
                                       max_new_tokens=4))
    ref.run_until_drained()
    assert {r["id"]: r["tokens"] for r in ref.completed} == \
        {r["id"]: r["tokens"] for r in eng.completed}

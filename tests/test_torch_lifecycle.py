"""The serving lifecycle of the port, held against the JAX engine.

Same weights, same prompts (numpy, seeded), float32 on the CPU, the same
calls on both engines: ``swap_weights`` (an identical-value swap
mid-decode, a swap to other weights, the refusals, the staleness bound),
``drain`` (to the end and to a deadline), ``export_kv_batch`` /
``export_in_flight`` and ``adopt_batch`` into a fresh engine,
``preempt``, and the emission-state pair. Tokens, streams, reports and
counters must equal the JAX engine's.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
)
from distributed_training_tpu_torch.resilience import faults as port_faults
from distributed_training_tpu_torch.serving import disagg as port_disagg
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.resilience import faults as jax_faults  # noqa: E402
from distributed_training_tpu.serving import disagg as jax_disagg  # noqa: E402
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, max_seq_len=128, dtype="float32",
            param_dtype="float32", pos_encoding="rope",
            tie_embeddings=False)
ENGINE = dict(max_batch=4, page_size=8, num_pages=64, max_seq_len=64,
              prefill_chunk=8)
PROV = {"name": "plan_a", "fingerprint": "fp_a"}


@pytest.fixture(scope="module")
def models():
    jm = Transformer(TransformerConfig(**TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    jp2 = jm.init(jax.random.PRNGKey(1))
    pm = PortTransformer(PortConfig(**TINY), device="cpu")

    def port(p):
        return from_jax_params(jax.tree.map(np.asarray, p), pm.cfg,
                               device="cpu")
    return jm, jp, jp2, pm, port(jp), port(jp2)


class Side:
    """One framework's engine API under one name, so that a scenario
    runs the same calls on both."""

    def __init__(self, name, model, params, params2):
        self.name, self.model = name, model
        self.params, self.params2 = params, params2
        mod = jax_engine if name == "jax" else port_engine
        self.Request, self.Config, self.Engine = (mod.Request,
                                                  mod.EngineConfig,
                                                  mod.Engine)
        self.faults = jax_faults if name == "jax" else port_faults

    def engine(self, params=None, **over):
        kw = {} if self.name == "jax" else {"device": "cpu"}
        prov = over.pop("weights_provenance", None)
        if prov is not None:
            kw["weights_provenance"] = prov
        return self.Engine(self.model,
                           self.params if params is None else params,
                           self.Config(**{**ENGINE, **over}), **kw)

    def fresh(self, params):
        """The same values in new storage (a publish never aliases the
        incumbent)."""
        if self.name == "jax":
            return jax.tree.map(lambda x: jnp.array(x), params)
        return {k: (self.fresh(v) if isinstance(v, dict) else v.clone())
                for k, v in params.items()}


@pytest.fixture(scope="module")
def sides(models):
    jm, jp, jp2, pm, pp, pp2 = models
    return Side("jax", jm, jp, jp2), Side("port", pm, pp, pp2)


def _values(side, params):
    """Every leaf's bytes, in one order on either side: a swap copies
    into the port's tensors in place, so weights are compared by value."""
    if side.name == "jax":
        return [np.asarray(x).tobytes() for x in jax.tree.leaves(params)]
    return {k: t.numpy().tobytes() for k, t in flatten(params).items()}


def _both(sides, scenario):
    want, got = (scenario(s) for s in sides)
    assert got == want
    return got


def _prompts(seed, n=3, size=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, size=size).astype(np.int32)
            for _ in range(n)]


def _submit_streamed(eng, side, prompts, n=8, prefix="r"):
    got: dict = {}
    for i, p in enumerate(prompts):
        rid = f"{prefix}{i}"
        eng.submit(side.Request(id=rid, prompt=p, max_new_tokens=n))
        eng.add_token_listener(
            rid, (lambda r: lambda t, d: got.setdefault(r, []).append(t))(
                rid))
    return got


def _records(eng) -> dict:
    return {r["id"]: (r["tokens"], r["weights_versions"])
            for r in eng.completed}


def test_identical_swap_mid_decode_matches_jax(sides):
    def scenario(side):
        eng = side.engine()
        counts = eng.warmup()
        got = _submit_streamed(eng, side, _prompts(41))
        for _ in range(6):
            eng.step()
        stale = eng.swap_weights(side.fresh(side.params), "v1")
        eng.run_until_drained()
        assert eng.compile_counts() == counts
        return (stale, got, _records(eng), eng.weights_version,
                eng.swap_stats)

    stale, got, recs, version, stats = _both(sides, scenario)
    assert stale == 0 and version == "v1" and stats["installed"] == 1
    assert all([v for v, _n in wv] == ["v0", "v1"]
               for _t, wv in recs.values())


def test_swap_to_other_weights_matches_jax_and_spares_the_callers(sides):
    """A swap to second-seed weights mid-decode: both engines emit the
    same mixed streams, and the port's engine copied the publish into
    its own compute tensors: neither the tree it was built with nor the
    published tree is written."""
    port = sides[1]
    before = {k: t.clone() for k, t in flatten(port.params).items()}
    published = port.fresh(port.params2)
    pub_before = {k: t.clone() for k, t in flatten(published).items()}

    def scenario(side):
        eng = side.engine()
        got = _submit_streamed(eng, side, _prompts(43))
        for _ in range(5):
            eng.step()
        eng.swap_weights(published if side is port
                         else side.fresh(side.params2), "v1")
        eng.run_until_drained()
        return got, _records(eng)

    _both(sides, scenario)
    for k, t in flatten(port.params).items():
        assert torch.equal(t, before[k]), k
    for k, t in flatten(published).items():
        assert torch.equal(t, pub_before[k]), k


def test_swapped_engine_equals_a_fresh_engine_on_the_new_weights(sides):
    port = sides[1]
    prompts = _prompts(45)
    for over in ({}, {"resident_k": 4}):
        eng = port.engine(**over)
        eng.warmup()
        eng.generate(prompts[0], 4)
        eng.swap_weights(port.params2, "v1")
        for i, p in enumerate(prompts):
            eng.submit(port.Request(id=f"n{i}", prompt=p, max_new_tokens=8))
        eng.run_until_drained()
        fresh = port.engine(port.params2, **over)
        for i, p in enumerate(prompts):
            fresh.submit(port.Request(id=f"n{i}", prompt=p,
                                      max_new_tokens=8))
        fresh.run_until_drained()
        want = {r["id"]: r["tokens"] for r in fresh.completed}
        got = {r["id"]: r["tokens"] for r in eng.completed
               if r["id"].startswith("n")}
        assert got == want, over
        assert _values(port, eng.params) == _values(port, port.params2)


def test_swap_refusals_leave_the_engine_serving_as_jax(sides):
    def scenario(side):
        eng = side.engine(weights_provenance=PROV)
        got = _submit_streamed(eng, side, _prompts(47, n=1))
        for _ in range(4):
            eng.step()
        incumbent = _values(side, eng.params)
        errors = []
        bad_leaf = side.fresh(side.params)
        bad_leaf["final_norm"]["scale"] = (
            jnp.zeros((3,)) if side.name == "jax" else torch.zeros(3))
        calls = [
            (side.params, "bad1", {"name": "plan_a",
                                   "fingerprint": "fp_b"}),
            (side.params, "bad2", None),
            ({"lonely": (jnp.zeros((2,)) if side.name == "jax"
                         else torch.zeros(2))}, "bad3", PROV),
            (bad_leaf, "bad4", PROV),
        ]
        for params, version, prov in calls:
            with pytest.raises(ValueError) as e:
                eng.swap_weights(params, version, provenance=prov)
            errors.append(type(e.value).__name__)
        eng.faults = side.faults.FaultInjector(
            side.faults.parse_fault_plan("swap_corrupt@1"))
        with pytest.raises(ValueError) as e:
            eng.swap_weights(side.params, "bad5", provenance=PROV)
        errors.append(type(e.value).__name__)
        eng.faults = None
        assert _values(side, eng.params) == incumbent
        eng.run_until_drained()
        return (errors, eng.weights_version, dict(eng.swap_stats), got,
                _records(eng))

    errors, version, stats, _got, _recs = _both(sides, scenario)
    assert errors == ["ProvenanceError", "ProvenanceError", "ValueError",
                      "ValueError", "ProvenanceError"]
    assert version == "v0"
    assert stats == {"installed": 0, "refused": 5, "stale_preempted": 0}


@pytest.mark.parametrize("resident", [1, 4], ids=["one_token",
                                                  "resident_k_4"])
def test_staleness_bound_zero_preempts_once_streams_each_index_once(
        sides, resident):
    def scenario(side):
        eng = side.engine(swap_staleness_tokens=0, resident_k=resident)
        got = _submit_streamed(eng, side, _prompts(49, n=3), n=10)
        ref = side.engine(resident_k=resident)
        want = _submit_streamed(ref, side, _prompts(49, n=3), n=10)
        ref.run_until_drained()
        # Mid-stream: a resident burst emits up to 4 tokens a step.
        for _ in range(5 if resident == 1 else 2):
            eng.step()
        stale = eng.swap_weights(side.fresh(side.params), "v1")
        again = eng.swap_weights(side.fresh(side.params), "v2")
        eng.run_until_drained()
        assert got == want  # every index delivered once, in order
        return stale, again, dict(eng.swap_stats), got, _records(eng)

    stale, again, stats, _got, recs = _both(sides, scenario)
    assert stale >= 1 and again == 0
    assert stats["stale_preempted"] == stale
    assert all(wv[0][0] != "v0" for _t, wv in recs.values()
               if len(wv) == 1)


def test_drain_report_matches_jax(sides):
    def scenario(side):
        eng = side.engine(max_batch=2)
        rng = np.random.default_rng(53)
        for i in range(4):
            p = rng.integers(1, 255, size=4).astype(np.int32)
            eng.submit(side.Request(id=f"d{i}", prompt=p,
                                    max_new_tokens=4))
        for _ in range(2):
            eng.step()
        rep = eng.drain()
        assert eng.draining and eng.in_flight == 0
        eng.draining = False
        eng.run_until_drained()
        return ({k: rep[k] for k in ("finished", "persisted", "requeued",
                                     "steps")},
                {r["id"]: r["tokens"] for r in eng.completed})

    rep, toks = _both(sides, scenario)
    assert sorted(rep["finished"] + rep["requeued"]) == \
        ["d0", "d1", "d2", "d3"]
    assert rep["persisted"] == [] and len(toks) == 4


def test_export_kv_batch_bit_equal_to_jax(sides):
    """The same requests stepped alike on both engines (the same page
    tables), the port's pools then loaded from the JAX engine's (the
    computed pools agree within summation order only): every in-flight
    sequence's dense KV equals JAX's bit for bit."""
    jside, pside = sides
    engines = [s.engine() for s in sides]
    for eng, side in zip(engines, sides):
        _submit_streamed(eng, side, _prompts(55, n=3, size=11), n=12)
        for _ in range(6):
            eng.step()
    jeng, peng = engines
    assert [s is None for s in jeng.slots] == [s is None
                                               for s in peng.slots]
    peng.cache.k_pages.copy_(torch.from_numpy(
        np.array(jeng.cache.k_pages)))
    peng.cache.v_pages.copy_(torch.from_numpy(
        np.array(jeng.cache.v_pages)))
    ids = [s.req.id for s in jeng.slots if s is not None]
    jk, jv = jax_disagg.export_kv_batch(jeng.cache, ids)
    pk, pv = port_disagg.export_kv_batch(peng.cache, ids)
    assert len(pk) == len(ids) == 3
    for a, b in zip(jk + jv, pk + pv):
        assert b.dtype == torch.float32
        assert np.array_equal(np.asarray(a), b.numpy())
    k1, v1 = port_disagg.export_kv(peng.cache, ids[1])
    assert torch.equal(k1, pk[1]) and torch.equal(v1, pv[1])


def test_drain_deadline_then_adopt_batch_matches_jax(sides):
    def scenario(side):
        eng = side.engine()
        got = _submit_streamed(eng, side, _prompts(59, n=3), n=10)
        for _ in range(5):
            eng.step()
        emission = eng.export_emission_state()
        rep = eng.drain(deadline_s=0.0)
        assert eng.cache.pages_used == 0 and eng.in_flight == 0
        succ = side.engine()
        succ.import_emission_state(emission)
        succ.adopt_batch(rep["export"]["adoptable"])
        for r in rep["export"]["requests"]:
            succ.submit(r)
        pre = succ.prefill_tokens_computed
        succ.run_until_drained()
        assert succ.cache.pages_used == 0
        return ({k: rep[k] for k in ("finished", "persisted", "requeued")},
                [(req.id, toks) for req, toks, _k, _v
                 in rep["export"]["adoptable"]],
                got, {r["id"]: r["tokens"] for r in succ.completed},
                succ.prefill_tokens_computed - pre)

    rep, items, got, toks, prefill = _both(sides, scenario)
    assert rep["persisted"] and rep["finished"] == []
    assert prefill == 0  # nothing re-prefilled
    assert got == toks   # each stream whole and once across the move


def test_adopt_batch_is_atomic_on_failure(sides):
    def scenario(side):
        src = side.engine()
        _submit_streamed(src, side, _prompts(61, n=3, size=20), n=20)
        for _ in range(8):
            src.step()
        items = src.export_in_flight()["adoptable"]
        tight = side.engine(num_pages=5)
        with pytest.raises(RuntimeError):
            tight.adopt_batch(items)
        leaked = (tight.cache.pages_used, tight.in_flight,
                  tight.cache.seqs)
        roomy = side.engine()
        roomy.adopt_batch(items)
        roomy.run_until_drained()
        return (len(items), leaked,
                {r["id"]: r["tokens"] for r in roomy.completed})

    n, leaked, toks = _both(sides, scenario)
    assert n == 3 and leaked == (0, 0, 0) and len(toks) == 3


def test_preempt_matches_jax(sides):
    def scenario(side):
        eng = side.engine()
        rng = np.random.default_rng(61)
        p1 = rng.integers(0, 256, size=12).astype(np.int32)
        eng.submit(side.Request(id="t1", prompt=p1, max_new_tokens=4,
                                session="s"))
        eng.run_until_drained()
        held = eng.cache.pages_used
        prompts = [rng.integers(0, 256, size=10).astype(np.int32)
                   for _ in range(6)]
        got = _submit_streamed(eng, side, prompts, n=5)
        eng.step()
        eng.step()
        lost = eng.preempt()
        listeners = dict(eng._token_listeners)
        state = (eng.cache.pages_used == held, len(eng.sessions),
                 eng.in_flight, len(eng.queue))
        for r in lost:
            eng.submit(r)
        eng.run_until_drained()
        return ([r.id for r in lost], listeners, state, got,
                {r["id"]: r["tokens"] for r in eng.completed})

    ids, listeners, state, got, toks = _both(sides, scenario)
    assert sorted(ids) == [f"r{i}" for i in range(6)]
    assert listeners == {} and state == (True, 1, 0, 0)
    # Tokens emitted before the preemption reached their streams; the
    # resubmitted requests have no listener.
    assert all(len(v) <= 1 for v in got.values())


def test_emission_state_round_trip(sides):
    port = sides[1]
    eng = port.engine()
    got = _submit_streamed(eng, port, _prompts(63, n=2), n=6)
    for _ in range(4):
        eng.step()
    state = eng.export_emission_state()
    assert set(state["listeners"]) == {"r0", "r1"}
    assert state["hwm"] == {k: len(v) for k, v in got.items()}
    other = port.engine()
    other.import_emission_state(state)
    other.import_emission_state(None)
    assert other._emit_hwm == state["hwm"]
    assert set(other._token_listeners) == {"r0", "r1"}

"""Fault injection and the serving supervisor of the port, held against
the JAX package, and the server's swap/drain/undrain controls.

- ``resilience/faults.py``: ``parse_fault_plan`` gives JAX's faults for a
  list of plans and refuses the bad ones alike; the injector's one-shot
  ledger and its serving hooks fire as JAX's do;
- the engine's ``faults`` slot: ``engine_crash@N`` under
  ``supervise_serving`` takes one restart, the KV of every decoding
  sequence is re-adopted, each stream is delivered once and equals the
  uncrashed run (and JAX's supervised run); a crash loop gives up as
  JAX's does; ``slow_decode`` sleeps, ``client_disconnect`` drops one
  listener, both as JAX's;
- ``ServingServer``: a swap through the engine thread keeps the tokens,
  a drain answers 503 with Retry-After while ``/healthz`` says
  "draining", and ``resume_admission`` reopens, over HTTP.

Float32 on the CPU, the same weights on both sides.
"""

import http.client
import json
import os
import time

import numpy as np
import pytest

from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
)
from distributed_training_tpu_torch.resilience import faults as port_faults
from distributed_training_tpu_torch.resilience import (
    integrity as port_integrity,
)
from distributed_training_tpu_torch.resilience import (
    supervisor as port_supervisor,
)
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.serving.server import ServingServer

jax = pytest.importorskip("jax")

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.resilience import faults as jax_faults  # noqa: E402
from distributed_training_tpu.resilience import (  # noqa: E402
    supervisor as jax_supervisor,
)
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, max_seq_len=128, dtype="float32",
            param_dtype="float32", pos_encoding="rope",
            tie_embeddings=False)
ENGINE = dict(max_batch=4, page_size=8, num_pages=64, max_seq_len=64,
              prefill_chunk=8)
NO_WAIT = dict(max_restarts=3, backoff_base_s=0.0, backoff_max_s=0.0)


@pytest.fixture(scope="module")
def models():
    jm = Transformer(TransformerConfig(**TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = PortTransformer(PortConfig(**TINY), device="cpu")
    pp = from_jax_params(jax.tree.map(np.asarray, jp), pm.cfg, device="cpu")
    return {"jax": (jm, jp, jax_engine, jax_faults, jax_supervisor),
            "port": (pm, pp, port_engine, port_faults, port_supervisor)}


def _engine(side, **over):
    model, params, mod, _f, _s = side
    kw = {"device": "cpu"} if mod is port_engine else {}
    return mod.Engine(model, params, mod.EngineConfig(**{**ENGINE, **over}),
                      **kw)


def _prompts(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, size=5).astype(np.int32) for _ in range(n)]


def _uncrashed(side, prompts, n=8) -> dict:
    eng = _engine(side)
    for i, p in enumerate(prompts):
        eng.submit(side[2].Request(id=f"r{i}", prompt=p, max_new_tokens=n))
    eng.run_until_drained()
    return {r["id"]: r["tokens"] for r in eng.completed}


PLANS = [
    "crash@40,sigterm@80,corrupt_ckpt@120,data_stall@60:500ms,"
    "data_error@70,crash@90:always",
    "engine_crash@4,swap_corrupt@2,slow_decode@3:50ms,client_disconnect@5",
    "lose_host@40:host=2,slow_host@30:host=1:200ms",
    "data_corrupt@60:source=wiki:fatal,source_stall@5:1.5s:source=books",
    "data_corrupt@7,crash@40,",
    "",
]
BAD_PLANS = ["crash", "crash@", "meteor@40", "crash@0", "crash@40,crash@40",
             "data_stall@60", "crash@40:500ms", "data_stall@60:500",
             "lose_host@4", "engine_crash@4:host=1", "slow_decode@3",
             "crash@4:skip", "crash@4:source=x"]


@pytest.mark.parametrize("plan", PLANS)
def test_parse_fault_plan_equals_jax(plan):
    want = jax_faults.parse_fault_plan(plan)
    got = port_faults.parse_fault_plan(plan)
    assert [vars(f) for f in got] == [vars(f) for f in want]
    assert [f.key for f in got] == [f.key for f in want]


@pytest.mark.parametrize("plan", BAD_PLANS)
def test_bad_fault_plans_raise_on_both_sides(plan):
    with pytest.raises(jax_faults.FaultPlanError):
        jax_faults.parse_fault_plan(plan)
    with pytest.raises(port_faults.FaultPlanError):
        port_faults.parse_fault_plan(plan)


def test_injector_serving_hooks_and_ledger_match_jax(tmp_path):
    plan = ("engine_crash@3,client_disconnect@3,slow_decode@2:10ms,"
            "swap_corrupt@4,engine_crash@6:always")
    out = {}
    for name, mod in (("jax", jax_faults), ("port", port_faults)):
        ledger = str(tmp_path / f"{name}.json")
        inj = mod.FaultInjector(plan, ledger_path=ledger)
        t0 = time.monotonic()
        fired = [inj.on_launch(n) for n in range(1, 7)]
        slept = time.monotonic() - t0
        swaps = [inj.on_swap(n) for n in (3, 4, 5)]
        again = mod.FaultInjector(plan, ledger_path=ledger)
        refired = [again.on_launch(n) for n in range(1, 7)]
        with open(ledger) as f:
            out[name] = (fired, swaps, refired, json.load(f))
        assert slept >= 0.01
    assert out["port"] == out["jax"]
    fired, swaps, refired, _ = out["port"]
    assert fired[2] == ["client_disconnect", "engine_crash"]
    assert swaps == [False, True, False]
    assert refired == [[], [], [], [], [], ["engine_crash"]]


def test_injector_trainer_hooks_match_jax(tmp_path):
    for mod in (jax_faults, port_faults):
        inj = mod.FaultInjector("data_error@2,data_stall@3:10ms,crash@5")
        inj.on_data(1)
        with pytest.raises(mod.InjectedDataError):
            inj.on_data(2)
        inj.on_data(3)
        with pytest.raises(mod.InjectedCrash):
            inj.on_step(5)
        assert inj.fired == {"data_error@2", "data_stall@3", "crash@5"}
    assert port_faults.LOST_HOST_EXIT_CODE == 97
    for mod in (jax_faults, port_faults):
        root = tmp_path / mod.__name__
        step_dir = root / "3"
        step_dir.mkdir(parents=True)
        (step_dir / "state.bin").write_bytes(b"x" * 256)
        port_integrity.write_manifest(str(step_dir))
        inj = mod.FaultInjector("corrupt_ckpt@3")
        inj.on_checkpoint_saved(2, str(root))
        assert inj.fired == set()
        inj.on_checkpoint_saved(3, str(root))
        assert inj.fired == {"corrupt_ckpt@3"}
        assert port_integrity.verify_manifest(str(step_dir))[1]


def _supervised(side, plan, prompts, ledger, resident=1):
    """``prompts`` served under ``supervise_serving`` with one shared
    injector; each stream collected from its listener."""
    model, params, mod, faults, sup = side
    inj = faults.FaultInjector(faults.parse_fault_plan(plan),
                               ledger_path=ledger)
    got: dict = {}

    def make_engine():
        eng = _engine(side, resident_k=resident)
        eng.faults = inj
        return eng

    def run(eng, incarnation):
        if incarnation == 0:
            for i, p in enumerate(prompts):
                rid = f"r{i}"
                eng.submit(mod.Request(id=rid, prompt=p, max_new_tokens=8))
                eng.add_token_listener(
                    rid, (lambda r: lambda t, d: got.setdefault(
                        r, []).append(t))(rid))
        eng.run_until_drained()
        return eng.finished_total

    res = sup.supervise_serving(make_engine, run,
                                policy=sup.RestartPolicy(**NO_WAIT))
    eng = res["engine"]
    return {"gave_up": res["gave_up"], "incarnations": res["incarnations"],
            "crashes": [c["error"] for c in res["crashes"]],
            "finished": eng.finished_total,
            "pages_used": eng.cache.pages_used,
            "tokens": {r["id"]: r["tokens"] for r in eng.completed},
            "streams": got}


@pytest.mark.parametrize("resident", [1, 4], ids=["one_token",
                                                  "resident_k_4"])
def test_engine_crash_supervised_streams_once_as_jax(models, tmp_path,
                                                     resident):
    prompts = _prompts(61)
    plan = "engine_crash@4" if resident == 1 else "engine_crash@2"
    want = _supervised(models["jax"], plan, prompts,
                       str(tmp_path / "jax.json"), resident)
    got = _supervised(models["port"], plan, prompts,
                      str(tmp_path / "port.json"), resident)
    assert got == want
    ref = _uncrashed(models["port"], prompts)
    assert got["gave_up"] is False and got["incarnations"] == 2
    assert len(got["crashes"]) == 1
    assert "InjectedCrash" in got["crashes"][0]
    assert got["finished"] == 3 and got["pages_used"] == 0
    assert got["streams"] == ref  # each index delivered once


def test_crash_loop_gives_up_as_jax(models):
    out = {}
    for name, side in models.items():
        model, params, mod, faults, sup = side

        def make_engine(side=side, faults=faults):
            eng = _engine(side)
            eng.faults = faults.FaultInjector(
                faults.parse_fault_plan("engine_crash@1"))
            return eng

        def run(eng, incarnation, mod=mod):
            if incarnation == 0:
                eng.submit(mod.Request(id="r0", prompt=np.asarray(
                    [5, 7, 11], np.int32), max_new_tokens=8))
            eng.run_until_drained()
            return eng.finished_total

        res = sup.supervise_serving(
            make_engine, run, policy=sup.RestartPolicy(
                max_restarts=2, backoff_base_s=0.0, backoff_max_s=0.0))
        out[name] = (res["gave_up"], res["incarnations"],
                     len(res["crashes"]), res["restarts"])
    assert out["port"] == out["jax"] == (True, 3, 3, 2)


def test_backoff_matches_jax():
    for kw in ({}, {"jitter": 0.0}, {"seed": 7, "backoff_max_s": 3.0}):
        jp = jax_supervisor.RestartPolicy(**kw)
        pp = port_supervisor.RestartPolicy(**kw)
        assert [pp.backoff_s(n) for n in range(1, 9)] == \
            [jp.backoff_s(n) for n in range(1, 9)]


def test_supervise_serving_incident_dir_waits_for_item_12(models,
                                                          tmp_path):
    """Item 12 has landed: ``incident_dir`` is taken, and a run without
    a crash writes no bundle (tests/test_torch_server_ops.py holds the
    crash bundles against JAX's)."""
    res = port_supervisor.supervise_serving(
        lambda: _engine(models["port"]), lambda e, i: 0,
        incident_dir=str(tmp_path / "incidents"))
    assert (res["result"], res["gave_up"], res["crashes"]) == (0, False, [])
    assert not os.path.exists(tmp_path / "incidents")


@pytest.mark.parametrize("plan", ["slow_decode@3:50ms",
                                  "client_disconnect@3"])
def test_slow_decode_and_client_disconnect_as_jax(models, plan):
    out = {}
    for name, side in models.items():
        mod, faults = side[2], side[3]
        eng = _engine(side)
        eng.faults = faults.FaultInjector(faults.parse_fault_plan(plan))
        got: dict = {}
        for i, p in enumerate(_prompts(71)):
            rid = f"r{i}"
            eng.submit(mod.Request(id=rid, prompt=p, max_new_tokens=6))
            eng.add_token_listener(rid, (lambda r: lambda t, d: got.setdefault(
                r, []).append(t))(rid))
        durs = []
        while not eng.idle:
            t0 = time.monotonic()
            eng.step()
            durs.append(time.monotonic() - t0)
        out[name] = (got, {r["id"]: r["tokens"] for r in eng.completed},
                     sorted(eng.faults.fired), eng._token_listeners)
        if plan.startswith("slow"):
            assert durs[2] >= 0.05
    assert out["port"] == out["jax"]
    got, toks, fired, listeners = out["port"]
    assert fired == [plan.split(":")[0]] and listeners == {}
    if plan.startswith("client"):
        # One stream was severed after launch 3; its request finished.
        assert sum(len(got[r]) < len(toks[r]) for r in toks) == 1


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, json.dumps(body).encode() if body else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), data


def test_server_swap_drain_and_undrain_over_http(models):
    pm, pp = models["port"][:2]
    eng = _engine(models["port"])
    srv = ServingServer(eng, port=0, retry_after_s=2.0).start()
    try:
        body = {"prompt_ids": [3, 1, 4, 1, 5, 9], "max_new_tokens": 6}
        st, _h, first = _http(srv.port, "POST", "/generate", body)
        assert st == 200
        fresh = {k: ({n: t.clone() for n, t in v.items()}
                     if isinstance(v, dict) else v.clone())
                 for k, v in pp.items()}
        assert srv.swap_weights(fresh, "v1") == 0
        assert eng.weights_version == "v1"
        st, _h, again = _http(srv.port, "POST", "/generate", body)
        assert json.loads(again)["tokens"] == json.loads(first)["tokens"]
        with pytest.raises(ValueError, match="structure"):
            srv.swap_weights({"lonely": pp["tok_embed"]}, "v2")
        assert eng.swap_stats == {"installed": 1, "refused": 1,
                                  "stale_preempted": 0}
        report = srv.drain()
        assert report["persisted"] == [] and report["requeued"] == []
        st, _h, health = _http(srv.port, "GET", "/healthz")
        assert st == 200 and json.loads(health)["status"] == "draining"
        st, headers, shed = _http(srv.port, "POST", "/generate", body)
        assert st == 503 and headers["Retry-After"] == "2"
        assert "draining" in json.loads(shed)["error"]
        srv.resume_admission()
        st, _h, health = _http(srv.port, "GET", "/healthz")
        assert json.loads(health)["status"] == "ok"
        st, _h, last = _http(srv.port, "POST", "/generate", body)
        assert st == 200 and json.loads(last)["tokens"] == \
            json.loads(first)["tokens"]
    finally:
        srv.stop()
    assert srv.leaked_threads == 0
    # Without the engine thread the controls run inline.
    idle = ServingServer(_engine(models["port"]), port=0)
    assert idle.drain()["finished"] == [] and idle.draining
    idle.resume_admission()
    assert not idle.draining


def test_server_streams_through_the_high_water_mark(models):
    """A stream whose request is preempted for staleness mid-way gets
    each index once: the server's listener sits behind the engine's
    exactly-once gate."""
    eng = _engine(models["port"], swap_staleness_tokens=0)
    # The engine thread pauses after launch 2, so the swap lands while
    # the request is in flight.
    eng.faults = port_faults.FaultInjector("slow_decode@2:500ms")
    srv = ServingServer(eng, port=0).start()
    try:
        body = {"prompt_ids": [5, 7, 11, 13], "max_new_tokens": 24,
                "stream": True}
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/generate", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        lines = [json.loads(resp.readline())]
        srv.swap_weights(models["port"][1], "v1")
        while "done" not in lines[-1]:
            line = resp.readline()
            if line.strip():
                lines.append(json.loads(line))
        conn.close()
    finally:
        srv.stop()
    streamed = [x["token"] for x in lines if "token" in x]
    assert streamed == lines[-1]["tokens"] and len(streamed) == 24
    assert eng.swap_stats["stale_preempted"] == 1

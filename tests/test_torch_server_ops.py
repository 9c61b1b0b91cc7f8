"""The serving server's observability and refusals in the port, held
against the JAX package (float32 on the CPU, the tiny model, the same
weights on both sides):

- ``telemetry/metrics_server.py``: the same recorded event stream (an
  engine run's records plus training, anomaly and incident records) fed
  to JAX's ``MetricsServer.observe`` and the port's renders the same
  text; each engine's own stream renders the same text once the values
  that derive from the clock are masked;
- ``serving_trace`` records equal JAX's field for field, times aside,
  for the finished, preempted (``preempt``, a stale swap,
  ``export_in_flight``), adopted and resumed (session) outcomes, through
  ``tests/test_torch_lifecycle.py``'s ``Side`` wrapper, and
  ``analyze_traces`` reports alike on both sides' records;
- ``debug_requests_snapshot`` equals JAX's on the same engine state;
- a full queue answers 503 with ``Retry-After`` as JAX's does, and
  ``GET /metrics`` / ``GET /debug/requests`` answer 200;
- a crash under ``supervise_serving(incident_dir=)`` and under
  ``ServingServer(incident_dir=)`` leaves bundles with JAX's files and
  ``meta.json`` keys.
"""

import http.client
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest

from distributed_training_tpu_torch import telemetry as port_tel
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
)
from distributed_training_tpu_torch.resilience import (
    supervisor as port_supervisor,
)
from distributed_training_tpu_torch.serving import server as port_server
from distributed_training_tpu_torch.telemetry import incident as port_incident
from distributed_training_tpu_torch.telemetry import (
    metrics_server as port_metrics,
)
from distributed_training_tpu_torch.telemetry import (
    serving_trace as port_trace,
)

jax = pytest.importorskip("jax")

from distributed_training_tpu import telemetry as jax_tel  # noqa: E402
from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.resilience import (  # noqa: E402
    supervisor as jax_supervisor,
)
from distributed_training_tpu.serving import server as jax_server  # noqa: E402
from distributed_training_tpu.telemetry import incident as jax_incident  # noqa: E402
from distributed_training_tpu.telemetry import (  # noqa: E402
    metrics_server as jax_metrics,
)
from distributed_training_tpu.telemetry import (  # noqa: E402
    serving_trace as jax_trace,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_lifecycle import TINY, Side, _prompts  # noqa: E402

# The trace fields that are times (seconds); everything else must match.
TIMES = ("t", "queue_wait_s", "ttft_s", "e2e_s")


@pytest.fixture(scope="module")
def sides():
    jm = Transformer(TransformerConfig(**TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    jp2 = jm.init(jax.random.PRNGKey(1))
    pm = PortTransformer(PortConfig(**TINY), device="cpu")

    def port(p):
        return from_jax_params(jax.tree.map(np.asarray, p), pm.cfg,
                               device="cpu")
    return Side("jax", jm, jp, jp2), Side("port", pm, port(jp), port(jp2))


def _tel(side):
    return jax_tel if side.name == "jax" else port_tel


def _recorded(side, tmp_path, scenario) -> tuple:
    """``scenario(side)``'s result and the records the engine emitted
    through an installed sink."""
    mod = _tel(side)
    sink = mod.install(mod.Telemetry(
        events_jsonl=str(tmp_path / f"{side.name}.jsonl")))
    records: list = []
    sink.add_observer(records.append)
    try:
        out = scenario(side)
    finally:
        mod.uninstall()
        sink.close()
    return out, records


def _untimed(rec: dict) -> dict:
    """A record with every time replaced by whether it was set."""
    out = {k: (v is not None if k in TIMES else v)
           for k, v in rec.items()}
    if "spans" in out:
        out["spans"] = [{k: v for k, v in s.items() if k != "t"}
                        for s in rec["spans"]]
    return out


def _traces(records) -> list:
    return [_untimed(r) for r in records if r["kind"] == "serving_trace"]


def _submit(eng, side, prompts, n=8, prefix="r", **req):
    for i, p in enumerate(prompts):
        eng.submit(side.Request(id=f"{prefix}{i}", prompt=p,
                                max_new_tokens=n, **req))


# -- the lifecycle trace -------------------------------------------------------


def _finished(side):
    eng = side.engine()
    _submit(eng, side, _prompts(81, n=4, size=11), n=6)
    eng.run_until_drained()


def _finished_sequential_spec(side):
    eng = side.engine(prefill_mode="sequential", spec_k=3)
    _submit(eng, side, _prompts(82, n=3, size=19), n=7)
    eng.run_until_drained()


def _finished_resident(side):
    eng = side.engine(resident_k=4)
    _submit(eng, side, _prompts(83, n=3, size=9), n=9)
    eng.run_until_drained()


def _preempted(side):
    eng = side.engine()
    _submit(eng, side, _prompts(84, n=3), n=8)
    for _ in range(4):
        eng.step()
    for req in eng.preempt():
        eng.submit(req)
    eng.run_until_drained()


def _stale_swap(side):
    eng = side.engine(swap_staleness_tokens=0)
    _submit(eng, side, _prompts(85, n=3), n=8)
    for _ in range(5):
        eng.step()
    eng.swap_weights(side.fresh(side.params2), "v1")
    eng.run_until_drained()


def _adopted(side):
    eng = side.engine()
    _submit(eng, side, _prompts(86, n=3), n=8)
    for _ in range(4):
        eng.step()
    export = eng.export_in_flight()
    fresh = side.engine()
    fresh.adopt_batch(export["adoptable"])
    for req in export["requests"]:
        fresh.submit(req)
    fresh.run_until_drained()


def _resumed(side):
    eng = side.engine(prefix_sharing=True)
    p = _prompts(87, n=1, size=12)[0]
    _submit(eng, side, [p], n=5, prefix="turn1-", session="chat")
    eng.run_until_drained()
    hist = np.concatenate([p, np.array(eng.completed[-1]["tokens"],
                                       np.int32)])
    _submit(eng, side, [hist], n=4, prefix="turn2-", session="chat")
    _submit(eng, side, [np.concatenate([hist, p[:5]])], n=4,
            prefix="turn3-", session="chat")
    _submit(eng, side, [p], n=3, prefix="shared-")
    eng.run_until_drained()


SCENARIOS = {"finished": _finished,
             "finished_sequential_spec": _finished_sequential_spec,
             "finished_resident": _finished_resident,
             "preempted": _preempted, "stale_swap": _stale_swap,
             "adopted": _adopted, "resumed": _resumed}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serving_trace_records_match_jax(sides, tmp_path, name):
    got = {}
    for side in sides:
        _out, records = _recorded(side, tmp_path, SCENARIOS[name])
        got[side.name] = records
    want, mine = _traces(got["jax"]), _traces(got["port"])
    assert mine == want
    outcomes = {t["outcome"] for t in mine}
    spans = {s["ev"] for t in mine for s in t["spans"]}
    assert set(mine[0]) == set(port_trace.TRACE_KEYS) | {"kind", "t"}
    assert spans <= set(port_trace.SPAN_EVENTS)
    expect = {"preempted": {"preempted", "finished"},
              "stale_swap": {"preempted", "finished"},
              "adopted": {"preempted", "finished"}}.get(name, {"finished"})
    assert outcomes == expect
    if name == "adopted":
        assert "adopted" in spans
    if name == "resumed":
        assert {"resumed", "session_retain"} <= spans
        assert any(t["prefix_hit_tokens"] for t in mine)
    # The analyzer reads either side's records alike.
    traces = port_trace.iter_traces(got["port"])
    assert port_trace.analyze_traces(traces) == \
        jax_trace.analyze_traces(traces)
    rep = port_trace.analyze_traces(traces)
    assert port_trace.render_serving_lines(rep) == \
        jax_trace.render_serving_lines(rep)
    counts = ("requests", "preemptions", "tokens_discarded",
              "prefix_hit_rate", "preempt_retry_cost", "prefill_launches",
              "prefill_tokens_per_launch", "decode_bursts",
              "decode_emitted_per_burst")
    theirs = jax_trace.analyze_traces(jax_trace.iter_traces(got["jax"]))
    assert {k: rep["overall"].get(k) for k in counts} == \
        {k: theirs["overall"].get(k) for k in counts}


def test_trace_module_constants_and_slo_equal_jax(tmp_path):
    assert port_trace.TRACE_KEYS == jax_trace.TRACE_KEYS
    assert port_trace.SPAN_EVENTS == jax_trace.SPAN_EVENTS
    assert port_trace.OUTCOMES == jax_trace.OUTCOMES
    assert port_trace.slo_deadlines_from_conf() == \
        jax_trace.slo_deadlines_from_conf()
    conf = tmp_path / "slo.yaml"
    conf.write_text("slo:\n  ttft_s: 0.5\n  per_token_s: 0.01\n")
    assert port_trace.slo_deadlines_from_conf(str(conf)) == \
        jax_trace.slo_deadlines_from_conf(str(conf)) == (0.5, 0.01)
    rng = np.random.default_rng(5)
    recs = [{"outcome": "finished", "tenant": f"t{i % 3}",
             "ttft_s": float(rng.uniform(0, 0.4)),
             "e2e_s": float(rng.uniform(0.4, 2.0)),
             "new_tokens": int(rng.integers(1, 40)),
             "queue_wait_s": float(rng.uniform(0, 0.1)),
             "prompt_tokens": 16, "prefix_hit_tokens": 8}
            for i in range(30)]
    for dl in ((0.25, 0.05), (0.1, 0.2)):
        assert port_trace.slo_attainment(recs, *dl) == \
            jax_trace.slo_attainment(recs, *dl)
        assert port_trace.analyze_traces(recs, *dl) == \
            jax_trace.analyze_traces(recs, *dl)


# -- /metrics ------------------------------------------------------------------


# Families whose values come from the clock: masked when two engines'
# own streams are compared.
CLOCK = ("dtt_serving_tokens_per_s", "dtt_serving_prefill_tokens_per_s",
         "dtt_serving_ttft_seconds", "dtt_serving_time_to_first_token",
         "dtt_serving_e2e_seconds", "dtt_serving_queue_wait_seconds")


def _masked(text: str) -> str:
    return "\n".join(re.sub(r" \S+$", " X", line)
                     if line.startswith(CLOCK) else line
                     for line in text.splitlines())


def _other_records() -> list:
    """Training, anomaly and incident records that exercise the
    observer's other branches."""
    return [
        {"kind": "span", "name": "compile", "dur_s": 3.0},
        {"kind": "span", "name": "step", "dur_s": 0.25},
        {"kind": "span", "name": "data_wait", "dur_s": 0.01},
        {"kind": "span", "name": "data_assemble", "dur_s": 0.02},
        {"kind": "goodput", "mfu_wall": 0.31, "goodput": 0.9},
        {"kind": "attribution", "overlap_frac": 0.5, "compute_frac": 0.7,
         "collective_frac": 0.2, "host_frac": 0.1},
        {"kind": "attribution_static", "overlap_score": 0.4},
        {"kind": "straggler", "persistent": [2]},
        {"kind": "resume", "world_size": 4, "restarts": 1},
        {"kind": "clock_sync", "process_count": 4},
        {"kind": "collectives", "bytes_per_step": 1 << 20},
        {"kind": "anomaly", "signal": "step_time"},
        {"kind": "anomaly_baseline", "step_time_s": 0.2,
         "data_wait_s": 0.01},
        {"kind": "incident"},
        {"kind": "serving", "op": "decode", "dur_s": 0.01, "tokens": 8,
         "in_flight": 4, "queue_depth": 1, "pages_used": 10,
         "pages_total": 63, "group_slots_active": [2, 2],
         "group_pages_used": [5, 5], "group_seqs": [2, 2],
         "group_prefill_slots_active": [1, 0], "kv_pages_shared": [0, 1],
         "spec_accepted_mean": 1.5, "host_syncs_per_token": 0.125,
         "resident_steps_per_launch": 4.0, "weight_bytes": 1000,
         "prefix_hit_tokens": 16, "prefill_tokens_saved": 16,
         "sessions_resident": 1},
        {"kind": "serving_request", "tenant": "acme", "ttft_s": 0.004,
         "latency_s": 0.3, "queue_wait_s": 0.002, "new_tokens": 12},
    ]


def _engine_records(side, tmp_path) -> list:
    def scenario(side):
        eng = side.engine(prefix_sharing=True)
        _submit(eng, side, _prompts(91, n=4, size=10), n=6)
        _submit(eng, side, _prompts(91, n=2, size=10), n=3, prefix="s",
                tenant="acme")
        eng.run_until_drained()
    return _recorded(side, tmp_path, scenario)[1]


def test_metrics_render_matches_jax(sides, tmp_path):
    jax_recs = _engine_records(sides[0], tmp_path)
    port_recs = _engine_records(sides[1], tmp_path)
    # One recorded stream into both observers: the same text.
    stream = port_recs + _other_records()
    texts = []
    for mod in (jax_metrics, port_metrics):
        ms = mod.MetricsServer(0, tokens_per_step=4096.0,
                               info={"world_size": 1, "host": "h"})
        for rec in stream:
            ms.observe(rec)
        texts.append(ms.render())
    assert texts[1] == texts[0]
    assert "dtt_serving_requests_total 7" in texts[1]
    assert 'dtt_serving_group_kv_pages_used{group="1"} 5' in texts[1]
    # Each engine's own stream: the same text with the clock masked.
    own = []
    for mod, recs in ((jax_metrics, jax_recs), (port_metrics, port_recs)):
        ms = mod.MetricsServer(0)
        for rec in recs:
            ms.observe(rec)
        own.append(_masked(ms.render()))
    assert own[1] == own[0]
    assert port_metrics.HIST_BUCKETS == jax_metrics.HIST_BUCKETS
    assert port_metrics.PROM_CONTENT_TYPE == jax_metrics.PROM_CONTENT_TYPE


def test_metrics_health_follows_jax():
    for mod in (jax_metrics, port_metrics):
        ms = mod.MetricsServer(0, stall_timeout_s=0.0)
        assert ms.health() == (True, {"steps": 0, "status": "ok",
                                      "stall_watch": "disabled"})
        ms = mod.MetricsServer(0, stall_timeout_s=1e-3)
        ms.observe({"kind": "span", "name": "step", "dur_s": 0.1})
        time.sleep(0.01)
        ok, detail = ms.health()
        assert not ok and detail["status"] == "stalled"


# -- /debug/requests -----------------------------------------------------------


def test_debug_requests_matches_jax(sides):
    def snap(side):
        eng = side.engine(prefix_sharing=True)
        ps = _prompts(95, n=3, size=13)
        _submit(eng, side, ps, n=8)
        _submit(eng, side, ps[:1], n=4, prefix="again-", tenant="acme")
        _submit(eng, side, _prompts(96, n=2), n=4, prefix="q")
        for _ in range(3):
            eng.step()
        eng.swap_weights(side.fresh(side.params), "v1",
                         provenance=None)
        eng.step()
        mod = jax_server if side.name == "jax" else port_server
        return mod.debug_requests_snapshot(eng)

    want, got = (snap(s) for s in sides)
    assert got == want
    assert got["in_flight"] == 4 and got["queue_depth"] == 2
    assert all(r["pages_held"] > 0 for r in got["requests"])


# -- load shedding and the HTTP endpoints --------------------------------------


def _request(port: int, method: str, path: str, body=None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, resp.getheader("Retry-After"), raw


def test_full_queue_answers_503_with_retry_after_as_jax(sides):
    """The engine's step is held while one request waits in its queue:
    with ``max_queue_depth`` 1 the next POST is shed."""
    body = {"prompt_ids": [3, 1, 4, 1, 5], "max_new_tokens": 3}
    out = {}
    for side in sides:
        mod = jax_server if side.name == "jax" else port_server
        eng = side.engine()
        entered, release = threading.Event(), threading.Event()
        step = eng.step

        def held_step(step=step, entered=entered, release=release):
            entered.set()
            release.wait(60)
            return step()
        eng.step = held_step
        srv = mod.ServingServer(eng, port=0, max_queue_depth=1,
                                retry_after_s=3.0)
        assert srv.start() is not None
        first: dict = {}
        t = threading.Thread(target=lambda: first.update(
            r=_request(srv.port, "POST", "/generate", body)))
        try:
            t.start()
            assert entered.wait(60)
            st, retry, raw = _request(srv.port, "POST", "/generate", body)
            release.set()
            t.join(60)
        finally:
            release.set()
            srv.stop()
        assert not t.is_alive()
        out[side.name] = (st, retry, json.loads(raw)["error"],
                          first["r"][0])
    assert out["port"] == out["jax"] == (
        503, "3", "queue full (depth 1 >= 1)", 200)


def test_metrics_and_debug_requests_answer_200(sides, tmp_path):
    port = sides[1]
    eng = port.engine()
    sink = port_tel.install(port_tel.Telemetry(
        events_jsonl=str(tmp_path / "events.jsonl")))
    srv = port_server.ServingServer(eng, port=0, metrics_port=0,
                                    telemetry=sink)
    try:
        assert srv.start() is not None
        bodies = [{"prompt_ids": p.tolist(), "max_new_tokens": 4,
                   "tenant": "acme"} for p in _prompts(97, n=3)]
        for b in bodies:
            assert _request(srv.port, "POST", "/generate", b)[0] == 200
        st, _r, text = _request(srv.port, "GET", "/metrics")
        st2, _r, dbg = _request(srv.port, "GET", "/debug/requests")
        conn = http.client.HTTPConnection("127.0.0.1", srv.metrics.port,
                                          timeout=60)
        conn.request("GET", "/metrics")
        own = conn.getresponse()
        own_text = own.read().decode()
        conn.close()
    finally:
        srv.stop()
        port_tel.uninstall()
        sink.close()
    text = text.decode()
    assert (st, st2, own.status) == (200, 200, 200)
    assert "dtt_serving_requests_total 3" in text
    assert 'dtt_serving_time_to_first_token_seconds_count{tenant="acme"} 3' \
        in text
    assert own_text.splitlines()[:3] == text.splitlines()[:3]
    assert json.loads(dbg) == {
        "in_flight": 0, "queue_depth": 0, "draining": False,
        "weights": {"version": "v0", "provenance": None,
                    "swaps": {"installed": 0, "refused": 0,
                              "stale_preempted": 0}},
        "requests": []}
    assert srv.leaked_threads == 0


# -- incident bundles ----------------------------------------------------------


def _bundles(root) -> dict:
    """kind → (sorted files, sorted meta keys) of every bundle."""
    out = {}
    for d in sorted(os.listdir(root)):
        path = os.path.join(root, d)
        assert port_incident.is_incident_bundle(path), d
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        out.setdefault(meta["kind"], set()).add(
            (tuple(sorted(os.listdir(path))), tuple(sorted(meta))))
    return out


def test_incident_module_constants_equal_jax():
    assert port_incident.KINDS == jax_incident.KINDS
    assert port_incident.SCHEMA == jax_incident.SCHEMA
    assert port_incident.BUNDLE_CORE_FILES == jax_incident.BUNDLE_CORE_FILES
    assert port_incident.BUNDLE_OPTIONAL_FILES == \
        jax_incident.BUNDLE_OPTIONAL_FILES
    assert port_incident.TRIGGER_FILE == jax_incident.TRIGGER_FILE
    assert port_incident._device_memory_stats() == []


def _supervised_bundles(side, root) -> dict:
    sup = jax_supervisor if side.name == "jax" else port_supervisor

    def make_engine():
        eng = side.engine()
        eng.faults = side.faults.FaultInjector(
            side.faults.parse_fault_plan("engine_crash@1"))
        return eng

    def run(eng, incarnation):
        if incarnation == 0:
            _submit(eng, side, _prompts(98, n=2), n=6)
        eng.run_until_drained()

    res = sup.supervise_serving(
        make_engine, run, incident_dir=str(root),
        policy=sup.RestartPolicy(max_restarts=1, backoff_base_s=0.0,
                                 backoff_max_s=0.0))
    assert res["gave_up"]
    return _bundles(root)


def _server_bundles(side, root) -> dict:
    mod = jax_server if side.name == "jax" else port_server
    eng = side.engine()
    eng.faults = side.faults.FaultInjector(
        side.faults.parse_fault_plan("engine_crash@2"))
    srv = mod.ServingServer(eng, port=0, incident_dir=str(root))
    assert srv.start() is not None
    try:
        _request(srv.port, "POST", "/generate",
                 {"prompt_ids": [5, 7, 11], "max_new_tokens": 6})
        deadline = time.monotonic() + 60
        while srv.engine_error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        st, retry, _raw = _request(srv.port, "POST", "/generate",
                                   {"prompt_ids": [5], "max_new_tokens": 2})
    finally:
        srv.stop()
    assert (st, retry) == (503, "1")
    return _bundles(root)


@pytest.mark.parametrize("where", ["supervise_serving", "server"])
def test_crash_bundle_files_and_meta_keys_match_jax(sides, tmp_path, where):
    make = _supervised_bundles if where == "supervise_serving" \
        else _server_bundles
    got = {s.name: make(s, tmp_path / s.name) for s in sides}
    assert got["port"] == got["jax"]
    kinds = {"engine_crash", "give_up"} if where == "supervise_serving" \
        else {"engine_crash"}
    assert set(got["port"]) == kinds
    files = {f for variants in got["port"].values() for fs, _m in variants
             for f in fs}
    assert "serving_requests.json" in files

"""The serving server's own entry point in the port, on the CPU:

- ``engine_config_from_yaml`` equals JAX's for every committed serving
  plan and the default YAML's engine block, with the 0, ``False`` and
  ``swap_staleness_tokens: 0`` cases;
- ``build_server`` and ``main([... "--device", "cpu"])`` answer
  ``POST /generate`` in one process with the tokens of a one-process
  engine; without ``--device cpu`` they need a card;
- the gate: ``python -m distributed_training_tpu_torch.serving.server
  --artifact A --plan serving_4dev_cpu_decode`` in a gloo world of 4
  (dp 2 x tp 2, one process per rank) answers ``POST /generate`` with
  the tokens of a one-process engine; a drain and a resume sent over
  HTTP reach every rank; SIGINT to the first rank ends all four
  processes with exit code 0.

A is exported by the port from a two-step CPU training run of the plan's
model (``tests/test_torch_server_world.py``), made once per test
process; the world and the one-process CLI run are spawned once per test
process and shared.
"""

import dataclasses
import http.client
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import yaml

from distributed_training_tpu_torch.parallel import planner as port_planner
from distributed_training_tpu_torch.runtime import NoCudaDeviceError
from distributed_training_tpu_torch.serving import server as port_server
from distributed_training_tpu_torch.serving.disagg import WeightStore
from distributed_training_tpu_torch.serving.engine import Engine, Request
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu.parallel import planner as jax_planner  # noqa: E402
from distributed_training_tpu.serving import server as jax_server  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_server_world.py")
sys.path.insert(0, os.path.dirname(WORKER))
from test_torch_server_world import (  # noqa: E402
    CONFIG,
    PLAN,
    serve,
    server_prompts,
)

NEW_TOKENS = 8
WAIT_S = 180
SERVING_PLANS = sorted(f[:-5] for f in os.listdir(port_planner.PLANS_DIR)
                       if f.startswith("serving_"))
DEFAULT_ENGINE = yaml.safe_load(open(CONFIG))["engine"]


# -- engine_config_from_yaml ---------------------------------------------------


BLOCKS = {
    "default_yaml": DEFAULT_ENGINE,
    "empty": {},
    "zeros_keep_the_plan": dict(max_batch=0, num_pages=0, max_seq_len=0,
                                prefill_slots=0, resident_k=0, eos_id=0,
                                temperature=0.0, top_k=0, policy=""),
    "prefix_sharing_false": dict(DEFAULT_ENGINE, prefix_sharing=False),
    "staleness_zero": dict(DEFAULT_ENGINE, swap_staleness_tokens=0),
    "set": dict(max_batch=8, page_size=8, prefill_chunk=8, num_pages=40,
                prefill_mode="batched", spec_k=4, resident_k=4,
                eos_id=3, policy="decode", temperature=0.0, top_k=5,
                prefix_sharing=True, swap_staleness_tokens=-1),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("name", SERVING_PLANS)
def test_engine_config_from_yaml_matches_jax(name, block):
    want = jax_server.engine_config_from_yaml(jax_planner.load_plan(name),
                                              BLOCKS[block])
    got = port_server.engine_config_from_yaml(
        port_planner.load_plan(name), BLOCKS[block])
    fields = [f.name for f in dataclasses.fields(want)]
    assert {f: getattr(got, f) for f in fields} == dataclasses.asdict(want)
    if block == "prefix_sharing_false":
        assert got.prefix_sharing is False
    if block == "staleness_zero":
        assert got.swap_staleness_tokens == 0


def test_no_deferral_names_left_in_the_port():
    """No deferral that a landed slice made untrue is left: items 12 and
    13's names, and any mention of items 14 (resilience and exactly-once
    data) and 15 (telemetry and utils), of item 3 (the remat and dropout
    refusals named its RoPE/GQA half), of item 7 (serving on a mesh,
    which the ``apply`` refusal under tp named) and of item 16 undivided
    (its refusals now name 16a-16d), no refusal of sequence parallelism
    (the ``sp`` axis, ring and Ulysses attention), and no refusal of
    pipeline parallelism (the runtime's ``"pp"`` entry, and any item 16b
    but serving's remainder), no refusal of MoE (any item 16c but a
    composition's remainder), no mention of item 16d (ResNet runs), and
    none of item 17b (the planner's search and serving over fsdp): no
    ``MESH_AXIS_ITEMS["fsdp"]`` refusal. Items 17c-17f's deferrals
    stay."""
    names = ("OPS_ITEM", "CLI_ITEM", "MESH_ITEM", "INCIDENTS_ITEM",
             '"sp": "16', "is sequence-parallel attention, which waits",
             '"pp": "16', "_UNPORTED_AXES", 'MESH_AXIS_ITEMS["fsdp"]',
             "MESH_AXIS_ITEMS['fsdp']", '"fsdp": "ROADMAP')
    item14 = re.compile(r"items?\s+(?:14|15|16|3|7)\b"
                        r"|16b(?!'s remainder)|16c(?!'s remainder)|16d"
                        r"|17b")
    pkg = os.path.join(REPO, "distributed_training_tpu_torch")
    found = []
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    text = fh.read()
                found += [(f, n) for n in names if n in text]
                found += [(f, m.group(0)) for m in item14.finditer(text)]
    assert found == []


# -- the artifact and the references -------------------------------------------


_RUNS: dict = {}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory) -> str:
    """A, exported once per test process."""
    if "artifact" not in _RUNS:
        out = tmp_path_factory.mktemp("server_artifact")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        proc = subprocess.run([sys.executable, WORKER, str(out)], env=env,
                              capture_output=True, text=True,
                              timeout=WAIT_S)
        assert proc.returncode == 0, proc.stderr[-3000:]
        _RUNS["artifact"] = str(out / "model.pt")
    return _RUNS["artifact"]


def _mesh_one_plan(path) -> str:
    """The decode plan's model, slots and length at a mesh of 1, saved
    by the port's ``save_plan``."""
    src = port_planner.load_plan(PLAN)
    model = port_planner.model_for_plan(src, device="cpu")
    return port_planner.save_plan(port_planner.Plan(
        name=f"{PLAN}_mesh1", devices=1,
        mesh={a: 1 for a in port_planner.MESH_AXES}, base_strategy="ddp",
        remat="none", batch_per_shard=src.batch_per_shard,
        seq_len=src.seq_len, batch_axes=["dp", "fsdp"],
        sharding_map={k: [] for k in flatten(model.param_shapes())},
        inputs={"model_kwargs": dict(src.inputs["model_kwargs"])}),
        str(path))


def _reference(artifact: str, groups: int = 1) -> dict:
    """The tokens of one process's engine under the decode plan's YAML
    geometry, with the pool of ``groups`` dp groups."""
    key = ("ref", groups)
    if key not in _RUNS:
        plan = port_planner.load_plan(PLAN)
        cfg = port_server.engine_config_from_yaml(plan, DEFAULT_ENGINE)
        cfg = dataclasses.replace(
            cfg, num_pages=groups * (cfg.num_pages - 1) + 1)
        store = WeightStore(artifact)
        eng = Engine(port_planner.model_for_plan(plan, device="cpu"),
                     store.params_for(None, dataclasses.replace(
                         plan, mesh={a: 1 for a in plan.mesh}), "cpu"),
                     cfg, device="cpu")
        for i, p in enumerate(server_prompts()):
            eng.submit(Request(id=str(i), prompt=p,
                               max_new_tokens=NEW_TOKENS))
        eng.run_until_drained()
        _RUNS[key] = {int(r["id"]): r["tokens"] for r in eng.completed}
    return _RUNS[key]


# -- HTTP ----------------------------------------------------------------------


def _http(port: int, method: str, path: str, body=None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, resp.getheader("Retry-After"), raw


def _generate_all(port: int, prompts: list) -> dict:
    """The prompts as concurrent POST /generate requests."""
    out: dict = {}

    def client(i):
        st, _r, raw = _http(port, "POST", "/generate", {
            "prompt_ids": prompts[i].tolist(),
            "max_new_tokens": NEW_TOKENS})
        out[i] = (st, json.loads(raw))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert all(out[i][0] == 200 for i in out), out
    return {i: r["tokens"] for i, (_s, r) in out.items()}


class _Lines:
    """A process's standard output, line by line, read on a thread."""

    def __init__(self, proc):
        self.q: queue.Queue = queue.Queue()
        self.lines: list = []
        threading.Thread(target=self._pump, args=(proc,),
                         daemon=True).start()

    def _pump(self, proc):
        for line in proc.stdout:
            self.q.put(line)
        self.q.put(None)

    def json_line(self, key: str, value) -> dict:
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            try:
                line = self.q.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                break
            self.lines.append(line)
            if line.startswith("{"):
                rec = json.loads(line)
                if rec.get(key) == value:
                    return rec
        raise AssertionError(f"no {key}={value} line in {self.lines}")


def _run_servers(args: list, world: int, cwd, scenario) -> dict:
    """Start the CLI in ``world`` processes, run ``scenario(port)``
    against the first one's port, then SIGINT the first process and
    collect every process's exit code and stop line."""
    procs = serve(args, world, str(cwd))
    readers = [_Lines(p) for p in procs]
    try:
        ready = [r.json_line("serving", "ready") for r in readers]
        out = scenario(ready[0]["port"])
        procs[0].send_signal(signal.SIGINT)
        out["stopped"] = [r.json_line("serving", "stopped")
                          for r in readers]
        out["rcs"] = [p.wait(timeout=WAIT_S) for p in procs]
        out["ready"] = ready
    except BaseException:
        logs = []
        for r in range(world):
            with open(os.path.join(cwd, f"rank{r}.log")) as f:
                logs.append(f.read()[-3000:])
        print("\n".join(logs))
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _world_scenario(port: int) -> dict:
    out = {"tokens": _generate_all(port, server_prompts())}
    out["metrics"] = _http(port, "GET", "/metrics")[2].decode()
    out["debug"] = json.loads(_http(port, "GET", "/debug/requests")[2])
    st, _r, raw = _http(port, "POST", "/drain")
    out["drain"] = (st, json.loads(raw))
    out["drained_health"] = json.loads(_http(port, "GET", "/healthz")[2])
    st, retry, raw = _http(port, "POST", "/generate",
                           {"prompt_ids": [1, 2, 3], "max_new_tokens": 2})
    out["shed"] = (st, retry, json.loads(raw)["error"])
    out["resume"] = _http(port, "POST", "/resume")[0]
    out["after"] = _generate_all(port, server_prompts()[:2])
    return out


@pytest.fixture(scope="module")
def world(artifact, tmp_path_factory) -> dict:
    """The CLI under the committed plan in a gloo world of 4, once per
    test process."""
    if "world" not in _RUNS:
        cwd = tmp_path_factory.mktemp("server_world")
        _RUNS["world"] = _run_servers(
            ["--artifact", artifact, "--plan", PLAN, "--config", CONFIG,
             "--port", "0", "--metrics-port", "0", "--device", "cpu"],
            4, cwd, _world_scenario)
        _RUNS["world"]["cwd"] = str(cwd)
    return _RUNS["world"]


def test_world_of_4_answers_with_one_process_tokens(artifact, world):
    ref = _reference(artifact, groups=2)
    assert world["tokens"] == ref
    assert world["after"] == {i: ref[i] for i in range(2)}
    assert len({tuple(t) for t in ref.values()}) > 1
    assert [r["front"] for r in world["ready"]] == [True] + [False] * 3
    n = len(server_prompts()) + 2
    assert f"dtt_serving_requests_total {n - 2}" in world["metrics"]
    assert 'dtt_serving_group_slots_active{group="1"}' in world["metrics"]
    assert world["debug"]["weights"]["provenance"]["name"] == PLAN
    assert world["debug"]["in_flight"] == 0


def test_world_drain_over_http_reaches_every_rank(world):
    st, rep = world["drain"]
    assert st == 200 and rep["persisted"] == [] and rep["requeued"] == []
    assert world["drained_health"]["status"] == "draining"
    assert world["shed"] == (503, "1",
                             "draining: not admitting new requests")
    assert world["resume"] == 200
    for rank, stop in enumerate(world["stopped"]):
        assert stop["control"] == {"drain": 1, "undrain": 1}, rank
        assert stop["draining"] is False, rank
        assert stop["requests_finished"] == len(server_prompts()) + 2, rank


def test_world_stop_ends_every_rank(world):
    assert world["rcs"] == [0, 0, 0, 0]
    assert all(s["engine_error"] is None and s["leaked_threads"] == 0
               for s in world["stopped"])
    # Only the first process records the serving telemetry.
    events = os.path.join(world["cwd"], "outputs", "serving",
                          "events.jsonl")
    with open(events) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("serving_trace") == len(server_prompts()) + 2


# -- one process ---------------------------------------------------------------


def test_entry_points_need_a_card_unless_cpu_is_named(artifact, tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(NoCudaDeviceError):
        port_server.build_server(artifact, PLAN)
    with pytest.raises(NoCudaDeviceError):
        port_server.main(["--artifact", artifact, "--plan", PLAN,
                          "--port", "0"])


def test_build_server_answers_with_one_process_tokens(artifact, tmp_path):
    srv = port_server.build_server(
        artifact, _mesh_one_plan(tmp_path / "mesh1.json"), port=0,
        engine_block=DEFAULT_ENGINE,
        server_block={"max_queue_depth": 64, "retry_after_s": 2.0},
        device="cpu")
    assert srv.engine.weights_provenance["name"] == PLAN
    assert (srv.max_queue_depth, srv.retry_after_s) == (64, 2.0)
    assert srv.start() is not None
    try:
        got = _generate_all(srv.port, server_prompts())
    finally:
        srv.stop()
    assert got == _reference(artifact)
    assert srv.leaked_threads == 0


def _one_scenario(port: int) -> dict:
    return {"tokens": _generate_all(port, server_prompts()),
            "metrics": _http(port, "GET", "/metrics")[2].decode(),
            "debug": _http(port, "GET", "/debug/requests")[0]}


def test_main_on_the_cpu_answers_with_one_process_tokens(artifact,
                                                         tmp_path):
    plan = _mesh_one_plan(tmp_path / "mesh1.json")
    run = _run_servers(["--artifact", artifact, "--plan", plan,
                        "--config", CONFIG, "--port", "0",
                        "--metrics-port", "0", "--device", "cpu"],
                       1, tmp_path, _one_scenario)
    assert run["tokens"] == _reference(artifact)
    assert run["rcs"] == [0] and run["debug"] == 200
    n = len(server_prompts())
    assert f"dtt_serving_requests_total {n}" in run["metrics"]
    assert re.search(
        r'dtt_serving_time_to_first_token_seconds_count\{tenant="default"\} '
        f"{n}$", run["metrics"], re.M)
    assert {k: v["launches"] for k, v in
            run["stopped"][0]["kernel_launches"].items()} == \
        {"flash_fwd": 0, "paged_decode": 0}
    assert os.path.isdir(tmp_path / "outputs" / "serving")

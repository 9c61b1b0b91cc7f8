"""The port's elastic world-size policy and resharded restore against the
JAX package.

- ``per_shard_batch``, ``lost_hosts_of`` (launcher reports, eviction
  sentinels and the eviction-request file) and ``ElasticPolicy``'s
  decisions over a table of states and exits equal JAX's.
- ``supervise`` with an elastic policy, driven by scripted incarnations
  that return ``GroupReport``s (a lost host, a grow-back at a checkpoint
  boundary, a coordinated eviction), gives JAX's environments, incidents
  and events.
- A resharded restore: a gloo world of 2 under ``fsdp`` saves (with
  ``gather_on_save``); restored at world 1 the state equals the
  consolidated artifact that the world gathered, bit for bit, and its
  sharded manifest covers every rank file plus ``meta.json`` and
  ``layout.json``. The ddp step saved at world 4 in the e2e below,
  restored at world 3, equals its consolidated artifact too.
- End to end, in subprocesses: ``launch --supervise --elastic`` with
  ``lose_host@6:host=2`` in a gloo world of 4 shrinks to 3, resumes from
  step 4 through the resharded restore, and finishes: the batches taken
  (``data_batch`` records, the last of each step) equal the uninterrupted
  world-1 run's, step for step, each sample once, and the final losses
  agree within 1e-4.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.checkpoint import consolidate
from distributed_training_tpu_torch.launch import local as port_launch
from distributed_training_tpu_torch.resilience import elastic as port_el
from distributed_training_tpu_torch.resilience import integrity
from distributed_training_tpu_torch.resilience import supervisor as port_sup
from distributed_training_tpu_torch.telemetry import events as port_events
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu import telemetry as jax_tel  # noqa: E402
from distributed_training_tpu.resilience import elastic as jax_el  # noqa: E402
from distributed_training_tpu.resilience import supervisor as jax_sup  # noqa: E402
from test_torch_supervisor import (  # noqa: E402
    _read_jsonl,
    _tail,
    child_env,
    losses_by_step,
    run_events,
    runs,
    train_args,
)

SIDES = {"jax": (jax_el, jax_sup, jax_tel.Telemetry),
         "port": (port_el, port_sup, port_events.Telemetry)}


@pytest.mark.parametrize("gb,n", [(12, 4), (12, 3), (12, 1), (16, 3),
                                  (0, 4), (8, 8)])
def test_per_shard_batch_equals_jax(gb, n):
    def run(mod):
        try:
            return mod.per_shard_batch(gb, n)
        except ValueError as e:
            return type(e).__name__
    assert run(port_el) == run(jax_el)


def _reports(mod):
    return [
        mod.GroupReport(returncode=97, world_size=4, self_failed=(2,),
                        killed=(0, 1, 3)),
        mod.GroupReport(returncode=1, world_size=4,
                        self_failed=(0, 1, 2, 3)),
        mod.GroupReport(returncode=1, world_size=1, self_failed=(0,)),
        mod.GroupReport(returncode=0, world_size=4, completed=(0, 1, 2, 3)),
        mod.GroupReport(returncode=5, world_size=3, self_failed=(1,),
                        completed=(0,), killed=(2,)),
    ]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("sentinels,request_host", [
    ([], None), ([{"outcome": "host_lost", "lost_host": 1}] * 4, None),
    ([], 3), ([{"outcome": "completed"}], None)])
def test_lost_hosts_of_equals_jax(tmp_path, case, sentinels, request_host):
    out = {}
    for side, (el, _, _) in SIDES.items():
        d = str(tmp_path / side)
        if request_host is not None:
            el.write_eviction_request(d, host=request_host, step=40,
                                      reason="straggler")
        out[side] = el.lost_hosts_of(_reports(el)[case], sentinels, d)
        el.clear_eviction_request(d)
        assert el.read_eviction_request(d) is None
    assert out["port"] == out["jax"]


# (policy kwargs, starting state, exits: (outcome, lost, reason,
# new_ckpts, grow_requested))
POLICY_TABLE = {
    "evict_with_capacity": (dict(replace_lost=True), dict(world=4),
                            [("host_lost", [2], "eviction", 0, False)]),
    "lost_with_capacity": (dict(replace_lost=True), dict(world=4),
                           [("host_lost", [1], "lost", 0, False)]),
    "lost_no_capacity": ({}, dict(world=4),
                         [("host_lost", [1], "lost", 0, False)]),
    "min_world_floor": (dict(min_world=4), dict(world=4),
                        [("host_lost", [2], "eviction", 0, False),
                         ("host_lost", [2], "lost", 0, False)]),
    "whole_group": ({}, dict(world=4),
                    [("crash", [], None, 0, False),
                     ("preempted", [], None, 0, False),
                     ("watchdog_abort", [], None, 0, False)]),
    "grow_hysteresis": (dict(grow_after_ckpts=1),
                        dict(world=3, evicted=[2]),
                        [("crash", [], None, 0, False),
                         ("crash", [], None, 1, False),
                         ("host_lost", [2], "eviction", 0, False),
                         ("crash", [], None, 1, False),
                         ("crash", [], None, 1, False)]),
    "no_grow": (dict(grow=False), dict(world=3),
                [("crash", [], None, 5, False)]),
    "no_capacity": (dict(capacity=lambda: False), dict(world=3),
                    [("crash", [], None, 5, False)]),
    "watcher_requested": (dict(grow_after_ckpts=10), dict(world=3),
                          [("preempted", [], None, 1, True)]),
    "two_lost": ({}, dict(world=4),
                 [("host_lost", [0, 3], "lost", 0, False)]),
}


@pytest.mark.parametrize("name", sorted(POLICY_TABLE))
def test_policy_decisions_equal_jax(name):
    knobs, start, exits = POLICY_TABLE[name]
    out = {}
    for side, (el, _, _) in SIDES.items():
        pol = el.ElasticPolicy(base_world=4, **knobs)
        st = el.ElasticState(**{k: (list(v) if isinstance(v, list) else v)
                                for k, v in start.items()})
        trace = []
        for outcome, lost, reason, new, grow in exits:
            d = pol.decide_after_exit(st, outcome, lost, reason,
                                      new_ckpts=new, grow_requested=grow)
            trace.append((d.action, d.world, tuple(d.evicted), d.reason,
                          d.refund, st.world, list(st.evicted), st.flaps,
                          st.grows, st.ckpts_since_shrink,
                          pol.required_ckpts_before_grow(st.flaps)))
        out[side] = trace
    assert out["port"] == out["jax"]


def _completed(base, pid=1):
    os.makedirs(os.path.dirname(base), exist_ok=True)
    with open(f"{base}.pid{pid}.json", "w") as f:
        json.dump({"outcome": "completed"}, f)


def _elastic_script(el, sup, name, ckpt):
    def run(extra_env):
        i = len(run.envs)
        run.envs.append(dict(extra_env))
        base = extra_env[sup.ENV_SENTINEL]
        if name == "evicted" and i == 0:
            os.makedirs(os.path.dirname(base), exist_ok=True)
            for pid in range(4):
                with open(f"{base}.pid{pid}.json", "w") as f:
                    json.dump({"outcome": "host_lost", "lost_host": 1}, f)
            return el.GroupReport(returncode=0, world_size=4,
                                  completed=(0, 1, 2, 3))
        if i == 0:
            return el.GroupReport(returncode=el.LOST_HOST_EXIT_CODE,
                                  world_size=4, self_failed=(2,),
                                  killed=(0, 1, 3))
        if name == "grow" and i == 1:
            os.makedirs(os.path.join(ckpt, "8"))
            with open(f"{base}.pid1.json", "w") as f:
                json.dump({"outcome": "preempted"}, f)
            return el.GroupReport(returncode=0, world_size=3,
                                  completed=(0, 1, 2), grow_requested=True)
        _completed(base)
        return el.GroupReport(returncode=0, world_size=int(
            extra_env[el.ENV_WORLD]), completed=(0,))

    run.envs = []
    return run


@pytest.mark.parametrize("name", ["shrink", "grow", "evicted"])
def test_elastic_supervise_equals_jax(tmp_path, name):
    out = {}
    for side, (el, sup, Tel) in SIDES.items():
        root = tmp_path / side
        ckpt = str(root / "ckpt")
        os.makedirs(ckpt)
        events = str(root / "sup.jsonl")
        tel = Tel(events_jsonl=events)
        run = _elastic_script(el, sup, name, ckpt)
        delays = []
        res = sup.supervise(
            run, policy=sup.RestartPolicy(max_restarts=1),
            state_dir=str(root / "state"), ckpt_dir=ckpt, telemetry=tel,
            sleep=delays.append,
            elastic=el.ElasticPolicy(base_world=4, grow_after_ckpts=1))
        tel.close()
        envs = [{k: v for k, v in e.items()
                 if k not in (el.ENV_ELASTIC_DIR, sup.ENV_SENTINEL)}
                for e in run.envs]
        out[side] = {
            "rc": res.returncode, "envs": envs, "delays": delays,
            "incidents": [{k: v for k, v in vars(i).items()
                           if k != "wall_s"} for i in res.incidents],
            "events": [{k: v for k, v in e.items() if k != "t"}
                       for e in _read_jsonl(events)
                       if e["kind"] != "run_start"]}
    assert out["port"] == out["jax"]
    worlds = [e[port_el.ENV_WORLD] for e in out["port"]["envs"]]
    assert worlds == {"shrink": ["4", "3"], "grow": ["4", "3", "4"],
                      "evicted": ["4", "3"]}[name]


# -- resharded restore -------------------------------------------------------


def _same(a: dict, b: dict, what: str) -> None:
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys(), what
    for k in fb:
        if isinstance(fb[k], torch.Tensor):
            assert torch.equal(fa[k].cpu(), fb[k].cpu()), (what, k)
        else:
            assert fa[k] == fb[k], (what, k)


def test_fsdp_world2_restores_at_world1_as_consolidated(tmp_path):
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    with child_env():
        report = port_launch.run_group(
            train_args(str(out), str(ckpt),
                       "train.parallel_strategy=fsdp", "mesh.dp=1",
                       "mesh.fsdp=2", "train.min_shard_elems=16",
                       "train.gather_on_save=true", "train.total_epochs=1",
                       "train.max_steps_per_epoch=2"),
            2, log_dir=str(tmp_path / "logs"), timeout=300)
    assert report.returncode == 0, _tail(tmp_path / "logs")
    step_dir = ckpt / "2"
    with open(step_dir / "layout.json") as f:
        layout = json.load(f)
    assert layout["world"] == 2 and any(layout["params"].values())
    with open(step_dir / integrity.MANIFEST_NAME) as f:
        files = set(json.load(f)["files"])
    assert files == {"state.rank0.pt", "state.rank1.pt", "meta.json",
                     "layout.json"}
    assert integrity.verify_manifest(str(step_dir)) == (True, [])
    ck = Checkpointer(str(ckpt))
    state, meta = ck.restore_latest("cpu", None)
    assert ck.last_restore["resharded"] and ck.last_restore["step"] == 2
    assert meta["data"]["samples_consumed"] == 24
    want, _ = consolidate.load_consolidated(
        str(ckpt / "consolidated_step2.pt"))
    _same(state["params"], want["params"], "params")
    _same(state["opt_state"], want["opt_state"], "opt_state")
    assert state["step"] == want["step"] == 2


@pytest.fixture(scope="module")
def elastic_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    with child_env():
        rc = port_launch.main([
            "--nproc", "4", "--log-dir", str(root / "logs"), "--supervise",
            "--elastic", "--elastic-no-grow", "--max-restarts", "2",
            "--backoff-base-s", "0.05", "--ckpt-dir", str(root / "ckpt"),
            "--", *train_args(str(root / "out"), str(root / "ckpt"),
                              "train.gather_on_save=true",
                              "train.fault_plan=lose_host@6:host=2")])
    assert rc == 0, _tail(root / "logs" / "attempt_1")
    return root


def test_elastic_shrink_resumes_at_world_3(elastic_run):
    sup_events = _read_jsonl(str(elastic_run / "logs" / "supervisor" /
                                 "events.jsonl"))
    el = [e for e in sup_events if e["kind"] == "elastic"]
    assert len(el) == 1 and el[0]["action"] == "shrink"
    assert (el[0]["old_world"], el[0]["new_world"]) == (4, 3)
    assert el[0]["lost_hosts"] == [2] and el[0]["lost_reason"] == "lost"
    events = run_events(elastic_run)
    resumes = [e for e in events if e["kind"] == "resume"]
    assert len(resumes) == 1
    r = resumes[0]
    assert (r["step"], r["world_size"], r["evicted_hosts"]) == (4, 3, [2])
    assert r["samples_consumed"] == 48 and r["global_batch"] == 12
    assert r["restore"]["resharded"] and r["restore"]["step"] == 4
    ledger = elastic_run / "out" / "default" / "host_2" / \
        "faults_fired.json"
    with open(ledger) as f:
        assert json.load(f)["fired"] == ["lose_host@6:host=2"]


def test_elastic_stream_is_exactly_once(elastic_run, tmp_path_factory):
    clean = runs(tmp_path_factory)["clean"]
    want = {e["step"]: (e["samples"], e["sha256"])
            for e in run_events(clean) if e["kind"] == "data_batch"}
    events = run_events(elastic_run)
    at = next(i for i, e in enumerate(events) if e["kind"] == "resume")
    before = [e["step"] for e in events[:at] if e["kind"] == "data_batch"]
    after = [e["step"] for e in events[at:] if e["kind"] == "data_batch"]
    # World 4 took steps 1.. until host 2 died after step 6; world 3
    # took 5..12 once each, from the step-4 checkpoint.
    assert before[:6] == [1, 2, 3, 4, 5, 6] and after == list(range(5, 13))
    got = {e["step"]: (e["samples"], e["sha256"]) for e in events
           if e["kind"] == "data_batch"}
    assert sorted(got) == sorted(want) == list(range(1, 13))
    assert got == want
    a, b = losses_by_step(elastic_run), losses_by_step(clean)
    assert sorted(a) == sorted(b)
    np.testing.assert_allclose([a[s] for s in sorted(a)],
                               [b[s] for s in sorted(b)], rtol=1e-4)


def test_ddp_world4_step_restores_at_world3_as_consolidated(elastic_run):
    ckpt = elastic_run / "ckpt"
    with open(ckpt / "4" / "layout.json") as f:
        assert json.load(f)["world"] == 4
    with open(ckpt / "8" / "layout.json") as f:
        assert json.load(f)["world"] == 3
    state = consolidate.place_state(
        consolidate.whole_state_of(str(ckpt / "4")), None, None, "cpu")
    want, meta = consolidate.load_consolidated(
        str(ckpt / "consolidated_step4.pt"))
    _same(state["params"], want["params"], "params")
    _same(state["opt_state"], want["opt_state"], "opt_state")
    assert meta["step"] == 4

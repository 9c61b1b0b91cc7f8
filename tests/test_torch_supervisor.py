"""The port's training supervisor against the JAX package's.

- ``classify_exit`` gives JAX's outcome for every (return code,
  sentinels) case, and the exit sentinels round-trip.
- ``supervise`` driven by scripted in-process incarnations (each writes
  the sentinel and the checkpoint step its scenario says) gives JAX's
  outcomes, return codes, budgets, backoffs and event kinds: a first-try
  completion, refunds on checkpoint progress, a crash loop that gives up
  (with its incident bundle), a preemption refund, a preemption storm
  that backs off, a stop request that stands down, a quarantine-lowered
  step still counted as progress, stale sentinels of an earlier run
  ignored, and a watchdog abort.
- End to end, in subprocesses: ``launch --supervise`` with
  ``train.fault_plan=crash@6`` on the streaming loader (byte_lm, d 32, one
  layer) restarts once, resumes from step 4, and ends with params and
  moments equal bit for bit to an uninterrupted run of the port; its
  losses stay within 1e-5 of the JAX trainer run in-process on the same
  stream from the same init.

``runs`` spawns the e2e's runs once per test process;
``tests/test_torch_elastic.py`` reads the uninterrupted run from it.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.checkpoint.export import (
    restore_step_local,
)
from distributed_training_tpu_torch.launch import local as port_launch
from distributed_training_tpu_torch.resilience import supervisor as port_sup
from distributed_training_tpu_torch.telemetry import events as port_events
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")

from distributed_training_tpu import telemetry as jax_tel  # noqa: E402
from distributed_training_tpu.resilience import supervisor as jax_sup  # noqa: E402

SIDES = {"jax": (jax_sup, jax_tel.Telemetry),
         "port": (port_sup, port_events.Telemetry)}


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("rc,outcomes", [
    (0, []), (0, ["completed"]), (0, ["preempted"]),
    (0, ["completed", "preempted"]), (1, ["preempted"]), (143, []),
    (130, ["completed"]), (42, []), (1, ["watchdog_abort"]),
    (0, ["host_lost"]), (97, []), (-9, []), (2, ["completed"]),
])
def test_classify_exit_equals_jax(rc, outcomes):
    st = [{"outcome": o} for o in outcomes]
    assert port_sup.classify_exit(rc, st) == jax_sup.classify_exit(rc, st)


def test_exit_sentinel_roundtrip(tmp_path, monkeypatch):
    base = str(tmp_path / "exit_0")
    monkeypatch.setenv(port_sup.ENV_SENTINEL, base)
    path = port_sup.write_exit_status(port_sup.PREEMPTED, step=40)
    assert path == port_sup.sentinel_path() and os.path.exists(path)
    assert jax_sup.read_exit_statuses(base) == \
        port_sup.read_exit_statuses(base)
    rec = port_sup.read_exit_statuses(base)[0]
    assert (rec["outcome"], rec["step"]) == ("preempted", 40)
    monkeypatch.delenv(port_sup.ENV_SENTINEL)
    assert port_sup.write_exit_status(port_sup.COMPLETED) is None
    for name in ("COMPLETED", "PREEMPTED", "HOST_LOST", "WATCHDOG_ABORT",
                 "CRASH", "WATCHDOG_EXIT_CODE", "ENV_SENTINEL",
                 "ENV_RESTART_COUNT"):
        assert getattr(port_sup, name) == getattr(jax_sup, name), name


def _scripted(sup, script, ckpt_dir, pid="1"):
    """A fake ``run_incarnation``: call ``i`` plays ``script[i]`` =
    (rc, sentinel outcome or None, new checkpoint step or None)."""
    calls = []

    def run(extra_env):
        i = min(len(calls), len(script) - 1)
        calls.append(dict(extra_env))
        rc, outcome, step = script[i]
        base = extra_env[sup.ENV_SENTINEL]
        if outcome is not None:
            os.makedirs(os.path.dirname(base), exist_ok=True)
            with open(f"{base}.pid{pid}.json", "w") as f:
                json.dump({"outcome": outcome}, f)
        if step is not None:
            os.makedirs(os.path.join(ckpt_dir, str(step)), exist_ok=True)
        return rc

    run.calls = calls
    return run


def _quarantine_then_complete(sup, ckpt):
    for s in ("100", "110"):
        os.makedirs(os.path.join(ckpt, s))
    calls = []

    def run(extra_env):
        calls.append(dict(extra_env))
        if len(calls) == 1:
            os.rename(os.path.join(ckpt, "110"),
                      os.path.join(ckpt, "step_110.corrupt"))
            os.makedirs(os.path.join(ckpt, "105"))
            return 1
        with open(f"{extra_env[sup.ENV_SENTINEL]}.pid1.json", "w") as f:
            json.dump({"outcome": sup.COMPLETED}, f)
        return 0

    run.calls = calls
    return run


C, P, W = "completed", "preempted", "watchdog_abort"
SCENARIOS = {
    "completes": ([(0, C, None)], {}),
    "progress_refunds": ([(1, None, 8), (1, None, 16), (0, C, None)],
                         dict(max_restarts=1)),
    "crash_loop": ([(1, None, None)],
                   dict(max_restarts=2, backoff_base_s=0.5, jitter=0.0)),
    "preempt_refunds": ([(0, P, None), (0, C, None)], dict(max_restarts=0)),
    "preempt_storm": ([(0, P, None)] * 3 + [(0, C, None)],
                      dict(max_restarts=1, backoff_base_s=0.5, jitter=0.0)),
    "stop_requested": ([(0, P, None)], {}),
    "quarantine_lowered": (None, dict(max_restarts=0)),
    "watchdog": ([(42, None, None), (0, C, None)], dict(max_restarts=1)),
    "jittered_backoff": ([(1, None, None)] * 2 + [(0, C, None)],
                         dict(max_restarts=3, backoff_base_s=0.25,
                              seed=5)),
}


def _play(side, name, root):
    sup, Tel = SIDES[side]
    script, knobs = SCENARIOS[name]
    ckpt = str(root / "ckpt")
    events = str(root / "sup" / "events.jsonl")
    tel = Tel(events_jsonl=events)
    run = (_quarantine_then_complete(sup, ckpt) if script is None
           else _scripted(sup, script, ckpt))
    delays = []
    res = sup.supervise(
        run, policy=sup.RestartPolicy(**knobs),
        state_dir=str(root / "state"), ckpt_dir=ckpt, telemetry=tel,
        sleep=delays.append,
        should_stop=(lambda: True) if name == "stop_requested" else None)
    tel.close()
    recs = _read_jsonl(events)
    drop = {"t", "wall_s"}
    return {
        "rc": res.returncode, "restarts": res.restarts,
        "calls": [sorted(c) for c in run.calls],
        "incidents": [{k: v for k, v in vars(i).items() if k not in drop}
                      for i in res.incidents],
        "delays": delays,
        "events": [{k: v for k, v in e.items() if k not in drop}
                   for e in recs if e["kind"] != "run_start"],
        "incident_bundles": sorted(
            os.listdir(root / "sup" / "incidents"))
        if os.path.isdir(root / "sup" / "incidents") else [],
        "summary": len(res.summary_lines()),
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervise_equals_jax(tmp_path, name):
    want = _play("jax", name, tmp_path / "jax")
    got = _play("port", name, tmp_path / "port")
    bundles = (len(got.pop("incident_bundles")),
               len(want.pop("incident_bundles")))
    assert bundles == ((1, 1) if name == "crash_loop" else (0, 0))
    assert got == want
    if name == "crash_loop":
        assert got["rc"] == 1 and len(got["incidents"]) == 3
        assert got["delays"] == [0.5, 1.0]
    if name == "quarantine_lowered":
        assert got["incidents"][0]["advanced"]


def test_supervise_ignores_stale_sentinels(tmp_path):
    state = str(tmp_path / "state")
    for sup in (jax_sup, port_sup):
        first = _scripted(sup, [(42, W, None)], str(tmp_path / "c"),
                          pid="111")
        assert sup.supervise(first, policy=sup.RestartPolicy(
            max_restarts=0), state_dir=state,
            sleep=lambda s: None).returncode != 0
        second = _scripted(sup, [(0, C, None)], str(tmp_path / "c"),
                           pid="222")
        res = sup.supervise(second, policy=sup.RestartPolicy(
            max_restarts=0), state_dir=state, sleep=lambda s: None)
        assert res.returncode == 0
        assert res.incidents[0].outcome == C


# -- end to end, in subprocesses ---------------------------------------------


STREAM = ("train.data_sources={text: {dataset: synthetic_doc, weight: 3, "
          "vocab_size: 256, min_len: 5, max_len: 40}, docs: {dataset: "
          "synthetic_lm, seq_len: 16, vocab_size: 256}}")
STEPS_PER_EPOCH = 4
EPOCHS = 3


def train_args(out, snap, *extra):
    """The e2e's training run: byte_lm at d 32, one layer, f32, on two
    packed sources at a global batch of 12 (divisible by 4 and 3)."""
    return ["-m", "distributed_training_tpu_torch.train", "train.device=cpu",
            "model=byte_lm", "train=gpt2", "+model.n_layers=1",
            "+model.d_model=32", "+model.n_heads=2", "+model.max_seq_len=16",
            "train.dtype=float32", STREAM, "train.pack_seq_len=16",
            "train.global_batch_size=12",
            f"train.max_steps_per_epoch={STEPS_PER_EPOCH}",
            f"train.total_epochs={EPOCHS}", "train.dataset_size=48",
            "train.warmup_steps=2", "train.save_every=1",
            "train.log_every=1", "run.log_level=WARNING",
            f"run.output_dir={out}", f"train.snapshot_path={snap}", *extra]


_RUNS: dict = {}
# One intra-op thread in the children: a BLAS that picks its thread count
# by the machine's load sums in another order from run to run, which
# would hide (or fake) a resume that is not bit for bit.
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def child_env():
    saved = {k: os.environ.get(k) for k in CHILD_ENV}
    os.environ.update(CHILD_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def runs(tmp_path_factory) -> dict:
    """The uninterrupted run and the supervised crash run, once per test
    process."""
    if not _RUNS:
        root = tmp_path_factory.mktemp("supervised")
        clean = root / "clean"
        faulty = root / "faulty"
        with child_env():
            report = port_launch.run_group(
                train_args(str(clean / "out"), str(clean / "ckpt")), 1,
                log_dir=str(clean / "logs"), timeout=300)
            assert report.returncode == 0, _tail(clean / "logs")
            rc = port_launch.main([
                "--nproc", "1", "--log-dir", str(faulty / "logs"),
                "--supervise", "--max-restarts", "2", "--backoff-base-s",
                "0.05", "--ckpt-dir", str(faulty / "ckpt"), "--",
                *train_args(str(faulty / "out"), str(faulty / "ckpt"),
                            "train.fault_plan=crash@6")])
        assert rc == 0, "".join(
            _tail(faulty / "logs" / d)
            for d in sorted(os.listdir(faulty / "logs")))
        _RUNS.update(clean=clean, faulty=faulty)
    return _RUNS


def _tail(log_dir) -> str:
    text = f"== {log_dir}\n"
    for p in sorted(os.listdir(log_dir)):
        if p.endswith((".log", ".jsonl", ".json")):
            with open(os.path.join(log_dir, p)) as f:
                text += f.read()[-3000:]
    return text


def run_events(root) -> list:
    """Process 0's event stream (``host_0/`` in a world of several
    processes or under an elastic supervisor)."""
    run = os.path.join(root, "out", "default")
    flat = os.path.join(run, "events.jsonl")
    return _read_jsonl(flat if os.path.exists(flat)
                       else os.path.join(run, "host_0", "events.jsonl"))


def losses_by_step(root) -> dict:
    """step → loss, the last record of each step (a restarted run
    records the steps it replays again)."""
    rows = _read_jsonl(os.path.join(root, "out", "default",
                                    "metrics.jsonl"))
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    return runs(tmp_path_factory)


def test_supervised_crash_restarts_once_and_resumes(e2e):
    faulty = e2e["faulty"]
    sup_events = _read_jsonl(str(faulty / "logs" / "supervisor" /
                                 "events.jsonl"))
    restarts = [e for e in sup_events if e["kind"] == "restart"]
    assert len(restarts) == 1
    assert restarts[0]["outcome"] == "crash"
    assert restarts[0]["ckpt_step"] == 4 and restarts[0]["advanced"]
    events = run_events(faulty)
    assert [e["fault"] for e in events
            if e["kind"] == "fault_injected"] == ["crash@6"]
    resumes = [e for e in events if e["kind"] == "resume"]
    assert len(resumes) == 1
    r = resumes[0]
    assert (r["step"], r["restarts"], r["world_size"]) == (4, 1, 1)
    assert r["samples_consumed"] == 4 * 12 and r["global_batch"] == 12
    assert set(r["realized_mixture"]) == {"text", "docs"}
    assert sum(1 for e in events if e["kind"] == "run_start") == 2
    with open(faulty / "logs" / "attempt_0" / "summary.json") as f:
        assert json.load(f)["outcome"] == "crash"


def test_supervised_crash_resume_is_bit_identical(e2e):
    got, got_step = restore_step_local(str(e2e["faulty"] / "ckpt"))
    want, want_step = restore_step_local(str(e2e["clean"] / "ckpt"))
    assert got_step == want_step == STEPS_PER_EPOCH * EPOCHS
    for part in ("params", "opt_state"):
        g, w = flatten(got[part]), flatten(want[part])
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], torch.Tensor):
                assert torch.equal(g[k], w[k]), (part, k)
            else:
                assert g[k] == w[k], (part, k)
    assert losses_by_step(e2e["faulty"]) == losses_by_step(e2e["clean"])


def test_supervised_losses_match_jax_trainer_on_the_same_stream(e2e):
    import jax.numpy as jnp

    from distributed_training_tpu import config as jax_config
    from distributed_training_tpu.data import stream as jax_stream
    from distributed_training_tpu.models import transformer as jax_tf
    from distributed_training_tpu.runtime import fake_cpu_runtime
    from distributed_training_tpu.train.trainer import Trainer as JaxTrainer

    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.models.registry import build_model

    args = train_args("unused", "unused")[2:]
    pcfg = load_config(None, "config", args)
    kw = dict(pcfg.model.kwargs)
    kw.pop("name", None)
    port_model = build_model(pcfg.model.name, loss=pcfg.train.loss,
                             dtype="float32", device="cpu", **kw)
    init = {k: np.asarray(v.detach())
            for k, v in flatten(port_model.init(pcfg.train.seed)).items()}

    jcfg = jax_config.load_config(None, "config", args)
    jcfg.train.batch_size = 12
    jcfg.train.snapshot_path = ""
    rt = fake_cpu_runtime(1)
    sources = jax_stream.build_stream_sources(
        jcfg.train.data_sources,
        defaults={"size": jcfg.train.dataset_size, "seed": jcfg.train.seed})
    loader = jax_stream.StreamingDataLoader(
        sources, rt, batch_size=12, pack_len=16, seed=jcfg.train.seed,
        steps_per_epoch=STEPS_PER_EPOCH)
    jkw = dict(jcfg.model.kwargs)
    jkw.pop("dtype", None)
    model = jax_tf.Transformer(jax_tf.TransformerConfig(
        **{k: v for k, v in jkw.items() if k != "name"}, dtype="float32"))
    jt = JaxTrainer(jcfg, rt, model, loader)

    def nest(flat):
        out: dict = {}
        for k, v in flat.items():
            *head, leaf = k.split("/")
            d = out
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = jnp.asarray(v)
        return out

    params = jax.device_put(nest(init), jt.state_shardings["params"])
    jt.state = {"params": params, "opt_state": jt.optimizer.init(params),
                "step": jt.state["step"]}
    jt.train()
    want = {row["step"]: row["loss"] for row in jt.metrics.history}
    got = losses_by_step(e2e["faulty"])
    assert sorted(got) == sorted(want) == list(
        range(1, STEPS_PER_EPOCH * EPOCHS + 1))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(got)], rtol=1e-5)


"""The port's training observability against the JAX package's.

Host-only modules (the port keeps its own copies): identical synthetic
inputs go to both packages' ``GoodputLedger`` (on a scripted clock),
``goodput_of_stream``, ``AnomalyDetector`` (the same ``anomaly`` events,
verdicts and rebuilt state), ``flag_stragglers`` and the detector's
exchange (a scripted gather), ``summarize_run``/``render``,
``aggregate_run``/``skew_report``/``render_multihost`` and the doctor on
the same run dirs and incident bundle; every result equal. ``memory.py``'s
byte counts for gpt2_125m and transformer_1b equal JAX's exactly.

In processes of their own: the watchdog fires in process, and its abort
path exits 42 in a subprocess, which the supervisor classifies as
``watchdog_abort``; a gloo world of 2 through the launcher with a
``slow_host`` fault writes the straggler eviction request that
``resilience/elastic.py`` reads, and ``--summarize`` prints the merged
report; a 2-layer CPU CLI run with every option on emits each event
kind with the JAX schema's keys.
"""

import json
import math
import os
import subprocess
import sys
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from distributed_training_tpu_torch.launch import local as launch
from distributed_training_tpu_torch.resilience import elastic as port_elastic
from distributed_training_tpu_torch.resilience import supervisor as port_sup
from distributed_training_tpu_torch.telemetry import aggregate as p_agg
from distributed_training_tpu_torch.telemetry import anomaly as p_anom
from distributed_training_tpu_torch.telemetry import doctor as p_doc
from distributed_training_tpu_torch.telemetry import goodput as p_good
from distributed_training_tpu_torch.telemetry import hbm as p_hbm
from distributed_training_tpu_torch.telemetry import incident as p_inc
from distributed_training_tpu_torch.telemetry import straggler as p_strag
from distributed_training_tpu_torch.telemetry import summarize as p_sum
from distributed_training_tpu_torch.telemetry import watchdog as p_wd
from distributed_training_tpu_torch.train import cli as port_cli
from distributed_training_tpu_torch.utils import memory as p_mem

jax = pytest.importorskip("jax")

from distributed_training_tpu import runtime as j_runtime  # noqa: E402
from distributed_training_tpu.models import transformer as j_tf  # noqa: E402
from distributed_training_tpu.telemetry import aggregate as j_agg  # noqa: E402
from distributed_training_tpu.telemetry import anomaly as j_anom  # noqa: E402
from distributed_training_tpu.telemetry import attribution as j_att  # noqa: E402
from distributed_training_tpu.telemetry import doctor as j_doc  # noqa: E402
from distributed_training_tpu.telemetry import events as j_events  # noqa: E402
from distributed_training_tpu.telemetry import goodput as j_good  # noqa: E402
from distributed_training_tpu.telemetry import hbm as j_hbm  # noqa: E402
from distributed_training_tpu.telemetry import straggler as j_strag  # noqa: E402
from distributed_training_tpu.telemetry import summarize as j_sum  # noqa: E402
from distributed_training_tpu.telemetry import xplane as j_xplane  # noqa: E402
from distributed_training_tpu.utils import memory as j_mem  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Sink:
    """A telemetry stand-in that keeps what is emitted through it."""

    def __init__(self):
        self.records = []

    def event(self, name, **fields):
        self.records.append({"kind": name, **fields})


# -- goodput ------------------------------------------------------------------


def test_goodput_ledger_matches_jax(monkeypatch):
    """Both ledgers on one scripted clock (4-decimal instants) and the
    same spans: window and run reports equal."""
    import time as time_mod

    reports = []
    for mod in (j_good, p_good):
        clock = iter([100.0, 100.0, 103.125, 103.125, 107.5])
        monkeypatch.setattr(time_mod, "perf_counter", lambda: next(clock))
        led = mod.GoodputLedger(flops_per_step=2e12, num_devices=2,
                                peak_flops=1e14)
        led.reset()
        for name, dur, steps in (("compile", 1.5, 1), ("data_wait", 0.25, 0),
                                 ("step", 0.5, 1), ("data_assemble", 9, 0),
                                 ("step", 0.5, 1)):
            led.add(name, dur, steps=steps)
        window = led.window_report()
        for name, dur, steps in (("ckpt_save", 0.75, 0), ("eval", 0.125, 0),
                                 ("step", 0.625, 1)):
            led.add(name, dur, steps=steps)
        reports.append((window, led.report()))
    assert reports[0] == reports[1]
    run = reports[1][1]
    assert math.isclose(sum(run["buckets"].values()), run["wall_s"])


def _stream(host=None, t0=1000.0, steps=24, crash_at=None, slow=1.0,
            data_wait=0.001):
    """A synthetic training event stream: run_start, clock_sync, spans,
    train metrics, goodput windows and run, hbm samples, an attribution
    and, with ``crash_at``, a crashed segment and a resumed one."""
    rng = np.random.default_rng(7 if host is None else 7 + host)
    ev, t = [], t0

    def add(kind, **f):
        rec = {"kind": kind, "t": round(t, 6), **f}
        if host is not None:
            rec["host"] = host
        ev.append(rec)

    add("run_start", step=0)
    add("clock_sync", t_sync=t0 + 0.5 + (host or 0) * 0.25,
        process_index=host or 0, process_count=2 if host is not None else 1)
    step, resumed = 0, False
    while step < steps:
        step += 1
        dw = data_wait * (1 + rng.random())
        t += dw
        add("span", name="data_wait", dur_s=round(dw, 6), depth=0,
            parent=None, step=step)
        dur = (2.0 if step == 1 else 0.1 * slow * (1 + 0.02 * rng.random()))
        if 14 <= step <= 19:
            dur *= 3  # a sustained regression
        t += dur
        add("span", name="compile" if step == 1 else "step",
            dur_s=round(dur, 6), depth=0, parent=None, step=step)
        loss = float("nan") if step == 9 else 5.0 - 0.1 * step
        add("train_metrics", step=step, loss=None if step == 9 else loss,
            samples_per_sec_per_chip=80.0 / dur, warmup=step < 3)
        if step % 4 == 0:
            add("goodput", scope="window", step=step, wall_s=0.4,
                buckets={"step": 0.3, "idle": 0.1}, steps=4, goodput=0.75)
            add("hbm", step=step, devices=[{"id": 0, "stats": {
                "bytes_in_use": 1000 * step, "peak_bytes_in_use": 2000 * step,
                "bytes_limit": 10 ** 6}}], estimate_bytes=500)
        if step == 12:
            add("attribution", schema=1, step=12, steps_captured=2,
                trace_dir="profiles/step_000011", source="device",
                window_s=0.25, compute_frac=0.5, collective_frac=0.125,
                host_frac=0.375, overlap_frac=0.25, compute_s=0.125,
                collective_s=0.0625, overlap_s=0.015625, top_ops=[])
        if crash_at is not None and step == crash_at and not resumed:
            resumed = True
            t += 7.5
            add("run_start", step=8)
            add("clock_sync", t_sync=t, process_index=host or 0,
                process_count=2 if host is not None else 1)
            add("resume", step=8, epoch=0, restarts=1, world_size=1,
                evicted_hosts=[], samples_consumed=64, global_batch=8,
                data_skips=0)
            step = 8
    add("goodput", scope="run", step=step, wall_s=round(t - t0, 4),
        buckets={"compile": 2.0, "data_wait": 0.05, "step": 3.0,
                 "checkpoint": 0.0, "eval": 0.0, "idle": 1.0},
        steps=step - 1, goodput=0.5)
    return ev


def test_goodput_of_stream_matches_jax():
    ev = _stream(crash_at=11)
    assert p_good.goodput_of_stream(ev) == j_good.goodput_of_stream(ev)
    no_run = [e for e in ev if not (e["kind"] == "goodput"
                                    and e.get("scope") == "run")]
    rec = p_good.goodput_of_stream(no_run)
    assert rec == j_good.goodput_of_stream(no_run) and rec["reconstructed"]


# -- anomaly ------------------------------------------------------------------


def test_anomaly_detector_matches_jax(tmp_path):
    """The same stream, observed live then replayed: the same anomaly
    events (the sustained regression arms one profile capture through
    the same drop file and ledger), verdicts and rebuilt state."""
    ev = _stream(steps=30) + [
        {"kind": "serving", "queue_depth": q, "t": 1.0}
        for q in [1] * 20 + [40]]
    out = []
    for mod, name in ((j_anom, "jax"), (p_anom, "port")):
        sink, run_dir = _Sink(), tmp_path / name
        det = mod.AnomalyDetector(telemetry=sink, run_dir=str(run_dir),
                                  window=16, min_samples=6, sustain=3,
                                  baseline_every=5, host=0)
        for rec in ev:
            det.observe(rec)
        again = mod.AnomalyDetector(run_dir=str(run_dir), window=16,
                                    min_samples=6, sustain=3, host=0)
        again.replay(ev)
        with open(run_dir / "incidents" / "autoprofile_fired.json") as f:
            ledger = {k: v["evidence"] for k, v in json.load(f).items()}
        out.append((sink.records, det.verdict(), det.state_fingerprint(),
                    again.state_fingerprint(), ledger,
                    (run_dir / "profile_now").read_text()))
    assert out[0] == out[1]
    signals = {r["signal"] for r in out[1][0] if r["kind"] == "anomaly"}
    assert {"step_time", "loss_nan", "serving_queue_depth"} <= signals
    assert p_anom.ANOMALY_KEYS == j_anom.ANOMALY_KEYS


# -- straggler ----------------------------------------------------------------


def test_flag_stragglers_matches_jax():
    per_host = {0: {"step": 0.1, "data_wait": 0.001},
                1: {"step": 0.32, "data_wait": 0.002},
                2: {"step": 0.11, "data_wait": 0.2},
                3: {"step": 0.1, "data_wait": None}}
    for th in (1.5, 3.0):
        assert (p_strag.flag_stragglers(per_host, th)
                == j_strag.flag_stragglers(per_host, th))


def test_straggler_exchange_matches_jax(tmp_path):
    """Both detectors on one scripted gather (host 1 three times slower):
    the same straggler events, eviction request and request file."""
    rt = SimpleNamespace(process_index=0, process_count=2)

    def gather(payload):
        slow = payload.copy()
        slow[0] *= 3
        return np.stack([payload, slow])

    out = []
    for mod, name in ((j_strag, "jax"), (p_strag, "port")):
        sink = _Sink()
        det = mod.StragglerDetector(rt, telemetry=sink, every=2, persist=1,
                                    evict_after=2, gather=gather,
                                    elastic_dir=str(tmp_path / name))
        for step in range(1, 7):
            det.record_step(0.1, 0.001)
            det.maybe_exchange(step)
        with open(tmp_path / name / "eviction_request.json") as f:
            req = {k: v for k, v in json.load(f).items() if k != "t"}
        out.append((sink.records, det.evict_request, req,
                    det.watchdog_info()))
    assert out[0] == out[1]
    assert out[1][1]["host"] == 1


# -- reports ------------------------------------------------------------------


def _write_jsonl(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _metrics(steps=24):
    return [{"step": s, "epoch": 0, "loss": 5.0 - 0.1 * s,
             "samples_per_sec_per_chip": 80.0 + s, "mfu": 0.2 + 0.001 * s}
            for s in range(2, steps + 1, 2)]


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """One single-host run dir (a crash and a resume, a postmortem
    bundle, an incident bundle), one two-host run dir (host 1 slow)."""
    root = tmp_path_factory.mktemp("reports")
    single = root / "single"
    ev = _stream(crash_at=11)
    ev.insert(30, {"kind": "watchdog_fired", "t": 1001.0, "step": 5,
                   "postmortem": "postmortem/x", "timeout_s": 1.0})
    _write_jsonl(str(single / "events.jsonl"), ev)
    _write_jsonl(str(single / "metrics.jsonl"), _metrics())
    os.makedirs(single / "postmortem" / "20260101T000000Z_pid1_0")
    bundle = p_inc.write_incident_bundle(
        str(single / "incidents"), reason="anomaly event: step_time",
        kind="anomaly", events_tail=ev[-40:],
        extra={"trigger": {"kind": "anomaly", "signal": "step_time"}},
        anomaly={"anomalies_total": {"step_time": 2}},
        attribution=next(e for e in ev if e["kind"] == "attribution"))
    multi = root / "multi"
    for h in (0, 1):
        _write_jsonl(str(multi / f"host_{h}" / "events.jsonl"),
                     _stream(host=h, slow=1.0 if h == 0 else 2.5,
                             data_wait=0.001 if h == 0 else 0.05))
    _write_jsonl(str(multi / "metrics.jsonl"), _metrics())
    return {"single": str(single), "multi": str(multi), "bundle": bundle}


def test_summarize_matches_jax(run_dirs):
    d = run_dirs["single"]
    want, got = j_sum.summarize_run(d), p_sum.summarize_run(d)
    assert got == want
    assert got["recovery"] and got["attribution"] and got["postmortems"]
    assert p_sum.render(got) == j_sum.render(want)
    assert (p_sum.render_recovery_lines(got["recovery"])
            == j_sum.render_recovery_lines(want["recovery"]))


def test_aggregate_matches_jax(run_dirs):
    d = run_dirs["multi"]
    assert p_agg.is_multihost_run_dir(d) and j_agg.is_multihost_run_dir(d)
    want, got = j_agg.aggregate_run(d), p_agg.aggregate_run(d)
    assert got == want
    streams = p_agg.load_host_streams(d)
    assert p_agg.skew_report(streams) == j_agg.skew_report(
        j_agg.load_host_streams(d))
    assert p_agg.clock_offsets(streams) == j_agg.clock_offsets(streams)
    assert p_agg.render_multihost(got) == j_agg.render_multihost(want)
    assert any(v["host"] == 1 for v in got["stragglers"]["offline"])


@pytest.mark.parametrize("target", ["single", "multi", "bundle"])
def test_doctor_matches_jax(run_dirs, target):
    path = run_dirs[target]
    want, got = j_doc.diagnose_path(path), p_doc.diagnose_path(path)
    assert got == want and got["verdict"] in p_doc.RULES
    assert p_doc.render_doctor(got) == j_doc.render_doctor(want)


def test_port_cli_reads_the_run_dirs(run_dirs, capsys):
    assert p_sum.main([run_dirs["single"], "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(
        p_sum.summarize_run(run_dirs["single"])))
    assert p_sum.main([run_dirs["bundle"], "--doctor"]) == 0
    assert "VERDICT:" in capsys.readouterr().out


# -- memory -------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["gpt2_125m", "transformer_1b"])
def test_memory_estimates_match_jax(preset):
    import dataclasses

    from distributed_training_tpu_torch.models import transformer as p_tf

    for over in ({}, dict(remat=True, remat_policy="mlp"),
                 dict(remat=True, remat_policy="mlp_pre"),
                 dict(remat=True, remat_policy="selective"),
                 dict(loss_impl="dense")):
        kw = {**j_tf.PRESETS[preset], **over}
        for opt, fsdp, tp in (("adamw", 1, 1), ("adafactor", 4, 2),
                              ("sgd", 8, 1)):
            want = j_mem.estimate_transformer_memory(
                j_tf.TransformerConfig(**kw), 4, 1024, opt, fsdp, tp)
            got = p_mem.estimate_transformer_memory(
                p_tf.TransformerConfig(**kw), 4, 1024, opt, fsdp, tp)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    shapes = jax.eval_shape(j_tf.Transformer(j_tf.TransformerConfig(
        **j_tf.PRESETS[preset])).init, jax.random.PRNGKey(0))
    assert p_mem.param_count(p_tf.param_shapes(p_tf.TransformerConfig(
        **j_tf.PRESETS[preset]))) == j_mem.param_count(shapes)
    assert {k: v for k, v in p_mem.HBM_GIB.items()
            if k in j_mem.HBM_GIB} == j_mem.HBM_GIB
    assert p_mem.HBM_GIB["nvidia h100 80gb hbm3"] == 80.0


def test_state_bytes_per_device():
    import torch

    from distributed_training_tpu_torch.parallel.strategy import Placement

    tree = {"a": torch.zeros(8, 4), "b": {"c": torch.zeros(3, dtype=torch.bfloat16)}}
    # Replicated: JAX's count with no PartitionSpec.
    want = j_mem.state_bytes_per_device(
        {"a": np.zeros((8, 4), np.float32),
         "b": {"c": np.zeros(3, jax.numpy.bfloat16)}},
        {"a": None, "b": {"c": None}})
    assert p_mem.state_bytes_per_device(tree) == want == 8 * 4 * 4 + 3 * 2
    split = {"a": Placement(splits=((0, ("fsdp",)), (1, ("tp",))))}
    assert p_mem.state_bytes_per_device(
        tree, split, {"fsdp": 4, "tp": 2}) == 8 * 4 * 4 // 8 + 6
    assert p_mem.state_bytes_per_device(tree, device="cuda") == 0


# -- hbm ----------------------------------------------------------------------


def test_hbm_samples_have_the_jax_schema():
    """On the CPU both packages sample ``"stats": null``."""
    jsink, psink = _Sink(), _Sink()
    cpu = SimpleNamespace(memory_stats=lambda: None)
    j_hbm.HBMSampler(jsink, every=2, estimate_bytes=64,
                     devices=[cpu]).maybe_sample(4)
    p_hbm.HBMSampler(psink, every=2, estimate_bytes=64,
                     device="cpu").maybe_sample(4)
    assert psink.records == jsink.records
    assert psink.records[0]["devices"][0]["stats"] is None


# -- watchdog -----------------------------------------------------------------


def test_watchdog_fires_in_process(tmp_path):
    sink = SimpleNamespace(records=[], tail=lambda: [{"kind": "x"}])
    sink.event = lambda name, **f: sink.records.append({"kind": name, **f})
    wd = p_wd.HangWatchdog(0.2, str(tmp_path / "pm"), telemetry=sink,
                           poll_s=0.02)
    try:
        wd.arm(step=3, epoch=0)
        for _ in range(200):
            if wd.fired_path:
                break
            threading.Event().wait(0.02)
        wd.disarm()
    finally:
        wd.stop()
    assert wd.fired_path and p_inc.is_incident_bundle(wd.fired_path)
    with open(os.path.join(wd.fired_path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "watchdog" and meta["step"] == 3
    assert sink.records[0]["kind"] == "watchdog_fired"
    assert port_sup.WATCHDOG_EXIT_CODE == p_wd.EXIT_CODE == 42


def test_watchdog_abort_exits_42_and_is_classified(tmp_path):
    base = str(tmp_path / "sentinel")
    script = ("import time; from distributed_training_tpu_torch.telemetry "
              "import watchdog; w = watchdog.HangWatchdog(0.2, "
              f"{str(tmp_path / 'pm')!r}, abort=True, poll_s=0.02); "
              "w.arm(step=1); time.sleep(30)")
    proc = subprocess.run(
        [sys.executable, "-c", script], timeout=120, capture_output=True,
        env=dict(os.environ, PYTHONPATH=REPO,
                 **{port_sup.ENV_SENTINEL: base}))
    assert proc.returncode == p_wd.EXIT_CODE == 42, proc.stderr[-2000:]
    statuses = port_sup.read_exit_statuses(base)
    assert [s["outcome"] for s in statuses] == [port_sup.WATCHDOG_ABORT]
    assert port_sup.classify_exit(proc.returncode, statuses) == \
        port_sup.WATCHDOG_ABORT
    assert port_sup.classify_exit(42, []) == port_sup.WATCHDOG_ABORT
    bundle = os.path.join(tmp_path, "pm", os.listdir(tmp_path / "pm")[0])
    with open(os.path.join(bundle, "stacks.txt")) as f:
        assert 'File "<string>"' in f.read()


# -- a gloo world of 2 through the launcher -----------------------------------

TINY = ["train.device=cpu", "model=gpt2_125m", "train=gpt2",
        "+model.n_layers=2", "+model.d_model=32", "+model.n_heads=2",
        "+model.vocab_size=64", "+model.max_seq_len=16",
        "train.dataset_kwargs.seq_len=16", "train.dataset_kwargs.vocab_size=64",
        "train.dtype=float32", "train.batch_size=2", "train.log_every=1",
        "run.log_level=WARNING"]


def test_straggler_eviction_and_launcher_summarize(tmp_path, monkeypatch,
                                                   capsys):
    """Host 1 sleeps 300 ms in every step from step 1: the exchange
    every 2 steps flags it, the verdict persists two windows, every
    process stops at the same step and process 0 writes the eviction
    request that the elastic supervisor reads; ``--summarize`` prints
    the merged two-host report."""
    out, el_dir = tmp_path / "out", tmp_path / "elastic"
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(port_elastic.ENV_ELASTIC_DIR, str(el_dir))
    run_dir = out / "default"
    rc = launch.main([
        "--nproc", "2", "--log-dir", str(tmp_path / "logs"),
        "--summarize", str(run_dir), "--", "-m",
        "distributed_training_tpu_torch.train", *TINY,
        "train.dataset_size=32", f"run.output_dir={out}",
        f"train.snapshot_path={out}/ckpt", "train.straggler_every=2",
        "train.straggler_persist=1", "train.straggler_evict_after=2",
        "train.fault_plan=slow_host@1:host=1:300ms"])
    report = capsys.readouterr().out
    assert rc == 0, report[-3000:]
    req = port_elastic.read_eviction_request(str(el_dir))
    assert req["host"] == 1 and req["reason"] == "straggler"
    assert req["step"] == 4
    for h in (0, 1):
        with open(run_dir / f"host_{h}" / "events.jsonl") as f:
            ev = [json.loads(line) for line in f]
        assert all(e.get("host") == h for e in ev)
        assert any(e["kind"] == "eviction_request" for e in ev)
        assert max(e["step"] for e in ev if e["kind"] == "span"
                   and e["name"] == "step") == 4
    assert "hosts: 2" in report or "host 1" in report
    assert report.strip() == j_agg.render_multihost(
        j_agg.aggregate_run(str(run_dir))).strip()


# -- the CLI with every option on ---------------------------------------------


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_every_option_emits_the_jax_schema(tmp_path):
    out = tmp_path / "run"
    run_dir = out / "default"
    box, stop = {}, threading.Event()

    def poll():
        while not stop.is_set():
            try:
                port = int((run_dir / "metrics.port").read_text())
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                    box["body"] = r.read().decode()
                if all(f"{n} " in box["body"] for n in
                       ("dtt_goodput", "dtt_step_time_seconds")):
                    return
            except (OSError, ValueError):
                pass
            stop.wait(0.05)

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        assert port_cli.main([
            *TINY, "train.dataset_size=24", f"run.output_dir={out}",
            f"train.snapshot_path={out}/ckpt", "train.profile_at=4",
            "train.profile_steps=2", "train.hbm_sample_every=3",
            "train.watchdog_timeout_s=60", f"train.metrics_port={_free_port()}",
            "+model.dropout=0.1",
            # A planted slow host from step 11, 1.5 s a step: the anomaly
            # detector (at its default, on) must flag it.
            "train.fault_plan=slow_host@11:host=0:1500ms",
            "train.anomaly_min_samples=6"]) == 0
    finally:
        stop.set()
        t.join(timeout=30)
    assert "dtt_goodput" in box.get("body", "")
    assert "dtt_step_time_seconds" in box["body"]
    with open(run_dir / "events.jsonl") as f:
        ev = [json.loads(line) for line in f]
    by = {}
    for e in ev:
        by.setdefault(e["kind"], []).append(e)
    for kind in ("run_start", "clock_sync", "runtime", "span",
                 "train_metrics", "goodput", "hbm", "attribution",
                 "kernel_launches"):
        assert kind in by, kind
    assert "anomaly_detect" not in by
    # The detector ran: it flagged the planted slow steps, and the
    # incident recorder bundled its event.
    flagged = [e for e in by["anomaly"] if e["signal"] == "step_time"]
    assert any(e["step"] >= 11 for e in flagged), by["anomaly"]
    assert set(j_anom.ANOMALY_KEYS) - {"detail"} <= set(flagged[-1])
    assert any(e["incident_kind"] == "anomaly" for e in by["incident"])
    # The JAX schema's keys, from the JAX package's own producers.
    path = str(tmp_path / "j.jsonl")
    tel = j_events.Telemetry(events_jsonl=path, start_step=0)
    tel.close()
    with open(path) as f:
        assert set(json.loads(f.readline())) <= set(by["run_start"][0])
    assert set(j_runtime.Runtime.clock_sync_record(SimpleNamespace(
        clock_sync_unix=1.0, process_index=0, process_count=1))) <= set(
        by["clock_sync"][0])
    led = j_good.GoodputLedger()
    run = [e for e in by["goodput"] if e["scope"] == "run"][0]
    assert set(led.report()) <= set(run)
    assert set(led.window_report()) <= set(by["goodput"][0])
    assert math.isclose(sum(run["buckets"].values()), run["wall_s"])
    jsink = _Sink()
    j_hbm.HBMSampler(jsink, every=1, estimate_bytes=1, devices=[
        SimpleNamespace(memory_stats=lambda: None)]).sample(1)
    assert set(jsink.records[0]) - {"kind"} <= set(by["hbm"][0])
    att = by["attribution"][0]
    assert set(j_att.SUMMARY_KEYS) - {"error"} <= set(att)
    assert set(j_xplane.attribution_of_events([])) <= set(att)
    assert att["steps_captured"] == 2 and "error" not in att
    assert [e["step"] for e in by["hbm"]] == [3, 6, 9, 12]
    assert len(by["train_metrics"]) == 12

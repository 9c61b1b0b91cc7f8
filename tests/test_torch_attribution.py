"""Step-time attribution: the port's Kineto reader against JAX's XSpace.

One timeline is encoded twice: as XSpace with JAX's
``xplane.encode_xspace`` (device planes with an "XLA Ops" lane, the host
plane's step/data_wait annotations) and as the Chrome-trace JSON that
``torch.profiler`` writes (``kernel`` events on device streams,
``user_annotation`` ranges on the host). JAX's ``attribution_of_planes``
and the port's ``attribution_of_trace`` agree to 1e-9 on every field.
``parse_profile_at`` parses as JAX's does; ``ProfileCapture`` captures a
real CPU ``torch.profiler`` trace and is one-shot across a restart
through its ledger, re-armed by the ``profile_now`` drop file, and
declines while another profiler runs.
"""

import json
import os

import pytest
import torch

from distributed_training_tpu_torch.telemetry import attribution as p_att
from distributed_training_tpu_torch.telemetry import kineto
from distributed_training_tpu_torch.utils import profiler

jax = pytest.importorskip("jax")

from distributed_training_tpu.telemetry import attribution as j_att  # noqa: E402
from distributed_training_tpu.telemetry import xplane  # noqa: E402

US = 1_000_000  # picoseconds per microsecond

# (stream, name, start us, duration us); the names classify alike in both
# packages.
TIMELINES = {
    "overlapped_comms": [
        (7, "fusion.1", 110, 40), (7, "all-reduce.2", 140, 30),
        (8, "all-gather.3", 120, 25), (7, "dot.4", 175, 50),
        (8, "fusion.5", 160, 20), (7, "reduce-scatter.6", 230, 15)],
    "compute_only": [(7, "fusion.1", 105, 10), (7, "dot.2", 118, 60),
                     (7, "fusion.3", 180, 5)],
    "host_bound": [(7, "dot.1", 400, 2), (7, "all-reduce.2", 403, 1)],
}
# The host's step and data_wait ranges (start us, duration us).
ANNOTATIONS = [("data_wait", 100, 8), ("step", 108, 160),
               ("data_wait", 268, 10), ("step", 278, 140)]


def _xspace(ops, annotations):
    lanes = {}
    for stream, name, start, dur in ops:
        lanes.setdefault(stream, []).append(
            xplane.Event(name=name, start_ps=start * US, dur_ps=dur * US))
    planes = [xplane.Plane(name=f"/device:GPU:{s}", lanes=[
        xplane.Lane(name="XLA Ops", events=evs)])
        for s, evs in sorted(lanes.items())]
    planes.append(xplane.Plane(name="/host:CPU", lanes=[xplane.Lane(
        name="python", events=[xplane.Event(name=n, start_ps=s * US,
                                            dur_ps=d * US)
                               for n, s, d in annotations])]))
    return xplane.parse_xspace(xplane.encode_xspace(planes))


def _kineto(ops, annotations, path):
    events = [{"ph": "X", "cat": "kernel", "name": name, "pid": 0,
               "tid": stream, "ts": float(start), "dur": float(dur)}
              for stream, name, start, dur in ops]
    events += [{"ph": "X", "cat": "user_annotation", "name": n,
                "pid": 4242, "tid": 4242, "ts": float(s), "dur": float(d)}
               for n, s, d in annotations]
    # The same ranges mirrored on the device's timeline, and the host's
    # launch calls: neither is work on the card.
    events += [{"ph": "X", "cat": "gpu_user_annotation", "name": n,
                "pid": 0, "tid": 7, "ts": float(s), "dur": float(d)}
               for n, s, d in annotations]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 4242, "tid": 4242, "ts": 101.0, "dur": 3.0},
               {"ph": "M", "name": "process_name", "pid": 0}]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


@pytest.mark.parametrize("annotated", [True, False])
@pytest.mark.parametrize("timeline", sorted(TIMELINES))
def test_kineto_attribution_matches_xspace(tmp_path, timeline, annotated):
    ops = TIMELINES[timeline]
    ann = ANNOTATIONS if annotated else []
    want = xplane.attribution_of_planes(_xspace(ops, ann))
    got = kineto.attribution_of_trace(kineto.load_trace(
        _kineto(ops, ann, str(tmp_path / "trace.json"))))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=1e-9), k
        else:
            assert got[k] == v, k
    assert got["source"] == "device"
    total = got["compute_frac"] + got["collective_frac"] + got["host_frac"]
    assert total == pytest.approx(1.0, abs=3e-6)


def test_classify_event():
    assert kineto.classify_event(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)") == \
        "collective"
    assert kineto.classify_event("void flash_fwd_sm90_kernel<64>()") == \
        "compute"
    # aten::permute is a layout op, not collective-permute.
    assert kineto.classify_event("aten::permute") == "compute"
    assert kineto.classify_event("step") is None


@pytest.mark.parametrize("spec", ["", "20", "20,500", " 7 , 3,7 ", 12,
                                  "x", "5,-1", "3.5"])
def test_parse_profile_at_matches_jax(spec):
    try:
        want = j_att.parse_profile_at(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="is not a step number"):
            p_att.parse_profile_at(spec)
        assert "train.profile_at" in str(e)
        return
    assert p_att.parse_profile_at(spec) == want


def test_summary_keys_are_jax_schema():
    assert p_att.SUMMARY_KEYS == j_att.SUMMARY_KEYS
    assert p_att.STATIC_SUMMARY_KEYS == j_att.STATIC_SUMMARY_KEYS
    rec = {"schema": 1, "step": 3, "top_ops": [], "compute_frac": 0.5}
    assert p_att.summary_of_event(rec) == j_att.summary_of_event(rec)


def _work():
    with torch.profiler.record_function("step"):
        a = torch.randn(64, 64)
        (a @ a).sum().item()


def test_profile_capture_is_one_shot_across_a_restart(tmp_path):
    run = str(tmp_path)
    cap = p_att.ProfileCapture(run, at_steps="3,4", n_steps=2)
    assert not cap.maybe_start(2)
    assert cap.maybe_start(3) and cap.active
    _work()
    assert cap.maybe_stop(3) is None
    _work()
    rep = cap.maybe_stop(4)
    assert "error" not in rep, rep
    assert rep["steps_captured"] == 2 and rep["trigger"] == "step_3"
    assert rep["source"] == "host" and rep["busy_s"] > 0
    assert rep["trace_dir"] == os.path.join("profiles", "step_000003")
    assert os.path.exists(rep["trace"])
    assert rep["top_ops"] and rep["window_s"] >= rep["busy_s"]
    with open(os.path.join(run, "profiles", "fired.json")) as f:
        assert json.load(f) == ["step_3"]
    # A restarted incarnation: step 3 does not fire again; step 4, due
    # and unfired, fires once at the first step at or after it.
    again = p_att.ProfileCapture(run, at_steps="3,4", n_steps=1)
    assert not again.maybe_start(3)
    assert again.maybe_start(9)
    again.abort()
    assert not again.active and not again.maybe_start(10)
    # The drop file re-arms it, once.
    open(os.path.join(run, p_att.TRIGGER_FILE), "w").close()
    assert again.maybe_start(11)
    assert not os.path.exists(os.path.join(run, p_att.TRIGGER_FILE))
    again.abort()
    assert not again.maybe_start(12)
    with open(os.path.join(run, "profiles", "fired.json")) as f:
        assert json.load(f) == ["file_at_11", "step_3", "step_4"]


def test_capture_declines_while_a_profiler_runs(tmp_path):
    cap = p_att.ProfileCapture(str(tmp_path / "run"), at_steps=1)
    with profiler.trace(str(tmp_path / "whole")):
        assert not cap.maybe_start(1)
        _work()
    assert os.path.exists(tmp_path / "whole" / profiler.TRACE_FILE)
    records = kineto.load_trace(str(tmp_path / "whole" /
                                    profiler.TRACE_FILE))
    assert kineto.annotation_window(records) is not None


def test_trace_steps_traces_after_warmup(tmp_path):
    steps = []

    class Trainer:
        def train_step(self, batch):
            steps.append(batch)
            _work()

    res = profiler.trace_steps(Trainer(), range(5), str(tmp_path), warmup=2)
    assert res == profiler.TraceResult(steps=3, logdir=str(tmp_path))
    assert steps == [0, 1, 2, 3, 4]
    assert kineto.find_trace(str(tmp_path)).endswith(profiler.TRACE_FILE)

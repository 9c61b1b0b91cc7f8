"""Device time by the program's spans (``yardstick/spans.py``) on a
synthetic Chrome trace: the innermost holding span, another thread's
launches inside the main thread's span, a graph's kernels, uncorrelated
events, the busy time's partition and the gaps' names; the harness's
own reading of the same trace (``Capture.read``), which the program's
spans do not move; and ``phases.py`` dry-run on the CPU."""

from __future__ import annotations

import json

import pytest

from portbench import harness, phases, tracing
from portbench.tests.tiny import opts, tiny_cell
from portbench.yardstick import spans

MAIN, AUTOGRAD = 101, 102


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1 if cat != "kernel" else 0, "tid": tid, "args": args}


def _launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 2, tid, correlation=corr)


def _kernel(corr, ts, dur, name="k"):
    return _x("kernel", name, ts, dur, 7, correlation=corr)


def _note(name, ts, dur, tid=MAIN):
    return _x("user_annotation", name, ts, dur, tid)


HARNESS = [_note("train_step", 0, 100)]
PROGRAM = [
    _note("step", 1, 98),
    _note("forward", 2, 30),
    _note("fsdp.gather", 5, 10),
    _note("backward", 35, 30),
    _note("fsdp.reduce_scatter", 50, 5, tid=AUTOGRAD),
    _note("optimizer", 75, 20),
]
DEVICE = [
    _launch(1, 6), _kernel(1, 10, 10),           # in fsdp.gather
    _launch(2, 20), _kernel(2, 20, 10),          # in forward
    _launch(3, 45, AUTOGRAD), _kernel(3, 45, 10),  # autograd thread
    _launch(4, 52, AUTOGRAD), _kernel(4, 55, 5),   # its reduce-scatter
    _launch(5, 80, name="cudaGraphLaunch"),
    _kernel(5, 82, 4, "g1"), _kernel(5, 86, 4, "g2"),  # one graph
    _kernel(None, 92, 3, "uncorrelated"),
    _launch(6, 99), _kernel(6, 100, 10, "late"),  # after every span
]


def _trace(tmp_path, records):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": records}))
    return str(path)


@pytest.fixture
def read(tmp_path):
    trace = spans.load(_trace(tmp_path, HARNESS + PROGRAM + DEVICE))
    ours = [s for s in trace.spans if s.name not in tracing.SPANS]
    return trace, spans.attribute(trace, ours, (0, 120 * 10 ** 6))


def _ms(x):
    return round(x * 1e6, 6)  # seconds -> microseconds


def test_innermost_and_inclusive(read):
    _, got = read
    assert {k: _ms(v) for k, v in got["innermost"].items()} == {
        "fsdp.gather": 10, "forward": 10, "backward": 10,
        "fsdp.reduce_scatter": 5, "optimizer": 8}
    inc = {k: _ms(v) for k, v in got["inclusive"].items()}
    assert inc["forward"] == 20 and inc["fsdp.gather"] == 10
    # The autograd thread's kernels lie in the main thread's backward.
    assert inc["backward"] == 15
    assert inc["optimizer"] == 8  # both kernels of the graph
    assert inc["step"] == 43


def test_unattributed_completes_the_busy_time(read):
    trace, got = read
    assert _ms(got["unattributed"]) == 13
    assert _ms(got["busy"]) == 56
    assert got["inclusive"]["step"] + got["unattributed"] == \
        pytest.approx(got["busy"])
    assert got["counts"] == {"step": 1, "forward": 1, "fsdp.gather": 1,
                             "backward": 1, "fsdp.reduce_scatter": 1,
                             "optimizer": 1}
    assert trace.launch[-2] is None  # the uncorrelated event


def test_window_clips(read):
    trace, _ = read
    ours = [s for s in trace.spans if s.name not in tracing.SPANS]
    got = spans.attribute(trace, ours, (0, 50 * 10 ** 6))
    assert _ms(got["busy"]) == 25
    assert _ms(got["inclusive"]["backward"]) == 5
    assert got["counts"]["backward"] == 1 and "optimizer" not in \
        got["counts"]


def test_idle_gaps_take_the_innermost_name(tmp_path):
    trace = spans.load(_trace(tmp_path, HARNESS + PROGRAM + DEVICE))
    gaps = spans.idle_gaps(trace.device, trace.spans, (0, 120 * 10 ** 6),
                           top=3)
    # The three longest gaps: 60-82 (its middle in step alone), 30-45
    # (in backward) and 0-10 (in fsdp.gather, inside forward and step).
    assert [g[0] for g in gaps] == ["step", "backward", "fsdp.gather"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [22, 15, 10]


class _Exported:
    """A profiler whose export writes a fixed trace."""

    def __init__(self, records):
        self.records = records

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.records}, f)


def test_harness_reading_unmoved_by_program_spans():
    """``Capture.read``'s ``host``, ``window``, ``steps`` and attribution
    are the same with and without the program's annotations."""
    reads = []
    for records in (HARNESS + DEVICE, HARNESS + PROGRAM + DEVICE):
        cap = tracing.Capture("cpu")
        cap.prof = _Exported(records)
        reads.append(cap.read("train_step"))
    a, b = reads
    for key in ("host", "window", "steps", "attribution", "device"):
        assert a[key] == b[key], key
    assert [h.name for h in b["host"]] == ["train_step"]


@pytest.mark.parametrize("name", [
    w["name"] for w in harness.benchmark()["workloads"] if w["chips"] == 1])
def test_phases_dry_run(name, capsys, monkeypatch):
    """``phases.py`` on the CPU at a tiny size: a line a stretch and the
    summary; the sink's totals carry the program's spans (no device
    events here, so the device readings are zero)."""
    monkeypatch.setattr(tracing, "TRACE_S", 0.3)
    cell = tiny_cell(name)
    run = phases.train if cell.traffic["generator"] == "train" else \
        phases.serve
    summary = run(cell, opts(seconds=0.3, rounds=1))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["kind"], r["sink"]) for r in lines] == [
        ("stretch", False), ("stretch", True), ("traced", True)]
    assert lines[0]["totals"] is None
    assert summary["rate"] in lines[0] and len(summary["off"]) == 1
    kept = lines[1]["totals"]["spans"]
    traced = lines[2]
    assert traced["idle_gaps"]
    if cell.traffic["generator"] == "train":
        assert kept["forward"]["count"] == kept["backward"]["count"] == \
            kept["optimizer"]["count"] == lines[1]["steps"]
        assert ("fsdp.gather" in kept) == (
            cell.spec["program"]["strategy"] == "fsdp")
        assert set(traced["device_ms"]) == set(phases.TRAIN_PHASES)
    else:
        assert kept["engine.step"]["count"] == lines[1]["steps"]
        assert 0 < lines[1]["engine_bookkeeping_ms"] < \
            lines[1]["host_step_ms"]
        assert 0 < lines[1]["kv_occupancy"] <= 100
        assert traced["launches"]["engine.decode"] > 0

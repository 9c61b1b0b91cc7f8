"""The benchmark's files: every cell, configuration, traffic mix and
per-layer metric of BENCHMARK.json is found by its name, and the file
keeps to the contract's shapes."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = harness.load_cell(w["name"])
    assert cell.spec["config"] == w["config"]
    assert cell.spec["traffic"] == w["traffic"]
    assert cell.spec["chips"] == w["chips"]
    assert cell.spec["why"] == w["why"]
    generator = harness.load_module("traffic", cell.traffic["generator"])
    assert callable(generator.run)
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = os.path.join(harness.ROOT, c["file"])
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    run = cfg["run"]
    assert run["d_model"] % run["n_heads"] == 0
    assert run["vocab_ids"] <= run["vocab_rows"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_per_layer_layers_named_as_perf_md_lists_them():
    """Each metric's ``layer`` is a row of PERF.md's list of layers."""
    with open(os.path.join(harness.ROOT, "PERF.md"), encoding="utf-8") as f:
        text = f.read()
    rows = {line.split("|")[1].strip() for line in text.splitlines()
            if line.startswith("| ")}
    for m in BENCH["per_layer"]:
        assert m["layer"] in rows, m["layer"]

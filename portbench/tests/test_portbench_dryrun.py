"""A dry run of every traffic generator at a tiny size on the CPU: the
result line has the contract's shape, and nothing the run loaded has the
top-level name ``jax``, ``jaxlib``, ``flax`` or
``distributed_training_tpu`` (a fresh process, so that what this test
process imported does not count)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]
         if w["chips"] == 1]

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.tiny import tiny_cell, opts
import portbench.run as R
cell = tiny_cell({cell!r})
lines = [R.execute(cell, opts(seconds=0.6, trace=t)) for t in (False, True)]
print(json.dumps({{"lines": lines, "loaded": harness.forbidden_modules()}}))
"""


@pytest.fixture(scope="module", params=CELLS)
def dry(request):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=harness.ROOT,
                                             cell=request.param)],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT,
        env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin",
             "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-4000:]
    return request.param, json.loads(out.stdout.strip().splitlines()[-1])


def test_result_lines(dry):
    name, got = dry
    cell = harness.load_cell(name)
    plain, traced = got["lines"]
    for line in (plain, traced):
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] > 0
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    assert set(traced["metrics"]) <= set(units)
    for k, v in traced["metrics"].items():
        assert v["unit"] == units[k]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_nothing_of_jax_loaded(dry):
    _, got = dry
    assert got["loaded"] == []


def test_forbidden_names_compare_whole(monkeypatch):
    """The port's own name begins with the JAX package's and passes."""
    monkeypatch.setitem(sys.modules, "distributed_training_tpu_torch.x",
                        object())
    assert "distributed_training_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.foo", object())
    assert "jaxlib" in harness.forbidden_modules()

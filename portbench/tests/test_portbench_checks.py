"""``correct`` at a tiny size on the CPU: the plain reference agrees
with the program run in float32; each fault a cell can have, planted
under the timed path, makes a whole run come out not correct; and the
fp8 control reads several times what the program does."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness
from portbench import run as R
from portbench.tests.tiny import opts, tiny_cell

TRAIN = "gpt2_125m.pretrain_b32"
FSDP = "transformer_1b.pretrain_fsdp1_b4"
SERVE = "gpt2_125m.serve_closed32"


@pytest.mark.parametrize("name", [TRAIN, FSDP])
def test_reference_matches_program_in_f32(name):
    cell = tiny_cell(name)
    cell.spec["program"]["dtype"] = "float32"
    generator = harness.load_module("traffic", "train")
    got = generator.readings(cell, opts(seed=5))
    # Steps 2 and 3 move each weight by about 1e-5 of its 0.02: the
    # change is read through f32 round-off of the weights themselves.
    assert got.pop("change_leaf") < 2e-4
    assert max(got.values()) < 2e-5, got


def test_reference_matches_served_tokens_in_f32():
    cell = tiny_cell(SERVE)
    cell.spec["program"]["dtype"] = "float32"
    line = R.execute(cell, opts(seed=5, seconds=0.6))
    assert line["checks"]["served_gap"]["value"] < 1e-4


@pytest.mark.parametrize("name,fault", [(TRAIN, "unchanged"),
                                        (TRAIN, "half_batch"),
                                        (FSDP, "unchanged"),
                                        (FSDP, "half_batch"),
                                        (SERVE, "token")])
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    assert R.execute(cell, opts(seed=9, seconds=0.4))["correct"] is True
    line = R.execute(cell, opts(seed=9, seconds=0.4, fault=fault))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", [TRAIN, FSDP])
def test_control_reads_above_program(name):
    """At this size the fp8 control's worst number is several times the
    bf16 program's over three seeds."""
    cell = tiny_cell(name)
    generator = harness.load_module("traffic", "train")
    prog = [generator.readings(cell, opts(seed=s)) for s in (1, 2, 3)]
    ctl = [generator.control(cell, opts(seed=s)) for s in (1, 2, 3)]
    for key in ("grad_leaf", "change_leaf"):
        lower = max(p[key] for p in prog)
        upper = min(c[key] for c in ctl)
        assert upper > 3 * lower, (key, lower, upper)
    assert np.isfinite([p["loss_step1"] for p in prog]).all()

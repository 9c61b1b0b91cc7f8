"""The controls at the cells' own sizes, on the card: the fp8 reference
put in the program's place must come out not correct under each cell's
limits. Run on a machine with the card:

    python3 -m pytest portbench/tests -m gpu -q
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

TRAIN = [w["name"] for w in harness.benchmark()["workloads"]
         if w["chips"] == 1 and "pretrain" in w["name"]]
SERVE = [w["name"] for w in harness.benchmark()["workloads"]
         if "serve" in w["name"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _opts(seed: int) -> dict:
    return {"seed": seed, "seconds": 5.0, "trace": False, "device": "cuda",
            "t_start": time.perf_counter(), "keep": True}


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN)
def test_training_control_not_correct(name):
    _card()
    cell = harness.load_cell(name)
    generator = harness.load_module("traffic", "train")
    ok, checks = harness.judge(generator.control(cell, _opts(4242)),
                               cell.spec["limits"])
    assert not ok, checks


@pytest.mark.gpu
@pytest.mark.parametrize("name", SERVE)
def test_serving_control_not_correct(name):
    _card()
    from portbench.reference import check_serve

    cell = harness.load_cell(name)
    generator = harness.load_module("traffic", "closed_loop")
    res = generator.run(cell, _opts(4242))
    picked = check_serve.sample(res["finished"], 4242,
                                cell.traffic["check_tokens"])
    params = check_serve.served_weights(cell.run_cfg, 4242,
                                        torch.device("cuda"),
                                        cell.spec["program"]["dtype"])
    gap = check_serve.served_gap(check_serve.gaps(
        cell.run_cfg, params, picked, torch.device("cuda"), low=True))
    ok, checks = harness.judge({"served_gap": gap}, cell.spec["limits"])
    assert not ok, checks

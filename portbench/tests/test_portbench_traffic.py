"""The serving mix as its source states it, the same requests for every
seed in an order of its own, and the idle readers' arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness
from portbench.traffic import closed_loop
from portbench.yardstick import timeline

SERVE = [w for w in harness.benchmark()["workloads"]
         if "serve" in w["name"]]


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
def test_pool_keeps_the_source_means(w):
    tr = harness.load_cell(w["name"]).traffic
    assert tr["source"]
    pool = closed_loop.length_pool(tr)
    for col, key in ((0, "prompt"), (1, "output")):
        law = tr[key]
        if law["law"] == "exponential":
            assert pool[:, col].mean() == pytest.approx(law["mean"],
                                                        rel=0.01)
        assert pool[:, col].min() >= law["min"]
        assert pool[:, col].max() <= law["max"]


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
def test_every_seed_offers_the_pool_in_its_own_order(w):
    tr = harness.load_cell(w["name"]).traffic
    n = tr["pool"]

    def lengths(seed):
        req = closed_loop.Requests(tr, seed)
        return [tuple((len(p), o)) for p, o in
                (req.next() for _ in range(2 * n))]

    a, b = lengths(2718281801), lengths(4242)
    assert sorted(a[:n]) == sorted(b[:n]) == sorted(map(tuple, closed_loop
                                                        .length_pool(tr)))
    assert sorted(a[n:]) == sorted(a[:n])
    assert a[:n] != b[:n]
    assert a == lengths(2718281801)


def _traced(busy_s: float, steps: int) -> dict:
    device = [timeline.Event("k", 0, int(busy_s * 1e12))]
    return {"device": device, "steps": steps,
            "attribution": timeline.attribution(
                device, (0, int(2 * busy_s * 1e12)))}


@pytest.mark.parametrize("name", ["idle_share.train", "idle_share.fsdp"])
def test_training_idle_share_reads_the_untraced_rest(name):
    reader = harness.load_module("metrics", name)
    # 0.9 s of kernels over 3 traced steps; the rest ran 10 steps in
    # 3.125 s: 0.3 s of work in each 0.3125 s step, 4% idle.
    ctx = {"traced": _traced(0.9, 3),
           "after": {"steps": 10, "seconds": 3.125}}
    assert reader.read(ctx) == pytest.approx(4.0)
    assert reader.read({**ctx, "after": {"steps": 0, "seconds": 0.0}}) \
        is None


def test_serving_idle_share_reads_the_untraced_rest():
    reader = harness.load_module("metrics", "idle_share.serve")
    ctx = {"traced": _traced(2.0, 40), "after_s": 10.0,
           "tokens": {"traced": 10_000, "after": 30_000}}
    # 0.2 ms of kernels a token; 3,000 tokens a second untraced: 60%
    # busy.
    assert reader.read(ctx) == pytest.approx(40.0)
    assert np.isfinite(reader.read(ctx))

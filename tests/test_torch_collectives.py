"""The port's collectives audit (``telemetry/collectives.py``, the
trainer's ``collectives`` event) held against JAX's
(``audit_hlo_text`` over the compiled step, ``Trainer.collectives_report``).

The shared surface first: ``summary_of_event``, ``render_lines``, the
summarizer's and the multi-host report's lines give JAX's output on the
same event. Then one spawned gloo world of 2
(``tests/test_torch_collectives_world.py``) trains the tiny transformer
of ``tests/test_analysis.py``'s collectives test (vocab 64, d_model 16,
2 heads, 1 layer, seq 8, batch 2 a shard, f32) for two steps under ddp
(dp 2), fsdp (fsdp 2) and tp (tp 2), and JAX's abstract trainer reports
the same configurations on two fake CPU devices. The port's event and
JAX's report have the same ``mesh`` and axis labels, and both sides'
bytes are derived from the same leaves, every gap between them named:

- ddp: the port's dp all-reduce of the gradients is the params' 17 600
  bytes; JAX's fused tuple adds the tied head's (64, 16) partial (4 096
  bytes, reduced before it is added to the embedding's) and the loss. The
  count of live targets is the port's f32 (2, 1) per shard, JAX's s32
  scalar; the port's metrics mean is an f32 pair.
- fsdp: the port gathers every leaf whole once and the tied embedding
  again for the head (17 600 + 4 096 bytes), and reduce-scatters each
  gathered tensor's gradient (half of that); JAX gathers every leaf once,
  re-gathers three 16-element norm leaves in the backward, and gathers
  the global batch's tokens and final hidden states, then syncs the
  gradients by a full all-reduce (XLA on the CPU), where the port
  reduce-scatters.
- tp: both reduce the activations, the cross-entropy's three (B, S)
  reductions and the tp-split leaves' norm partials; JAX gathers the
  vocab-split embedding whole (4 096 bytes) where the port's
  vocab-parallel lookup all-reduces the activation, and JAX reduces the
  q, k and v input gradients as three tensors where the port's
  ``copy_to_tp`` reduces their sum once.

The event is emitted once, by the coordinator, after the first step.
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import subprocess
import sys
import types

import pytest
import torch

from distributed_training_tpu_torch.telemetry import aggregate as port_agg
from distributed_training_tpu_torch.telemetry import collectives as port_coll
from distributed_training_tpu_torch.telemetry import summarize as port_sum

jax = pytest.importorskip("jax")

from distributed_training_tpu.telemetry import aggregate as jax_agg  # noqa: E402
from distributed_training_tpu.telemetry import collectives as jax_coll  # noqa: E402
from distributed_training_tpu.telemetry import summarize as jax_sum  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_collectives_world.py")

MODEL = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1,
             max_seq_len=8, dtype="float32")
B, S, D, L = 2, 8, 16, 1
CASES = {"ddp": {"dp": 2}, "fsdp": {"fsdp": 2}, "tp": {"tp": 2}}

EVENTS = [
    {"schema": 1, "total_collectives": 0, "bytes_per_step": 0,
     "by_kind": {}, "by_axis": {}, "mesh": {},
     "spmd_reshard_warnings": 0},
    {"schema": 1, "total_collectives": 3, "bytes_per_step": 3_500_000,
     "by_kind": {"all-reduce": {"count": 2, "bytes": 3_000_000},
                 "all-gather": {"count": 1, "bytes": 500_000}},
     "by_axis": {"dp": {"count": 2, "bytes": 3_000_000},
                 "fsdp+tp": {"count": 1, "bytes": 500_000}},
     "mesh": {"dp": 2, "fsdp": 2, "tp": 2}, "spmd_reshard_warnings": 0,
     "largest": [], "rows": []},
    {"schema": 1, "total_collectives": 1, "bytes_per_step": 64,
     "by_kind": {"collective-permute": {"count": 1, "bytes": 64}},
     "by_axis": {"unknown": {"count": 1, "bytes": 64}},
     "mesh": {"sp": 2}, "spmd_reshard_warnings": 2,
     "sharding_plan": {"name": "p", "fingerprint": "abc",
                       "base_strategy": "fsdp", "remat": "none"}},
]


# -- the shared surface ---------------------------------------------------------


def test_schema_and_kinds_are_jax():
    assert port_coll.SCHEMA == jax_coll.SCHEMA
    assert port_coll.SUMMARY_KEYS == jax_coll.SUMMARY_KEYS
    assert port_coll.COLLECTIVE_KINDS == jax_coll.COLLECTIVE_KINDS


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_render_and_summary_match_jax(i):
    ev = EVENTS[i]
    assert port_coll.summary_of_event(ev) == jax_coll.summary_of_event(ev)
    assert port_coll.render_lines(ev) == jax_coll.render_lines(ev)


def _write_run(run_dir, ev: dict, host=None) -> None:
    os.makedirs(run_dir, exist_ok=True)
    recs = [{"kind": "run_start", "t": 1.0, "step": 0},
            *({"kind": "span", "name": "step", "t": 2.0 + i, "dur_s": 0.25,
               "depth": 0, "parent": None, "step": i + 1}
              for i in range(4)),
            {"kind": "collectives", "t": 3.0, **ev}]
    if host is not None:
        recs = [{**r, "host": host} for r in recs]
    with open(os.path.join(run_dir, "events.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)


def _block(text: str) -> list[str]:
    """The collectives block of a rendered report."""
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith("collectives:"))
    out = [lines[i]]
    for ln in lines[i + 1:]:
        if not (ln.startswith("  axis") or ln.startswith("  ~")
                or ln.startswith("  SPMD") or ln.startswith("  sharding")):
            break
        out.append(ln)
    return out


@pytest.mark.parametrize("i", range(1, len(EVENTS)))
def test_summarize_and_aggregate_render_jax_lines(tmp_path, i):
    """The single-run summary (with the bandwidth over the measured
    steps) and the multi-host report render the event as JAX's do."""
    _write_run(str(tmp_path / "one"), EVENTS[i])
    got = port_sum.summarize_run(str(tmp_path / "one"))
    want = jax_sum.summarize_run(str(tmp_path / "one"))
    assert got["collectives"] == want["collectives"]
    assert _block(port_sum.render(got)) == _block(jax_sum.render(want))
    for h in (0, 1):
        _write_run(str(tmp_path / "multi" / f"host_{h}"), EVENTS[i], host=h)
    got = port_agg.aggregate_run(str(tmp_path / "multi"))
    want = jax_agg.aggregate_run(str(tmp_path / "multi"))
    assert got["collectives"] == want["collectives"]
    assert (_block(port_agg.render_multihost(got))
            == _block(jax_agg.render_multihost(want)))


def test_groupings_and_labels():
    """Labels are the ``+``-joined mesh axes of the grouping a group is
    one of, in mesh order; any other set of processes is unknown."""
    mesh = types.SimpleNamespace(
        ranks=torch.arange(8).view(1, 2, 2, 1, 2))   # dp 2, fsdp 2, tp 2
    groupings = port_coll.mesh_axis_groupings(mesh)
    assert [g[0] for g in groupings] == [
        "dp", "fsdp", "tp", "dp+fsdp", "dp+tp", "fsdp+tp", "dp+fsdp+tp"]
    assert port_coll.axes_label((0, 1), groupings) == "tp"
    assert port_coll.axes_label((5, 7), groupings) == "fsdp"
    assert port_coll.axes_label((1, 5), groupings) == "dp"
    assert port_coll.axes_label((4, 5, 6, 7), groupings) == "fsdp+tp"
    assert port_coll.axes_label(tuple(range(8)), groupings) == "dp+fsdp+tp"
    assert port_coll.axes_label((0, 3), groupings) == "unknown"
    assert port_coll.axes_label((0, 1, 2), groupings) == "unknown"


def test_record_outside_a_window_and_over_a_group_of_one(tmp_path):
    """Nothing is recorded outside a window (no process group needed),
    nor over a group of one; a kind outside JAX's table raises."""
    import torch.distributed as dist

    port_coll.record("all-reduce", None, torch.zeros(4))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        with port_coll.recording() as rows:
            port_coll.record("all-reduce", None, torch.zeros(4))
            with pytest.raises(ValueError, match="collective kind"):
                port_coll.record("broadcast", None, torch.zeros(4))
            with pytest.raises(RuntimeError, match="already open"):
                with port_coll.recording():
                    pass
        assert rows == []
    finally:
        dist.destroy_process_group()


# -- the world against JAX's abstract trainer ------------------------------------


def _spawn(out: str) -> None:
    job = {"world": 2, "rdzv": os.path.join(out, "rdzv"), "out": out,
           "model": MODEL, "seq_len": S,
           "train": {"batch_size": B, "min_shard_elems": 1,
                     "dtype": "float32", "log_every": 0, "device": "cpu"},
           "cases": [{"name": n, "strategy": n, "mesh": m}
                     for n, m in CASES.items()]}
    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "job.json"), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        log[-3000:] for log in logs)


def _jax_reports() -> dict:
    """JAX's ``collectives_report`` per case, and its param leaves'
    shapes (``build_abstract_trainer`` on two fake CPU devices)."""
    import numpy as np

    from distributed_training_tpu.analysis.compile import (
        build_abstract_trainer)

    out = {}
    for name, axes in CASES.items():
        trainer, _rt, batch = build_abstract_trainer(
            2, name, "transformer", MODEL, batch_size=B, seq_len=S,
            mesh_axes=axes,
            train_overrides=dict(min_shard_elems=1, dtype="float32"))
        rep = trainer.collectives_report(batch)
        shapes = jax.eval_shape(trainer.model.init, trainer.init_rng)
        out[name] = {
            "report": {k: v for k, v in rep.items()},
            "leaf_bytes": [int(np.prod(s.shape)) * s.dtype.itemsize
                           for s in jax.tree_util.tree_leaves(shapes)]}
    return out


def _once(root, name: str, make):
    """``make(dir)``'s result, made once for every test process of the
    run that shares ``root`` (an exclusive lock around a marker file),
    then read from ``dir``."""
    d = root / name
    d.mkdir(exist_ok=True)
    done = d / "done.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            with open(done, "wb") as f:
                pickle.dump(make(str(d)), f)
    with open(done, "rb") as f:
        return pickle.load(f)


_WORLD: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's output directory, JAX's reports), once per test
    run."""
    if "out" not in _WORLD:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # the run's directory, above the workers'

        def make(d):
            _spawn(d)
            return {"dir": d, "jax": _jax_reports()}
        _WORLD["out"] = _once(root, "collectives_world", make)
    return _WORLD["out"]


def _port(world: dict, name: str) -> dict:
    with open(os.path.join(world["dir"], f"{name}.json")) as f:
        run = json.load(f)
    (event,) = run["events"]
    run["event"] = event
    run["leaf_bytes"] = [4 * int(torch.tensor(s).prod())
                         for s in run["shapes"].values()]
    return run


def _rows(rep: dict, kind: str) -> list:
    return [r for r in rep["rows"] if r["kind"] == kind]


def _bytes(rep: dict, kind: str) -> int:
    return rep["by_kind"].get(kind, {}).get("bytes", 0)


@pytest.mark.parametrize("name", list(CASES))
def test_event_has_jax_keys_mesh_and_axes(world, name):
    got = _port(world, name)["event"]
    want = world["jax"][name]["report"]
    assert set(port_coll.SUMMARY_KEYS) - {"sharding_plan"} <= set(got)
    assert got["schema"] == want["schema"] == 1
    assert got["mesh"] == want["mesh"] == CASES[name]
    assert set(got["by_axis"]) == set(want["by_axis"]) == set(CASES[name])
    assert got["spmd_reshard_warnings"] == want["spmd_reshard_warnings"] == 0
    assert got["total_collectives"] == len(got["rows"])
    assert got["bytes_per_step"] == sum(r["bytes"] for r in got["rows"])
    assert port_coll.render_lines(got) == jax_coll.render_lines(got)


@pytest.mark.parametrize("name", list(CASES))
def test_event_emitted_once_by_the_coordinator(world, name):
    for rank, want in ((0, 1), (1, 0)):
        with open(os.path.join(world["dir"],
                               f"{name}.count.rank{rank}.json")) as f:
            got = json.load(f)
        assert got == {"collectives_events": want, "steps": 2}, (rank, got)


def test_ddp_bytes_are_the_leaves(world):
    port, jx = _port(world, "ddp"), world["jax"]["ddp"]
    leaves = sum(jx["leaf_bytes"])
    assert leaves == sum(port["leaf_bytes"]) == 17_600
    tok = 64 * 16 * 4
    got, want = port["event"], jx["report"]
    # The port: one all-reduce of every gradient, the live-target counts
    # (f32, one per data shard and microbatch) and the metrics' mean.
    sizes = sorted(r["bytes"] for r in _rows(got, "all-reduce"))
    assert sizes == [2 * 4, 2 * 4, leaves]
    assert {r["shape"] for r in _rows(got, "all-reduce")} == {
        "2,1", "2", "4400"}
    # JAX: the gradients, the tied head's partial and the loss in one
    # tuple, and its s32 count.
    assert _bytes(want, "all-reduce") == leaves + tok + 4 + 4 == 21_704
    assert sorted(r["tuple_arity"] for r in _rows(want, "all-reduce")) == [
        1, len(jx["leaf_bytes"]) + 2]


def test_fsdp_bytes_are_the_leaves(world):
    port, jx = _port(world, "fsdp"), world["jax"]["fsdp"]
    leaves = sum(jx["leaf_bytes"])
    tok = 64 * 16 * 4
    got, want = port["event"], jx["report"]
    # Every leaf is stored split (min_shard_elems 1).
    assert all(pl is not None for pl in port["placements"].values())
    # The port: each leaf gathered once, the tied embedding again for
    # the head; each gathered tensor's gradient reduce-scattered.
    assert _bytes(got, "all-gather") == leaves + tok == 21_696
    assert _bytes(got, "reduce-scatter") == (leaves + tok) // 2
    # Scalars only: the live-target counts, the metrics, and the norm's
    # per-leaf partial sums over fsdp.
    assert sorted(r["bytes"] for r in _rows(got, "all-reduce")) == [
        8, 8, 4 * len(port["leaf_bytes"])]
    # JAX: each leaf once, three 16-element norm leaves again in the
    # backward, the global batch's s32 tokens and (4, 8, 16) hidden
    # states; then the gradients' full all-reduce, the norm partials
    # and the loss, and the count.
    tokens, hidden = 2 * B * S * 4, 2 * B * S * D * 4
    assert _bytes(want, "all-gather") == (leaves + 3 * 16 * 4 + tokens
                                          + hidden) == 19_968
    assert _bytes(want, "all-reduce") == leaves + 4 * (16 + 1) + 4 \
        == 17_672
    assert _bytes(want, "reduce-scatter") == 0


def test_tp_bytes_are_the_activations_and_leaves(world):
    port, jx = _port(world, "tp"), world["jax"]["tp"]
    got, want = port["event"], jx["report"]
    act = B * S * D * 4
    xent = 3 * B * S * 4        # the row max, the sum, the target logit
    split = [k for k, pl in port["placements"].items()
             if pl and any("tp" in a for _d, a in pl)]
    assert len(split) == 8
    # The port: 2L + 1 reduce_from_tp (the lookup, attention, MLP) and
    # 2L + 1 copy_to_tp backward reductions (q/k/v's input, wi's, the
    # head's), the cross-entropy, the norm partials.
    assert [r["bytes"] for r in _rows(got, "all-reduce")
            if r["shape"] == "2,8,16"] == [act] * 2 * (2 * L + 1)
    assert _bytes(got, "all-reduce") == (2 * (2 * L + 1) * act + xent
                                         + 4 * len(split)) == 6_368
    assert _bytes(got, "all-gather") == 0
    # JAX: the table gathered whole for the lookup; forward attention
    # and MLP outputs, backward q, k, v separately plus wi's and the
    # head's inputs, the cross-entropy, the same norm partials.
    assert _bytes(want, "all-gather") == 64 * 16 * 4
    assert _bytes(want, "all-reduce") == ((2 * L + 4 * L + 1) * act + xent
                                          + 4 * len(split)) == 7_392

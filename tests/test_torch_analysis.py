"""The port's static analysis (``distributed_training_tpu_torch/analysis``)
held against the JAX package's (``tests/test_analysis.py``'s layers).

- the pitfall rules (DTT001–DTT004, DTT007–DTT011 in their torch forms):
  a positive and a negative fixture each, the ``# noqa`` scoping, the
  ``tests/`` exemption, and the port's own tree clean;
- the ratchet (``baseline.py``): JAX's semantics on synthetic findings;
- the audit: the 8-device targets audited once per run on one spawned
  gloo world of 8 (SPMD003 at a floor of one byte, so that every
  replicated leaf is a finding), their SPMD003 fingerprints equal to
  JAX's ``_replicated_param_findings`` on the train targets (and on the
  same targets at the default ``min_shard_elems``, where small leaves
  stay whole), the committed baseline exact, the document's shape, the
  pins; a
  one-device target audited in this process (zero collectives, zero
  findings); the CLI's subset refusal.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import pickle
import subprocess
import sys

import pytest

from distributed_training_tpu_torch.analysis import (
    audit,
    baseline,
    pitfalls,
    targets,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "distributed_training_tpu_torch"


def _rules(tmp_path, src, name="x.py"):
    p = tmp_path / name
    p.write_text(src)
    return pitfalls.check_file_rules(str(p), repo=str(tmp_path))


def _rules_scoped(tmp_path, src, rel=f"{PKG}/train", code=None):
    d = tmp_path / rel
    d.mkdir(parents=True, exist_ok=True)
    p = d / "x.py"
    p.write_text(src)
    got = pitfalls.check_file_rules(str(p), repo=str(tmp_path))
    return [g for g in got if code is None or code in g]


# -- registry plumbing ---------------------------------------------------------


def test_registry_has_the_ported_rules():
    assert set(pitfalls.RULES) == {
        "DTT001", "DTT002", "DTT003", "DTT004", "DTT007", "DTT008",
        "DTT009", "DTT010", "DTT011"}
    assert set(pitfalls.NOT_CARRIED) == {"DTT005", "DTT006"}


def test_tests_directory_is_exempt(tmp_path):
    (tmp_path / "tests").mkdir()
    p = tmp_path / "tests" / "fixture.py"
    p.write_text("f = open('events.jsonl', 'w')\n")
    assert pitfalls.check_file_rules(str(p), repo=str(tmp_path)) == []


def test_the_ports_tree_is_clean():
    """Every finding in the port's files is fixed or suppressed with a
    reason on its line; the walk covers the package (this module's own
    subpackage included)."""
    files = list(pitfalls.iter_py_files())
    assert any(f.endswith(os.path.join("analysis", "pitfalls.py"))
               for f in files)
    assert all(os.sep + PKG + os.sep in f for f in files)
    assert pitfalls.run_rules() == []


# -- DTT001 / DTT002 -------------------------------------------------------------


def test_dtt001_jsonl_writes(tmp_path):
    assert _rules_scoped(tmp_path, "f = open(path + '.jsonl', 'a')\n",
                         rel=f"{PKG}/serving", code="DTT001")
    assert not _rules_scoped(tmp_path, "f = open('x.jsonl')\n",
                             rel=f"{PKG}/serving", code="DTT001")
    d = tmp_path / PKG / "telemetry"
    d.mkdir(parents=True)
    (d / "events.py").write_text("f = open('e.jsonl', 'w')\n")
    assert pitfalls.check_file_rules(str(d / "events.py"),
                                     repo=str(tmp_path)) == []


def test_dtt002_silent_swallow(tmp_path):
    assert _rules(tmp_path, "try:\n    f()\nexcept Exception:\n    pass\n")
    assert not _rules(tmp_path, (
        "try:\n    f()\nexcept FileNotFoundError:\n    pass\n"
        "try:\n    f()\nexcept Exception:  # noqa: DTT002 — best effort\n"
        "    pass\n"))


# -- DTT003 — host sync in the step loop ---------------------------------------

_HOT = {"hot.py": {"train_step"}}


def test_dtt003_flags_torch_host_syncs(tmp_path, monkeypatch):
    monkeypatch.setattr(pitfalls, "DTT003_HOT_PATHS", _HOT)
    problems = _rules(tmp_path, (
        "def train_step(self, batch):\n"
        "    loss = metrics['loss'].item()\n"
        "    x = float(metrics['loss'])\n"
        "    y = metrics['loss'].cpu()\n"
        "    z = t.tolist()\n"
        "    w = t.numpy()\n"
        "    torch.cuda.synchronize()\n"
        "    ok = bool(torch.isfinite(x))\n"), name="hot.py")
    assert len([p for p in problems if "DTT003" in p]) == 7, problems


def test_dtt003_scoping(tmp_path, monkeypatch):
    monkeypatch.setattr(pitfalls, "DTT003_HOT_PATHS", _HOT)
    assert not _rules(tmp_path, "def helper(x):\n    return x.item()\n",
                      name="hot.py")
    assert not _rules(tmp_path, "def train_step(x):\n    return x.item()\n",
                      name="cold.py")
    assert not _rules(tmp_path, (
        "def train_step(x):\n    return float('nan')\n"), name="hot.py")
    assert not _rules(tmp_path, (
        "def train_step(x):\n"
        "    return float(x)  # noqa: DTT003 — epoch drain\n"),
        name="hot.py")


def test_dtt003_scopes_the_ports_trainer():
    assert pitfalls.DTT003_HOT_PATHS == {
        os.path.join(PKG, "train", "trainer.py"):
            {"train_step", "_run_epoch", "evaluate"}}


# -- DTT004 — collective under a host-local condition ---------------------------


def test_dtt004_flags_host_local_guards(tmp_path):
    problems = _rules(tmp_path, (
        "def f(self, x):\n"
        "    if self.rt.is_coordinator:\n"
        "        dist.all_reduce(x)\n"
        "def g(self, x, t0):\n"
        "    while time.perf_counter() - t0 < 5:\n"
        "        fsdp.mean_over_data(x, self.rt)\n"
        "def h(x):\n"
        "    if dist.get_rank() == 0:\n"
        "        dist.broadcast(x, src=0)\n"))
    hits = [p for p in problems if "DTT004" in p]
    assert len(hits) == 3, problems
    assert "is_coordinator" in hits[0]
    assert "perf_counter" in hits[1]
    assert "get_rank" in hits[2]


def test_dtt004_step_cadence_passes(tmp_path):
    assert not _rules(tmp_path, (
        "def f(self, x, global_step):\n"
        "    if global_step % self.every == 0:\n"
        "        dist.all_gather(parts, x)\n"
        "    if self.rt.process_count > 1:\n"
        "        dist.barrier()\n"
        "    if self.rt.is_coordinator:\n"
        "        dist.all_reduce(x)  # noqa: DTT004 — every rank is one\n"))


# -- DTT007 — hard-coded world size ---------------------------------------------


def test_dtt007_flags_world_size_literals(tmp_path):
    problems = _rules_scoped(tmp_path, (
        "def f(rt, host_dirs):\n"
        "    if rt.process_count == 2:\n"
        "        pass\n"
        "    if dist.get_world_size() >= 4:\n"
        "        pass\n"
        "    for h in range(4):\n"
        "        print(host_dirs[h])\n"), code="DTT007")
    assert len(problems) == 3, problems


def test_dtt007_world_agnostic_forms_pass(tmp_path):
    assert not _rules_scoped(tmp_path, (
        "def f(rt, host_dirs):\n"
        "    single = rt.process_count == 1\n"
        "    for h in range(rt.process_count):\n"
        "        print(host_dirs[h])\n"
        "    for attempt in range(3):\n"
        "        subprocess.run(cmd)\n"), code="DTT007")
    # serving/ and parallel/ are out of scope.
    assert not _rules_scoped(tmp_path, (
        "def f(rt):\n    return rt.process_count == 2\n"),
        rel=f"{PKG}/parallel", code="DTT007")


# -- DTT008 — placement literals -------------------------------------------------


def test_dtt008_flags_placement_literals_in_scope(tmp_path):
    problems = _rules_scoped(tmp_path, (
        "a = Placement(((0, ('fsdp',)),))\n"
        "b = Placement(splits=((1, ('tp',)),))\n"), rel=f"{PKG}/models",
        code="DTT008")
    assert len(problems) == 2, problems


def test_dtt008_derived_and_out_of_scope_pass(tmp_path):
    assert not _rules_scoped(tmp_path, (
        "a = Placement(splits)\n"
        "b = Placement(((dim, axes),))\n"
        "c = rt.group(('tp',))\n"), rel=f"{PKG}/train", code="DTT008")
    assert not _rules_scoped(tmp_path, (
        "a = Placement(((0, ('fsdp',)),))\n"), rel=f"{PKG}/parallel",
        code="DTT008")


# -- DTT009 — unseeded RNG in data/ ---------------------------------------------


def test_dtt009_flags_unseeded_rng_in_data(tmp_path):
    problems = _rules_scoped(tmp_path, (
        "import random\n"
        "import numpy as np\n"
        "import torch\n"
        "def f(rows, t):\n"
        "    a = torch.randperm(10)\n"
        "    b = torch.rand(4)\n"
        "    c = torch.randint(0, 5, (3,))\n"
        "    t.uniform_()\n"
        "    rng = np.random.default_rng()\n"
        "    x = np.random.rand(4)\n"
        "    random.shuffle(rows)\n"), rel=f"{PKG}/data", code="DTT009")
    assert len(problems) == 7, problems


def test_dtt009_seeded_and_scoped_forms_pass(tmp_path):
    assert not _rules_scoped(tmp_path, (
        "import numpy as np\n"
        "import torch\n"
        "def f(seed, g, t):\n"
        "    a = torch.randperm(10, generator=g)\n"
        "    b = torch.rand(4, generator=g)\n"
        "    t.uniform_(generator=g)\n"
        "    rng = np.random.default_rng([seed, 0])\n"
        "    x = rng.permutation(10)\n"), rel=f"{PKG}/data", code="DTT009")
    assert not _rules_scoped(tmp_path, "x = torch.rand(4)\n",
                             rel=f"{PKG}/models", code="DTT009")


# -- DTT010 / DTT011 — serving ----------------------------------------------------


def test_dtt010_flags_serving_syncs_outside_helpers(tmp_path):
    problems = _rules_scoped(tmp_path, (
        "def step(self):\n"
        "    a = self.x.item()\n"
        "    b = self.y.cpu()\n"
        "    c = self.z.tolist()\n"
        "    d = np.asarray(self.w)\n"
        "    torch.cuda.synchronize()\n"), rel=f"{PKG}/serving",
        code="DTT010")
    assert len(problems) == 5, problems


def test_dtt010_helpers_host_data_and_noqa_pass(tmp_path):
    d = tmp_path / PKG / "serving"
    d.mkdir(parents=True)
    (d / "engine.py").write_text(
        "class Engine:\n"
        "    def _fetch_host(self, *ts):\n"
        "        return tuple(t.cpu().numpy() for t in ts)\n"
        "    def step(self):\n"
        "        a = np.array(self.prompt)\n"
        "        b = jnp.asarray(a)\n"
        "        c = self.p.tolist()  # noqa: DTT010 — host data\n")
    assert pitfalls.check_file_rules(str(d / "engine.py"),
                                     repo=str(tmp_path)) == []


def test_dtt011_params_rebinding(tmp_path):
    d = tmp_path / PKG / "serving"
    d.mkdir(parents=True)
    (d / "engine.py").write_text(
        "class Engine:\n"
        "    def __init__(self, p):\n"
        "        self.params = p\n"
        "    def swap_weights(self, p):\n"
        "        self.params = p\n"
        "    def hack(self, p):\n"
        "        self.params = p\n"
        "        params = p\n")
    got = pitfalls.check_file_rules(str(d / "engine.py"), repo=str(tmp_path))
    assert [g.split(":")[1] for g in got if "DTT011" in g] == ["7"], got


# -- the ratchet ------------------------------------------------------------------


def _f(fp):
    return {"code": fp.split(":")[0], "target": "t",
            "fingerprint": fp, "message": fp, "detail": {}}


def test_ratchet_baseline_suppresses_old_fails_new(tmp_path):
    findings = [_f("SPMD003:t:a"), _f("SPMD002:t:b")]
    path = str(tmp_path / "base.json")
    baseline.write(findings, path=path)
    cmp = baseline.compare(findings, baseline.load(path))
    assert not cmp["new"] and not cmp["stale"]
    assert len(cmp["known"]) == 2
    cmp = baseline.compare(
        [findings[0], _f("SPMD003:t:c")], baseline.load(path))
    assert [f["fingerprint"] for f in cmp["new"]] == ["SPMD003:t:c"]
    assert cmp["stale"] == ["SPMD002:t:b"]


def test_ratchet_subset_run_scopes_stale_to_selected_targets(tmp_path):
    path = str(tmp_path / "base.json")
    baseline.write([_f("SPMD002:alpha:x"), _f("SPMD002:beta:y")],
                   path=path)
    cmp = baseline.compare([_f("SPMD002:alpha:x")],
                           baseline.load(path), targets=["alpha"])
    assert not cmp["new"] and not cmp["stale"]
    cmp = baseline.compare([], baseline.load(path), targets=["alpha"])
    assert cmp["stale"] == ["SPMD002:alpha:x"]


def test_ratchet_missing_baseline_is_empty(tmp_path):
    cmp = baseline.compare([_f("SPMD002:t:a")],
                           baseline.load(str(tmp_path / "nope.json")))
    assert len(cmp["new"]) == 1


def test_ratchet_schema_mismatch_raises(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": 99, "fingerprints": []}))
    with pytest.raises(ValueError, match="schema"):
        baseline.load(str(p))


def test_unattributed_collective_is_spmd002():
    """A recorded collective over a group that is none of the mesh's
    groupings (axes "unknown") is an SPMD002 finding, counted by shape."""
    t = targets.TARGETS["multichip_r05_tp_sp_fsdp"]
    row = {"kind": "all-reduce", "dtype": "f32", "shape": "4", "bytes": 16,
           "axes": "unknown"}
    rep = {"rows": [row, dict(row), dict(row, axes="tp")]}
    (f,) = audit._unattributed_findings(t, rep)
    assert f["fingerprint"] == \
        "SPMD002:multichip_r05_tp_sp_fsdp:all-reduce:f32[4]"
    assert f["detail"]["count"] == 2


def test_pinned_codes_fail_even_when_baselined():
    rec = {"target": "multichip_r05_tp_sp_fsdp", "title": "t",
           "devices": 8, "strategy": "tp", "mesh": {},
           "spmd_reshard_warnings": 1,
           "findings": [_f("SPMD001:multichip_r05_tp_sp_fsdp:x")],
           "findings_by_code": {"SPMD001": 1}, "collectives": {}}
    (violation,) = audit.pinned_violations(audit.assemble_doc([rec]))
    assert "SPMD001" in violation and "ZERO" in violation


# -- the targets and the CLI --------------------------------------------------------


def test_targets_are_jaxs():
    """The same names and pinned configurations as JAX's targets, so a
    finding ratchets under the same fingerprint in both packages."""
    jax_targets = pytest.importorskip(
        "distributed_training_tpu.analysis.targets")
    assert list(targets.TARGETS) == list(jax_targets.TARGETS)
    for name, t in targets.TARGETS.items():
        j = jax_targets.TARGETS[name]
        for field in ("devices", "strategy", "model", "model_kwargs",
                      "batch_size", "seq_len", "mesh_axes",
                      "train_overrides", "pin_zero", "kind",
                      "serving_plan", "serving_objective", "title"):
            assert getattr(t, field) == getattr(j, field), (name, field)


def test_cli_write_baseline_refuses_target_subset():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_training_tpu_torch.analysis",
         "--no-rules", "--targets", "single_chip_headline",
         "--write-baseline"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "full run" in out.stderr


def test_one_device_target_has_no_collectives_and_no_findings():
    """A one-device target (the headline's shape of target, at a tiny
    width) runs in this process: zero collectives, zero findings."""
    t = targets.AuditTarget(
        name="tiny_single", title="t", devices=1, strategy="ddp",
        model="transformer",
        model_kwargs=dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1,
                          max_seq_len=8, dtype="float32"),
        batch_size=2, seq_len=8, train_overrides=dict(dtype="float32"),
        pin_zero=("SPMD001",))
    rec = audit.audit_target(t, "cpu")
    assert rec["collectives"]["total_collectives"] == 0
    assert rec["collectives"]["mesh"] == {}
    assert rec["findings"] == [] and rec["spmd_reshard_warnings"] == 0


# -- the world of 8 -----------------------------------------------------------------

EIGHT = [n for n, t in targets.TARGETS.items() if t.devices == 8]


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
    """The 8-device targets' records (SPMD003 at a one-byte floor), from
    one world of 8, once per test run."""
    if "out" not in _WORLD:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # the run's directory, above the workers'
        _WORLD["out"] = _once(
            root, "analysis_world",
            lambda d: audit.audit_records(EIGHT, device="cpu",
                                          min_replicated_bytes=1))
    return {r["target"]: r for r in _WORLD["out"]}


def _jax_spmd003_findings(t) -> list[dict]:
    """JAX's SPMD003 findings on train target ``t`` at a one-byte floor
    (its abstract trainer; nothing compiled)."""
    pytest.importorskip("jax")
    from distributed_training_tpu.analysis import audit as jax_audit
    from distributed_training_tpu.analysis.compile import (
        build_abstract_trainer)

    trainer, _rt, _batch = build_abstract_trainer(
        t.devices, t.strategy, t.model, dict(t.model_kwargs), t.batch_size,
        t.seq_len, mesh_axes=dict(t.mesh_axes),
        train_overrides=dict(t.train_overrides))
    return jax_audit._replicated_param_findings(t, trainer, 1)


def _jax_spmd003(name: str) -> list[str]:
    from distributed_training_tpu.analysis import targets as jax_targets

    return sorted(f["fingerprint"] for f in
                  _jax_spmd003_findings(jax_targets.TARGETS[name]))


@pytest.mark.parametrize("name", ["multichip_r05_tp_sp_fsdp",
                                  "multichip_r06_planned"])
def test_spmd003_equals_jax_on_the_train_targets(world, name):
    got = sorted(f["fingerprint"] for f in world[name]["findings"]
                 if f["code"] == "SPMD003")
    assert got == _jax_spmd003(name)


@pytest.mark.parametrize("name,strategy,mesh", [
    ("multichip_r05_tp_sp_fsdp", "tp", None),
    ("multichip_r06_planned", "fsdp", {"fsdp": 8})])
def test_spmd003_equals_jax_where_leaves_stay_whole(name, strategy, mesh):
    """The same targets at the default ``min_shard_elems`` (4096), where
    the small leaves stay whole (r06 under the fsdp rules, its plan
    aside): the port's placements leave JAX's leaves replicated, under
    JAX's fingerprints, bytes and order."""
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.parallel.strategy import (
        get_strategy,
        layout,
    )
    from distributed_training_tpu_torch.runtime import MESH_AXES, MeshSpec
    from distributed_training_tpu_torch.train.optimizer import flatten

    t = targets.TARGETS[name]
    overrides = {k: v for k, v in t.train_overrides.items()
                 if k not in ("min_shard_elems", "sharding_plan")}
    t = dataclasses.replace(t, strategy=strategy,
                            mesh_axes=mesh or t.mesh_axes,
                            train_overrides=overrides)
    spec = MeshSpec(**{a: t.mesh_axes.get(a, 1) for a in MESH_AXES})
    kwargs = dict(t.model_kwargs)
    model = build_model(t.model, dtype=kwargs.pop("dtype"), device="cpu",
                        **kwargs)
    shapes = flatten(model.param_shapes())
    pls = layout(get_strategy(t.strategy, spec, min_shard_elems=4096),
                 shapes, flatten(model.logical_axes()))["params"]
    got = audit.replicated_param_findings(
        t, shapes, dict.fromkeys(shapes, 4), pls, spec.as_dict(), 1)
    want = _jax_spmd003_findings(t)
    assert len(got) >= 4
    assert [(f["fingerprint"], f["detail"]["bytes"]) for f in got] == [
        (f["fingerprint"], f["detail"]["bytes"]) for f in want]


def test_the_committed_baseline_is_exact(world):
    """At the gate's 1 MiB floor every finding is known and no baseline
    entry is stale; no SPMD001 (no partitioner) and no pin broken."""
    findings = [f for r in world.values() for f in r["findings"]
                if f["code"] != "SPMD003" or f["detail"]["bytes"] >= 2**20]
    cmp = baseline.compare(findings, baseline.load(), targets=EIGHT)
    assert not cmp["new"] and not cmp["stale"], cmp
    doc = audit.assemble_doc(list(world.values()))
    assert audit.pinned_violations(doc) == []
    assert doc["totals"]["by_code"].get("SPMD001", 0) == 0
    assert not [f for r in world.values() for f in r["findings"]
                if f["code"] == "SPMD002"]


def test_ring_sends_run_over_sp(world):
    """The ring's sends are collective-permutes over the sp group: JAX's
    three baselined SPMD002 permutes of this target do not appear."""
    rec = world["multichip_r05_tp_sp_fsdp"]
    assert rec["mesh"] == {"fsdp": 2, "sp": 2, "tp": 2}
    coll = rec["collectives"]
    assert coll["by_kind"]["collective-permute"]["count"] > 0
    assert "unknown" not in coll["by_axis"]
    assert {"fsdp", "sp", "tp"} <= set(coll["by_axis"])
    with open(os.path.join(REPO, "distributed_training_tpu", "analysis",
                           "spmd_baseline.json")) as f:
        jax_fps = json.load(f)["fingerprints"]
    assert len(jax_fps) == 3
    assert not set(jax_fps) & {f["fingerprint"] for f in rec["findings"]}


def test_document_shape(world):
    doc = audit.assemble_doc(list(world.values()))
    assert doc["schema"] == audit.SCHEMA == 1
    assert doc["codes"] == audit.CODES
    assert doc["totals"]["targets"] == len(EIGHT) == 4
    assert doc["totals"]["findings"] == sum(
        len(r["findings"]) for r in doc["targets"])
    planned = world["multichip_r06_planned"]["collectives"]
    with open(os.path.join(REPO, "conf", "plans",
                           "multichip_8dev.json")) as f:
        plan = json.load(f)
    assert planned["sharding_plan"]["name"] == plan["name"]
    assert planned["sharding_plan"]["fingerprint"] == plan["fingerprint"]
    assert planned["mesh"] == {"fsdp": 8}
    serving = world["serving_decode_planned"]["collectives"]
    assert serving["mesh"] == {"dp": 4, "tp": 2}
    assert "tp" in serving["by_axis"]
    cmp = baseline.compare(audit.all_findings(doc), baseline.load(),
                           targets=EIGHT)
    lines = "\n".join(audit.render_report(doc, cmp))
    assert "== multichip_r05_tp_sp_fsdp" in lines
    assert "collective-permute" in lines and "baseline:" in lines

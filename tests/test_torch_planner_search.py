"""The planner's search in the port (``parallel/planner.py``), held
against the JAX planner run live in the same test run.

The parity bar, for each of the six registered targets (the committed
plans under ``conf/plans/``), exact (``==`` on floats):

- ``as_dict()``, ``enumerate_candidates`` (keys, in order), every
  candidate's ``score_candidate`` record, ``rank_candidates`` (order and
  scores), ``calibration_provenance``;
- ``build_plan`` on the winner gives the committed plan's fingerprint
  (and JAX's), ``resolve_sharding_map`` gives JAX's map for the
  committed mesh;
- ``check_plan`` gives JAX's problem list: ``[]`` for five targets, and
  JAX's ranking-drift string for ``multichip_8dev_cpu`` for as long as
  JAX's own live ranking differs from its committed one (three scores a
  last bit apart; ROADMAP.md "Reference caveats").

JAX's side of each target is computed once a test run, whatever the
xdist workers (``_once``: a lock and a marker file in the run's base
temporary directory). Then the counterparts of JAX
``tests/test_planner.py``'s enumeration, HBM-infeasible, remat,
determinism, drifted-ranking, disqualification and all-dirty tests on
the port (the search with injected gates), ``hbm_plan_record`` against
JAX's for ``benchmarks/plan_memory.py``'s rows, the CLI, and the nominal
per-chip constants. The real gate runs in ``tests/test_torch_plan.py``'s
world (training) and ``tests/test_torch_serving_fsdp.py``'s (serving).
"""

import dataclasses
import fcntl
import importlib.util
import json
import math
import os
import pickle

import pytest

from distributed_training_tpu_torch.parallel import planner as port

pytest.importorskip("jax")

from distributed_training_tpu.parallel import planner as jaxp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = list(port.PLAN_TARGETS)
DRIFTED = "multichip_8dev_cpu"
TARGET = port.PLAN_TARGETS["multichip_8dev"]


def _once(root, name: str, make):
    """``make()``'s result, made once for every test process of the run
    that shares ``root`` (an exclusive lock around a marker file)."""
    done = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            with open(done, "wb") as f:
                pickle.dump(make(), f)
    with open(done, "rb") as f:
        return pickle.load(f)


def _jax_side(name: str) -> dict:
    """Everything the parity tests compare, from JAX's planner."""
    t = jaxp.PLAN_TARGETS[name]
    cands = jaxp.enumerate_candidates(t)
    ranked = jaxp.rank_candidates(t)
    records = {c.key: s for c, s in ranked}
    n_params = jaxp._n_params(t)
    for c in cands:
        if c.key not in records:
            records[c.key] = jaxp.score_candidate(t, c, n_params)
    lookup = jaxp.resolve_calibration(t)
    committed = jaxp.load_plan(name)
    return {
        "as_dict": t.as_dict(),
        "keys": [c.key for c in cands],
        "n_params": n_params,
        "records": records,
        "ranking": [(c.key, s["score"]) for c, s in ranked],
        "winner_fingerprint": jaxp.build_plan(t, ranked[0][0]).fingerprint(),
        "map": jaxp.resolve_sharding_map(t, committed.mesh),
        "calibration": jaxp.calibration_provenance(t, lookup.table,
                                                   lookup.note),
        "check": jaxp.check_plan(t),
    }


_JAX: dict = {}


@pytest.fixture
def jax_side(request, tmp_path_factory):
    name = request.node.callspec.params["name"]
    if name not in _JAX:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # the run's directory, above the workers'
        _JAX[name] = _once(root, f"jax_planner_{name}",
                           lambda: _jax_side(name))
    return _JAX[name]


# -- the parity bar ------------------------------------------------------------


@pytest.mark.parametrize("name", TARGETS)
def test_target_and_candidates_match_jax(name, jax_side):
    t = port.PLAN_TARGETS[name]
    assert t.as_dict() == jax_side["as_dict"]
    assert [c.key for c in port.enumerate_candidates(t)] == jax_side["keys"]
    assert port._n_params(t) == jax_side["n_params"]


@pytest.mark.parametrize("name", TARGETS)
def test_every_score_record_matches_jax(name, jax_side):
    t = port.PLAN_TARGETS[name]
    n_params = port._n_params(t)
    for c in port.enumerate_candidates(t):
        got = port.score_candidate(t, c, n_params)
        assert got == jax_side["records"][c.key], c.key


@pytest.mark.parametrize("name", TARGETS)
def test_ranking_matches_jax(name, jax_side):
    ranked = port.rank_candidates(port.PLAN_TARGETS[name])
    assert [(c.key, s["score"]) for c, s in ranked] == jax_side["ranking"]


@pytest.mark.parametrize("name", TARGETS)
def test_winner_fingerprint_and_map_match(name, jax_side):
    t = port.PLAN_TARGETS[name]
    committed = port.load_plan(name)
    winner = port.rank_candidates(t)[0][0]
    assert winner.key == committed.candidate_key
    plan = port.build_plan(t, winner)
    assert plan.fingerprint() == committed.fingerprint() == \
        jax_side["winner_fingerprint"]
    assert port.resolve_sharding_map(t, committed.mesh) == jax_side["map"]
    lookup = port.resolve_calibration(t)
    assert port.calibration_provenance(t, lookup.table, lookup.note) == \
        jax_side["calibration"]


@pytest.mark.parametrize("name", TARGETS)
def test_check_plan_matches_jax(name, jax_side):
    got = port.check_plan(port.PLAN_TARGETS[name])
    assert got == jax_side["check"]
    if name == DRIFTED and got:
        # JAX's own live ranking differs from its committed one in the
        # last bit of a few scores, and only there: the same keys in the
        # same order.
        recorded = port.load_plan(name).provenance["ranking"]
        live = jax_side["ranking"]
        assert [r["candidate"] for r in recorded] == [k for k, _ in live]
        gaps = [abs(s - r["score"]) / r["score"]
                for (_k, s), r in zip(live, recorded) if s != r["score"]]
        assert gaps and max(gaps) < 1e-15
        assert got == [f"{name}: stage-1 ranking changed (cost model or "
                       "search space drift) — re-run planner --write"]
    else:
        assert got == []


# -- JAX tests/test_planner.py's counterparts ----------------------------------


def test_enumeration_respects_devices_and_divisibility():
    cands = port.enumerate_candidates(TARGET)
    assert cands
    for c in cands:
        assert c.pp * c.dp * c.fsdp * c.sp * c.tp == TARGET.devices
        assert c.pp == 1
        assert TARGET.model_kwargs["n_kv_heads"] % c.tp == 0
        assert TARGET.seq_len % c.sp == 0
    assert not [c for c in cands if c.tp > 2]
    assert [c for c in cands if c.sp > 1]
    naive = dataclasses.replace(
        TARGET, model_kwargs={**TARGET.model_kwargs,
                              "attention_impl": "naive"})
    assert not [c for c in port.enumerate_candidates(naive) if c.sp > 1]
    pp = port.enumerate_candidates(dataclasses.replace(TARGET, allow_pp=True))
    assert 2 in {c.pp for c in pp}


def test_hbm_infeasible_candidates_rejected():
    big = port.PlanTarget(
        name="big", devices=8,
        model_kwargs=dict(vocab_size=50257, d_model=2048, n_heads=16,
                          n_layers=24, max_seq_len=2048, dtype="bfloat16"),
        seq_len=2048, chip="v5e", batch_candidates=(16,),
        remat_candidates=("none",))
    cand = port.Candidate(1, 8, 1, 1, 1, "none", 16)
    rec = port.score_candidate(big, cand)
    assert (rec["feasible"], rec["reason"]) == (False, "hbm")
    assert cand.key not in [c.key for c, _s in port.rank_candidates(big)]


def test_score_prefers_no_remat_when_memory_allows():
    n_params = port._n_params(TARGET)
    scores = {r: port.score_candidate(
        TARGET, port.Candidate(1, 1, 8, 1, 1, r, 8), n_params)
        for r in port.REMAT_POLICIES}
    assert all(s["feasible"] for s in scores.values())
    assert (scores["none"]["score"] >= scores["mlp_pre"]["score"]
            >= scores["mlp"]["score"])


def test_ranking_is_deterministic():
    a = [(c.key, s["score"]) for c, s in port.rank_candidates(TARGET)]
    b = [(c.key, s["score"]) for c, s in port.rank_candidates(TARGET)]
    assert a == b and a
    assert all(math.isfinite(s) for _k, s in a)


def test_check_plan_flags_drifted_ranking(monkeypatch):
    doc = port.load_plan(TARGET.name).to_doc()
    doc["provenance"] = dict(doc["provenance"])
    doc["provenance"]["ranking"] = doc["provenance"]["ranking"][:1]
    doc.pop("integrity", None)
    monkeypatch.setattr(
        port, "load_plan",
        lambda _n: port.Plan.from_doc(json.loads(json.dumps(doc))))
    problems = port.check_plan(TARGET)
    assert problems and "ranking changed" in problems[0]


def _evidence(warnings=0, agree=True):
    return {"spmd_reshard_warnings": warnings,
            "reshard_ops": ["gather"] if warnings else [],
            "collective_bytes_per_step": 1, "total_collectives": 1,
            "gate": {"agree": agree}}


@pytest.mark.parametrize("how", ["reshard", "gate"])
def test_failing_candidate_disqualified(how):
    """A gate that fails the top candidate (JAX's reshard warnings, or
    the port's run gate disagreeing): the search records it and settles
    on the next one."""
    ranked = port.rank_candidates(TARGET)
    dirty = ranked[0][0].key
    calls = []

    def fake_verify(_target, plan):
        calls.append(plan.candidate_key)
        bad = plan.candidate_key == dirty
        return _evidence(2 if bad and how == "reshard" else 0,
                         not (bad and how == "gate"))

    plan = port.plan_search(TARGET, verify_fn=fake_verify)
    assert calls == [dirty, ranked[1][0].key]
    assert plan.candidate_key == ranked[1][0].key
    assert plan.provenance["rank"] == 1
    dq = plan.provenance["disqualified"]
    assert [d["candidate"] for d in dq] == [dirty]
    assert dq[0]["spmd_reshard_warnings"] == (2 if how == "reshard" else 0)
    assert plan.provenance["calibration"]["source"] == "nominal"


def test_all_dirty_candidates_raise():
    calls = []

    def always_dirty(_t, p):
        calls.append(p.candidate_key)
        return _evidence(agree=False)

    with pytest.raises(port.PlanError, match="involuntary-reshard"):
        port.plan_search(TARGET, verify_fn=always_dirty)
    assert len(calls) == TARGET.max_compiles


def test_no_feasible_candidate_raises():
    tight = dataclasses.replace(TARGET, hbm_gib=1e-9)
    with pytest.raises(port.PlanError, match="no feasible candidate"):
        port.plan_search(tight, verify_fn=lambda t, p: _evidence())


def _plan_memory_rows():
    spec = importlib.util.spec_from_file_location(
        "plan_memory", os.path.join(REPO, "benchmarks", "plan_memory.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PLANS


@pytest.mark.parametrize("row", _plan_memory_rows(), ids=lambda r: r[0])
def test_hbm_plan_record_matches_jax(row):
    assert port.hbm_plan_record(*row) == jaxp.hbm_plan_record(*row)


# -- the nominal constants and the CLI -----------------------------------------


def test_nominal_constants():
    """The committed targets' chips take JAX's values; the card takes the
    port's peak (the card has no interconnect row: the one-size
    fallback)."""
    from distributed_training_tpu.utils.metrics import peak_flops_per_chip

    from distributed_training_tpu_torch.utils.metrics import PEAK_FLOPS
    for chip in ("v5e", "cpu", "TPU v5 lite", "v4"):
        assert port.nominal_peak_flops_per_s(chip) == \
            peak_flops_per_chip(chip)
        assert port.nominal_ici_bytes_per_s(chip) == \
            jaxp.nominal_ici_bytes_per_s(chip)
    h100 = "nvidia h100 80gb hbm3"
    assert port.nominal_peak_flops_per_s(h100) == PEAK_FLOPS["h100"]
    assert port.nominal_ici_bytes_per_s(h100) == port.ICI_BYTES_PER_S
    assert port.hbm_budget_gib(port.PlanTarget(
        name="h", devices=1, model_kwargs={}, seq_len=8, chip=h100)) == \
        80.0 * 0.85


def test_card_target_scores_on_the_nominal_roofline():
    """gpt2_125m at full width on one card: 12 candidates, all feasible,
    no comms; the scores tie over batch and the largest batch wins."""
    from distributed_training_tpu_torch.models.transformer import PRESETS
    t = port.PlanTarget(name="gpt2_125m_h100", devices=1,
                        model_kwargs=dict(PRESETS["gpt2_125m"],
                                          dtype="bfloat16"),
                        seq_len=1024, chip="nvidia h100 80gb hbm3")
    cands = port.enumerate_candidates(t)
    ranked = port.rank_candidates(t)
    assert len(cands) == len(ranked) == 12
    assert ranked[0][0].key == "pp1.dp1.fsdp1.sp1.tp1/none/b8"
    rec = ranked[0][1]
    assert rec["comms_s"] == 0 and rec["comms_bytes_by_kind"] == {}
    assert rec["calibrated"] is False
    assert rec["hbm_gib"] == pytest.approx(8.44, abs=0.01)


def test_cli_check_and_list(capsys):
    assert port.main(["--targets", "serving_4dev_cpu_decode", "--check"]) == 0
    assert "serving_4dev_cpu_decode: OK" in capsys.readouterr().out
    assert port.main(["--targets", "serving_4dev_cpu_prefill"]) == 0
    out = capsys.readouterr().out
    assert "5 candidates, 5 feasible; top 5:" in out


def test_cli_write_refuses_the_committed_plans(tmp_path, capsys):
    with pytest.raises(SystemExit):
        port.main(["--write", "--targets", "serving_4dev_cpu_decode"])
    with pytest.raises(SystemExit):
        port.main(["--write", "--out", port.PLANS_DIR])
    assert "JAX planner's committed plans" in capsys.readouterr().err

"""The port's calibration tables (``calibration/table.py``) held against
the JAX package's, value for value.

- ``conf/calibration/cpu.json`` loads in both with one fingerprint, the
  same curves and the same fitted summary, and round-trips through the
  port's ``save_table``;
- ``chip_slug`` maps a list of device kinds (the card's among them) as
  JAX's does;
- ``collective_seconds`` and ``achievable_flops_per_s`` give JAX's floats
  exactly (``==``), for every collective kind, at points below, on,
  between and above the measured ones;
- ``lookup_for_chip`` gives JAX's status and table for the committed
  chip, a chip with no table (the card), a tampered copy and a truncated
  one.
"""

import json
import shutil

import pytest

from distributed_training_tpu_torch import calibration as port_cal

pytest.importorskip("jax")

from distributed_training_tpu import calibration as jax_cal  # noqa: E402

KINDS = ["cpu", "TPU v5 lite", "TPU v5litepod", "v5e", "TPU v5p", "TPU v4",
         "TPU v6 lite", "v6e", "NVIDIA H100 80GB HBM3", "nvidia h100 80gb hbm3",
         "NVIDIA H200", "Some Odd-Chip/2"]


def _tables():
    path = port_cal.table_path("cpu")
    return port_cal.load_table(path), jax_cal.load_table(path)


def test_exports_match_jax():
    assert port_cal.COLLECTIVE_KINDS == jax_cal.COLLECTIVE_KINDS
    from distributed_training_tpu.calibration import table as jax_table
    assert port_cal.SCHEMA == jax_table.SCHEMA
    assert port_cal.CALIB_DIR == jax_table.CALIB_DIR


def test_committed_table_loads_with_jax_fingerprint(tmp_path):
    got, want = _tables()
    assert got.fingerprint() == want.fingerprint() == "01189c61f99e7b74"
    assert got.to_doc() == want.to_doc()
    assert got.fitted_summary() == want.fitted_summary()
    path = port_cal.save_table(got, str(tmp_path / "cpu.json"))
    assert jax_cal.load_table(path).fingerprint() == want.fingerprint()


@pytest.mark.parametrize("kind", KINDS)
def test_chip_slug_matches_jax(kind):
    assert port_cal.chip_slug(kind) == jax_cal.chip_slug(kind)
    assert port_cal.table_path(kind) == jax_cal.table_path(kind)


def test_card_slug():
    assert port_cal.chip_slug("NVIDIA H100 80GB HBM3") == \
        "nvidia_h100_80gb_hbm3"


def _probe_points(xs: list) -> list:
    """Below, on, between and above the measured x values."""
    pts = [0.0, 1.0, xs[0] / 2, xs[-1] * 3.7, xs[-1] + 1.0]
    for a, b in zip(xs, xs[1:]):
        pts += [a, b, (a + b) / 2, a + (b - a) / 3, b - 1.0]
    return pts


@pytest.mark.parametrize("kind", list(port_cal.COLLECTIVE_KINDS))
def test_collective_seconds_bit_for_bit(kind):
    got, want = _tables()
    xs = [b for b, _t in want.collectives[kind]]
    for x in _probe_points(xs):
        assert got.collective_seconds(kind, x) == \
            want.collective_seconds(kind, x), x


def test_achievable_flops_bit_for_bit():
    got, want = _tables()
    xs = [f for f, _r in want.matmul]
    for x in _probe_points(xs):
        assert got.achievable_flops_per_s(x) == \
            want.achievable_flops_per_s(x), x


def test_degenerate_curves_match_jax():
    """A single-point tail and a non-monotonic one take the aggregate-rate
    fallback; an empty curve raises."""
    doc = dict(device_kind="x", platform="cpu", n_devices=2,
               collectives={"all-gather": [[100.0, 1e-3]],
                            "all-reduce": [[100.0, 2e-3], [200.0, 1e-3]]},
               matmul=[[10.0, 5.0], [10.0, 7.0]])
    got, want = port_cal.CalibrationTable(**doc), jax_cal.CalibrationTable(
        **doc)
    assert got.fingerprint() == want.fingerprint()
    for kind in ("all-gather", "all-reduce"):
        for x in (50.0, 100.0, 150.0, 1000.0):
            assert got.collective_seconds(kind, x) == \
                want.collective_seconds(kind, x)
    for x in (1.0, 10.0, 20.0):
        assert got.achievable_flops_per_s(x) == want.achievable_flops_per_s(x)
    with pytest.raises(port_cal.CalibrationError, match="ppermute"):
        got.collective_seconds("ppermute", 1.0)


def _tamper(path):
    with open(path) as f:
        doc = json.load(f)
    doc["matmul"][0][1] *= 2
    with open(path, "w") as f:
        json.dump(doc, f)


def _truncate(path):
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[:len(text) // 2])


@pytest.mark.parametrize("damage", [None, _tamper, _truncate, "missing"],
                         ids=["intact", "tampered", "truncated", "missing"])
def test_lookup_status_matches_jax(damage, tmp_path):
    d = tmp_path / "calib"
    d.mkdir()
    if damage != "missing":
        shutil.copy(port_cal.table_path("cpu"), d / "cpu.json")
        if damage is not None:
            damage(str(d / "cpu.json"))
    got = port_cal.lookup_for_chip("cpu", str(d))
    want = jax_cal.lookup_for_chip("cpu", str(d))
    assert got.status == want.status == {
        None: "measured", _tamper: "unusable", _truncate: "unusable",
        "missing": "missing"}[damage]
    assert (got.table is None) == (want.table is None)
    if got.table is not None:
        assert got.table.fingerprint() == want.table.fingerprint()


@pytest.mark.parametrize("chip", ["cpu", "v5e", "nvidia h100 80gb hbm3"])
def test_committed_lookup_matches_jax(chip):
    got, want = port_cal.lookup_for_chip(chip), jax_cal.lookup_for_chip(chip)
    assert (got.status, got.note) == (want.status, want.note)
    assert got.status == ("measured" if chip == "cpu" else "missing")

"""Checkpoint integrity of the port against the JAX package.

- ``resilience/integrity.py``: the port's and JAX's ``write_manifest`` on
  the same directory give the same manifest (all but its time stamp);
  ``verify_manifest`` gives the same verdicts on the same damage (no
  manifest, an unreadable one, a missing, an extra, a resized and an
  altered file); ``quarantine_step`` renames, survives name collisions
  and emits ``ckpt_quarantined``; the step scan skips what is not a
  committed step.
- ``FaultInjector.on_checkpoint_saved``: ``corrupt_ckpt`` damages the
  newest manifested step and stays armed while none exists, as JAX's.
- ``checkpoint/manager.py``: every committed step (sync or async) has a
  manifest; ``restore_latest`` quarantines a damaged newest step and
  falls back, starts fresh when every step is damaged, and quarantines
  a step that fails to load; an async save that the caller updates
  right after restores the bits it saved; the injector only ever sees
  manifested steps (its damage is always detectable); the context
  manager drains a save in flight.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.resilience import faults as port_faults
from distributed_training_tpu_torch.resilience import integrity as port_int
from distributed_training_tpu_torch.telemetry import events as port_events

jax = pytest.importorskip("jax")

from distributed_training_tpu.resilience import faults as jax_faults  # noqa: E402
from distributed_training_tpu.resilience import integrity as jax_int  # noqa: E402


def _step_dir(root, step=8, payload=b"x" * 4096):
    d = root / str(step)
    (d / "state").mkdir(parents=True)
    (d / "state" / "arrays.bin").write_bytes(payload)
    (d / "meta.json").write_text('{"epoch": 1}')
    return str(d)


def _manifest(step_dir):
    with open(os.path.join(step_dir, port_int.MANIFEST_NAME)) as f:
        m = json.load(f)
    m.pop("t")
    return m


def test_manifest_equals_jax(tmp_path):
    d = _step_dir(tmp_path)
    jax_int.write_manifest(d)
    want = _manifest(d)
    port_int.write_manifest(d)
    assert _manifest(d) == want
    assert set(want["files"]) == {"meta.json", "state/arrays.bin"}
    assert port_int.MANIFEST_NAME == jax_int.MANIFEST_NAME
    assert port_int.MANIFEST_SCHEMA == jax_int.MANIFEST_SCHEMA


def _damage(kind, d):
    path = os.path.join(d, "state", "arrays.bin")
    if kind == "altered":
        port_faults.corrupt_step_dir(d)
    elif kind == "resized":
        with open(path, "ab") as f:
            f.write(b"y")
    elif kind == "missing":
        os.remove(path)
    elif kind == "extra":
        with open(os.path.join(d, "stray.bin"), "wb") as f:
            f.write(b"z")
    elif kind == "unreadable":
        with open(os.path.join(d, port_int.MANIFEST_NAME), "w") as f:
            f.write("{not json")
    elif kind == "absent":
        os.remove(os.path.join(d, port_int.MANIFEST_NAME))


@pytest.mark.parametrize("kind", ["none", "altered", "resized", "missing",
                                  "extra", "unreadable", "absent"])
def test_verify_verdicts_equal_jax(tmp_path, kind):
    d = _step_dir(tmp_path)
    port_int.write_manifest(d)
    _damage(kind, d)
    got = port_int.verify_manifest(d)
    assert got == jax_int.verify_manifest(d)
    if kind == "none":
        assert got == (True, [])
    elif kind == "absent":
        assert got == (False, [])
    else:
        assert got[1], kind


def test_quarantine_collisions_and_step_scan(tmp_path):
    seen = []
    tel = port_events.install(port_events.Telemetry(
        events_jsonl=str(tmp_path / "events.jsonl")))
    tel.add_observer(seen.append)
    try:
        for n in range(3):
            _step_dir(tmp_path, step=8)
            assert port_int.checkpoint_steps_on_disk(str(tmp_path)) == [8]
            dst = port_int.quarantine_step(str(tmp_path), 8,
                                           problems=[f"p{n}"])
            suffix = "" if n == 0 else f".{n + 1}"
            assert dst == str(tmp_path / f"step_8.corrupt{suffix}")
        assert port_int.quarantine_step(str(tmp_path), 8) is None
    finally:
        port_events.uninstall()
        tel.close()
    assert [e["problems"] for e in seen
            if e["kind"] == "ckpt_quarantined"] == [["p0"], ["p1"], ["p2"]]
    scan = tmp_path / "scan"
    (scan / ".tmp-12").mkdir(parents=True)
    (scan / "step_3.corrupt").mkdir()
    _step_dir(scan, step=4)
    for mod in (port_int, jax_int):
        assert mod.checkpoint_steps_on_disk(str(scan)) == [4]
        assert mod.latest_step_on_disk(str(scan)) == 4
        assert mod.checkpoint_steps_on_disk(str(tmp_path / "nope")) == []


def test_corrupt_ckpt_targets_the_newest_manifested_step_as_jax(tmp_path):
    for name, fmod, imod in (("jax", jax_faults, jax_int),
                             ("port", port_faults, port_int)):
        root = tmp_path / name
        unmanifested = _step_dir(root, step=16)
        inj = fmod.FaultInjector("corrupt_ckpt@5", ckpt_dir=str(root))
        inj.on_checkpoint_saved(16)
        assert inj.fired == set()
        manifested = _step_dir(root, step=8)
        imod.write_manifest(manifested)
        inj.on_checkpoint_saved(4)
        assert inj.fired == set()  # below the fault's step
        inj.on_checkpoint_saved(24)
        assert inj.fired == {"corrupt_ckpt@5"}
        assert imod.verify_manifest(manifested)[1]
        assert imod.verify_manifest(unmanifested) == (False, [])


def _state(seed=0, step=3):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(64, 32, generator=g),
                       "b": {"x": torch.randn(32, generator=g)}},
            "opt_state": {"count": step,
                          "mu": {"w": torch.randn(64, 32, generator=g)}},
            "step": step}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("async_save", [False, True])
def test_saves_are_manifested_and_fall_back_past_damage(tmp_path,
                                                        async_save):
    ckdir = str(tmp_path / "ckpt")
    states = {s: _state(seed=s, step=s) for s in (2, 4, 6)}
    with Checkpointer(ckdir, async_save=async_save) as ck:
        for s, st in states.items():
            assert ck.save(s, st, meta={"epoch": s})
    for s in states:
        d = os.path.join(ckdir, str(s))
        assert port_int.verify_manifest(d) == (True, [])
        assert sorted(os.listdir(d)) == ["manifest.dtt.json", "meta.json",
                                         "state.pt"]
    port_faults.corrupt_step_dir(os.path.join(ckdir, "6"))
    got, meta = Checkpointer(ckdir).restore_latest("cpu")
    assert meta == {"epoch": 4}
    _equal(got, states[4])
    assert port_int.checkpoint_steps_on_disk(ckdir) == [2, 4]
    assert os.path.isdir(os.path.join(ckdir, "step_6.corrupt"))
    # A step that fails to load (no manifest to condemn it) is
    # quarantined too.
    os.remove(os.path.join(ckdir, "4", port_int.MANIFEST_NAME))
    with open(os.path.join(ckdir, "4", "state.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    got, meta = Checkpointer(ckdir).restore_latest("cpu")
    _equal(got, states[2])
    port_faults.corrupt_step_dir(os.path.join(ckdir, "2"))
    assert Checkpointer(ckdir).restore_latest("cpu") is None
    assert port_int.checkpoint_steps_on_disk(ckdir) == []


def test_async_save_racing_an_update_restores_the_saved_bits(tmp_path):
    st = _state()
    want = {"params": {"w": st["params"]["w"].clone(),
                       "b": {"x": st["params"]["b"]["x"].clone()}},
            "opt_state": {"count": 3,
                          "mu": {"w": st["opt_state"]["mu"]["w"].clone()}},
            "step": 3}
    ckdir = str(tmp_path / "ckpt")
    with Checkpointer(ckdir, async_save=True) as ck:
        assert ck.save(3, st)
        ck.fence()
        # The update right after the save, in place, as the optimizer's.
        st["params"]["w"].add_(1.0)
        st["params"]["b"]["x"].mul_(-2.0)
        st["opt_state"]["mu"]["w"].zero_()
        assert ck.save(4, st)  # reuses the host buffers of step 3's copy
    step3 = torch.load(os.path.join(ckdir, "3", "state.pt"),
                       weights_only=True)
    _equal(step3, want)


def test_async_corruption_is_always_detectable(tmp_path):
    """The injector sees a step only once it is manifested, so the
    damage it makes is the damage verification catches (JAX's
    ordering: the second save's drain manifests step 1, then the fault
    fires on it)."""
    inj = port_faults.FaultInjector("corrupt_ckpt@1",
                                    ledger_path=str(tmp_path / "led.json"))
    with Checkpointer(str(tmp_path / "ckpt"), async_save=True,
                      fault_injector=inj) as ck:
        assert ck.save(1, _state(step=1), meta={"epoch": 0})
        assert inj.fired == set()
        assert ck.save(2, _state(step=2), meta={"epoch": 1})
        assert inj.fired == {"corrupt_ckpt@1"}
    d1, d2 = (str(tmp_path / "ckpt" / s) for s in ("1", "2"))
    assert port_int.verify_manifest(d1)[1]
    assert port_int.verify_manifest(d2) == (True, [])
    assert ck.last_manifest["step"] == 2 and ck.last_manifest["bytes"] > 0


def test_context_manager_drains_an_async_save(tmp_path):
    with Checkpointer(str(tmp_path / "ckpt"), async_save=True) as ck:
        assert ck.save(1, _state(), meta={"epoch": 0})
    d = str(tmp_path / "ckpt" / "1")
    assert port_int.verify_manifest(d) == (True, [])
    assert not [n for n in os.listdir(tmp_path / "ckpt")
                if n.startswith(".tmp")]

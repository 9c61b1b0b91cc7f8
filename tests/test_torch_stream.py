"""The port's exactly-once streaming pipeline (``data/stream.py``) against
the JAX package's, on ``tests/test_stream.py``'s sources.

- world 1: the port's batches equal JAX's ``StreamingDataLoader``'s byte
  for byte over two epochs;
- a save whose carry lands inside a document, then a resume on a fresh
  loader: the concatenated stream equals JAX's uninterrupted one, and
  the port's ``state_dict()`` equals JAX's at the save (``to_dict()``
  plus the mixture evidence);
- a world of 4 that shrinks to 3 mid-epoch at a global batch of 12: the
  shards' rows, joined per step, equal JAX's world-1 stream, each sample
  once;
- ``data_corrupt@k:skip`` skips and records the same ``(source,
  sample_id)`` on both sides, and the tokens after it stay equal;
- ``retry_transient``'s rollback: a transient error mid-batch retries
  from the pre-batch state, so the batches equal an unfaulted run's;
- ``state_dict``/``load_state_dict`` refuse a changed global batch and
  the state refuses reordered sources, as JAX's do.

The port's loader takes a duck-typed runtime (``device``,
``data_shard_count``, ``data_shard_index``): a world of N is N loaders,
one per data shard, stepped together.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.data import datasets as port_ds
from distributed_training_tpu_torch.data import stream as port_stream
from distributed_training_tpu_torch.resilience import faults as port_faults

jax = pytest.importorskip("jax")

from distributed_training_tpu.data import datasets as jax_ds  # noqa: E402
from distributed_training_tpu.data import stream as jax_stream  # noqa: E402
from distributed_training_tpu.resilience import faults as jax_faults  # noqa: E402
from distributed_training_tpu.runtime import fake_cpu_runtime  # noqa: E402


def _sources(side, vocab=50):
    """``tests/test_stream.py``'s ``make_sources`` on either side."""
    ds, st = (jax_ds, jax_stream) if side == "jax" else (port_ds,
                                                         port_stream)
    return [
        st.StreamSource("lm", ds.SyntheticLMDataset(
            size=64, seq_len=16, vocab_size=vocab, seed=1), weight=2.0),
        st.StreamSource("doc", ds.SyntheticDocDataset(
            size=48, min_len=5, max_len=30, vocab_size=vocab, seed=2),
            weight=1.0),
    ]


def _jax_loader(batch_size, **kw):
    return jax_stream.StreamingDataLoader(
        _sources("jax"), fake_cpu_runtime(1), batch_size=batch_size,
        pack_len=16, seed=7, **kw)


def _port_world(world, global_batch, **kw):
    """One port loader per data shard of a world of ``world``."""
    out = []
    for k in range(world):
        rt = types.SimpleNamespace(device=torch.device("cpu"),
                                   data_shard_count=world,
                                   data_shard_index=k,
                                   seq_shard_count=1, seq_shard_index=0)
        out.append(port_stream.StreamingDataLoader(
            _sources("port"), rt, batch_size=global_batch // world,
            pack_len=16, seed=7, **kw))
    return out


def _jax_batches(loader, epochs, steps=None):
    out = []
    for e in epochs:
        it = loader.epoch(e)
        for b in it:
            out.append(np.asarray(b["tokens"]))
            if steps is not None and len(out) == steps:
                it.close()
                return out
    return out


def _port_batches(loaders, epochs, steps=None):
    """Each step's global batch: the shards' rows, shard-major."""
    out = []
    for e in epochs:
        its = [ld.epoch(e) for ld in loaders]
        for parts in zip(*its):
            out.append(np.concatenate([p["tokens"].numpy() for p in parts]))
            if steps is not None and len(out) == steps:
                for it in its:
                    it.close()
                return out
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_world1_batches_equal_jax():
    want = _jax_batches(_jax_loader(4), [0, 1])
    port = _port_world(1, 4)
    got = _port_batches(port, [0, 1])
    assert port[0].steps_per_epoch == _jax_loader(4).steps_per_epoch
    _assert_same(got, want)


def test_resume_mid_document_equals_uninterrupted_jax():
    jl = _jax_loader(2)
    want = _jax_batches(jl, [0, 1])
    spe = jl.steps_per_epoch
    # Cut where the carry points inside a document.
    cut = None
    for k in range(3, spe - 1):
        probe = _port_world(1, 2)
        _port_batches(probe, [0], steps=k)
        if probe[0].state.carry is not None:
            cut = k
            break
    assert cut is not None, "no block boundary inside a document"
    first = _port_world(1, 2)
    head = _port_batches(first, [0], steps=cut)
    saved = json.loads(json.dumps(first[0].state_dict()))
    assert saved["carry"]["offset"] > 0 and saved["mid_epoch"]
    # JAX's loader at the same cut has the same state.
    jcut = _jax_loader(2)
    _jax_batches(jcut, [0], steps=cut)
    assert saved == json.loads(json.dumps(jcut.state_dict()))
    assert saved["samples_consumed"] == cut * 2
    resumed = _port_world(1, 2)
    resumed[0].load_state_dict(saved)
    assert resumed[0].resume_epoch == 0
    tail = _port_batches(resumed, [0, 1])
    _assert_same(head + tail, want)


def test_world_4_to_3_mid_epoch_is_exactly_once():
    want = _jax_batches(_jax_loader(12), [0, 1])
    before = _port_world(4, 12)
    cut = 3
    head = _port_batches(before, [0], steps=cut)
    states = [ld.state_dict() for ld in before]
    assert all(s == states[0] for s in states)
    after = _port_world(3, 12)
    for ld in after:
        ld.load_state_dict(json.loads(json.dumps(states[0])))
    tail = _port_batches(after, [0, 1])
    got = head + tail
    _assert_same(got, want)
    rows = [tuple(r) for b in got for r in b]
    assert len(rows) == len(want) * 12


@pytest.mark.parametrize("plan", ["data_corrupt@3:source=doc:skip",
                                  "data_corrupt@2:skip"])
def test_data_corrupt_skip_records_the_same_sample(plan, monkeypatch):
    out = {}
    for side, fmod, smod in (("jax", jax_faults, jax_stream),
                             ("port", port_faults, port_stream)):
        inj = fmod.FaultInjector(plan)
        records = []
        orig = smod.telemetry.event

        def grab(name, _orig=orig, _records=records, **fields):
            if name == "data_skip":
                _records.append((fields["source"], fields["sample_id"],
                                 fields["step"]))
            return _orig(name, **fields)

        monkeypatch.setattr(smod.telemetry, "event", grab)
        if side == "jax":
            ld = _jax_loader(2, fault_injector=inj)
            toks = _jax_batches(ld, [0])
        else:
            ld = _port_world(1, 2, fault_injector=inj)[0]
            toks = _port_batches([ld], [0])
        out[side] = (records, toks, ld.state.skipped)
    assert out["port"][0] == out["jax"][0] and len(out["jax"][0]) == 1
    assert out["port"][2] == out["jax"][2] == 1
    _assert_same(out["port"][1], out["jax"][1])


def test_transient_error_rolls_back_to_the_pre_batch_state():
    clean = _port_batches(_port_world(1, 2), [0])
    inj = port_faults.FaultInjector("data_error@3")
    got = _port_batches(_port_world(1, 2, fault_injector=inj), [0])
    assert inj.fired == {"data_error@3"}
    _assert_same(got, clean)


def test_refusals_match_jax():
    port = _port_world(1, 4)[0]
    d = port.state_dict()
    other = _port_world(2, 4)[0]  # global batch 4, per-shard 2: same
    other.load_state_dict(d)
    bigger = _port_world(1, 8)[0]
    with pytest.raises(port_stream.StreamStateError, match="global batch"):
        bigger.load_state_dict(d)
    jd = _jax_loader(4).state_dict()
    flipped = dict(jd, sources=dict(reversed(list(jd["sources"].items()))))
    for mod in (jax_stream, port_stream):
        with pytest.raises(mod.StreamStateError, match="order"):
            mod.StreamState.from_dict(flipped, 7, ["lm", "doc"])
    assert port_stream.MAX_CONSECUTIVE_SKIPS == \
        jax_stream.MAX_CONSECUTIVE_SKIPS
    assert port_stream.STATE_SCHEMA == jax_stream.STATE_SCHEMA


def test_build_stream_sources_and_probe():
    spec = {"text": {"dataset": "synthetic_doc", "weight": 3,
                     "vocab_size": 256, "min_len": 5, "max_len": 40},
            "docs": {"dataset": "synthetic_lm", "seq_len": 16,
                     "vocab_size": 256}}
    got = port_stream.build_stream_sources(spec, defaults={"size": 32,
                                                          "seed": 0})
    want = jax_stream.build_stream_sources(spec, defaults={"size": 32,
                                                          "seed": 0})
    assert [(s.name, s.weight, len(s.dataset)) for s in got] == \
        [(s.name, s.weight, len(s.dataset)) for s in want]
    for g, w in zip(got, want):
        for i in range(3):
            np.testing.assert_array_equal(port_stream._doc_tokens(g.dataset, i),
                                          jax_stream._doc_tokens(w.dataset, i))
    ld = port_stream.StreamingDataLoader(
        got, types.SimpleNamespace(device=torch.device("cpu"),
                                   data_shard_count=1, data_shard_index=0,
                                   seq_shard_count=1, seq_shard_index=0),
        batch_size=2, pack_len=16)
    assert ld.dataset.vocab_size == 256 and ld.dataset.seq_len == 16
    assert ld.dataset.batch(np.array([0]))["tokens"].shape == (1, 17)
    assert ld.target_mixture() == {"text": 0.75, "docs": 0.25}

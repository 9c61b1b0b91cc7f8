"""The port's config and data layers held against the JAX package's.

- ``load_config`` resolves the same ``conf/`` tree to the same dict;
- the synthetic LM corpus is bit-identical;
- the loader's index stream (batches, epochs, a mid-epoch resume) is
  identical for the same seed.

Exact equality throughout: no arithmetic differs.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.data import datasets as port_ds
from distributed_training_tpu_torch.data import loader as port_loader
from distributed_training_tpu_torch.runtime import (
    MeshSpecError,
    Runtime,
    initialize_runtime,
)

jax = pytest.importorskip("jax")

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu.data import datasets as jax_ds  # noqa: E402
from distributed_training_tpu.data import loader as jax_loader  # noqa: E402
from distributed_training_tpu.runtime import fake_cpu_runtime  # noqa: E402


@pytest.mark.parametrize("overrides", [
    [], ["model=gpt2_125m", "train=gpt2"],
    ["model=gpt2_125m", "train=gpt2", "train.learning_rate=3e-4",
     "train.device=cpu", "+model.n_layers=2", "run.output_dir=/tmp/x"],
    ["train.decay_mask=matrices", "train.total_steps=7", "mesh.dp=1"]],
    ids=["default", "gpt2", "gpt2-overrides", "default-overrides"])
def test_load_config_resolves_like_jax(overrides):
    want = jax_config.load_config(overrides=overrides).to_dict()
    got = port_config.load_config(overrides=overrides).to_dict()
    assert got == want


def test_synthetic_corpus_is_bit_identical():
    kw = dict(size=37, seq_len=129, vocab_size=50304, seed=42)
    want = jax_ds.SyntheticLMDataset(**kw).columns["tokens"]
    got = port_ds.build_dataset("synthetic_lm", _defaults={"seed": 0},
                                **kw).columns["tokens"]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown dataset"):
        port_ds.build_dataset("memmap_token", path="x", seq_len=4)


def test_loader_index_stream_matches_jax():
    """Two epochs with a wrap-padded last batch, then a resume from a
    mid-epoch cursor, batch for batch."""
    ds_kw = dict(size=11, seq_len=8, vocab_size=97, seed=3)
    jl = jax_loader.ShardedDataLoader(
        jax_ds.SyntheticLMDataset(**ds_kw), fake_cpu_runtime(1),
        batch_size=3, shuffle=True, seed=5)
    rt = Runtime(device=torch.device("cpu"))
    pl = port_loader.ShardedDataLoader(
        port_ds.SyntheticLMDataset(**ds_kw), rt, batch_size=3,
        shuffle=True, seed=5)
    assert pl.steps_per_epoch == jl.steps_per_epoch == 4
    for epoch in (0, 1):
        want = [np.asarray(b["tokens"]) for b in jl.epoch(epoch)]
        got = [b["tokens"].numpy() for b in pl.epoch(epoch)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    # Stop after two batches of epoch 2, save the cursor, resume.
    it = pl.epoch(2)
    next(it), next(it)
    state = pl.state_dict()
    it.close()
    assert state["epoch"] == 2 and state["step_in_epoch"] == 2
    assert state == {**jl.state_dict(), "epoch": 2, "step_in_epoch": 2,
                     "samples_consumed": 2 * 4 * 3 + 2 * 3,
                     "mid_epoch": True}
    resumed = port_loader.ShardedDataLoader(
        port_ds.SyntheticLMDataset(**ds_kw), rt, batch_size=3,
        shuffle=True, seed=5)
    resumed.load_state_dict(state)
    assert resumed.resume_epoch == 2
    got = [b["tokens"].numpy() for b in resumed.epoch(2)]
    want = [np.asarray(b["tokens"]) for b in jl.epoch(2)][2:]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="seed"):
        resumed.load_state_dict({**state, "seed": 6})


def test_runtime_resolves_one_device_and_refuses_a_mesh():
    """A world of 1 without a process group: one device, no mesh; a mesh
    that needs more processes than the world is the MeshSpec error, for
    tp as for fsdp, and sequence or pipeline parallelism names its
    ROADMAP item."""
    cfg = port_config.load_config(overrides=["train.device=cpu"])
    rt = initialize_runtime(cfg)
    assert (rt.device.type, rt.num_devices, rt.data_shard_count,
            rt.process_count, rt.is_coordinator) == ("cpu", 1, 1, 1, True)
    assert rt.mesh is None and rt.backend is None
    assert "platform=cpu" in rt.describe()
    with pytest.raises(MeshSpecError, match="device count 1"):
        initialize_runtime(port_config.load_config(
            overrides=["train.device=cpu", "mesh.fsdp=2"]))
    with pytest.raises(MeshSpecError, match="device count 1"):
        initialize_runtime(port_config.load_config(
            overrides=["train.device=cpu", "mesh.tp=2"]))
    with pytest.raises(MeshSpecError, match="device count 1"):
        initialize_runtime(port_config.load_config(
            overrides=["train.device=cpu", "mesh.sp=2"]))
    with pytest.raises(MeshSpecError, match="device count 1"):
        initialize_runtime(port_config.load_config(
            overrides=["train.device=cpu", "mesh.pp=2"]))

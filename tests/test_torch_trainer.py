"""The port's Trainer and CLI held against the JAX package's.

Trajectory: a tiny gpt2-class decoder and a tiny RoPE/GQA decoder
(2 layers, d 64, 4 heads, vocab 512, seq 128), float32, 5 AdamW steps
with warmup, cosine, clipping and weight decay, through the JAX
``Trainer`` and the port's ``Trainer`` on CPU from the same weights and
the same synthetic corpus, with ``attention_impl="flash"`` (the JAX
Pallas kernels in interpret mode; the port's plain versions through its
autograd Function), ``remat_policy="mlp"`` and the chunked xent head.
Per-step losses agree within 1e-5 relative; final params within 1e-4.

CLI: a run saved after its first epoch and resumed for the second ends
with params identical to an uninterrupted run.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.runtime import MeshSpecError, Runtime
from distributed_training_tpu_torch.train import cli
from distributed_training_tpu_torch.train import state as port_state
from distributed_training_tpu_torch.train.optimizer import flatten
from distributed_training_tpu_torch.train.trainer import Trainer

jax = pytest.importorskip("jax")

from distributed_training_tpu import config as jax_config  # noqa: E402
from distributed_training_tpu.data import ShardedDataLoader as JaxLoader  # noqa: E402
from distributed_training_tpu.data import SyntheticLMDataset as JaxLM  # noqa: E402
from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402
from distributed_training_tpu.runtime import fake_cpu_runtime  # noqa: E402
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402

MODELS = {
    "gpt2": dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                 max_seq_len=128),
    "rope-gqa": dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, max_seq_len=128, pos_encoding="rope",
                     tie_embeddings=False),
}
TRAIN = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.1,
             warmup_steps=2, lr_schedule="cosine", grad_clip_norm=0.5,
             batch_size=2, dataset_size=10, total_epochs=1, log_every=1,
             dtype="float32", seed=7)


def _configure(cfg):
    for k, v in TRAIN.items():
        setattr(cfg.train, k, v)
    return cfg


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trainer_trajectory_matches_jax(name):
    kw = dict(MODELS[name], dtype="float32", attention_impl="flash",
              remat=True, remat_policy="mlp", xent_chunk_rows=64)
    ds_kw = dict(size=TRAIN["dataset_size"], seq_len=128, vocab_size=512,
                 seed=TRAIN["seed"])

    jcfg = _configure(jax_config.Config())
    rt = fake_cpu_runtime(1)
    jl = JaxLoader(JaxLM(**ds_kw), rt, batch_size=2, seed=TRAIN["seed"])
    jt = JaxTrainer(jcfg, rt, jax_tf.Transformer(
        jax_tf.TransformerConfig(**kw)), jl)
    params = jax.tree.map(np.asarray, jt.state["params"])

    pcfg = _configure(port_config.Config())
    model = port_tf.Transformer(port_tf.TransformerConfig(**kw),
                                device="cpu")
    pl = ShardedDataLoader(SyntheticLMDataset(**ds_kw),
                           Runtime(device=torch.device("cpu")),
                           batch_size=2, seed=TRAIN["seed"])
    pt = Trainer(pcfg, Runtime(device=torch.device("cpu")), model, pl)
    p = port_state.with_grad(from_jax_params(params, model.cfg, "cpu"))
    pt.state = {"params": p, "opt_state": pt.optimizer.init(flatten(p)),
                "step": 0}

    jt.train()
    pt.train()
    want = [row["loss"] for row in jt.metrics.history]
    got = [row["loss"] for row in pt.metrics.history]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    final = flatten(jax.tree.map(np.asarray, jt.state["params"]))
    for k, v in flatten(pt.state["params"]).items():
        np.testing.assert_allclose(v.detach().numpy(), final[k], rtol=0,
                                   atol=1e-4, err_msg=k)
    assert pt.global_step == 5


def _cli(out_dir, epochs):
    return cli.main([
        "model=gpt2_125m", "train=gpt2", "train.device=cpu",
        "+model.n_layers=2", "+model.d_model=32", "+model.n_heads=2",
        "+model.vocab_size=128", "+model.max_seq_len=32",
        "train.dataset_kwargs.seq_len=32",
        "train.dataset_kwargs.vocab_size=128", "train.dataset_size=6",
        "train.batch_size=2", "train.total_steps=6", "train.warmup_steps=2",
        "train.dtype=float32", f"train.total_epochs={epochs}",
        "train.log_every=1", "run.log_level=WARNING",
        f"run.output_dir={out_dir}"])


def _final_params(out_dir):
    ckpt = os.path.join(out_dir, "default", "checkpoints")
    step = max(int(n) for n in os.listdir(ckpt) if n.isdigit())
    state = torch.load(os.path.join(ckpt, str(step), "state.pt"),
                       weights_only=True)
    return step, flatten(state["params"])


def test_cli_save_stop_resume_matches_uninterrupted(tmp_path):
    """Epoch 1 of 2, stop, rerun for 2 epochs: the rerun resumes from
    the checkpoint (params, optimizer state, step, loader cursor) and
    ends identical to one uninterrupted run of 2 epochs."""
    assert _cli(tmp_path / "a", 1) == 0
    assert _final_params(tmp_path / "a")[0] == 3
    assert _cli(tmp_path / "a", 2) == 0
    assert _cli(tmp_path / "b", 2) == 0
    step_a, a = _final_params(tmp_path / "a")
    step_b, b = _final_params(tmp_path / "b")
    assert step_a == step_b == 6
    for k in b:
        assert torch.equal(a[k], b[k]), k
    run = tmp_path / "a" / "default"
    events = [json.loads(line) for line in open(run / "events.jsonl")]
    resume = [e for e in events if e["kind"] == "resume"]
    assert resume and resume[-1]["step"] == 3
    assert resume[-1]["samples_consumed"] == 6
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4, 5, 6]
    assert os.path.exists(run / "resolved_config.yaml")


def test_cli_refuses_unported_features(tmp_path):
    """Tensor, sequence and pipeline parallelism run: ``mesh.tp=2``,
    ``mesh.sp=2`` or ``mesh.pp=2`` in a world of one is the mesh error,
    as any axis that needs more processes, and ring attention trains at
    sp 1. No train field is refused any more: straggler eviction runs,
    and in a world of one its detector is a no-op."""
    for axis in ("tp", "sp"):
        with pytest.raises(MeshSpecError, match="needs 2 devices"):
            cli.main(["train.device=cpu", "train.parallel_strategy=tp",
                      "mesh.dp=1", f"mesh.{axis}=2", "model=gpt2_125m",
                      "train=gpt2", f"run.output_dir={tmp_path}"])
    with pytest.raises(MeshSpecError, match="needs 2 devices"):
        cli.main(["train.device=cpu", "mesh.dp=1", "mesh.pp=2",
                  f"run.output_dir={tmp_path}"])
    assert cli.main(["train.device=cpu", "+model.attention_impl=ring",
                  "train.dataset_size=4", "train.batch_size=2",
                  "+model.n_layers=1", "+model.d_model=32",
                  "+model.n_heads=2", "+model.vocab_size=64",
                  "+model.max_seq_len=16", "train.dataset_kwargs.seq_len=16",
                  "train.dataset_kwargs.vocab_size=64",
                  "model=gpt2_125m", "train=gpt2",
                  f"run.output_dir={tmp_path}/ring",
                  f"train.snapshot_path={tmp_path}/ring/ckpt"]) == 0
    assert cli.main(["train.device=cpu", "train.straggler_evict_after=2",
                     "train.straggler_every=1", "train.dataset_size=8",
                     "train.batch_size=4", f"run.output_dir={tmp_path}",
                     f"train.snapshot_path={tmp_path}/ckpt"]) == 0


def test_sigterm_mid_run_saves_a_checkpoint_that_resumes(tmp_path,
                                                         monkeypatch):
    """SIGTERM after step 4 of 6 (2 epochs of 3): the CLI's PreemptionGuard stops the
    run after that step with a mid-epoch save; rerunning resumes there
    and ends identical to an uninterrupted run. The event stream says
    which runtime ran, opens with its clock-sync record and ends the run
    with the goodput ledger's report."""
    import signal

    step = Trainer.train_step

    def sigterm_after_4(self, batch):
        metrics = step(self, batch)
        if self.global_step == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    monkeypatch.setattr(Trainer, "train_step", sigterm_after_4)
    # The guard must put back the handler it found: SIG_DFL in a fresh
    # process, but an earlier test in the same worker may have left its
    # own.
    before = signal.getsignal(signal.SIGTERM)
    assert _cli(tmp_path / "a", 2) == 0
    monkeypatch.undo()
    assert signal.getsignal(signal.SIGTERM) == before
    assert _final_params(tmp_path / "a")[0] == 4
    run = tmp_path / "a" / "default"
    meta = json.load(open(run / "checkpoints" / "4" / "meta.json"))
    assert meta["data"]["mid_epoch"] and meta["data"]["step_in_epoch"] == 1
    events = [json.loads(line) for line in open(run / "events.jsonl")]
    kinds = {e["kind"]: e for e in events}
    assert kinds["runtime"]["backend"] is None
    assert kinds["runtime"]["world"] == 1
    assert kinds["clock_sync"]["process_count"] == 1
    assert isinstance(kinds["clock_sync"]["t_sync"], float)
    assert kinds["goodput"]["scope"] == "run"
    assert kinds["goodput"]["steps"] == 3  # steps 2-4; step 1 compiles
    assert "anomaly_detect" not in kinds
    assert _cli(tmp_path / "a", 2) == 0
    assert _cli(tmp_path / "b", 2) == 0
    step_a, a = _final_params(tmp_path / "a")
    step_b, b = _final_params(tmp_path / "b")
    assert step_a == step_b == 6
    for k in b:
        assert torch.equal(a[k], b[k]), k

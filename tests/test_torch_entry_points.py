"""The port's real-text path and its entry points held against the JAX
package.

One tiny byte LM (``train=bytes_lm model=byte_lm`` cut to 2 layers, d 64,
seq 64, float32) is trained through the port's CLI on a corpus
``data/prepare.py`` builds from the repo's own files, with the held-out
split (``train.eval_fraction=0.05``, ``eval_every=1``), then:

- ``val_loss`` of each epoch equals JAX's ``model.loss(train=False)``
  mean over the JAX package's own held-out split (``train_eval_split``
  with ``multiple_of`` the batch) on the checkpointed params, within
  1e-5 relative;
- ``eval.py`` (``--device cpu``) scores the run's dataset as JAX's
  ``model.loss(train=False)`` does on the same unshuffled batches;
- ``generate.py`` (``--device cpu``), ``--decode fused`` and ``--decode
  paged``, gives JAX's ``model.generate`` greedy tokens, on JAX's init
  scaled by 3 written into the run as another step (the few trained
  steps leave the model emitting one byte);
- sampling (temperature and top-k) is deterministic in ``--seed`` and
  every drawn token lies in the top-k of the model's logits at its
  position. JAX's ``jax.random`` stream is not reproduced (a difference
  by design), so sampled tokens are not compared across packages.

Without ``--device cpu`` both CLIs ask for the CUDA card and raise here.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import eval as port_eval
from distributed_training_tpu_torch import generate as port_generate
from distributed_training_tpu_torch.data import prepare
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.runtime import NoCudaDeviceError
from distributed_training_tpu_torch.train import cli

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.data import datasets as jax_ds  # noqa: E402
from distributed_training_tpu.models import transformer as jax_tf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             max_seq_len=64)
SEQ, BATCH, SEED = 64, 4, 42  # conf/train/bytes_lm.yaml's seed


def _run_cli(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The trained run: (run dir, corpus path)."""
    tmp = tmp_path_factory.mktemp("byte_lm")
    corpus = str(tmp / "corpus.bin")
    prepare.main(["--out", corpus, os.path.join(
        REPO, "distributed_training_tpu_torch", "data", "*.py")])
    assert cli.main([
        "train=bytes_lm", "model=byte_lm", "train.device=cpu",
        f"train.dataset_kwargs.path={corpus}",
        f"train.dataset_kwargs.seq_len={SEQ}",
        *[f"+model.{k}={v}" for k, v in MODEL.items()],
        f"train.batch_size={BATCH}", "train.max_steps_per_epoch=4",
        "train.warmup_steps=2", "train.dtype=float32", "train.log_every=1",
        "train.eval_fraction=0.05", "train.eval_every=1",
        "run.log_level=WARNING", f"run.output_dir={tmp}"]) == 0
    return str(tmp / "default"), corpus


def _jax_model():
    return jax_tf.Transformer(jax_tf.TransformerConfig(**MODEL,
                                                       dtype="float32"))


def _params(run_dir: str, step: int) -> dict:
    state = torch.load(os.path.join(run_dir, "checkpoints", str(step),
                                    "state.pt"), weights_only=True)
    return state["params"]


def _as_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _jax_mean_loss(model, params, ds, rows: np.ndarray) -> float:
    score = jax.jit(lambda p, b: model.loss(p, b, jax.random.PRNGKey(0),
                                            train=False)[0])
    losses = [float(score(params, ds.batch(rows[i:i + BATCH])))
              for i in range(0, len(rows), BATCH)]
    return float(np.mean(losses))


def test_val_loss_matches_jax(run):
    run_dir, corpus = run
    rows = [json.loads(line) for line in open(os.path.join(run_dir,
                                                           "metrics.jsonl"))]
    vals = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in vals] == [4, 8]
    base = jax_ds.build_dataset("bytes", path=corpus, seq_len=SEQ)
    _, held = jax_ds.train_eval_split(base, 0.05, seed=SEED,
                                      multiple_of=BATCH)
    assert len(held) % BATCH == 0 and len(held) >= 2 * BATCH
    model = _jax_model()
    for r in vals:
        want = _jax_mean_loss(model, _as_jax(_params(run_dir, r["step"])),
                              held, np.arange(len(held)))
        np.testing.assert_allclose(r["val_loss"], want, rtol=1e-5)


def test_eval_cli_matches_jax(run):
    run_dir, corpus = run
    got = _run_cli(port_eval.main, ["--run-dir", run_dir, "--device", "cpu",
                                    "--max-batches", "3"])
    assert got["batches"] == 3 and got["step"] == 8
    assert got["tokens"] == 3 * BATCH * (SEQ + 1)
    assert set(got["kernel_launches"]) >= {"flash_fwd", "paged_decode"}
    base = jax_ds.build_dataset("bytes", path=corpus, seq_len=SEQ)
    want = _jax_mean_loss(_jax_model(), _as_jax(_params(run_dir, 8)), base,
                          np.arange(3 * BATCH))
    np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    with pytest.raises(NoCudaDeviceError):
        port_eval.main(["--run-dir", run_dir])


@pytest.fixture(scope="module")
def sharp(run):
    """JAX's init (seed 5) scaled by 3, saved into the run as step 99: a
    few steps of training leave the tiny model emitting one byte."""
    run_dir, _ = run
    ckpt = os.path.join(run_dir, "checkpoints")
    state = torch.load(os.path.join(ckpt, "8", "state.pt"),
                       weights_only=True)
    init = _jax_model().init(jax.random.PRNGKey(5))
    state["params"] = from_jax_params(
        jax.tree.map(lambda t: np.asarray(t) * 3.0, init),
        build_model("gpt2_125m", dtype="float32", device="cpu",
                    **MODEL).cfg, "cpu")
    os.makedirs(os.path.join(ckpt, "99"))
    torch.save(state, os.path.join(ckpt, "99", "state.pt"))
    with open(os.path.join(ckpt, "99", "meta.json"), "w") as f:
        json.dump({"epoch": 1}, f)
    return state["params"]


PROMPT = "def main(argv):\n    "


@pytest.mark.parametrize("decode", ["fused", "paged"])
def test_generate_greedy_matches_jax(run, sharp, decode):
    run_dir, _ = run
    got = _run_cli(port_generate.main, [
        "--run-dir", run_dir, "--step", "99", "--device", "cpu",
        "--prompt", PROMPT, "-n", "24", "--decode", decode, "--json"])
    assert got["decode"] == decode and got["step"] == 99
    ids = np.frombuffer(PROMPT.encode(), np.uint8).astype(np.int32)
    want = np.asarray(_jax_model().generate(
        _as_jax(sharp), jnp.asarray(ids)[None], 24))[0]
    assert got["tokens"] == want.tolist()
    assert len(set(got["tokens"])) > 3


def test_sampling_deterministic_and_in_top_k(run, sharp):
    run_dir, _ = run
    argv = ["--run-dir", run_dir, "--step", "99", "--device", "cpu",
            "--prompt", PROMPT, "-n", "16", "--temperature", "0.9",
            "--top-k", "4", "--json"]
    a = _run_cli(port_generate.main, argv + ["--seed", "3"])
    b = _run_cli(port_generate.main, argv + ["--seed", "3"])
    c = _run_cli(port_generate.main, argv + ["--seed", "4"])
    assert a["tokens"] == b["tokens"] and a["decode"] == "fused"
    assert a["tokens"] != c["tokens"]
    model = build_model("gpt2_125m", dtype="float32", device="cpu", **MODEL)
    ids = list(np.frombuffer(PROMPT.encode(), np.uint8))
    for tok in a["tokens"]:
        logits, _ = model.apply(sharp, torch.tensor([ids]))
        assert tok in torch.topk(logits[0, -1], 4).indices.tolist()
        ids.append(tok)
    with pytest.raises(NoCudaDeviceError):
        port_generate.main(["--run-dir", run_dir, "--prompt", "x"])

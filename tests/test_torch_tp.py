"""The port's tensor-parallel collectives (``parallel/tensor.py``), the
vocab-parallel cross-entropy (``ops/xent.py``) and the tensor-parallel
block (``models/transformer.py``).

In the 2-process gloo world that ``tests/test_torch_sharded.py`` spawns
(its ``tp_ops`` run, ``tp_ops_inputs`` in the worker), at tp 2, float32:

- the vocab-parallel cross-entropy (each rank's half of the head's
  columns, 3 sequence chunks, masked targets) against
  ``lm_cross_entropy`` over the whole vocab in this process: the nll and
  the gradients of the hidden states and of the head, within 1e-6;
- the vocab-parallel embedding lookup (each rank's half of the rows)
  against plain indexing, its values bit for bit and its gradient;
- ``reduce_from_tp`` (forward sum, gradient passed through) and
  ``copy_to_tp`` (gradient summed) on rank-weighted inputs, and the
  all-reduces each launched;
- ``Transformer.apply`` under the tp binding (each rank's blocks of the
  weights) against the unbound ``apply`` in this process: the whole
  vocab's f32 logits, within 1e-5.

In this process, in a gloo group of one: the block bound to a tp group
of one gives the unbound block's loss and gradients bit for bit under
every remat policy, and launches the all-reduces the design predicts
(none re-run by remat); ``tp_fsdp`` through the CLI gives ``ddp``'s
losses and gradient norms bit for bit in bfloat16.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.ops.xent import lm_cross_entropy
from distributed_training_tpu_torch.parallel import tensor as tp_lib
from distributed_training_tpu_torch.train import cli as port_cli
from distributed_training_tpu_torch.train.optimizer import flatten
from test_torch_sharded import spawned
from test_torch_sharded_world import (
    TP_APPLY_MODEL,
    tp_apply_tokens,
    tp_ops_inputs,
)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tp_ops(tmp_path_factory):
    return spawned(2, tmp_path_factory)["tp_ops"]


def test_vocab_parallel_xent_matches_the_whole_vocab(tp_ops):
    inp = {k: torch.from_numpy(v) for k, v in tp_ops_inputs().items()}
    x = inp["x"].clone().requires_grad_(True)
    head = inp["head"].clone().requires_grad_(True)
    nll = lm_cross_entropy(x, head, inp["targets"], chunk_rows=16)
    (nll * inp["w"]).sum().backward()
    assert tp_ops["tp"] == 2
    assert (nll[inp["targets"] < 0] == 0).all()
    for got, want in ((tp_ops["nll"], nll.detach()), (tp_ops["dx"], x.grad),
                      (tp_ops["dhead"], head.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # A masked target gives its row no gradient on either rank.
    assert (tp_ops["dx"][inp["targets"] < 0] == 0).all()


def test_vocab_parallel_embedding_matches_plain_indexing(tp_ops):
    inp = {k: torch.from_numpy(v) for k, v in tp_ops_inputs().items()}
    table = inp["table"].clone().requires_grad_(True)
    emb = table[inp["ids"]]
    (emb * inp["emb_w"]).sum().backward()
    assert torch.equal(tp_ops["emb"], emb.detach())
    np.testing.assert_allclose(tp_ops["dtable"].numpy(),
                               table.grad.numpy(), **TOL)


def test_copy_and_reduce_gradients(tp_ops):
    """Rank r feeds (r + 1) * y to ``reduce_from_tp``: every rank gets
    the sum, 3y, and rank 0's gradient of y is its own factor times the
    output's gradient. ``copy_to_tp``'s gradient of z sums the ranks'
    (r + 1) * scale. Over the whole run the xent launched two
    all-reduces per chunk (3 chunks), ``copy_to_tp`` one per backward (x
    and z), ``reduce_from_tp`` one per forward (the lookup and y)."""
    inp = {k: torch.from_numpy(v) for k, v in tp_ops_inputs().items()}
    x, scale = inp["x"], inp["scale"]
    assert torch.equal(tp_ops["reduced"], x * 1 + x * 2)
    assert torch.equal(tp_ops["dy"], scale.expand_as(x))
    assert torch.equal(tp_ops["dz"], (scale * 1 + scale * 2).expand_as(x))
    assert tp_ops["all_reduces"] == {"xent": 6, "copy_to_tp": 2,
                                     "reduce_from_tp": 2}


@pytest.mark.parametrize("n_heads,n_kv_heads,tp", [
    (4, 2, 4), (8, 2, 4), (12, 3, 2), (12, 4, 6), (32, 8, 16), (6, 3, 2)])
def test_kv_heads_of_rank_feed_each_query_head_its_kv_head(n_heads,
                                                           n_kv_heads, tp):
    """Where tp does not divide the kv heads, each rank's selection of
    kv heads, read with the flash kernels' GQA rule (local query head j
    reads local kv head j // (H/tp / n)), gives every query head h the
    kv head h // (H / Hkv) it reads in the whole model."""
    per, group = n_heads // tp, n_heads // n_kv_heads
    for rank in range(tp):
        idx = port_tf.kv_heads_of_rank(n_heads, n_kv_heads, tp, rank)
        assert per % len(idx) == 0
        ratio = per // len(idx)
        assert [idx[j // ratio] for j in range(per)] == [
            (rank * per + j) // group for j in range(per)]


def test_apply_under_tp_gives_the_whole_vocab_logits(tp_ops):
    model = port_tf.Transformer(port_tf.TransformerConfig(**TP_APPLY_MODEL),
                                device="cpu")
    want, _ = model.apply(model.init(0), tp_apply_tokens())
    got = tp_ops["apply"]
    assert got.shape == want.shape == (2, 12, TP_APPLY_MODEL["vocab_size"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bind_refuses_splits_tp_does_not_divide():
    model = port_tf.Transformer(port_tf.TransformerConfig(
        vocab_size=64, d_model=48, n_layers=1, n_heads=6, dtype="float32"),
        device="cpu")
    with pytest.raises(ValueError, match="n_heads=6 does not split over tp=4"):
        model.bind_tensor_parallel(SimpleNamespace(size=4, rank=0))
    model.bind_tensor_parallel(SimpleNamespace(size=2, rank=1, group=None))
    model.cfg.loss_impl = "dense"
    with pytest.raises(ValueError, match="loss_impl='fused'"):
        model.loss(model.init(0), {"tokens": np.zeros((1, 5), np.int64)})


@pytest.fixture
def group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield tp_lib.TPGroup(dist.group.WORLD)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("remat", ["none", "full", "selective", "mlp",
                                   "mlp_pre"])
def test_tp_group_of_one_equals_the_unbound_block_bitwise(group_of_one,
                                                          remat):
    """The GQA/RoPE/untied model bound to a tp group of one: the same
    loss and gradients, bit for bit, as unbound, and per loss and
    backward 2L + 1 ``reduce_from_tp`` (two a layer and the lookup),
    2L + 1 ``copy_to_tp`` (two a layer and the head's input) and two
    all-reduces per cross-entropy chunk, however remat recomputes."""
    cfg = port_tf.TransformerConfig(
        vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        max_seq_len=32, pos_encoding="rope", tie_embeddings=False,
        dtype="float32", remat=remat != "none",
        remat_policy="selective" if remat == "none" else remat,
        xent_chunk_rows=16)
    model = port_tf.Transformer(cfg, device="cpu")
    params = model.init(0)
    leaves = list(flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": np.random.default_rng(0).integers(0, 128, (2, 33))}
    runs = []
    for tp in (None, group_of_one):
        model.bind_tensor_parallel(tp)
        tp_lib.ALL_REDUCES.clear()
        loss, _ = model.loss(params, batch)
        runs.append((loss, torch.autograd.grad(loss, leaves),
                     dict(tp_lib.ALL_REDUCES)))
    (want, wgrads, none), (got, grads, counts) = runs
    assert none == {}
    assert torch.equal(got, want)
    for g, w in zip(grads, wgrads):
        assert torch.equal(g, w)
    L, chunks = cfg.n_layers, 32 * 2 // 16
    assert counts == {"reduce_from_tp": 2 * L + 1, "copy_to_tp": 2 * L + 1,
                      "xent": 2 * chunks}


def test_tp_fsdp_in_a_group_of_one_equals_ddp_bitwise(tmp_path):
    """bfloat16, 4 steps through the CLI: ``tp_fsdp`` at tp 1 and fsdp 1
    in a gloo group of one (the block's reduces, the vocab-parallel
    lookup and cross-entropy over a tp group of one, the per-layer
    gathers over an fsdp group of one) gives ``ddp`` with no group's
    losses and gradient norms bit for bit."""
    tiny = ["train.device=cpu", "model=transformer_1b", "train=gpt2",
            "+model.n_layers=2", "+model.d_model=64", "+model.n_heads=4",
            "+model.vocab_size=512", "+model.max_seq_len=128",
            "train.dataset_kwargs.seq_len=128",
            "train.dataset_kwargs.vocab_size=512", "train.dataset_size=16",
            "train.batch_size=4", "train.total_epochs=1", "train.log_every=1",
            "train.save_every=0", "run.log_level=WARNING"]

    def rows(out):
        with open(os.path.join(out, "default", "metrics.jsonl")) as f:
            return [(r["step"], r["loss"], r.get("grad_norm"))
                    for r in map(json.loads, f) if "loss" in r]

    tp_lib.ALL_REDUCES.clear()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        assert port_cli.main(tiny + ["train.parallel_strategy=tp_fsdp",
                                     f"run.output_dir={tmp_path}/tp"]) == 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    counts = dict(tp_lib.ALL_REDUCES)
    assert port_cli.main(tiny + [f"run.output_dir={tmp_path}/ddp"]) == 0
    got, want = rows(f"{tmp_path}/tp"), rows(f"{tmp_path}/ddp")
    assert len(want) == 4 and got == want
    assert counts == {"reduce_from_tp": 5 * 4, "copy_to_tp": 5 * 4,
                      "xent": 2 * 4}

"""One process of the spawned gloo world of 2 for the MoE world tests in
``tests/test_torch_moe.py``.

    python tests/test_torch_moe_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs, on the CPU, every ``train`` case of the job: the
port's Trainer on the case's mesh (a tiny MoE transformer, float32,
the job's init weights, the case's dataset of ``DATASETS``), optionally
saving a checkpoint, optionally with a planted fault:

- ``local_aux``: each data shard's aux statistics its own, not summed
  over the data group;
- ``sp_offset``: each sequence slice's capacity places counted from 0,
  without the earlier slices' counts;
- ``tp_seam``: the router's gradient summed over tp although it is
  whole on every rank (the router marked ``tp_partial``);
- ``shard_weight``: the trainer's live-target weight left out of the
  loss, so that the aux's gradient share takes it a second time (seen
  only where the shards' live targets differ: ``MaskedSkewedLMDataset``).

Process 0 writes the metric rows (with ``moe_aux``), the whole final
params and the placements of the expert leaves to ``<out>/<case>.pt``.
It imports only the port (and torch, numpy), never JAX. The file holds
no tests.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.parallel import expert, fsdp
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.train import trainer as trainer_lib
from distributed_training_tpu_torch.train.optimizer import (
    flatten,
    unflatten,
)


class SkewedLMDataset(SyntheticLMDataset):
    """``SyntheticLMDataset`` rows whose ids are folded into the vocab's
    lower half on even rows and its upper half on odd ones: with two
    data shards (strided rows) each shard sees one half, so its routing
    differs from the other's and a per-shard aux from the global one."""

    def batch(self, indices: np.ndarray) -> dict:
        out = super().batch(indices)
        half = self.vocab_size // 2
        toks = np.array(out["tokens"]) % half
        toks += half * (np.asarray(indices) % 2)[:, None].astype(toks.dtype)
        return {**out, "tokens": toks}


class MaskedSkewedLMDataset(SkewedLMDataset):
    """``SkewedLMDataset`` rows whose tail is masked: row ``i`` ends in
    ``i * 5 % (L // 2)`` ids of -1 (padding targets), so the data
    shards' live-target counts differ and the trainer weighs them."""

    def batch(self, indices: np.ndarray) -> dict:
        out = super().batch(indices)
        toks = np.array(out["tokens"])
        L = toks.shape[1]
        for r, i in enumerate(np.asarray(indices)):
            tail = int(i) * 5 % (L // 2)
            if tail:
                toks[r, L - tail:] = -1
        return {**out, "tokens": toks}


DATASETS = {"skewed": SkewedLMDataset, "masked": MaskedSkewedLMDataset}


def _fault(name: str | None):
    if name == "local_aux":
        return mock.patch.object(
            expert.DataGroup, "aux",
            lambda self, counts, probsum, n, E, grad_scale=1.0:
            expert.local_aux(counts, probsum, n, E))
    if name == "sp_offset":
        return mock.patch.object(
            expert, "slot_counts", lambda counts, group, rank: (counts, 0))
    if name == "tp_seam":
        layout = trainer_lib.strategy_layout

        def seam_summed(*args):
            out = layout(*args)
            return {**out, "tp_partial": (*out["tp_partial"], "mlp/router")}
        return mock.patch.object(trainer_lib, "strategy_layout", seam_summed)
    if name == "shard_weight":
        loss = port_tf.Transformer.loss

        def weight_dropped(self, *args, shard_weight=None, **kwargs):
            return loss(self, *args, **kwargs)
        return mock.patch.object(port_tf.Transformer, "loss", weight_dropped)
    return contextlib.nullcontext()


def _train(job: dict, case: dict, out: str) -> None:
    cfg = port_config.Config()
    for key, val in {**job["train"], **case.get("train", {})}.items():
        setattr(cfg.train, key, val)
    for key, val in case["mesh"].items():
        setattr(cfg.mesh, key, val)
    rt = initialize_runtime(cfg)
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **job["model"], **case.get("model", {})), device="cpu")
    ds = DATASETS[case.get("dataset", "skewed")](**job["dataset"])
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=cfg.train.seed, shuffle=False)
    ckpt = case.get("ckpt")
    checkpointer = Checkpointer(ckpt, runtime=rt) if ckpt else None
    init = {k: v.clone() for k, v in torch.load(
        job["init"], weights_only=True).items()}
    with _fault(case.get("fault")):
        trainer = trainer_lib.Trainer(cfg, rt, model, loader, checkpointer,
                                      params=unflatten(init))
        trainer.train()
    whole = fsdp.gather_full(flatten(trainer.state["params"]),
                             trainer.layout["params"], rt)
    if rt.is_coordinator:
        torch.save({"rows": trainer.metrics.history,
                    "placements": {k: (None if pl is None else pl.splits)
                                   for k, pl in
                                   trainer.layout["params"].items()
                                   if k.startswith("mlp/")},
                    "params": {k: v.detach().clone()
                               for k, v in whole.items()}},
                   os.path.join(out, f"{case['name']}.pt"))


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=job["world"],
                            timeout=datetime.timedelta(seconds=120))
    try:
        for case in job["cases"]:
            _train(job, case, job["out"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

"""One process of the spawned gloo world of 2 for the ResNet world tests
in ``tests/test_torch_resnet_world.py``.

    python tests/test_torch_resnet_worker.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs, on the CPU, every case of the job: the port's Trainer
on the case's mesh and strategy (a narrow ResNet, float32, the job's
init weights, ``SyntheticImageDataset``), optionally saving a
checkpoint, optionally with the planted fault ``unsummed``: the
gradient all-reduce dropped for the leaves whose moments the strategy's
shape heuristic slices (ZeRO-1), so each process updates its slice from
its own shard's gradient. A case with ``"raises": true`` records the
``ValueError`` the Trainer raises for its mesh (``sp`` or ``pp`` > 1).

Process 0 writes each step's metrics, the whole final params and the
placements of every leaf to ``<out>/<case>.pt``. It imports only the
port (and torch, numpy), never JAX. The file holds no tests.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
from unittest import mock

import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticImageDataset
from distributed_training_tpu_torch.models.resnet import ResNet
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.train import trainer as trainer_lib
from distributed_training_tpu_torch.train.optimizer import (
    flatten,
    unflatten,
)


def _unsummed(trainer):
    """``fsdp.average_grads`` without the sum over the data processes for
    the leaves whose moments are sliced (ZeRO-1's heuristic leaves)."""
    lay = trainer.layout
    sliced = {k for k, pl in lay["opt"].items()
              if pl is not None and lay["params"][k] is None}
    if not sliced:
        raise ValueError("the planted fault needs leaves with sliced moments")
    real = fsdp.average_grads

    def average(grads, placements, runtime, tp_partial=()):
        real({k: g for k, g in grads.items() if k not in sliced},
             placements, runtime, tp_partial)
        for k in sliced:
            grads[k].div_(runtime.data_shard_count)
        return grads
    return mock.patch.object(fsdp, "average_grads", average)


def _splits(layout: dict) -> dict:
    return {k: (None if pl is None else pl.splits)
            for k, pl in layout.items()}


def _train(job: dict, case: dict, out: str) -> None:
    cfg = port_config.Config()
    for key, val in {**job["train"], **case.get("train", {})}.items():
        setattr(cfg.train, key, val)
    for key, val in case["mesh"].items():
        setattr(cfg.mesh, key, val)
    rt = initialize_runtime(cfg)
    model = ResNet(**job["model"], device="cpu")
    loader = ShardedDataLoader(SyntheticImageDataset(**job["dataset"]), rt,
                               batch_size=cfg.train.batch_size,
                               seed=cfg.train.seed, shuffle=False)
    init = unflatten({k: v.clone() for k, v in torch.load(
        job["init"], weights_only=True).items()})
    if case.get("raises"):
        try:
            trainer_lib.Trainer(cfg, rt, model, loader, params=init)
            error = None
        except ValueError as e:
            error = str(e)
        if rt.is_coordinator:
            torch.save({"error": error},
                       os.path.join(out, f"{case['name']}.pt"))
        return
    ckpt = case.get("ckpt")
    checkpointer = Checkpointer(ckpt, runtime=rt) if ckpt else None
    trainer = trainer_lib.Trainer(cfg, rt, model, loader, checkpointer,
                                  params=init)
    rows, step = [], trainer.train_step

    def record(batch):
        m = step(batch)
        rows.append({k: float(v) for k, v in m.items()})
        return m
    trainer.train_step = record
    fault = (_unsummed(trainer) if case.get("fault") == "unsummed"
             else contextlib.nullcontext())
    with fault:
        trainer.train()
    whole = fsdp.gather_full(flatten(trainer.state["params"]),
                             trainer.layout["params"], rt)
    if rt.is_coordinator:
        torch.save({"rows": rows,
                    "placements": _splits(trainer.layout["params"]),
                    "opt_placements": _splits(trainer.layout["opt"]),
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

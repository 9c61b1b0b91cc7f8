"""One process of a spawned gloo world for ``tests/test_torch_mlp.py``
and ``tests/test_torch_adafactor.py``.

    python tests/test_torch_mlp_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs every run of the job on the CPU through the port's
``Trainer``, from the parent's init weights: the default config's MLP
(``model: default``, ``synthetic``, SGD) or a tiny transformer under
Adafactor, on the run's mesh and strategy. Process 0 writes each run's
metrics rows and whole final params to ``<out>/<run>.pt``; a run with
``ckpt`` also saves its last step there, sharded, for the parent to
consolidate. It imports only the port (and torch, numpy), never JAX. The
file holds no tests.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.data import ShardedDataLoader, build_dataset
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten
from distributed_training_tpu_torch.train.trainer import Trainer


def _run(job: dict, run: dict) -> dict:
    cfg = port_config.Config()
    for k, v in {**run["train"], "device": "cpu"}.items():
        setattr(cfg.train, k, v)
    for k, v in run["mesh"].items():
        setattr(cfg.mesh, k, v)
    rt = initialize_runtime(cfg)
    kw = dict(run["model_kwargs"])
    model = build_model(run["model"], loss=cfg.train.loss,
                        dtype=kw.pop("dtype", cfg.train.dtype), device="cpu",
                        **kw)
    ds = build_dataset(cfg.train.dataset, **run["dataset"])
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=cfg.train.seed)
    init = {k: v.clone() for k, v in torch.load(
        run["init"], weights_only=True).items()}
    ckpt = None
    if run.get("ckpt"):
        cfg.train.snapshot_path = run["ckpt"]
        ckpt = Checkpointer(run["ckpt"], runtime=rt)
    trainer = Trainer(cfg, rt, model, loader, ckpt, params=unflatten(init))
    trainer.train()
    whole = fsdp.gather_full(flatten(trainer.state["params"]),
                             trainer.layout["params"], rt)
    return {"rows": trainer.metrics.history,
            "params": {k: v.detach().clone() for k, v in whole.items()},
            "layout": {k: None if pl is None else pl.splits
                       for k, pl in trainer.layout["params"].items()}}


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=job["world"])
    try:
        for run in job["runs"]:
            out = _run(job, run)
            if rank == 0:
                torch.save(out, os.path.join(job["out"],
                                             run["name"] + ".pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

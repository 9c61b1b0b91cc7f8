"""One process of a spawned gloo world for ``tests/test_torch_sharded.py``.

    python tests/test_torch_sharded_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job, then trains every run of the job through the port's Trainer on
the CPU (tiny model, float32, the parent's init weights) and writes,
from process 0, each run's metrics rows and whole final params to
``<out>/<run>.pt``. It imports only the port (and torch, numpy), never
JAX: the parent holds the results against the JAX trainer. The file
holds no tests.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.checkpoint.consolidate import (
    load_consolidated,
)
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.train.optimizer import (
    flatten,
    unflatten,
)
from distributed_training_tpu_torch.train.trainer import Trainer
from distributed_training_tpu_torch.utils.preemption import PreemptionGuard


def _trainer(job: dict, run: dict, ckpt: str | None = None, guard=None):
    cfg = port_config.Config()
    for k, v in {**job["train"], **run.get("train", {})}.items():
        setattr(cfg.train, k, v)
    for k, v in run["mesh"].items():
        setattr(cfg.mesh, k, v)
    rt = initialize_runtime(cfg)
    checkpointer = None
    if ckpt is not None:
        cfg.train.snapshot_path = ckpt
        checkpointer = Checkpointer(ckpt, runtime=rt)
    model = port_tf.Transformer(port_tf.TransformerConfig(**job["model"]),
                                device="cpu")
    ds = SyntheticLMDataset(**{**job["dataset"], **run.get("dataset", {})})
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=cfg.train.seed)
    init = {k: v.clone() for k, v in torch.load(
        job["init"], weights_only=True).items()}
    return Trainer(cfg, rt, model, loader, checkpointer,
                   preemption_guard=guard, params=unflatten(init))


def _whole_params(trainer) -> dict:
    flat = flatten(trainer.state["params"])
    return {k: v.detach().clone() for k, v in fsdp.gather_full(
        flat, trainer.layout["params"], trainer.rt).items()}


def _run(job: dict, run: dict, rank: int) -> dict:
    kind = run.get("kind", "train")
    if kind == "train":
        trainer = _trainer(job, run)
        trainer.train()
        return {"rows": trainer.metrics.history,
                "params": _whole_params(trainer)}
    if kind == "drift":
        # Rank 1 perturbs its replica of one weight after step 3: the
        # next checks must see it.
        trainer = _trainer(job, run)
        step = trainer.train_step

        def planted(batch):
            m = step(batch)
            if trainer.global_step == 3 and rank == 1:
                with torch.no_grad():
                    trainer.state["params"]["tok_embed"][0, 0] += 1e-3
            return m
        trainer.train_step = planted
        trainer.train()
        return {"rows": trainer.metrics.history}
    assert kind == "resume", kind
    # Rank 0 alone is asked to stop after step 2: every rank must agree,
    # save (sharded, plus the consolidated artifact) and leave; a second
    # trainer resumes from that save and runs to the end.
    ckpt = os.path.join(job["out"], run["name"] + "_ckpt")
    guard = PreemptionGuard()
    first = _trainer(job, run, ckpt, guard)
    step = first.train_step

    def stop_after_2(batch):
        m = step(batch)
        if first.global_step == 2 and rank == 0:
            guard.trigger("test")
        return m
    first.train_step = stop_after_2
    first.train()
    saved = _whole_params(first)
    artifact = None
    if rank == 0:
        state, meta = load_consolidated(
            os.path.join(ckpt, "consolidated_step2.pt"))
        artifact = {"params": flatten(state["params"]), "meta": meta}
    second = _trainer(job, run, ckpt)
    resumed_at = second.global_step
    second.train()
    return {"rows_first": first.metrics.history,
            "rows": second.metrics.history, "resumed_at": resumed_at,
            "saved_params": saved, "artifact": artifact, "ckpt": ckpt,
            "params": _whole_params(second)}


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=job["world"])
    try:
        for run in job["runs"]:
            out = _run(job, run, rank)
            if rank == 0:
                torch.save(out, os.path.join(job["out"],
                                             run["name"] + ".pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

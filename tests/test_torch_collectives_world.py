"""One process of the spawned gloo world of 2 for the collectives tests in
``tests/test_torch_collectives.py``.

    python tests/test_torch_collectives_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs, on the CPU, every case of the job: the port's Trainer
on the case's mesh (the tiny transformer of ``tests/test_analysis.py``'s
collectives test: vocab 64, d_model 16, 2 heads, 1 layer, seq 8, batch 2
a shard, float32, ``min_shard_elems`` 1) for two steps of one epoch,
with an event sink of its own (``events.rank<r>.jsonl``). Process 0
writes the case's ``collectives`` events, the leaf shapes and the
placements to ``<out>/<case>.json``; every process writes the count of
``collectives`` events its own stream holds. It imports only the port
(and torch, numpy), never JAX. The file holds no tests.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.telemetry import events
from distributed_training_tpu_torch.train import trainer as trainer_lib
from distributed_training_tpu_torch.train.optimizer import flatten


def _run(job: dict, case: dict, rank: int) -> None:
    cfg = port_config.Config()
    for key, val in {**job["train"],
                     "parallel_strategy": case["strategy"]}.items():
        setattr(cfg.train, key, val)
    for key, val in case["mesh"].items():
        setattr(cfg.mesh, key, val)
    rt = initialize_runtime(cfg)
    path = os.path.join(job["out"], f"{case['name']}.events.rank{rank}.jsonl")
    tel = events.install(events.Telemetry(path, host_id=rank))
    try:
        model = build_model("transformer", device="cpu", **job["model"])
        ds = SyntheticLMDataset(size=64, seq_len=job["seq_len"],
                                vocab_size=job["model"]["vocab_size"], seed=0)
        loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                                   shuffle=False, max_steps_per_epoch=2)
        trainer = trainer_lib.Trainer(cfg, rt, model, loader)
        trainer.train(max_epochs=1)
        steps = trainer.global_step
    finally:
        tel.close()
        events.uninstall()
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    coll = [r for r in recs if r.get("kind") == "collectives"]
    with open(os.path.join(job["out"],
                           f"{case['name']}.count.rank{rank}.json"), "w") as f:
        json.dump({"collectives_events": len(coll), "steps": steps}, f)
    if rank == 0:
        pls = trainer.layout["params"]
        with open(os.path.join(job["out"], f"{case['name']}.json"), "w") as f:
            json.dump({
                "events": coll,
                "shapes": {k: list(v) for k, v in
                           flatten(model.param_shapes()).items()},
                "placements": {k: None if pl is None else
                               [[d, list(a)] for d, a in pl.splits]
                               for k, pl in pls.items()}}, f)


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=job["world"])
    try:
        for case in job["cases"]:
            _run(job, case, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

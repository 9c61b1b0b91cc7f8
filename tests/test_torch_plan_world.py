"""One process of the spawned gloo world of 4 for
``tests/test_torch_plan.py``.

    python tests/test_torch_plan_world.py <job.json> <rank>

Every process runs, in one world, the port's training CLI for three
steps under ``train.sharding_plan=<the job's plan>`` (fsdp 2 x tp 2),
then the same CLI under ``tp_fsdp`` on the same mesh with no plan, then
the CLI under the job's ring plan (fsdp 2 x sp 2, ring attention); each
run writes its ``metrics.jsonl`` under ``<out>/<run>/default``. Then
the port's planner searches the job's target (``search``: JAX's e2e
model at 4 devices) with its real gate on the CPU in the same world,
and writes the plan it chose to ``<out>/searched.rank<r>.json``. It
imports only the port (and torch), never JAX. The file holds no tests.
"""

from __future__ import annotations

import datetime
import json
import sys

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.parallel import planner
from distributed_training_tpu_torch.train import cli

STEPS = 3


def cli_overrides(model: dict) -> list:
    """The CLI's tiny run of ``model`` (the plan's model kwargs)."""
    return (["train.device=cpu", "model=gpt2_125m", "train=gpt2",
             "+model.remat=false", "train.dataset_size=64",
             f"train.dataset_kwargs.seq_len={model['max_seq_len']}",
             f"train.dataset_kwargs.vocab_size={model['vocab_size']}",
             "train.dtype=float32", "train.total_epochs=1",
             f"train.max_steps_per_epoch={STEPS}",
             "train.log_every=1", "train.save_every=0",
             "train.min_shard_elems=1", "run.log_level=WARNING"]
            + [f"+model.{k}={v}" for k, v in model.items() if k != "dtype"])


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        tiny = cli_overrides(job["model"])
        out = job["out"]
        assert cli.main(tiny + [f"train.sharding_plan={job['plan']}",
                                f"run.output_dir={out}/planned"]) == 0
        assert cli.main(tiny + ["train.parallel_strategy=tp_fsdp",
                                "train.batch_size=2"]
                        + [f"mesh.{k}={v}" for k, v in job["mesh"].items()]
                        + [f"run.output_dir={out}/unplanned"]) == 0
        assert cli.main(cli_overrides(job["ring_model"])
                        + [f"train.sharding_plan={job['ring_plan']}",
                           f"run.output_dir={out}/ring_planned"]) == 0
        target = planner.PlanTarget(**job["search"])
        plan = planner.plan_search(
            target, lambda t, p: planner.compile_verify(t, p, "cpu"))
        with open(f"{out}/searched.rank{rank}.json", "w") as f:
            json.dump(plan.to_doc(), f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

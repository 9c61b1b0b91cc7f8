"""One process of the spawned gloo world of 8 for
``tests/test_torch_disagg.py``.

    python tests/test_torch_disagg_world.py <job.json> <rank>

Ranks 0–3 are the prefill slice (the committed plan
``serving_4dev_cpu_prefill``, dp 4), ranks 4–7 the decode slice
(``serving_4dev_cpu_decode``, dp 2 x tp 2). Every process loads the job's
artifact through ``WeightStore``, builds the ``DisaggPipeline`` over the
two slices and runs the job's prompts through ``generate_many``, then the
first two through ``generate``. The decode slice then runs the mesh-KV
round trip of ``test_torch_serving_mesh_world.mesh_kv`` on its own mesh
of 4 (a stream stopped mid-way, exported and adopted back; a drain with
a deadline). Each process writes its readings to ``<out>/rank<r>.pt``.
It imports only the port (and torch, numpy), never JAX. The file holds
no tests.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.parallel.planner import load_plan
from distributed_training_tpu_torch.serving.disagg import (
    DisaggPipeline,
    WeightStore,
    engine_config_for_plan,
)
from distributed_training_tpu_torch.serving.engine import Request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_serving_mesh_world import mesh_kv  # noqa: E402

PREFILL, DECODE = "serving_4dev_cpu_prefill", "serving_4dev_cpu_decode"
PREFILL_RANKS, DECODE_RANKS = range(0, 4), range(4, 8)


def disagg_prompts(seed: int = 29, n: int = 6) -> list:
    """``n`` prompts of 4–20 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(4, 21)))
            .astype(np.int32) for _ in range(n)]


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    # A collective that waits this long has hung: fail instead.
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=120))
    try:
        store = WeightStore(job["artifact"])
        decode_plan = load_plan(DECODE)
        pipe = DisaggPipeline(store, load_plan(PREFILL), decode_plan,
                              prefill_ranks=PREFILL_RANKS,
                              decode_ranks=DECODE_RANKS, device="cpu")
        prompts = disagg_prompts()
        n = job["new_tokens"]
        out = {"rank": rank,
               "many": pipe.generate_many([
                   Request(id=f"r{i}", prompt=p, max_new_tokens=n)
                   for i, p in enumerate(prompts)]),
               "one": {f"g{i}": pipe.generate(p, n, req_id=f"g{i}")
                       for i, p in enumerate(prompts[:2])},
               "handoff": dict(pipe.handoff_stats)}
        engine = pipe.decode_engine or pipe.prefill_engine
        out["describe"] = engine.mesh.describe()
        out["gathers"] = dict(engine.gathers)
        # The engine's own collectives stay in its slice: the mesh's group
        # (lockstep, kv_export, deadline) and the dp group (dp_fetch).
        out["groups"] = {
            name: (dist.get_world_size(g), g is dist.group.WORLD)
            for name, g in (("mesh", engine._mesh_group),
                            ("dp", engine._dp_group))}
        if pipe.decode_engine is not None:
            rt = pipe.decode_engine.mesh
            out["mesh_kv"] = mesh_kv(
                pipe.model, store.params_for(rt, decode_plan, "cpu"), rt,
                dataclasses.asdict(engine_config_for_plan(decode_plan)),
                prompts, n)
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

"""One process of the spawned gloo world of 4 for
``tests/test_torch_serving_fsdp.py``.

    python tests/test_torch_serving_fsdp_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs, on the CPU, with the job's weights (the serving model
of the committed plans, biases drawn nonzero):

- ``modes``: the engine on the mesh fsdp 2 x dp 2 (``Engine(...,
  mesh=runtime)``) in four forms (batched and sequential prefill,
  ``spec_k`` 4, ``resident_k`` 4), each request's tokens; the same with
  int8 weight-only leaves (``int8``), and batched on fsdp 2 x tp 2
  (``fsdp2_tp2``, leaves split on two dims);
- ``first_decode``: every request's f32 logits at its first decode step
  (this process's rows), the fsdp gathers and their bytes over that one
  step, and the same with a planted fault (rank 1 concatenates layer
  0's gathered shards in the wrong order);
- ``weights``: this rank's blocks from ``disagg.place_params`` under a
  plan of fsdp 2 x dp 2 and from the engine's ``_rank_params``;
- ``gates``: ``compile_verify_serving`` on the committed
  ``serving_4dev_cpu_decode`` and ``serving_4dev_cpu_prefill`` plans,
  over the same world.

It writes its readings to ``<out>/rank<r>.pt``. It imports only the port
(and torch, numpy), never JAX. The file holds no tests.
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

from distributed_training_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.parallel import planner
from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime
from distributed_training_tpu_torch.serving import disagg
from distributed_training_tpu_torch.serving import engine as eng_mod
from distributed_training_tpu_torch.train.optimizer import flatten, unflatten

MESH = {"dp": 2, "fsdp": 2}
MODES = {"batched": {},
         "sequential": {"prefill_mode": "sequential"},
         "spec_k_4": {"spec_k": 4},
         "resident_k_4": {"resident_k": 4}}
# Per dp group: 4 slots, each able to hold a whole sequence (8 pages of
# 8 tokens).
ENGINE = dict(max_batch=8, page_size=8, num_pages=33, max_seq_len=64,
              prefill_chunk=8)
NEW_TOKENS = 8
# The plan of the mesh fsdp 2 x dp 2 for the committed decode target's
# model (its budget widened so the candidate is feasible).
CANDIDATE = planner.Candidate(1, 2, 2, 1, 1, "none", 16)


def target() -> planner.PlanTarget:
    return dataclasses.replace(
        planner.PLAN_TARGETS["serving_4dev_cpu_decode"],
        name="serving_fsdp2_dp2", hbm_gib=1.0)


def prompts(seed: int = 17, n: int = 8) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 30)))
            .astype(np.int32) for _ in range(n)]


def run(engine, new_tokens: int = NEW_TOKENS) -> dict:
    """The prompts through ``engine`` to the end: each request's tokens."""
    for i, p in enumerate(prompts()):
        engine.submit(eng_mod.Request(id=f"r{i}", prompt=p,
                                      max_new_tokens=new_tokens))
    engine.run_until_drained()
    return {r["id"]: r["tokens"] for r in engine.completed}


def first_decode(engine) -> dict:
    """Every request's f32 logits at its first decode step (this
    process's rows), and the fsdp gathers and bytes of that one step."""
    for i, p in enumerate(prompts()):
        engine.submit(eng_mod.Request(id=f"r{i}", prompt=p,
                                      max_new_tokens=2))
    while engine.queue or any(s is not None and not s.prefill_done
                              for s in engine.slots):
        engine.step()
    gathers, traffic = dict(fsdp.GATHERS), dict(fsdp.TRAFFIC)
    engine.logits_sink = []
    engine.step()
    (ids, logits), = engine.logits_sink
    return {"logits": {i: row.clone() for i, row in zip(ids, logits)
                       if i is not None},
            "gathers": {k: n - gathers.get(k, 0)
                        for k, n in fsdp.GATHERS.items()
                        if n != gathers.get(k, 0)},
            "gathered_bytes": fsdp.TRAFFIC["gathered_bytes"]
            - traffic.get("gathered_bytes", 0),
            "decode_launches": engine.decode_launches}


class SwapLayer0Halves(eng_mod._FsdpWeights):
    """The planted fault: layer 0's gathered shards concatenated in the
    wrong order."""

    def layer(self, layer, i):
        out = super().layer(layer, i)
        if i != 0:
            return out
        for g, n, m, d in self.layer_parts:
            w = out[g][n] if m is None else out[g][n][m]
            w = torch.cat(list(reversed(w.chunk(2, d))), d)
            if m is None:
                out[g][n] = w
            else:
                out[g][n] = {**out[g][n], m: w}
        return out


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        model = Transformer(TransformerConfig(**job["model"]), device="cpu")
        params = unflatten(torch.load(job["params"]))
        rt = slice_runtime([MeshSpec(**MESH)], "cpu")
        out = {"rank": rank, "describe": rt.describe(), "modes": {}}
        for mode, over in MODES.items():
            eng = eng_mod.Engine(model, params,
                                 eng_mod.EngineConfig(**ENGINE, **over),
                                 mesh=rt, device="cpu")
            out["modes"][mode] = {"tokens": run(eng),
                                  "pages_left": eng.cache.pages_used,
                                  "gathers": dict(eng.gathers)}
        out["int8"] = run(eng_mod.Engine(
            model, disagg.quantize_params_int8(params),
            eng_mod.EngineConfig(**ENGINE), mesh=rt, device="cpu"))
        out["first_decode"] = first_decode(eng_mod.Engine(
            model, params, eng_mod.EngineConfig(**ENGINE), mesh=rt,
            device="cpu"))
        faulty = eng_mod.Engine(model, params, eng_mod.EngineConfig(**ENGINE),
                                mesh=rt, device="cpu")
        if rank == 1:
            faulty._fsdp.__class__ = SwapLayer0Halves
        out["first_decode_fault"] = first_decode(faulty)["logits"]
        plan = planner.build_plan(target(), CANDIDATE)
        out["weights"] = {
            "placed": flatten(disagg.place_params(params, rt, plan)),
            "rank_params": flatten(eng_mod._rank_params(params, model, rt)),
            "layout": eng_mod.weight_layout(model, rt),
            "plan_shardings": flatten(disagg.plan_shardings(plan, rt,
                                                            params))}
        out["gates"] = {
            name: disagg.compile_verify_serving(
                planner.PLAN_TARGETS[name], planner.load_plan(name), "cpu")
            for name in ("serving_4dev_cpu_decode",
                         "serving_4dev_cpu_prefill")}
        rt2 = slice_runtime([MeshSpec(fsdp=2, tp=2)], "cpu")
        out["fsdp2_tp2"] = run(eng_mod.Engine(
            model, params,
            eng_mod.EngineConfig(**{**ENGINE, "num_pages": 65}),
            mesh=rt2, device="cpu"))
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

"""One process of a spawned gloo world for ``tests/test_torch_serving_mesh.py``.

    python tests/test_torch_serving_mesh_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job, builds the port's ``Runtime`` over the job's mesh (``dp`` x
``tp``, gloo, on the CPU) and runs every scenario of the job through
``Engine(..., mesh=runtime)``, each process given the same submissions
in the same order. It writes its readings to ``<out>/rank<r>.pt``:

- ``modes``: for batched and sequential prefill, ``spec_k`` 4 and
  ``resident_k`` 4, the tokens and group of every completed request,
  the pages left in each group after the drain, the ``group_*`` fields
  the step records carried, and the collectives the run launched beside
  the engine's launch counts;
- ``burst``: the JAX engine's skewed arrival burst, the slots active per
  group once all of it is admitted;
- ``composition``: 9 prompts batched, then three of them alone;
- ``weights``: whether this rank's weight slices equal the ones the
  port's ``tp`` trainer holds on the same mesh;
- ``lockstep``: the last rank is given one extra submission; every rank
  must raise at the first step (the message, or None);
- ``lifecycle``: the batched tokens of an engine on int8 weight-only
  leaves, with this rank's ``qw``/``scale`` shapes and weight bytes; the
  batched run again with an identical-value ``swap_weights`` mid-stream,
  then ``preempt`` and a resubmission, then ``drain``, every call in
  lock-step; and dense KV on the mesh: a stream stopped mid-way,
  exported (``export_in_flight``) and adopted back (``adopt_batch``),
  then a drain with a deadline and its persisted work adopted back.

It imports only the port (and torch, numpy), never JAX: the parent holds
the results against the port's one-process engine and the JAX engine.
The file holds no tests.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch import config as port_config
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data.datasets import SyntheticLMDataset
from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.parallel import tensor as tp_lib
from distributed_training_tpu_torch.runtime import initialize_runtime
from distributed_training_tpu_torch.serving.disagg import (
    _QUANT_AXES,
    quantize_params_int8,
)
from distributed_training_tpu_torch.serving.engine import (
    Engine,
    EngineConfig,
    Request,
)
from distributed_training_tpu_torch.train.optimizer import (
    flatten,
    unflatten,
)
from distributed_training_tpu_torch.train.trainer import Trainer

# The engine forms every world runs, as EngineConfig overrides.
MODES = {"batched": {},
         "sequential": {"prefill_mode": "sequential"},
         "spec_k_4": {"spec_k": 4},
         "resident_k_4": {"resident_k": 4}}


def mesh_prompts(seed: int = 17, n: int = 12) -> list:
    """The JAX sharded-engine test's prompts: ``n`` of 3–24 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 24)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng) -> dict:
    eng.run_until_drained()
    recs = {r["id"]: r for r in eng.completed}
    eng.completed.clear()
    return recs


def _serve(eng, prompts: list, new_tokens: int, prefix: str) -> dict:
    for i, p in enumerate(prompts):
        eng.submit(Request(id=f"{prefix}{i}", prompt=p,
                           max_new_tokens=new_tokens))
    return _drain(eng)


def _mode(model, params, rt, ecfg: dict, over: dict, prompts: list,
          new_tokens: int) -> dict:
    eng = Engine(model, params, EngineConfig(**ecfg, **over), mesh=rt,
                 device="cpu")
    eng.warmup()
    tp_lib.ALL_REDUCES.clear()
    tp_lib.ALL_GATHERS.clear()
    steps = []
    step = eng.step

    def recorded():
        rec = step()
        steps.append({k: rec[k] for k in ("group_slots_active",
                                          "group_prefill_slots_active",
                                          "kv_pages_shared") if k in rec})
        return rec
    eng.step = recorded
    recs = _serve(eng, prompts, new_tokens, "r")
    return {"tokens": {k: r["tokens"] for k, r in recs.items()},
            "groups": {k: r["group"] for k, r in recs.items()},
            "pages_left": [eng.cache.pages_used_in(g)
                           for g in range(eng.dp_groups)],
            "steps": steps, "n_steps": len(steps),
            "prefill_launches": eng.prefill_launches,
            "decode_launches": eng.decode_launches,
            "host_syncs": eng.host_syncs, "gathers": dict(eng.gathers),
            "all_reduces": dict(tp_lib.ALL_REDUCES),
            "all_gathers": dict(tp_lib.ALL_GATHERS),
            "pool_shape": list(eng.cache.k_pages.shape),
            "kv_heads": list(eng.cache.kv_heads),
            "local_group": eng.cache.local_group,
            "batch_local": eng.batch_local}


def _burst(eng) -> dict:
    """JAX's test_admission_balances_skewed_arrival_burst: 2 requests a
    group at once, one admission a step."""
    G = eng.dp_groups
    rng = np.random.default_rng(29)
    n = 2 * G
    for i in range(n):
        eng.submit(Request(id=f"burst{i}",
                           prompt=rng.integers(0, 256, size=6)
                           .astype(np.int32), max_new_tokens=4))
    for _ in range(3 * n):
        if eng.in_flight == n:
            break
        eng.step()
    active = eng.slots_active_by_group()
    recs = _drain(eng)
    return {"in_flight": n, "active": active,
            "groups": sorted(r["group"] for r in recs.values()),
            "pages_left": [eng.cache.pages_used_in(g) for g in range(G)]}


def _composition(eng) -> dict:
    """JAX's test_batch_composition_independence_across_groups: 9
    prompts batched, then prompts 2, 5 and 8 alone on the same engine."""
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, 256, size=int(rng.integers(4, 16)))
               .astype(np.int32) for _ in range(9)]
    batched = _serve(eng, prompts, 6, "b")
    solo = {}
    for i in (2, 5, 8):
        eng.submit(Request(id=f"solo{i}", prompt=prompts[i],
                           max_new_tokens=6))
        r = _drain(eng)[f"solo{i}"]
        solo[i] = {"tokens": r["tokens"], "group": r["group"]}
    return {"batched": {int(k[1:]): {"tokens": r["tokens"],
                                     "group": r["group"]}
                        for k, r in batched.items()},
            "solo": solo}


def _weights_match_trainer(job: dict, rt, model, params, eng) -> bool:
    """The engine's weight slices against the port's tp trainer's shards
    of the same whole weights on the same mesh."""
    cfg = port_config.Config()
    for k, v in {"device": "cpu", "parallel_strategy": "tp",
                 "batch_size": 2, "dtype": "float32"}.items():
        setattr(cfg.train, k, v)
    ds = SyntheticLMDataset(size=8, seq_len=16, vocab_size=256, seed=0)
    loader = ShardedDataLoader(ds, rt, batch_size=2, seed=0)
    trainer = Trainer(cfg, rt, model, loader, params=params)
    mine = flatten(eng.params)
    theirs = flatten(trainer.state["params"])
    model.bind_tensor_parallel(None)
    return set(mine) == set(theirs) and all(
        torch.equal(mine[k], theirs[k].detach()) for k in mine)


def _lockstep(model, params, rt, ecfg: dict, rank: int, world: int):
    eng = Engine(model, params, EngineConfig(**ecfg), mesh=rt, device="cpu")
    for i, p in enumerate(mesh_prompts(5, 4)):
        eng.submit(Request(id=f"l{i}", prompt=p, max_new_tokens=4))
    if rank == world - 1:
        eng.submit(Request(id="extra", prompt=np.arange(1, 5, dtype=np.int32),
                           max_new_tokens=4))
    try:
        eng.run_until_drained()
    except RuntimeError as e:
        return str(e)
    return None


def _lifecycle(model, params, rt, ecfg: dict, prompts: list,
               new_tokens: int) -> dict:
    out: dict = {}
    eng = Engine(model, quantize_params_int8(params), EngineConfig(**ecfg),
                 mesh=rt, device="cpu")
    out["int8"] = {k: r["tokens"] for k, r in
                   _serve(eng, prompts, new_tokens, "r").items()}
    out["int8_shapes"] = {
        f"{g}/{n}": {part: list(eng.params[g][n][part].shape)
                     for part in ("qw", "scale")} for g, n in _QUANT_AXES}
    out["int8_weight_bytes"] = eng.weight_bytes
    eng = Engine(model, params, EngineConfig(**ecfg), mesh=rt, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(id=f"r{i}", prompt=p, max_new_tokens=new_tokens))
    for _ in range(3):
        eng.step()
    eng.swap_weights(unflatten({k: t.clone()
                                for k, t in flatten(params).items()}), "v1")
    for _ in range(2):
        eng.step()
    lost = eng.preempt()
    for r in lost:
        eng.submit(r)
    eng.step()
    report = eng.drain()
    eng.draining = False
    eng.run_until_drained()
    out["swap"] = {"tokens": {r["id"]: r["tokens"] for r in eng.completed},
                   "versions": {r["id"]: r["weights_versions"]
                                for r in eng.completed},
                   "lost": [r.id for r in lost],
                   "drained": sorted(report["finished"]
                                     + report["requeued"]),
                   "requeued": report["requeued"],
                   "persisted": report["persisted"],
                   "swap_stats": dict(eng.swap_stats),
                   "pages_left": [eng.cache.pages_used_in(g)
                                  for g in range(eng.dp_groups)]}
    out["mesh_kv"] = mesh_kv(model, params, rt, ecfg, prompts, new_tokens)
    return out


def _resume(eng, persisted: dict) -> dict:
    """Adopt ``persisted`` (an ``export_in_flight``) back, resubmit its
    fresh requests and run to the end: every request's tokens."""
    eng.draining = False
    eng.adopt_batch(persisted["adoptable"])
    for r in persisted["requests"]:
        eng.submit(r)
    eng.run_until_drained()
    return {r["id"]: r["tokens"] for r in eng.completed}


def mesh_kv(model, params, rt, ecfg: dict, prompts: list,
            new_tokens: int) -> dict:
    """Dense KV on the mesh, in lock-step: a stream stopped after four
    steps, exported and adopted back; then a drain with a deadline (the
    first process's clock) and its persisted work adopted back."""
    out = {}
    for name, stop in (("export", lambda e: e.export_in_flight()),
                       ("deadline", lambda e: e.drain(deadline_s=0.0))):
        eng = Engine(model, params, EngineConfig(**ecfg), mesh=rt,
                     device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(id=f"r{i}", prompt=p,
                               max_new_tokens=new_tokens))
        for _ in range(4):
            eng.step()
        got = stop(eng)
        persisted = got.get("export", got)
        out[name] = {"adopted": sorted(it[0].id
                                       for it in persisted["adoptable"]),
                     "fresh": sorted(r.id for r in persisted["requests"]),
                     "persisted": got.get("persisted"),
                     "tokens": _resume(eng, persisted),
                     "gathers": dict(eng.gathers)}
    return out


def main(job_path: str, rank: int) -> int:
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    # A collective that waits this long has hung: fail instead.
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=job["world"],
                            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = port_config.Config()
        cfg.train.device = "cpu"
        for k, v in job["mesh"].items():
            setattr(cfg.mesh, k, v)
        rt = initialize_runtime(cfg)
        model = port_tf.Transformer(port_tf.TransformerConfig(**job["model"]),
                                    device="cpu")
        params = unflatten(torch.load(job["params"], weights_only=True))
        prompts = mesh_prompts()
        out = {"rank": rank, "modes": {}}
        for name, over in MODES.items():
            out["modes"][name] = _mode(model, params, rt, job["engine"], over,
                                       prompts, job["new_tokens"])
        eng = Engine(model, params, EngineConfig(**job["engine"]), mesh=rt,
                     device="cpu")
        eng.warmup()
        out["burst"] = _burst(eng)
        out["composition"] = _composition(eng)
        out["weights_match_trainer"] = _weights_match_trainer(
            job, rt, model, params, eng)
        out["lockstep"] = _lockstep(model, params, rt, job["engine"], rank,
                                    job["world"])
        out["lifecycle"] = _lifecycle(model, params, rt, job["engine"],
                                      prompts, job["new_tokens"])
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

"""One process of a spawned gloo world for ``tests/test_torch_sharded.py``
and ``tests/test_torch_tp.py``.

    python tests/test_torch_sharded_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job, then runs every run of the job on the CPU and writes, from
process 0, each run's results to ``<out>/<run>.pt``: a training run
(through the port's Trainer: tiny model, float32, the parent's init
weights of the run's model variant) its metrics rows and whole final
params; a ``tp_ops`` run the tensor-parallel collectives' outputs and
gradients on ``tp_ops_inputs``. It imports only the port (and torch,
numpy), never JAX: the parent holds the results against the JAX trainer
and the port's whole-vocab ops. The file holds no tests.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
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
from distributed_training_tpu_torch.ops.xent import lm_cross_entropy
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.parallel import tensor as tp_lib
from distributed_training_tpu_torch.parallel.strategy import (
    get_strategy,
    layout as strategy_layout,
)
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
    variant = run.get("variant", "")
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **job["model"], **job["variants"].get(variant, {})), device="cpu")
    ds = SyntheticLMDataset(**{**job["dataset"], **run.get("dataset", {})})
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=cfg.train.seed)
    init = {k: v.clone() for k, v in torch.load(
        job["init"][variant], weights_only=True).items()}
    return Trainer(cfg, rt, model, loader, checkpointer,
                   preemption_guard=guard, params=unflatten(init))


def _whole_params(trainer) -> dict:
    flat = flatten(trainer.state["params"])
    return {k: v.detach().clone() for k, v in fsdp.gather_full(
        flat, trainer.layout["params"], trainer.rt).items()}


def tp_ops_inputs(seed: int = 3) -> dict:
    """The inputs of a ``tp_ops`` run (numpy, float32): hidden states
    ``x`` (B, S, D), a head (D, V), targets with masked (-1) ids, an
    embedding table (V, D) and ids, and the weights ``w`` of each loss;
    ``scale`` (D,) weighs the collectives' check."""
    rng = np.random.default_rng(seed)
    B, S, D, V = 2, 24, 16, 64
    t = rng.integers(0, V, (B, S))
    t[0, :3] = -1
    t[1, -2:] = -1
    f32 = np.float32
    return {"x": rng.standard_normal((B, S, D)).astype(f32),
            "head": (0.5 * rng.standard_normal((D, V))).astype(f32),
            "targets": t, "w": rng.standard_normal((B, S)).astype(f32),
            "table": rng.standard_normal((V, D)).astype(f32),
            "ids": rng.integers(0, V, (B, S)),
            "emb_w": rng.standard_normal((B, S, D)).astype(f32),
            "scale": rng.standard_normal(D).astype(f32)}


# The model ``Transformer.apply`` runs under the tp binding in a
# ``tp_ops`` run (tp 2 splits its heads, MLP width and vocab), and the
# tokens it reads.
TP_APPLY_MODEL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                      max_seq_len=12, dtype="float32")


def tp_apply_tokens(seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, (2, 12))


def _tp_ops(job: dict, run: dict) -> dict:
    """The vocab-parallel cross-entropy and embedding on this rank's
    columns and rows of ``tp_ops_inputs``, and ``copy_to_tp`` /
    ``reduce_from_tp`` on rank-weighted inputs, over the tp group of
    ``run["mesh"]``; their whole results (gathered over the group) and
    the all-reduces each launched. Then ``Transformer.apply`` of
    ``TP_APPLY_MODEL`` (weights from seed 0) on this rank's blocks of
    the weights: its logits over the whole vocab."""
    cfg = port_config.Config()
    cfg.train.device = "cpu"
    for k, v in run["mesh"].items():
        setattr(cfg.mesh, k, v)
    rt = initialize_runtime(cfg)
    tp = tp_lib.TPGroup(rt.group(("tp",)))
    inp = {k: torch.from_numpy(v) for k, v in tp_ops_inputs().items()}
    tp_lib.ALL_REDUCES.clear()

    def cols(t, dim):
        n = t.shape[dim] // tp.size
        return t.narrow(dim, tp.rank * n, n).clone().requires_grad_(True)

    def whole(t, dim):
        parts = [torch.empty_like(t) for _ in range(tp.size)]
        dist.all_gather(parts, t.contiguous(), group=tp.group)
        return torch.cat(parts, dim)

    x = inp["x"].clone().requires_grad_(True)
    head = cols(inp["head"], 1)
    nll = lm_cross_entropy(tp.copy(x), head, inp["targets"], chunk_rows=16,
                           group=tp.group,
                           vocab_start=tp.rank * head.shape[1])
    (nll * inp["w"]).sum().backward()
    table = cols(inp["table"], 0)
    emb = tp.embed(table, inp["ids"])
    (emb * inp["emb_w"]).sum().backward()
    # reduce_from_tp sums rank r's (r + 1) * y; copy_to_tp's gradient
    # sums rank r's (r + 1) * scale.
    y = inp["x"].clone().requires_grad_(True)
    reduced = tp.reduce(y * (tp.rank + 1))
    (reduced * inp["scale"]).sum().backward()
    z = inp["x"].clone().requires_grad_(True)
    (tp.copy(z) * inp["scale"] * (tp.rank + 1)).sum().backward()
    out = {"tp": tp.size, "nll": nll.detach(), "dx": x.grad,
           "dhead": whole(head.grad, 1), "emb": emb.detach(),
           "dtable": whole(table.grad, 0), "reduced": reduced.detach(),
           "dy": y.grad, "dz": z.grad,
           "all_reduces": dict(tp_lib.ALL_REDUCES)}
    model = port_tf.Transformer(port_tf.TransformerConfig(**TP_APPLY_MODEL),
                                device="cpu")
    lay = strategy_layout(get_strategy("tp", rt.spec, min_shard_elems=0),
                          flatten(model.param_shapes()),
                          flatten(model.logical_axes()))
    local = unflatten({k: fsdp.shard(w, lay["params"][k], rt)
                       for k, w in flatten(model.init(0)).items()})
    model.bind_tensor_parallel(tp)
    out["apply"] = model.apply(local, tp_apply_tokens())[0]
    return out


def _run(job: dict, run: dict, rank: int) -> dict:
    kind = run.get("kind", "train")
    if kind == "tp_ops":
        return _tp_ops(job, run)
    if kind == "train":
        tp_lib.ALL_REDUCES.clear()
        trainer = _trainer(job, run)
        trainer.train()
        return {"rows": trainer.metrics.history,
                "params": _whole_params(trainer),
                "all_reduces": dict(tp_lib.ALL_REDUCES)}
    if kind == "drift":
        # Rank 1 perturbs its replica of one weight after step 3: the
        # next checks must see it.
        trainer = _trainer(job, run)
        step = trainer.train_step
        top, _, name = run.get("leaf", "tok_embed").partition("/")

        def planted(batch):
            m = step(batch)
            if trainer.global_step == 3 and rank == 1:
                leaf = trainer.state["params"][top]
                with torch.no_grad():
                    (leaf[name] if name else leaf).view(-1)[0] += 1e-3
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

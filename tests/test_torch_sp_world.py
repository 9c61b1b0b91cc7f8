"""One process of the spawned gloo world of 4 for
``tests/test_torch_ring.py`` and ``tests/test_torch_ulysses.py``.

    python tests/test_torch_sp_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs, on the CPU, every case of the job:

- an ``attn`` case: ring or Ulysses attention on this process's block of
  the job's global inputs (its data shard's rows, its ``sp`` slice of
  the sequence, its ``tp`` block of the heads), then its backward on the
  same block of the upstream gradient; every process writes its output,
  its input gradients and the shapes of the tensors autograd saved to
  ``<out>/<case>.rank<r>.pt``;
- a ``train`` case: the port's Trainer on the case's mesh (tiny model,
  float32, the case's init weights from the parent), optionally saving
  or resuming a checkpoint; process 0 writes the metric rows and the
  whole final params to ``<out>/<case>.pt``.

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
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.parallel import ring_attention as ring_module
from distributed_training_tpu_torch.parallel.ring_attention import (
    SPGroup,
    ring_attention,
)
from distributed_training_tpu_torch.parallel.ulysses import ulysses_attention
from distributed_training_tpu_torch.runtime import (
    MeshSpec,
    initialize_runtime,
    slice_runtime,
)
from distributed_training_tpu_torch.train.optimizer import (
    flatten,
    unflatten,
)
from distributed_training_tpu_torch.train.trainer import Trainer


class MaskedLMDataset(SyntheticLMDataset):
    """``SyntheticLMDataset`` rows whose tail is masked: row ``i`` ends
    in ``tail(i)`` ids of -1, so its last targets are padding. Padding
    sits only at the end of a row, so under causal attention no live
    target reads it; the rows' live-target counts differ, across data
    shards and across a row's sequence slices."""

    def batch(self, indices: np.ndarray) -> dict:
        out = super().batch(indices)
        toks = np.array(out["tokens"])
        L = toks.shape[1]
        for r, i in enumerate(np.asarray(indices)):
            tail = int(i) * 7 % (L // 2)
            if tail:
                toks[r, L - tail:] = -1
        return {**out, "tokens": toks}


DATASETS = {"synthetic_lm": SyntheticLMDataset, "masked_lm": MaskedLMDataset}


def _block(x: np.ndarray, rt, heads: bool = True) -> torch.Tensor:
    """This process's block of a global (B, S, H, D) array: its data
    shard's rows, its sp slice of the sequence, its tp block of the
    heads."""
    spec = rt.spec
    n, d = rt.data_shard_count, rt.data_shard_index
    b = x.shape[0] // n
    s = x.shape[1] // spec.sp
    i = rt.seq_shard_index
    x = x[d * b:(d + 1) * b, i * s:(i + 1) * s]
    if heads and spec.tp > 1:
        h = x.shape[2] // spec.tp
        t = rt.mesh.get_local_rank("tp")
        x = x[:, :, t * h:(t + 1) * h]
    return torch.from_numpy(np.ascontiguousarray(x))


def _attn(case: dict, rt, out: str, rank: int) -> None:
    inputs = np.load(case["inputs"])
    dt = getattr(torch, case["dtype"])
    q, k, v = (_block(inputs[n], rt).to(dt).requires_grad_()
               for n in ("q", "k", "v"))
    do = _block(inputs["do"], rt).to(dt)
    sp = SPGroup(rt.group(("sp",)))
    kw = dict(causal=case["causal"], window=case["window"])
    saved: list = []

    def pack(t):
        saved.append(list(t.shape))
        return t

    # "flash": the ring's blocks forced through the kernels' wrappers.
    force = (mock.patch.object(ring_module, "_use_flash", return_value=True)
             if case["flash"] else contextlib.nullcontext())
    # The shapes of every tensor autograd saves for the backward.
    with force, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if case["impl"] == "ring":
            o = ring_attention(q, k, v, sp, **kw)
        else:
            o = ulysses_attention(q, k, v, sp, **kw)
    o.backward(do)
    torch.save({"out": o.detach().float(), "dq": q.grad.float(),
                "dk": k.grad.float(), "dv": v.grad.float(),
                "saved": saved},
               os.path.join(out, f"{case['name']}.rank{rank}.pt"))


def _train(job: dict, case: dict, out: str) -> None:
    cfg = port_config.Config()
    for key, val in {**job["train"], **case.get("train", {})}.items():
        setattr(cfg.train, key, val)
    for key, val in case["mesh"].items():
        setattr(cfg.mesh, key, val)
    rt = initialize_runtime(cfg)
    model = port_tf.Transformer(port_tf.TransformerConfig(
        **job["model"], **case.get("model", {})), device="cpu")
    dset = case.get("dataset", {})
    ds = DATASETS[dset.get("kind", "synthetic_lm")](
        **{**job["dataset"], **{k: v for k, v in dset.items()
                                if k != "kind"}})
    loader = ShardedDataLoader(ds, rt, batch_size=cfg.train.batch_size,
                               seed=cfg.train.seed, shuffle=False)
    ckpt = case.get("ckpt")
    checkpointer = Checkpointer(ckpt, runtime=rt) if ckpt else None
    init = {k: v.clone() for k, v in torch.load(
        case["init"], weights_only=True).items()}
    trainer = Trainer(cfg, rt, model, loader, checkpointer,
                      params=unflatten(init))
    trainer.train()
    whole = fsdp.gather_full(flatten(trainer.state["params"]),
                             trainer.layout["params"], rt)
    if rt.is_coordinator:
        torch.save({"rows": trainer.metrics.history,
                    "step": trainer.state["step"],
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
        runtimes: dict = {}
        for case in job["cases"]:
            if case["kind"] == "attn":
                key = tuple(sorted(case["mesh"].items()))
                if key not in runtimes:
                    runtimes[key] = slice_runtime(
                        [MeshSpec(**case["mesh"])], torch.device("cpu"))
                _attn(case, runtimes[key], job["out"], rank)
            else:
                _train(job, case, job["out"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

"""One process of the spawned gloo world of 4 for
``tests/test_torch_pipeline.py``.

    python tests/test_torch_pp_world.py <job.json> <rank>

Each process joins the world through a ``file://`` rendezvous named by
the job and runs, on the CPU, every case of the job:

- a ``pipe`` case: ``pipeline_apply`` over the ``pp`` group of the
  case's mesh on the job's inputs (a tanh layer stack whose aux is the
  sum of squares of every layer's output), then the backward of
  ``sum(out * g) + c * aux``; every process writes its output, aux, its
  partial gradients, the (microbatch, virtual stage) keys and shapes of
  the inputs its pipeline saved, and the count of tensors autograd
  saved during the forward to ``<out>/<case>.rank<r>.pt``;
- a ``dropout`` case: the port's transformer bound to the ``pp`` group
  of the case's mesh, its loss (no gradients) with dropout for each of
  the case's (rate, microbatches); process 0 writes them;
- a ``train`` case: ``test_torch_sp_world``'s (the port's Trainer on the
  case's mesh).

It imports only the port (and torch, numpy), never JAX. The file holds
no tests.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.parallel.pipeline import (
    PPGroup,
    pipeline_apply,
)
from distributed_training_tpu_torch.runtime import MeshSpec, slice_runtime
from distributed_training_tpu_torch.train.optimizer import unflatten

from test_torch_sp_world import _train


def tanh_stack(stage_params: dict, layer_ids, x, mb_idx) -> tuple:
    """JAX's ``test_pipeline_apply_matches_sequential`` body: each layer
    ``tanh(x @ w + b)``, the aux the sum of squares of each output."""
    aux = torch.zeros((), dtype=torch.float32)
    for i in range(len(layer_ids)):
        x = torch.tanh(x @ stage_params["w"][i] + stage_params["b"][i])
        aux = aux + (x ** 2).sum()
    return x, aux


def _pipe(case: dict, rt, out: str, rank: int) -> None:
    inputs = np.load(case["inputs"])
    w, b, x = (torch.from_numpy(inputs[n]).requires_grad_()
               for n in ("w", "b", "x"))
    pp = PPGroup(rt.group(("pp",)))
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o, aux = pipeline_apply(tanh_stack, {"w": w, "b": b}, x, pp,
                                case["microbatches"], case["schedule"],
                                case["virtual_stages"])
    saved = {f"{m},{s}": list(t.shape)
             for (m, s), t in o.grad_fn.pipe.saved.items()}
    loss = (o * torch.from_numpy(inputs["g"])).sum() + case["c"] * aux
    loss.backward()
    torch.save({"out": o.detach(), "aux": aux.detach(), "dx": x.grad,
                "dw": w.grad, "db": b.grad, "saved": saved,
                "autograd_saved": count[0]},
               os.path.join(out, f"{case['name']}.rank{rank}.pt"))


def _dropout(job: dict, case: dict, rt, out: str) -> None:
    tokens = torch.from_numpy(np.load(case["tokens"]))
    init = unflatten({k: v.clone() for k, v in torch.load(
        case["init"], weights_only=True).items()})
    losses = []
    for rate, microbatches in case["runs"]:
        model = port_tf.Transformer(port_tf.TransformerConfig(
            **{**job["model"], **case.get("model", {}), "dropout": rate,
               "pp_microbatches": microbatches}), device="cpu")
        model.bind_pipeline(PPGroup(rt.group(("pp",))), rt.data_shard_count)
        with torch.no_grad():
            loss, _ = model.loss(init, {"tokens": tokens}, rng=case["rng"],
                                 train=True)
        losses.append(float(loss))
    if rt.is_coordinator:
        torch.save(losses, os.path.join(out, f"{case['name']}.pt"))


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
            if case["kind"] == "train":
                _train(job, case, job["out"])
                continue
            key = tuple(sorted(case["mesh"].items()))
            if key not in runtimes:
                runtimes[key] = slice_runtime(
                    [MeshSpec(**case["mesh"])], torch.device("cpu"))
            if case["kind"] == "pipe":
                _pipe(case, runtimes[key], job["out"], rank)
            else:
                _dropout(job, case, runtimes[key], job["out"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))

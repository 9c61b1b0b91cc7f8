"""DDP from collective primitives (port of
``playground/ddp_from_primitives.py``).

The reference's pedagogical recipe (src/playground/ddp_script.py,
SURVEY.md §3.2), one process per rank over ``torch.distributed``:

1. the same seed on every rank;
2. the params broadcast from rank 0 (``dist.broadcast``);
3. the dataset sharded by rank (the production sampler's strided
   arithmetic, ``data/sampler.py``);
4. a local forward and backward, then per parameter
   ``all_reduce(SUM) / world_size``;
5. the same SGD step on every rank;
6. optional per-rank gradient and weight norms (``--log-norms``).

The JAX package runs the ranks as devices of one process under
``shard_map``; here each rank is a process, as in the reference.

    python -m distributed_training_tpu_torch.playground.ddp_from_primitives \\
        --world-size 4 --epochs 3 [--device cpu] [--log-norms]

Without ``RANK`` in its environment the CLI starts the world itself
through the local launcher (``launch/local.py``): one process per rank,
gloo, a TCP rendezvous on a free local port. Each rank writes
``<log-dir>/ddp_rank_<r>.json`` (its epoch losses and final params) and,
with ``--log-norms``, ``ddp_rank_<r>.log`` lines. Every rank runs on
``--device`` (the CUDA card unless ``cpu`` is given; gloo carries CUDA
tensors too, so several ranks may share one card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.data.sampler import DistributedShardSampler
from distributed_training_tpu_torch.runtime import make_generator, resolve_device

logger = logging.getLogger(__name__)


# -- model: SimpleModel = Linear(10, 1) (ddp_script.py:16-23) -------------


def init_params(seed: int, in_dim: int = 10, device=None) -> dict:
    """torch.nn.Linear's init, U(-1/sqrt(in_dim), 1/sqrt(in_dim)), from
    a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    bound = 1.0 / math.sqrt(in_dim)

    def draw(shape):
        return torch.rand(shape, generator=gen, device=dev) * (2 * bound) \
            - bound

    return {"w": draw((in_dim, 1)), "b": draw((1,))}


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def mse_loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((forward(params, x) - y) ** 2)  # ddp_script.py:135


# -- dataset: DummyDataset randn pairs (ddp_script.py:26-36) -------------


def make_dataset(size: int = 1000, in_dim: int = 10, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((size, in_dim)).astype(np.float32)
    y = rng.standard_normal((size, 1)).astype(np.float32)
    return x, y


# -- the per-rank program ------------------------------------------------


def _broadcast_from_rank0(params: dict) -> None:
    """(2) Seeding already makes the replicas equal (ddp_script.py:108);
    the broadcast makes sure, as the reference does (:118-121)."""
    for p in params.values():
        dist.broadcast(p, src=0)


def _rank_step(params: dict, x: torch.Tensor, y: torch.Tensor, lr: float,
               world: int) -> tuple:
    """What one rank does for one batch: the local loss and gradient,
    each gradient all-reduced (SUM) and divided by the world size, the
    loss averaged for the report, and the SGD step."""
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    loss = mse_loss(params, x, y)
    grads = torch.autograd.grad(loss, leaves)
    local = loss.detach()
    mean_loss = local.clone()
    dist.all_reduce(mean_loss)
    mean_loss /= world
    out = {}
    with torch.no_grad():
        for (k, p), g in zip(params.items(), grads):
            dist.all_reduce(g)            # (4) SUM over the ranks ...
            g /= world                    # ... then / world (Q10)
            out[k] = (p - lr * g).detach()  # (5)
    return out, mean_loss, local, grads


def train_ddp(epochs: int = 3, batch_size: int = 32, lr: float = 0.01,
              dataset_size: int = 1000, seed: int = 42,
              log_norms: bool = False, log_dir: str | None = None,
              device=None, params: dict | None = None) -> dict:
    """This rank's DDP loop over the initialized process group: returns
    its final params and its history (each epoch's mean of the
    world-averaged step losses). ``params``: whole weights to start from
    instead of the seed's draw (rank 0's are broadcast either way)."""
    dev = resolve_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    # (1) the same seed everywhere: the same init (ddp_script.py:108)
    params = ({k: torch.as_tensor(v, dtype=torch.float32).to(dev).clone()
               for k, v in params.items()} if params is not None
              else init_params(seed, device=dev))
    _broadcast_from_rank0(params)  # (2)
    x, y = make_dataset(dataset_size, seed=seed)
    # (3) this rank's shard: the production sampler's arithmetic
    sampler = DistributedShardSampler(dataset_size, world, shuffle=True,
                                      seed=seed)
    steps_per_epoch = sampler.num_samples // batch_size
    history = []
    for epoch in range(epochs):
        sampler.set_epoch(epoch)  # reshuffle (ddp_script.py:140)
        rows_all = sampler.shard_indices(rank)
        losses = []
        for s in range(steps_per_epoch):
            rows = rows_all[s * batch_size:(s + 1) * batch_size]
            xb = torch.from_numpy(x[rows]).to(dev)
            yb = torch.from_numpy(y[rows]).to(dev)
            params, mean_loss, local, grads = _rank_step(params, xb, yb, lr,
                                                         world)
            losses.append(mean_loss)
            if log_norms and log_dir:  # (6) ddp_script.py:155-164
                norms = " ".join(
                    f"|g[{k}]|={float(torch.linalg.norm(g)):.4f}"
                    for k, g in zip(params, grads))
                wnorms = " ".join(
                    f"|w[{k}]|={float(torch.linalg.norm(p)):.4f}"
                    for k, p in params.items())
                with open(os.path.join(log_dir, f"ddp_rank_{rank}.log"),
                          "a") as f:
                    f.write(f"epoch={epoch} step={s} "
                            f"local_loss={float(local):.6f} {norms} "
                            f"{wnorms}\n")
        entry = {"epoch": epoch,
                 "mean_loss": float(np.mean([float(v) for v in losses]))}
        history.append(entry)
        if rank == 0:
            logger.info("epoch %d | mean_loss %.6f", epoch,
                        entry["mean_loss"])
    return {"params": params, "history": history}


def _rank_main(args) -> int:
    """One rank of a world the launcher (or torchrun) started."""
    dev = resolve_device(args.device)
    dist.init_process_group(
        "gloo", init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=120))
    try:
        params = None
        if args.init:
            with np.load(args.init) as f:
                params = {k: f[k] for k in ("w", "b")}
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
        result = train_ddp(epochs=args.epochs, batch_size=args.batch_size,
                           lr=args.lr, dataset_size=args.dataset_size,
                           seed=args.seed, log_norms=args.log_norms,
                           log_dir=args.log_dir, device=dev, params=params)
        rank = dist.get_rank()
        if args.log_dir:
            with open(os.path.join(args.log_dir,
                                   f"ddp_rank_{rank}.json"), "w") as f:
                json.dump({"rank": rank, "world": dist.get_world_size(),
                           "device": str(dev),
                           "history": result["history"],
                           "params": {k: v.cpu().reshape(-1).tolist()
                                      for k, v in result["params"].items()}},
                          f)
        if rank == 0:
            print(f"final mean_loss: "
                  f"{result['history'][-1]['mean_loss']:.6f}")
    finally:
        dist.destroy_process_group()
    return 0


def build_argparser() -> argparse.ArgumentParser:
    # argparse CLI, as ddp_script.py:186-241
    p = argparse.ArgumentParser(
        description="DDP from collective primitives (pedagogical)")
    p.add_argument("--world-size", type=int, default=2,
                   help="ranks: processes started through the local "
                        "launcher (ignored under RANK/WORLD_SIZE)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--dataset-size", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-norms", action="store_true",
                   help="per-rank grad/weight norm lines (off by default: "
                        "instrumentation)")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--device", default=None,
                   help="'cpu' to run every rank on the CPU (default: the "
                        "CUDA card)")
    p.add_argument("--init", default=None,
                   help=".npz with 'w' (10, 1) and 'b' (1,) to start from "
                        "instead of the seed's draw")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _rank_main(args)
    from distributed_training_tpu_torch.launch.local import run_group

    rc = run_group(
        ["-m", "distributed_training_tpu_torch.playground."
               "ddp_from_primitives", *argv], args.world_size,
        log_dir=os.path.join(args.log_dir, "launch")).returncode
    if rc == 0:
        with open(os.path.join(args.log_dir, "ddp_rank_0.json")) as f:
            history = json.load(f)["history"]
        print(f"final mean_loss: {history[-1]['mean_loss']:.6f}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

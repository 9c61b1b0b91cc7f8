"""Micro-benchmarks that fill a CalibrationTable (port of
``calibration/microbench.py``).

Measures, in this process (and, for the collectives, over the world's
process group):

- each collective kind the planner prices (``table.COLLECTIVE_KINDS``)
  across a ladder of message sizes, as ``torch.distributed`` calls over
  the world's group. Inputs are shaped so that each timed op moves JAX's
  accounted bytes (``accounted_rows``, the convention of ``table.py``);
- dense f32 matmul across a ladder of square shapes: the achievable-FLOPs
  curve, ``2n³`` FLOPs a point.

Timing: one untimed warm-up call (kernel selection, first-touch
allocation), then ``iters`` back-to-back calls timed as one span: by
CUDA events on the card, by the host clock on the CPU. Each point
records seconds per op.

Over gloo between processes on one card the collectives measure the
host's copies and sockets, not a link: no collective curve measured that
way describes a card, and none is committed.

    python -m distributed_training_tpu_torch.calibration.microbench \\
        --device cpu --world 2 --out /tmp/cpu_table.json
    python -m distributed_training_tpu_torch.calibration.microbench \\
        --matmul-only            # the matmul ladder on the card
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

from distributed_training_tpu_torch.calibration.table import (
    COLLECTIVE_KINDS,
    CalibrationTable,
    save_table,
)

# Message-size ladder (accounted bytes): JAX's.
DEFAULT_SIZES = (1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 23)

# Square matmul edge sizes; flops = 2 * n^3.
DEFAULT_MATMUL_SIZES = (256, 512, 1024, 2048)


def accounted_rows(kind: str, nbytes: float, n: int) -> int:
    """The f32 elements of the GLOBAL tensor JAX's builder makes for
    ``kind`` at ``nbytes`` accounted bytes over ``n`` devices
    (``_collective_fns``): a whole multiple of ``n``, at least ``n``.
    all-gather: the gathered tensor; reduce-scatter: the reduced one;
    all-reduce: the tensor, half the accounted bytes (the ring's two
    phases); ppermute: ``n`` shards of the bytes each device ships."""
    scale = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 0.5,
             "ppermute": float(n)}[kind]
    return max(n, int(nbytes * scale) // 4 // n * n)


def _local_shapes(kind: str, nbytes: float, n: int) -> tuple[int, int]:
    """(input, output) elements on one process for ``kind``."""
    rows = accounted_rows(kind, nbytes, n)
    return {"all-gather": (rows // n, rows),
            "reduce-scatter": (rows, rows // n),
            "all-reduce": (rows, rows),
            "ppermute": (rows // n, rows // n)}[kind]


def _timeit(fn, iters: int, device) -> float:
    """Seconds per call of ``fn``: one warm-up, then ``iters`` calls
    timed together (CUDA events on the card)."""
    import torch

    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _collective_fn(kind: str, nbytes: float, group, device):
    """A no-argument call of ``kind`` over ``group`` on buffers sized
    for ``nbytes`` accounted bytes (on the host for a gloo group, which
    moves host tensors)."""
    import torch
    import torch.distributed as dist

    if dist.get_backend(group) == "gloo":
        device = torch.device("cpu")
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_in, n_out = _local_shapes(kind, nbytes, n)
    x = torch.zeros(n_in, dtype=torch.float32, device=device)
    out = torch.empty(n_out, dtype=torch.float32, device=device)
    if kind == "all-gather":
        return lambda: dist.all_gather_into_tensor(out, x, group=group)
    if kind == "reduce-scatter":
        return lambda: dist.reduce_scatter_tensor(out, x, group=group)
    if kind == "all-reduce":
        return lambda: dist.all_reduce(x, group=group)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(rank + 1) % n], ranks[(rank - 1) % n]

    def permute():
        for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, nxt, group),
                 dist.P2POp(dist.irecv, out, prv, group)]):
            w.wait()
    return permute


def bench_collectives(sizes=DEFAULT_SIZES, iters: int = 10, group=None,
                      device="cpu") -> dict:
    """kind -> [[accounted_bytes, seconds], ...] over ``group`` (None:
    the world); every process of it calls this."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size(group) < 2:
        raise RuntimeError(
            "collective calibration needs a process group of >= 2 "
            "processes; start a world (e.g. this module's --world N)")
    device = torch.device("cpu" if dist.get_backend(group) == "gloo"
                          else device)
    out: dict = {}
    for kind in COLLECTIVE_KINDS:
        out[kind] = [[float(nbytes), _timeit(
            _collective_fn(kind, nbytes, group, device), iters, device)]
            for nbytes in sorted(sizes)]
    return out


def bench_matmul(sizes=DEFAULT_MATMUL_SIZES, iters: int = 10,
                 device="cuda") -> list:
    """[[flops, achieved_flops_per_s], ...] for square f32 matmuls on
    ``device`` (TF32 off: the f32 curve). In a world, every process
    computes at once, as JAX's measures every device concurrently."""
    import torch

    from distributed_training_tpu_torch.runtime import resolve_device

    device = resolve_device(device)
    pts = []
    for edge in sorted(sizes):
        a = torch.ones((edge, edge), dtype=torch.float32, device=device)
        out = torch.empty_like(a)
        secs = _timeit(lambda: torch.matmul(a, a, out=out), iters, device)
        flops = 2.0 * edge ** 3
        pts.append([flops, flops / secs])
    return pts


def calibrate(sizes=DEFAULT_SIZES, matmul_sizes=DEFAULT_MATMUL_SIZES,
              iters: int = 10, note: str = "", device="cpu",
              group=None) -> CalibrationTable:
    """The full suite over the world's group (every process calls
    this), as a table for this device's kind."""
    import torch
    import torch.distributed as dist

    from distributed_training_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return CalibrationTable(
        device_kind=kind,
        platform="gpu" if dev.type == "cuda" else "cpu",
        n_devices=dist.get_world_size(group),
        collectives=bench_collectives(sizes, iters=iters, group=group,
                                      device=dev),
        matmul=bench_matmul(matmul_sizes, iters=iters, device=dev),
        meta={
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": dist.get_backend(group),
            "iters": iters,
            "note": note or (
                "measured by python -m distributed_training_tpu_torch."
                "calibration.microbench; x-axis conventions in "
                "calibration/table.py"),
        })


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.calibration."
             "microbench",
        description="Measure a calibration table (collective and matmul "
                    "curves) for the planner's cost model.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=2,
                    help="processes of the gloo world the collectives "
                         "run over (all on cuda:0 on the card)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sizes", default="",
                    help="comma-separated accounted bytes (default: "
                         "JAX's ladder)")
    ap.add_argument("--matmul-sizes", default="",
                    help="comma-separated square edges (default: "
                         "256,512,1024,2048)")
    ap.add_argument("--matmul-only", action="store_true",
                    help="the matmul ladder alone, in this process; "
                         "prints its points")
    ap.add_argument("--out", default="", metavar="PATH",
                    help="write the table here (default: print it)")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.sizes.split(",") if s) \
        or DEFAULT_SIZES
    msizes = tuple(int(s) for s in args.matmul_sizes.split(",") if s) \
        or DEFAULT_MATMUL_SIZES
    if args.matmul_only:
        for flops, rate in bench_matmul(msizes, args.iters, args.device):
            print(json.dumps({"flops": flops, "flops_per_s": rate}))
        return 0
    if "RANK" not in os.environ:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "distributed_training_tpu_torch.calibration.microbench",
             *(argv if argv is not None else sys.argv[1:])],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.world),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     OMP_NUM_THREADS="1"))
            for r in range(args.world)]
        codes = [p.wait() for p in procs]
        return max(codes)
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    if args.device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    try:
        table = calibrate(sizes, msizes, args.iters,
                          device="cuda:0" if args.device == "cuda"
                          else "cpu")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        if args.out:
            print(save_table(table, args.out))
        else:
            print(json.dumps(table.to_doc(), indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

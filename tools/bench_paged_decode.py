#!/usr/bin/env python
"""Time the port's paged-decode kernel of one or two source trees on one card.

    python3 tools/bench_paged_decode.py [--ab OTHER_ROOT] [--out FILE]

Times ``ops/paged_attention.py::paged_attention`` of a checkout of the
repository (this one, or ``OTHER_ROOT``, e.g. an unpacked earlier commit)
at the decode cases of ``chip_smoke.py``'s kernels phase: ``chip_smoke.
Timer`` (median of 30 single launches after an L2 flush, CUDA events), on
the inputs ``chip_smoke.paged_inputs`` builds from the smoke's seed, each
output held against the tree's own plain version. It also reads the host
time of one wrapper call (the mean over 200 calls enqueued back to back).
With ``--ab`` each tree runs in its own process, in the order other, this,
this, other, so both are compared on one card within one call. One JSON
line per run; the last line holds them all, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (B, H, Hkv, hd, ps, max_len, dtype, lengths), as in chip_smoke.py.
CASES = {
    "main": (8, 12, 12, 64, 16, 1024, "bfloat16", None),
    "f32_gqa": (8, 12, 4, 64, 16, 1024, "float32", None),
    "long_gqa": (8, 32, 8, 128, 16, 2048, "bfloat16", None),
    "long_single": (1, 16, 16, 128, 16, 2048, "bfloat16", [2048]),
}
HOST_CALLS = 200


def _smoke():
    """This checkout's chip_smoke.py, loaded by path (the package comes
    from whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from distributed_training_tpu_torch.ops import paged_attention as pa

    smoke = _smoke()
    timer = smoke.Timer()
    res = {"root": root, "cases": {}}
    for name, (B, H, Hkv, hd, ps, max_len, dt, lengths) in CASES.items():
        dtype = getattr(torch, dt)
        args, lens = smoke.paged_inputs(B, H, Hkv, hd, ps, max_len, dtype,
                                        lengths)
        out = pa.paged_attention(*args)
        ref = pa.paged_attention(*args, impl="ref")
        err = (out.float() - ref.float()).abs().max().item()
        tol = smoke.TOL[dtype]
        smoke.check(torch.allclose(out.float(), ref.float(), rtol=tol,
                                   atol=tol), f"{root} {name}: err {err}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            pa.paged_attention(*args)
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        bound_ms, bound_by = smoke.paged_bound(args, lens, dtype)
        res["cases"][name] = {
            "ms": timer.ms(lambda: pa.paged_attention(*args)),
            "host_us_per_call": host_us, "max_abs_err": err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kv_bytes": 2 * int(lens.sum()) * Hkv * hd * args[1].element_size()}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT",
                    help="also time this tree; order other, this, this, other")
    ap.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the last line to this file")
    a = ap.parse_args()
    if a.one:
        print(json.dumps(run_one(a.one)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_paged_decode: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    roots = [a.ab, HERE, HERE, a.ab] if a.ab else [HERE]
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = json.dumps({"card": card, "runs": runs})
    if a.out:
        with open(a.out, "w") as f:
            f.write(summary + "\n")
    print(summary, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

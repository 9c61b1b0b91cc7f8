"""The readings the correctness limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--fault half_batch:1,2,3]

For a training cell, each ``--seeds`` seed gives the program's numbers
(its set-up steps, then the reference; no window); ``--control`` seeds
give the fp8 reference's numbers against the reference; ``--fault
<name>:<seeds>`` the numbers of the program with a fault planted
(``traffic/train.py::_plant``), ``half_batch_ref`` the reference itself
on half of each step's rows. For a serving cell, ``--seeds`` run the
cell with a window of ``--seconds`` and read ``served_gap``;
``--control`` reads the fp8 reference's gap at the positions of the
same run's served tokens. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def train_readings(cell, args, opts) -> None:
    generator = harness.load_module("traffic", "train")
    for seed in _seeds(args.seeds):
        _emit(kind="program", seed=seed,
              numbers=generator.readings(cell, {**opts, "seed": seed}))
    for seed in _seeds(args.control):
        _emit(kind="control_fp8", seed=seed,
              numbers=generator.control(cell, {**opts, "seed": seed}))
    for spec in args.fault:
        name, seeds = spec.split(":")
        for seed in _seeds(seeds):
            o = {**opts, "seed": seed}
            nums = (generator.control(cell, o, half=True)
                    if name == "half_batch_ref" else
                    generator.readings(cell, {**o, "fault": name}))
            _emit(kind=f"fault_{name}", seed=seed, numbers=nums)


def serve_readings(cell, args, opts) -> None:
    import torch

    generator = harness.load_module("traffic", "closed_loop")
    from portbench.reference import check_serve

    for seed in _seeds(args.seeds):
        o = {**opts, "seed": seed, "t_start": time.perf_counter(),
             "keep": True}
        res = generator.run(cell, o)
        finished = res["finished"]
        picked = check_serve.sample(finished, seed,
                                    cell.traffic["check_tokens"])
        params = check_serve.served_weights(cell.run_cfg, seed,
                                            torch.device("cuda"),
                                            cell.spec["program"]["dtype"])
        rec = {"kind": "program", "seed": seed,
               "numbers": {k: v["value"] for k, v in res["checks"].items()},
               "served": sum(len(r["tokens"]) for r in picked)}
        if seed in _seeds(args.control):
            rec["control_served_gap"] = check_serve.served_gap(
                check_serve.gaps(cell.run_cfg, params, picked,
                                 torch.device("cuda"), low=True))
        _emit(**rec)
        del res, finished, params
        gc.collect()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    harness.check_device(cell.chips)
    opts = {"seconds": args.seconds, "trace": False, "device": "cuda",
            "t_start": time.perf_counter()}
    if cell.traffic["generator"] == "train":
        train_readings(cell, args, opts)
    else:
        serve_readings(cell, args, opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())

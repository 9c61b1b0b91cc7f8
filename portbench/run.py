"""Run one cell of the benchmark of ``distributed_training_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's cards. Set-up
(``setup_s``: from the start of this script to the window) makes the
inputs and weights from ``--seed``, builds the program and warms up the
cell's own shapes; the window measures for ``--seconds``; then the
program's state is freed and what the window produced is compared with
the plain reference (``correct``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics), ``device`` and, last, ``checks``: each number
compared beside its limit, which also end standard error.

Exits 3 and prints no result without the cards the cell asks for, and
1 if a module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``distributed_training_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell, opts: dict) -> dict:
    """The generator's run of ``cell`` and its result line."""
    generator = harness.load_module("traffic", cell.traffic["generator"])
    res = generator.run(cell, opts)
    return harness.result_line(cell, res, bool(opts["trace"]))


def main(argv=None) -> int:
    args = parse(argv)
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    try:
        harness.check_device(cell.chips)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    opts = {"seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "device": "cuda",
            "t_start": T_START}
    line = execute(cell, opts)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 1
    harness.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

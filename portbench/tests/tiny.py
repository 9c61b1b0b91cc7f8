"""Cells at a size a CPU test can hold: the benchmark's own files with
the configuration's sizes cut down, run on the CPU."""

from __future__ import annotations

import copy

from portbench import harness

# Limits at this size, where the CPU's bf16 plain kernels part from the
# f32 reference by up to 2e-5 in the loss and 1e-3 in a leaf's norm
# (sound runs, 6 seeds), the fp8 control by 3e-3 to 1e-2 and half of
# the batch by 3e-2 to 9e-2: each limit lies between.
TINY_LIMITS = {"loss_step3": 1e-4, "grad_leaf": 3e-3, "change_leaf": 3e-3}

TINY_RUN = {"d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 256,
            "vocab_rows": 512, "vocab_ids": 500, "max_seq_len": 64}


def tiny_cell(name: str, **traffic) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json at TINY_RUN's sizes, with the
    traffic's sizes cut (``traffic`` overrides)."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config["run"] = {**cell.config["run"], **TINY_RUN}
    tr = cell.traffic
    if tr["generator"] == "train":
        tr.update(batch_per_chip=4, seq_len=32, rows=16,
                  vocab_ids=TINY_RUN["vocab_ids"])
        cell.spec["reference"]["rows_per_block"] = 2
        cell.spec["limits"] = dict(TINY_LIMITS)
    else:
        tr.update(clients=4, pool=64, check_tokens=40, warm_requests=4,
                  vocab_ids=TINY_RUN["vocab_ids"],
                  prompt={**tr["prompt"], "mean": 8, "max": 40},
                  output={**tr["output"], "mean": 6, "max": 12})
        cell.spec["engine"].update(max_batch=4, num_pages=33,
                                   max_seq_len=64, prefill_chunk=16)
    tr.update(traffic)
    return cell


def opts(seed: int = 7, seconds: float = 0.5, trace: bool = False,
         **more) -> dict:
    import time

    return {"seed": seed, "seconds": seconds, "trace": trace,
            "device": "cpu", "t_start": time.perf_counter(), **more}

"""What every cell shares: finding its files by name, the device checks,
the cache directories, the per-layer metric readers, the import check
and the result line.

The contract of a run is ``run.py``'s docstring. A generator
(``traffic/<generator>.py``) exposes ``run(cell, opts) -> dict`` and
returns the end-to-end readings, the inputs of the per-layer readers,
the correctness checks and the device readings; this module turns that
into the result line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# Caches of the program and its libraries: fixed directories inside the
# checkout, so that only a checkout's first run builds.
CACHE = os.path.join(ROOT, ".portbench_cache")
# Modules that may not be loaded in the process that prints a result,
# compared by whole top-level name.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "distributed_training_tpu"})


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


@dataclass
class Cell:
    name: str
    chips: int
    spec: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def run_cfg(self) -> dict:
        """The configuration's sizes as they are run."""
        return self.config["run"]


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return _read_json(os.path.join(ROOT, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(
        name=name, chips=entry["chips"],
        spec=_read_json(os.path.join(HERE, "workloads", f"{name}.json")),
        config=_read_json(os.path.join(HERE, "configs",
                                       f"{entry['config']}.json")),
        traffic=_read_json(os.path.join(HERE, "traffic",
                                        f"{entry['traffic']}.json")),
        end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_cache_env() -> None:
    """Point every build and kernel cache at fixed directories in the
    checkout, and keep libraries from loading JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def check_device(chips: int):
    """The CUDA card's name, or ``NoDevice``."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} card(s), the cell "
                       f"asks for {chips}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def read_per_layer(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric's reader over ``ctx``; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _e2e(readings: dict, name: str) -> float:
    """The generator's reading of ``name``; a quantity split by cell
    (``train_samples_per_s.fsdp``) is its reading of the part before the
    first dot."""
    return readings[name] if name in readings else \
        readings[name.split(".")[0]]


def result_line(cell: Cell, res: dict, trace: bool) -> dict:
    """The result's JSON object; ``checks`` (each compared number beside
    its limit) comes last."""
    if trace:
        metrics = read_per_layer(cell, res["ctx"])
    else:
        metrics = {m["name"]: {"value": float(_e2e(res["e2e"], m["name"])),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": res["device"]}
    if trace and res.get("breakdown"):
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def print_checks(checks: dict) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{verdict}", file=sys.stderr, flush=True)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number with its limit; correct when none passes it
    and every limit has a number (a missing reading is not correct)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or value != value:
            value = float("inf")
        checks[name] = {"value": float(value), "limit": float(limit)}
        ok = ok and value <= limit
    return ok, checks

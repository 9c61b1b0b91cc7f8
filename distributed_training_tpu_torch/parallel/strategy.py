"""Parallelism strategies (port of ``parallel/strategy.py``).

This slice runs data parallelism on a world of one process and one card,
so ``get_strategy("ddp")`` is the only strategy: its gradient all-reduce
over a world of 1 is the identity. The sharded strategies (``zero1``,
``fsdp``, ``hybrid``, ``tp``, ``tp_fsdp``) wait for ROADMAP.md queue A
item 4.
"""

from __future__ import annotations

from dataclasses import dataclass

SHARDED = ("zero1", "fsdp", "hybrid", "tp", "tp_fsdp")


@dataclass
class DataParallel:
    """Replicated params, batch split over the data shards."""

    name: str = "ddp"
    gather_on_save: bool = False


def get_strategy(name: str, gather_on_save: bool = False) -> DataParallel:
    """Strategy registry, as the JAX ``get_strategy``."""
    name = name.lower()
    if name in SHARDED:
        raise NotImplementedError(
            f"parallel_strategy '{name}' waits for ROADMAP.md queue A "
            "item 4 (sharded training)")
    if name != "ddp":
        raise ValueError(f"unknown parallel strategy '{name}'")
    if gather_on_save:
        raise NotImplementedError(
            "gather_on_save (the consolidated export) waits for "
            "ROADMAP.md queue A item 4 (checkpoint/consolidate.py)")
    return DataParallel()

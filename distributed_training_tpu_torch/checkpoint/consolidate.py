"""Gathered single-artifact export (port of ``checkpoint/consolidate.py``).

The day-to-day checkpoint is sharded (``manager.py``); this writes ONE
portable file to hand to an inference stack or to archive, the
reference's FSDP FULL_STATE_DICT analogue.

``export_consolidated`` is COLLECTIVE: every process calls it (each
sharded leaf is all-gathered over its group), process 0 alone writes,
and every process leaves after a barrier. The artifact is the port's own
format: ``torch.save`` of ``{"state": <nested dict of whole CPU tensors
and ints>, "meta": {...}}``, loadable with ``load_consolidated`` on any
machine, without a mesh or a process group.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Any

import torch

from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.train.optimizer import (
    flatten,
    moment_placements,
    unflatten,
)

logger = logging.getLogger(__name__)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    return tree


def gather_full_state(state: dict, layout: dict | None, runtime) -> dict:
    """The whole train state on the host. COLLECTIVE under a process
    group: every process must call it. ``layout``: the trainer's
    placements (None without a process group: the state is whole)."""
    if layout is None:
        return _to_cpu(state)
    out = dict(state)
    out["params"] = unflatten(fsdp.gather_full(
        flatten(state["params"]), layout["params"], runtime))
    opt = dict(state["opt_state"])
    for name, pls in moment_placements(opt, layout["opt"],
                                       layout.get("factored") or {}).items():
        opt[name] = fsdp.gather_full(opt[name], pls, runtime)
    out["opt_state"] = opt
    return _to_cpu(out)


def write_artifact(path: str, state: dict, meta: dict | None) -> int:
    """Write ``{"state", "meta"}`` atomically (temp file + rename).
    Returns the byte count. Shared by the collective export and the
    offline CLI so the format cannot drift between them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"state": state, "meta": dict(meta or {})}, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return os.path.getsize(path)


def export_consolidated(path: str, state: dict, layout: dict | None,
                        runtime, meta: dict | None = None) -> str:
    """Write the whole (gathered) state as ONE file. COLLECTIVE: call
    from every process; process 0 writes; all leave together."""
    full = gather_full_state(state, layout, runtime)
    if runtime.is_coordinator:
        n = write_artifact(path, full, meta)
        logger.info("consolidated checkpoint exported: %s (%d bytes)",
                    path, n)
    runtime.barrier()
    return path


def load_consolidated(path: str) -> tuple[dict, dict]:
    """(state, meta) of a consolidated artifact, tensors on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["state"], dict(payload.get("meta") or {})

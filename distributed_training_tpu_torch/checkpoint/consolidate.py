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

import json
import logging
import math
import os
import tempfile
from typing import Any

import numpy as np
import torch

from distributed_training_tpu_torch.checkpoint.manager import (
    LAYOUT_FILE,
    WHOLE_FILE,
    placements_of,
    rank_file,
    written_ranks,
)
from distributed_training_tpu_torch.parallel import fsdp
from distributed_training_tpu_torch.runtime import MESH_AXES
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


def _join(local: list, pls: dict, coords: list, sizes: dict) -> dict:
    """Whole leaves from every process's flat dict of local blocks: a
    leaf split on two dims is joined along its last split first, then
    along the first."""
    out = {}
    for k, pl in pls.items():
        if k not in local[0]:
            continue  # a moment that only some leaves have
        blocks = {(): local[0][k]}
        if pl is not None:
            blocks = {}
            for r, c in enumerate(coords):
                at = tuple(int(np.ravel_multi_index(
                    [c[a] for a in axes], [sizes[a] for a in axes]))
                    for _, axes in pl.splits)
                blocks.setdefault(at, local[r][k])
            for j in reversed(range(len(pl.splits))):
                dim, axes = pl.splits[j]
                n = math.prod(sizes[a] for a in axes)
                blocks = {at: torch.cat([blocks[at + (i,)]
                                         for i in range(n)], dim=dim)
                          for at in {at[:j] for at in blocks}}
        out[k] = blocks[()]
    return out


def whole_state_of(step_dir: str) -> dict:
    """A committed step's whole state on the host, whatever mesh wrote
    it: ``state.pt`` as saved, or the ``state.rank<r>.pt`` of every
    process that wrote one (under ``pp``, the first stages) joined by
    ``layout.json``. One process, no process group; it holds
    every rank file in memory at once."""
    whole = os.path.join(step_dir, WHOLE_FILE)
    if os.path.exists(whole):
        return torch.load(whole, map_location="cpu", weights_only=True)
    with open(os.path.join(step_dir, LAYOUT_FILE)) as f:
        manifest = json.load(f)
    sizes = manifest["mesh"]
    shape = [sizes[a] for a in MESH_AXES]
    ranks = written_ranks(manifest)
    coords = [dict(zip(MESH_AXES, np.unravel_index(r, shape)))
              for r in ranks]
    local = [torch.load(os.path.join(step_dir, rank_file(r)),
                        map_location="cpu", weights_only=True)
             for r in ranks]
    state = dict(local[0])
    state["params"] = unflatten(_join(
        [flatten(s["params"]) for s in local],
        placements_of(manifest, "params"), coords, sizes))
    opt = dict(state["opt_state"])
    factored = {name: placements_of(manifest, name)
                for name in manifest.get("factored", {})}
    for name, pls in moment_placements(opt, placements_of(manifest, "opt"),
                                       factored).items():
        opt[name] = _join([s["opt_state"][name] for s in local], pls,
                          coords, sizes)
    state["opt_state"] = opt
    return state


def place_state(whole: dict, layout: dict | None, runtime, device) -> dict:
    """A whole state (``whole_state_of``) on ``device``, cut to this
    process's shards by ``layout`` (None: every leaf whole) — the
    inverse of the join, for a run on another mesh than the one that
    saved."""
    def to(t):
        return t.to(device) if isinstance(t, torch.Tensor) else t
    flat = {k: to(t) for k, t in flatten(whole["params"]).items()}
    out = dict(whole)
    opt = {k: ({n: to(t) for n, t in v.items()} if isinstance(v, dict)
               else to(v)) for k, v in whole["opt_state"].items()}
    if layout is not None:
        flat = {k: fsdp.shard(t, layout["params"][k], runtime)
                for k, t in flat.items()}
        for name, pls in moment_placements(
                opt, layout["opt"], layout.get("factored") or {}).items():
            opt[name] = {k: fsdp.shard(t, pls[k], runtime)
                         for k, t in opt[name].items()}
    out["params"] = unflatten(flat)
    out["opt_state"] = opt
    return out

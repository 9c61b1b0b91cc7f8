"""Synchronous checkpoints, whole or sharded (port of
``checkpoint/manager.py``).

The JAX ``Checkpointer``'s interface over ``torch.save``. Each save
writes a temporary directory that is renamed into place, so a reader
never sees a half-written step:

- without a process group (a world of 1): ``<directory>/<step>/state.pt``
  (params, optimizer state, step) and ``meta.json`` (epoch, the loader's
  cursor, the architecture);
- with one (any world under torch.distributed): every process writes its
  local shards to ``state.rank<r>.pt``, and process 0 writes
  ``meta.json`` and ``layout.json`` (the mesh and each leaf's placement)
  and renames the directory once every process has written (barriers
  before and after). Resume restores the shards onto the same mesh and
  layout, and refuses another (``checkpoint/export.py`` consolidates a
  sharded step into one file).

``restore_latest`` loads the newest step; ``max_to_keep`` prunes the
oldest. Saves are synchronous, so ``wait`` has nothing to drain. The
sha256 manifest and the quarantine fallback (``resilience/integrity.py``)
wait for ROADMAP.md queue A item 14.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any

import torch

from distributed_training_tpu_torch.parallel.strategy import Placement
from distributed_training_tpu_torch.telemetry import events as telemetry

logger = logging.getLogger(__name__)

WHOLE_FILE = "state.pt"
LAYOUT_FILE = "layout.json"


def rank_file(rank: int) -> str:
    return f"state.rank{rank}.pt"


def _detached(state: Any) -> Any:
    if isinstance(state, dict):
        return {k: _detached(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach()
    return state


def layout_manifest(layout: dict, runtime) -> dict:
    """The JSON record of a sharded save's layout: the mesh, and each
    leaf's placement: ``[dim, [axes…]]`` for one split dim,
    ``[[dim, [axes…]], [dim, [axes…]]]`` for two, or null."""
    def enc(pls):
        out = {}
        for k, pl in pls.items():
            splits = [[d, list(axes)] for d, axes in (pl.splits if pl else ())]
            out[k] = (splits[0] if len(splits) == 1 else splits) or None
        return out
    out = {"world": runtime.process_count,
           "mesh": runtime.spec.as_dict(),
           "params": enc(layout["params"]), "opt": enc(layout["opt"])}
    if layout.get("factored"):
        # Adafactor's factored moments (train/optimizer.py).
        out["factored"] = {name: enc(pls)
                           for name, pls in layout["factored"].items()}
    return out


def placements_of(manifest: dict, kind: str) -> dict:
    """A manifest's placements back as ``Placement`` (or None):
    ``kind`` "params", "opt", or a factored moment's name under
    "factored"."""
    def dec(v):
        splits = [v] if isinstance(v[0], int) else v
        return Placement(tuple((d, tuple(axes)) for d, axes in splits))
    enc = manifest[kind] if kind in manifest else manifest["factored"][kind]
    return {k: None if v is None else dec(v) for k, v in enc.items()}


class Checkpointer:
    """Step-numbered checkpoints in one directory. ``runtime``: the
    process's ``Runtime``; sharded saves when it has a process group."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 runtime=None) -> None:
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.rt = runtime
        self.sharded = runtime is not None and runtime.mesh is not None
        os.makedirs(directory, exist_ok=True)

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            self.wait()
        finally:
            self.close()
        return False

    def steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, meta: dict | None = None,
             force: bool = False, layout: dict | None = None) -> bool:
        """Write step ``step`` (collective under a process group: every
        process calls it). A step already on disk is kept unless
        ``force``. Returns whether a checkpoint was written."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final) and not force:
            return False
        if self.sharded:
            tmp = os.path.join(self.directory, f".tmp-{step}")
            coordinator = self.rt.is_coordinator
        else:
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            coordinator = True
        with telemetry.span("ckpt_save", step=step):
            if coordinator:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            if self.sharded:
                self.rt.barrier()
                torch.save(_detached(state),
                           os.path.join(tmp, rank_file(self.rt.process_index)))
                self.rt.barrier()
            else:
                torch.save(_detached(state), os.path.join(tmp, WHOLE_FILE))
            if coordinator:
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta or {}, f)
                if self.sharded:
                    with open(os.path.join(tmp, LAYOUT_FILE), "w") as f:
                        json.dump(layout_manifest(layout, self.rt), f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                for old in self.steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
            if self.sharded:
                self.rt.barrier()
        logger.info("checkpoint saved at step %d -> %s", step,
                    self.directory)
        return True

    def restore_latest(self, device=None, layout: dict | None = None
                       ) -> tuple[dict, dict] | None:
        """(state, meta) of the newest step with its tensors on
        ``device`` (this process's shards under a process group), or
        None when the directory holds no checkpoint (a fresh start)."""
        step = self.latest_step()
        if step is None:
            return None
        step_dir = os.path.join(self.directory, str(step))
        with telemetry.span("ckpt_restore", step=step):
            with open(os.path.join(step_dir, "meta.json")) as f:
                meta = json.load(f)
            whole = os.path.exists(os.path.join(step_dir, WHOLE_FILE))
            if whole == self.sharded:
                raise ValueError(
                    f"checkpoint step {step} in {self.directory} is "
                    f"{'whole' if whole else 'sharded'}, and this run "
                    f"{'has' if self.sharded else 'has no'} process group; "
                    "resume it as it was written, or consolidate it "
                    "(python -m distributed_training_tpu_torch.checkpoint."
                    "export)")
            if whole:
                state = torch.load(os.path.join(step_dir, WHOLE_FILE),
                                   map_location=device, weights_only=True)
            else:
                with open(os.path.join(step_dir, LAYOUT_FILE)) as f:
                    saved = json.load(f)
                want = layout_manifest(layout, self.rt)
                if saved != want:
                    raise ValueError(
                        f"checkpoint step {step} was sharded over mesh "
                        f"{saved['mesh']} (world {saved['world']}) with "
                        "another layout than this run's "
                        f"{want['mesh']} (world {want['world']}); resume "
                        "on the same mesh and strategy")
                state = torch.load(
                    os.path.join(step_dir, rank_file(self.rt.process_index)),
                    map_location=device, weights_only=True)
        logger.info("restored checkpoint step %d from %s", step,
                    self.directory)
        return state, meta

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""

"""Synchronous single-process checkpoints (port of
``checkpoint/manager.py``).

The JAX ``Checkpointer``'s interface over ``torch.save``: each save
writes ``<directory>/<step>/state.pt`` (params, optimizer state, step)
and ``meta.json`` (epoch, the loader's cursor, the architecture) into a
temporary directory that is renamed into place, so a reader never sees a
half-written step. ``restore_latest`` loads the newest step;
``max_to_keep`` prunes the oldest. Saves are synchronous, so ``wait`` has
nothing to drain. The sha256 manifest and the quarantine fallback
(``resilience/integrity.py``) wait for ROADMAP.md queue A item 14.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any

import torch

from distributed_training_tpu_torch.telemetry import events as telemetry

logger = logging.getLogger(__name__)


def _detached(state: Any) -> Any:
    if isinstance(state, dict):
        return {k: _detached(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach()
    return state


class Checkpointer:
    """Step-numbered checkpoints in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = directory
        self.max_to_keep = max_to_keep
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
             force: bool = False) -> bool:
        """Write step ``step``. A step already on disk is kept unless
        ``force``. Returns whether a checkpoint was written."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final) and not force:
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with telemetry.span("ckpt_save", step=step):
            torch.save(_detached(state), os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta or {}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        logger.info("checkpoint saved at step %d -> %s", step,
                    self.directory)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore_latest(self, device=None) -> tuple[dict, dict] | None:
        """(state, meta) of the newest step with its tensors on
        ``device``, or None when the directory holds no checkpoint (a
        fresh start)."""
        step = self.latest_step()
        if step is None:
            return None
        step_dir = os.path.join(self.directory, str(step))
        with telemetry.span("ckpt_restore", step=step):
            state = torch.load(os.path.join(step_dir, "state.pt"),
                               map_location=device, weights_only=True)
            with open(os.path.join(step_dir, "meta.json")) as f:
                meta = json.load(f)
        logger.info("restored checkpoint step %d from %s", step,
                    self.directory)
        return state, meta

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""

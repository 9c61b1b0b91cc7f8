"""Checkpoints, whole or sharded, synchronous or asynchronous, with
integrity manifests (port of ``checkpoint/manager.py``).

The JAX ``Checkpointer``'s interface over ``torch.save``. Each save
writes a temporary directory that is renamed into place, so a reader
never sees a half-written step:

- without a process group (a world of 1): ``<directory>/<step>/state.pt``
  (params, optimizer state, step) and ``meta.json`` (epoch, the loader's
  position, the architecture);
- with one (any world under torch.distributed): every process writes its
  local shards to ``state.rank<r>.pt``, and process 0 writes
  ``meta.json`` and ``layout.json`` (the mesh and each leaf's placement;
  ``replica_axes`` names ``pp`` and ``sp`` when the mesh has them)
  and renames the directory once every process has written. Under
  ``pp`` only the first stage of each data shard (and sp slice and tp
  block) writes: the other stages hold the same state, and read the
  first stage's file back (``writer_rank``).

Every committed step gets ``manifest.dtt.json`` (``resilience/
integrity.py``: the sha256 and size of every file, the rank files,
``meta.json`` and ``layout.json`` included), written by process 0 after
the rename. ``restore_latest`` verifies the newest step's manifest; a
damaged step is quarantined (renamed ``step_<N>.corrupt``, a
``ckpt_quarantined`` event) and the next older one is tried, and a run
whose every step is damaged starts fresh.

**Async saves** (``async_save=True``, the default, as in the JAX
package): ``save`` copies the state into reused host buffers (pinned
memory, on a side CUDA stream; ``fence`` makes the next optimizer update
wait on that copy, not the forward and backward before it) and returns;
a writer thread waits for the copy and ``torch.save``\\ s it; for a
sharded step every process's writer then meets the others at a barrier
of a gloo group of the checkpointer's own (a collective off the training
thread must not share the training's groups), and process 0's writer
renames the step. Process 0's writer then hashes it. A step is manifested
only once committed, and the fault injector's ``on_checkpoint_saved`` is
called (on the caller's thread, at the next ``save`` or ``wait``) only
with a manifested step. ``wait()``, ``close()`` and the context manager
drain every save in flight.

**Restore onto another world.** A step saved under another mesh or
layout (``ddp``, ``zero1``, ``fsdp``, ``hybrid`` at world N, or whole) is
joined from its files (``consolidate.whole_state_of``) and cut by this
run's layout (``consolidate.place_state``), the counterpart of Orbax's
resharded restore that the JAX elastic path relies on.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.parallel.strategy import Placement
from distributed_training_tpu_torch.resilience import integrity
from distributed_training_tpu_torch.runtime import MESH_AXES
from distributed_training_tpu_torch.telemetry import events as telemetry

logger = logging.getLogger(__name__)

WHOLE_FILE = "state.pt"
LAYOUT_FILE = "layout.json"


def rank_file(rank: int) -> str:
    return f"state.rank{rank}.pt"


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
    replicas = [a for a in ("pp", "sp") if getattr(runtime.spec, a) > 1]
    if replicas:
        # Every leaf is whole over pp and sp: the sp members' files hold
        # replicas (the pp stages' are not written), and a restore on
        # another mesh re-cuts the state from any one.
        out["replica_axes"] = replicas
    if layout.get("factored"):
        # Adafactor's factored moments (train/optimizer.py).
        out["factored"] = {name: enc(pls)
                           for name, pls in layout["factored"].items()}
    return out


def writer_rank(runtime) -> int:
    """The process whose rank file holds this process's state: itself,
    or under ``pp`` the first stage of its pipeline."""
    if runtime.mesh is None or runtime.spec.pp == 1:
        return runtime.process_index
    return runtime.mesh.members(("pp",))[0] - runtime.first_rank


def written_ranks(manifest: dict) -> list:
    """The processes of a sharded save that wrote a rank file: every one,
    or under ``pp`` the first stage of each pipeline."""
    shape = [manifest["mesh"][a] for a in MESH_AXES]
    return [r for r in range(manifest["world"])
            if np.unravel_index(r, shape)[MESH_AXES.index("pp")] == 0]


def placements_of(manifest: dict, kind: str) -> dict:
    """A manifest's placements back as ``Placement`` (or None):
    ``kind`` "params", "opt", or a factored moment's name under
    "factored"."""
    def dec(v):
        splits = [v] if isinstance(v[0], int) else v
        return Placement(tuple((d, tuple(axes)) for d, axes in splits))
    enc = manifest[kind] if kind in manifest else manifest["factored"][kind]
    return {k: None if v is None else dec(v) for k, v in enc.items()}


class _Snapshot:
    """Host copies of a state's tensors, reused from save to save (one
    buffer per leaf path; pinned when the leaf is on the card). The
    copies of a card's tensors run on a side stream; ``event`` marks
    their end."""

    def __init__(self) -> None:
        self._bufs: dict[str, torch.Tensor] = {}
        self._stream = None
        self.event = None

    def take(self, state: Any) -> Any:
        on_card = []
        self.event = None

        def walk(x, path):
            if isinstance(x, dict):
                return {k: walk(v, f"{path}/{k}") for k, v in x.items()}
            if not isinstance(x, torch.Tensor):
                return x
            t = x.detach()
            buf = self._bufs.get(path)
            if (buf is None or buf.shape != t.shape
                    or buf.dtype != t.dtype):
                buf = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.device.type == "cuda")
                self._bufs[path] = buf
            if t.device.type == "cuda":
                on_card.append((buf, t))
            else:
                buf.copy_(t)
            return buf

        out = walk(state, "")
        if on_card:
            if self._stream is None:
                self._stream = torch.cuda.Stream(on_card[0][1].device)
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                for buf, t in on_card:
                    buf.copy_(t, non_blocking=True)
                    # The update may free a moment while the copy still
                    # reads it: the allocator must not hand its memory
                    # out before the side stream is done.
                    t.record_stream(self._stream)
            self.event = torch.cuda.Event()
            self.event.record(self._stream)
        return out


class Checkpointer:
    """Step-numbered checkpoints in one directory. ``runtime``: the
    process's ``Runtime``; sharded saves when it has a process group.
    ``fault_injector``: its ``on_checkpoint_saved`` is called (process 0
    only) with each step once it is manifested."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 runtime=None, async_save: bool = True,
                 fault_injector=None) -> None:
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.rt = runtime
        self.sharded = runtime is not None and runtime.mesh is not None
        self.coordinator = (not self.sharded) or runtime.is_coordinator
        self._injector = fault_injector
        self._snap = _Snapshot() if async_save else None
        # The writers' commit barrier (every process of the mesh makes
        # it, here, at the same point of the program).
        self._commit_group = (
            dist.new_group(ranks=list(runtime.mesh.members(MESH_AXES)),
                           backend="gloo")
            if async_save and self.sharded else None)
        # The save in flight: (step, writer thread, errors).
        self._inflight: tuple | None = None
        # Seconds the caller was held by the last save / restore, and
        # the bytes and seconds of the last manifest (what the chip
        # smoke reports).
        self.last_save_stall_s = 0.0
        self.last_manifest: dict | None = None
        self.last_restore: dict | None = None
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
        return integrity.checkpoint_steps_on_disk(self.directory)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def fence(self) -> None:
        """Make the current CUDA stream wait for the last save's copy of
        the state: call before writing the saved tensors in place (the
        optimizer update). A no-op without a copy in flight."""
        ev = self._snap.event if self._snap is not None else None
        if ev is not None:
            torch.cuda.current_stream().wait_event(ev)
            self._snap.event = None

    def save(self, step: int, state: dict, meta: dict | None = None,
             force: bool = False, layout: dict | None = None) -> bool:
        """Write step ``step`` (collective under a process group: every
        process calls it). A step already on disk is kept unless
        ``force``. Returns whether a checkpoint was started."""
        t0 = time.perf_counter()
        self._drain()
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final) and not force:
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}" if self.sharded
                           else f".tmp-{step}-{os.getpid()}")
        with telemetry.span("ckpt_save", step=step):
            if self.coordinator:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            if self.sharded:
                self.rt.barrier()
            fname = (rank_file(self.rt.process_index) if self.sharded
                     else WHOLE_FILE)
            commit = {"step": step, "tmp": tmp, "final": final,
                      "meta": meta or {},
                      "layout": (layout_manifest(layout, self.rt)
                                 if self.sharded else None)}
            writes = (not self.sharded
                      or writer_rank(self.rt) == self.rt.process_index)
            if self._snap is None:
                if writes:
                    torch.save(_detached(state), os.path.join(tmp, fname))
                self._commit(commit)
            else:
                host = self._snap.take(state)
                event = self._snap.event
                errors: list[BaseException] = []

                def write():
                    try:
                        if event is not None:
                            event.synchronize()
                        if writes:
                            torch.save(host, os.path.join(tmp, fname))
                        if self.sharded:
                            dist.barrier(group=self._commit_group)
                        if self.coordinator:
                            self._publish(commit)
                            self._hash(step)
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        # at the next drain, on the caller's thread.
                        errors.append(e)

                thread = threading.Thread(target=write, name="ckpt-writer",
                                          daemon=True)
                thread.start()
                self._inflight = (step, thread, errors)
        self.last_save_stall_s = time.perf_counter() - t0
        logger.info("checkpoint %s at step %d -> %s",
                    "started" if self._snap is not None else "saved", step,
                    self.directory)
        return True

    def _publish(self, commit: dict) -> None:
        """Process 0: meta, layout, the rename, and pruning."""
        tmp, final = commit["tmp"], commit["final"]
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(commit["meta"], f)
        if commit["layout"] is not None:
            with open(os.path.join(tmp, LAYOUT_FILE), "w") as f:
                json.dump(commit["layout"], f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def _hash(self, step: int) -> None:
        step_dir = os.path.join(self.directory, str(step))
        if not os.path.isdir(step_dir):
            return  # pruned already (max_to_keep below the saves in flight)
        t0 = time.perf_counter()
        path = integrity.write_manifest(step_dir)
        with open(path) as f:
            files = json.load(f)["files"]
        self.last_manifest = {
            "step": step, "s": time.perf_counter() - t0,
            "bytes": sum(v["bytes"] for v in files.values())}

    def _commit(self, commit: dict) -> None:
        """Commit a synchronous save whose files are written (every
        process): the barrier, process 0's rename and hash, the
        injector's hook."""
        if self.sharded:
            self.rt.barrier()
        if self.coordinator:
            self._publish(commit)
            self._hash(commit["step"])
            self._manifested(commit["step"])
        if self.sharded:
            self.rt.barrier()

    def _manifested(self, step: int) -> None:
        if self._injector is not None and self.coordinator:
            self._injector.on_checkpoint_saved(step, self.directory)

    def _drain(self) -> None:
        """Finish the save in flight: join the writer, raise its error,
        and call the injector's hook with the step it manifested."""
        if self._inflight is None:
            return
        step, thread, errors = self._inflight
        self._inflight = None
        thread.join()
        if errors:
            raise errors[0]
        self._manifested(step)

    # -- restore -------------------------------------------------------------

    def restore_latest(self, device=None, layout: dict | None = None
                       ) -> tuple[dict, dict] | None:
        """(state, meta) of the newest good step with its tensors on
        ``device`` (this process's shards by ``layout`` under a process
        group), or None when no step is usable (a fresh start). A step
        saved under another mesh or layout is joined and re-cut."""
        self.wait()
        t0 = time.perf_counter()
        while True:
            step = self._newest_good_step()
            if step is None:
                return None
            try:
                state, meta, same, files = self._load(step, device, layout)
                break
            except Exception as e:  # noqa: BLE001 — a step that cannot
                # be read is condemned like a damaged one (no process
                # group: a rank alone must not decide for the others).
                if self.sharded:
                    raise
                logger.exception("restore of step %d failed; "
                                 "quarantining it", step)
                integrity.quarantine_step(
                    self.directory, step,
                    problems=[f"restore raised {type(e).__name__}: {e}"])
        step_dir = os.path.join(self.directory, str(step))
        self.last_restore = {
            "step": step, "resharded": not same,
            "s": time.perf_counter() - t0,
            "bytes": sum(os.path.getsize(os.path.join(step_dir, n))
                         for n in files)}
        logger.info("restored checkpoint step %d from %s", step,
                    self.directory)
        return state, meta

    def _load(self, step: int, device, layout: dict | None):
        """(state, meta, saved in this run's layout, files read)."""
        step_dir = os.path.join(self.directory, str(step))
        with telemetry.span("ckpt_restore", step=step):
            with open(os.path.join(step_dir, "meta.json")) as f:
                meta = json.load(f)
            whole = os.path.exists(os.path.join(step_dir, WHOLE_FILE))
            saved = None
            if not whole:
                with open(os.path.join(step_dir, LAYOUT_FILE)) as f:
                    saved = json.load(f)
            same = (saved == layout_manifest(layout, self.rt)
                    if self.sharded and saved is not None
                    else whole and not self.sharded)
            if same:
                name = (rank_file(writer_rank(self.rt)) if self.sharded
                        else WHOLE_FILE)
                files = [name]
                state = torch.load(os.path.join(step_dir, name),
                                   map_location=device, weights_only=True)
            else:
                from distributed_training_tpu_torch.checkpoint import (
                    consolidate,
                )
                files = ([WHOLE_FILE] if whole else
                         [rank_file(r) for r in written_ranks(saved)])
                state = consolidate.place_state(
                    consolidate.whole_state_of(step_dir), layout, self.rt,
                    device)
                logger.info(
                    "checkpoint step %d re-cut from %s onto this run's "
                    "%s", step,
                    "a whole save" if whole else
                    f"mesh {saved['mesh']} (world {saved['world']})",
                    "layout" if self.sharded else "whole state")
        return state, meta, same, files

    def _newest_good_step(self) -> int | None:
        """The newest step whose manifest verifies (or that has none),
        quarantining every damaged step above it. Process 0 decides under
        a process group; the others wait at a barrier."""
        if self.coordinator:
            while True:
                step = self.latest_step()
                if step is None:
                    break
                step_dir = os.path.join(self.directory, str(step))
                verified, problems = integrity.verify_manifest(step_dir)
                if problems:
                    integrity.quarantine_step(self.directory, step,
                                              problems=problems)
                    continue
                if not verified:
                    logger.warning("checkpoint step %d has no integrity "
                                   "manifest; restoring it unverified",
                                   step)
                break
        if self.sharded:
            self.rt.barrier()
        return self.latest_step()

    # -- lifecycle -----------------------------------------------------------

    def wait(self) -> None:
        """Block until every save is committed and manifested (every
        process under a group calls it)."""
        with telemetry.span("ckpt_wait"):
            self._drain()

    def close(self) -> None:
        """Join the writer of a save still in flight."""
        if self._inflight is not None:
            self._inflight[1].join()


def _detached(state: Any) -> Any:
    if isinstance(state, dict):
        return {k: _detached(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach()
    return state

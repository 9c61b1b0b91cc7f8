"""Batch assembly: host rows → device tensors (port of ``data/loader.py``).

``ShardedDataLoader`` keeps the JAX loader's contract: the per-epoch
order from ``DistributedShardSampler``, wrap-padding of the final batch,
a prefetch thread that assembles batches ahead of the step loop, a
checkpointable position (``state_dict``/``load_state_dict``) that makes a
resume continue exactly where it stopped, and the same close/drain rules
for the prefetch worker. Batches are dicts of torch tensors on the
runtime's device: gathered on the host, pinned, and copied with
``non_blocking=True`` so the copy overlaps the running step.

Each process assembles only its own data shard's rows: shard ``s``
(dp-major over (dp, fsdp), ``runtime.data_shard_index``) takes rows
``[s*b, (s+1)*b)`` of the global batch of ``b * num_shards`` rows, the
JAX loader's layout, and the index stream is the JAX one. Under
sequence parallelism the ``sp`` members of a data shard read the same
rows, and each keeps its slice of every token row (``sequence_slice``:
its S/sp inputs and their shifted targets). A batch whose
assembly raises a transient IO error (``OSError``: a network file
system's blip under ``memmap_tokens``/``bytes``) is retried
``data_retries`` times with a short exponential backoff, one
``data_retry`` event each (``retry_transient``, the JAX policy), then
the error is raised. With a fault injector, ``on_data`` runs inside the
retried block, keyed by the optimizer's global step, so an injected
``data_error``/``data_stall`` takes the real recovery path.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, Mapping

import numpy as np
import torch

from distributed_training_tpu_torch.data.sampler import DistributedShardSampler
from distributed_training_tpu_torch.telemetry import events as telemetry

logger = logging.getLogger(__name__)

# Batches assembled ahead of the step loop (the JAX loader's default).
PREFETCH_DEPTH = 2
# The retryable failure class: host-side IO blips (TimeoutError is an
# OSError). A ValueError or KeyError stays fatal: malformed data does not
# improve on a second read.
TRANSIENT_DATA_ERRORS = (OSError,)


def retry_transient(assemble, *, retries: int, rollback=None,
                    **event_fields):
    """Run one batch assembly with a budget of ``retries`` retries of a
    transient failure (the JAX package's policy): a short exponential
    backoff (0.05 s doubling, at most 2 s) and a ``data_retry`` event per
    attempt (``event_fields`` name the position), then the error is
    raised. ``rollback`` (if given) runs after each failure, so a
    stateful assembler restarts the batch from its pre-batch snapshot
    and a retried batch equals an untried one."""
    attempt = 0
    while True:
        try:
            return assemble()
        except TRANSIENT_DATA_ERRORS as e:
            if rollback is not None:
                rollback()
            attempt += 1
            if attempt > retries:
                raise
            delay = min(2.0, 0.05 * 2 ** (attempt - 1))
            logger.warning(
                "transient data error (attempt %d/%d, retrying in "
                "%.2fs): %s: %s", attempt, retries, delay,
                type(e).__name__, e)
            telemetry.event(
                "data_retry", attempt=attempt, retries=retries,
                backoff_s=delay, error=f"{type(e).__name__}: {e}",
                **event_fields)
            time.sleep(delay)


def sequence_slice(tokens: np.ndarray, index: int, count: int) -> np.ndarray:
    """Slice ``index`` of ``count`` of next-token rows (B, S + 1): the
    slice's S/count inputs and their targets, columns ``[index·S/count,
    (index + 1)·S/count + 1)`` (the JAX layout shards the inputs and the
    shifted targets over ``sp`` alike)."""
    if count == 1:
        return tokens
    S = tokens.shape[1] - 1
    if S % count:
        raise ValueError(f"sequence length {S} does not split over "
                         f"sp={count}")
    n = S // count
    return tokens[:, index * n:(index + 1) * n + 1]


def seq_shard(runtime) -> tuple[int, int]:
    """(index, count) of this process's sequence slice."""
    return runtime.seq_shard_index, runtime.seq_shard_count


class ShardedDataLoader:
    """Epoch-based loader yielding dicts of tensors on the runtime's
    device: this process's data shard of each global batch.
    ``batch_size`` is per data shard; the global batch is
    ``batch_size * runtime.data_shard_count``."""

    def __init__(self, dataset, runtime, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, max_steps_per_epoch: int = 0,
                 data_retries: int = 2, fault_injector=None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        self.dataset = dataset
        self.runtime = runtime
        self.device = runtime.device
        self.batch_size = batch_size
        self.num_shards = runtime.data_shard_count
        self.shard_index = runtime.data_shard_index
        self.global_batch = batch_size * self.num_shards
        self.seq_index, self.seq_count = seq_shard(runtime)
        self.data_retries = data_retries
        self._faults = fault_injector
        self.sampler = DistributedShardSampler(
            len(dataset), self.num_shards, shuffle=shuffle, seed=seed,
            drop_last=drop_last)
        # The final partial batch is wrap-padded: every batch has the
        # same shape, as under the JAX loader.
        self.steps_per_epoch = -(-self.sampler.num_samples // batch_size)
        if max_steps_per_epoch:
            self.steps_per_epoch = min(self.steps_per_epoch,
                                       max_steps_per_epoch)
        # (epoch, batches consumed within it), committed as the consumer
        # takes each batch; ``_resume`` holds a restored position until
        # the matching epoch() picks it up.
        self._position = (0, 0)
        self._resume: tuple[int, int] | None = None

    # -- checkpointable position -------------------------------------------

    def state_dict(self) -> dict:
        """Serializable pipeline position (rides the checkpoint meta)."""
        epoch, step = self._position
        if step >= self.steps_per_epoch:
            epoch, step = epoch + 1, 0
        return {
            "schema": 1,
            "impl": "sharded",
            "seed": self.sampler.seed,
            "epoch": epoch,
            "step_in_epoch": step,
            "steps_per_epoch": self.steps_per_epoch,
            "num_shards": self.num_shards,
            "batch_size": self.batch_size,
            "shuffle": self.sampler.shuffle,
            "samples_consumed": (epoch * self.steps_per_epoch + step)
            * self.global_batch,
            "mid_epoch": step > 0,
        }

    def load_state_dict(self, d) -> None:
        if d.get("schema") != 1 or d.get("impl") != "sharded":
            raise ValueError(
                f"unsupported loader state (schema={d.get('schema')!r}, "
                f"impl={d.get('impl')!r})")
        if d.get("shuffle") not in (None, self.sampler.shuffle):
            raise ValueError(
                f"checkpointed loader shuffle={d.get('shuffle')} != "
                f"configured {self.sampler.shuffle}; the epoch orders "
                "diverge")
        if int(d.get("seed", self.sampler.seed)) != self.sampler.seed:
            raise ValueError(
                f"checkpointed loader seed {d.get('seed')} != configured "
                f"{self.sampler.seed}; the permutations diverge")
        epoch, step = int(d["epoch"]), int(d["step_in_epoch"])
        for field_name, current in (
                ("steps_per_epoch", self.steps_per_epoch),
                ("num_shards", self.num_shards),
                ("batch_size", self.batch_size)):
            saved = d.get(field_name)
            if saved not in (None, current) and step > 0:
                # The mid-epoch offset names other rows under another
                # epoch geometry; the trainer then replays the epoch.
                raise ValueError(
                    f"loader {field_name} changed {saved} -> {current} "
                    "across restart; the mid-epoch offset is not "
                    "transferable")
        self._position = (epoch, step)
        self._resume = (epoch, step)

    @property
    def resume_epoch(self) -> int:
        """The epoch the current position falls in."""
        epoch, step = self._position
        return epoch + 1 if step >= self.steps_per_epoch else epoch

    def seek_epoch(self, epoch: int) -> None:
        """Position the loader at an epoch boundary."""
        self._position = (epoch, 0)
        self._resume = (epoch, 0)

    def _epoch_shard_orders(self, epoch: int) -> np.ndarray:
        """(num_shards, num_samples) index matrix for this epoch, with
        per-shard wrap padding up to a batch multiple."""
        self.sampler.set_epoch(epoch)
        per_shard = np.stack([self.sampler.shard_indices(s)
                              for s in range(self.num_shards)])
        need = self.steps_per_epoch * self.batch_size
        if per_shard.shape[1] < need:
            reps = -(-need // per_shard.shape[1])
            per_shard = np.concatenate([per_shard] * (reps + 1),
                                       axis=1)[:, :need]
        return per_shard

    def _assemble(self, rows_by_shard: np.ndarray) -> dict:
        """The given shards' rows (shard-major) as device tensors."""
        host = self.dataset.batch(rows_by_shard.reshape(-1))
        if self.seq_count > 1:
            host = dict(host, tokens=sequence_slice(
                host["tokens"], self.seq_index, self.seq_count))
        out = {}
        for name, col in host.items():
            t = torch.from_numpy(np.ascontiguousarray(col))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[name] = t
        return out

    def epoch(self, epoch: int) -> Iterator[Mapping[str, torch.Tensor]]:
        """Iterate one epoch's batches with background prefetch. A
        restored position makes the matching epoch start at the saved
        batch offset. Closing the iterator early stops and joins the
        prefetch worker."""
        start = 0
        if self._resume is not None and self._resume[0] == epoch:
            start = min(self._resume[1], self.steps_per_epoch)
        self._resume = None
        orders = self._epoch_shard_orders(epoch)

        def produce():
            for step in range(start, self.steps_per_epoch):
                sl = slice(step * self.batch_size,
                           (step + 1) * self.batch_size)
                rows = orders[self.shard_index:self.shard_index + 1, sl]
                fault_step = epoch * self.steps_per_epoch + step + 1

                def assemble(rows=rows, fault_step=fault_step):
                    if self._faults is not None:
                        self._faults.on_data(fault_step)
                    return self._assemble(rows)

                with telemetry.span("data_assemble", step_in_epoch=step):
                    batch = retry_transient(
                        assemble, retries=self.data_retries, epoch=epoch,
                        step_in_epoch=step)
                yield batch

        it = _prefetch(produce(), PREFETCH_DEPTH)
        step = start
        try:
            for batch in it:
                step += 1
                self._position = (epoch, step)
                yield batch
            self._position = (epoch + 1, 0)
        finally:
            it.close()

    def __len__(self) -> int:
        return self.steps_per_epoch


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` in a daemon thread, keeping ``depth`` items ready.

    A consumer that stops early must not strand the worker blocked on
    ``q.put``: puts are stop-aware, and the generator's ``finally``
    signals stop, drains the queue, and joins the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            put(_END)

    t = threading.Thread(target=worker, name="data-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)

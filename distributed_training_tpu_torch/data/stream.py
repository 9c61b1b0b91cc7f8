"""Exactly-once streaming pipeline: deterministic, resumable,
multi-source (port of ``data/stream.py``).

The whole pipeline position is a small serializable ``StreamState``, and
every consumption decision is a pure function of it, with the JAX
module's integer arithmetic, so the port's blocks equal the JAX
loader's token for token for the same sources, seed and world history:

- **Per-source order**: source ``i``'s pass ``e`` reads its rows in
  ``epoch_permutation(seed, e, n_i, stream=i)`` order, recomputed from
  integers, so a position serializes as ``(epoch, cursor)`` per source.
- **Mixture**: the source of the next document is picked by deficit
  round-robin over the per-source consumed counts (``pick_source``), so
  the realized mixture follows from the cursors alone.
- **Packing**: documents concatenate into blocks of ``pack_len + 1``
  tokens (the ``+1`` keeps the next-token shift). A block boundary can
  land mid-document; the carry is stored as a pointer ``(source, epoch,
  pos, offset)``, and a restore re-reads the document and skips the
  consumed prefix.
- **Sharding**: packed sample ``s`` is row ``s % global_batch`` of step
  ``s // global_batch``; data shard ``k`` takes rows ``[k*b, (k+1)*b)``
  of each step, a pure function of ``(state, world_size)``; under
  sequence parallelism each ``sp`` member keeps its slice of those rows
  (``loader.sequence_slice``). With a
  world-size-invariant global batch (``train.global_batch_size``) an
  elastic resize re-deals only the rows not yet consumed.

**Exactly-once**: for any save point and any world-size history, the
batches consumed across incarnations concatenate to the uninterrupted
run's token stream. A corrupt sample skipped under ``policy=skip`` is
recorded (a ``data_skip`` event with ``(source, sample_id)``, counted in
``StreamState.skipped``). Each batch taken emits a ``data_batch`` event
with the sha256 of the whole global batch's rows, the same at any world
size, which is how a run's consumed stream is compared with another's.
The trainer stores ``state_dict()`` in every checkpoint's meta (under
the step's sha256 manifest) and restores it before the first batch.

Failure policy at read time: a transient ``OSError`` is retried with
backoff (``retry_transient``, with a rollback of the working state); a
sample raising an exception whose ``corrupt_policy`` is ``"skip"``
(``CorruptSampleError``, or the injected ``data_corrupt`` fault) is
recorded and skipped, at most ``MAX_CONSECUTIVE_SKIPS`` in a row; any
other error propagates.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from distributed_training_tpu_torch.data.loader import (
    _prefetch,
    retry_transient,
    seq_shard,
    sequence_slice,
)
from distributed_training_tpu_torch.data.sampler import epoch_permutation
from distributed_training_tpu_torch.telemetry import events as telemetry

logger = logging.getLogger(__name__)

STATE_SCHEMA = 1

# Consecutive skip-and-record corrupt samples before the stream gives
# up and escalates to a fatal error: pervasive corruption (a rotted
# shard where EVERY read fails validation) must surface as a loud
# incident, not an infinite cursor spin that only the hang watchdog
# ever notices.
MAX_CONSECUTIVE_SKIPS = 64


class StreamStateError(ValueError):
    """A checkpointed stream state this loader cannot drive (schema or
    source-set mismatch). The trainer falls back to an epoch-boundary
    resume instead of guessing a position."""


class CorruptSampleError(ValueError):
    """A sample that failed validation at read time. Carries the
    recovery policy the stream applies: ``"skip"`` → record a
    ``data_skip`` event (source, sample_id) and continue; ``"fatal"``
    → propagate. Deliberately NOT an OSError: corrupt bytes do not
    improve on a retry. The injected ``data_corrupt`` fault
    (resilience/faults.py) raises a duck-type-compatible exception
    (same ``corrupt_policy`` attribute) so the injected path IS the
    real skip/fatal path."""

    def __init__(self, msg: str, policy: str = "skip"):
        super().__init__(msg)
        self.corrupt_policy = policy


@dataclass(frozen=True)
class StreamSource:
    """One named source in the mixture. ``weight`` is relative; the
    realized mixture converges to ``weight / sum(weights)`` in
    documents consumed."""

    name: str
    dataset: object
    weight: float = 1.0


class StreamState:
    """The ENTIRE pipeline position, serializable as a small dict.

    ``step`` counts optimizer batches fully consumed, ``samples``
    counts packed rows emitted (``samples == step * global_batch`` at
    every batch boundary), ``epochs[i]``/``cursors[i]`` are source
    ``i``'s pass count and position within its current permutation,
    ``carry`` points at a partially packed document, ``skipped``
    counts corrupt samples deliberately skipped (and recorded)."""

    def __init__(self, seed: int, names: Sequence[str],
                 sizes: Sequence[int] | None = None):
        self.seed = int(seed)
        self.names = tuple(names)
        # Source sizes are part of the stream identity too: the
        # permutation of pass e is epoch_permutation(seed, e, n), so a
        # corpus that grew or shrank across a restart is a DIFFERENT
        # stream (from_dict rejects the mismatch).
        self.sizes = tuple(int(s) for s in sizes) if sizes else None
        self.step = 0
        self.samples = 0
        self.skipped = 0
        self.epochs = [0] * len(self.names)
        self.cursors = [0] * len(self.names)
        self.carry: dict | None = None

    def clone(self) -> "StreamState":
        out = StreamState(self.seed, self.names, self.sizes)
        out.assign(self)
        return out

    def assign(self, other: "StreamState") -> None:
        """In-place copy (the retry path rolls a working state back to
        its pre-batch snapshot without rebinding closures)."""
        self.seed = other.seed
        self.names = other.names
        self.sizes = other.sizes
        self.step = other.step
        self.samples = other.samples
        self.skipped = other.skipped
        self.epochs = list(other.epochs)
        self.cursors = list(other.cursors)
        self.carry = dict(other.carry) if other.carry else None

    def to_dict(self) -> dict:
        """Checkpoint form — JSON-serializable, name-keyed (a source
        set that changed across restarts fails loudly in
        ``from_dict``, never silently misaligns cursors)."""
        return {
            "schema": STATE_SCHEMA,
            "impl": "stream",
            "seed": self.seed,
            "step": self.step,
            "samples_consumed": self.samples,
            "skipped": self.skipped,
            "sources": {
                name: {"epoch": self.epochs[i],
                       "cursor": self.cursors[i],
                       "size": self.sizes[i] if self.sizes else None}
                for i, name in enumerate(self.names)},
            "carry": dict(self.carry) if self.carry else None,
        }

    @classmethod
    def from_dict(cls, d: Mapping, seed: int, names: Sequence[str],
                  sizes: Sequence[int] | None = None) -> "StreamState":
        if d.get("schema") != STATE_SCHEMA or d.get("impl") != "stream":
            raise StreamStateError(
                f"unsupported stream state (schema={d.get('schema')!r}, "
                f"impl={d.get('impl')!r})")
        saved = d.get("sources") or {}
        # ORDER matters, not just the set: the source index keys each
        # source's permutation stream and breaks mixture ties, so a
        # reordered config is a DIFFERENT stream — restoring cursors
        # (or the positional carry) into it would silently splice
        # wrong documents.
        if list(saved) != list(names):
            raise StreamStateError(
                f"checkpointed sources {list(saved)} != configured "
                f"{list(names)} — the mixture (or its order, which "
                "keys the per-source permutation streams) changed; "
                "cursors cannot be mapped")
        if int(d.get("seed", seed)) != int(seed):
            raise StreamStateError(
                f"checkpointed stream seed {d.get('seed')} != configured "
                f"{seed} — the permutations would diverge")
        if sizes:
            for name, n in zip(names, sizes):
                saved_n = saved[name].get("size")
                if saved_n is not None and int(saved_n) != int(n):
                    raise StreamStateError(
                        f"source {name!r} changed size {saved_n} -> "
                        f"{n} across restart — its permutations "
                        "diverge; cursors cannot be mapped")
        st = cls(seed, names, sizes)
        st.step = int(d.get("step", 0))
        st.samples = int(d.get("samples_consumed", 0))
        st.skipped = int(d.get("skipped", 0))
        for i, name in enumerate(st.names):
            st.epochs[i] = int(saved[name]["epoch"])
            st.cursors[i] = int(saved[name]["cursor"])
        carry = d.get("carry")
        st.carry = dict(carry) if carry else None
        return st


def pick_source(weights: Sequence[float],
                consumed: Sequence[int]) -> int:
    """Deficit round-robin: the source owed the most documents at this
    point of the stream. A pure function of the cursors, so the
    mixture schedule checkpoints with them; ties break to the lowest
    index (stable under restart by construction)."""
    total = sum(consumed) + 1
    wsum = sum(weights)
    best, best_deficit = 0, None
    for i, (w, c) in enumerate(zip(weights, consumed)):
        deficit = (w / wsum) * total - c
        if best_deficit is None or deficit > best_deficit:
            best, best_deficit = i, deficit
    return best


def _doc_tokens(dataset, row: int) -> np.ndarray:
    """One document's tokens. Ragged datasets expose ``doc(i)``;
    fixed-row datasets serve through the columnar ``batch``."""
    if hasattr(dataset, "doc"):
        return np.asarray(dataset.doc(row))
    return np.asarray(dataset.batch(np.array([row]))["tokens"][0])


class StreamingDataLoader:
    """Multi-source exactly-once loader with the ShardedDataLoader
    interface (``steps_per_epoch``/``global_batch``/``epoch()``), so
    the Trainer drives either interchangeably.

    Every process assembles the same deterministic global batch and
    keeps its data shard's rows ``[k*b, (k+1)*b)`` as a tensor on the
    runtime's device (pinned and copied with ``non_blocking``) —
    content depends only on ``(sources, seed, pack_len, global
    batch)``, never on the world size, which is what makes the elastic
    resize exactly-once. ``batch_size`` is per data shard (derive it
    from a world-size-invariant ``train.global_batch_size`` for
    elastic runs).

    An "epoch" is a bookkeeping window of ``steps_per_epoch`` batches
    over the endless stream (sources rewind per-source with fresh
    permutations), defaulting to one nominal pass: ``total_docs //
    global_batch``.
    """

    def __init__(self, sources: Sequence[StreamSource], runtime,
                 batch_size: int, pack_len: int = 0, shuffle: bool = True,
                 seed: int = 0, steps_per_epoch: int = 0,
                 prefetch_depth: int = 2, data_retries: int = 2,
                 fault_injector=None):
        if not sources:
            raise ValueError("StreamingDataLoader needs >= 1 source")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        names = [s.name for s in sources]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate source names: {names}")
        for s in sources:
            if s.weight <= 0:
                raise ValueError(
                    f"source {s.name!r} weight must be > 0, got {s.weight}")
            if len(s.dataset) <= 0:
                raise ValueError(f"source {s.name!r} dataset is empty")
        self.sources = tuple(sources)
        self.runtime = runtime
        self.batch_size = batch_size
        self.device = runtime.device
        self.num_shards = runtime.data_shard_count
        self.shard_index = runtime.data_shard_index
        self.global_batch = batch_size * self.num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.pack_len = int(pack_len)
        if self.pack_len < 0:
            raise ValueError(f"pack_len must be >= 0, got {pack_len}")
        # Row shape: pack_len+1 tokens packed, else the (uniform)
        # source row length — probing one document per source only in
        # the unpacked mode that needs it (a probe is a real read on
        # a remote/memmap corpus). Ragged sources require packing —
        # without it there is no fixed batch shape to emit.
        if self.pack_len:
            self.block_len = self.pack_len + 1
        else:
            ragged = [s.name for s in self.sources
                      if hasattr(s.dataset, "doc")]
            if ragged:
                # The ``doc()`` protocol declares per-row lengths may
                # vary — a doc-0 probe can't prove uniformity, and a
                # mid-run length mismatch would be a deterministic
                # crash loop (the permutation replays to the same odd
                # doc every restart). Fail at construction instead.
                raise ValueError(
                    f"source(s) {ragged} are ragged (expose doc()); "
                    "without packing there is no fixed batch shape — "
                    "set train.pack_seq_len")
            lens = {s.name: len(_doc_tokens(s.dataset, 0))
                    for s in self.sources}
            if len(set(lens.values())) != 1:
                raise ValueError(
                    "without packing (pack_len=0) every source must "
                    f"yield equal-length rows; got {lens} — set "
                    "train.pack_seq_len to pack mixed lengths")
            self.block_len = next(iter(lens.values()))
        total_docs = sum(len(s.dataset) for s in self.sources)
        self.steps_per_epoch = max(
            1, steps_per_epoch or total_docs // self.global_batch)
        self.prefetch_depth = prefetch_depth
        self.data_retries = data_retries
        self._faults = fault_injector
        # Per-source permutation cache {src: {epoch: perm}} — see
        # _row_at. Derived data only; never serialized.
        self._perms: dict[int, dict[int, np.ndarray]] = {}
        # In-memory tokens of the carried (partially packed) document,
        # keyed by its carry pointer — the pointer alone is what
        # serializes; this cache just avoids re-reading the straddling
        # document at every block boundary (a ~2x read amplification
        # on short docs). Keyed lookups make rollback/restore
        # staleness self-resolving.
        self._carry_toks: tuple[tuple[int, int, int], np.ndarray] | None \
            = None
        self.state = StreamState(seed, names, self._sizes())
        vocabs = [getattr(s.dataset, "vocab_size", None)
                  for s in self.sources]
        vocabs = [v for v in vocabs if v]
        self.dataset = _StreamProbe(
            total_docs, self.block_len,
            vocab_size=max(vocabs) if vocabs else None)

    def _sizes(self) -> list[int]:
        return [len(s.dataset) for s in self.sources]

    # -- checkpointable position -------------------------------------------

    def state_dict(self) -> dict:
        """The pipeline position + the mixture evidence the resume
        telemetry event carries (realized vs target, derived from the
        cursors — nothing here is sampled at save time)."""
        d = self.state.to_dict()
        d["realized_mixture"] = self.realized_mixture()
        d["target_mixture"] = self.target_mixture()
        d["mid_epoch"] = self.state.step % self.steps_per_epoch != 0
        d["global_batch"] = self.global_batch
        d["shuffle"] = self.shuffle
        return d

    def load_state_dict(self, d: Mapping) -> None:
        if d.get("shuffle") not in (None, self.shuffle):
            # Same failure class as a seed change: shuffle toggles
            # every per-source permutation between shuffled and
            # arange, so cursors (and the carry pointer) would index
            # a different stream.
            raise StreamStateError(
                f"checkpointed shuffle={d.get('shuffle')} != "
                f"configured {self.shuffle} — the permutations "
                "diverge; cursors cannot be mapped")
        saved_gb = d.get("global_batch")
        if saved_gb not in (None, self.global_batch):
            # step/samples count in units of the global batch; a
            # different global batch (legacy per-shard batch_size
            # under an elastic resize) makes the cursors — and the
            # documented samples == step * global_batch invariant —
            # unit-incoherent. Reject; the trainer falls back to the
            # honest epoch-boundary resume. Elastic runs preserve the
            # global batch via train.global_batch_size, which keeps
            # this invariant across any world size.
            raise StreamStateError(
                f"checkpointed global batch {saved_gb} != configured "
                f"{self.global_batch} — the stream's step/sample units "
                "diverge; set train.global_batch_size for elastic runs")
        self.state = StreamState.from_dict(
            d, self.seed, [s.name for s in self.sources],
            self._sizes())

    @property
    def resume_epoch(self) -> int:
        """The epoch the current position falls in — what the trainer
        resumes INTO (mid-epoch positions land inside it)."""
        return self.state.step // self.steps_per_epoch

    def seek_epoch(self, epoch: int) -> None:
        """Fast-forward to an epoch boundary by replaying the stream's
        reads — the resume fallback when a checkpoint carries no
        usable stream state. Documents are re-read (so real
        corrupt-sample skips replay and the cursors land exactly where
        the consuming incarnation left them) but nothing is
        materialized or emitted, and injected faults NEVER fire — the
        replay consumes nothing; a stall/corruption here would be
        charged to samples a previous incarnation already trained on.
        Cannot rewind: the stream is forward-only by construction."""
        target = epoch * self.steps_per_epoch
        if target < self.state.step:
            raise StreamStateError(
                f"cannot seek backwards (step {self.state.step} -> "
                f"{target}); rebuild the loader instead")
        work = self.state.clone()
        pre_seek_skipped = work.skipped
        faults, self._faults = self._faults, None
        try:
            # Replay by actually reading (both modes): a pure-cursor
            # fast-forward would land short of the consumed position
            # whenever the original incarnation skip-and-recorded
            # corrupt samples — their cursor advances only replay if
            # the reads (and their skips) replay too. Those skips
            # were already recorded by the incarnation that consumed
            # them: collect into a throwaway buffer (no events) and
            # restore the counter below.
            discard: list[dict] = []
            while work.step < target:
                for _ in range(self.global_batch):
                    self._next_block(work, work.step + 1, discard)
                work.samples += self.global_batch
                work.step += 1
        finally:
            self._faults = faults
        work.skipped = pre_seek_skipped
        self.state = work

    def realized_mixture(self) -> dict[str, float]:
        counts = self._doc_counts(self.state)
        total = sum(counts) or 1
        return {s.name: round(c / total, 6)
                for s, c in zip(self.sources, counts)}

    def target_mixture(self) -> dict[str, float]:
        wsum = sum(s.weight for s in self.sources)
        return {s.name: round(s.weight / wsum, 6) for s in self.sources}

    # -- the deterministic stream ------------------------------------------

    def _doc_counts(self, state: StreamState) -> list[int]:
        return [state.epochs[i] * len(s.dataset) + state.cursors[i]
                for i, s in enumerate(self.sources)]

    def _row_at(self, src: int, epoch: int, pos: int) -> int:
        # Permutations are pure functions of (seed, src, epoch) but
        # O(n) to build — computing one per DOCUMENT would make a
        # source pass O(n^2). Cache per source, keeping the two
        # newest epochs (the carry may still point one epoch back).
        # Only the producer thread (or seek, with no producer live)
        # reads documents, so no locking is needed.
        cache = self._perms.setdefault(src, {})
        perm = cache.get(epoch)
        if perm is None:
            perm = epoch_permutation(self.seed, epoch,
                                     len(self.sources[src].dataset),
                                     shuffle=self.shuffle, stream=src)
            cache[epoch] = perm
            for e in sorted(cache)[:-2]:
                del cache[e]
        return int(perm[pos])

    def _advance_cursor(self, state: StreamState) -> tuple[int, int]:
        """Pick the next source and advance its cursor — the pure
        integer core every consumption decision reduces to. Returns
        ``(source index, row id)``."""
        src = pick_source([s.weight for s in self.sources],
                          self._doc_counts(state))
        epoch, pos = state.epochs[src], state.cursors[src]
        row = self._row_at(src, epoch, pos)
        state.cursors[src] += 1
        if state.cursors[src] >= len(self.sources[src].dataset):
            state.cursors[src] = 0
            state.epochs[src] += 1
        return src, row

    def _read_doc(self, state: StreamState, src: int, row: int,
                  fault_step: int, skips: list | None,
                  cached: np.ndarray | None = None
                  ) -> np.ndarray | None:
        """One document read under the full failure policy: the
        source-level fault hook fires first (so injected stalls and
        corruption hit every read path, carried documents included),
        then the skip-and-record handling — ``None`` means "this
        sample was recorded as skipped; move on". Skip records
        collect into ``skips`` so the caller emits them only once the
        batch COMMITS — emitting inside the retried block would
        double-count a skip whose batch is rolled back by a later
        transient error."""
        name = self.sources[src].name
        try:
            if self._faults is not None:
                self._faults.on_source(fault_step, name)
            if cached is not None:
                return cached
            return _doc_tokens(self.sources[src].dataset, row)
        except ValueError as e:
            policy = getattr(e, "corrupt_policy", "fatal")
            if policy != "skip":
                raise
            # Exactly-once accounting for the skip: the sample is
            # RECORDED (event + counter), never silently dropped.
            state.skipped += 1
            record = dict(source=name, sample_id=row, step=fault_step,
                          error=f"{type(e).__name__}: {e}")
            if skips is None:
                telemetry.event("data_skip", **record)
            else:
                skips.append(record)
            logger.warning(
                "skipping corrupt sample %s[%d] at step %d: %s",
                name, row, fault_step, e)
            return None

    def _next_doc(self, state: StreamState, fault_step: int,
                  skips: list | None = None
                  ) -> tuple[int, int, np.ndarray]:
        """Pull the next document — advancing cursors under the
        ``_read_doc`` failure policy, with a bound on consecutive
        skips (pervasive corruption must surface as an incident, not
        an infinite cursor spin)."""
        consecutive = 0
        while True:
            src, row = self._advance_cursor(state)
            toks = self._read_doc(state, src, row, fault_step, skips)
            if toks is not None:
                return src, row, toks
            consecutive += 1
            if consecutive > MAX_CONSECUTIVE_SKIPS:
                raise ValueError(
                    f"{consecutive} consecutive corrupt samples "
                    f"(last: {self.sources[src].name}[{row}]) — "
                    "pervasive corruption is an incident, not "
                    "something to skip past")

    def _next_block(self, state: StreamState, fault_step: int,
                    skips: list | None = None) -> np.ndarray:
        """One fixed-shape sample row: a whole document, or a packed
        ``block_len`` window continuing from the carry pointer."""
        if not self.pack_len:
            _src, _row, toks = self._next_doc(state, fault_step, skips)
            if len(toks) != self.block_len:
                raise ValueError(
                    f"unpacked row length {len(toks)} != {self.block_len}"
                    " (sources must be uniform without packing)")
            return np.asarray(toks, dtype=np.int32)
        out = np.empty((self.block_len,), dtype=np.int32)
        filled = 0
        while filled < self.block_len:
            if state.carry is not None:
                c = state.carry
                src_epoch_pos = (c["source"], c["epoch"], c["pos"])
                cached = (self._carry_toks[1]
                          if self._carry_toks is not None
                          and self._carry_toks[0] == src_epoch_pos
                          else None)
                row = self._row_at(*src_epoch_pos)
                # Same failure policy as fresh documents: the fault
                # hook fires (carry-only steps must not be a fault
                # blind spot) and a skip-policy corruption of the
                # carried doc drops its unconsumed remainder —
                # recorded — instead of crash-looping every restart
                # on the same carry pointer.
                toks = self._read_doc(state, c["source"], row,
                                      fault_step, skips, cached=cached)
                if toks is None:
                    state.carry = None
                    continue
                offset = c["offset"]
            else:
                src, _row, toks = self._next_doc(state, fault_step,
                                                 skips)
                offset = 0
                # The doc just consumed sits at cursor-1 of its
                # (possibly just-wrapped) permutation.
                pos = state.cursors[src] - 1
                epoch = state.epochs[src]
                if pos < 0:
                    pos = len(self.sources[src].dataset) - 1
                    epoch -= 1
                src_epoch_pos = (src, epoch, pos)
            take = min(len(toks) - offset, self.block_len - filled)
            out[filled:filled + take] = toks[offset:offset + take]
            filled += take
            if offset + take < len(toks):
                state.carry = {"source": src_epoch_pos[0],
                               "epoch": src_epoch_pos[1],
                               "pos": src_epoch_pos[2],
                               "offset": offset + take}
                self._carry_toks = (src_epoch_pos, toks)
            else:
                state.carry = None
        return out

    # -- batch production ---------------------------------------------------

    def _produce_step(self, work: StreamState
                      ) -> tuple[dict[str, torch.Tensor], StreamState,
                                 list[dict], str]:
        """Assemble the next global batch, advancing ``work`` — under
        the shared ``retry_transient`` policy, with ``work`` rolled
        back to its pre-batch snapshot before each retry so a retried
        batch is bit-identical to an untried one. Returns this shard's
        device batch, a consumed-state snapshot, the batch's skip
        records and the global batch's sha256; the CONSUMER commits
        them together — emitting
        skips here (the prefetch thread, up to depth batches ahead)
        would record skips of batches a preemption never consumes,
        which the resumed incarnation then records again."""
        fault_step = work.step + 1
        snapshot = work.clone()
        skips: list[dict] = []

        def assemble():
            # A retried attempt starts from a clean slate: the
            # rollback restored ``work``; the skip buffer must reset
            # with it or a re-skipped sample double-emits.
            skips.clear()
            if self._faults is not None:
                self._faults.on_data(fault_step)
            return np.stack([self._next_block(work, fault_step, skips)
                             for _ in range(self.global_batch)])

        rows = retry_transient(assemble, retries=self.data_retries,
                               rollback=lambda: work.assign(snapshot),
                               step=fault_step)
        work.samples += self.global_batch
        work.step += 1
        b = self.batch_size
        t = torch.from_numpy(np.ascontiguousarray(sequence_slice(
            rows[self.shard_index * b:(self.shard_index + 1) * b],
            *seq_shard(self.runtime))))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        digest = hashlib.sha256(rows.tobytes()).hexdigest()
        return {"tokens": t}, work.clone(), list(skips), digest

    def epoch(self, epoch: int) -> Iterator[Mapping[str, torch.Tensor]]:
        """Yield this epoch's REMAINING batches, continuing from the
        current (possibly restored, mid-epoch) position. The consumed
        position commits as each batch is handed over, so a save at
        any point records exactly the batches the trainer took."""
        spe = self.steps_per_epoch
        if not epoch * spe <= self.state.step < (epoch + 1) * spe:
            raise ValueError(
                f"epoch({epoch}) does not contain stream position "
                f"step={self.state.step} (steps_per_epoch={spe}) — "
                "resume must continue from the restored cursor")
        remaining = (epoch + 1) * spe - self.state.step
        work = self.state.clone()

        def produce():
            for k in range(remaining):
                # Assemble BEFORE yield (the ShardedDataLoader
                # discipline): the generator suspends at the yield, so
                # a span around it would stay open while the consumer
                # trains and the duration would be meaningless.
                with telemetry.span(
                        "data_assemble",
                        step_in_epoch=work.step - epoch * spe):
                    item = self._produce_step(work)
                yield item

        it = (_prefetch(produce(), self.prefetch_depth)
              if self.prefetch_depth > 0 else produce())
        try:
            for batch, consumed, skips, digest in it:
                # Commit point: position and skip evidence land
                # together, only for batches the trainer actually
                # takes (see _produce_step).
                self.state = consumed
                for record in skips:
                    telemetry.event("data_skip", **record)
                # The global batch's identity, the same at any world
                # size: concatenated across incarnations, these records
                # prove the stream was consumed exactly once.
                telemetry.event("data_batch", step=consumed.step,
                                samples=consumed.samples, sha256=digest)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def __len__(self) -> int:
        return self.steps_per_epoch


class _StreamProbe:
    """Cheap stand-in for ``loader.dataset`` so the Trainer's
    model/dataset contract checks (batch keys, vocab range) work
    without touching the stream position."""

    def __init__(self, total_docs: int, block_len: int,
                 vocab_size: int | None = None):
        self._total = total_docs
        self._block_len = block_len
        if vocab_size is not None:
            # Max over sources: the contract check must catch ANY
            # source whose ids exceed the model's embedding table.
            self.vocab_size = vocab_size
        self.seq_len = block_len - 1

    def __len__(self) -> int:
        return self._total

    def batch(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        return {"tokens": np.zeros((len(indices), self._block_len),
                                   dtype=np.int32)}


def build_stream_sources(specs: Mapping[str, Mapping], *,
                         defaults: Mapping | None = None
                         ) -> list[StreamSource]:
    """Sources from ``train.data_sources`` config: ``{name: {dataset:
    <registry name>, weight: W, **dataset kwargs}}``. Order follows
    the mapping (identical on every host — it comes from config)."""
    from distributed_training_tpu_torch.data.datasets import build_dataset
    sources: list[StreamSource] = []
    for name, spec in specs.items():
        if not isinstance(spec, Mapping) or "dataset" not in spec:
            raise ValueError(
                f"train.data_sources.{name} must be a mapping with a "
                f"'dataset' key, got {spec!r}")
        kwargs = dict(spec)
        ds_name = kwargs.pop("dataset")
        weight = float(kwargs.pop("weight", 1.0))
        ds = build_dataset(ds_name, _defaults=dict(defaults or {}),
                           **kwargs)
        sources.append(StreamSource(name=name, dataset=ds,
                                    weight=weight))
    return sources

"""Paged KV cache: fixed-size pages in one preallocated pool (port).

The port of ``distributed_training_tpu/serving/kv_cache.py`` for one dp
group. One reservation of ``num_pages`` pages of ``page_size`` tokens
per layer, kv-head-major, as torch tensors on the engine's device:

    k_pages, v_pages: (1, n_layers, n_kv_heads, num_pages, page_size,
                       head_dim)

The leading group dimension keeps the JAX package's layout; pools
sharded over dp groups wait for ROADMAP.md queue A 'Serving: dp groups
and a mesh'. A sequence owns an ordered list of physical page ids (its
page table); logical position ``p`` lives in slot ``p % page_size`` of
its ``p // page_size``-th page. Join = allocate pages from the free
list, evict = return them — no copying, and the pools never change
shape. The engine writes them in place.

**Page 0 is the scratch page**: never allocated, the write target for
inactive batch slots and padding positions. Unused page-table entries
also point at it; attention masks those slots out by position, so the
scratch page is never read as a live page.

**Accounting** is host-side Python; every alloc/free emits a
``serving_kv`` telemetry record. Invariant: ``pages_used + free ==
num_pages - 1`` always, and freeing every sequence returns occupancy to
zero.

**Sharing**: pages are refcounted. ``attach`` takes read-only references
on another sequence's committed pages; ``free`` returns a page to the
free list only when its last owner releases it. A prefix index maps the
exact bytes of each page-aligned token prefix to the page ids holding
its KV (``register_prefix``/``match_prefix``); entries are registered
only for fully committed pages and die with their last page.
``privatize`` is the copy-on-write half: before a sequence writes into a
page it shares, the page is swapped for a fresh private one and the
caller copies it on the device. ``rename`` moves a table between owner
keys without touching refcounts (session retention).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distributed_training_tpu_torch.runtime import resolve_device
from distributed_training_tpu_torch.telemetry import event

_DP_ITEM = "ROADMAP.md queue A 'Serving: dp groups and a mesh'"


@dataclass(frozen=True)
class PagedCacheConfig:
    """Pool geometry. ``max_seq_len`` bounds pages per sequence;
    ``num_pages`` includes the scratch page 0."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16
    num_pages: int = 128
    max_seq_len: int = 256
    dtype: str = "float32"
    dp_groups: int = 1

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got "
                             f"{self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is scratch), got "
                f"{self.num_pages}")
        if self.max_seq_len % self.page_size:
            raise ValueError(
                f"max_seq_len ({self.max_seq_len}) must be a multiple "
                f"of page_size ({self.page_size})")
        if self.dp_groups != 1:
            raise NotImplementedError(
                f"dp_groups={self.dp_groups}: pools sharded over dp "
                f"groups wait for {_DP_ITEM}")

    @property
    def pages_per_seq(self) -> int:
        return self.max_seq_len // self.page_size

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1  # minus scratch


class PagedKVCache:
    """The pool + its host-side allocator and page tables.

    ``device=None`` places the pools on the CUDA card (raising without
    one); the tests pass ``device="cpu"``."""

    def __init__(self, cfg: PagedCacheConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.dp_groups, cfg.n_layers, cfg.n_kv_heads,
                 cfg.num_pages, cfg.page_size, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)
        # LIFO free list: recently freed pages are re-handed first
        # (deterministic for the join/evict permutations the tests run).
        self._free: list[int] = list(range(cfg.num_pages - 1, 0, -1))
        self._tables: dict[object, list[int]] = {}
        self._lengths: dict[object, int] = {}
        # ``_refs[page]`` counts the tables holding ``page`` (absent ==
        # free); ``_index`` maps the bytes of a page-aligned token
        # prefix to the page ids holding its KV; ``_page_keys`` maps a
        # page id to the index keys whose LAST page it is (a key dies
        # exactly when its last page is released). ``_registered``
        # counts each sequence's pages already indexed.
        self._refs: dict[int, int] = {}
        self._index: dict[bytes, tuple] = {}
        self._page_keys: dict[int, set] = {}
        self._registered: dict[object, int] = {}

    # -- allocator ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.cfg.usable_pages - len(self._free)

    @property
    def seqs(self) -> int:
        return len(self._tables)

    def _emit(self, op: str, seq_id) -> None:
        event("serving_kv", op=op, seq=str(seq_id), group=0,
              pages_used=self.pages_used,
              pages_total=self.cfg.usable_pages, seqs=self.seqs)

    def can_admit(self, n_tokens: int) -> bool:
        """Would ``ensure`` succeed for a new sequence of n_tokens?"""
        need = -(-max(1, n_tokens) // self.cfg.page_size)
        return need <= len(self._free)

    def join(self, seq_id) -> None:
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id!r} already joined")
        self._tables[seq_id] = []
        self._lengths[seq_id] = 0
        self._emit("join", seq_id)

    def ensure(self, seq_id, n_tokens: int) -> bool:
        """Grow seq_id's table to cover ``n_tokens`` total positions.
        Returns False (allocating nothing) when the free list cannot
        cover the growth; the engine treats that as backpressure."""
        if n_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"sequence {seq_id!r} needs {n_tokens} positions, "
                f"pool max_seq_len is {self.cfg.max_seq_len}")
        table = self._tables[seq_id]
        need = -(-n_tokens // self.cfg.page_size) - len(table)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            page = self._free.pop()
            self._refs[page] = 1
            table.append(page)
        self._emit("grow", seq_id)
        return True

    def advance(self, seq_id, n_tokens: int) -> None:
        """Record ``n_tokens`` more positions as written (pages must
        already be ensured)."""
        new_len = self._lengths[seq_id] + n_tokens
        table = self._tables[seq_id]
        if new_len > len(table) * self.cfg.page_size:
            raise RuntimeError(
                f"sequence {seq_id!r}: advancing to {new_len} "
                f"positions but only {len(table)} page(s) allocated "
                "— ensure() first")
        self._lengths[seq_id] = new_len

    def free(self, seq_id) -> int:
        """Evict: drop one reference on each of the sequence's pages;
        pages whose last reference this was go back to the free list
        (and their prefix-index entries die with them). Returns the
        page count released."""
        table = self._tables.pop(seq_id)
        del self._lengths[seq_id]
        released = []
        for page in table:
            self._refs[page] -= 1
            if self._refs[page] == 0:
                del self._refs[page]
                self._invalidate(page)
                released.append(page)
        self._free.extend(reversed(released))
        self._registered.pop(seq_id, None)
        self._emit("free", seq_id)
        return len(released)

    def length(self, seq_id) -> int:
        return self._lengths[seq_id]

    # -- sharing: refcounted attach / COW / prefix index -------------------

    def attach(self, seq_id, pages, n_tokens: int) -> None:
        """Take read-only references on ``pages`` (a resident prefix,
        in table order) for a joined sequence with an empty table, and
        mark ``n_tokens`` positions as written. Attaching a freed page
        is a KeyError, not a silent corruption."""
        table = self._tables[seq_id]
        if table or self._lengths[seq_id]:
            raise RuntimeError(
                f"sequence {seq_id!r} already has pages — attach is "
                "admission-time only")
        if n_tokens > len(pages) * self.cfg.page_size:
            raise ValueError(
                f"sequence {seq_id!r}: attaching {len(pages)} page(s) "
                f"cannot cover {n_tokens} positions")
        for page in pages:
            self._refs[page] = self._refs[page] + 1  # KeyError if free
        table.extend(pages)
        self._lengths[seq_id] = n_tokens
        # The attached prefix is already indexed.
        self._registered[seq_id] = len(pages)
        self._emit("attach", seq_id)

    def rename(self, old_id, new_id) -> None:
        """Move a table between owner keys (refcounts untouched)."""
        if new_id in self._tables:
            raise KeyError(f"sequence {new_id!r} already joined")
        self._tables[new_id] = self._tables.pop(old_id)
        self._lengths[new_id] = self._lengths.pop(old_id)
        if old_id in self._registered:
            self._registered[new_id] = self._registered.pop(old_id)

    def privatize(self, seq_id):
        """Copy-on-write bookkeeping: swap every shared page at or past
        the sequence's write frontier (``length // page_size``) for a
        fresh private page. Returns the ``(src, dst)`` page pairs for
        the caller's device copy ([] when nothing was shared), or None —
        allocating nothing — when the free list cannot cover the swap."""
        table = self._tables[seq_id]
        start = self._lengths[seq_id] // self.cfg.page_size
        idxs = [i for i in range(start, len(table))
                if self._refs[table[i]] > 1]
        if len(idxs) > len(self._free):
            return None
        pairs = []
        for i in idxs:
            src = table[i]
            dst = self._free.pop()
            self._refs[src] -= 1
            self._refs[dst] = 1
            table[i] = dst
            pairs.append((src, dst))
        if pairs:
            # Registration counts only pages below the forked one.
            if self._registered.get(seq_id, 0) > idxs[0]:
                self._registered[seq_id] = idxs[0]
            self._emit("cow", seq_id)
        return pairs

    def register_prefix(self, seq_id, tokens) -> None:
        """Index every fully committed page-aligned prefix of
        ``tokens`` (the sequence's token history) not yet registered,
        keyed by the exact prefix bytes."""
        table = self._tables[seq_id]
        ps = self.cfg.page_size
        full = self._lengths[seq_id] // ps
        done = self._registered.get(seq_id, 0)
        if full <= done:
            return
        toks = np.array(tokens, np.int32)
        for j in range(done + 1, full + 1):
            key = toks[:j * ps].tobytes()
            self._index[key] = tuple(table[:j])
            self._page_keys.setdefault(table[j - 1], set()).add(key)
        self._registered[seq_id] = full

    def needs_register(self, seq_id) -> bool:
        """Does the sequence have committed pages not yet indexed?"""
        return (self._lengths[seq_id] // self.cfg.page_size
                > self._registered.get(seq_id, 0))

    def match_prefix(self, tokens):
        """Longest indexed page-aligned prefix of ``tokens``:
        ``(pages, n_pages)`` or ``((), 0)``."""
        if not self._index:
            return (), 0
        toks = np.array(tokens, np.int32)
        ps = self.cfg.page_size
        for j in range(len(toks) // ps, 0, -1):
            pages = self._index.get(toks[:j * ps].tobytes())
            if pages is not None:
                return pages, j
        return (), 0

    def _invalidate(self, page: int) -> None:
        """Drop the index entries whose last page just died."""
        for key in self._page_keys.pop(page, ()):
            self._index.pop(key, None)

    def shared_pages(self) -> int:
        """Pages held by more than one table."""
        return sum(1 for n in self._refs.values() if n > 1)

    def token_capacity(self, seq_id) -> int:
        """Max total positions this sequence could hold right now: its
        allocated pages plus the whole free list, capped by
        max_seq_len. The resident decode path sizes burst budgets
        against this, so a burst never writes past what ``ensure`` can
        cover."""
        pages = len(self._tables[seq_id]) + len(self._free)
        return min(pages * self.cfg.page_size, self.cfg.max_seq_len)

    def occupancy(self) -> dict:
        return {"pages_used": self.pages_used,
                "pages_total": self.cfg.usable_pages,
                "seqs": self.seqs}

    # -- device-side views -------------------------------------------------

    def page_row(self, seq_id) -> np.ndarray:
        """(pages_per_seq,) int32 page-table row, scratch-padded."""
        row = np.zeros((self.cfg.pages_per_seq,), np.int32)
        table = self._tables[seq_id]
        row[:len(table)] = table
        return row

    def page_rows(self, seq_ids: list, width: int | None = None
                  ) -> np.ndarray:
        """(width, pages_per_seq) int32 table (width defaults to
        ``len(seq_ids)``); ``None`` entries and the padding up to
        ``width`` are all-scratch rows."""
        rows = np.zeros((width if width is not None else len(seq_ids),
                         self.cfg.pages_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is not None:
                rows[i] = self.page_row(sid)
        return rows

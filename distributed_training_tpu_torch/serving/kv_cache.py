"""Paged KV cache: fixed-size pages in preallocated pools (port).

The port of ``distributed_training_tpu/serving/kv_cache.py``.
``dp_groups`` independent pools of ``num_pages`` pages of ``page_size``
tokens per layer, kv-head-major, as torch tensors on the engine's
device. Without a mesh this process holds every group (the JAX layout):

    k_pages, v_pages: (dp_groups, n_layers, n_kv_heads, num_pages,
                       page_size, head_dim)

On a mesh (the port's ``Runtime``: one process per mesh rank) every
process keeps the host allocator of every group, in lock-step with the
others, but holds on the device only its own group's shard, at its tp
rank's contiguous block of kv heads (``pool_shard``):

    k_pages, v_pages: (1, n_layers, n_kv_heads / tp, num_pages,
                       page_size, head_dim)

which is the block a JAX program body sees inside its shard_map over
dp with the kv heads split over tp. A sequence owns an ordered list of
physical page ids (its page table) inside one group's pool; logical
position ``p`` lives in slot ``p % page_size`` of its ``p // page_size``-th
page. Join = allocate pages from the group's free list, evict = return
them — no copying, and the pools never change shape. The engine writes
them in place.

**Page 0 of every group is its scratch page**: never allocated, the
write target for inactive batch slots and padding positions. Unused
page-table entries also point at it; attention masks those slots out by
position, so the scratch page is never read as a live page.

**Accounting** is host-side Python, per group; every alloc/free emits a
``serving_kv`` telemetry record with the owning group. Invariant, per
group: ``pages_used_in(g) + free == num_pages - 1`` always, and freeing
every sequence returns every group's occupancy to zero; no join/evict
order lets one group's allocation bleed into another's pool.

**Sharing**: pages are refcounted per (group, page). ``attach`` takes
read-only references on another sequence's committed pages; ``free``
returns a page to the free list only when its last owner releases it.
A group-local prefix index maps the exact bytes of each page-aligned
token prefix to the page ids holding its KV
(``register_prefix``/``match_prefix``); entries are registered only for
fully committed pages and die with their last page. ``privatize`` is the
copy-on-write half: before a sequence writes into a page it shares, the
page is swapped for a fresh private one and the caller copies it on the
device. ``rename`` moves a table between owner keys without touching
refcounts (session retention).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distributed_training_tpu_torch.runtime import resolve_device
from distributed_training_tpu_torch.telemetry import event


@dataclass(frozen=True)
class PagedCacheConfig:
    """Pool geometry. ``max_seq_len`` bounds pages per sequence;
    ``num_pages`` is per group (each dp group owns a pool of
    ``num_pages`` pages, scratch page 0 included)."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16
    num_pages: int = 128          # per group, scratch page 0 included
    max_seq_len: int = 256
    dtype: str = "float32"
    dp_groups: int = 1            # leading pool dim / allocator groups

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
        if self.dp_groups < 1:
            raise ValueError(
                f"dp_groups must be >= 1, got {self.dp_groups}")

    @property
    def pages_per_seq(self) -> int:
        return self.max_seq_len // self.page_size

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1  # per group, minus scratch

    @property
    def usable_pages_total(self) -> int:
        return self.dp_groups * self.usable_pages


def pool_shard(mesh, n_kv_heads: int, dp_groups: int,
               kv_axis: str | None, dp_axis: str | None):
    """This process's block of the pool on ``mesh`` (a ``Runtime``):
    ``(group, first kv head, kv heads)``, ``group`` None when the pool
    is not split over dp (every group held); None without a mesh (every
    group, every head). The JAX ``pool_sharding``'s rules: the group dim
    over ``dp_axis`` and the kv-head dim over ``kv_axis``, each when its
    extent is above 1; a kv axis that does not divide the kv heads
    raises, and a split group dim must have the mesh's dp groups."""
    if mesh is None:
        return None
    sizes = mesh.spec.as_dict()
    kv_n = sizes.get(kv_axis, 1) if kv_axis else 1
    if kv_n > 1 and n_kv_heads % kv_n:
        raise ValueError(
            f"kv pool cannot shard {n_kv_heads} kv heads over "
            f"{kv_axis}={kv_n}")
    dp_n = sizes.get(dp_axis, 1) if dp_axis else 1
    if dp_n > 1 and dp_groups != dp_n:
        raise ValueError(
            f"pool has {dp_groups} dp group(s) but mesh axis "
            f"'{dp_axis}' has extent {dp_n} — the allocator "
            "groups must be the mesh's dp groups")
    per = n_kv_heads // kv_n
    group = mesh.mesh.get_local_rank(dp_axis) if dp_n > 1 else None
    kv0 = mesh.mesh.get_local_rank(kv_axis) * per if kv_n > 1 else 0
    return group, kv0, per


class PagedKVCache:
    """The pools + the per-group host allocators and page tables.

    ``device=None`` places the pools on the CUDA card (raising without
    one); the tests pass ``device="cpu"``. ``mesh``/``kv_axis``/
    ``dp_axis``: hold only this process's block of the pools
    (``pool_shard``; ``cfg.dp_groups`` must equal the ``dp_axis``
    extent). The engine writes the pools in place."""

    def __init__(self, cfg: PagedCacheConfig, device=None, mesh=None,
                 kv_axis: str | None = None, dp_axis: str | None = "dp"):
        self.cfg = cfg
        self.device = resolve_device(device)
        shard = pool_shard(mesh, cfg.n_kv_heads, cfg.dp_groups, kv_axis,
                           dp_axis)
        # The group whose pool this process holds (None: every group)
        # and its block of kv heads.
        self.local_group, kv0, hkv = (
            (None, 0, cfg.n_kv_heads) if shard is None else shard)
        self.kv_heads = (kv0, hkv)
        shape = (cfg.dp_groups if self.local_group is None else 1,
                 cfg.n_layers, hkv,
                 cfg.num_pages, cfg.page_size, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)
        # Host allocator state, per group. Free lists are LIFO: recently
        # freed pages are re-handed first (deterministic for the
        # join/evict permutations the tests run).
        self._frees: list[list[int]] = [
            list(range(cfg.num_pages - 1, 0, -1))
            for _ in range(cfg.dp_groups)]
        self._tables: dict[object, list[int]] = {}
        self._lengths: dict[object, int] = {}
        self._groups: dict[object, int] = {}
        # Sharing state, per group. ``_refs[g][page]`` counts the tables
        # holding ``page`` (absent == free); ``_index[g]`` maps the bytes
        # of a page-aligned token prefix to the page ids holding its KV;
        # ``_page_keys[g]`` maps a page id to the index keys whose LAST
        # page it is (a key dies exactly when its last page is
        # released). ``_registered`` counts each sequence's pages
        # already indexed.
        self._refs: list[dict[int, int]] = [
            {} for _ in range(cfg.dp_groups)]
        self._index: list[dict[bytes, tuple]] = [
            {} for _ in range(cfg.dp_groups)]
        self._page_keys: list[dict[int, set]] = [
            {} for _ in range(cfg.dp_groups)]
        self._registered: dict[object, int] = {}

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the pools this process holds (k and v)."""
        return 2 * self.k_pages.numel() * self.k_pages.element_size()

    # -- allocator ---------------------------------------------------------

    @property
    def _free(self) -> list[int]:
        """Group 0's free list: the single-pool surface, for dp_groups
        == 1 only."""
        if self.cfg.dp_groups != 1:
            raise AttributeError(
                "no single free list on a dp-sharded pool — use "
                "free_pages_in(group)")
        return self._frees[0]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def free_pages_in(self, group: int) -> int:
        return len(self._frees[group])

    @property
    def pages_used(self) -> int:
        """Pages allocated across all groups."""
        return self.cfg.usable_pages_total - sum(
            len(f) for f in self._frees)

    def pages_used_in(self, group: int) -> int:
        return self.cfg.usable_pages - len(self._frees[group])

    @property
    def seqs(self) -> int:
        return len(self._tables)

    def seqs_in(self, group: int) -> int:
        return sum(1 for g in self._groups.values() if g == group)

    def _emit(self, op: str, seq_id) -> None:
        event("serving_kv", op=op, seq=str(seq_id),
              group=self._groups.get(seq_id, 0),
              pages_used=self.pages_used,
              pages_total=self.cfg.usable_pages_total, seqs=self.seqs)

    def can_admit(self, n_tokens: int, group: int = 0) -> bool:
        """Would ``ensure`` succeed for a new sequence of n_tokens in
        ``group``?"""
        need = -(-max(1, n_tokens) // self.cfg.page_size)
        return need <= len(self._frees[group])

    def join(self, seq_id, group: int = 0) -> None:
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id!r} already joined")
        if not 0 <= group < self.cfg.dp_groups:
            raise ValueError(
                f"group {group} out of range (pool has "
                f"{self.cfg.dp_groups} dp group(s))")
        self._tables[seq_id] = []
        self._lengths[seq_id] = 0
        self._groups[seq_id] = group
        self._emit("join", seq_id)

    def group_of(self, seq_id) -> int:
        return self._groups[seq_id]

    def ensure(self, seq_id, n_tokens: int) -> bool:
        """Grow seq_id's table to cover ``n_tokens`` total positions,
        from its own group's free list. Returns False (allocating
        nothing) when that free list cannot cover the growth; the engine
        treats that as backpressure."""
        if n_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"sequence {seq_id!r} needs {n_tokens} positions, "
                f"pool max_seq_len is {self.cfg.max_seq_len}")
        table = self._tables[seq_id]
        group = self._groups[seq_id]
        free = self._frees[group]
        need = -(-n_tokens // self.cfg.page_size) - len(table)
        if need <= 0:
            return True
        if need > len(free):
            return False
        refs = self._refs[group]
        for _ in range(need):
            page = free.pop()
            refs[page] = 1
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
        pages whose last reference this was go back to the group's free
        list (and their prefix-index entries die with them). Returns the
        page count released."""
        table = self._tables.pop(seq_id)
        del self._lengths[seq_id]
        group = self._groups[seq_id]
        refs = self._refs[group]
        released = []
        for page in table:
            refs[page] -= 1
            if refs[page] == 0:
                del refs[page]
                self._invalidate(group, page)
                released.append(page)
        self._frees[group].extend(reversed(released))
        self._registered.pop(seq_id, None)
        self._emit("free", seq_id)
        del self._groups[seq_id]
        return len(released)

    def length(self, seq_id) -> int:
        return self._lengths[seq_id]

    def pages_of(self, seq_id) -> int:
        """Pages in ``seq_id``'s table (shared pages count: they are
        held, refcounted). The ``/debug/requests`` read; a KeyError for
        an unknown id, as every per-sequence accessor raises."""
        return len(self._tables[seq_id])

    # -- sharing: refcounted attach / COW / prefix index -------------------

    def attach(self, seq_id, pages, n_tokens: int) -> None:
        """Take read-only references on ``pages`` (a resident prefix in
        the sequence's group, in table order) for a joined sequence with
        an empty table, and mark ``n_tokens`` positions as written.
        Attaching a freed page is a KeyError, not a silent
        corruption."""
        table = self._tables[seq_id]
        if table or self._lengths[seq_id]:
            raise RuntimeError(
                f"sequence {seq_id!r} already has pages — attach is "
                "admission-time only")
        if n_tokens > len(pages) * self.cfg.page_size:
            raise ValueError(
                f"sequence {seq_id!r}: attaching {len(pages)} page(s) "
                f"cannot cover {n_tokens} positions")
        refs = self._refs[self._groups[seq_id]]
        for page in pages:
            refs[page] = refs[page] + 1  # KeyError if not live
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
        self._groups[new_id] = self._groups.pop(old_id)
        if old_id in self._registered:
            self._registered[new_id] = self._registered.pop(old_id)

    def privatize(self, seq_id):
        """Copy-on-write bookkeeping: swap every shared page at or past
        the sequence's write frontier (``length // page_size``) for a
        fresh private page of its group. Returns the ``(src, dst)`` page
        pairs for the caller's device copy ([] when nothing was shared),
        or None — allocating nothing — when the free list cannot cover
        the swap."""
        table = self._tables[seq_id]
        group = self._groups[seq_id]
        refs = self._refs[group]
        free = self._frees[group]
        start = self._lengths[seq_id] // self.cfg.page_size
        idxs = [i for i in range(start, len(table)) if refs[table[i]] > 1]
        if len(idxs) > len(free):
            return None
        pairs = []
        for i in idxs:
            src = table[i]
            dst = free.pop()
            refs[src] -= 1
            refs[dst] = 1
            table[i] = dst
            pairs.append((src, dst))
        if pairs:
            # Registration counts only pages below the forked one.
            if self._registered.get(seq_id, 0) > idxs[0]:
                self._registered[seq_id] = idxs[0]
            self._emit("cow", seq_id)
        return pairs

    def register_prefix(self, seq_id, tokens) -> None:
        """Index, in the sequence's group, every fully committed
        page-aligned prefix of ``tokens`` (the sequence's token history)
        not yet registered, keyed by the exact prefix bytes."""
        table = self._tables[seq_id]
        group = self._groups[seq_id]
        ps = self.cfg.page_size
        full = self._lengths[seq_id] // ps
        done = self._registered.get(seq_id, 0)
        if full <= done:
            return
        toks = np.array(tokens, np.int32)
        for j in range(done + 1, full + 1):
            key = toks[:j * ps].tobytes()
            self._index[group][key] = tuple(table[:j])
            self._page_keys[group].setdefault(table[j - 1], set()).add(key)
        self._registered[seq_id] = full

    def needs_register(self, seq_id) -> bool:
        """Does the sequence have committed pages not yet indexed?"""
        return (self._lengths[seq_id] // self.cfg.page_size
                > self._registered.get(seq_id, 0))

    def match_prefix(self, group: int, tokens):
        """Longest indexed page-aligned prefix of ``tokens`` resident in
        ``group``: ``(pages, n_pages)`` or ``((), 0)``."""
        index = self._index[group]
        if not index:
            return (), 0
        toks = np.array(tokens, np.int32)
        ps = self.cfg.page_size
        for j in range(len(toks) // ps, 0, -1):
            pages = index.get(toks[:j * ps].tobytes())
            if pages is not None:
                return pages, j
        return (), 0

    def _invalidate(self, group: int, page: int) -> None:
        """Drop the index entries whose last page just died."""
        for key in self._page_keys[group].pop(page, ()):
            self._index[group].pop(key, None)

    def shared_pages_in(self, group: int) -> int:
        """Pages in ``group`` held by more than one table."""
        return sum(1 for n in self._refs[group].values() if n > 1)

    def token_capacity(self, seq_id) -> int:
        """Max total positions this sequence could hold right now: its
        allocated pages plus its group's whole free list, capped by
        max_seq_len. The resident decode path sizes burst budgets
        against this, so a burst never writes past what ``ensure`` can
        cover."""
        g = self._groups[seq_id]
        pages = len(self._tables[seq_id]) + len(self._frees[g])
        return min(pages * self.cfg.page_size, self.cfg.max_seq_len)

    def occupancy(self) -> dict:
        rec = {"pages_used": self.pages_used,
               "pages_total": self.cfg.usable_pages_total,
               "seqs": self.seqs}
        if self.cfg.dp_groups > 1:
            rec["group_pages_used"] = [
                self.pages_used_in(g) for g in range(self.cfg.dp_groups)]
            rec["group_seqs"] = [
                self.seqs_in(g) for g in range(self.cfg.dp_groups)]
        return rec

    # -- device-side views -------------------------------------------------

    def _pool_index(self, groups: np.ndarray) -> torch.Tensor:
        local = groups if self.local_group is None else (
            groups - self.local_group)
        return torch.from_numpy(local).to(self.device)

    def gather_pages(self, groups: np.ndarray, pages: np.ndarray,
                     to_host: bool = True) -> tuple:
        """The listed (group, page) pairs of both pools, (L, hkv, n, ps,
        hd) each at this process's kv heads: one device gather, laid out
        there, and (``to_host``) one copy to the host per pool. Only these
        pages move, never the whole pool. This process must hold every
        listed group."""
        gi = self._pool_index(groups)
        pi = torch.from_numpy(pages).to(self.device)
        out = tuple(pool[gi, :, :, pi].permute(1, 2, 0, 3, 4).contiguous()
                    for pool in (self.k_pages, self.v_pages))
        return tuple(t.cpu() for t in out) if to_host else out

    def scatter_pages(self, groups: np.ndarray, pages: np.ndarray,
                      k: torch.Tensor, v: torch.Tensor) -> None:
        """Write (L, Hkv, n, ps, hd) blocks of every kv head into the
        listed (group, page) pairs of the pools: one scatter per pool, of
        the pairs in groups this process holds, at its kv heads."""
        if self.local_group is not None:
            keep = groups == self.local_group
            sel = torch.from_numpy(np.flatnonzero(keep))
            k, v = (t.index_select(2, sel.to(t.device)) for t in (k, v))
            groups, pages = groups[keep], pages[keep]
            if not len(groups):
                return
        kv0, hkv = self.kv_heads
        gi = self._pool_index(groups)
        pi = torch.from_numpy(pages).to(self.device)
        for pool, new in ((self.k_pages, k), (self.v_pages, v)):
            pool[gi, :, :, pi] = new[:, kv0:kv0 + hkv].to(
                self.device, pool.dtype).permute(2, 0, 1, 3, 4)

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

    def page_rows_grouped(self, seq_ids_by_group: list,
                          width: int | None = None) -> np.ndarray:
        """(dp_groups, width, pages_per_seq) int32 tables from a
        per-group nested id list, the batched programs' layout (group
        g's rows index only group g's pool). Ragged lists pad with
        all-scratch rows up to ``width`` (default: the longest group's
        length)."""
        b = width if width is not None else max(
            (len(ids) for ids in seq_ids_by_group), default=0)
        rows = np.zeros((self.cfg.dp_groups, b, self.cfg.pages_per_seq),
                        np.int32)
        for g, ids in enumerate(seq_ids_by_group):
            rows[g, :len(ids)] = self.page_rows(ids)
        return rows

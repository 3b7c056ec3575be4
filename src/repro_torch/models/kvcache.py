"""KV-cache storage: dense per-layer caches and page pools (twin of
``repro/models/kvcache.py``).

* ``dense`` — per-layer contiguous ``[B, S_max, Hkv, D]`` buffers.
* ``paged`` — a page pool ``[P, page, Hkv, D]`` per layer plus a page
  table ``pt [B, max_pages]`` mapping logical page ``j`` of row ``b`` to a
  physical page id.

A paged cache dict is recognized by its ``"pt"`` key. Its logical view
(:func:`pool_view`) holds the same values as the dense cache at every
committed position; positions at or past the row's length are garbage in
both layouts and masked the same way by every reader.

Unlike the JAX twin, writes update the buffers IN PLACE (torch tensors
are mutable; a functional update would copy a pool per layer per cycle).
The in-place writes are fixed-shape (:func:`drop_put_`): they drop the
masked entries as JAX's ``.at[...].set(..., mode="drop")`` does, with no
data-dependent shape and no device-to-host sync, so a CUDA graph can
capture them.

:class:`PagePool` is the host-side refcounted allocator the serving
engine hands pages out from; :func:`copy_page_` is the copy-on-write
step of a prefix-cache hit that ends inside a page.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

#: Page-table entry marking an unallocated logical page (int32 max; its
#: own copy of ``repro.models.kvcache.PAGE_SENTINEL``). Reads clamp it to
#: the last physical page and mask; writes drop it.
PAGE_SENTINEL = int(np.iinfo(np.int32).max)


def is_paged(cache_dict) -> bool:
    """A cache/state dict is paged iff it carries a page table."""
    return isinstance(cache_dict, dict) and "pt" in cache_dict


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-int(n_tokens) // int(page_size))


def page_geometry(cache_dict):
    """(page_size, max_pages, pool_pages) of a paged cache dict."""
    pool = cache_dict["k"]
    return pool.shape[-3], cache_dict["pt"].shape[-1], pool.shape[-4]


def logical_len(cache_dict) -> int:
    """Logical per-row capacity (max_pages * page_size) of a paged dict."""
    page, max_pages, _ = page_geometry(cache_dict)
    return page * max_pages


def identity_page_table(batch: int, max_pages: int, device=None):
    """[B, max_pages] int32 table where row b owns pages
    [b*max_pages, (b+1)*max_pages)."""
    return (torch.arange(batch, dtype=torch.int32, device=device)[:, None]
            * max_pages
            + torch.arange(max_pages, dtype=torch.int32, device=device)[None])


def default_page_layout(batch: int, max_len: int, page_size: int,
                        pool_pages=None, page_table=None, device=None):
    """``(pool_pages, page_table)`` with the identity layout filled in
    wherever the caller left None."""
    mp = pages_for(max_len, page_size)
    if page_table is None:
        page_table = identity_page_table(batch, mp, device)
    if pool_pages is None:
        pool_pages = batch * mp
    return pool_pages, page_table


def init_pool(pool_pages: int, page_size: int, num_kv_heads: int,
              head_dim: int, dtype, device, lead: tuple = ()):
    """Zeroed K or V page pool [*lead, P, page, Hkv, Dh]."""
    return torch.zeros((*lead, pool_pages, page_size, num_kv_heads,
                        head_dim), dtype=dtype, device=device)


def pool_view(pool, table):
    """Gather the logical per-row view of a page pool.

    pool [P, page, H, D] (or stacked [L, P, page, H, D]); table
    [B, max_pages] -> [B, MP*page, H, D] (or [L, B, MP*page, H, D]).
    Out-of-range entries (:data:`PAGE_SENTINEL`) clamp to the last
    physical page; what they surface lies past the row length and is
    masked by every consumer.
    """
    n_phys = pool.shape[-4]
    b, mp = table.shape
    idx = table.long().clamp(0, n_phys - 1)
    if pool.ndim == 4:
        v = pool[idx]                            # [B, MP, page, H, D]
        return v.reshape(b, mp * v.shape[2], *v.shape[3:])
    v = pool[:, idx]                             # [L, B, MP, page, H, D]
    return v.reshape(v.shape[0], b, mp * v.shape[3], *v.shape[4:])


def pool_scatter_(pool, table, new, pos, valid=None):
    """Write ``new`` at logical positions ``pos`` of each row's paged
    stream, in place. Returns ``pool``.

    pool: [P, page, H, D] or stacked [L, P, page, H, D];
    table: [B, max_pages]; new: [B, T, H, D] or [L, B, T, H, D];
    pos: [B, T] logical positions; valid: optional [B, T] bool. Entries
    that are invalid, or whose position falls outside the row's table or
    onto an unallocated (out-of-range) page, are dropped
    (:func:`drop_put_`).
    """
    page = pool.shape[-3]
    n_phys = pool.shape[-4]
    mp = table.shape[-1]
    pos = pos.long()
    pidx = torch.div(pos, page, rounding_mode="floor")
    slot = pos - pidx * page
    ok = (pos >= 0) & (pidx < mp)
    if valid is not None:
        ok = ok & valid
    phys = torch.gather(table.long(), 1, pidx.clamp(0, mp - 1))
    ok = ok & (phys >= 0) & (phys < n_phys)
    flat = (phys * page + slot).reshape(-1)
    tail = pool.shape[-2:]
    if pool.ndim == 4:
        drop_put_(pool.view(n_phys * page, *tail), 0, flat,
                  new.reshape(-1, *tail), ok.reshape(-1))
    else:
        lead = pool.shape[0]
        drop_put_(pool.view(lead, n_phys * page, *tail), 1, flat,
                  new.reshape(lead, -1, *tail), ok.reshape(-1))
    return pool


def drop_put_(buf, dim, idx, src, ok):
    """``buf.index_copy_(dim, idx, src)`` of the entries where ``ok``, in
    place: the twin of JAX's ``.at[idx].set(src, mode="drop")`` with the
    dropped entries' indices pushed out of range. Returns ``buf``.

    idx: [M] integer (any value where not ``ok``); src: ``buf``'s shape
    with M at ``dim``; ok: [M] bool. The write has a fixed shape: no
    data-dependent size and no device-to-host sync. A dropped entry
    repeats the first kept one (the same index and the same value), so
    duplicate indices carry identical values and no write races another;
    when none is kept, every entry rewrites the value already at index 0,
    read before the write.
    """
    if idx.numel() == 0:
        return buf
    first = torch.argmax(ok.to(torch.int32)).reshape(1)
    kept = ok.any()
    idx = idx.long()
    src = src.to(buf.dtype)
    at = torch.where(kept, idx.index_select(0, first), 0)
    fill = torch.where(kept, src.index_select(dim, first),
                       buf.index_select(dim, at))
    shape = [1] * src.ndim
    shape[dim] = -1
    return buf.index_copy_(dim, torch.where(ok, idx, at),
                           torch.where(ok.view(shape), src, fill))


def copy_page_(pool, src: int, dst: int):
    """Copy physical page ``src`` to ``dst`` in place (the COW step).

    pool: [..., P, page, H, D] (any stacked leading axes, as the drafter
    layers'). Used when a prefix-cache hit ends inside a page: the shared
    partial tail page is duplicated into a freshly allocated page before
    the new row's first write, so a page with refcount > 1 is never
    written. Returns ``pool``."""
    ax = pool.ndim - 4
    pool.select(ax, int(dst)).copy_(pool.select(ax, int(src)))
    return pool


class PagePool:
    """Host-side refcounted free-list allocator over a page space (its own
    copy of ``repro.models.kvcache.PagePool``).

    One pool backs a single wave (``pool_scope="wave"``) or the whole
    serving engine's lifetime (``pool_scope="engine"``): waves borrow the
    pool, so pages the radix prefix cache owns, and their device contents
    (``core.state.capture_pools``), survive wave turnover.

    ``alloc`` hands pages out at refcount 1, :meth:`incref` adds a reader
    (a prefix-cache hit splicing the page into another row's table) and
    :meth:`free` is a decref: a page returns to the free list when its
    last owner lets go. A page with refcount > 1 is shared and is never
    written; refcount underflow and double frees assert.
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._free_set = set(self._free)     # O(1) double-free detection
        self._ref: List[int] = [0] * self.n_pages
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        assert 0 <= page < self.n_pages, f"foreign page {page}"
        return self._ref[page]

    @property
    def free_page_ids(self):
        """Frozen snapshot of the free page ids."""
        return frozenset(self._free_set)

    def refcounts(self) -> List[int]:
        """Snapshot of every page's refcount."""
        return list(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` free page ids at refcount 1; None (no partial grant)
        if short."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        for p in pages:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        """Add a reader to allocated pages; increffing a free page asserts."""
        for p in pages:
            assert 0 <= p < self.n_pages and self._ref[p] > 0, \
                f"incref of free / foreign page {p}"
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the free list at
        refcount 0. Freeing an already-free page asserts."""
        for p in pages:
            assert 0 <= p < self.n_pages and p not in self._free_set \
                and self._ref[p] > 0, f"double free / foreign page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                self._free_set.add(p)

    def sanity_check(self) -> None:
        """Free-list / refcount consistency."""
        assert len(self._free) == len(self._free_set)
        for p in range(self.n_pages):
            assert (self._ref[p] == 0) == (p in self._free_set), p

    def row_table(self, pages: Sequence[int], max_pages: int):
        """[max_pages] int32 row table: allocated pages first, then
        :data:`PAGE_SENTINEL` for the unallocated slots (reads clamp and
        mask, writes drop)."""
        t = np.full((max_pages,), PAGE_SENTINEL, np.int32)
        t[: len(pages)] = pages
        return t

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
capture them. The host-side ``PagePool`` allocator belongs to the
serving slice and is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

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

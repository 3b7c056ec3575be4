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

Mesh layout (page identity global, page bytes per rank): under a
``use_sharding`` context with a ``kv_seq`` axis of P ranks, each rank's
pool is a real allocation of its run of every page, ``[.., pool_pages,
page_size // P, H, D]``: rank r holds slots ``[r*page/P, (r+1)*page/P)``
(JAX's ``shard_pool`` places the same bytes). The host allocator,
refcounts, radix tree and page tables are global and run alike on every
rank. :func:`page_geometry` reports the global page; every writer
(:func:`pool_scatter_`, so the commits, installs and feature-cache
extensions, and :func:`copy_page_`) writes only the local run; the
decode hook reads the local run (``distributed/spdecode.py``), and
:func:`logical_view` gathers every rank's run for the reads outside it.

Replicas over the batch axes: when a wave's rows split over the mesh's
batch axes (``sharding.batch_run``), every batch rank holds the whole
pool (its kv_seq run of every page) and writes only its own rows'
pages. Inside :func:`log_pool_writes` each :func:`pool_scatter_` records
the slots it kept, and :func:`sync_replicas_` then ships every rank's
written slots to every other replica (``core/state.py``: once a cycle,
once an install), in rounds of a bounded size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed import spdecode as sp

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
    """(page_size, max_pages, pool_pages) of a paged cache dict. Under a
    kv_seq mesh the pool holds this rank's run of each page, and the
    global page is that run times the axis size."""
    pool = cache_dict["k"]
    return (pool.shape[-3] * sp.kv_seq_shards(), cache_dict["pt"].shape[-1],
            pool.shape[-4])


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


def local_page(page_size: int) -> int:
    """Slots of each page this rank's pool holds: ``page_size``, or under
    a kv_seq mesh of P ranks ``page_size // P`` (twin of JAX's
    ``shard_pool`` placement). A page that P does not divide raises."""
    n = sp.kv_seq_shards()
    if page_size % n:
        raise ValueError(
            f"page_size={page_size} must be divisible by the kv_seq mesh "
            f"axis size ({n}): each rank holds page_size // {n} slots of "
            "every page")
    return page_size // n


def init_pool(pool_pages: int, page_size: int, num_kv_heads: int,
              head_dim: int, dtype, device, lead: tuple = ()):
    """Zeroed K or V page pool [*lead, P, page, Hkv, Dh]; under a kv_seq
    mesh this rank's pool [*lead, P, page // n_shards, Hkv, Dh]: rank r
    holds slots ``[r*page/n, (r+1)*page/n)`` of every page
    (:func:`local_page`), and page ids, tables and the host allocator stay
    global."""
    return torch.zeros((*lead, pool_pages, local_page(page_size),
                        num_kv_heads, head_dim), dtype=dtype, device=device)


# --------------------------------------------------- dense runs, slices ----
@dataclasses.dataclass(frozen=True)
class SlotRun:
    """The slots ``[lo, lo + n)`` of a dense cache of ``cap`` slots that
    this rank stores (JAX's rule ``(batch, kv_seq, kv_heads_p, None)``,
    fitted: under a kv_seq axis of P that divides ``cap``, rank r holds
    ``[r cap/P, (r+1) cap/P)``; otherwise every slot)."""
    lo: int
    n: int
    cap: int

    @property
    def whole(self) -> bool:
        return self.n == self.cap


def dense_cache(shape, seq_dim: int, dtype, device) -> torch.Tensor:
    """A zeroed dense cache of whole ``shape`` whose slot axis is
    ``seq_dim``: inside a kv_seq mesh, this rank's :class:`SlotRun` of it,
    which the tensor carries (``slot_run``)."""
    shape = list(shape)
    cap, p = shape[seq_dim], sp.kv_seq_shards()
    run = SlotRun(0, cap, cap)
    if p > 1 and cap % p == 0:
        n = cap // p
        run = SlotRun(sp.kv_seq_index() * n, n, cap)
    shape[seq_dim] = run.n
    t = torch.zeros(shape, dtype=dtype, device=device)
    if p > 1:
        t.slot_run = run
    return t


def slot_run(buf: torch.Tensor, seq_dim: int) -> SlotRun:
    """The :class:`SlotRun` a dense cache ``buf`` stores. Outside a kv_seq
    mesh every slot; inside one, the run it was made with
    (:func:`dense_cache`, kept by :func:`like`). A dense cache made
    outside the mesh raises there: its slots cannot be placed."""
    run = getattr(buf, "slot_run", None)
    if run is not None:
        return run
    if sp.kv_seq_shards() > 1:
        raise RuntimeError(
            "a dense cache inside a kv_seq mesh must be made there "
            "(kvcache.dense_cache): its slot run is not known")
    n = buf.shape[seq_dim]
    return SlotRun(0, n, n)


def like(src: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (made from ``src``'s rows: a row template, repeated rows)
    carrying ``src``'s slot run or slice, if it has one."""
    for name in ("slot_run", "state_slice"):
        if hasattr(src, name):
            setattr(t, name, getattr(src, name))
    return t


def dense_slots(buf: torch.Tensor, seq_dim: int, pos, rolling: bool):
    """(local slot, kept) of absolute positions ``pos`` in the dense cache
    ``buf``: position p at slot p (a rolling cache: p % cap), kept where
    that slot lies in this rank's run (and in the cache)."""
    run = slot_run(buf, seq_dim)
    pos = pos.long()
    idx = torch.remainder(pos, run.cap) if rolling else pos
    loc = idx - run.lo
    ok = (idx >= 0) & (idx < run.cap) & (loc >= 0) & (loc < run.n)
    return loc, ok


def dense_view(buf: torch.Tensor, seq_dim: int) -> torch.Tensor:
    """Every slot of the dense cache ``buf``: ``buf`` itself, or under a
    kv_seq mesh every rank's run all-gathered in order (what JAX's GSPMD
    gathers for a read outside the sharded decode hook)."""
    run = slot_run(buf, seq_dim)
    if run.whole:
        return buf
    mesh, axis = sh.active_mesh(), sp.kv_seq_axis()
    every = sh.card_all_gather(mesh, buf.contiguous(), axis)
    return every.movedim(0, seq_dim).flatten(seq_dim, seq_dim + 1)


@dataclasses.dataclass(frozen=True)
class StateSlice:
    """A recurrent state leaf stored at this rank's slice over the model
    axes (JAX's state rules: ``rg_h`` and ``conv_buf`` by ``ffn``,
    ``tm_s`` by ``heads``): dim ``dim`` holds ``[lo, lo + n)`` of ``size``
    over mesh ``axes``."""
    dim: int
    lo: int
    n: int
    size: int
    axes: tuple


def state_leaf(name: str, t: torch.Tensor) -> torch.Tensor:
    """A freshly made (zeroed) recurrent state leaf ``name`` [B, ...] as
    this rank stores it in the active mesh: cut by the state rules over
    every axis but the batch axes (the state already holds the rank's
    rows), carrying its :class:`StateSlice`; ``t`` itself where nothing
    is cut."""
    mesh = sh.active_mesh()
    if mesh is None:
        return t
    rec = sh.leaf_shard(name, tuple(t.shape), mesh)
    logical = sh.param_logical_axes(name, t.ndim)
    cut = [(d, e) for d, (a, e) in enumerate(zip(logical, rec.spec))
           if e is not None and a != "batch"]
    if not cut:
        return t
    if len(cut) > 1:
        raise NotImplementedError(f"state leaf {name}: cut over two dims")
    d, entry = cut[0]
    sl = rec.index[d]
    out = torch.zeros(t.shape[:d] + (sl.stop - sl.start,) + t.shape[d + 1:],
                      dtype=t.dtype, device=t.device)
    out.state_slice = StateSlice(d, sl.start, sl.stop - sl.start,
                                 t.shape[d], sh.entry_axes(entry))
    return out


@contextlib.contextmanager
def whole_states(st):
    """One layer's state dict with each leaf stored at a slice
    (:func:`state_leaf`) all-gathered whole; on leaving, this rank's slice
    of what the layer wrote into the whole leaves is kept. ``st`` itself
    (None, or nothing cut)."""
    cut = ({k: v.state_slice for k, v in st.items()
            if isinstance(v, torch.Tensor) and hasattr(v, "state_slice")}
           if st is not None else {})
    if not cut:
        yield st
        return
    mesh = sh.active_mesh()
    work = dict(st)
    for k, s in cut.items():
        every = sh.card_all_gather(mesh, st[k].contiguous(), s.axes)
        work[k] = every.movedim(0, s.dim).flatten(s.dim, s.dim + 1)
    yield work
    for k, s in cut.items():
        st[k].copy_(work[k].narrow(s.dim, s.lo, s.n))


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


def logical_view(pool, table):
    """:func:`pool_view` of the whole logical pool. Under a kv_seq mesh
    every rank's local view is all-gathered and put back in page order
    (what JAX's GSPMD gathers for a read outside the sharded decode hook:
    a prefill after a prefix hit, the replay of the state-replay
    verifier); without one, :func:`pool_view` itself."""
    mesh, axis = sh.active_mesh(), sp.kv_seq_axis()
    loc = pool_view(pool, table)
    if axis is None:
        return loc
    n, b, mp = mesh.size(axis), table.shape[0], table.shape[1]
    parts = mesh.all_gather(loc, axis)       # [n, .., B, MP*page_loc, H, D]
    lead = parts.shape[1:-4]
    parts = parts.reshape(n, *lead, b, mp, -1, *parts.shape[-2:])
    out = parts.movedim(0, -4)               # [.., B, MP, n, page_loc, H, D]
    return out.reshape(*lead, b, -1, *out.shape[-2:])


def pool_scatter_(pool, table, new, pos, valid=None):
    """Write ``new`` at logical positions ``pos`` of each row's paged
    stream, in place. Returns ``pool``.

    pool: [P, page, H, D] or stacked [L, P, page, H, D];
    table: [B, max_pages]; new: [B, T, H, D] or [L, B, T, H, D];
    pos: [B, T] logical positions; valid: optional [B, T] bool. Entries
    that are invalid, or whose position falls outside the row's table or
    onto an unallocated (out-of-range) page, are dropped
    (:func:`drop_put_`). Under a kv_seq mesh the pool is this rank's run
    of each page, and so are dropped the entries whose in-page slot lies
    in another rank's run.
    """
    loc = pool.shape[-3]
    n_sh = sp.kv_seq_shards()
    page = loc * n_sh
    n_phys = pool.shape[-4]
    mp = table.shape[-1]
    pos = pos.long()
    pidx = torch.div(pos, page, rounding_mode="floor")
    slot = pos - pidx * page
    ok = (pos >= 0) & (pidx < mp)
    if n_sh > 1:
        slot = slot - sp.kv_seq_index() * loc
        ok = ok & (slot >= 0) & (slot < loc)
    if valid is not None:
        ok = ok & valid
    phys = torch.gather(table.long(), 1, pidx.clamp(0, mp - 1))
    ok = ok & (phys >= 0) & (phys < n_phys)
    flat = (phys * loc + slot).reshape(-1)
    if _LOG.entries is not None:
        _LOG.entries.append((pool, flat, ok.reshape(-1)))
    tail = pool.shape[-2:]
    if pool.ndim == 4:
        drop_put_(pool.view(n_phys * loc, *tail), 0, flat,
                  new.reshape(-1, *tail), ok.reshape(-1))
    else:
        lead = pool.shape[0]
        drop_put_(pool.view(lead, n_phys * loc, *tail), 1, flat,
                  new.reshape(lead, -1, *tail), ok.reshape(-1))
    return pool


class _WriteLog(threading.local):
    def __init__(self):
        self.entries = None


_LOG = _WriteLog()


@contextlib.contextmanager
def log_pool_writes(on: bool = True):
    """While inside (and ``on``), every :func:`pool_scatter_` records the
    pool it wrote, the flat slot indices and which it kept. Yields the
    record list (None when off) for :func:`sync_replicas_`."""
    if not on:
        yield None
        return
    old = _LOG.entries
    _LOG.entries = []
    try:
        yield _LOG.entries
    finally:
        _LOG.entries = old


def _slots(pool):
    """``pool`` as ``([.., n_slots, H, D] view, slot axis)``."""
    n = pool.shape[-4] * pool.shape[-3]
    if pool.ndim == 4:
        return pool.view(n, *pool.shape[-2:]), 0
    return pool.view(pool.shape[0], n, *pool.shape[-2:]), 1


def sync_replicas_(pools: Sequence[torch.Tensor], log, mesh, axes) -> int:
    """Every batch rank's logged writes (:func:`log_pool_writes`) into
    this rank's replica of ``pools``, in place. One gather over ``axes``
    of each rank's written slot count per pool, then each rank's stream
    of written slots (pool by pool, each slot its index and then its
    values) in rounds of at most ``device_exchange.ROUND_BYTES`` a rank,
    staged through the host: each round is copied into the replica before
    the next is gathered, so a rank never holds more than one round of its
    peers' writes (and a slot that straddles two rounds). The ranks write
    disjoint pages (a shared page is never written), so the order of the
    copies does not matter. Returns the bytes this rank sent."""
    if any(p.device.type == "meta" for p in pools):
        return _sync_replicas_meta(pools, log, mesh, axes)
    from repro_torch.distributed.device_exchange import ROUND_BYTES
    at = {id(p): j for j, p in enumerate(pools)}
    written = [[] for _ in pools]
    for pool, flat, ok in log:
        written[at[id(pool)]].append(flat[ok])
    parts, counts = [], []
    for pool, w in zip(pools, written):
        view, dim = _slots(pool)
        idx = (torch.unique(torch.cat(w)) if w else
               torch.zeros((0,), dtype=torch.long, device=pool.device))
        vals = view.index_select(dim, idx).movedim(dim, 0).cpu()
        c = idx.numel()
        parts.append(torch.cat([
            idx.cpu().view(torch.uint8).reshape(c, 8),
            vals.contiguous().view(torch.uint8).reshape(
                c, _slot_bytes(pool) - 8)], 1).reshape(-1))
        counts.append(c)
    n = torch.tensor(counts, dtype=torch.long)
    all_n = mesh.all_gather(n, axes)                 # [ranks, pools]
    per = [_slot_bytes(p) for p in pools]
    sizes = [sum(int(all_n[r, j]) * per[j] for j in range(len(pools)))
             for r in range(all_n.shape[0])]
    mine = torch.cat(parts)
    me = mesh.index(axes)
    # each peer's place in its stream: (pool, slots of it copied, the
    # bytes of a slot the last round cut)
    place = {r: [0, 0, mine[:0]] for r in range(len(sizes)) if r != me}
    total = max(sizes)
    for a in range(0, total, ROUND_BYTES):
        w = min(ROUND_BYTES, total - a)
        chunk = torch.zeros((w,), dtype=torch.uint8)
        piece = mine[a:a + w]
        chunk[:piece.numel()] = piece
        every = mesh.all_gather(chunk, axes)         # [ranks, w]
        for r, pos in place.items():
            got = every[r, :max(0, min(w, sizes[r] - a))]
            pos[2] = _copy_slots_(pools, all_n[r], per, pos,
                                  torch.cat([pos[2], got]))
    return int(n.numel() * 8 + mine.numel())


def _copy_slots_(pools, counts, per, pos, buf):
    """Copy the whole slots at the front of ``buf`` (a peer's stream from
    its place ``pos`` = [pool, slots of it copied, ...]) into ``pools``,
    advancing ``pos``; returns the bytes of a slot left over."""
    while pos[0] < len(pools):
        j = pos[0]
        k = min(int(counts[j]) - pos[1], buf.numel() // per[j])
        if k:
            pool = pools[j]
            view, dim = _slots(pool)
            ent = buf[:k * per[j]].reshape(k, per[j])
            idx = ent[:, :8].clone().view(torch.long).reshape(k)
            shape = [k] + [s for i, s in enumerate(view.shape) if i != dim]
            vals = ent[:, 8:].clone().view(view.dtype).reshape(shape)
            view.index_copy_(dim, idx.to(pool.device),
                             vals.movedim(0, dim).to(pool.device))
            buf = buf[k * per[j]:]
            pos[1] += k
        if pos[1] < int(counts[j]):
            break
        pos[0], pos[1] = j + 1, 0
    return buf


def _slot_bytes(p) -> int:
    """Bytes a written slot of pool ``p`` takes in the exchange: its
    index, then its values."""
    return 8 + p.numel() // (p.shape[-4] * p.shape[-3]) * p.element_size()


def _sync_replicas_meta(pools, log, mesh, axes) -> int:
    """:func:`sync_replicas_` on meta pools (a shape-only trace, which
    cannot read which writes landed): the same gathers, the payload sized
    as if every logged write landed on a slot of its own, the most the
    exchange can carry, in the same rounds."""
    from repro_torch.distributed.device_exchange import ROUND_BYTES
    at = {id(p): j for j, p in enumerate(pools)}
    slots = [0] * len(pools)
    for pool, flat, _ in log:
        slots[at[id(pool)]] += flat.numel()
    mesh.all_gather(torch.empty((len(pools),), dtype=torch.long,
                                device="meta"), axes)
    size = sum(c * _slot_bytes(p) for c, p in zip(slots, pools))
    for a in range(0, size, ROUND_BYTES):
        mesh.all_gather(torch.empty((min(ROUND_BYTES, size - a),),
                                    dtype=torch.uint8, device="meta"), axes)
    return len(pools) * 8 + size


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
    layers'); under a kv_seq mesh this rank's run of the page. Used when a prefix-cache hit ends inside a page: the shared
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

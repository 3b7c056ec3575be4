"""Radix prefix cache: cross-request page sharing over a PagePool.

D2SD's candidate organization is built on shared prefixes *inside* a draft
block; this module applies the same economics *across the request
population* (vLLM prefix caching / SGLang RadixAttention style). A
host-side radix tree indexes the committed token strings of retired
requests; each tree node owns a run of physical pages in a
:class:`~repro_torch.models.kvcache.PagePool` holding the target KV **and both
drafter feature caches** for its token span (every paged cache of a wave
shares one page-id space, so one node covers all three). The tree lives
as long as its pool: with the serving engine's default engine-lifetime
pool the tree OUTLIVES wave turnover — wave N+1's prompts hit prefixes
committed in wave N (resident serving; the engine carries the device
pool buffers across via ``core.state.capture_pools`` and
``engine_init(pools=)``) —
while a legacy per-wave pool scopes it to one wave. Admitting a request
whose prompt extends a cached string becomes a page-table splice:

* **match** — longest cached prefix of the prompt (capped at ``P - 1``:
  at least one suffix token must remain to produce the anchor logits);
* **share** — the full pages covering the match are refcount-bumped and
  written into the new row's page table; the suffix is the only part that
  is prefilled (``install_rows(prefix_hits=...)``);
* **COW** — when the match ends inside a page, that partially filled tail
  page is copied to a freshly allocated page before the row's first write
  (:func:`repro_torch.core.state.cow_copy_page`), upholding the pool invariant
  that *a page with refcount > 1 is never written*;
* **insert** — at retire, the request's committed string (prompt +
  generated tokens actually committed to cache) is inserted back: the
  private pages covering the new suffix are donated to the tree (their
  refcount passes over), duplicated spans and allocation headroom are
  freed;
* **evict** — under pool pressure, least-recently-used *unpinned* leaf
  nodes are evicted and their pages returned. A node is pinned exactly
  while an in-flight row still reads one of its pages (pool refcount > 1),
  and eviction refuses pinned nodes. Pinning is refcount-based, so it is
  wave-agnostic: a row in ANY live wave of an engine-lifetime pool holds
  its read refs until retire, and eviction pressure is engine-global
  (driven by the shared pool's occupancy, not per-wave sizing).

Everything here is host-side bookkeeping over integer page ids — device
state is only touched by the engine (COW copy + installs). This is the
PyTorch port's own copy of ``repro/serving/prefix_cache.py``, over the
port's :class:`~repro_torch.models.kvcache.PagePool`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.models import kvcache as kvc


class RadixNode:
    """One edge of the radix tree.

    edge:  the token run this node contributes (np.int32 [E], E >= 1 for
           every node except the root).
    start: absolute token offset of ``edge[0]`` in the cached string.
    pages: ``[(page_index, physical_page)]`` owned by this node — the
           pages whose first position falls inside [start, end), plus (for
           a node created from a mid-page branch) one *override* entry for
           the boundary page index, shadowing the ancestor's partially
           shared page with this branch's COW copy.
    """

    __slots__ = ("edge", "start", "children", "pages", "parent", "last_use")

    def __init__(self, edge: np.ndarray, start: int,
                 parent: Optional["RadixNode"]):
        self.edge = edge
        self.start = int(start)
        self.children: Dict[int, "RadixNode"] = {}
        self.pages: List[Tuple[int, int]] = []
        self.parent = parent
        self.last_use = 0

    @property
    def end(self) -> int:
        return self.start + len(self.edge)


@dataclasses.dataclass
class PrefixHit:
    """A successful prompt match.

    length:  matched token count (the row's warm-start ``prefix_hit``).
    shared:  physical pages fully covered by the match — spliced into the
             row's table read-only (refcount bumped by :meth:`acquire`).
    partial: physical page holding position ``length`` when the match ends
             mid-page — the COW source (held alive by a temporary ref
             between :meth:`acquire` and :meth:`release_partial`).
    """
    length: int
    shared: List[int]
    partial: Optional[int]


class PrefixCache:
    """Host-side radix tree over committed prefixes of one pool — per-wave
    or engine-lifetime, whichever scope the owning engine runs."""

    def __init__(self, pool: kvc.PagePool):
        self.pool = pool
        self.page = pool.page_size
        self.root = RadixNode(np.zeros((0,), np.int32), 0, None)
        self._tick = 0
        self.evictions = 0

    # ------------------------------------------------------------- walk ----
    def _walk(self, tokens: np.ndarray):
        """Longest-prefix walk. Returns (node, off, matched, path): the
        deepest node reached, the offset inside its edge where matching
        stopped, the total matched token count, and the root->node path."""
        node = self.root
        path = [node]
        m, n = 0, len(tokens)
        while m < n:
            child = node.children.get(int(tokens[m]))
            if child is None:
                return node, len(node.edge), m, path
            e = child.edge
            k = min(len(e), n - m)
            neq = np.nonzero(e[:k] != tokens[m: m + k])[0]
            j = int(neq[0]) if len(neq) else k
            m += j
            path.append(child)
            node = child
            if j < len(e):
                return node, j, m, path
        return node, len(node.edge), m, path

    def _page_map(self, path: List[RadixNode], n_idx: int) -> Dict[int, int]:
        """page_index -> physical page for indices < n_idx along ``path``
        (deeper nodes override ancestors at boundary indices)."""
        mp: Dict[int, int] = {}
        for node in path:
            for i, p in node.pages:
                if i < n_idx:
                    mp[i] = p
        return mp

    # ------------------------------------------------------------ lookup ---
    def lookup(self, prompt: np.ndarray) -> Optional[PrefixHit]:
        """Longest cached prefix of ``prompt`` (read-only, no refcounts).

        The match is capped at ``len(prompt) - 1`` so the install always
        prefills at least one token (the anchor comes from real logits).
        """
        prompt = np.asarray(prompt, np.int32)
        node, off, m, path = self._walk(prompt)
        m = min(m, len(prompt) - 1)
        if m <= 0:
            return None
        self._tick += 1
        for nd in path:
            nd.last_use = self._tick
        n_full = m // self.page
        mp = self._page_map(path, kvc.pages_for(m, self.page))
        shared = [mp[i] for i in range(n_full)]
        partial = mp[n_full] if m % self.page else None
        return PrefixHit(length=m, shared=shared, partial=partial)

    def acquire(self, hit: PrefixHit) -> None:
        """Pin a hit: one read ref per shared page for the row's lifetime,
        plus a temporary ref on the COW source page (released right after
        the copy by :meth:`release_partial`)."""
        self.pool.incref(hit.shared)
        if hit.partial is not None:
            self.pool.incref([hit.partial])

    def release_partial(self, hit: PrefixHit) -> None:
        if hit.partial is not None:
            self.pool.free([hit.partial])

    def release(self, hit: PrefixHit) -> None:
        """Drop the row's read refs at retire (or on an aborted install)."""
        self.pool.free(hit.shared)

    # ------------------------------------------------------------ insert ---
    def insert(self, tokens: np.ndarray, row_table: np.ndarray,
               private=None, min_donate_idx: int = 0) -> Set[int]:
        """Insert a retired row's committed token string.

        ``row_table``: logical page index -> physical page for the row.
        Returns the physical pages DONATED to the tree — their refcount
        transfers (the caller must NOT free them). Pages covering spans
        the tree already holds, and allocation headroom beyond the
        committed length, stay with the caller. ``private``: the row's
        exclusively owned pages — donations must come from it (shared
        pages already belong to the tree; donating one would fork
        ownership).

        ``min_donate_idx``: the row's first PRIVATE page index (its
        install-time shared-page count). The walk below can stop SHORT of
        the row's original hit length — eviction may have removed a
        page-less split node from the matched path while the row was in
        flight (such nodes own no pages, so page-refcount pinning cannot
        protect them) — and the re-derived boundary ``m // page`` would
        then reach into the row's shared pages. Donation is clamped to
        start at ``min_donate_idx``; coverage stays complete because
        every index below it resolves through the surviving (pinned)
        owners of the row's shared pages, which are always at or above
        the point where the walk stopped.
        """
        tokens = np.asarray(tokens, np.int32)
        c = len(tokens)
        if c <= 0:
            return set()
        node, off, m, path = self._walk(tokens)
        self._tick += 1
        for nd in path:
            nd.last_use = self._tick
        if m >= c:
            return set()                    # string fully cached already
        if off < len(node.edge):
            node = self._split(node, off)
        # boundary override at m // page; clamped off the row's shared span
        first = max(m // self.page, int(min_donate_idx))
        pages = [(i, int(row_table[i]))
                 for i in range(first, kvc.pages_for(c, self.page))]
        if private is not None:
            assert all(p in private for _, p in pages), \
                "radix insert would donate a page the row does not own"
        child = RadixNode(tokens[m:c].copy(), m, node)
        child.pages = pages
        child.last_use = self._tick
        node.children[int(tokens[m])] = child
        return {p for _, p in pages}

    def _split(self, node: RadixNode, off: int) -> RadixNode:
        """Split ``node``'s edge at ``off`` (0 < off < len(edge)); the
        original object becomes the upper half (parent links stay valid)
        and a new child carries the lower half. Pages partition by page
        start position; a page straddling the split stays with the upper
        half (the lower half reads it through its ancestor)."""
        assert 0 < off < len(node.edge)
        split_abs = node.start + off
        lower = RadixNode(node.edge[off:].copy(), split_abs, node)
        lower.children = node.children
        for ch in lower.children.values():
            ch.parent = lower
        lower.pages = [(i, p) for i, p in node.pages
                       if i * self.page >= split_abs]
        lower.last_use = node.last_use
        node.pages = [(i, p) for i, p in node.pages
                      if i * self.page < split_abs]
        node.edge = node.edge[:off].copy()
        node.children = {int(lower.edge[0]): lower}
        return node

    # ---------------------------------------------------------- eviction ---
    def _nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _pinned(self, node: RadixNode) -> bool:
        """A node is pinned while any in-flight row still reads one of its
        pages (pool refcount > 1 — the tree itself holds exactly one)."""
        return any(self.pool.refcount(p) != 1 for _, p in node.pages)

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self._nodes()) - 1        # excl. root

    @property
    def cached_pages(self) -> int:
        return sum(len(n.pages) for n in self._nodes())

    def evictable_pages(self) -> int:
        """Pages reclaimable right now: nodes whose entire subtree is
        unpinned (leaves must go before ancestors, so a pinned descendant
        blocks the whole chain above it)."""
        def rec(n: RadixNode) -> Tuple[int, bool]:
            cnt, clean = 0, not self._pinned(n)
            for ch in n.children.values():
                c_cnt, c_clean = rec(ch)
                cnt += c_cnt
                clean &= c_clean
            if clean and n is not self.root:
                cnt += len(n.pages)
            return cnt, clean

        return rec(self.root)[0]

    def evict_for(self, n_pages: int) -> bool:
        """LRU-evict unpinned leaves until ``pool.free_pages >= n_pages``.

        Pinned nodes are REFUSED (their pages have in-flight readers);
        returns False if pressure cannot be satisfied — the caller must
        then deny admission, never force-free.
        """
        while self.pool.free_pages < n_pages:
            victim = None
            for node in self._nodes():
                if node is self.root or node.children:
                    continue
                if self._pinned(node):
                    continue
                if victim is None or node.last_use < victim.last_use:
                    victim = node
            if victim is None:
                return False
            if victim.pages:
                self.pool.free([p for _, p in victim.pages])
            del victim.parent.children[int(victim.edge[0])]
            self.evictions += 1
        return True

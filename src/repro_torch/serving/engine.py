"""Batched D2SD serving engine: continuous slot-refill batching over a
pluggable KV storage layer (twin of ``repro/serving/engine.py``).

Requests queue up and are served FIFO through a fixed-size batch of row
*slots* over one :class:`~repro_torch.core.state.EngineState`:

* **Per-slot prefill**: each request is prefilled into its row by
  :func:`~repro_torch.core.state.install_rows` (a batch-K prefill spliced
  into the wave's rows in place), so one running batch mixes prompt
  lengths and ``max_new`` budgets.
* **Early-exit masking**: before every decode cycle the engine pushes a
  per-row ``active`` mask; rows whose request hit its budget (or whose
  slot is idle) commit nothing (disable with ``early_exit=False``).
* **Slot refill**: a finished request retires into ``done`` and the FIFO
  head of the queue is prefilled into the vacated row (disable with
  ``refill=False`` for drain-the-wave batching).

KV memory (``cache_impl``): ``dense`` reserves the wave's worst-case
``max_len`` per slot; ``paged`` backs the target's global KV and both
drafter feature caches with a :class:`~repro_torch.models.kvcache.PagePool`
(engine-lifetime with ``pool_scope="engine"``, per wave with ``"wave"``).
Admission accounts in pages, retire frees them, and install is copy-free:
it allocates pages, prefills straight into them and patches one
page-table row (:func:`~repro_torch.core.state.rows_template`).

Prefix cache (``prefix_cache=True``, paged, all-global-attention target):
a :class:`~repro_torch.serving.prefix_cache.PrefixCache` radix tree over
retired requests' committed token strings, whose nodes own refcounted
page runs. A hit splices the matched full pages read-only into the new
row's table and prefills only the suffix (a warm start); a match that
ends inside a page first copies that page (COW: a page with refcount > 1
is never written). Retire inserts the committed string; pool pressure
evicts least-recently-used unpinned leaves.

Prompt-length bucketing (``bucket_sizes``, default the pow-2
:data:`DEFAULT_BUCKETS`): install prefills are padded to a bucket (the
real length masked through ``true_len``); ``install_traces`` counts the
distinct install shapes, as the JAX engine counts its traces.

Cycle API (overlap contract): :meth:`ServingEngine.dispatch_cycle`
enqueues one decode cycle (``pipeline.decode_cycle``, which makes no host
sync) and returns; :meth:`complete_cycle` reads its results, banks
tokens and retires: the only host/device sync. Between the two,
:meth:`admit_idle` fills idle slots; its installs run after the cycle on
the same stream and touch only idle rows and freshly allocated pages.
An install's anchor token is read back at the next retire boundary
(pending-anchor deferral), never inline. Timestamps go through an
injected :class:`~repro_torch.serving.metrics.Clock`.

Random numbers: one ``torch.Generator`` per engine (``seed``), which
every install and cycle draws from in order, in place of JAX's key
splits. Not ported here: mesh residency (ROADMAP.md queue 1, slice E;
the stats keep its keys for one device: ``kv_shards`` 1,
``pool_shard_slots`` the pool's slots, ``decode_collective_bytes`` 0).
Cross-attention targets (VLM, encoder-decoder) are refused: a request
carries no context, and JAX's engine serves them against a zero cross
cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pipeline as pl
from repro_torch.core.state import (EngineState, capture_pools, cow_copy_page,
                                    engine_init, install_rows,
                                    refill_copy_bytes)
from repro_torch.models import kvcache as kvc
from repro_torch.models import param as pm
from repro_torch.serving.metrics import Clock, MetricsRecorder, MonotonicClock
from repro_torch.serving.prefix_cache import PrefixCache, PrefixHit


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [P]
    max_new: int
    out: Optional[np.ndarray] = None
    n_cycles: int = 0
    latency_s: float = 0.0
    t_start: float = 0.0


@dataclasses.dataclass
class Wave:
    """One running batch: typed engine state + per-slot request books."""
    requests: List[Optional[Request]]   # slot -> live request (None = idle)
    state: EngineState
    bufs: np.ndarray            # [B, cap] committed tokens (slot 0 = anchor)
    filled: np.ndarray          # [B] tokens committed so far
    targets: np.ndarray         # [B] per-request max_new (0 for idle slots)
    t0: float
    cycles: int = 0
    pool: Optional[kvc.PagePool] = None        # paged mode (borrowed when
    #                                            pool_scope="engine")
    row_pages: Optional[List[List[int]]] = None  # slot -> private pages
    cache: Optional[PrefixCache] = None        # prefix_cache=True only
    row_tables: Optional[List[Optional[np.ndarray]]] = None  # host copies
    row_hits: Optional[List[Optional[PrefixHit]]] = None
    trunc: Optional[np.ndarray] = None  # [B] output buf overflowed (bool)
    evictions0: int = 0                 # cache.evictions at wave start
    # slots whose install-produced anchor has not been read back to bufs
    # yet (read at the next retire boundary, _flush_anchors)
    pending_anchor: Set[int] = dataclasses.field(default_factory=set)

    @property
    def done(self) -> bool:
        return all(r is None for r in self.requests)


#: default install-prefill length buckets (pow-2 ladder; longer prompts
#: round up to a multiple of the largest bucket)
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


class ServingEngine:
    def __init__(self, bundle: pl.SpecBundle, batch_size: int = 8,
                 seed: int = 0, early_exit: bool = True,
                 refill: bool = True, cache_impl: str = "dense",
                 page_size: int = 64, prefix_cache: bool = False,
                 bucket_sizes="auto", pool_scope: str = "engine",
                 pool_pages: Optional[int] = None,
                 pool_headroom: float = 1.0,
                 clock: Optional[Clock] = None,
                 recorder: Optional[MetricsRecorder] = None,
                 device="cuda"):
        assert cache_impl in ("dense", "paged"), cache_impl
        assert pool_scope in ("engine", "wave"), pool_scope
        kinds = set(bundle.target_cfg.pattern_for_depth())
        if bundle.target_cfg.cross_attn_every:
            # JAX's engine allocates the cross caches without ctx_len and
            # prefills without ctx, so it serves such a target against a
            # zero cross cache: with no context at all (ROADMAP.md queue 3)
            raise ValueError(
                "ServingEngine serves no cross-attention target (VLM, "
                "encoder-decoder): requests carry no context; decode it "
                "with pipeline.generate(ctx=)")
        if pool_pages is not None and not (cache_impl == "paged"
                                           and pool_scope == "engine"):
            raise ValueError(
                "pool_pages only sizes the engine-lifetime pool "
                "(cache_impl='paged', pool_scope='engine'); per-wave "
                "pools are sized per wave by the engine-global rule")
        if prefix_cache:
            if cache_impl != "paged":
                raise ValueError(
                    "prefix_cache=True requires cache_impl='paged': "
                    "cross-request sharing is a page-table splice")
            if kinds != {"global"}:
                raise ValueError(
                    "prefix_cache=True requires an all-global-attention "
                    "target: sliding-window rolling buffers and recurrent "
                    f"states cannot be rebuilt from shared pages ({kinds})")
        if cache_impl == "paged" and not early_exit:
            # a retired slot's pages go back to the pool but its stale page
            # table stays until refill; an unmasked idle row would commit
            # KV through it into pages granted to a live request
            raise ValueError(
                "cache_impl='paged' requires early_exit=True: idle slots "
                "must be masked so they cannot write through stale page "
                "tables into freed (reallocated) pages")
        self.device = resolve_device(device)
        self.kv_shards = 1
        self.bundle = bundle
        self.batch_size = batch_size
        self.early_exit = early_exit
        self.refill = refill
        self.cache_impl = cache_impl
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self.pool_scope = pool_scope
        self._pool_pages_cfg = pool_pages
        self.pool_headroom = float(pool_headroom)
        # engine-lifetime pool + radix tree (paged, pool_scope="engine"):
        # made at the first start_wave, borrowed by every wave after
        self.pool: Optional[kvc.PagePool] = None
        self.cache: Optional[PrefixCache] = None
        self._pools = None      # device pool tensors kept between waves
        if bucket_sizes == "auto":
            bucket_sizes = DEFAULT_BUCKETS
        self.bucket_sizes = (tuple(sorted(bucket_sizes))
                             if bucket_sizes else None)
        # every engine timestamp goes through the injected clock; the
        # engine charges "cycle" per dispatched cycle and "install" per
        # install call to it (a no-op on the MonotonicClock)
        self.clock = clock if clock is not None else MonotonicClock()
        self.recorder = recorder
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.gen = pm.make_generator(seed, self.device)
        self._next_uid = 0
        self.wave: Optional[Wave] = None
        # (state, gen) -> (state', out); holds no reference to the engine,
        # so a dropped engine frees its caches without waiting for the gc
        self._cycle = functools.partial(pl.decode_cycle, bundle,
                                        collect_stats=False)
        self.stats = {"tokens": 0, "cycles": 0, "accepted": 0,
                      "wall_s": 0.0, "waves": 0, "alpha": 0.0,
                      "wasted_row_cycles": 0, "refills": 0,
                      "refill_copy_bytes": 0, "installs": 0,
                      "install_traces": 0, "install_calls": 0,
                      "pool_pages": 0, "pool_peak_pages": 0,
                      "pool_utilization": 0.0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "prefill_tokens_saved": 0,
                      "cow_copies": 0, "prefix_evictions": 0,
                      "prefix_cached_pages": 0,
                      "kv_shards": self.kv_shards,
                      "pool_shard_slots": 0,
                      "decode_collective_bytes": 0,
                      "warm_cycle_s": 0.0, "warm_cycles": 0}
        self._alpha_num = 0
        self._alpha_den = 0
        self._util_sum = 0.0
        self._util_samples = 0
        # dispatch->complete durations of every cycle but each wave's
        # first (warm_cycle_s is their median)
        self._warm_durs: List[float] = []
        # distinct install shapes: (group size, prompt length, warm, wave
        # batch, capacity, pool pages), the JAX engine's trace key
        self._install_shapes = set()

    def submit(self, prompt: np.ndarray, max_new: int,
               t_arrival: Optional[float] = None) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self.queue.append(Request(uid, np.asarray(prompt, np.int32),
                                  max_new))
        if self.recorder is not None:
            # open-loop drivers pass the trace arrival time
            self.recorder.on_arrival(uid, t=t_arrival)
        return uid

    def _next_wave(self) -> List[Request]:
        # FIFO: the wave anchors on the oldest queued request
        take = self.queue[: self.batch_size]
        if self.pool is not None and take:
            # engine-lifetime pool: a new wave's initial set must fit the
            # fixed pool after the radix tree gives back what it can;
            # later requests enter through refill admission (_fits)
            g = self.bundle.spec.gamma
            budget = self.pool.free_pages + (
                self.cache.evictable_pages() if self.cache is not None
                else 0)
            kept: List[Request] = []
            acc = 0
            for r in take:
                n = self._pages_needed(r, g)
                if acc + n > budget:
                    break
                kept.append(r)
                acc += n
            if not kept:
                raise RuntimeError(
                    f"request uid={take[0].uid} needs "
                    f"{self._pages_needed(take[0], g)} pages but the "
                    f"engine-lifetime pool can grant at most {budget} of "
                    f"{self.pool.n_pages}; raise pool_pages / "
                    f"pool_headroom (or use pool_scope='wave')")
            take = kept
        self.queue = self.queue[len(take):]
        return take

    def _pool_budget(self, need: List[int], b: int) -> int:
        """Engine-global pool sizing rule (both pool scopes): the
        worst-case concurrent live set (the ``b`` largest candidate page
        needs) plus ``pool_headroom`` times that for prefix retention when
        the radix cache is on. Refill candidates run in slots the live set
        vacates, so only their retired prefixes need extra pages."""
        live = sum(need[:b])
        if not self.prefix_cache:
            return live
        return live + int(np.ceil(self.pool_headroom * live))

    # ------------------------------------------------------ step API ------
    def start_wave(self, width: Optional[int] = None) -> bool:
        """Allocate + prefill the next running batch. False if queue empty.

        ``width`` (open-loop serving): build the wave with this many rows
        even if fewer requests are visible now; the extra rows start idle
        and are filled by refills / :meth:`admit_idle`."""
        assert self.wave is None, "finish the active wave first"
        g = self.bundle.spec.gamma
        if (self.cache_impl == "paged" and self.pool_scope == "engine"
                and self.pool is None and self.queue):
            # the engine-lifetime pool, made once: an explicit pool_pages,
            # or the engine-global rule over the whole visible queue
            need0 = sorted((self._pages_needed(r, g) for r in self.queue),
                           reverse=True)
            b0 = min(self.batch_size, len(self.queue))
            n_pages = (self._pool_pages_cfg
                       if self._pool_pages_cfg is not None
                       else self._pool_budget(need0, b0))
            self.pool = kvc.PagePool(n_pages, self.page_size)
            if self.prefix_cache:
                self.cache = PrefixCache(self.pool)
        reqs = self._next_wave()
        if not reqs:
            return False
        b = (len(reqs) if width is None
             else min(self.batch_size, max(width, len(reqs))))
        # size caches for the wave plus the next batch of likely refill
        # candidates (requests that do not fit wait for the next wave)
        cand = reqs + self.queue[: self.batch_size]
        cap = max(self._bufs_needed(r, g) for r in cand)
        pool = None
        row_pages = None
        cache = None
        if self.cache_impl == "paged":
            # the table is as wide as the largest candidate needs (capped
            # at the pool); the pool is sized by _pool_budget
            need = sorted((self._pages_needed(r, g) for r in cand),
                          reverse=True)
            if self.pool_scope == "engine":
                pool, cache = self.pool, self.cache
            else:
                pool = kvc.PagePool(self._pool_budget(need, b),
                                    self.page_size)
                if self.prefix_cache:
                    cache = PrefixCache(pool)
            pool_pages = pool.n_pages
            mp = min(need[0], pool_pages)
            row_pages = [[] for _ in range(b)]
            # every row starts unallocated: sentinel until _install patches
            table = np.full((b, mp), kvc.PAGE_SENTINEL, np.int32)
            # borrowed-pool contract: the pool tensors kept at the last
            # turnover go straight into the new wave
            state = engine_init(self.bundle, b, mp * self.page_size,
                                cache_impl="paged",
                                page_size=self.page_size,
                                pool_pages=pool_pages, page_table=table,
                                device=self.device, pools=self._pools)
            self._pools = None
            self.stats["pool_pages"] = max(self.stats["pool_pages"],
                                           pool_pages)
            self.stats["pool_shard_slots"] = max(
                self.stats["pool_shard_slots"],
                pool_pages * (self.page_size // self.kv_shards))
        else:
            max_len = max(self._cache_needed(r, g) for r in cand)
            state = engine_init(self.bundle, b, max_len, device=self.device)
        state = state.replace(active=torch.zeros((b,), dtype=torch.bool,
                                                 device=self.device))
        self.wave = Wave(requests=[None] * b, state=state,
                         bufs=np.zeros((b, cap), np.int32),
                         filled=np.zeros((b,), np.int64),
                         targets=np.zeros((b,), np.int64),
                         t0=self.clock.now(), pool=pool,
                         row_pages=row_pages,
                         cache=cache, row_tables=[None] * b,
                         row_hits=[None] * b, trunc=np.zeros((b,), bool),
                         evictions0=cache.evictions if cache else 0)
        # install every initial request before the first retire (a retire
        # can chain-refill beyond the pool-sizing window)
        self._install_group(list(enumerate(reqs)))
        for i in range(b):
            if (self.wave.requests[i] is not None
                    and self.wave.filled[i] >= self.wave.targets[i]):
                # satisfied by the prefill alone (max_new <= 1)
                self._retire(i)
        if self.wave.done:
            self._finish_wave()
        return True

    def _bucket(self, n: int) -> int:
        """Pad a prefill length to its bucket (identity when disabled)."""
        if self.bucket_sizes is None:
            return n
        for b in self.bucket_sizes:
            if b >= n:
                return b
        top = self.bucket_sizes[-1]
        return -(-n // top) * top

    def _prep_install(self, slot: int, r: Request) -> int:
        """Host-side admission work for one install: prefix-cache match,
        page allocation, table splice, COW. Returns the matched prefix
        length (0 = cold install; always 0 when dense)."""
        w = self.wave
        if self.cache_impl != "paged":
            return 0
        prompt = np.asarray(r.prompt, np.int32)
        g = self.bundle.spec.gamma
        n_total = self._pages_needed(r, g)
        hit = w.cache.lookup(prompt) if w.cache is not None else None
        if hit is not None:
            w.cache.acquire(hit)        # pin shared pages + COW source
        n_new = n_total - (len(hit.shared) if hit else 0)
        if w.pool.free_pages < n_new and w.cache is not None:
            w.cache.evict_for(n_new)
        pages = w.pool.alloc(n_new)
        if pages is None and hit is not None:
            # tight pool: admission (_fits) guarantees the miss shape, so
            # give the hit back and install cold
            w.cache.release_partial(hit)
            w.cache.release(hit)
            hit = None
            w.cache.evict_for(n_total)
            pages = w.pool.alloc(n_total)
        assert pages is not None, "admission control must guarantee pages"
        w.row_pages[slot] = pages
        shared = hit.shared if hit else []
        w.row_tables[slot] = w.pool.row_table(shared + pages,
                                              w.state.max_pages)
        if hit is not None:
            if hit.partial is not None:
                # COW: copy the shared partial tail page into the row's
                # first private page before any write lands there
                cow_copy_page(w.state, hit.partial, pages[0])
                self.stats["cow_copies"] += 1
            w.cache.release_partial(hit)
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += hit.length
            # prefill tokens skipped relative to a cold install, counted
            # in bucketed lengths
            self.stats["prefill_tokens_saved"] += (
                self._bucket(len(prompt))
                - self._bucket(len(prompt) - hit.length))
        elif w.cache is not None:
            self.stats["prefix_misses"] += 1
        w.row_hits[slot] = hit
        return hit.length if hit else 0

    def _install_group(self, picks: List[Tuple[int, Request]]) -> None:
        """Install (slot, request) picks. At temperature 0 the host prep
        runs for every pick first, in pick order, then same (suffix
        bucket, warm/cold) groups go through one batched install each.
        Sampled installs go one by one (a batched install draws its K
        anchors from one draw)."""
        if self.bundle.spec.temperature > 0 or len(picks) <= 1:
            for slot, r in picks:
                self._install_batch([(slot, r, self._prep_install(slot, r))])
            return
        prepped = [(slot, r, self._prep_install(slot, r))
                   for slot, r in picks]
        groups: Dict[Tuple[int, bool],
                     List[Tuple[int, Request, int]]] = {}
        for slot, r, pfx in prepped:
            key = (self._bucket(len(r.prompt) - pfx), pfx > 0)
            groups.setdefault(key, []).append((slot, r, pfx))
        for _, grp in sorted(groups.items()):
            self._install_batch(grp)

    def _install_batch(self, grp: List[Tuple[int, Request, int]]) -> None:
        """One batch-K install for K requests already prepped by
        :meth:`_prep_install`, all cold or all warm, in one suffix bucket
        (warm rows may carry different prefix lengths)."""
        w = self.wave
        k = len(grp)
        warm = grp[0][2] > 0
        lens = [len(r.prompt) - p0 for _, r, p0 in grp]
        pad = max(self._bucket(n) for n in lens)
        prompts = np.zeros((k, pad), np.int32)
        true = np.zeros((k,), np.int32)
        pfx = np.zeros((k,), np.int32)
        for i, (slot, r, p0) in enumerate(grp):
            sfx = np.asarray(r.prompt, np.int32)[p0:]
            prompts[i, : len(sfx)] = sfx
            true[i] = len(sfx)
            pfx[i] = p0
            self.stats["refill_copy_bytes"] += refill_copy_bytes(
                w.state, len(sfx))
            if self.recorder is not None:
                self.recorder.on_admit(r.uid)
        self._install_shapes.add(
            (k, pad, warm, w.state.batch, w.state.max_len,
             w.pool.n_pages if w.pool is not None else 0))
        self.stats["install_traces"] = len(self._install_shapes)
        self.stats["installs"] += k
        self.stats["install_calls"] += 1
        row_tables = None
        if self.cache_impl == "paged":
            row_tables = np.stack([w.row_tables[slot] for slot, _, _ in grp])
        install_rows(self.bundle, w.state, [s for s, _, _ in grp], prompts,
                     self.gen, temperature=self.bundle.spec.temperature,
                     row_tables=row_tables,
                     true_len=true if self.bucket_sizes is not None else None,
                     prefix_hits=pfx if warm else None)
        # one install call: one simulated install charge
        self.clock.tick("install")
        for slot, r, _ in grp:
            self._book_install(slot, r)

    def _book_install(self, slot: int, r: Request) -> None:
        """Host books of an install. The anchor (the request's first
        generated token) is not read back here: the slot is marked
        pending and the anchor lands in ``bufs`` at the next retire
        boundary (:meth:`_flush_anchors`)."""
        w = self.wave
        w.bufs[slot] = 0
        w.pending_anchor.add(slot)
        w.filled[slot] = 1
        w.targets[slot] = r.max_new
        w.requests[slot] = r
        w.trunc[slot] = False
        r.t_start = self.clock.now()
        r.n_cycles = 0
        if self.recorder is not None:
            self.recorder.on_first_token(r.uid)

    def _flush_anchors(self) -> None:
        """Read pending install anchors into ``bufs``: one device read
        covers every install since the last flush."""
        w = self.wave
        if w is None or not w.pending_anchor:
            return
        anchors = w.state.anchor.cpu().numpy()
        for slot in w.pending_anchor:
            w.bufs[slot, 0] = int(anchors[slot])
        w.pending_anchor.clear()

    # ---- sizing: single source of truth for allocation and admission ----
    @staticmethod
    def _bufs_needed(r: Request, g: int) -> int:
        """Output-buffer slots: budget + worst-case overshoot + anchor."""
        return r.max_new + g + 1

    @staticmethod
    def _cache_needed(r: Request, g: int) -> int:
        """KV/feature-cache positions: prompt + budget + draft headroom
        (the same rule as ``generate``'s default max_len)."""
        return len(r.prompt) + r.max_new + 2 * g + 8

    def _pages_needed(self, r: Request, g: int) -> int:
        return kvc.pages_for(self._cache_needed(r, g), self.page_size)

    def _fits(self, r: Request, reserved_pages: int = 0) -> bool:
        """Can ``r`` be adopted into the current wave's allocation? Paged
        mode admits on free pages (plus the radix cache's evictable ones),
        for the miss shape; ``reserved_pages`` are promised to picks whose
        installs have not allocated yet."""
        w = self.wave
        g = self.bundle.spec.gamma
        if self._bufs_needed(r, g) > w.bufs.shape[1]:
            return False
        if self.cache_impl == "paged":
            n = self._pages_needed(r, g)
            avail = w.pool.free_pages - reserved_pages
            if w.cache is not None:
                avail += w.cache.evictable_pages()
            return n <= w.state.max_pages and n <= avail
        return self._cache_needed(r, g) <= w.state.max_len

    def _host_active(self) -> np.ndarray:
        """[B] rows holding a request that still wants tokens."""
        w = self.wave
        return np.array([r is not None and w.filled[i] < w.targets[i]
                         for i, r in enumerate(w.requests)])

    def dispatch_cycle(self):
        """Enqueue ONE decode cycle and return without waiting for it.

        Returns a handle for :meth:`complete_cycle` (None when no wave is
        running). On a card the host is then free for admission work
        (:meth:`admit_idle`) while the device decodes. Pending install
        anchors are read first."""
        w = self.wave
        if w is None:
            return None
        self._flush_anchors()
        b = len(w.requests)
        active = self._host_active()
        mask = active if self.early_exit else np.ones((b,), bool)
        # a copy: an install splices its row into this tensor in place,
        # which must not reach the host snapshot ``active`` of this cycle
        w.state = w.state.replace(active=torch.tensor(
            mask, dtype=torch.bool, device=self.device))
        w.state, out = self._cycle(w.state, self.gen)
        w.cycles += 1
        self.clock.tick("cycle")
        if w.pool is not None:
            self._util_sum += w.pool.pages_in_use / max(w.pool.n_pages, 1)
            self._util_samples += 1
        # only rows actively serving a request count toward acceptance
        self.stats["wasted_row_cycles"] += int(b - active.sum())
        return active, out, self.clock.now()

    def complete_cycle(self, handle) -> bool:
        """Read a dispatched cycle's results, bank tokens, retire: the
        wave's only device-sync boundary. Returns True while any slot
        still has an unfinished request."""
        w = self.wave
        if handle is None or w is None:
            return False
        active, out, t_disp = handle
        toks = out["tokens"].cpu().numpy()          # retire-boundary sync
        n_out = out["n_out"].cpu().numpy()
        if w.cycles > 1:
            # the wave's first cycle is left out of the warm sample
            self._warm_durs.append(self.clock.now() - t_disp)
        cap = w.bufs.shape[1]
        self._alpha_num += int(n_out[active].sum())
        self._alpha_den += int(active.sum())
        self.stats["accepted"] += int(out["n_acc"].cpu().numpy()[active]
                                      .sum())
        for i in range(len(w.requests)):
            r = w.requests[i]
            if r is None:
                continue
            if active[i]:
                m = min(int(n_out[i]), cap - int(w.filled[i]))
                if m > 0:
                    w.bufs[i, w.filled[i]: w.filled[i] + m] = toks[i, :m]
                if m < int(n_out[i]):
                    # committed tokens fell off the output buffer: this
                    # row must not seed the prefix tree
                    w.trunc[i] = True
                w.filled[i] = min(w.filled[i] + int(n_out[i]), cap)
                r.n_cycles += 1
            if w.filled[i] >= w.targets[i] or r.n_cycles > r.max_new + 8:
                self._retire(i)
        if w.done:
            self._finish_wave()
            return False
        return True

    def step(self) -> bool:
        """ONE decode cycle, dispatch + complete back-to-back."""
        return self.complete_cycle(self.dispatch_cycle())

    def admit_idle(self) -> int:
        """Fill idle slots from the queue while a dispatched cycle is in
        flight (the overlap window); installs are grouped by suffix
        bucket. Safe without a sync: an idle slot is inactive in the
        running cycle and installs touch only that row and freshly
        allocated pages. Returns the number of requests admitted."""
        w = self.wave
        if w is None or not self.refill or not self.queue:
            return 0
        g = self.bundle.spec.gamma
        picks: List[Tuple[int, Request]] = []
        reserved = 0
        for slot in range(len(w.requests)):
            if w.requests[slot] is not None:
                continue
            if not self.queue or not self._fits(self.queue[0], reserved):
                break
            r = self.queue.pop(0)
            picks.append((slot, r))
            if self.cache_impl == "paged":
                reserved += self._pages_needed(r, g)
        if not picks:
            return 0
        self._install_group(picks)
        self.stats["refills"] += len(picks)
        for slot, r in picks:
            if w.requests[slot] is not None \
                    and w.filled[slot] >= w.targets[slot]:
                self._retire(slot)
        return len(picks)

    def _retire(self, slot: int) -> None:
        w = self.wave
        while True:
            self._flush_anchors()
            r = w.requests[slot]
            r.out = w.bufs[slot, : r.max_new].copy()
            r.latency_s = self.clock.now() - r.t_start
            self.done.append(r)
            # tokens actually committed (a cycle-cap bailout can retire
            # a request short of max_new)
            committed = int(min(w.filled[slot], r.max_new))
            self.stats["tokens"] += committed
            if self.recorder is not None:
                self.recorder.on_done(r.uid, committed)
            w.requests[slot] = None
            w.targets[slot] = 0
            if w.pool is not None:
                donated = set()
                if w.cache is not None and not w.trunc[slot]:
                    # seed the radix tree with the committed string (prompt
                    # + every banked token but the last anchor, which was
                    # never written to cache); private pages covering the
                    # new suffix are donated to the tree
                    committed = np.concatenate(
                        [np.asarray(r.prompt, np.int32),
                         w.bufs[slot, : max(int(w.filled[slot]) - 1, 0)]])
                    hit = w.row_hits[slot]
                    donated = w.cache.insert(
                        committed, w.row_tables[slot],
                        private=set(w.row_pages[slot]),
                        min_donate_idx=len(hit.shared) if hit else 0)
                if w.row_hits[slot] is not None:
                    w.cache.release(w.row_hits[slot])
                    w.row_hits[slot] = None
                leftover = [p for p in w.row_pages[slot] if p not in donated]
                if leftover:
                    w.pool.free(leftover)
                w.row_pages[slot] = []
                w.row_tables[slot] = None
            if not (self.refill and self.queue
                    and self._fits(self.queue[0])):
                return
            self._install_group([(slot, self.queue.pop(0))])
            self.stats["refills"] += 1
            if w.filled[slot] < w.targets[slot]:
                return
            # the adopted request was satisfied by its prefill alone

    def _finish_wave(self) -> None:
        w = self.wave
        self._flush_anchors()
        dt = self.clock.now() - w.t0
        self.stats["cycles"] += w.cycles * len(w.requests)
        self.stats["wall_s"] += dt
        self.stats["waves"] += 1
        self.stats["alpha"] = (self._alpha_num / self._alpha_den
                               if self._alpha_den else 0.0)
        if self._warm_durs:
            self.stats["warm_cycle_s"] = float(np.median(self._warm_durs))
            self.stats["warm_cycles"] = len(self._warm_durs)
        if w.pool is not None:
            self.stats["pool_peak_pages"] = max(
                self.stats["pool_peak_pages"], w.pool.peak_in_use)
            self.stats["pool_utilization"] = (
                self._util_sum / self._util_samples
                if self._util_samples else 0.0)
        if w.cache is not None:
            # delta since wave start (an engine-lifetime cache accumulates)
            self.stats["prefix_evictions"] += w.cache.evictions - w.evictions0
            self.stats["prefix_cached_pages"] = w.cache.cached_pages
        if w.pool is not None and self.pool_scope == "engine":
            # borrowed-pool contract: the next wave adopts these tensors
            self._pools = capture_pools(w.state)
        self.wave = None

    # ----------------------------------------------------- drain loop -----
    def run(self) -> Dict:
        """Synchronous drain loop (dispatch + complete back-to-back);
        ``wall_s`` sums per-wave deltas of the injected clock."""
        while self.queue or self.wave is not None:
            if self.wave is None and not self.start_wave():
                break
            while self.wave is not None and self.step():
                pass
        s = dict(self.stats)
        s["tokens_per_s"] = (s["tokens"] / s["wall_s"]
                             if s["wall_s"] else 0.0)
        return s

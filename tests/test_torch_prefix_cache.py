"""The JAX prefix-cache suites (``test_prefix_cache.py`` and
``test_pool_invariants.py``) mirrored on the port: the host-side radix
tree over the port's ``PagePool`` (``repro_torch.serving.prefix_cache``),
prefix-aware serving through the port's ``ServingEngine`` (token identity,
COW, multi-turn hits into generated tokens, bucketing), and the
randomized pool / radix / COW invariants after every engine step, a page
with refcount > 1 held bit-identical in every pool for as long as it is
shared. Seed 0 of the randomized schedule runs in tier 1; the rerolls
are marked ``slow``, as in the JAX suite. References are the port's
plain greedy decoding (``_torch_parity.port_greedy``); the engine itself
is held to the JAX engine in ``test_torch_serving.py``. float32, tiny
shapes.
"""
import collections
import functools

import jax
import numpy as np
import pytest
from conftest import tiny_drafter, tiny_target

from _torch_parity import port_bundle, port_greedy, port_model_cfg
from repro.config.base import SpecConfig as JSpec
from repro.core import pipeline as jpl
from repro.core.drafter import drafter_init as jdrafter_init
from repro.models import lm as jlm
from repro_torch.core import pipeline as tpl
from repro_torch.core.state import capture_pools
from repro_torch.models import kvcache as kvc
from repro_torch.serving import engine as teng
from repro_torch.serving.engine import Request
from repro_torch.serving.prefix_cache import PrefixCache

GAMMA = 4
PAGE = 8

# the port's engine on the CPU, called as the JAX suites call theirs
ServingEngine = functools.partial(teng.ServingEngine, device="cpu")


@pytest.fixture(scope="module")
def bundle():
    tcfg = tiny_target(vocab=61, dtype="float32")
    dcfg = tiny_drafter(vocab=61, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    return port_bundle(jpl.SpecBundle(
        tcfg, dcfg, dcfg, JSpec(gamma=GAMMA, top_k_branches=2, mode="d2sd"),
        jlm.lm_init(jax.random.PRNGKey(0), tcfg),
        jdrafter_init(jax.random.PRNGKey(1), dcfg),
        jdrafter_init(jax.random.PRNGKey(2), dcfg)))


def _ref(bundle, prompt, n):
    return port_greedy(bundle, prompt, n)


# ===================================================== host-side radix ====
def _insert_string(cache: PrefixCache, pool: kvc.PagePool, tokens):
    """Simulate a retired row: allocate private pages for the uncached
    suffix of ``tokens``, build its row table, insert. Returns the table."""
    tokens = np.asarray(tokens, np.int32)
    hit = cache.lookup(np.concatenate([tokens, [999]]))  # uncapped-ish match
    shared = hit.shared if hit else []
    n_total = kvc.pages_for(len(tokens), pool.page_size)
    priv = pool.alloc(n_total - len(shared))
    assert priv is not None
    if hit:
        cache.acquire(hit)
        cache.release_partial(hit)
    table = pool.row_table(shared + priv, max_pages=n_total)
    donated = cache.insert(tokens, table, private=set(priv),
                           min_donate_idx=len(shared))
    if hit:
        cache.release(hit)
    leftover = [p for p in priv if p not in donated]
    if leftover:
        pool.free(leftover)
    return table


def test_radix_match_insert_roundtrip():
    pool = kvc.PagePool(12, PAGE)
    cache = PrefixCache(pool)
    s = np.arange(100, 120, dtype=np.int32)          # 20 tokens, 3 pages
    assert cache.lookup(s) is None                    # empty tree
    t = _insert_string(cache, pool, s)
    # full-string prompt: match capped at P-1 (one suffix token must stay)
    hit = cache.lookup(s)
    assert hit.length == 19
    assert hit.shared == [int(t[0]), int(t[1])]       # 2 full pages
    assert hit.partial == int(t[2])                   # position 19's page
    # page-aligned prefix: no COW source
    hit16 = cache.lookup(s[:17])
    assert hit16.length == 16 and hit16.partial is None
    assert hit16.shared == [int(t[0]), int(t[1])]
    # divergent first token: miss
    assert cache.lookup(np.asarray([7, 8, 9], np.int32)) is None
    # fully cached reinsert donates nothing and frees the duplicates
    free0 = pool.free_pages
    _insert_string(cache, pool, s)
    assert pool.free_pages == free0


def test_radix_split_and_override_pages():
    pool = kvc.PagePool(16, PAGE)
    cache = PrefixCache(pool)
    a = np.arange(100, 118, dtype=np.int32)           # 18 tokens
    ta = _insert_string(cache, pool, a)
    # second string diverges mid-edge at token 10 (inside page 1)
    b = np.concatenate([a[:10], np.arange(300, 312, dtype=np.int32)])
    tb = _insert_string(cache, pool, b)
    assert cache.n_nodes == 3                         # split upper + 2 leaves
    # matching a's full string still resolves a's own pages
    ha = cache.lookup(a)
    assert ha.length == 17
    assert ha.shared == [int(ta[0]), int(ta[1])]
    # matching b resolves the COW override for page 1, not a's page
    hb = cache.lookup(b)
    assert hb.length == len(b) - 1
    assert hb.shared[0] == int(ta[0])                 # shared page 0
    assert hb.shared[1] == int(tb[1]) != int(ta[1])   # b's override copy
    # the partially-matched upper node's page stays with the upper half:
    # a prompt diverging inside page 0 still finds page 0
    h = cache.lookup(np.concatenate([a[:5], [999, 998]]).astype(np.int32))
    assert h.length == 5 and h.partial == int(ta[0]) and h.shared == []


def test_radix_lru_eviction_order_and_refusal():
    pool = kvc.PagePool(6, PAGE)
    cache = PrefixCache(pool)
    s1 = np.arange(100, 116, dtype=np.int32)          # 2 pages
    s2 = np.arange(200, 216, dtype=np.int32)          # 2 pages
    _insert_string(cache, pool, s1)
    t2 = _insert_string(cache, pool, s2)
    assert pool.free_pages == 2
    cache.lookup(s1)                                  # s1 most recently used
    assert cache.evictable_pages() == 4
    # pin s2 (a row reads its pages) -> only s1 is reclaimable
    hit2 = cache.lookup(s2[:9])
    cache.acquire(hit2)
    assert cache.evictable_pages() == 2
    # pressure for 5 free pages can only reach 4 (s1) -> refuse, but the
    # unpinned LRU leaf (s1, older use BUT s1 was just looked up...) —
    # s2 is pinned so s1 goes regardless of LRU order
    assert not cache.evict_for(5)
    assert pool.free_pages == 4 and cache.evictions == 1
    assert cache.lookup(s1) is None                   # s1 evicted
    assert cache.lookup(s2[:9]).shared == hit2.shared  # s2 survived (pinned)
    # release the pin: now s2 is evictable too
    cache.release_partial(hit2)
    cache.release(hit2)
    assert cache.evict_for(6)
    assert pool.free_pages == 6 and cache.lookup(s2[:9]) is None
    pool.sanity_check()


def test_pageless_split_leaf_evicted_under_inflight_hit():
    """Regression: a _split can leave the LOWER half with zero pages
    (every page start falls before the split point), and such a node
    cannot be pinned through page refcounts. Evicting it while a row's
    full-length hit is in flight shortens the retire-time walk below the
    row's shared boundary; insert's donation must be clamped to the
    row's private span (min_donate_idx), not re-derived from the walk."""
    page = 4
    pool = kvc.PagePool(20, page)
    cache = PrefixCache(pool)
    a = np.arange(100, 108, dtype=np.int32)     # page-aligned length 8
    _insert_string(cache, pool, a)
    # diverge inside a's LAST page -> split at 6 leaves the lower half
    # [6, 8) with no pages (idx0/idx1 both start before the split)
    b = np.concatenate([a[:6], np.asarray([7, 7, 7, 7], np.int32)])
    _insert_string(cache, pool, b)
    # in-flight row with a full-length hit on a's string
    prompt = np.concatenate([a, np.asarray([9], np.int32)])
    committed = np.concatenate([prompt, np.asarray([9, 9, 9], np.int32)])
    hit = cache.lookup(prompt)
    assert hit.length == 8 and len(hit.shared) == 2
    cache.acquire(hit)
    n_total = kvc.pages_for(len(committed) + 2, page)
    priv = pool.alloc(n_total - len(hit.shared))
    cache.release_partial(hit)
    table = pool.row_table(hit.shared + priv, n_total)
    # maximal pressure: every unpinned leaf goes, INCLUDING the page-less
    # lower node on the hit's matched path (pinning must refuse the rest)
    assert not cache.evict_for(pool.n_pages + 1)
    donated = cache.insert(committed, table, private=set(priv),
                           min_donate_idx=len(hit.shared))
    cache.release(hit)
    pool.free([p for p in priv if p not in donated])
    pool.sanity_check()
    assert donated and donated <= set(priv)
    # the reinserted string resolves end to end: shared pages via the
    # surviving pinned owner, private suffix via the new child
    h2 = cache.lookup(np.concatenate([committed, [11]]).astype(np.int32))
    assert h2.length == len(committed)
    assert h2.shared[:2] == hit.shared          # still the donor's pages


def test_radix_eviction_pressure_stress():
    """Randomized interleaving of admissions / retires / insertions under
    a deliberately tight pool: LRU eviction fires while hit paths are in
    flight (including partially pinned chains whose tail leaf is
    evictable), and the donation invariant — insert never hands the tree
    a page the row does not own — must hold throughout; refcounts must
    balance at drain."""
    rng = np.random.default_rng(0)
    page = 4
    pool = kvc.PagePool(48, page)
    cache = PrefixCache(pool)
    # tiny alphabet + shared base strings -> deep overlap, frequent splits
    base = [rng.integers(0, 3, size=int(rng.integers(6, 30))).astype(np.int32)
            for _ in range(6)]
    live = []                       # (hit, priv, table, committed)

    def retire(entry):
        hit, priv, table, toks = entry
        donated = cache.insert(toks, table, private=set(priv),
                               min_donate_idx=len(hit.shared) if hit else 0)
        if hit:
            cache.release(hit)
        leftover = [p for p in priv if p not in donated]
        if leftover:
            pool.free(leftover)

    denied = 0
    for _ in range(300):
        if live and (len(live) >= 4 or rng.random() < 0.45):
            retire(live.pop(int(rng.integers(0, len(live)))))
            continue
        b = base[int(rng.integers(0, len(base)))]
        prompt = np.concatenate(
            [b[: int(rng.integers(1, len(b) + 1))],
             rng.integers(0, 3, size=int(rng.integers(1, 6))).astype(np.int32)])
        committed = np.concatenate(
            [prompt, rng.integers(0, 3,
                                  size=int(rng.integers(0, 8))).astype(np.int32)])
        n_total = kvc.pages_for(len(committed) + 3, page)  # alloc headroom
        hit = cache.lookup(prompt)
        if hit:
            cache.acquire(hit)
        n_new = n_total - (len(hit.shared) if hit else 0)
        if pool.free_pages < n_new:
            cache.evict_for(n_new)
        priv = pool.alloc(n_new)
        if priv is None:                   # admission denied, give hit back
            if hit:
                cache.release_partial(hit)
                cache.release(hit)
            denied += 1
            continue
        table = pool.row_table((hit.shared if hit else []) + priv, n_total)
        if hit:
            cache.release_partial(hit)     # host analogue of post-COW drop
        live.append((hit, priv, table, committed))
    while live:
        retire(live.pop())
    pool.sanity_check()
    assert cache.evictions > 0             # pressure really fired eviction
    # every allocated page is exactly the tree's (all row refs released)
    assert pool.pages_in_use == cache.cached_pages


def test_page_pool_refcount_edge_cases():
    pool = kvc.PagePool(4, PAGE)
    # exhaustion mid-admission: no partial grant, state unchanged
    a = pool.alloc(3)
    assert pool.alloc(2) is None and pool.free_pages == 1
    # sharing lifecycle: second owner keeps the page allocated
    pool.incref([a[0]])
    pool.free([a[0]])
    assert pool.refcount(a[0]) == 1 and pool.free_pages == 1
    pool.free([a[0]])
    assert pool.refcount(a[0]) == 0 and pool.free_pages == 2
    # double free / refcount underflow
    with pytest.raises(AssertionError):
        pool.free([a[0]])
    # incref of a free page is meaningless
    with pytest.raises(AssertionError):
        pool.incref([a[0]])
    # foreign page ids
    with pytest.raises(AssertionError):
        pool.free([99])
    pool.sanity_check()


# ============================================== serving: COW + identity ====
def _serve(bundle, reqs, **kw):
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE, **kw)
    for p, n in reqs:
        eng.submit(p, max_new=n)
    stats = eng.run()
    return eng, stats


def test_prefix_serving_token_identity_and_cow(bundle):
    """Shared-system-prompt fleet: cache-on serving is token-identical to
    cache-off AND to standalone greedy decoding, while sharing pages
    (hits, COW copies, prefill tokens saved all exercised) — the PR
    acceptance criterion. Hit rows decode *concurrently* with other live
    rows, so drafter feature-cache extension and verify KV commits both
    run against shared (refcount > 1) prefix pages without touching
    them."""
    v = bundle.target_cfg.vocab_size
    rng = np.random.default_rng(3)
    sysp = rng.integers(0, v, size=19).astype(np.int32)
    reqs = []
    for i in range(5):
        tail = rng.integers(0, v, size=4 + i).astype(np.int32)
        reqs.append((np.concatenate([sysp, tail]), 4 + (i % 3)))
    e_off, s_off = _serve(bundle, reqs, prefix_cache=False)
    e_on, s_on = _serve(bundle, reqs, prefix_cache=True)
    outs = lambda e: {r.uid: r.out.tolist() for r in e.done}  # noqa: E731
    assert outs(e_off) == outs(e_on)
    for r in e_on.done:
        assert np.array_equal(r.out, _ref(bundle, reqs[r.uid][0],
                                          r.max_new)), r.uid
    assert s_on["prefix_hits"] > 0
    assert s_on["prefill_tokens_saved"] > 0
    assert s_on["cow_copies"] > 0
    assert s_on["prefix_hit_tokens"] >= s_on["prefix_hits"] * (len(sysp) - 1)
    # cache-off engine never hits
    assert s_off["prefix_hits"] == 0 and s_off["cow_copies"] == 0


def test_prefix_serving_multiturn_hits_generated_tokens(bundle):
    """Multi-turn chat: turn-2 prompts extend turn-1's prompt+answer, so
    matches reach into the *generated* region the retired request
    committed (insert-at-retire covers decode-committed pages, not just
    the prefill)."""
    v = bundle.target_cfg.vocab_size
    rng = np.random.default_rng(5)
    t1 = [(rng.integers(0, v, size=7 + 2 * i).astype(np.int32), 5)
          for i in range(2)]
    t2 = []
    for p, n in t1:
        out = _ref(bundle, p, n)
        t2.append((np.concatenate(
            [p, out, rng.integers(0, v, size=4).astype(np.int32)]), 4))
    reqs = t1 + t2
    e_on, s_on = _serve(bundle, reqs, prefix_cache=True)
    for r in e_on.done:
        assert np.array_equal(r.out, _ref(bundle, reqs[r.uid][0],
                                          r.max_new)), r.uid
    # hits must extend beyond the turn-1 prompts into generated tokens:
    # each turn-2 match covers prompt + (max_new - 1) committed outputs
    min_t2_hit = sum(len(p) + n - 1 for p, n in t1)
    assert s_on["prefix_hit_tokens"] >= min_t2_hit
    assert s_on["prefix_hits"] >= len(t2)


def test_bucketed_install_bounds_traces(bundle):
    """Prompt-length bucketing: distinct donated-install traces stay
    O(buckets) under varying prompt lengths, token output unchanged."""
    v = bundle.target_cfg.vocab_size
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, v, size=5 + i).astype(np.int32), 3)
            for i in range(7)]                        # 7 distinct lengths
    e_exact, s_exact = _serve(bundle, reqs, prefix_cache=False,
                              bucket_sizes=None)      # legacy exact installs
    e_bkt, s_bkt = _serve(bundle, reqs, prefix_cache=False,
                          bucket_sizes=(8, 16))
    outs = lambda e: {r.uid: r.out.tolist() for r in e.done}  # noqa: E731
    assert outs(e_exact) == outs(e_bkt)
    assert s_exact["install_traces"] == 7             # one per length
    # one trace per (bucket, install group size): the wave's same-bucket
    # initial pair goes through ONE batched install_rows dispatch (its own
    # trace), refills are singles per bucket — still O(buckets), and
    # strictly fewer donated dispatches than requests
    assert s_bkt["install_traces"] <= 3
    assert s_bkt["install_calls"] < s_bkt["installs"]
    for r in e_bkt.done:
        assert np.array_equal(r.out, _ref(bundle, reqs[r.uid][0],
                                          r.max_new)), r.uid


def test_prefix_cache_requires_paged_and_global(bundle):
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(bundle, cache_impl="dense", prefix_cache=True)
    tcfg = tiny_target(vocab=61, dtype="float32",
                       layer_pattern=("local", "global"), sliding_window=16)
    b2 = tpl.SpecBundle(port_model_cfg(tcfg), bundle.d1_cfg, bundle.d2_cfg,
                        bundle.spec, bundle.target_params, bundle.d1_params,
                        bundle.d2_params)
    with pytest.raises(ValueError, match="global"):
        ServingEngine(b2, cache_impl="paged", prefix_cache=True)


# ===================================================== invariant checker ===
def _live_refs(eng):
    """(pool, cache, refs, tables): host-side reconstruction of every page
    reference — tree node pages plus, per live row, its private pages and
    its hit's shared pages — and the per-row table page sets."""
    w = eng.wave
    pool = eng.pool if eng.pool is not None else (w.pool if w else None)
    cache = eng.cache if eng.cache is not None else (w.cache if w else None)
    refs = collections.Counter()
    tables = []
    if cache is not None:
        for node in cache._nodes():
            for _, p in node.pages:
                refs[p] += 1
    if w is not None:
        for slot, r in enumerate(w.requests):
            if r is None:
                continue
            for p in w.row_pages[slot]:
                refs[p] += 1
            hit = w.row_hits[slot]
            if hit is not None:
                for p in hit.shared:
                    refs[p] += 1
            t = w.row_tables[slot]
            tables.append({int(x) for x in t if int(x) < pool.n_pages})
    return pool, cache, refs, tables


def check_invariants(eng, watch=None):
    """The global pool/radix/COW invariants, checked between engine steps
    (install/retire/COW are atomic within a step from the host's view)."""
    pool, cache, refs, tables = _live_refs(eng)
    if pool is None:
        return
    rc = pool.refcounts()
    free = pool.free_page_ids
    for p in range(pool.n_pages):
        # refcounts == table + tree reference counts, exactly
        assert rc[p] == refs[p], (
            f"page {p}: pool refcount {rc[p]} != reconstructed {refs[p]}")
        # free-list ∩ referenced pages = ∅
        assert (p in free) == (rc[p] == 0), (
            f"page {p}: refcount {rc[p]} but free={p in free}")
    # no page in two tables without a refcount covering every reader
    occ = collections.Counter()
    for t in tables:
        occ.update(t)
    for p, k in occ.items():
        if k > 1:
            assert rc[p] >= k, (
                f"page {p} in {k} tables but refcount {rc[p]}")
    pool.sanity_check()
    if watch is not None:
        watch.observe(eng)


def _page_slices(pools, p):
    """Host copies of physical page ``p`` from every paged k/v buffer."""
    out = []
    for name in sorted(pools):
        for arr in pools[name]:
            a = np.asarray(arr)
            out.append(np.take(a, p, axis=a.ndim - 4).copy())
    return out


class SharedPageWriteMonitor:
    """The COW invariant, observed: a page with refcount > 1 must never be
    written. Each shared page's contents in every pool are snapshotted
    when it becomes shared and must stay bit-identical at every later
    observation until its refcount drops back to 1."""

    def __init__(self):
        self.snaps = {}
        self.pages_checked = 0

    def observe(self, eng):
        w = eng.wave
        pool = eng.pool if eng.pool is not None else (w.pool if w else None)
        if pool is None or w is None:
            return
        rc = pool.refcounts()
        pools = capture_pools(w.state)
        for p in [q for q in self.snaps if rc[q] <= 1]:
            del self.snaps[p]
        for p in (q for q in range(pool.n_pages) if rc[q] > 1):
            cur = _page_slices(pools, p)
            if p in self.snaps:
                for a, b in zip(self.snaps[p], cur):
                    assert np.array_equal(a, b), (
                        f"shared page {p} (refcount {rc[p]}) was written")
                self.pages_checked += 1
            else:
                self.snaps[p] = cur


# ======================================================= schedule driver ===
def _drive(eng, reqs, rng, watch=None):
    """Scripted schedule: bursty random arrivals interleaved with engine
    steps, invariants checked after every step. Returns the number of
    scheduled steps (engine events the invariants were checked after)."""
    pending = list(reqs)
    steps = 0
    while pending or eng.queue or eng.wave is not None:
        starved = not (eng.queue or eng.wave is not None)
        if pending and (starved or rng.random() < 0.18):
            for _ in range(min(int(rng.integers(3, 9)), len(pending))):
                p, n = pending.pop(0)
                eng.submit(p, max_new=n)
        if eng.wave is None:
            if not eng.queue:
                continue
            eng.start_wave()
        else:
            eng.step()
        steps += 1
        check_invariants(eng, watch)
    return steps


def _stress_traffic(v, rng, n_requests):
    """Random prompts drawn from shared prefix families (hits, splits,
    COW) with random budgets (randomized retire times)."""
    fams = [rng.integers(0, v, size=int(rng.integers(10, 18))).astype(np.int32)
            for _ in range(3)]
    reqs = []
    for _ in range(n_requests):
        f = fams[int(rng.integers(0, len(fams)))]
        cut = int(rng.integers(4, len(f) + 1))
        tail = rng.integers(0, v, size=int(rng.integers(1, 5))).astype(np.int32)
        reqs.append((np.concatenate([f[:cut], tail]),
                     int(rng.integers(2, 9))))
    return reqs


STRESS_SEEDS = [0] + [pytest.param(s, marks=pytest.mark.slow)
                      for s in (1, 2, 3)]


@pytest.mark.parametrize("seed", STRESS_SEEDS)
def test_randomized_pool_invariants(bundle, seed):
    """≥200-step randomized multi-wave schedule with zero refcount /
    free-list / shared-page-write violations (the PR acceptance
    criterion). Seed 0 is the tier-1 gate; the rerolls are the --stress
    variant."""
    rng = np.random.default_rng(seed)
    v = bundle.target_cfg.vocab_size
    reqs = _stress_traffic(v, rng, 120)
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE, prefix_cache=True,
                        bucket_sizes=(8, 16, 32), pool_headroom=0.75,
                        seed=seed)
    watch = SharedPageWriteMonitor()
    # three drain-to-empty chunks: every chunk boundary is a guaranteed
    # wave turnover, so the schedule always exercises the cross-wave
    # retention path regardless of how the bursty arrivals land
    steps = sum(_drive(eng, reqs[i::3], rng, watch) for i in range(3))
    assert steps >= 200, steps
    assert len(eng.done) == len(reqs)
    assert eng.stats["waves"] >= 3, "schedule never turned a wave over"
    assert eng.stats["prefix_hits"] > 0, "families never produced a hit"
    assert watch.pages_checked > 0, "no shared page was ever observed"
    # drained: every surviving page belongs to the tree, refs balanced
    check_invariants(eng, watch)
    assert eng.pool.pages_in_use == eng.cache.cached_pages


# ==================================================== cross-wave parity ====
def _phased_traffic(bundle, seed=11):
    """Phase 2 prompts extend phase 1's committed strings (prompt +
    greedy answer), so serving phase 2 after a wave turnover exercises
    cross-wave prefix hits."""
    v = bundle.target_cfg.vocab_size
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, v, size=13).astype(np.int32)
    phase1 = []
    for i in range(3):
        tail = rng.integers(0, v, size=4 + i).astype(np.int32)
        phase1.append((np.concatenate([sysp, tail]), 5))
    phase2 = []
    for p, n in phase1[:2]:
        ans = _ref(bundle, p, n)
        phase2.append((np.concatenate(
            [p, ans, rng.integers(0, v, size=3).astype(np.int32)]), 4))
    return phase1, phase2


def _serve_phases(bundle, phases, **kw):
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE, **kw)
    marks = []
    for reqs in phases:
        for p, n in reqs:
            eng.submit(p, max_new=n)
        eng.run()
        marks.append(dict(eng.stats))
    return eng, marks


def test_cross_wave_parity_legacy_vs_engine_pool(bundle):
    """Identical multi-wave traffic through per-wave pools (legacy), the
    engine-lifetime pool cache-off, and cache-on: per-request tokens
    must be identical, the cache-on run must hit prefixes cached in the
    PREVIOUS wave, and the outputs must match ``generate_ondevice``."""
    phases = _phased_traffic(bundle)
    e_legacy, _ = _serve_phases(bundle, phases, pool_scope="wave")
    e_off, _ = _serve_phases(bundle, phases)
    e_on, marks = _serve_phases(bundle, phases, prefix_cache=True)
    outs = lambda e: {r.uid: r.out.tolist() for r in e.done}  # noqa: E731
    assert outs(e_legacy) == outs(e_off) == outs(e_on)
    assert e_on.stats["waves"] >= 2
    # hits recorded AFTER the first turnover: phase 2 matched strings the
    # tree committed in phase 1's wave (the resident-server fast path)
    assert (marks[1]["prefix_hit_tokens"]
            > marks[0]["prefix_hit_tokens"]), marks
    # legacy per-wave pools cannot carry prefixes across run() calls
    assert e_legacy.stats["prefix_hits"] == 0
    # per-request parity against each request's standalone greedy decode
    for r in sorted(e_on.done, key=lambda r: r.uid):
        prompt = ([p for ph in phases for p, _ in ph])[r.uid]
        assert np.array_equal(r.out, _ref(bundle, prompt, r.max_new)), r.uid
    # ondevice-loop coverage: same shapes -> one trace, token-identical
    (p1, n1), (p2, n2) = phases[0][0], phases[0][1]
    for p, n, uid in ((p1, n1, 0), (p2, n2, 1)):
        dev = tpl.generate_ondevice(bundle, np.asarray(p)[None], n,
                                    device="cpu")
        assert np.array_equal(dev["tokens"][0],
                              outs(e_on)[uid]), uid


def test_cached_pages_survive_wave_turnover(bundle):
    """The borrowed-pool contract end to end: device contents of every
    page the radix tree owns are bit-identical before and after a wave
    turnover (capture_pools -> engine_init(pools=))."""
    phases = _phased_traffic(bundle, seed=17)
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE, prefix_cache=True)
    for p, n in phases[0]:
        eng.submit(p, max_new=n)
    eng.run()
    assert eng.wave is None and eng._pools is not None
    tree_pages = sorted({p for node in eng.cache._nodes()
                         for _, p in node.pages})
    assert tree_pages, "phase 1 cached nothing"
    before = {p: _page_slices(eng._pools, p) for p in tree_pages}
    for p, n in phases[1]:
        eng.submit(p, max_new=n)
    assert eng.start_wave()
    survivors = {p for node in eng.cache._nodes() for _, p in node.pages}
    after_pools = capture_pools(eng.wave.state)
    checked = 0
    for p in tree_pages:
        if p not in survivors:
            continue                      # evicted under phase-2 pressure
        for a, b in zip(before[p], _page_slices(after_pools, p)):
            assert np.array_equal(a, b), f"cached page {p} changed"
        checked += 1
    assert checked > 0
    eng.run()
    assert eng.stats["prefix_hits"] > 0


# ================================================= eviction under churn ====
def test_eviction_under_churn_across_waves(bundle):
    """Fill the engine pool across several waves, then admit a worst-case
    cold prompt: LRU eviction reclaims unpinned leaves only (live rows'
    pages are protected by their refcounts — verified by the invariant
    checks after every step), and re-admitting an evicted prefix is a
    clean miss with correct output (no stale page-table reads)."""
    v = bundle.target_cfg.vocab_size
    g = GAMMA
    rng = np.random.default_rng(23)
    fam = [rng.integers(0, v, size=14).astype(np.int32) for _ in range(3)]
    mk_tail = lambda k: rng.integers(0, v, size=k).astype(np.int32)  # noqa
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE, prefix_cache=True,
                        pool_headroom=0.5)
    watch = SharedPageWriteMonitor()
    # several waves of family traffic fill the tree up to the headroom
    for f in fam:
        reqs = [(np.concatenate([f, mk_tail(3)]), 4),
                (np.concatenate([f, mk_tail(5)]), 4)]
        _drive(eng, reqs, rng, watch)
        assert eng.wave is None
    filled = eng.cache.cached_pages
    assert filled > 0
    # worst-case cold prompt: needs more pages than are free -> eviction
    cold_prompt, cold_new = rng.integers(0, v, size=30).astype(np.int32), 6
    cold_req = Request(uid=-1, prompt=cold_prompt, max_new=cold_new)
    assert eng._pages_needed(cold_req, g) > eng.pool.free_pages
    _drive(eng, [(cold_prompt, cold_new)], rng, watch)
    assert eng.stats["prefix_evictions"] > 0
    # re-admission of an evicted prefix: find a family whose string no
    # longer matches -> clean miss, output still exact
    missed = [f for f in fam if eng.cache.lookup(
        np.concatenate([f, [0]]).astype(np.int32)) is None]
    assert missed, "cold admission evicted nothing from the families"
    misses0 = eng.stats["prefix_misses"]
    probe_prompt, probe_new = np.concatenate([missed[0], mk_tail(2)]), 4
    _drive(eng, [(probe_prompt, probe_new)], rng, watch)
    assert eng.stats["prefix_misses"] > misses0
    done = {r.uid: r for r in eng.done}
    probe_out = done[max(done)]
    assert np.array_equal(probe_out.out, _ref(bundle, probe_prompt,
                                              probe_new)), "stale read"
    check_invariants(eng, watch)


# ============================================== sizing-rule regression =====
def test_pool_sizing_no_refill_double_count(bundle):
    """Regression: the prefix-cache pool previously sized itself as
    ``sum(need)`` over the whole candidate window — counting likely-refill
    candidates' full needs ON TOP of the live set they refill into. The
    engine-global rule pins the budget to live-set + headroom."""
    v = bundle.target_cfg.vocab_size
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, v, size=9).astype(np.int32)
               for _ in range(6)]                  # 6 identical-need reqs
    g = bundle.spec.gamma

    def sized(prefix_cache, **kw):
        eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                            page_size=PAGE, prefix_cache=prefix_cache, **kw)
        for p in prompts:
            eng.submit(p, max_new=4)
        k = eng._pages_needed(eng.queue[0], g)
        assert eng.start_wave()
        return eng, k

    eng, k = sized(True, pool_headroom=0.25)
    live = 2 * k
    assert eng.pool.n_pages == live + int(np.ceil(0.25 * live))
    # the old window-sum rule (4 candidates) would have over-allocated
    assert eng.pool.n_pages < 4 * k
    # cache-off engine pool: live set only, no retention headroom
    eng_off, k = sized(False)
    assert eng_off.pool.n_pages == 2 * k
    # explicit override wins
    eng_ovr, _ = sized(True, pool_pages=4 * k + 1)
    assert eng_ovr.pool.n_pages == 4 * k + 1
    for e in (eng, eng_off, eng_ovr):
        e.run()
        assert len(e.done) == len(prompts)


def test_engine_pool_too_small_raises(bundle):
    """A head request that can never fit the fixed engine pool must fail
    loudly at start_wave, not hang or corrupt."""
    v = bundle.target_cfg.vocab_size
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE, pool_pages=2)
    eng.submit(np.arange(20, dtype=np.int32) % v, max_new=8)
    with pytest.raises(RuntimeError, match="pool"):
        eng.start_wave()


def test_engine_pool_sized_for_large_queued_request(bundle):
    """Auto-sizing must scan the WHOLE visible queue: a large request
    submitted behind a burst of small ones (beyond the first wave's
    candidate window) still gets a pool it fits and completes — the
    per-wave pools served this traffic, so the engine pool must too."""
    v = bundle.target_cfg.vocab_size
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, v, size=6).astype(np.int32)
               for _ in range(5)] + [rng.integers(0, v, size=50)
                                     .astype(np.int32)]
    eng = ServingEngine(bundle, batch_size=2, cache_impl="paged",
                        page_size=PAGE)
    for p in prompts:
        eng.submit(p, max_new=4)
    g = GAMMA
    assert (eng._pages_needed(eng.queue[-1], g)
            > 2 * eng._pages_needed(eng.queue[0], g))
    eng.run()
    assert len(eng.done) == len(prompts)
    assert eng._pages_needed(
        Request(uid=-1, prompt=prompts[-1], max_new=4), g) \
        <= eng.pool.n_pages
    for r in eng.done:
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid],
                                          r.max_new)), r.uid


def test_pool_pages_requires_engine_scope(bundle):
    """An explicit pool_pages override is meaningless for per-wave pools
    (and dense caches) and must be rejected, not silently ignored."""
    with pytest.raises(ValueError, match="pool_pages"):
        ServingEngine(bundle, cache_impl="paged", pool_scope="wave",
                      pool_pages=64)
    with pytest.raises(ValueError, match="pool_pages"):
        ServingEngine(bundle, cache_impl="dense", pool_pages=64)

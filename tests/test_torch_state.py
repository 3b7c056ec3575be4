"""The port's engine-state layer (``repro_torch.core.state``) held to the
JAX package: ``prefill(true_len=, start=)`` on dense and paged caches and
through both read paths, the slot-install plumbing (``install_rows``,
``cow_copy_page``, ``capture_pools`` / ``engine_init(pools=)``,
``refill_copy_bytes``), the host ``PagePool``, ``copy_page_``, the
in-place table patch that every paged cache reads, and dropped writes at
padded and sentinel positions. float32, tiny shapes, inputs from a numpy
seed; the JAX functions are jitted once per shape.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_drafter, tiny_target

from _torch_parity import (assert_state_matches, clone_state, port_bundle,
                           port_greedy)
from repro.config.base import SpecConfig as JSpec
from repro.core import pipeline as jpl
from repro.core import state as jcs
from repro.core.drafter import drafter_init as jdrafter_init
from repro.models import lm as jlm
from repro_torch.core import pipeline as tpl
from repro_torch.core import state as tcs
from repro_torch.models import kvcache as kvc

VOCAB, GAMMA, PAGE, MAX_LEN = 61, 5, 8, 48

jax_prefill = jax.jit(jcs.prefill)
jax_install_rows = jax.jit(jcs._install_rows_impl,
                           static_argnames=("temperature", "ctx_len"))


@functools.lru_cache(maxsize=None)
def _bundles(hybrid=False):
    """(JAX bundle, port bundle) at tiny size; ``hybrid``: a local/global
    target with a 16-token window, or with ``"recurrent"`` a
    recurrent/local/global one (its fourth layer recurrent)."""
    extra = (dict(layer_pattern=("recurrent", "local", "global"),
                  sliding_window=16) if hybrid == "recurrent" else
             dict(layer_pattern=("local", "global"), sliding_window=16)
             if hybrid else {})
    tcfg = tiny_target(vocab=VOCAB, dtype="float32", **extra)
    dcfg = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    jb = jpl.SpecBundle(tcfg, dcfg, dcfg, JSpec(gamma=GAMMA,
                                                top_k_branches=2),
                        jlm.lm_init(jax.random.PRNGKey(0), tcfg),
                        jdrafter_init(jax.random.PRNGKey(1), dcfg),
                        jdrafter_init(jax.random.PRNGKey(2), dcfg))
    return jb, port_bundle(jb)


def _table(b, rng):
    """[B, MAX_LEN/PAGE] shuffled page table over 2B rows' worth of pages,
    the last page of each row unallocated (sentinel)."""
    mp = MAX_LEN // PAGE
    pages = rng.permutation(2 * b * mp)[: b * mp].reshape(b, mp)
    pages[:, -1] = kvc.PAGE_SENTINEL
    return pages.astype(np.int32), 2 * b * mp


def _init(b, cache_impl, rng, impl="gather", hybrid=False):
    """JAX and port states over the same (shuffled, sentinel-tailed) page
    table."""
    jb, tb = _bundles(hybrid)
    tb = tpl.with_attn_impl(tb, impl)
    kw = {}
    if cache_impl == "paged":
        table, n_pages = _table(b, rng)
        kw = dict(page_size=PAGE, pool_pages=n_pages, page_table=table)
    js = jcs.engine_init(jb, b, MAX_LEN, cache_impl=cache_impl, **kw)
    ts = tcs.engine_init(tb, b, MAX_LEN, cache_impl=cache_impl,
                         device="cpu", **kw)
    return jb, tb, js, ts


def _snapshot(ts):
    """A copy of every tensor of a port state."""
    return clone_state(ts)


def _views(ts):
    """Per-layer logical K views [B, S, H, D] of a port state (a recurrent
    layer's state leaves, [B, ...]) and the two feature caches' [L, B, S,
    H, D]."""
    out = []
    for d in ts.target["layers"] + [ts.d1_feat, ts.d2_feat]:
        if "k" not in d:
            out += [d[name] for name in sorted(d)]
        else:
            out.append(kvc.pool_view(d["k"], d["pt"]) if kvc.is_paged(d)
                       else d["k"])
    return out


# ------------------------------------------------ prefill(true_len, start) --
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("case", ["padded", "warm", "warm_padded"])
def test_prefill_true_len_and_start_match_jax(case, cache_impl, impl):
    """A bucket-padded cold prefill and a warm start over a cache that an
    earlier prefill filled: every cache leaf equal to JAX's within 1e-6
    of its largest value, lengths and anchors exactly, and no entry at or
    past a row's real end written."""
    rng = np.random.default_rng(0)
    b = 3
    jb, tb, js, ts = _init(b, cache_impl, rng, impl)
    full = rng.integers(0, VOCAB, (b, 16)).astype(np.int32)
    if case == "padded":
        # a first prefill fills 10 positions; the padded one rewrites
        # only each row's first true_len of them
        first, first_len = full[:, :10], None
        second, start, true = full[:, 10:16], None, np.array([6, 3, 1])
    else:
        first, first_len = full[:, :8], np.array([4, 7, 2], np.int32)
        start = first_len
        second = full[:, 8:14]
        true = np.array([6, 3, 1]) if case == "warm_padded" else None
    js = jax_prefill(jb, js, jnp.asarray(first),
                     true_len=None if first_len is None
                     else jnp.asarray(first_len))
    ts = tcs.prefill(tb, ts, torch.as_tensor(first).long(),
                     true_len=None if first_len is None
                     else torch.as_tensor(first_len))
    assert_state_matches(ts, js, jb.target_cfg)
    before = _views(_snapshot(ts))
    kw_j = dict(true_len=None if true is None else jnp.asarray(true, jnp.int32),
                start=None if start is None else jnp.asarray(start))
    kw_t = dict(true_len=None if true is None else torch.as_tensor(true),
                start=None if start is None else torch.as_tensor(start))
    if case == "padded":
        js = js.replace(target={**js.target, "length": js.length * 0})
        ts = ts.replace(target={**ts.target, "length": ts.length * 0})
        second = np.concatenate([second, np.zeros((b, 2), np.int32)], 1)
    js = jax_prefill(jb, js, jnp.asarray(second), **kw_j)
    ts = tcs.prefill(tb, ts, torch.as_tensor(second).long(), **kw_t)
    assert_state_matches(ts, js, jb.target_cfg)
    # entries at or past each row's real end keep what the first
    # prefill wrote there
    n_real = second.shape[1] if true is None else true
    lo = np.zeros(b, int) if start is None else start
    for got, want in zip(_views(ts), before):
        for r in range(b):
            end = int(lo[r] + (n_real if np.isscalar(n_real) else n_real[r]))
            sl = (slice(None), r, slice(end, None)) if got.ndim == 5 \
                else (r, slice(end, None))
            assert torch.equal(got[sl], want[sl]), (r, end)
    assert ts.length.tolist() == (lo + n_real).tolist()


# ------------------------------------------------------------- installs ----
def _wave(cache_impl, rng, hybrid=False):
    """A 3-row wave prefilled with 8-token prompts (JAX, port)."""
    jb, tb, js, ts = _init(3, cache_impl, rng, hybrid=hybrid)
    prompts = rng.integers(0, VOCAB, (3, 8)).astype(np.int32)
    js = jax_prefill(jb, js, jnp.asarray(prompts))
    ts = tcs.prefill(tb, ts, torch.as_tensor(prompts).long())
    return jb, tb, js, ts


def _free_pages(ts, n, used_extra=()):
    """``n`` physical pages no row of ``ts`` holds."""
    used = set(ts.d1_feat["pt"].flatten().tolist()) | set(used_extra)
    free = [p for p in range(ts.d1_feat["k"].shape[1]) if p not in used]
    return free[:n]


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("hybrid", [False, True, "recurrent"])
def test_install_rows_match_jax_and_spare_neighbours(cache_impl, hybrid):
    """Two bucket-padded prompts installed into rows 0 and 2 in one call:
    the state equals JAX's install, and row 1 of every cache is
    bit-unchanged. With a recurrent layer in front the leaves are held at
    1e-5 of their largest value (the port's RG-LRU loop and JAX's
    associative scan round differently, and the layers behind it read
    its output), else 1e-6."""
    rng = np.random.default_rng(1)
    jb, tb, js, ts = _wave(cache_impl, rng, hybrid)
    before = _views(_snapshot(ts))
    prompts = np.zeros((2, 16), np.int32)
    true = np.array([11, 14], np.int32)
    for i, n in enumerate(true):
        prompts[i, :n] = rng.integers(0, VOCAB, n)
    tables = None
    if cache_impl == "paged":
        mp = ts.max_pages
        fresh = _free_pages(ts, 2 * 2)
        tables = np.full((2, mp), kvc.PAGE_SENTINEL, np.int32)
        tables[:, :2] = np.asarray(fresh).reshape(2, 2)
    js = jax_install_rows(jb, js, jnp.asarray([0, 2]), jnp.asarray(prompts),
                          jax.random.PRNGKey(0),
                          None if tables is None else jnp.asarray(tables),
                          temperature=0.0, ctx_len=0,
                          true_len=jnp.asarray(true))
    out = tcs.install_rows(tb, ts, [0, 2], prompts, row_tables=tables,
                           true_len=true)
    assert out is ts
    assert_state_matches(ts, js, jb.target_cfg,
                         tol=1e-5 if hybrid == "recurrent" else 1e-6)
    for got, want in zip(_views(ts), before):
        row = (slice(None), 1) if got.ndim == 5 else (1,)
        assert torch.equal(got[row], want[row])
    assert ts.length.tolist() == [11, 8, 14]


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_install_one_row_matches_jax_prefill_row(cache_impl):
    """``install_rows`` of one row, in place, gives JAX's ``prefill_row``
    state; every other row of every cache keeps its bytes, and the
    adopted anchor is plain greedy's first token."""
    rng = np.random.default_rng(2)
    jb, tb, js, ts = _wave(cache_impl, rng)
    newp = rng.integers(0, VOCAB, 12).astype(np.int32)
    kept = _snapshot(ts)
    table = None
    if cache_impl == "paged":
        table = np.full((ts.max_pages,), kvc.PAGE_SENTINEL, np.int32)
        table[:3] = _free_pages(ts, 3)
    jst = jcs.prefill_row(jb, js, 1, jnp.asarray(newp),
                          row_table=None if table is None
                          else jnp.asarray(table))
    out = tcs.install_rows(tb, ts, [1], newp[None],
                           row_tables=None if table is None else table[None])
    assert out is ts
    assert_state_matches(ts, jst, jb.target_cfg)
    for a, b in zip(_views(ts), _views(kept)):
        for row in (0, 2):
            idx = (slice(None), row) if a.ndim == 5 else (row,)
            assert torch.equal(a[idx], b[idx])
    assert int(ts.anchor[1]) == int(port_greedy(tb, newp, 1)[0])


def test_warm_install_after_cow_matches_jax_and_keeps_shared_page():
    """A prefix hit that ends mid-page: the tail page is copied (COW) to a
    fresh page, the suffix is installed warm over the shared full page,
    and the state equals JAX's; the shared page's bytes in every pool are
    the same before and after."""
    rng = np.random.default_rng(3)
    jb, tb, js, ts = _init(3, "paged", rng)
    base = rng.integers(0, VOCAB, (3, 16)).astype(np.int32)
    js = jax_prefill(jb, js, jnp.asarray(base))
    ts = tcs.prefill(tb, ts, torch.as_tensor(base).long())
    shared, partial = int(ts.d1_feat["pt"][0, 0]), int(ts.d1_feat["pt"][0, 1])
    hit = 12                                     # 1 full page + 4 tokens
    fresh = _free_pages(ts, 3)
    table = np.full((ts.max_pages,), kvc.PAGE_SENTINEL, np.int32)
    table[:4] = [shared] + fresh
    pools = tcs.capture_pools(ts)
    shared_bytes = [t[..., shared, :, :, :].clone() for kv in pools.values()
                    for t in kv]
    js = jcs.cow_copy_page(js, partial, fresh[0])
    tcs.cow_copy_page(ts, partial, fresh[0])
    assert_state_matches(ts, js, jb.target_cfg)
    suffix = np.concatenate([base[0, :hit], rng.integers(0, VOCAB, 9)])[hit:]
    prompts = np.zeros((1, 16), np.int32)
    prompts[0, :9] = suffix
    js = jax_install_rows(jb, js, jnp.asarray([2]), jnp.asarray(prompts),
                          jax.random.PRNGKey(0), jnp.asarray(table[None]),
                          temperature=0.0, ctx_len=0,
                          true_len=jnp.asarray([9]),
                          prefix_hits=jnp.asarray([hit]))
    tcs.install_rows(tb, ts, [2], prompts, row_tables=table[None],
                     true_len=[9], prefix_hits=[hit])
    assert_state_matches(ts, js, jb.target_cfg)
    assert ts.length.tolist() == [16, 16, hit + 9]
    after = [t[..., shared, :, :, :] for kv in tcs.capture_pools(ts).values()
             for t in kv]
    for a, b in zip(shared_bytes, after):
        assert torch.equal(a, b)
    # the warm row decodes what a cold prefill of the whole prompt gives
    whole = np.concatenate([base[0, :hit], suffix])
    assert int(ts.anchor[2]) == int(port_greedy(tb, whole, 1)[0])


def test_table_patch_reaches_every_paged_cache():
    """The wave's page table is one tensor that every paged cache reads:
    an install patches it in place, each layer and both feature caches
    see the new row, and no pool or table tensor is rebound."""
    rng = np.random.default_rng(4)
    _, tb, _, ts = _init(3, "paged", rng)
    dicts = [d for d in ts.target["layers"] if kvc.is_paged(d)] + [
        ts.d1_feat, ts.d2_feat]
    ids = [(id(d["k"]), id(d["v"]), id(d["pt"])) for d in dicts]
    assert len({id(d["pt"]) for d in dicts}) == 1
    table = np.full((ts.max_pages,), kvc.PAGE_SENTINEL, np.int32)
    table[:2] = _free_pages(ts, 2)
    tcs.install_rows(tb, ts, [1], rng.integers(0, VOCAB, (1, 10)),
                     row_tables=table[None])
    for d, i in zip(dicts, ids):
        assert (id(d["k"]), id(d["v"]), id(d["pt"])) == i
        assert d["pt"][1].tolist() == table.tolist()
    # the batch-1 install target holds the wave's pools themselves
    sub = tcs.rows_template(ts, table[None])
    assert sub.batch == 1 and sub.d1_feat["k"] is ts.d1_feat["k"]
    assert sub.target["layers"][0]["pt"].tolist() == [table.tolist()]


def test_sentinel_and_padding_writes_are_dropped():
    """A write through a sentinel page-table entry or past ``valid``
    drops: the last physical page (what a clamped write would hit) keeps
    its bytes."""
    pool = torch.arange(4 * 2 * 1 * 1, dtype=torch.float32).reshape(4, 2, 1, 1)
    keep = pool.clone()
    table = torch.tensor([[0, kvc.PAGE_SENTINEL]], dtype=torch.int32)
    new = torch.full((1, 4, 1, 1), -1.0)
    pos = torch.arange(4)[None]
    kvc.pool_scatter_(pool, table, new, pos,
                      valid=torch.tensor([[True, False, True, True]]))
    assert pool[0, 0].item() == -1.0 and pool[0, 1] == keep[0, 1]
    assert torch.equal(pool[1:], keep[1:])


def test_capture_pools_hand_over_the_same_tensors():
    """``engine_init(pools=)`` takes the captured pool tensors
    themselves, not copies."""
    rng = np.random.default_rng(5)
    _, tb, _, s0 = _init(2, "paged", rng)
    pools = tcs.capture_pools(s0)
    assert set(pools) == {f"target/{i}" for i in range(4)} | {"d1_feat",
                                                              "d2_feat"}
    table = np.full((2, MAX_LEN // PAGE), kvc.PAGE_SENTINEL, np.int32)
    n_pages = s0.d1_feat["k"].shape[1]
    s1 = tcs.engine_init(tb, 2, MAX_LEN, cache_impl="paged", page_size=PAGE,
                         pool_pages=n_pages, page_table=table, device="cpu",
                         pools=pools)
    for name, (k, v) in tcs.capture_pools(s1).items():
        assert k is pools[name][0] and v is pools[name][1], name


@pytest.mark.parametrize("hybrid", [False, True, "recurrent"])
def test_refill_copy_bytes_equal_to_jax(hybrid):
    """The install accounting model gives JAX's numbers, dense and paged;
    paged installs cost page-order bytes, dense a full row."""
    rng = np.random.default_rng(6)
    out = {}
    for cache_impl in ("dense", "paged"):
        _, _, js, ts = _init(2, cache_impl, rng, hybrid=hybrid)
        for n in (1, 8, 13):
            got = tcs.refill_copy_bytes(ts, n)
            assert got == jcs.refill_copy_bytes(js, n), (cache_impl, n)
        out[cache_impl] = tcs.refill_copy_bytes(ts, 8)
    assert out["paged"] * 3 < out["dense"]


# ------------------------------------------------------- pool primitives ---
def test_page_pool_alloc_free_invariants():
    pool = kvc.PagePool(6, PAGE)
    a = pool.alloc(4)
    assert len(set(a)) == 4 and pool.free_pages == 2
    assert pool.alloc(3) is None            # no partial grants
    b = pool.alloc(2)
    assert pool.free_pages == 0 and pool.peak_in_use == 6
    pool.free(a)
    assert pool.free_pages == 4 and pool.pages_in_use == 2
    c = pool.alloc(4)
    assert set(c) == set(a)                 # pages are recycled
    with pytest.raises(AssertionError):
        pool.free([c[0], c[0]])             # double free
    t = pool.row_table(b, max_pages=5)
    assert list(t[:2]) == b and (t[2:] == kvc.PAGE_SENTINEL).all()
    pool.incref([b[0]])
    pool.free([b[0]])
    assert pool.refcount(b[0]) == 1
    with pytest.raises(AssertionError):
        pool.incref([a[0]] if pool.refcount(a[0]) == 0 else [99])


def test_copy_page_matches_jax():
    """``copy_page_`` on stacked pools equals JAX's ``copy_page``."""
    from repro.models import kvcache as jkvc
    x = np.random.default_rng(7).normal(size=(2, 5, 4, 2, 3)).astype(
        np.float32)
    want = np.asarray(jkvc.copy_page(jnp.asarray(x), 3, 1))
    got = kvc.copy_page_(torch.as_tensor(x.copy()), 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- decode masking ---
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_decode_cycle_inactive_row_frozen(cache_impl):
    """A masked row keeps length, anchor, page table and its logical
    cache view bit-identical through a decode cycle."""
    rng = np.random.default_rng(9)
    _, tb, _, ts = _init(2, cache_impl, rng)
    ts = tcs.prefill(tb, ts, torch.as_tensor(
        rng.integers(0, VOCAB, (2, 8))).long())
    ts = ts.replace(active=torch.tensor([True, False]))
    before = _snapshot(ts)
    st2, out = tpl.decode_cycle(tb, ts, torch.Generator(),
                                collect_stats=False)
    n_out = out["n_out"].tolist()
    assert n_out[0] >= 1 and n_out[1] == 0
    assert st2.length.tolist()[1] == before.length.tolist()[1]
    assert st2.length.tolist()[0] > before.length.tolist()[0]
    assert int(st2.anchor[1]) == int(before.anchor[1])
    for a, b in zip(_views(st2), _views(before)):
        row = (slice(None), 1) if a.ndim == 5 else (1,)
        assert torch.equal(a[row], b[row])
    if cache_impl == "paged":
        assert torch.equal(st2.d1_feat["pt"], before.d1_feat["pt"])


@pytest.mark.parametrize("case", ["dense", "paged", "paged_warm"])
def test_install_makes_no_host_sync(case):
    """An install whose inputs are already tensors (on a card the engine
    hands them over through pinned memory without blocking): the
    prefill, the table patch and the row splices read nothing back and
    make no tensor from host data, so the engine can enqueue an install
    behind an in-flight decode cycle."""
    from test_torch_ondevice import _NoHostSync
    rng = np.random.default_rng(10)
    jb, tb, js, ts = _wave("dense" if case == "dense" else "paged", rng)
    prompts = torch.as_tensor(rng.integers(0, VOCAB, (2, 16))).long()
    kw = dict(true_len=torch.tensor([13, 9], dtype=torch.int32))
    if case != "dense":
        table = np.full((2, ts.max_pages), kvc.PAGE_SENTINEL, np.int32)
        table[:, :3] = np.asarray(_free_pages(ts, 6)).reshape(2, 3)
        if case == "paged_warm":
            table[:, 0] = ts.d1_feat["pt"][0, 0].item()    # one shared page
            kw["prefix_hits"] = torch.tensor([8, 8], dtype=torch.int32)
        kw["row_tables"] = torch.as_tensor(table)
    with _NoHostSync() as mode:
        tcs.install_rows(tb, ts, [0, 2], prompts, **kw)
    assert torch.ops.aten.index_copy_ in mode.ops
    assert ts.length.tolist() == ([21, 8, 17] if case == "paged_warm"
                                  else [13, 8, 9])

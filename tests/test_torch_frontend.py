"""The JAX front-end suite (``test_frontend.py``) mirrored on the port
(``repro_torch.serving.frontend``, ``metrics`` and ``traffic``), and the
port held to the JAX front-end: a seed gives the same arrival trace and
the same prompts, and a replay on a ``VirtualClock`` (1 virtual second a
decode cycle, 0.25 an install) gives per-request tokens, engine cycles
and the whole SLA summary (TTFT, TPOT, e2e, queue wait, queue depth)
equal to the JAX engine's, through the overlapped front-end and through
the synchronous baseline. float32, tiny shapes.
"""
import functools

import jax
import numpy as np
import pytest
from conftest import tiny_drafter, tiny_target

from _torch_parity import port_bundle, port_greedy
from repro.config.base import SpecConfig as JSpec
from repro.core import pipeline as jpl
from repro.core.drafter import drafter_init as jdrafter_init
from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro.serving import frontend as jfe
from repro.serving import metrics as jmet
from repro.serving import traffic as jtraffic
from repro_torch.core import state as cs
from repro_torch.models import kvcache as kvc
from repro_torch.serving import engine as teng
from repro_torch.serving.frontend import ReplayDriver
from repro_torch.serving.metrics import (MetricsRecorder, VirtualClock,
                                         percentile, summarize)
from repro_torch.serving.traffic import (Arrival, bursty_trace, make_trace,
                                         poisson_trace)

GAMMA = 6
VOCAB = 61

# the port's engine on the CPU, called as the JAX suite calls its own
ServingEngine = functools.partial(teng.ServingEngine, device="cpu")


@functools.lru_cache(maxsize=None)
def _bundles():
    tcfg = tiny_target(vocab=VOCAB, dtype="float32")
    dcfg = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    jb = jpl.SpecBundle(tcfg, dcfg, dcfg,
                        JSpec(gamma=GAMMA, top_k_branches=2, mode="d2sd"),
                        jlm.lm_init(jax.random.PRNGKey(0), tcfg),
                        jdrafter_init(jax.random.PRNGKey(1), dcfg),
                        jdrafter_init(jax.random.PRNGKey(2), dcfg))
    return jb, port_bundle(jb)


@pytest.fixture(scope="module")
def bundle():
    return _bundles()[1]


def _ref(bundle, prompt, n):
    return port_greedy(bundle, prompt, n)


def _engine(bundle, batch=3, install_s=0.25, **kw):
    clock = VirtualClock(cycle_s=1.0, install_s=install_s)
    rec = MetricsRecorder(clock)
    return ServingEngine(bundle, batch_size=batch, seed=0,
                         cache_impl="paged", page_size=8, pool_pages=64,
                         bucket_sizes=(8, 16), clock=clock,
                         recorder=rec, **kw)


def _jax_engine(batch=3, install_s=0.25):
    """The JAX twin of :func:`_engine` on the same weights."""
    clock = jmet.VirtualClock(cycle_s=1.0, install_s=install_s)
    return jeng.ServingEngine(_bundles()[0], batch_size=batch, seed=0,
                              cache_impl="paged", page_size=8, pool_pages=64,
                              bucket_sizes=(8, 16), clock=clock,
                              recorder=jmet.MetricsRecorder(clock))


def _outs(eng):
    return {r.uid: r.out.tolist() for r in eng.done}


# ------------------------------------------------------ metrics: exact -----
def test_percentile_nearest_rank_exact():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 90) == 5.0
    assert percentile(xs, 99) == 5.0
    assert percentile(xs, 1) == 1.0
    assert percentile([7.0], 99) == 7.0
    s = summarize(xs)
    assert (s["p50"], s["max"], s["mean"]) == (3.0, 5.0, 3.0)
    empty = summarize([])
    assert empty["p50"] == 0.0 and empty["p99"] == 0.0


def test_ttft_tpot_exact_on_hand_schedule():
    """Recorder arithmetic on a hand-driven event sequence."""
    clock = VirtualClock(cycle_s=1.0, install_s=0.25)
    rec = MetricsRecorder(clock)
    rec.on_arrival(0, t=2.0)            # client sent at t=2.0
    clock.advance(3.5)                  # scheduler picks it up at 3.5
    rec.on_admit(0)
    rec.on_first_token(0)               # prefill anchor at admission
    clock.advance(6.5)                  # decode until t=10.0
    rec.on_done(0, n_tokens=5)
    (r,) = rec.completed()
    assert r.ttft == 1.5                # 3.5 - 2.0
    assert r.queue_wait == 1.5
    assert r.tpot == 6.5 / 4            # (10.0 - 3.5) / (5 - 1)
    assert r.e2e == 8.0                 # 10.0 - 2.0
    # single-token request: TPOT degenerates to 0, never divides by zero
    rec.on_arrival(1, t=10.0)
    rec.on_admit(1)
    rec.on_first_token(1)
    rec.on_done(1, n_tokens=1)
    assert rec.requests[1].tpot == 0.0
    summ = rec.summary()
    assert summ["n_requests"] == 2
    assert summ["ttft"]["max"] == 1.5


def test_virtual_clock_charges_costs():
    clock = VirtualClock(cycle_s=1.0, install_s=0.25)
    assert clock.now() == 0.0
    clock.tick("cycle")
    clock.tick("install", 2)
    assert clock.now() == 1.5
    clock.wait_until(5.0)
    assert clock.now() == 5.0
    clock.wait_until(1.0)               # never goes backwards
    assert clock.now() == 5.0


# ----------------------------------------------------------- traffic -------
def test_traffic_deterministic_and_bounded():
    kw = dict(rate=2.0, duration=10.0, seed=4, prompt_lens=(6, 9),
              max_new=(3, 12), vocab=VOCAB)
    a = poisson_trace(**kw)
    b = poisson_trace(**kw)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.t == y.t and x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)
    assert all(0 < x.t < 10.0 for x in a)
    assert all(x.t <= y.t for x, y in zip(a, a[1:]))
    assert {x.max_new for x in a} <= {3, 12}
    assert all(x.prompt.min() >= 0 and x.prompt.max() < VOCAB for x in a)
    c = poisson_trace(**{**kw, "seed": 5})
    assert [x.t for x in c] != [x.t for x in a]
    d = bursty_trace(**kw)
    assert [x.t for x in d] != [x.t for x in a]    # different process
    assert make_trace("bursty", 2.0, 10.0, seed=4, prompt_lens=(6, 9),
                      max_new=(3, 12), vocab=VOCAB)[0].t == d[0].t
    with pytest.raises(ValueError):
        make_trace("lumpy", 1.0, 1.0)


def test_traffic_equals_jax_traffic():
    """A seed gives the JAX module's trace: the same times, budgets and
    prompts, for both arrival processes and the native vocabulary."""
    for kind in ("poisson", "bursty"):
        for vocab in (VOCAB, None):
            kw = dict(seed=6, prompt_lens=(6, 9, 31), max_new=(3, 12),
                      vocab=vocab)
            got = make_trace(kind, 1.5, 12.0, **kw)
            want = jtraffic.make_trace(kind, 1.5, 12.0, **kw)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert (a.t, a.max_new) == (b.t, b.max_new)
                np.testing.assert_array_equal(a.prompt, b.prompt)


# ------------------------------------------- replay: token identity --------
def test_replay_token_identity_and_sla(bundle):
    """Overlapped and sync replays of a seeded poisson trace produce
    identical per-request tokens, equal to standalone greedy decoding;
    the SLA summary is emitted and internally consistent."""
    trace = poisson_trace(rate=0.7, duration=10.0, seed=1,
                          prompt_lens=(6, 9), max_new=(3, 7), vocab=VOCAB)
    assert len(trace) >= 3
    eng_o = _engine(bundle)
    st_o = ReplayDriver(eng_o, trace, overlap=True).run()
    eng_s = _engine(bundle)
    st_s = ReplayDriver(eng_s, trace, overlap=False).run()
    assert _outs(eng_o) == _outs(eng_s)
    assert len(eng_o.done) == len(trace)
    by_uid = {r.uid: r for r in eng_o.done}
    for uid, a in enumerate(trace):     # submit order == trace order
        assert np.array_equal(by_uid[uid].out,
                              _ref(bundle, a.prompt, a.max_new)), uid
    for st in (st_o, st_s):
        sla = st["sla"]
        assert sla["n_requests"] == len(trace)
        assert sla["ttft"]["p50"] > 0.0
        assert sla["ttft"]["p50"] <= sla["ttft"]["p90"] <= sla["ttft"]["p99"]
        assert sla["e2e"]["max"] >= sla["ttft"]["max"]
    # overlap may not win on light poisson load, but it must never lose
    assert st_o["engine_cycles"] <= st_s["engine_cycles"]
    # the JAX front-end on the same trace: tokens, cycles and SLA equal
    jtrace = jtraffic.poisson_trace(rate=0.7, duration=10.0, seed=1,
                                    prompt_lens=(6, 9), max_new=(3, 7),
                                    vocab=VOCAB)
    for overlap, eng, st in ((True, eng_o, st_o), (False, eng_s, st_s)):
        jeng_ = _jax_engine()
        jst = jfe.ReplayDriver(jeng_, jtrace, overlap=overlap).run()
        assert _outs(jeng_) == _outs(eng)
        assert set(jst) == set(st)
        for k in jst:
            if k not in ("wall_s", "warm_cycle_s", "sla"):
                assert st[k] == pytest.approx(jst[k], rel=1e-9), (k, overlap)
        assert jst["sla"] == st["sla"], overlap
        assert jeng_.recorder.queue_depth == eng.recorder.queue_depth


# --------------------------------------------- replay: structural win ------
def test_overlap_fewer_cycles_on_hand_built_burst(bundle):
    """The canonical overlap scenario, hand-built (no randomness): a
    long request anchors the wave, its co-admitted shorts retire into a
    momentarily empty queue, then a burst lands mid-wave. The sync
    baseline admits the burst only at the long request's retire (slots
    idle until the wave drains); the overlapped front-end admits it one
    cycle later — strictly fewer engine cycles, identical tokens."""
    rng = np.random.default_rng(0)

    def arr(t, plen, max_new):
        return Arrival(t=t, prompt=rng.integers(
            3, VOCAB, size=plen).astype(np.int32), max_new=max_new)

    trace = [arr(0.4, 8, 30), arr(0.45, 8, 2), arr(0.5, 8, 2),
             # burst lands while only the long request is still running
             arr(4.4, 8, 2), arr(4.5, 8, 2), arr(4.6, 8, 3)]
    rng2 = np.random.default_rng(0)     # identical prompts for both runs
    trace2 = [Arrival(t=a.t, prompt=rng2.integers(
        3, VOCAB, size=8).astype(np.int32), max_new=a.max_new)
        for a in trace]
    eng_o = _engine(bundle)
    st_o = ReplayDriver(eng_o, trace, overlap=True).run()
    eng_s = _engine(bundle)
    st_s = ReplayDriver(eng_s, trace2, overlap=False).run()
    assert _outs(eng_o) == _outs(eng_s)
    assert st_o["engine_cycles"] < st_s["engine_cycles"], (
        st_o["engine_cycles"], st_s["engine_cycles"])
    # the overlapped run re-used the long request's wave for the burst
    assert st_o["refills"] >= 3


@pytest.mark.slow
def test_overlap_fewer_cycles_on_seeded_bursty(bundle):
    """Randomized end-to-end version of the structural win (slow: long
    MMPP replay through both drivers)."""
    trace = bursty_trace(rate=1.0, duration=20.0, seed=3, calm_scale=0.3,
                         burst_scale=5.0, mean_dwell=5.0, prompt_lens=(8,),
                         max_new=(4, 28), vocab=VOCAB)
    eng_o = _engine(bundle, batch=4)
    st_o = ReplayDriver(eng_o, trace, overlap=True).run()
    eng_s = _engine(bundle, batch=4)
    st_s = ReplayDriver(eng_s, trace, overlap=False).run()
    assert _outs(eng_o) == _outs(eng_s)
    assert st_o["engine_cycles"] < st_s["engine_cycles"], (
        st_o["engine_cycles"], st_s["engine_cycles"])


# -------------------------------------------------- queue-depth timeline ---
def test_queue_depth_matches_reference_simulator(bundle):
    """The sampled queue-depth timeline equals an independent
    event-count reconstruction: depth(t) = #arrivals<=t - #admits<t.

    The driver samples at the pump instant, BEFORE that iteration's
    admissions — every due arrival is already in the queue and every
    admission stamped at or after the sample time has not popped it yet,
    so the equality is exact at every sample (strict inequality on the
    admit side).
    """
    trace = poisson_trace(rate=0.5, duration=12.0, seed=2,
                          prompt_lens=(6,), max_new=(3, 4), vocab=VOCAB)
    eng = _engine(bundle)
    ReplayDriver(eng, trace, overlap=True).run()
    rec = eng.recorder
    assert rec.queue_depth, "no queue-depth samples recorded"
    assert any(d > 0 for _, d in rec.queue_depth), "trace never queued"
    arrivals = sorted(a.t for a in trace)
    admits = sorted(r.t_admit for r in rec.requests.values()
                    if r.t_admit is not None)
    for t, depth in rec.queue_depth:
        ref = (sum(1 for x in arrivals if x <= t)
               - sum(1 for x in admits if x < t))
        assert depth == ref, (t, depth, ref)


# ----------------------------------------------------- batched installs ----
def test_batched_install_collapses_same_bucket_group(bundle):
    """Same-length-bucket co-admissions dispatch ONE batched install_rows
    call; per-request tokens equal standalone greedy decoding."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, VOCAB, size=7).astype(np.int32)
               for _ in range(3)]
    eng = _engine(bundle, batch=3)
    for p in prompts:
        eng.submit(p, max_new=4)
    eng.start_wave()
    while eng.wave is not None:
        eng.step()
    assert eng.stats["installs"] == 3
    assert eng.stats["install_calls"] == 1      # one batch-3 dispatch
    for r in eng.done:
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid], 4)), r.uid


def test_batched_install_matches_singles_path(bundle):
    """The batched install path is token-identical to the per-request
    fallback (bucketing off forces exact-length single installs)."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, VOCAB, size=n).astype(np.int32)
               for n in (6, 7, 9)]    # distinct lengths: one shared
    #                                   bucket batches, exact-length
    #                                   installs cannot

    def serve(bucket_sizes):
        clock = VirtualClock()
        eng = ServingEngine(bundle, batch_size=3, seed=0,
                            cache_impl="paged", page_size=8,
                            pool_pages=64, bucket_sizes=bucket_sizes,
                            clock=clock, recorder=MetricsRecorder(clock))
        for p in prompts:
            eng.submit(p, max_new=5)
        eng.run()
        return eng

    batched = serve((16,))
    singles = serve(None)
    assert _outs(batched) == _outs(singles)
    assert batched.stats["install_calls"] == 1
    assert singles.stats["install_calls"] == 3


# ------------------------------------------- sentinel + retained pools -----
def test_page_sentinel_is_growth_stable():
    """The unallocated-page marker is a constant, not n_pages: growing
    the pool can never make an old sentinel alias a real page."""
    assert kvc.PAGE_SENTINEL == np.iinfo(np.int32).max
    pool = kvc.PagePool(8, 4)
    pages = pool.alloc(2)
    t = pool.row_table(pages, 5)
    assert list(t[:2]) == pages
    assert (t[2:] == kvc.PAGE_SENTINEL).all()
    # any conceivable pool growth stays below the sentinel
    assert kvc.PAGE_SENTINEL > 10 ** 9


def test_engine_init_adopts_retained_pool_buffers(bundle):
    """engine_init(pools=...) must alias the captured device buffers —
    the borrowed-pool contract is zero-copy adoption, not a reload."""
    table = np.full((2, 4), kvc.PAGE_SENTINEL, np.int32)
    s0 = cs.engine_init(bundle, 2, 32, cache_impl="paged", page_size=8,
                        pool_pages=16, page_table=table, device="cpu")
    pools = cs.capture_pools(s0)
    assert pools, "paged state captured no pool buffers"
    s1 = cs.engine_init(bundle, 2, 32, cache_impl="paged", page_size=8,
                        pool_pages=16, page_table=table, device="cpu",
                        pools=pools)
    adopted = cs.capture_pools(s1)
    assert set(adopted) == set(pools)
    for name, (k, v) in pools.items():
        k2, v2 = adopted[name]
        assert k2 is k and v2 is v, f"{name} was copied, not adopted"


def test_start_wave_width_builds_idle_rows(bundle):
    """Open-loop waves reserve idle rows for mid-flight admission: one
    visible request still yields a full-width wave, and the idle rows
    are claimable by admit_idle."""
    eng = _engine(bundle, batch=3)
    rng = np.random.default_rng(9)
    eng.submit(rng.integers(3, VOCAB, size=6).astype(np.int32), max_new=8)
    eng.start_wave(width=eng.batch_size)
    w = eng.wave
    assert len(w.requests) == 3
    assert sum(1 for r in w.requests if r is not None) == 1
    eng.submit(rng.integers(3, VOCAB, size=6).astype(np.int32), max_new=3)
    handle = eng.dispatch_cycle()
    assert eng.admit_idle() == 1        # idle row claimed mid-flight
    eng.complete_cycle(handle)
    while eng.wave is not None:
        eng.step()
    assert len(eng.done) == 2

"""The port's ``ServingEngine`` (``repro_torch.serving.engine``) held to
the JAX engine, and the JAX serving suites (``test_serving.py``,
``test_paged.py``'s serving cases) mirrored on the port's engine.

Engine parity: one queue of mixed prompt lengths and ``max_new`` budgets
through six configurations (legacy waves; dense refill; paged with
per-wave pools; paged with the engine-lifetime pool; that pool with the
prefix cache on multi-turn prompts that hit generated tokens; paged with
a local/global hybrid target) gives per-request tokens and the whole
stats dict equal to the JAX engine's: integers exactly, floats to 1e-9
relative, timing keys left out. Each JAX run is made once per module.
The state-replay cases of the JAX suites (recurrent targets) belong to a
later slice. float32, tiny shapes, prompts from a numpy seed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_drafter, tiny_target

from _torch_parity import clone_state, port_bundle, port_greedy
from repro.config.base import SpecConfig as JSpec
from repro.core import pipeline as jpl
from repro.core.drafter import drafter_init as jdrafter_init
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.core import pipeline as tpl
from repro_torch.core import state as tcs
from repro_torch.serving.engine import ServingEngine

GAMMA, VOCAB, PAGE = 6, 61, 8
TIMING = ("wall_s", "warm_cycle_s", "tokens_per_s")


@functools.lru_cache(maxsize=None)
def _bundles(hybrid=False, gamma=GAMMA):
    extra = (dict(layer_pattern=("local", "global"), sliding_window=16)
             if hybrid else {})
    tcfg = tiny_target(vocab=VOCAB, dtype="float32", **extra)
    dcfg = tiny_drafter(vocab=VOCAB, gamma=gamma, dtype="float32",
                        target_cfg=tcfg)
    jb = jpl.SpecBundle(tcfg, dcfg, dcfg,
                        JSpec(gamma=gamma, top_k_branches=2, mode="d2sd"),
                        jlm.lm_init(jax.random.PRNGKey(0), tcfg),
                        jdrafter_init(jax.random.PRNGKey(1), dcfg),
                        jdrafter_init(jax.random.PRNGKey(2), dcfg))
    return jb, port_bundle(jb)


@pytest.fixture(scope="module")
def bundle():
    return _bundles()[1]


def _ref(bundle, prompt, n):
    return port_greedy(bundle, prompt, n)


def _mixed_requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    plens = (8, 11, 8, 9, 10)
    wants = (6, 14, 9, 5, 11)
    return [rng.integers(0, vocab, size=p).astype(np.int32)
            for p in plens], wants


def _multiturn_requests():
    """Turn 1: three prompts behind a shared 13-token system prompt;
    turn 2: two of them again with their greedy answers and 3 new tokens,
    so the prefix cache hits into the generated region."""
    _, tb = _bundles()
    rng = np.random.default_rng(11)
    sysp = rng.integers(0, VOCAB, 13).astype(np.int32)
    t1 = [(np.concatenate([sysp, rng.integers(0, VOCAB, 4 + i)]).astype(
        np.int32), 5) for i in range(3)]
    t2 = [(np.concatenate([p, port_greedy(tb, p, n).astype(np.int32),
                           rng.integers(0, VOCAB, 3)]).astype(np.int32), 4)
          for p, n in t1[:2]]
    return t1 + t2


CONFIGS = {
    "legacy": dict(early_exit=False, refill=False),
    "dense_refill": dict(),
    "paged_wave": dict(cache_impl="paged", page_size=PAGE,
                       pool_scope="wave"),
    "paged_engine": dict(cache_impl="paged", page_size=PAGE),
    "prefix_multiturn": dict(cache_impl="paged", page_size=PAGE,
                             prefix_cache=True),
    "paged_hybrid": dict(cache_impl="paged", page_size=PAGE),
}


def _requests(name):
    if name == "prefix_multiturn":
        return _multiturn_requests()
    prompts, wants = _mixed_requests(VOCAB)
    return list(zip(prompts, wants))


def _serve(engine_cls, bundle, reqs, **kw):
    eng = engine_cls(bundle, batch_size=2, **kw)
    for p, n in reqs:
        eng.submit(p, max_new=n)
    return eng, eng.run()


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(per-request tokens, stats) of the JAX engine on config ``name``."""
    jb, _ = _bundles(hybrid=name == "paged_hybrid")
    eng, stats = _serve(JEngine, jb, _requests(name), **CONFIGS[name])
    return {r.uid: r.out.tolist() for r in eng.done}, stats


def _outs(eng):
    return {r.uid: r.out.tolist() for r in eng.done}


def assert_stats_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k in TIMING:
            continue
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-12), k
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_jax_engine(name):
    want_out, want_stats = _jax_run(name)
    _, tb = _bundles(hybrid=name == "paged_hybrid")
    impl = "kernel" if name in ("paged_engine", "prefix_multiturn") \
        else "gather"
    eng, stats = _serve(ServingEngine, tpl.with_attn_impl(tb, impl),
                        _requests(name), device="cpu", **CONFIGS[name])
    assert _outs(eng) == want_out
    assert_stats_equal(stats, want_stats)
    if name == "prefix_multiturn":
        assert stats["prefix_hits"] >= 3 and stats["cow_copies"] > 0
        t1 = _requests(name)[:2]
        assert stats["prefix_hit_tokens"] >= sum(len(p) + n - 1
                                                 for p, n in t1)
    if eng.pool is not None:
        eng.pool.sanity_check()
    for r in eng.done:
        p, n = _requests(name)[r.uid]
        np.testing.assert_array_equal(r.out, _ref(tb, p, n))


def test_engine_refuses_recurrent_targets():
    """A target with recurrent blocks needs the state-replay verifier,
    which is not ported: building an engine on it raises, naming the
    slice."""
    _, tb = _bundles()
    cfg = dataclasses.replace(tb.target_cfg,
                              layer_pattern=("recurrent", "global"))
    bad = tpl.SpecBundle(cfg, tb.d1_cfg, tb.d2_cfg, tb.spec, None, None,
                         None)
    with pytest.raises(NotImplementedError, match="slice C"):
        ServingEngine(bad, device="cpu")


# ------------------------------------------ test_serving.py, mirrored -------
def test_mixed_budget_refill_parity_vs_generate(bundle):
    prompts, wants = _mixed_requests(VOCAB)
    eng, stats = _serve(ServingEngine, bundle, list(zip(prompts, wants)),
                        device="cpu")
    assert stats["waves"] == 1
    assert stats["refills"] == len(prompts) - 2
    assert len(eng.done) == len(prompts)
    for r in sorted(eng.done, key=lambda r: r.uid):
        assert r.out.shape == (r.max_new,)
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid],
                                          r.max_new)), r.uid
    g = tpl.generate(bundle, prompts[0][None], wants[0], device="cpu")
    assert np.array_equal(g["tokens"][0],
                          sorted(eng.done, key=lambda r: r.uid)[0].out)


def test_refill_preserves_other_rows(bundle):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=8).astype(np.int32)
               for _ in range(3)]
    eng, stats = _serve(ServingEngine, bundle,
                        list(zip(prompts, [18, 4, 4])), device="cpu")
    assert stats["waves"] == 1 and stats["refills"] == 1
    for r in eng.done:
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid],
                                          r.max_new)), r.uid


def test_early_exit_and_refill_reduce_wasted_row_cycles(bundle):
    rng = np.random.default_rng(1)
    wants = [20, 4, 4, 4, 4, 4]
    prompts = [rng.integers(0, VOCAB, size=p).astype(np.int32)
               for p in (10, 8, 9, 8, 11, 8)]
    reqs = list(zip(prompts, wants))
    eng_new, s_new = _serve(ServingEngine, bundle, reqs, device="cpu")
    eng_old, s_old = _serve(ServingEngine, bundle, reqs, device="cpu",
                            early_exit=False, refill=False)
    by_uid = lambda e: sorted(e.done, key=lambda r: r.uid)  # noqa: E731
    for a, b in zip(by_uid(eng_new), by_uid(eng_old)):
        assert np.array_equal(a.out, b.out), a.uid
    assert s_new["tokens"] == s_old["tokens"]
    assert s_new["wasted_row_cycles"] < s_old["wasted_row_cycles"]
    assert s_new["cycles"] < s_old["cycles"]


def _recording(eng):
    log = []
    orig = eng._cycle

    def cycle(s, gen):
        s2, out = orig(s, gen)
        log.append((s.active.numpy().copy(), out["n_out"].numpy().copy()))
        return s2, out

    eng._cycle = cycle
    return log


def test_alpha_and_token_stats_match_hand_computed(bundle):
    prompts, wants = _mixed_requests(VOCAB, seed=2)
    eng = ServingEngine(bundle, batch_size=2, device="cpu")
    log = _recording(eng)
    for p, n in zip(prompts, wants):
        eng.submit(p, max_new=n)
    stats = eng.run()
    num = sum(int(n_out[act].sum()) for act, n_out in log)
    den = sum(int(act.sum()) for act, _ in log)
    assert den < sum(len(a) for a, _ in log)
    assert stats["alpha"] == pytest.approx(num / den)
    assert stats["tokens"] == sum(wants)
    assert num == sum(int(n_out.sum()) for _, n_out in log)


def test_finished_rows_commit_nothing(bundle):
    rng = np.random.default_rng(5)
    eng = ServingEngine(bundle, batch_size=2, refill=False, device="cpu")
    eng.submit(rng.integers(0, VOCAB, size=8).astype(np.int32), max_new=4)
    eng.submit(rng.integers(0, VOCAB, size=8).astype(np.int32), max_new=20)
    seen = _recording(eng)
    eng.run()
    masked = [(a, n) for a, n in seen if not a.all()]
    assert masked, "short request never went inactive"
    for act, n_out in masked:
        assert (n_out[~act] == 0).all()


def test_max_new_one_burst_needs_no_decode_cycles(bundle):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, size=8).astype(np.int32)
               for _ in range(4)]
    eng, stats = _serve(ServingEngine, bundle, [(p, 1) for p in prompts],
                        device="cpu")
    assert len(eng.done) == 4
    assert stats["cycles"] == 0 and stats["wasted_row_cycles"] == 0
    assert stats["tokens"] == 4
    for r in eng.done:
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid], 1)), r.uid


def test_fifo_no_starvation_by_prompt_length(bundle):
    rng = np.random.default_rng(7)
    eng = ServingEngine(bundle, batch_size=1, device="cpu")
    long_uid = eng.submit(rng.integers(0, VOCAB, size=16).astype(np.int32),
                          max_new=4)
    for _ in range(3):
        eng.submit(rng.integers(0, VOCAB, size=6).astype(np.int32),
                   max_new=4)
    eng.run()
    assert eng.done[0].uid == long_uid
    assert [r.uid for r in eng.done] == sorted(r.uid for r in eng.done)


def test_ondevice_early_exit_freezes_finished_rows(bundle):
    prompts = np.random.default_rng(4).integers(0, VOCAB, (3, 8))
    host = tpl.generate(bundle, prompts, 16, collect_stats=False,
                        device="cpu")
    dev = tpl.generate_ondevice(bundle, prompts, 16, device="cpu")
    assert np.array_equal(host["tokens"], dev["tokens"])
    assert host["n_cycles"] == dev["n_cycles"]
    assert host["alpha"] == pytest.approx(dev["alpha"])


def test_install_adopts_without_touching_neighbors(bundle):
    rng = np.random.default_rng(3)
    st2 = tcs.engine_init(bundle, 3, 64, device="cpu")
    st2 = tcs.prefill(bundle, st2, torch.as_tensor(
        rng.integers(0, VOCAB, (3, 8))).long())
    state = clone_state(st2)
    newp = rng.integers(0, VOCAB, 12)
    tcs.install_rows(bundle, st2, [1], newp[None])
    assert int(st2.length[1]) == 12
    assert [int(st2.length[i]) for i in (0, 2)] == \
        [int(state.length[i]) for i in (0, 2)]
    assert torch.equal(st2.anchor[[0, 2]], state.anchor[[0, 2]])
    assert int(st2.anchor[1]) == int(_ref(bundle, newp, 1)[0])
    for feat, old in ((st2.d1_feat, state.d1_feat),
                      (st2.d2_feat, state.d2_feat)):
        assert torch.equal(feat["k"][:, 0], old["k"][:, 0])
        assert not torch.equal(feat["k"][:, 1], old["k"][:, 1])


# ---------------------------------- test_paged.py's serving cases, mirrored -
def test_serving_paged_token_parity_and_page_accounting(bundle):
    prompts, wants = _mixed_requests(VOCAB)
    reqs = list(zip(prompts, wants))
    ed, sd = _serve(ServingEngine, bundle, reqs, device="cpu")
    ep, sp = _serve(ServingEngine, bundle, reqs, device="cpu",
                    cache_impl="paged", page_size=PAGE)
    assert _outs(ed) == _outs(ep)
    assert sp["refills"] == sd["refills"] and sp["refills"] > 0
    assert sp["pool_pages"] > 0
    assert 0 < sp["pool_peak_pages"] <= sp["pool_pages"]
    assert 0.0 < sp["pool_utilization"] <= 1.0
    assert sp["installs"] == sd["installs"]
    assert sp["refill_copy_bytes"] * 3 < sd["refill_copy_bytes"]
    for r in ep.done:
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid],
                                          r.max_new)), r.uid


def test_serving_paged_requires_early_exit(bundle):
    with pytest.raises(ValueError, match="early_exit"):
        ServingEngine(bundle, cache_impl="paged", early_exit=False,
                      device="cpu")


def test_serving_paged_prefill_burst_pool_pressure(bundle):
    rng = np.random.default_rng(7)
    mk = lambda n: rng.integers(0, VOCAB, size=n).astype(np.int32)  # noqa
    reqs = [(mk(6), 1), (mk(10), 12), (mk(6), 1), (mk(6), 1), (mk(12), 10),
            (mk(6), 4)]
    eng, stats = _serve(ServingEngine, bundle, reqs, device="cpu",
                        cache_impl="paged", page_size=PAGE)
    assert len(eng.done) == len(reqs)
    for r in eng.done:
        assert np.array_equal(r.out, _ref(bundle, reqs[r.uid][0],
                                          r.max_new)), r.uid
    assert stats["pool_peak_pages"] <= stats["pool_pages"]
    eng.pool.sanity_check()


def test_serving_paged_pool_reuse_across_retires(bundle):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, size=8).astype(np.int32)
               for _ in range(6)]
    ep, sp = _serve(ServingEngine, bundle, [(p, 4) for p in prompts],
                    device="cpu", cache_impl="paged", page_size=PAGE)
    assert len(ep.done) == 6 and sp["waves"] == 1
    need = -(-(8 + 4 + 2 * GAMMA + 8) // PAGE)
    assert sp["pool_peak_pages"] <= 2 * need
    for r in ep.done:
        assert np.array_equal(r.out, _ref(bundle, prompts[r.uid],
                                          r.max_new)), r.uid


def test_paged_local_global_hybrid_generate():
    """Local layers keep dense rolling buffers while global layers page:
    generate is token-exact on both caches, against JAX's tokens."""
    jb, tb = _bundles(hybrid=True, gamma=4)
    prompts = np.random.default_rng(3).integers(0, VOCAB, (2, 8))
    want = jpl.generate(jb, jnp.asarray(prompts), max_new=10,
                        key=jax.random.PRNGKey(9), collect_stats=False)
    for cache_impl in ("dense", "paged"):
        got = tpl.generate(tb, prompts, 10, collect_stats=False,
                           cache_impl=cache_impl, page_size=PAGE,
                           device="cpu")
        np.testing.assert_array_equal(got["tokens"],
                                      np.asarray(want["tokens"]))
        assert got["n_cycles"] == want["n_cycles"]


@pytest.mark.parametrize("traffic", [False, True])
def test_launch_serve_on_the_cpu(traffic, capsys):
    """``launch/serve.py`` on the smoke target, paged with the prefix
    cache, as a fixed batch and as an open-loop trace."""
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--requests", "2", "--max-new", "6",
            "--cache-impl", "paged", "--page-size", "16", "--prefix-cache",
            "--attn-impl", "kernel"]
    if traffic:
        argv += ["--traffic", "poisson", "--rate", "2", "--duration", "2",
                 "--virtual-clock"]
    stats = serve.main(argv)
    assert stats["tokens"] > 0 and stats["pool_pages"] > 0
    assert "served" in capsys.readouterr().out

"""The port's state-replay verifier (recurrent and hybrid targets) held to
the JAX package, and the small twins of slice A.

* ``select_backend`` picks the verifier by the target's blocks (the
  mirror of ``tests/test_engine_api.py::test_backend_selection_by_capability``);
* ``_paths_to_leaves`` equals JAX's on chain, comb and third-level trees;
* ``generate`` and ``generate_ondevice`` give JAX ``generate``'s greedy
  tokens and cycles, which are plain greedy decoding's, for an RWKV
  target and a recurrent + local hybrid, on dense and paged caches,
  through both read paths (``kernel``: the cascade kernels' plain
  versions on CPU tensors), and plain greedy in every draft mode (the
  mirror of ``tests/test_lossless.py::test_greedy_exact_ssm_target``);
* with the oracle's drafts of ``chip_smoke.py`` cycles accept into the
  comb's branches and every cache and recurrent state the replays
  committed equals a plain prefill of the same tokens;
* the hybrid recurrent + global paged case and the rwkv paged case (the
  mirrors of ``tests/test_paged.py``'s state-replay cases);
* one step of the on-device loop makes no host sync for either family;
* the serving smoke (the mirror of
  ``tests/test_serving.py::test_serving_state_replay_backend_smoke``):
  per-request tokens and the whole stats dict equal the JAX engine's;
* the reference quirk the port mirrors: a recurrent target's sampled
  output is its greedy output;
* slice A: ``core/adaptive.py`` (the mirror of ``tests/test_adaptive.py``),
  ``layers.layernorm``, ``attend_dense(sinks=)``,
  ``confidence.select_branches`` and ``chain_prefix_accept_greedy``.

float32, tiny shapes, inputs from numpy seeds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import pure_greedy, tiny_drafter, tiny_target

from _torch_parity import (close, jax_drafter_init, jax_lm_init,
                           port_bundle, port_greedy, t)
from repro.config.base import SpecConfig as JSpec
from repro.core import adaptive as jad
from repro.core import confidence as jconf
from repro.core import pipeline as jpl
from repro.core import tree as jtree
from repro.core import verify as jver
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.core import adaptive as tad
from repro_torch.core import confidence as tconf
from repro_torch.core import pipeline as tpl
from repro_torch.core import tree as ttree
from repro_torch.core import verify as tver
from repro_torch.core.state import engine_init, prefill
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.serving.engine import ServingEngine
from test_torch_ondevice import _NoHostSync
from test_torch_pipeline import _chip_smoke
from test_torch_serving import assert_stats_equal

VOCAB, GAMMA, K, MAX_NEW = 61, 6, 2, 14
FAMILIES = {
    "rwkv": dict(layer_pattern=("rwkv",), rwkv_head_dim=16, num_layers=4),
    "hybrid": dict(layer_pattern=("recurrent", "recurrent", "local"),
                   sliding_window=8, num_layers=5),
    "hybrid_global": dict(layer_pattern=("recurrent", "global")),
}


@functools.lru_cache(maxsize=None)
def _base(family):
    """(JAX bundle, port bundle) of a tiny recurrent target and its two
    drafters in d2sd; every other mode reuses their weights."""
    tcfg = tiny_target(vocab=VOCAB, dtype="float32", **FAMILIES[family])
    dcfg = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    jb = jpl.SpecBundle(tcfg, dcfg, dcfg,
                        JSpec(gamma=GAMMA, top_k_branches=K, mode="d2sd"),
                        jax_lm_init(jax.random.PRNGKey(0), tcfg),
                        jax_drafter_init(jax.random.PRNGKey(1), dcfg),
                        jax_drafter_init(jax.random.PRNGKey(2), dcfg))
    return jb, port_bundle(jb)


@functools.lru_cache(maxsize=None)
def _bundles(family, mode="d2sd", third=False, temperature=0.0):
    """The bundles of :func:`_base` wired for ``mode`` as
    ``tests/test_lossless.py`` wires it: a causal drafter for ``eagle``,
    drafter 1's params as drafter 2 for ``dflash_second``."""
    jb, tb = _base(family)
    pick = lambda b: dataclasses.replace(  # noqa: E731
        b, d1_cfg=dataclasses.replace(b.d1_cfg, causal=mode == "eagle"),
        spec=dataclasses.replace(b.spec, mode=mode, third_level=third,
                                 temperature=temperature),
        d2_params=b.d1_params if mode == "dflash_second" else b.d2_params)
    return pick(jb), pick(tb)


@functools.lru_cache(maxsize=None)
def _prompts():
    return np.random.default_rng(3).integers(0, VOCAB, (3, 8)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _greedy(family, n=MAX_NEW):
    jb, _ = _bundles(family)
    return np.asarray(jax.jit(pure_greedy, static_argnums=(1, 3))(
        jb.target_params, jb.target_cfg, jnp.asarray(_prompts()), n))


@functools.lru_cache(maxsize=None)
def _plain(family, n):
    """The port's plain greedy decoding of the prompts (``port_greedy``,
    held to JAX's by :func:`test_generate_matches_jax_and_greedy`)."""
    tb = _base(family)[1]
    return np.stack([port_greedy(tb, p, n) for p in _prompts()])


@functools.lru_cache(maxsize=None)
def _jax_generate(family):
    jb, _ = _bundles(family)
    out = jpl.generate(jb, jnp.asarray(_prompts()), max_new=MAX_NEW,
                       key=jax.random.PRNGKey(7))
    return np.asarray(out["tokens"]), int(out["n_cycles"])


def test_backend_selection_by_capability():
    for family in FAMILIES:
        jb, tb = _bundles(family)
        assert not tver.uses_tree_attention(tb.target_cfg)
        assert isinstance(tver.select_backend(tb.target_cfg),
                          tver.StateReplayVerifier)
        assert isinstance(jver.select_backend(jb.target_cfg),
                          jver.StateReplayVerifier)
    attn = tiny_target(dtype="float32")
    from _torch_parity import port_model_cfg
    assert isinstance(tver.select_backend(port_model_cfg(attn)),
                      tver.TreeAttentionVerifier)


# ------------------------------------------------------------- the rows ---
def _trees(kind, seed=0):
    rng = np.random.default_rng(seed)
    b, g, k = 4, GAMMA, 3
    anchor = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    trunk = rng.integers(0, VOCAB, (b, g - 1)).astype(np.int32)
    if kind == "chain":
        return (jtree.chain_tree(jnp.asarray(anchor), jnp.asarray(trunk)),
                ttree.chain_tree(t(anchor), t(trunk)))
    branch = rng.integers(0, VOCAB, (b, k, g - 1)).astype(np.int32)
    # forks at every depth, the last (a branch of one node) included
    fork = np.array([[0, 3, 4], [2, 1, 0], [4, 0, 2], [1, 1, 3]], np.int32)
    jt_ = jtree.comb_tree(jnp.asarray(anchor), jnp.asarray(trunk),
                          jnp.asarray(branch), jnp.asarray(fork), g)
    tt_ = ttree.comb_tree(t(anchor), t(trunk), t(branch), t(fork), g)
    if kind == "comb":
        return jt_, tt_
    b3 = rng.integers(0, VOCAB, (b, k, g - 1)).astype(np.int32)
    # third-level fork slots s >= i_b, s == i_b (a fork at the branch's
    # root) included
    f3 = np.minimum(fork + np.array([[0, 1, 0], [2, 0, 1], [1, 3, 0],
                                     [0, 2, 1]]), g - 1).astype(np.int32)
    return (jtree.extend_third_level(jt_, jnp.asarray(b3), jnp.asarray(fork),
                                     jnp.asarray(f3), g),
            ttree.extend_third_level(tt_, t(b3), t(fork), t(f3), g))


@pytest.mark.parametrize("kind", ["chain", "comb", "third_level"])
def test_paths_to_leaves_matches_jax(kind):
    jt_, tt_ = _trees(kind)
    want = np.asarray(jver._paths_to_leaves(jt_))
    got = tver._paths_to_leaves(tt_)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the loops ---
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_generate_matches_jax_and_greedy(family, cache_impl, impl):
    jtok, jcycles = _jax_generate(family)
    ref = _greedy(family)
    np.testing.assert_array_equal(jtok, ref)
    _, tb = _bundles(family)
    tb = tpl.with_attn_impl(tb, impl)
    kw = dict(cache_impl=cache_impl, page_size=8, device="cpu")
    host = tpl.generate(tb, _prompts(), MAX_NEW, **kw)
    np.testing.assert_array_equal(host["tokens"], ref)
    assert host["n_cycles"] == jcycles
    dev = tpl.generate_ondevice(tb, _prompts(), MAX_NEW, **kw)
    np.testing.assert_array_equal(dev["tokens"], ref)
    assert (dev["n_cycles"], dev["alpha"]) == (host["n_cycles"],
                                               host["alpha"])


MODES = [("dflash", False), ("naive_k", False), ("eagle", False),
         ("d2sd", True), ("dflash_second", False)]


@pytest.mark.parametrize("mode,third", MODES)
@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_every_mode_is_greedy(family, mode, third):
    """Every draft mode JAX's ``generate`` runs on a recurrent target gives
    plain greedy decoding (JAX's own tokens for these inputs: d2sd above,
    the rest by ``tests/test_lossless.py``'s rule), through both loops."""
    ref = _greedy(family)
    _, tb = _bundles(family, mode, third)
    for fn in (tpl.generate, tpl.generate_ondevice):
        out = fn(tb, _prompts(), MAX_NEW, device="cpu")
        np.testing.assert_array_equal(out["tokens"], ref)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_oracle_replay_commits_exact_states(family, cache_impl):
    """With the oracle's drafts (the greedy reference, spoiled from a depth
    that varies by row and cycle) cycles commit several tokens, some along
    a branch row: tokens equal greedy, alpha is what the drafts must give,
    and every KV cache, recurrent state and feature cache the replays
    committed equals a plain prefill of the same tokens. With the third
    level too: ``_paths_to_leaves`` counts the third level's K segments
    as branch segments, so its rows reach the third-level leaves and
    alpha is still exactly the oracle's."""
    ref = _plain(family, MAX_NEW + GAMMA)
    seq = t(np.concatenate([_prompts(), ref], 1)).long()
    cs = _chip_smoke()
    oracle = cs.register_oracle(seq)
    _, tb = _bundles(family)
    for third in (False, True):
        oracle.reset()
        bundle = tpl.SpecBundle(
            tb.target_cfg, tb.d1_cfg, tb.d2_cfg,
            tpl.SpecConfig(gamma=GAMMA, top_k_branches=K, mode="oracle",
                           third_level=third),
            tb.target_params, tb.d1_params, tb.d2_params)
        out = tpl.generate(bundle, _prompts(), MAX_NEW,
                           cache_impl=cache_impl, page_size=8, device="cpu")
        np.testing.assert_array_equal(out["tokens"], ref[:, :MAX_NEW])
        count = oracle.read()
        assert out["alpha"] == count["committed"] / count["row_cycles"]
        assert out["alpha"] > 2 and count["branch_paths"] > 0
        assert (count["third_paths"] > 0) == third
        if third:
            continue
        err = cs.committed_cache_error(
            bundle, t(_prompts()).long(), seq, cache_impl, max_new=MAX_NEW,
            page_size=8)
        assert err < 1e-5
        err = cs.committed_cache_error(
            bundle, t(_prompts()).long(), seq, cache_impl, max_new=MAX_NEW,
            page_size=8, ondevice=True)
        assert err < 1e-5


@pytest.mark.parametrize("family", ["hybrid_global", "rwkv"])
def test_paged_state_replay_parity(family):
    """The mirrors of ``tests/test_paged.py::
    test_paged_hybrid_recurrent_global_parity`` (the read pass repeats
    page-table rows and not the pools; the replay writes page-wise) and
    ``test_paged_state_replay_backend_parity`` (paged feature caches are
    an rwkv target's only paged leaves): paged tokens equal dense ones
    and plain greedy, through both read paths (JAX's equal greedy by its
    own tests)."""
    _, tb = _bundles(family)
    ref = _plain(family, 8)
    for impl in ("gather", "kernel"):
        b = tpl.with_attn_impl(tb, impl)
        for cache_impl in ("dense", "paged"):
            out = tpl.generate(b, _prompts(), 8, cache_impl=cache_impl,
                               page_size=4, collect_stats=False,
                               device="cpu")
            np.testing.assert_array_equal(out["tokens"], ref)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_ondevice_step_makes_no_host_sync(family, cache_impl, impl):
    """One step of the on-device loop over a recurrent target (the
    read-only pass over the folded rows, the replay, its in-place state
    writes, the feature caches and the token buffer) under the dispatch
    mode of ``tests/test_torch_ondevice.py`` that refuses what a CUDA graph
    cannot capture; the recurrent states the step writes are the loop's
    own tensors, changed in place."""
    _, tb = _bundles(family)
    bundle = tpl.with_attn_impl(tb, impl)
    gen = torch.Generator()
    state = prefill(bundle, engine_init(bundle, 3, 40, cache_impl=cache_impl,
                                        page_size=8, device="cpu"),
                    t(_prompts()).long(), gen)
    loop = tpl.OnDeviceLoop(bundle, state, MAX_NEW, gen)
    loop.step()
    rec = [(d, {k: v.clone() for k, v in d.items()})
           for kind, d in zip(bundle.target_cfg.pattern_for_depth(),
                              loop.state.target["layers"])
           if kind in ("recurrent", "rwkv")]
    ptrs = [{k: v.data_ptr() for k, v in d.items()} for d, _ in rec]
    before = loop.state.length.clone()
    with _NoHostSync():
        loop.step()
    assert (loop.state.length > before).all()
    for (d, old), ptr in zip(rec, ptrs):
        assert {k: v.data_ptr() for k, v in d.items()} == ptr
        assert any(not torch.equal(d[k], old[k]) for k in d)


# -------------------------------------------------------------- serving ---
def test_serving_state_replay_smoke():
    """The rwkv target through the port's ServingEngine (batch 2, three
    requests, dense refill): per-request tokens equal plain greedy and
    the JAX engine's, and the stats dicts are equal."""
    jb, tb = _bundles("rwkv")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=6).astype(np.int32)
               for _ in range(3)]
    wants = [4, 8, 6]

    def serve(cls, b, **kw):
        eng = cls(b, batch_size=2, **kw)
        for p, n in zip(prompts, wants):
            eng.submit(p, max_new=n)
        return eng, eng.run()

    jeng, jstats = serve(JEngine, jb)
    eng, stats = serve(ServingEngine, tb, device="cpu")
    assert len(eng.done) == 3
    outs = {r.uid: r.out.tolist() for r in eng.done}
    assert outs == {r.uid: r.out.tolist() for r in jeng.done}
    for r in eng.done:
        np.testing.assert_array_equal(
            r.out, port_greedy(tb, prompts[r.uid], r.max_new))
    assert_stats_equal(stats, jstats)


# --------------------------------------------------------------- quirks ---
def test_sampled_recurrent_target_is_greedy():
    """The state-replay verifier drops the draft distributions and the
    generator and accepts greedily at every temperature (JAX
    ``StateReplayVerifier``), so a recurrent target's output at
    temperature 1 is its greedy output, in JAX and in the port, whatever
    the seed (ROADMAP.md queue 3)."""
    ref = _greedy("rwkv")
    jb, tb = _bundles("rwkv", temperature=1.0)
    for seed in (0, 1):
        out = tpl.generate(tb, _prompts(), MAX_NEW, seed=seed, device="cpu")
        # the prefill's anchor is sampled; every later token is greedy
        # given the tokens before it
        first = out["tokens"][:, 0]
        g = tpl.generate(_bundles("rwkv")[1], np.concatenate(
            [_prompts(), first[:, None]], 1), MAX_NEW - 1, device="cpu")
        np.testing.assert_array_equal(out["tokens"][:, 1:], g["tokens"])
    jout = jpl.generate(jb, jnp.asarray(_prompts()), max_new=MAX_NEW,
                        key=jax.random.PRNGKey(7))
    jfirst = np.asarray(jout["tokens"])[:, :1]
    jg = jpl.generate(_bundles("rwkv")[0], jnp.asarray(np.concatenate(
        [_prompts(), jfirst], 1)), max_new=MAX_NEW - 1,
        key=jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(jout["tokens"])[:, 1:],
                                  np.asarray(jg["tokens"]))
    assert ref.shape == out["tokens"].shape


# ------------------------------------------------------- slice A twins ---
def test_concentrated_posterior_needs_one_branch():
    r = np.array([[0.9, 0.01, 0.01, 0.01, 0.01]], np.float32)
    assert int(tad.posterior_coverage_k(t(r), 0.85, 4)[0]) == 1
    assert int(jad.posterior_coverage_k(jnp.asarray(r), 0.85, 4)[0]) == 1


def test_diffuse_posterior_needs_many():
    r = np.ones((1, 8), np.float32) / 8
    assert int(tad.posterior_coverage_k(t(r), 0.85, 4)[0]) == 4


def test_skip_when_confident():
    conf = t(np.array([[0.99] * 6, [0.5] * 6], np.float32))
    k = tad.choose_k(conf, tconf.boundary_posterior(conf))
    assert int(k[0]) == 0 and int(k[1]) > 0


@pytest.mark.parametrize("seed", range(4))
def test_adaptive_matches_jax(seed):
    """choose_k, posterior_coverage_k (monotone in coverage, within [1,
    k_max]) and expected_recovery against JAX on random confidences."""
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.05, 0.99, (5, 9)).astype(np.float32)
    tr = tconf.boundary_posterior(t(conf))
    jr = jconf.boundary_posterior(jnp.asarray(conf))
    for cov in (0.5, 0.85, 0.95):
        k = tad.posterior_coverage_k(tr, cov, 4)
        np.testing.assert_array_equal(
            k.numpy(), np.asarray(jad.posterior_coverage_k(jr, cov, 4)))
        assert ((k >= 1) & (k <= 4)).all()
        assert (tad.posterior_coverage_k(tr, min(cov + 0.04, 0.99), 4)
                >= k).all()
    np.testing.assert_array_equal(
        tad.choose_k(t(conf), tr, skip_threshold=0.01).numpy(),
        np.asarray(jad.choose_k(jnp.asarray(conf), jr, skip_threshold=0.01)))
    fork = rng.integers(0, 9, (5, 3)).astype(np.int32)
    close(tad.expected_recovery(tr, t(fork), GAMMA),
          jad.expected_recovery(jr, jnp.asarray(fork), GAMMA))


def test_layernorm_sinks_select_branches_chain_accept_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    close(tlayers.layernorm({k: t(v) for k, v in p.items()}, t(x)),
          jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    # attend_dense takes sinks and does not read them, in both packages
    q = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    sinks = rng.standard_normal(4).astype(np.float32)
    want = jattn.attend_dense(jnp.asarray(q), jnp.asarray(kv),
                              jnp.asarray(kv), sinks=jnp.asarray(sinks))
    close(tattn.attend_dense(t(q), t(kv), t(kv), sinks=t(sinks)), want)
    close(tattn.attend_dense(t(q), t(kv), t(kv)), want)
    logits = rng.standard_normal((3, GAMMA - 1, VOCAB)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (3, GAMMA - 1)).astype(np.int32)
    for dt in (None, toks):
        got = tconf.select_branches(t(logits), K, None if dt is None
                                    else t(dt))
        want = jconf.select_branches(jnp.asarray(logits), K, None if dt is
                                     None else jnp.asarray(dt))
        close(got[0], want[0])
        close(got[1], want[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # chain acceptance: make some rows agree with the argmax for a while
    pred = logits.argmax(-1)
    toks[0] = pred[0]
    toks[1, :2] = pred[1, :2]
    n_t, p_t = tver.chain_prefix_accept_greedy(t(toks), t(logits))
    n_j, p_j = jver.chain_prefix_accept_greedy(jnp.asarray(toks),
                                               jnp.asarray(logits))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert n_t[0] == GAMMA - 1 and n_t[1] >= 2


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_ragged_prompts_decode_as_each_row_alone(family):
    """``generate(true_len=)`` and ``generate_ondevice(true_len=)`` over
    prompts padded to one length give each row the tokens it gets
    decoded alone from its real prompt (the recurrent states snap at the
    row's length in the prefill)."""
    _, tb = _bundles(family)
    lens = (8, 5, 7)
    padded = _prompts().copy()
    for r, n in enumerate(lens):
        padded[r, n:] = 0
    want = [tpl.generate(tb, _prompts()[r:r + 1, :n], 10, device="cpu")[
        "tokens"][0] for r, n in enumerate(lens)]
    for fn in (tpl.generate, tpl.generate_ondevice):
        out = fn(tb, padded, 10, true_len=lens, device="cpu")
        np.testing.assert_array_equal(out["tokens"], np.stack(want))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_launch_serve_recurrent_archs_on_the_cpu(arch, capsys):
    """``launch/serve.py --arch`` on each recurrent arch's smoke target
    (its drafter reads that target's features), paged, through the
    cascade kernels' plain versions."""
    from repro_torch.launch import serve
    stats = serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                        "--max-new", "6", "--cache-impl", "paged",
                        "--page-size", "16", "--attn-impl", "kernel"])
    assert stats["tokens"] == 12 and stats["pool_pages"] > 0
    assert "served" in capsys.readouterr().out

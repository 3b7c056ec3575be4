"""The port's other draft modes held to the JAX package: ``naive_k``,
``eagle``, ``dflash_second`` and ``d2sd`` with ``third_level`` (the
paper's Tables 1, 5, 6 and 7), greedy.

* ``generate`` and ``generate_ondevice`` are token-identical to JAX
  ``generate`` and to plain greedy decoding for each mode, on dense and
  paged caches, through both read paths (``kernel`` runs the cascade
  kernels' plain versions on CPU tensors), with JAX's ``n_cycles`` for
  every mode but ``naive_k``, whose resamples are random draws at any
  temperature and cannot follow JAX's stream;
* each mode's draft phase on one state builds JAX's tree;
* ``ar_chain_draft``, ``extend_third_level`` (the head at ``s == i_b``
  included), ``_splice``, ``children_table``, ``comb_draft_probs`` and the
  sampled ``confidences`` match their JAX twins on inputs from a numpy
  seed; ``comb_draft_probs`` differs on purpose where JAX's q is not the
  distribution a token was drawn from (ROADMAP.md queue 3).

float32, tiny shapes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close, port_drafter_cfg, t
from repro.config.base import SpecConfig as JSpec
from repro.core import confidence as jconf
from repro.core import drafter as jdr
from repro.core import pipeline as jpl
from repro.core import state as jstate
from repro.core import strategies as jst
from repro.core import tree as jtree
from repro_torch.config.base import SpecConfig
from repro_torch.core import confidence as tconf
from repro_torch.core import drafter as tdr
from repro_torch.core import pipeline as tpl
from repro_torch.core import state as tstate
from repro_torch.core import strategies as tst
from repro_torch.core import tree as ttree
from test_torch_pipeline import (GAMMA, K, MAX_NEW, VOCAB, _chip_smoke,
                                 _greedy_tokens, _models, _prompts)

# the modes beside d2sd, as chip_smoke.MODES names them
MODES = ["dflash_second", "eagle", "naive_k", "third_level"]


def jax_bundle(name, temperature=0.0):
    """JAX bundle of a mode as ``tests/test_lossless.py`` wires it: a causal
    drafter for ``eagle``, drafter 1's params as drafter 2 for
    ``dflash_second``."""
    (jt, jd, tp, d1, d2), _ = _models()
    mode, third = _chip_smoke().MODES.get(name, (name, False))
    jd = dataclasses.replace(jd, causal=mode == "eagle")
    spec = JSpec(gamma=GAMMA, top_k_branches=K, mode=mode, third_level=third,
                 temperature=temperature)
    return jpl.SpecBundle(jt, jd, jd, spec, tp, d1,
                          d1 if mode == "dflash_second" else d2)


def bundle_for(name, impl="gather", temperature=0.0):
    """The port's bundle of a mode (``chip_smoke.mode_bundle``, wired as
    :func:`jax_bundle`) on the read path ``impl``."""
    _, (tt, td, tp, d1, d2) = _models()
    base = tpl.SpecBundle(tt, td, td, SpecConfig(gamma=GAMMA,
                                                 top_k_branches=K),
                          tp, d1, d2)
    return tpl.with_attn_impl(
        _chip_smoke().mode_bundle(base, name, temperature), impl)


@functools.lru_cache(maxsize=None)
def _jax_generate(name):
    out = jpl.generate(jax_bundle(name), jnp.asarray(_prompts()),
                       max_new=MAX_NEW, key=jax.random.PRNGKey(7))
    return np.asarray(out["tokens"]), int(out["n_cycles"])


# ------------------------------------------------------------ the loops ---
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("name", MODES)
def test_mode_matches_jax_and_pure_greedy(name, cache_impl, impl):
    assert sorted(_chip_smoke().MODES) == MODES
    jtok, jcycles = _jax_generate(name)
    ref = _greedy_tokens()
    np.testing.assert_array_equal(jtok, ref)
    bundle = bundle_for(name, impl)
    kw = dict(cache_impl=cache_impl, page_size=8, device="cpu")
    host = tpl.generate(bundle, _prompts(), MAX_NEW, **kw)
    graph = tpl.generate_ondevice(bundle, _prompts(), MAX_NEW, **kw)
    for out in (host, graph):
        np.testing.assert_array_equal(out["tokens"], ref)
    assert (graph["n_cycles"], graph["alpha"]) == (host["n_cycles"],
                                                   host["alpha"])
    if name != "naive_k":
        assert host["n_cycles"] == jcycles
    assert len(host["stats"]["n_out"]) == host["n_cycles"]
    # the calibration stats of the modes with a diffusion trunk
    assert bool(host["stats"]["conf"]) == (name != "eagle")


def _jax_state(bundle, prompts, cache_impl):
    state = jstate.engine_init(bundle, prompts.shape[0], 40,
                               cache_impl=cache_impl, page_size=8)
    return jstate.prefill(bundle, state, jnp.asarray(prompts))


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("name", ["eagle", "dflash_second", "third_level"])
def test_draft_builds_jax_tree(name, cache_impl):
    """One draft phase on the same prefilled state: the same tree (tokens,
    parents, depths, validity), sibling bound and trunk confidences; the
    drafters' paged feature-cache reads through the kernel path."""
    prompts = _prompts()
    jb = jax_bundle(name)
    jres = jst.get_strategy(jb.spec.mode).draft(
        jb, _jax_state(jb, prompts, cache_impl), jax.random.PRNGKey(0))
    tb = bundle_for(name, "kernel")
    st = tstate.prefill(tb, tstate.engine_init(
        tb, prompts.shape[0], 40, cache_impl=cache_impl, page_size=8,
        device="cpu"), t(prompts).long())
    res = tst.get_strategy(tb.spec.mode).draft(tb, st, None)
    for f in ("tokens", "parent", "depth", "valid"):
        np.testing.assert_array_equal(getattr(res.tree, f).numpy(),
                                      np.asarray(getattr(jres.tree, f)))
    assert res.tree.max_depth == jres.tree.max_depth
    assert res.max_children == jres.max_children
    assert res.dprobs is None and jres.dprobs is None
    if jres.conf is None:
        assert res.conf is None
    else:
        close(res.conf, jres.conf, atol=1e-6)
    strategy = tst.get_strategy(tb.spec.mode)
    jstrategy = jst.get_strategy(jb.spec.mode)
    for meta in ("n_draft_passes", "n_tree_nodes"):
        assert getattr(strategy, meta)(tb.spec) == getattr(
            jstrategy, meta)(jb.spec)
    assert strategy.n_tree_nodes(tb.spec) == res.tree.n


# ------------------------------------------------------- the functions ---
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_ar_chain_draft_matches_jax(cache_impl, impl):
    """g-1 causal forwards over the block: tokens exact, logits 1e-5;
    with ``kernel`` on a paged cache every step reads the feature pools
    through the paged cascade kernel's plain version."""
    (_, jd, _, d1, _), (_, _, _, t1, _) = _models()
    jd = dataclasses.replace(jd, causal=True)
    td = port_drafter_cfg(jd, attn_impl=impl)
    rng = np.random.default_rng(21)
    b, max_len, fd = 3, 40, jd.target_feature_dim
    kw = dict(cache_impl=cache_impl, page_size=8)
    jc = jdr.init_feat_cache(jd, b, max_len, dtype=jnp.float32, **kw)
    tc = tdr.init_feat_cache(td, b, max_len, torch.float32, "cpu", **kw)
    n_new = np.array([11, 7, 9], np.int32)
    feats = rng.standard_normal((b, 11, fd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (b, 11))
    jc = jdr.extend_feat_cache(d1, jd, jc, jnp.asarray(feats),
                               jnp.asarray(pos), jnp.asarray(n_new))
    tc = tdr.extend_feat_cache(t1, td, tc, t(feats), t(pos), t(n_new))
    anchor = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    jtok, jlog = jdr.ar_chain_draft(d1, jd, jnp.asarray(anchor), jc,
                                    steps=GAMMA - 1)
    ttok, tlog = tdr.ar_chain_draft(t1, td, t(anchor).long(), tc,
                                    steps=GAMMA - 1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    close(tlog, jlog)


def _third_inputs(seed, b=5, g=GAMMA, k=3):
    """A comb tree and third-level forks, each row with a head at
    ``s == i_b`` (a fork at g-2, so that s is clipped back onto it)."""
    rng = np.random.default_rng(seed)
    anchor = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    trunk = rng.integers(0, VOCAB, (b, g - 1)).astype(np.int32)
    branch = rng.integers(0, VOCAB, (b, k, g - 1)).astype(np.int32)
    third = rng.integers(0, VOCAB, (b, k, g - 1)).astype(np.int32)
    fork = np.stack([np.r_[g - 2, rng.permutation(g - 2)[:k - 1]]
                     for _ in range(b)]).astype(np.int32)
    fork3 = np.minimum(fork + 1 + rng.integers(0, g, (b, k)), g - 2)
    fork3 = np.maximum(fork3, fork).astype(np.int32)
    return anchor, trunk, branch, third, fork, fork3


def _trees(inputs, g=GAMMA):
    anchor, trunk, branch, third, fork, fork3 = inputs
    jt_ = jtree.extend_third_level(
        jtree.comb_tree(*map(jnp.asarray, (anchor, trunk, branch, fork)), g),
        jnp.asarray(third), jnp.asarray(fork), jnp.asarray(fork3), g)
    tt_ = ttree.extend_third_level(
        ttree.comb_tree(t(anchor), t(trunk), t(branch), t(fork), g),
        t(third), t(fork), t(fork3), g)
    return jt_, tt_


@pytest.mark.parametrize("seed", [0, 1])
def test_third_level_tree_and_children_match_jax(seed):
    inputs = _third_inputs(seed)
    anchor, trunk, branch, third, fork, fork3 = inputs
    k = fork.shape[1]
    assert (fork3 == fork).any() and (fork3 > fork).any()
    jt_, tt_ = _trees(inputs)
    for f in ("tokens", "parent", "depth", "valid"):
        np.testing.assert_array_equal(getattr(tt_, f).numpy(),
                                      np.asarray(getattr(jt_, f)))
    np.testing.assert_array_equal(
        tst._splice(t(trunk), t(branch), t(fork)).numpy(),
        np.asarray(jst._splice(jnp.asarray(trunk), jnp.asarray(branch),
                               jnp.asarray(fork))))
    # the full bound (K + 2), and bounds that drop children
    for c in (k + 2, 2, 1):
        np.testing.assert_array_equal(
            ttree.children_table(tt_, c).numpy(),
            np.asarray(jtree.children_table(jt_, c)))
    ok = np.random.default_rng(seed).random(tt_.tokens.shape) < 0.8
    jacc = jtree.propagate_acceptance(jt_, jnp.asarray(ok))
    tacc = ttree.propagate_acceptance(tt_, t(ok))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for a, w in zip(ttree.best_path(tt_, tacc), jtree.best_path(jt_, jacc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_comb_draft_probs_match_jax_but_the_quirk(temp):
    """Trunk and second-level nodes within 1e-6 of JAX; third-level nodes
    take the third draft's distribution (JAX: branch K-1's second-draft
    one at that slot)."""
    rng = np.random.default_rng(22)
    inputs = _third_inputs(3)
    jt_, tt_ = _trees(inputs)
    b, k, g = inputs[2].shape[0], inputs[2].shape[1], GAMMA
    d1, d2, d3 = (rng.standard_normal(s).astype(np.float32) * 2
                  for s in ((b, g, VOCAB), (b, k, g, VOCAB),
                            (b, k, g, VOCAB)))
    want = np.asarray(jst.comb_draft_probs(jt_, jnp.asarray(d1),
                                           jnp.asarray(d2), g, temp))
    got = tst.comb_draft_probs(tt_, t(d1), t(d2), g, temp,
                               d3_logits=t(d3)).numpy()
    n2 = g + k * (g - 1)
    close(got[:, :n2], want[:, :n2], atol=1e-6)
    q3 = torch.softmax(t(d3) / temp, -1).reshape(b, k * g, VOCAB)
    node = np.arange(n2, tt_.n)
    row = ((node - n2) // (g - 1))[None] * g + np.minimum(
        tt_.depth[:, n2:].numpy(), g - 1)
    close(got[:, n2:], torch.gather(q3, 1, torch.from_numpy(row)[
        ..., None].expand(-1, -1, VOCAB)), atol=1e-6)
    assert np.abs(got[:, n2:] - want[:, n2:]).max() > 1e-2


@pytest.mark.parametrize("temp", [1.0, 1.5, 0.5])
def test_naive_k_draft_probs_match_jax_from_temperature_one(temp):
    """naive_k's q: the trunk at T, the resamples at max(T, 1), the
    temperature they were drawn at; JAX builds both at T, the same
    from T = 1 up."""
    rng = np.random.default_rng(23)
    b, g = 4, GAMMA
    anchor = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    trunk = rng.integers(0, VOCAB, (b, g - 1)).astype(np.int32)
    res = rng.integers(0, VOCAB, (b, K, g - 1)).astype(np.int32)
    fork = np.zeros((b, K), np.int32)
    d1 = rng.standard_normal((b, g, VOCAB)).astype(np.float32) * 2
    jt_ = jtree.comb_tree(*map(jnp.asarray, (anchor, trunk, res, fork)), g)
    tt_ = ttree.comb_tree(t(anchor), t(trunk), t(res), t(fork), g)
    want = np.asarray(jst.comb_draft_probs(jt_, jnp.asarray(d1), None, g,
                                           temp))
    got = tst.comb_draft_probs(tt_, t(d1), t(d1)[:, None], g, temp,
                               d2_temp=max(temp, 1.0)).numpy()
    close(got[:, :g], want[:, :g], atol=1e-6)
    if temp >= 1.0:
        close(got, want, atol=1e-6)
    else:
        assert np.abs(got[:, g:] - want[:, g:]).max() > 1e-2


def test_sampled_confidences_match_jax():
    rng = np.random.default_rng(24)
    logits = rng.standard_normal((3, 2, GAMMA - 1, VOCAB)).astype(
        np.float32) * 3
    toks = rng.integers(0, VOCAB, (3, 2, GAMMA - 1)).astype(np.int32)
    close(tconf.confidences(t(logits), t(toks)),
          jconf.confidences(jnp.asarray(logits), jnp.asarray(toks)),
          atol=1e-6)


def test_draft_probs_quirks_smallest_inputs():
    """The two smallest inputs on which the port's q departs from JAX's,
    as ROADMAP.md queue 3 logs them. Third level (gamma 3, K 1, V 2, one
    row; the third branch hangs off the branch's slot-1 node and drafts
    slot 2, node 5): d2 logits 0, d3 logits (0, ln 3); JAX gives node 5
    branch 0's second-draft q (0.5, 0.5), the port the third draft's
    (0.25, 0.75). naive_k (gamma 2, K 1, V 2, T 0.5; d1 logits (0, 1) at
    slot 1): the resample, drawn at T 1, gets q (0.269, 0.731) in the
    port and (0.119, 0.881), the trunk's, in JAX."""
    g = 3
    a, tr, br, th = (np.array(x) for x in ([0], [[1, 1]], [[[1, 1]]],
                                           [[[0, 1]]]))
    fork, f3 = np.array([[0]]), np.array([[1]])
    jt_ = jtree.extend_third_level(
        jtree.comb_tree(*map(jnp.asarray, (a, tr, br, fork)), g),
        jnp.asarray(th), jnp.asarray(fork), jnp.asarray(f3), g)
    tt_ = ttree.extend_third_level(
        ttree.comb_tree(t(a), t(tr), t(br), t(fork), g), t(th), t(fork),
        t(f3), g)
    assert tt_.valid[0, 5] and tt_.parent[0, 5] == 3
    d1, d2 = np.zeros((1, g, 2), np.float32), np.zeros((1, 1, g, 2),
                                                       np.float32)
    d3 = np.zeros((1, 1, g, 2), np.float32)
    d3[..., 1] = np.log(3.0)
    want = np.asarray(jst.comb_draft_probs(jt_, jnp.asarray(d1),
                                           jnp.asarray(d2), g, 1.0))
    got = tst.comb_draft_probs(tt_, t(d1), t(d2), g, 1.0,
                               d3_logits=t(d3)).numpy()
    close(want[0, 5], [0.5, 0.5], atol=1e-6)
    close(got[0, 5], [0.25, 0.75], atol=1e-6)
    close(got[:, :5], want[:, :5], atol=1e-6)
    g = 2
    a, tr, rs, fork = (np.array(x) for x in ([0], [[1]], [[[0]]], [[0]]))
    jt_ = jtree.comb_tree(*map(jnp.asarray, (a, tr, rs, fork)), g)
    tt_ = ttree.comb_tree(t(a), t(tr), t(rs), t(fork), g)
    d1 = np.array([[[0.0, 0.0], [0.0, 1.0]]], np.float32)
    want = np.asarray(jst.comb_draft_probs(jt_, jnp.asarray(d1), None, g,
                                           0.5))
    got = tst.comb_draft_probs(tt_, t(d1), t(d1)[:, None], g, 0.5,
                               d2_temp=1.0).numpy()
    close(got[:, :2], want[:, :2], atol=1e-6)
    close(want[0, 2], [0.11920292, 0.88079708], atol=1e-6)
    close(got[0, 2], [0.26894142, 0.73105858], atol=1e-6)

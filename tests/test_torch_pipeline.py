"""The port's greedy D^2SD path (``repro_torch.core``) held to the JAX
package.

``generate`` must be token-identical to JAX ``pipeline.generate`` and to
plain greedy decoding (``conftest.pure_greedy``) for the ``d2sd`` and
``dflash`` modes, on dense and paged caches, through both read paths
(``gather``, and ``kernel``: on CPU tensors the kernel wrappers run their
plain versions, so this pins the arithmetic the CUDA kernels are held to
on the card). The drafter forward (including the paged feature-cache
kernel read) and the tree and confidence helpers are checked on their
own first. ``chip_smoke.py``'s oracle drafts, which make cycles accept
paths that run into the tree's branches, are checked here as well.
float32, tiny shapes, inputs from a numpy seed.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import pure_greedy, tiny_drafter, tiny_target

from _torch_parity import (close, jax_drafter_forward, jax_drafter_init,
                           jax_extend_feat_cache, jax_lm_init, port_drafter,
                           port_drafter_cfg, port_lm, port_model_cfg, t)
from repro.config.base import SpecConfig as JSpec
from repro.core import confidence as jconf
from repro.core import drafter as jdr
from repro.core import pipeline as jpl
from repro.core import tree as jtree
from repro_torch.config.base import SpecConfig
from repro_torch.core import confidence as tconf
from repro_torch.core import drafter as tdr
from repro_torch.core import pipeline as tpl
from repro_torch.core import tree as ttree

VOCAB, GAMMA, K, MAX_NEW = 61, 6, 2, 16
ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _models():
    """JAX target and drafters at tiny size, and their port copies."""
    jt = tiny_target(vocab=VOCAB, dtype="float32")
    jd = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                      target_cfg=jt)
    tp = jax_lm_init(jax.random.PRNGKey(0), jt)
    d1 = jax_drafter_init(jax.random.PRNGKey(1), jd)
    d2 = jax_drafter_init(jax.random.PRNGKey(2), jd)
    tt, td = port_model_cfg(jt), port_drafter_cfg(jd)
    return (jt, jd, tp, d1, d2), (tt, td, port_lm(tp, tt), port_drafter(d1),
                                  port_drafter(d2))


@functools.lru_cache(maxsize=None)
def _prompts():
    return np.random.default_rng(3).integers(0, VOCAB, (3, 8)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _greedy_tokens(n=MAX_NEW):
    (jt, _, tp, _, _), _ = _models()
    greedy = jax.jit(pure_greedy, static_argnums=(1, 3))
    return np.asarray(greedy(tp, jt, jnp.asarray(_prompts()), n))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` at the repo root, loaded as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_tokens(mode):
    """(JAX generate tokens, n_cycles)."""
    (jt, jd, tp, d1, d2), _ = _models()
    out = jpl.generate(
        jpl.SpecBundle(jt, jd, jd, JSpec(gamma=GAMMA, top_k_branches=K,
                                         mode=mode), tp, d1, d2),
        jnp.asarray(_prompts()), max_new=MAX_NEW, key=jax.random.PRNGKey(7))
    return np.asarray(out["tokens"]), int(out["n_cycles"])


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["d2sd", "dflash"])
def test_generate_matches_jax_and_pure_greedy(mode, cache_impl, impl):
    jtok, jcycles = _jax_tokens(mode)
    ref = _greedy_tokens()
    np.testing.assert_array_equal(jtok, ref)
    _, (tt, td, tp, d1, d2) = _models()
    bundle = tpl.SpecBundle(tt, td, td, SpecConfig(
        gamma=GAMMA, top_k_branches=K, mode=mode), tp, d1, d2)
    out = tpl.generate(tpl.with_attn_impl(bundle, impl), _prompts(),
                       MAX_NEW, cache_impl=cache_impl, page_size=8,
                       device="cpu")
    np.testing.assert_array_equal(out["tokens"], ref)
    np.testing.assert_array_equal(out["tokens"], jtok)
    assert out["n_cycles"] == jcycles


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_oracle_drafts_accept_into_branches(cache_impl, impl):
    """With the oracle's drafts (the greedy reference, spoiled from a depth
    that varies by row and cycle) cycles commit several tokens, some
    along a path that runs into a branch, and with ``third_level`` some
    on into a third-level branch: tokens still equal pure greedy, alpha
    is exactly what the drafts must give, and the committed target and
    feature caches equal a plain prefill of the same tokens."""
    ref = _greedy_tokens(MAX_NEW + GAMMA)
    seq = t(np.concatenate([_prompts(), ref], 1)).long()
    oracle = _chip_smoke().register_oracle(seq)
    _, (tt, td, tp, d1, d2) = _models()
    for third in (False, True):
        oracle.reset()
        bundle = tpl.with_attn_impl(tpl.SpecBundle(tt, td, td, SpecConfig(
            gamma=GAMMA, top_k_branches=K, mode="oracle",
            third_level=third), tp, d1, d2), impl)
        out = tpl.generate(bundle, _prompts(), MAX_NEW,
                           cache_impl=cache_impl, page_size=8, device="cpu")
        np.testing.assert_array_equal(out["tokens"], ref[:, :MAX_NEW])
        count = oracle.read()
        assert out["alpha"] == count["committed"] / count["row_cycles"]
        assert out["alpha"] > 2 and count["branch_paths"] > 0
        assert (count["third_paths"] > 0) == third
        # the caches the cycles committed equal a prefill of the tokens
        err = _chip_smoke().committed_cache_error(
            bundle, t(_prompts()).long(), seq, cache_impl, max_new=MAX_NEW,
            page_size=8)
        assert err < 1e-5


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_drafter_forward_matches_jax(cache_impl, impl):
    """Feature-cache extension at ragged counts, then the DFlash block and
    a batch of VP blocks through ``drafter_forward``; ``kernel`` on a
    paged cache reads the pools through the paged cascade kernel."""
    (jt, jd, _, d1, _), (_, td, _, t1, _) = _models()
    td = port_drafter_cfg(jd, attn_impl=impl)
    rng = np.random.default_rng(4)
    b, max_len, fd = 3, 40, jd.target_feature_dim
    kw = dict(cache_impl=cache_impl, page_size=8)
    jc = jdr.init_feat_cache(jd, b, max_len, dtype=jnp.float32, **kw)
    tc = tdr.init_feat_cache(td, b, max_len, torch.float32, "cpu", **kw)
    base = np.zeros((b,), np.int32)
    for n_new in ([9, 9, 9], [4, 1, 3]):
        n_new = np.asarray(n_new, np.int32)
        feats = rng.standard_normal((b, 9, fd)).astype(np.float32)
        pos = (base[:, None] + np.arange(9)).astype(np.int32)
        jc = jax_extend_feat_cache(d1, jd, jc, jnp.asarray(feats),
                                   jnp.asarray(pos), jnp.asarray(n_new))
        tc = tdr.extend_feat_cache(t1, td, tc, t(feats), t(pos), t(n_new))
        base = base + n_new
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    anchor = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    blk = np.asarray(jdr.dflash_block(jnp.asarray(anchor), GAMMA,
                                      jd.mask_token))
    np.testing.assert_array_equal(
        tdr.dflash_block(t(anchor), GAMMA, td.mask_token).numpy(), blk)
    close(tdr.drafter_forward(t1, td, t(blk), tc),
          jax_drafter_forward(d1, jd, jnp.asarray(blk), jc))
    trunk = rng.integers(0, VOCAB, (b, GAMMA - 1)).astype(np.int32)
    fork = np.array([[0, 3], [2, 1], [4, 0]], np.int32)
    jvp = jdr.vp_blocks(jnp.asarray(anchor), jnp.asarray(trunk),
                        jnp.asarray(fork), jd.mask_token)
    tvp = tdr.vp_blocks(t(anchor), t(trunk), t(fork), td.mask_token)
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))
    # the K forks batched as rows, each reading its row's feature cache
    rows = np.repeat(np.arange(b), K)

    def take(c):
        out = dict(c)
        out["length"] = c["length"][rows]
        if "pt" in c:
            out["pt"] = c["pt"][rows]
        else:
            out["k"], out["v"] = c["k"][:, rows], c["v"][:, rows]
        return out
    pos = (base[rows][:, None] + np.arange(GAMMA)).astype(np.int32)
    close(tdr.drafter_forward(t1, td, tvp.reshape(b * K, GAMMA),
                              take(tc), positions=t(pos)),
          jax_drafter_forward(d1, jd, jvp.reshape(b * K, GAMMA),
                              take(jc), positions=jnp.asarray(pos)))


def test_tree_and_confidence_match_jax():
    """Comb tree, ancestor mask, positions, acceptance propagation, best
    path and the boundary posterior / top-K forks, on random drafts."""
    rng = np.random.default_rng(8)
    b, g, k = 4, GAMMA, 3
    anchor = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    trunk = rng.integers(0, VOCAB, (b, g - 1)).astype(np.int32)
    branch = rng.integers(0, VOCAB, (b, k, g - 1)).astype(np.int32)
    logits = rng.standard_normal((b, g - 1, VOCAB)).astype(np.float32) * 3
    jc = jconf.confidences(jnp.asarray(logits))
    tc = tconf.confidences(t(logits))
    close(tc, jc)
    jr, tr = jconf.boundary_posterior(jc), tconf.boundary_posterior(tc)
    close(tr, jr)
    fork = np.asarray(jconf.topk_prefixes(jr, k)[1])
    np.testing.assert_array_equal(tconf.topk_prefixes(tr, k)[1].numpy(),
                                  fork)
    jt_ = jtree.comb_tree(jnp.asarray(anchor), jnp.asarray(trunk),
                          jnp.asarray(branch), jnp.asarray(fork), g)
    tt_ = ttree.comb_tree(t(anchor), t(trunk), t(branch), t(fork), g)
    for name in ("tokens", "parent", "depth", "valid"):
        np.testing.assert_array_equal(getattr(tt_, name).numpy(),
                                      np.asarray(getattr(jt_, name)))
    np.testing.assert_array_equal(ttree.attention_mask(tt_).numpy(),
                                  np.asarray(jtree.attention_mask(jt_)))
    base = np.array([5, 9, 0, 30], np.int32)
    np.testing.assert_array_equal(
        ttree.positions(tt_, t(base)).numpy(),
        np.asarray(jtree.positions(jt_, jnp.asarray(base))))
    ok = rng.random((b, tt_.n)) < 0.7
    jacc = jtree.propagate_acceptance(jt_, jnp.asarray(ok))
    tacc = ttree.propagate_acceptance(tt_, t(ok))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for a, w in zip(ttree.best_path(tt_, tacc), jtree.best_path(jt_, jacc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))

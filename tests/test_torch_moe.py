"""The port's mixture-of-experts FFN (``repro_torch/models/moe.py``) and
MoE targets held to the JAX package.

``moe_apply`` against JAX's for both dispatches, fp32 and bf16, with and
without a shared expert, at a capacity that drops (token, expert) pairs
and at one that cannot; the queue positions, the kept mask and the
capacity exactly; the mirrors of ``tests/test_models.py::test_moe`` and
``::test_moe_dispatch_paths_agree``; a tiny MoE target's logits through
prefill and a tree verify; greedy ``generate`` tokens and ``n_cycles``
against JAX's and plain greedy on both caches and both read paths; the
capacity quirk both packages share (a verify pass drops pairs that
one-token greedy never drops, so D^2SD leaves plain greedy); and one
graph-loop step of a MoE target free of host syncs. Weights go through
``repro_torch.convert``; inputs come from a numpy seed.

Tolerances: fp32 1e-5 of the largest magnitude (the two packages differ
only in summation order); bf16 8e-3 of it (``TOL_FLASH[bfloat16]``, one
bf16 ulp either way), as the other bf16 checks of the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_drafter, tiny_target

from _torch_parity import (jax_drafter_init, jax_greedy, jax_lm_forward,
                           jax_lm_init, port_drafter, port_drafter_cfg,
                           port_greedy, port_lm, port_model_cfg, t)
from repro.config.base import ModelConfig, MoEConfig
from repro.config.base import SpecConfig as JSpec
from repro.core import pipeline as jpl
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.config.base import SpecConfig
from repro_torch.core import pipeline as tpl
from repro_torch.core.state import engine_init, prefill
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

BASE = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
            max_seq_len=64, remat=False)
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
VOCAB, GAMMA, K, MAX_NEW = 61, 6, 2, 12


def _rel_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def _moe_cfg(dispatch="scatter", cf=4.0, shared=0, dtype="float32",
             experts=4, top_k=2, **kw):
    return ModelConfig(num_layers=1, dtype=dtype, moe=MoEConfig(
        num_experts=experts, top_k=top_k, capacity_factor=cf,
        dispatch=dispatch, num_shared_experts=shared), **{**BASE, **kw})


def _moe_inputs(jcfg, seed=0, b=2, t_len=16):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, t_len, jcfg.d_model)).astype(np.float32)
    dt = getattr(torch, jcfg.dtype)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    return jp, tp, jnp.asarray(x, jnp.dtype(jcfg.dtype)), t(x).to(dt)


# --------------------------------------------------------------- moe ------
@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_apply_matches_jax(dispatch, dtype, shared, cf):
    jcfg = _moe_cfg(dispatch, cf, shared, dtype)
    tcfg = port_model_cfg(jcfg)
    jp, tp, jx, tx = _moe_inputs(jcfg)
    want = jmoe.moe_apply(jp, jx, jcfg, dispatch=dispatch)
    got = tmoe.moe_apply(tp, tx, tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == tx.shape
    _rel_close(got, want, dtype)
    # the capacity that drops does drop, the other does not
    _, idx = tmoe._route(tp, tx.reshape(-1, jcfg.d_model), tcfg)
    cap = tmoe._capacity(idx.shape[0], tcfg)
    dropped = int((tmoe._positions(idx, 4) >= cap).sum())
    assert (dropped > 0) == (cf < 1), dropped


@pytest.mark.parametrize("experts,top_k", [(4, 2), (8, 3), (16, 8)])
def test_positions_keep_and_capacity_match_jax(experts, top_k):
    """Queue positions and the kept mask exactly, for routings drawn at
    random (each token's k experts distinct), and the capacity rule."""
    rng = np.random.default_rng(experts)
    idx = np.stack([rng.permutation(experts)[:top_k] for _ in range(37)])
    jpos = np.asarray(jmoe._positions(jnp.asarray(idx), experts, 0))
    tpos = tmoe._positions(t(idx).long(), experts)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    for cf in (0.25, 1.25, 2.0):
        jcfg = _moe_cfg(cf=cf, experts=experts, top_k=top_k)
        tcfg = port_model_cfg(jcfg)
        for n in (1, 3, 37, 304, 2048):
            assert tmoe._capacity(n, tcfg) == jmoe._capacity(n, jcfg)
        cap = jmoe._capacity(idx.shape[0], jcfg)
        np.testing.assert_array_equal((tpos < cap).numpy(), jpos < cap)


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["no_drops", "drops"])
def test_moe_dispatch_paths_agree(cf):
    """The mirror of ``tests/test_models.py::test_moe_dispatch_paths_agree``
    (its tolerance), and at a capacity that drops."""
    jcfg = _moe_cfg("einsum", cf)
    tcfg = port_model_cfg(jcfg)
    _, tp, _, tx = _moe_inputs(jcfg)
    y1 = tmoe.moe_apply(tp, tx, tcfg, dispatch="einsum")
    y2 = tmoe.moe_apply(tp, tx, tcfg, dispatch="scatter")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_init_builds_stacks_in_param_dtype():
    """The expert stacks are allocated in ``cfg.param_dtype`` and hold
    JAX's tree of shapes."""
    jcfg = _moe_cfg(shared=1)
    want = jax.tree.map(lambda a: a.shape, jmoe.moe_init(
        jax.random.PRNGKey(0), jcfg))
    for pd in ("float32", "bfloat16"):
        tcfg = dataclasses.replace(port_model_cfg(jcfg), param_dtype=pd)
        p = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
        assert jax.tree.map(lambda a: tuple(a.shape), p,
                            is_leaf=lambda a: isinstance(a, torch.Tensor)) \
            == jax.tree.map(tuple, want,
                            is_leaf=lambda a: isinstance(a, tuple))
        for name in ("moe_w_in", "moe_w_gate", "moe_w_out"):
            assert p[name].dtype == getattr(torch, pd)
            assert p[name].is_contiguous()
        assert p["router"].dtype == torch.float32


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe(dispatch):
    """The mirror of ``tests/test_models.py::test_moe``: a cached prefill
    of all but the last token, then one decode pass, against the full
    causal pass (bf16, JAX's weights, capacity 4.0: no drops)."""
    jcfg = ModelConfig(num_layers=4, moe=MoEConfig(
        num_experts=4, top_k=2, capacity_factor=4.0, dispatch=dispatch),
        **BASE)
    tcfg = port_model_cfg(jcfg)
    tp = port_lm(jax_lm_init(jax.random.PRNGKey(0), jcfg), tcfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 12))).long()
    full = tlm.forward(tp, toks, tcfg)
    assert not torch.isnan(full["logits"].float()).any()
    states = tlm.init_states(tcfg, 2, 32, device="cpu")
    o1 = tlm.forward(tp, toks[:, :-1], tcfg, states=states, write_kv=True)
    o2 = tlm.forward(tp, toks[:, -1:], tcfg, states=o1["states"],
                     write_kv=False)
    d = (o2["logits"][:, -1].float() - full["logits"][:, -1].float()).abs()
    assert float(d.max()) < 0.16, float(d.max())


# -------------------------------------------------------- a MoE target ----
def _target(cf, shared=0):
    return tiny_target(vocab=VOCAB, dtype="float32", moe=MoEConfig(
        num_experts=4, top_k=2, capacity_factor=cf, dispatch="scatter",
        num_shared_experts=shared))


@functools.lru_cache(maxsize=None)
def _weights():
    """JAX weights of the tiny MoE target and its drafters; the capacity
    factor reads no weight, so every ``cf`` shares them (one init
    compile)."""
    jt = _target(2.0)
    jd = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                      target_cfg=jt)
    return (jax_lm_init(jax.random.PRNGKey(0), jt),
            jax_drafter_init(jax.random.PRNGKey(1), jd),
            jax_drafter_init(jax.random.PRNGKey(2), jd))


@functools.lru_cache(maxsize=None)
def _models(cf):
    """JAX MoE target (4 experts, top 2, capacity factor ``cf``) and
    drafters at tiny size, and their port copies."""
    jt = _target(cf)
    jd = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                      target_cfg=jt)
    tp, d1, d2 = _weights()
    tt, td = port_model_cfg(jt), port_drafter_cfg(jd)
    return (jt, jd, tp, d1, d2), (tt, td, port_lm(tp, tt), port_drafter(d1),
                                  port_drafter(d2))


def _bundles(cf, impl="gather"):
    (jt, jd, tp, d1, d2), (tt, td, ttp, td1, td2) = _models(cf)
    spec = dict(gamma=GAMMA, top_k_branches=K)
    return (jpl.SpecBundle(jt, jd, jd, JSpec(**spec), tp, d1, d2),
            tpl.with_attn_impl(tpl.SpecBundle(tt, td, td, SpecConfig(**spec),
                                              ttp, td1, td2), impl))


@functools.lru_cache(maxsize=None)
def _jax_run(cf, prompts_key, max_new):
    """(JAX generate tokens, n_cycles, JAX plain greedy tokens)."""
    prompts = np.asarray(prompts_key, np.int32)
    jb, _ = _bundles(cf)
    out = jpl.generate(jb, jnp.asarray(prompts), max_new=max_new,
                       key=jax.random.PRNGKey(7))
    ref = jax_greedy(jb.target_params, jb.target_cfg, jnp.asarray(prompts),
                     max_new)
    return np.asarray(out["tokens"]), int(out["n_cycles"]), ref


def _key(a):
    return tuple(map(tuple, np.asarray(a).tolist()))


PROMPTS = np.random.default_rng(3).integers(0, VOCAB, (3, 8)).astype(np.int32)


def test_moe_target_logits_match_jax():
    """A tiny MoE target with a shared expert (capacity 1.25: the prefill
    drops pairs): prefill logits, features and caches, then a tree-masked
    verify step over the caches, against JAX (fp32)."""
    jt = _target(1.25, shared=1)
    tt = port_model_cfg(jt)
    jp = jax_lm_init(jax.random.PRNGKey(0), jt)
    tp = port_lm(jp, tt)
    toks = np.random.default_rng(5).integers(0, VOCAB, (2, 9))
    js = jlm.init_states(jt, 2, 24, dtype=jnp.float32)
    jo = jax_lm_forward(jp, jnp.asarray(toks), jt, states=js, write_kv=True,
                        want_features=True)
    to = tlm.forward(tp, t(toks).long(), tt, states=tlm.init_states(
        tt, 2, 24, device="cpu"), write_kv=True, want_features=True)
    for name in ("logits", "features"):
        _rel_close(to[name], jo[name], "float32")
    blk = np.random.default_rng(6).integers(0, VOCAB, (2, 5))
    mask = np.tril(np.ones((5, 5), bool))
    mask[3, 1:3] = False
    pos = np.array([[9, 10, 11, 10, 11]] * 2)
    jv = jax_lm_forward(jp, jnp.asarray(blk), jt, states=jo["states"],
                        extra_mask=jnp.asarray(mask), positions=jnp.asarray(
                            pos))
    tv = tlm.forward(tp, t(blk).long(), tt, states=to["states"],
                     extra_mask=t(mask), positions=t(pos))
    _rel_close(tv["logits"], jv["logits"], "float32")


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_generate_matches_jax_and_pure_greedy(cache_impl, impl):
    """Capacity factor E/k = 2: no pass can drop, so D^2SD equals plain
    greedy in both packages; the port's tokens and cycles equal JAX's."""
    jtok, jcycles, ref = _jax_run(2.0, _key(PROMPTS), MAX_NEW)
    np.testing.assert_array_equal(jtok, ref)
    _, tb = _bundles(2.0, impl)
    out = tpl.generate(tb, PROMPTS, MAX_NEW, cache_impl=cache_impl,
                       page_size=8, device="cpu")
    np.testing.assert_array_equal(out["tokens"], jtok)
    assert out["n_cycles"] == jcycles


# The smallest input found where JAX's D^2SD tokens leave plain greedy
# because of a capacity drop: two rows, one prompt token each, two new
# tokens (one cycle), capacity factor 0.5. The verify pass routes 2 x 16
# tree tokens at capacity 8 an expert, in row-major priority: row 0's
# tokens fill experts that row 1's root then overflows, so row 1's bonus
# token comes from a pass that dropped its root's expert. Plain greedy
# routes 2 tokens at capacity 2 and never drops (ROADMAP.md queue 3).
QUIRK_PROMPTS = np.random.default_rng(2).integers(0, VOCAB, (2, 1)).astype(
    np.int32)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_capacity_quirk_matches_jax(cache_impl, impl):
    jtok, jcycles, ref = _jax_run(0.5, _key(QUIRK_PROMPTS), 2)
    assert jcycles == 1
    assert (jtok[0] == ref[0]).all() and jtok[1, 1] != ref[1, 1]
    _, tb = _bundles(0.5, impl)
    out = tpl.generate(tb, QUIRK_PROMPTS, 2, cache_impl=cache_impl,
                       page_size=8, device="cpu")
    np.testing.assert_array_equal(out["tokens"], jtok)
    # the port's plain greedy is JAX's; raising the capacity to E/k
    # brings D^2SD back onto it (JAX's at E/k: the test above)
    greedy = [port_greedy(tb, p, 2) for p in QUIRK_PROMPTS]
    np.testing.assert_array_equal(np.stack(greedy), ref)
    out2 = tpl.generate(_bundles(2.0, impl)[1], QUIRK_PROMPTS, 2,
                        cache_impl=cache_impl, page_size=8, device="cpu")
    np.testing.assert_array_equal(out2["tokens"], ref)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_moe_ondevice_step_makes_no_host_sync(cache_impl):
    """One step of the graph loop on a MoE target (capacity 1.25: the
    verify drops pairs) under the dispatch mode that refuses what a CUDA
    graph cannot capture: the routing, the capacity buckets and the
    combine read nothing back to the host."""
    from test_torch_ondevice import _NoHostSync
    _, tb = _bundles(1.25, "kernel")
    gen = torch.Generator()
    state = prefill(tb, engine_init(tb, 3, 40, cache_impl=cache_impl,
                                    page_size=8, device="cpu"),
                    t(PROMPTS).long(), gen)
    loop = tpl.OnDeviceLoop(tb, state, MAX_NEW, gen)
    loop.step()
    before = loop.state.length.clone()
    with _NoHostSync() as mode:
        loop.step()
    assert (loop.state.length > before).all()
    assert torch.ops.aten.bmm in mode.ops            # the expert products

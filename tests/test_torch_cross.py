"""The port's cross-attention blocks, encoder-decoder and ``ctx`` plumbing
held to the JAX package.

``period_spec``, the drafter features and ``feature_dim`` of cross
configs; ``attn_init(cross=True)``'s tree; the mirror of
``tests/test_models.py::test_cross_attention``; a tiny VLM target's
logits, features and cross caches through a forward with ``ctx``, a
prefill with it and a tree verify that reads the caches; ``encode``
(dense, and chunked with a padded last chunk) and the non-causal chunked
attention it runs (``encdec_loss`` / ``api.train_loss`` and their grads
are held to JAX for whisper and the VLM in ``tests/test_torch_archs.py``);
greedy ``generate(ctx=)`` tokens and ``n_cycles`` against JAX's and a
plain greedy that prefills with ``ctx`` and reads the cross caches, on a
tiny VLM and a tiny whisper, both caches and both read paths; the
prefill steps of ``launch/steps.py``; and the serving quirk (JAX's
engine serves a cross target with no context; the port's refuses it).

float32, tiny shapes, inputs from a numpy seed, weights through
``repro_torch.convert``; tolerance 1e-5 of the largest magnitude (the two
packages differ only in summation order).
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
                           jax_lm_init, jax_state_layers, np_tree,
                           port_drafter, port_drafter_cfg, port_lm,
                           port_model_cfg, t)
from repro.config.base import ModelConfig
from repro.config.base import SpecConfig as JSpec
from repro.config.registry import get_config as jget
from repro.core import pipeline as jpl
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import encdec as jenc
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.config.base import SpecConfig
from repro_torch.core import pipeline as tpl
from repro_torch.core import state as tstate
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import encdec as tenc
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import ServingEngine as TEngine

BASE = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
            max_seq_len=64, remat=False)
VOCAB, GAMMA, K, MAX_NEW, N_CTX = 61, 6, 2, 12, 5


def _rel_close(got, want, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ the spec ----
SPEC_CFGS = {
    "vlm_smoke": jget("llama-3.2-vision-11b", smoke=True),
    "vlm_full": jget("llama-3.2-vision-11b"),
    "whisper_smoke": jget("whisper-medium", smoke=True),
    "whisper_full": jget("whisper-medium"),
    "local_global_every3": ModelConfig(
        num_layers=7, layer_pattern=("local", "global"), cross_attn_every=3,
        sliding_window=8, **BASE),
    "hybrid_every2_tail": ModelConfig(
        num_layers=8, layer_pattern=("recurrent", "recurrent", "local"),
        cross_attn_every=2, sliding_window=8, **BASE),
    "no_cross_tail": ModelConfig(num_layers=5,
                                 layer_pattern=("local", "global"), **BASE),
}


@pytest.mark.parametrize("name", sorted(SPEC_CFGS))
def test_period_spec_and_feature_dim_match_jax(name):
    jcfg = SPEC_CFGS[name]
    tcfg = port_model_cfg(jcfg)
    jspec, jn, jtail = jblocks.period_spec(jcfg)
    tspec, tn, ttail = tblocks.period_spec(tcfg)
    as_pairs = lambda s: [(b.kind, b.cross) for b in s]  # noqa: E731
    assert as_pairs(tspec) == as_pairs(jspec) and tn == jn
    assert as_pairs(ttail) == as_pairs(jtail)
    specs = tblocks.layer_specs(tcfg)
    assert [b.kind for b in specs] == list(tcfg.pattern_for_depth())
    assert tlm.feature_dim(tcfg) == jlm.feature_dim(jcfg)


def test_cross_attn_init_tree_matches_jax():
    """No QKV bias on the cross sub-layer; with qk_norm, q_norm and
    k_norm exist (and are never read), as in JAX."""
    jcfg = ModelConfig(num_layers=2, cross_attn_every=2, qkv_bias=True,
                       qk_norm=True, **BASE)
    tcfg = port_model_cfg(jcfg)
    for cross in (False, True):
        jp = jattn.attn_init(jax.random.PRNGKey(0), jcfg, cross=cross)
        tp = tattn.attn_init(torch.Generator(), tcfg, cross=cross)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: v.shape for k, v in jp.items()}
    tp = tlm.lm_init(tcfg, device="cpu")
    assert "xattn" in tp["layers"][1] and "xattn" not in tp["layers"][0]


def test_cross_attention():
    """The mirror of ``tests/test_models.py::test_cross_attention``: a
    cached prefill of all but the last token with ``ctx``, then one decode
    pass that reads the cross caches, against the full causal pass with
    ``ctx`` (bf16, JAX's weights, tolerance 0.15)."""
    jcfg = ModelConfig(num_layers=4, cross_attn_every=2, **BASE)
    tcfg = port_model_cfg(jcfg)
    tp = port_lm(jax_lm_init(jax.random.PRNGKey(0), jcfg), tcfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 12))).long()
    ctx = t(_rand(2, 2, 5, jcfg.d_model)).to(torch.bfloat16)
    full = tlm.forward(tp, toks, tcfg, ctx=ctx)
    assert not torch.isnan(full["logits"].float()).any()
    states = tlm.init_states(tcfg, 2, 32, ctx_len=5, device="cpu")
    o1 = tlm.forward(tp, toks[:, :-1], tcfg, states=states, write_kv=True,
                     ctx=ctx)
    o2 = tlm.forward(tp, toks[:, -1:], tcfg, states=o1["states"],
                     write_kv=False)
    d = (o2["logits"][:, -1].float() - full["logits"][:, -1].float()).abs()
    assert float(d.max()) < 0.15, float(d.max())


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_cross_target_forward_matches_jax(cache_impl):
    """A tiny VLM target (4 layers, cross every 2nd): a forward with
    ``ctx`` (logits, features), a prefill with ``ctx`` (logits and every
    state leaf, ``ck``/``cv`` included), then a tree-masked verify that
    reads the cross caches, against JAX."""
    jt = tiny_target(vocab=VOCAB, dtype="float32", cross_attn_every=2,
                     num_vision_tokens=N_CTX)
    tt = port_model_cfg(jt)
    jp = jax_lm_init(jax.random.PRNGKey(0), jt)
    tp = port_lm(jp, tt)
    toks = np.random.default_rng(5).integers(0, VOCAB, (2, 9))
    ctx = _rand(6, 2, N_CTX, jt.d_model)
    jo = jax_lm_forward(jp, jnp.asarray(toks), jt, ctx=jnp.asarray(ctx),
                        want_features=True)
    to = tlm.forward(tp, t(toks).long(), tt, ctx=t(ctx), want_features=True)
    for name in ("logits", "features"):
        _rel_close(to[name], jo[name])
    kw = dict(cache_impl=cache_impl, page_size=8)
    js = jlm.init_states(jt, 2, 24, ctx_len=N_CTX, dtype=jnp.float32, **kw)
    ts = tlm.init_states(tt, 2, 24, ctx_len=N_CTX, device="cpu", **kw)
    jo = jax_lm_forward(jp, jnp.asarray(toks), jt, states=js, write_kv=True,
                        ctx=jnp.asarray(ctx))
    to = tlm.forward(tp, t(toks).long(), tt, states=ts, write_kv=True,
                     ctx=t(ctx))
    _rel_close(to["logits"], jo["logits"])
    for tl, jl in zip(to["states"]["layers"],
                      jax_state_layers(jo["states"], jt)):
        assert set(tl) == set(jl)
        for name in tl:
            if name != "pt":
                _rel_close(tl[name], jl[name])
    blk = np.random.default_rng(7).integers(0, VOCAB, (2, 5))
    mask = np.tril(np.ones((5, 5), bool))
    mask[3, 1:3] = False
    pos = np.array([[9, 10, 11, 10, 11]] * 2)
    jv = jax_lm_forward(jp, jnp.asarray(blk), jt, states=jo["states"],
                        extra_mask=jnp.asarray(mask),
                        positions=jnp.asarray(pos))
    for impl in ("gather", "kernel"):
        tv = tlm.forward(tp, t(blk).long(),
                         dataclasses.replace(tt, attn_impl=impl),
                         states=to["states"], extra_mask=t(mask),
                         positions=t(pos))
        _rel_close(tv["logits"], jv["logits"])


def test_cross_cache_must_fit_the_context():
    tcfg = port_model_cfg(ModelConfig(num_layers=2, cross_attn_every=2,
                                      dtype="float32", **BASE))
    tp = tlm.lm_init(tcfg, device="cpu")
    states = tlm.init_states(tcfg, 1, 16, ctx_len=3, device="cpu")
    with pytest.raises(ValueError, match="ctx_len=4"):
        tlm.forward(tp, torch.zeros((1, 2), dtype=torch.long), tcfg,
                    states=states, write_kv=True, ctx=torch.zeros((1, 4, 64)))


# ----------------------------------------------------------- the encoder --
def _whisper(**over):
    return dataclasses.replace(jget("whisper-medium", smoke=True),
                               dtype="float32", **over)


@functools.lru_cache(maxsize=None)
def _whisper_params():
    jcfg = _whisper()
    jp = jax.jit(jenc.encdec_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    return jp, convert.convert_encdec(np_tree(jp), port_model_cfg(jcfg),
                                      device="cpu")


@pytest.mark.parametrize("frames", [32, 1100])
def test_encode_matches_jax(frames):
    """Whisper's smoke encoder: 32 frames attend densely; 1100 frames
    (1100^2 > 256 * 1024) attend in 1024-key chunks, JAX's last chunk
    zero-padded (76 real keys of 1024), the port's short."""
    jcfg = _whisper(enc_max_len=frames)
    jp, tp = _whisper_params()
    feats = _rand(8, 2, frames, jcfg.d_model)
    want = jax.jit(jenc.encode, static_argnums=2)(jp["encoder"],
                                                  jnp.asarray(feats), jcfg)
    got = tenc.encode(tp["encoder"], t(feats), port_model_cfg(jcfg))
    _rel_close(got, want)


def test_non_causal_chunked_attention_pads_like_jax():
    """The encoder's read: non-causal chunked attention without
    ``kv_len``, over a key count that ``kv_chunk`` does not divide."""
    q, k, v = (_rand(s, 2, 9, 4, 16) if s == 0 else _rand(s, 2, 23, 2, 16)
               for s in range(3))
    kw = dict(causal=False, q_offset=0, kv_chunk=7)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.attend_chunked(t(q), t(k), t(v), **kw)
    _rel_close(got, want)
    dense = tattn.attend(t(q), t(k), t(v), causal=False, impl="dense")
    _rel_close(got, dense.numpy())


# ------------------------------------------------------------- decoding ---
def _target(name):
    if name == "vlm":
        return tiny_target(vocab=VOCAB, dtype="float32", cross_attn_every=2,
                           num_vision_tokens=N_CTX)
    return _whisper()


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX and port bundles, prompts and context of a tiny cross target,
    and JAX's (generate tokens, n_cycles, greedy tokens)."""
    jt = _target(name)
    jd = tiny_drafter(vocab=jt.vocab_size, gamma=GAMMA, dtype="float32",
                      target_cfg=jt)
    if name == "vlm":
        tp = jax_lm_init(jax.random.PRNGKey(0), jt)
        ctx = jnp.asarray(_rand(4, 3, N_CTX, jt.d_model))
        ttp = port_lm(tp, port_model_cfg(jt))
    else:
        jp, tw = _whisper_params()
        tp, ttp = jp["decoder"], tw["decoder"]
        ctx = jax.jit(jenc.encode, static_argnums=2)(
            jp["encoder"], jnp.asarray(_rand(4, 3, jt.enc_max_len,
                                             jt.d_model)), jt)
    d1 = jax_drafter_init(jax.random.PRNGKey(1), jd)
    d2 = jax_drafter_init(jax.random.PRNGKey(2), jd)
    spec = dict(gamma=GAMMA, top_k_branches=K)
    jb = jpl.SpecBundle(jt, jd, jd, JSpec(**spec), tp, d1, d2)
    tt, td = port_model_cfg(jt), port_drafter_cfg(jd)
    tb = tpl.SpecBundle(tt, td, td, SpecConfig(**spec), ttp,
                        port_drafter(d1), port_drafter(d2))
    prompts = np.random.default_rng(3).integers(
        0, jt.vocab_size, (3, 8)).astype(np.int32)
    out = jpl.generate(jb, jnp.asarray(prompts), max_new=MAX_NEW,
                       key=jax.random.PRNGKey(7), ctx=ctx)
    # plain greedy with the context: a prefill with ``ctx`` (which writes
    # the cross caches), then one-token steps that read them
    ref = jax_greedy(tp, jt, jnp.asarray(prompts), MAX_NEW, ctx=ctx)
    return jb, tb, prompts, np.asarray(ctx), (
        np.asarray(out["tokens"]), int(out["n_cycles"]), ref)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("name", ["vlm", "whisper"])
def test_generate_with_ctx_matches_jax_and_greedy(name, cache_impl, impl):
    """``generate(ctx=)`` on a tiny VLM (image embeddings) and a tiny
    whisper (the encoder's output over 32 frames): tokens equal JAX's and
    a plain greedy that prefills with the context, cycles equal JAX's."""
    _, tb, prompts, ctx, (jtok, jcycles, ref) = _case(name)
    np.testing.assert_array_equal(jtok, ref)
    out = tpl.generate(tpl.with_attn_impl(tb, impl), prompts, MAX_NEW,
                       ctx=t(ctx), cache_impl=cache_impl, page_size=8,
                       device="cpu")
    np.testing.assert_array_equal(out["tokens"], jtok)
    assert out["n_cycles"] == jcycles


def test_prefill_steps_match_jax():
    """``launch/steps.py``: ``ctx_len_for`` and the whisper and VLM
    prefill steps (encode then prefill with the encoder's output, or
    prefill with the image embeddings): anchors and cross caches."""
    for name in ("vlm", "whisper"):
        jb, tb, prompts, _, _ = _case(name)
        jt, tt = jb.target_cfg, tb.target_cfg
        n = tsteps.ctx_len_for(tt)
        assert n == jsteps.ctx_len_for(jt) > 0
        feats = _rand(9, 3, n, jt.d_model)
        jest = jpl.engine_init(jb, 3, 32, ctx_len=n)
        test = tstate.engine_init(tb, 3, 32, ctx_len=n, device="cpu")
        if name == "whisper":
            jp, tp = _whisper_params()
            jst = jsteps.make_prefill_step(jt)(
                jp["encoder"], jb, jest, jnp.asarray(prompts),
                jnp.asarray(feats))
            tst = tsteps.make_prefill_step(tt)(
                tp["encoder"], tb, test, t(prompts).long(), t(feats))
        else:
            jst = jsteps.make_prefill_step(jt)(jb, jest, jnp.asarray(prompts),
                                               jnp.asarray(feats))
            tst = tsteps.make_prefill_step(tt)(tb, test, t(prompts).long(),
                                               t(feats))
        np.testing.assert_array_equal(tst.anchor.numpy(),
                                      np.asarray(jst.anchor))
        for tl, jl in zip(tst.target["layers"],
                          jax_state_layers(jst.target, jt)):
            if "ck" in jl:
                _rel_close(tl["ck"], jl["ck"])
                _rel_close(tl["cv"], jl["cv"])
    assert tsteps.ctx_len_for(port_model_cfg(tiny_target())) == 0


def test_serving_engine_quirk_cross_target():
    """JAX's engine allocates the cross caches without ``ctx_len`` and
    prefills without ``ctx``: it serves a cross target against a zero
    cross cache, so its tokens are plain greedy with no context, not
    with one. A context of zeros reads the same (keys and values without
    bias are zero, so every cross read is zero). The port's engine
    refuses such a target (ROADMAP.md queue 3)."""
    from repro.serving.engine import ServingEngine as JEngine
    jb, tb, prompts, ctx, (_, _, with_ctx) = _case("vlm")
    eng = JEngine(jb, batch_size=2)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    eng.run()
    served = np.stack([r.out for r in sorted(eng.done, key=lambda r: r.uid)])
    no_ctx = jax_greedy(jb.target_params, jb.target_cfg,
                        jnp.asarray(prompts), MAX_NEW,
                        ctx=jnp.zeros(ctx.shape, jnp.float32))
    np.testing.assert_array_equal(served, no_ctx)
    assert (served != with_ctx).any()
    with pytest.raises(ValueError, match="cross-attention"):
        TEngine(tb, batch_size=2, device="cpu")

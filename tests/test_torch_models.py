"""The port's model layers (``repro_torch.models``) held to their JAX twins.

Per-op checks first (norms, RoPE, softcap, MLP, projections, masks, the
plain attention paths, page pools, rolling writes), then ``lm.forward``
logits and drafter features through prefill, a tree-masked verify step,
a ragged KV commit and a second verify step, over dense and paged caches
and through both read paths (``gather``, and ``kernel``, which on CPU
tensors runs the cascade kernels' plain versions). Weights go through
``repro_torch.convert``; inputs come from a numpy seed; everything is
float32, atol 1e-5 (the two packages differ only in summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_target

from _torch_parity import (ATOL, close, jax_lm_forward, jax_lm_init, port_lm,
                           port_model_cfg, t)
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import kvcache as jkv
from repro.models import layers as jlay
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tlay
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------------- ops -----
def _op_rmsnorm(rng):
    x, s = _rand(rng, 2, 5, 64), _rand(rng, 64)
    return (jlay.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6),
            tlay.rmsnorm({"scale": t(s)}, t(x), 1e-6))


def _op_rope(rng):
    x = _rand(rng, 2, 5, 4, 16)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    return (jlay.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
            tlay.apply_rope(t(x), t(pos), 1e6))


def _op_softcap(rng):
    x = _rand(rng, 3, 7, scale=40.0)
    return jlay.softcap(jnp.asarray(x), 20.0), tlay.softcap(t(x), 20.0)


def _op_mlp(rng, act="silu", gated=True):
    x = _rand(rng, 2, 5, 32)
    p = {"w_in": _rand(rng, 32, 48, scale=0.2),
         "w_out": _rand(rng, 48, 32, scale=0.2)}
    if gated:
        p["w_gate"] = _rand(rng, 32, 48, scale=0.2)
    return (jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), act, gated),
            tmlp.mlp({k: t(v) for k, v in p.items()}, t(x), act, gated))


def _op_project_qkv(rng):
    jcfg = tiny_target(dtype="float32", qk_norm=True, qkv_bias=True,
                       rope_theta=1e6)
    tcfg = port_model_cfg(jcfg)
    d, hq, hkv, dh = 64, 4, 2, 16
    p = {"wq": _rand(rng, d, hq * dh, scale=0.1),
         "wk": _rand(rng, d, hkv * dh, scale=0.1),
         "wv": _rand(rng, d, hkv * dh, scale=0.1),
         "bq": _rand(rng, hq * dh), "bk": _rand(rng, hkv * dh),
         "bv": _rand(rng, hkv * dh), "q_norm": _rand(rng, dh),
         "k_norm": _rand(rng, dh)}
    x = _rand(rng, 2, 5, d)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    jq = jattn.project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jcfg, jnp.asarray(pos))
    tq = tattn.project_qkv({k: t(v) for k, v in p.items()}, t(x), tcfg,
                           t(pos))
    return jnp.concatenate([a.reshape(-1) for a in jq]), torch.cat(
        [a.reshape(-1) for a in tq])


OPS = {"rmsnorm": _op_rmsnorm, "rope": _op_rope, "softcap": _op_softcap,
       "swiglu": _op_mlp,
       "gelu_plain": lambda rng: _op_mlp(rng, "gelu", False),
       "project_qkv": _op_project_qkv}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    want, got = OPS[name](np.random.default_rng(7))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


MASK_CASES = [
    dict(tq=5, tkv=9, causal=True, q_offset=3),
    dict(tq=5, tkv=9, causal=True, q_offset=np.array([2, 4]), window=3,
         kv_len=np.array([7, 9])),
    dict(tq=4, tkv=6, causal=False, q_offset=0, kv_len=5),
    dict(tq=6, tkv=6, causal=True, q_offset=0, window=2),
]


@pytest.mark.parametrize("i", range(len(MASK_CASES)))
def test_make_attention_mask_matches_jax(i):
    kw = dict(MASK_CASES[i])
    tq, tkv = kw.pop("tq"), kw.pop("tkv")
    want = jattn.make_attention_mask(
        tq, tkv, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()})
    got = tattn.make_attention_mask(
        tq, tkv, **{k: (t(v) if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attend_dense_chunked_and_merge_match_jax():
    rng = np.random.default_rng(11)
    q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 20, 2, 16), \
        _rand(rng, 2, 20, 2, 16)
    q_off, kv_len = np.array([10, 14]), np.array([17, 20])
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = t(q), t(k), t(v)
    # dense with a mask and a softcap
    jm = jattn.make_attention_mask(6, 20, causal=True,
                                   q_offset=jnp.asarray(q_off), window=8,
                                   kv_len=jnp.asarray(kv_len))
    close(tattn.attend_dense(tq, tk, tv, t(jm), attn_softcap=30.0),
          jattn.attend_dense(jq, jk, jv, jm, attn_softcap=30.0))
    # chunked, normalized and as flash stats
    kw = dict(causal=True, window=8, kv_chunk=8)
    close(tattn.attend_chunked(tq, tk, tv, q_offset=t(q_off),
                               kv_len=t(kv_len), **kw),
          jattn.attend_chunked(jq, jk, jv, q_offset=jnp.asarray(q_off),
                               kv_len=jnp.asarray(kv_len), **kw))
    halves = []
    for lo, hi in ((0, 16), (16, 20)):
        jst = jattn.attend_chunked(
            jq, jk[:, lo:hi], jv[:, lo:hi], q_offset=jnp.asarray(q_off),
            kv_len=jnp.asarray(kv_len), return_stats=True, key_offset=lo,
            **kw)
        tst = tattn.attend_chunked(
            tq, tk[:, lo:hi], tv[:, lo:hi], q_offset=t(q_off),
            kv_len=t(kv_len), return_stats=True, key_offset=lo, **kw)
        live = np.asarray(jst[1]) > -1e30     # rows with a key in range
        for a, b in zip(tst, jst):
            close(a.numpy()[live], np.asarray(b)[live])
        halves.append((jst, tst))
    close(tattn.merge_attn_stats([h[1] for h in halves], q.shape,
                                 torch.float32),
          jattn.merge_attn_stats([h[0] for h in halves], q.shape,
                                 jnp.float32))


def test_attend_chunked_stats_ignore_chunk_padding():
    """A key shard whose length is not a multiple of ``kv_chunk``, with
    ``kv_len`` past its end: the JAX twin zero-pads the last chunk and
    lets the padded keys in (their positions pass the ``kv_len`` and
    causal masks), the port has no padded keys. The port is held to JAX
    with a chunk that needs no padding (ROADMAP.md queue 3)."""
    rng = np.random.default_rng(11)
    q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 12, 2, 16), \
        _rand(rng, 2, 12, 2, 16)
    q_off, kv_len = np.array([10, 14]), np.array([17, 20])
    kw = dict(causal=True, window=8, return_stats=True)
    got = tattn.attend_chunked(t(q), t(k), t(v), q_offset=t(q_off),
                               kv_len=t(kv_len), kv_chunk=8, **kw)
    want = jattn.attend_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
        kv_chunk=12, **kw)
    for a, b in zip(got, want):
        close(a, b)


CPB_CASES = [
    # (rolling, cap, cache_len, window, batched tree mask)
    (False, 16, 9, None, False),
    (False, 16, (5, 12), 4, True),
    (True, 8, (5, 13), 6, True),
    (True, 7, (20, 7), None, False),
]


@pytest.mark.parametrize("i", range(len(CPB_CASES)))
def test_attend_cache_plus_block_matches_jax(i):
    """The gather read path over [cache ++ block], with rolling position
    recovery (floored mod here, as jnp.mod) at wrapped lengths."""
    rolling, cap, clen, window, batched = CPB_CASES[i]
    rng = np.random.default_rng(20 + i)
    b, tb = 2, 5
    q = _rand(rng, b, tb, 4, 16)
    kk, vv = _rand(rng, b, cap + tb, 2, 16), _rand(rng, b, cap + tb, 2, 16)
    clen = np.asarray(clen, np.int32)
    base = clen if clen.ndim else np.full((b,), clen)
    q_abs = (base[:, None] + np.arange(tb)).astype(np.int32)
    if not clen.ndim:
        q_abs = q_abs[0]
    mask = None
    if batched:
        mask = np.tril(np.ones((tb, tb), bool)) & (rng.random((b, tb, tb))
                                                   < 0.6)
        mask |= np.eye(tb, dtype=bool)
    kw = dict(cache_cap=cap, window=window, attn_softcap=None, impl="auto",
              kv_chunk=1024, rolling=rolling)
    want = jattn.attend_cache_plus_block(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
        cache_len=jnp.asarray(clen), q_abs=jnp.asarray(q_abs),
        extra_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = tattn.attend_cache_plus_block(
        t(q), t(kk), t(vv), cache_len=t(clen), q_abs=t(q_abs),
        extra_mask=None if mask is None else t(mask), **kw)
    close(got, want)


def test_pool_view_and_scatter_match_jax():
    """Sentinel entries clamp on read; writes off the table, onto
    unallocated pages or marked invalid are dropped."""
    rng = np.random.default_rng(5)
    n_phys, page = 6, 4
    pool = _rand(rng, n_phys, page, 2, 8)
    table = np.array([[3, 0, tkv.PAGE_SENTINEL], [5, 1, 2]], np.int32)
    assert tkv.PAGE_SENTINEL == jkv.PAGE_SENTINEL
    close(tkv.pool_view(t(pool), t(table)),
          jkv.pool_view(jnp.asarray(pool), jnp.asarray(table)))
    new = _rand(rng, 2, 5, 2, 8)
    pos = np.array([[2, 5, 9, 12, -1], [0, 7, 11, 3, 4]], np.int32)
    valid = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 1]], bool)
    want = jkv.pool_scatter(jnp.asarray(pool), jnp.asarray(table),
                            jnp.asarray(new), jnp.asarray(pos),
                            jnp.asarray(valid))
    got = tkv.pool_scatter_(t(pool), t(table), t(new), t(pos), t(valid))
    close(got, want)
    # stacked [L, P, page, H, D] (the drafters' feature pools)
    pool_l = _rand(rng, 2, n_phys, page, 2, 8)
    new_l = _rand(rng, 2, 2, 5, 2, 8)
    close(tkv.pool_scatter_(t(pool_l), t(table), t(new_l), t(pos)),
          jkv.pool_scatter(jnp.asarray(pool_l), jnp.asarray(table),
                           jnp.asarray(new_l), jnp.asarray(pos)))
    close(tkv.pool_view(t(pool_l), t(table)),
          jkv.pool_view(jnp.asarray(pool_l), jnp.asarray(table)))


@pytest.mark.parametrize("rolling,t_new,start", [
    (False, 3, (2, 5)), (True, 3, (6, 7)), (True, 9, (1, 4))])
def test_scatter_kv_matches_jax(rolling, t_new, start):
    rng = np.random.default_rng(3)
    buf, new = _rand(rng, 2, 8, 2, 4), _rand(rng, 2, t_new, 2, 4)
    start = np.asarray(start, np.int32)
    want = jblocks._scatter_kv(jnp.asarray(buf), jnp.asarray(new),
                               jnp.asarray(start), rolling)
    got = tblocks._scatter_kv_(t(buf), t(new), t(start), rolling)
    close(got, want)


# ------------------------------------------------------------ lm.forward ---
LM_CFGS = {
    "global": lambda: tiny_target(dtype="float32"),
    # local/global hybrid: rolling local caches (cap 8) wrap in prefill
    "hybrid": lambda: tiny_target(dtype="float32",
                                  layer_pattern=("local", "global"),
                                  sliding_window=8, attn_softcap=30.0,
                                  use_post_norm=True, logit_softcap=20.0),
}


# Features are the residual stream (|x| up to ~10 with post-norms), so
# they are held at atol 1e-5 plus 1e-5 of their magnitude: float32
# rounding over the layers, summed in another order by each package.
FEAT_RTOL = 1e-5


def _tree_inputs(rng, b, tb, vocab, base):
    toks = rng.integers(0, vocab, (b, tb)).astype(np.int32)
    mask = np.tril(np.ones((tb, tb), bool)) & (rng.random((b, tb, tb)) < 0.6)
    mask |= np.eye(tb, dtype=bool)
    depth = mask.sum(-1) - 1
    return toks, mask, (np.asarray(base)[:, None] + depth).astype(np.int32)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("cfg_name", sorted(LM_CFGS))
def test_lm_forward_matches_jax(cfg_name, cache_impl):
    jcfg = LM_CFGS[cfg_name]()
    tcfg = port_model_cfg(jcfg)
    jp = jax_lm_init(jax.random.PRNGKey(0), jcfg)
    tp = port_lm(jp, tcfg)
    rng = np.random.default_rng(1)
    b, p, tb, max_len = 2, 12, 5, 40
    prompts = rng.integers(0, jcfg.vocab_size, (b, p)).astype(np.int32)
    skw = dict(cache_impl=cache_impl, page_size=8)
    js = jlm.init_states(jcfg, b, max_len, dtype=jnp.float32, **skw)
    ts = tlm.init_states(tcfg, b, max_len, dtype=torch.float32,
                         device="cpu", **skw)
    jo = jax_lm_forward(jp, jnp.asarray(prompts), jcfg, states=js,
                     write_kv=True, want_features=True, remat=False)
    to = tlm.forward(tp, t(prompts), tcfg, states=ts, write_kv=True,
                     want_features=True)
    close(to["logits"], jo["logits"])
    close(to["features"], jo["features"], rtol=FEAT_RTOL)
    assert to["features"].shape[-1] == tlm.feature_dim(tcfg)

    jstates, tstates, base = jo["states"], to["states"], np.full((b,), p)
    for step in range(2):
        toks, mask, pos = _tree_inputs(rng, b, tb, jcfg.vocab_size, base)
        jv = jax_lm_forward(jp, jnp.asarray(toks), jcfg, states=jstates,
                         extra_mask=jnp.asarray(mask),
                         positions=jnp.asarray(pos), want_features=True,
                         remat=False)
        outs = {}
        for impl in ("gather", "kernel"):
            cfg_i = port_model_cfg(jcfg, attn_impl=impl)
            outs[impl] = tlm.forward(tp, t(toks), cfg_i, states=tstates,
                                     extra_mask=t(mask), positions=t(pos),
                                     want_features=True)
            close(outs[impl]["logits"], jv["logits"])
            close(outs[impl]["features"], jv["features"], rtol=FEAT_RTOL)
        # commit a ragged path: 3 tokens on row 0, 1 on row 1
        path = np.tile(np.arange(3, dtype=np.int32), (b, 1))
        n_commit = np.array([3, 1], np.int32)
        jstates = jlm.commit_kv(jstates, jv["kv_outs"], jcfg,
                                jnp.asarray(path), jnp.asarray(n_commit))
        tstates = tlm.commit_kv(tstates, outs["gather"]["kv_outs"], tcfg,
                                t(path), t(n_commit))
        np.testing.assert_array_equal(tstates["length"].numpy(),
                                      np.asarray(jstates["length"]))
        base = np.asarray(jstates["length"])


def test_lm_forward_replay_write_matches_jax():
    """Replay mode (``attend_cache_on_write``): one token at a time over
    the cache, as the plain greedy reference decodes."""
    jcfg = LM_CFGS["hybrid"]()
    tcfg = port_model_cfg(jcfg)
    jp = jax_lm_init(jax.random.PRNGKey(2), jcfg)
    tp = port_lm(jp, tcfg)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    js = jlm.init_states(jcfg, 2, 20, dtype=jnp.float32)
    ts = tlm.init_states(tcfg, 2, 20, dtype=torch.float32, device="cpu")
    jo = jax_lm_forward(jp, jnp.asarray(prompts), jcfg, states=js,
                     write_kv=True, remat=False)
    to = tlm.forward(tp, t(prompts), tcfg, states=ts, write_kv=True)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jo["logits"][:, -1], -1)).astype(np.int32)
        assert np.array_equal(tok, to["logits"][:, -1].argmax(-1).numpy())
        jo = jax_lm_forward(jp, jnp.asarray(tok[:, None]), jcfg,
                         states=jo["states"], write_kv=True,
                         attend_cache_on_write=True, remat=False)
        to = tlm.forward(tp, t(tok[:, None]), tcfg, states=to["states"],
                         write_kv=True, attend_cache_on_write=True)
        close(to["logits"], jo["logits"], atol=ATOL)

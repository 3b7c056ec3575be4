"""The port's recurrent blocks held to the JAX package: ``models/rglru.py``
(RG-LRU) and ``models/rwkv.py`` (RWKV-6 time-mix and channel-mix), the
``recurrent`` and ``rwkv`` kinds of ``models/blocks.py`` and
``lm.forward`` over their states.

* each block's outputs and new states against its JAX twin on the same
  params, inputs and carried states (numpy seeds), with and without
  ``snap_at``, at ``ATOL`` 1e-5 in fp32;
* ``time_mix``'s chunked path against its scan (the mirror of
  ``tests/test_models.py::test_rwkv_chunked_equals_scan``) and against
  JAX's chunked path;
* the mirrors of ``tests/test_models.py``'s hybrid-tail and rwkv-stack
  decode-vs-full consistency and ``test_snap_at_state_advance``;
* a prefill of a padded prompt (``snap_at``) and a decode pass through the
  whole stack for both families, logits, features and every state leaf vs
  JAX within ``ATOL`` 1e-5 of each array's largest magnitude (the
  residual stream grows past 1, and XLA and torch sum the matmuls in
  different orders).

float32 unless stated, tiny shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (close, jax_lm_forward, jax_lm_init,
                           jax_state_layers, np_tree, port_lm,
                           port_model_cfg, t)
from repro.config.base import ModelConfig
from repro.models import lm as jlm
from repro.models import rglru as jrg
from repro.models import rwkv as jrw
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv as trw

BASE = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
            max_seq_len=64, remat=False)
HYBRID = dict(num_layers=5, layer_pattern=("recurrent", "recurrent", "local"),
              sliding_window=8)
RWKV = dict(num_layers=4, layer_pattern=("rwkv",), rwkv_head_dim=16)


def _tp(tree):
    return convert._tree(np_tree(tree), lambda a: convert.to_tensor(a, "cpu"))


def _close_scaled(got, want, tol=1e-5):
    close(got, want, atol=tol * max(1.0, float(np.abs(np.asarray(
        want, np.float32)).max(initial=0.0))))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- RG-LRU --
@pytest.mark.parametrize("t_len,snap", [(7, None), (7, (3, 7)), (1, None),
                                        (5, (0, 1))])
def test_rglru_block_matches_jax(t_len, snap):
    cfg = ModelConfig(dtype="float32", rglru_width=48, conv1d_width=4,
                      **HYBRID, **BASE)
    jp = jrg.rglru_block_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(t_len)
    x = _rand(rng, 2, t_len, 64)
    st = {"rg_h": _rand(rng, 2, 48), "conv_buf": _rand(rng, 2, 3, 48)}
    sa = None if snap is None else np.asarray(snap, np.int32)
    jy, jst = jrg.rglru_block(jp, jnp.asarray(x), cfg,
                              state=jax.tree.map(jnp.asarray, st),
                              snap_at=None if sa is None else jnp.asarray(sa))
    ty, tst = trg.rglru_block(_tp(jp), t(x), port_model_cfg(cfg),
                              state={k: t(v) for k, v in st.items()},
                              snap_at=None if sa is None else t(sa))
    close(ty, jy)
    for k in trg.STATE_KEYS:
        close(tst[k], jst[k])


# --------------------------------------------------------------- RWKV-6 ---
@pytest.mark.parametrize("t_len,snap,impl", [
    (8, None, "scan"), (8, (3, 8), "scan"), (1, None, "scan"),
    (8, None, "chunked"), (4, (0, 2), "scan")])
def test_time_and_channel_mix_match_jax(t_len, snap, impl):
    cfg = ModelConfig(dtype="float32", **RWKV, **BASE)
    tcfg = port_model_cfg(cfg)
    jtm = jrw.time_mix_init(jax.random.PRNGKey(0), cfg)
    jcm = jrw.channel_mix_init(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(10 + t_len)
    x = _rand(rng, 2, t_len, 64)
    st = {"tm_x_prev": _rand(rng, 2, 64), "tm_s": _rand(rng, 2, 4, 16, 16),
          "cm_x_prev": _rand(rng, 2, 64)}
    sa = None if snap is None else np.asarray(snap, np.int32)
    jsa = None if sa is None else jnp.asarray(sa)
    tsa = None if sa is None else t(sa)
    jy, jst = jrw.time_mix(jtm, jnp.asarray(x), cfg, chunk=4, snap_at=jsa,
                           impl=impl, state={k: jnp.asarray(st[k]) for k in
                                             jrw.TM_STATE_KEYS})
    ty, tst = trw.time_mix(_tp(jtm), t(x), tcfg, chunk=4, snap_at=tsa,
                           impl=impl,
                           state={k: t(st[k]) for k in trw.TM_STATE_KEYS})
    close(ty, jy)
    for k in trw.TM_STATE_KEYS:
        close(tst[k], jst[k])
    jy, jst = jrw.channel_mix(jcm, jnp.asarray(x), cfg, snap_at=jsa,
                              state={"cm_x_prev": jnp.asarray(st["cm_x_prev"])})
    ty, tst = trw.channel_mix(_tp(jcm), t(x), tcfg, snap_at=tsa,
                              state={"cm_x_prev": t(st["cm_x_prev"])})
    close(ty, jy)
    close(tst["cm_x_prev"], jst["cm_x_prev"])


def _wkv_inputs(seed, b=2, t_len=64, h=2, dh=16):
    """The inputs of ``tests/test_models.py::test_rwkv_chunked_equals_scan``
    drawn from a numpy seed: decays from w = exp(-exp(x)) in the regime the
    fp32 factorization supports."""
    rng = np.random.default_rng(seed)
    r, k, v = (_rand(rng, b, t_len, h, dh) for _ in range(3))
    w = np.exp(-np.exp(_rand(rng, b, t_len, h, dh) * 0.5 - 2.0))
    u = _rand(rng, h, dh) * 0.5
    s0 = _rand(rng, b, h, dh, dh) * 0.1
    return r, k, v, w.astype(np.float32), u, s0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rwkv_chunked_equals_scan(seed):
    args = _wkv_inputs(seed)
    targs = [t(a) for a in args]
    o1, s1 = trw._time_mix_scan(*targs)
    o2, s2 = trw.time_mix_chunked(*targs, chunk=16)
    close(o2, o1.numpy(), atol=2e-3, rtol=2e-3)
    close(s2, s1.numpy(), atol=2e-3, rtol=2e-3)
    jo, js = jrw.time_mix_chunked(*map(jnp.asarray, args), chunk=16)
    close(o2, jo, atol=1e-4)
    close(s2, js, atol=1e-4)
    jo, js = jrw._time_mix_scan(*map(jnp.asarray, args))
    close(o1, jo, atol=1e-4)
    close(s1, js, atol=1e-4)


# --------------------------------------------------- the stack, as JAX ----
def _consistency(jcfg, t_len=12, tol=0.15):
    """The port's twin of ``tests/test_models.py::_consistency``: a cached
    prefill of all but the last token, then one decode pass, against the
    full causal pass (bf16, JAX's weights)."""
    jp = jax_lm_init(jax.random.PRNGKey(0), jcfg)
    tcfg = port_model_cfg(jcfg)
    tp = port_lm(jp, tcfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, t_len))).long()
    full = tlm.forward(tp, toks, tcfg)
    assert not torch.isnan(full["logits"].float()).any()
    states = tlm.init_states(tcfg, 2, 32, device="cpu")
    o1 = tlm.forward(tp, toks[:, :-1], tcfg, states=states, write_kv=True)
    o2 = tlm.forward(tp, toks[:, -1:], tcfg, states=o1["states"],
                     write_kv=False)
    d = (o2["logits"][:, -1].float() - full["logits"][:, -1].float()).abs()
    assert float(d.max()) < tol, float(d.max())


def test_hybrid_tail():
    _consistency(ModelConfig(**HYBRID, **BASE))


def test_rwkv_stack():
    _consistency(ModelConfig(**RWKV, **BASE))


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_snap_at_state_advance(family):
    """A pass with snap_at = n leaves every recurrent state as stepping
    the first n tokens would (the mirror of
    ``tests/test_models.py::test_snap_at_state_advance``, for both
    families), and advances each row's length by its n."""
    extra = dict(RWKV, num_layers=3) if family == "rwkv" else HYBRID
    cfg = port_model_cfg(ModelConfig(dtype="float32", **extra, **BASE))
    p = tlm.lm_init(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, 97, (2, 8))).long()
    n_keep = [3, 5]
    out = tlm.forward(p, toks, cfg, states=tlm.init_states(
        cfg, 2, 32, device="cpu"), write_kv=True,
        snap_at=torch.tensor(n_keep), attend_cache_on_write=True)
    for i, n in enumerate(n_keep):
        oi = tlm.forward(p, toks[i:i + 1, :n], cfg, states=tlm.init_states(
            cfg, 1, 32, device="cpu"), write_kv=True)
        for kind, got, ref in zip(cfg.pattern_for_depth(),
                                  out["states"]["layers"],
                                  oi["states"]["layers"]):
            if kind in ("recurrent", "rwkv"):
                for name in ref:
                    close(got[name][i], ref[name][0].numpy())
        assert int(out["states"]["length"][i]) == n


@pytest.mark.parametrize("family", ["rwkv", "hybrid"])
def test_forward_states_match_jax(family):
    """A prefill of prompts padded to one length (``snap_at`` = each row's
    real length), then a 4-token read-only pass and a 3-token write pass
    from the committed states: logits, features and every state leaf of
    the port against JAX."""
    extra = RWKV if family == "rwkv" else HYBRID
    jcfg = ModelConfig(dtype="float32", **extra, **BASE)
    tcfg = port_model_cfg(jcfg)
    jp = jax_lm_init(jax.random.PRNGKey(0), jcfg)
    tp = port_lm(jp, tcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 97, (2, 12)).astype(np.int32)
    true_len = np.asarray([12, 9], np.int32)
    js = jlm.init_states(jcfg, 2, 32, dtype=jnp.float32)
    ts = tlm.init_states(tcfg, 2, 32, device="cpu")

    def both(tok, write, snap=None, acw=False):
        nonlocal js, ts
        jo = jax_lm_forward(jp, jnp.asarray(tok), jcfg, states=js,
                            write_kv=write, want_features=True,
                            attend_cache_on_write=acw,
                            snap_at=None if snap is None else
                            jnp.asarray(snap))
        to = tlm.forward(tp, t(tok).long(), tcfg, states=ts, write_kv=write,
                         want_features=True, attend_cache_on_write=acw,
                         snap_at=None if snap is None else t(snap))
        _close_scaled(to["logits"], jo["logits"])
        _close_scaled(to["features"], jo["features"])
        if write:
            js, ts = jo["states"], to["states"]
            for i, (tl, jl) in enumerate(zip(
                    ts["layers"], jax_state_layers(js, jcfg))):
                assert set(tl) == set(jl), (i, set(tl), set(jl))
                for name in tl:
                    _close_scaled(tl[name], jl[name])
            np.testing.assert_array_equal(ts["length"].numpy(),
                                          np.asarray(js["length"]))

    both(toks, True, true_len)
    both(rng.integers(0, 97, (2, 4)).astype(np.int32), False)
    both(rng.integers(0, 97, (2, 3)).astype(np.int32), True,
         np.asarray([3, 1], np.int32), acw=True)


def test_block_kinds_and_state_leaves():
    """The port's per-layer states carry JAX's leaves, fp32, batch-leading;
    the recurrent configs of the registry resolve."""
    from repro.config.registry import all_archs as jax_archs
    from repro_torch.config.registry import all_archs, get_config
    assert set(all_archs()) == set(jax_archs()) >= {"recurrentgemma-2b",
                                                    "rwkv6-1.6b"}
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b"):
        tc = get_config(arch, smoke=True)
        from repro.config.registry import get_config as jget
        for full in (False, True):
            jc = jget(arch, smoke=not full)
            assert dataclasses.asdict(port_model_cfg(jc)) == \
                dataclasses.asdict(get_config(arch, smoke=not full))
        st = tlm.init_states(dataclasses.replace(tc, dtype="float32"), 3, 16,
                             device="cpu")
        js = jlm.init_states(jget(arch, smoke=True), 3, 16,
                             dtype=jnp.float32)
        for tl, jl in zip(st["layers"],
                          jax_state_layers(js, jget(arch, smoke=True))):
            assert set(tl) == set(jl)
            for name in tl:
                assert tuple(tl[name].shape) == jl[name].shape, name
                if name not in ("k", "v"):
                    assert tl[name].dtype == torch.float32

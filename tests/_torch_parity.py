"""Helpers for the tests that hold the PyTorch port (``repro_torch``) to
the JAX package: configs carried across field by field, params carried
across as numpy through ``repro_torch.convert``, arrays handed over as
numpy. Not a test module (no ``test_`` prefix)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import drafter as jdr
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.config import base as tbase
from repro_torch.core import drafter as tdr

ATOL = 1e-5

# The port's CPU tests move tiny tensors, so torch runs them on one
# thread: pytest's workers, one a core, would otherwise each start a
# thread a core, and those threads spin against each other.
torch.set_num_threads(1)

# The JAX functions compiled once per config: the same values as the
# eager calls, in a fraction of the CPU time.
jax_lm_init = jax.jit(jlm.lm_init, static_argnums=1)
jax_drafter_init = jax.jit(jdr.drafter_init, static_argnums=1)
jax_lm_forward = jax.jit(jlm.forward, static_argnums=2, static_argnames=(
    "write_kv", "want_features", "remat", "attend_cache_on_write"))
jax_extend_feat_cache = jax.jit(jdr.extend_feat_cache, static_argnums=1)
jax_drafter_forward = jax.jit(jdr.drafter_forward, static_argnums=1)


def jax_greedy(jparams, jcfg, prompts, n, ctx=None):
    """JAX plain greedy, one token at a time over a dense cache, as
    ``conftest.pure_greedy`` decodes, through ``jax_lm_forward`` (two
    compiles a config instead of one of ``n`` unrolled steps); with
    ``ctx`` the prefill writes the cross caches and the steps read them.
    [B, n] numpy tokens."""
    b, p = prompts.shape
    states = jlm.init_states(jcfg, b, p + n + 4,
                             ctx_len=0 if ctx is None else ctx.shape[1],
                             dtype=jnp.dtype(jcfg.dtype))
    out = jax_lm_forward(jparams, prompts, jcfg, states=states,
                         write_kv=True, remat=False, ctx=ctx)
    tok = jnp.argmax(out["logits"][:, -1], -1).astype(jnp.int32)
    res = [tok]
    for _ in range(n - 1):
        out = jax_lm_forward(jparams, tok[:, None], jcfg,
                             states=out["states"], write_kv=True,
                             attend_cache_on_write=True, remat=False)
        tok = jnp.argmax(out["logits"][:, -1], -1).astype(jnp.int32)
        res.append(tok)
    return np.asarray(jnp.stack(res, 1))


def t(x):
    """numpy/JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def _fields(jcfg, **over):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    impl = kw.get("attn_impl")
    kw["attn_impl"] = "kernel" if impl == "pallas" else "gather"
    kw.update(over)
    return kw


def port_model_cfg(jcfg, **over):
    """The port's ModelConfig with the JAX config's values; the read path
    ``pallas`` maps to ``kernel``."""
    kw = _fields(jcfg, **over)
    kw["family"] = tbase.Family(jcfg.family.value)
    if jcfg.moe is not None:
        kw["moe"] = tbase.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return tbase.ModelConfig(**kw)


def port_drafter_cfg(jdcfg, **over):
    return tdr.DrafterConfig(**_fields(jdcfg, **over))


def port_lm(jparams, tcfg):
    return convert.convert_lm(np_tree(jparams), tcfg, device="cpu")


def port_drafter(jparams):
    return convert.convert_drafter(np_tree(jparams), device="cpu")


def close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def port_bundle(jbundle):
    """The port's SpecBundle holding the JAX bundle's configs and weights
    (the read path ``gather``; ``pipeline.with_attn_impl`` switches it)."""
    import dataclasses as dc

    from repro_torch.config.base import SpecConfig
    from repro_torch.core import pipeline as tpl
    tt = port_model_cfg(jbundle.target_cfg)
    t1 = port_drafter_cfg(jbundle.d1_cfg)
    t2 = port_drafter_cfg(jbundle.d2_cfg)
    spec = SpecConfig(**{f.name: getattr(jbundle.spec, f.name)
                         for f in dc.fields(jbundle.spec)})
    return tpl.SpecBundle(tt, t1, t2, spec, port_lm(jbundle.target_params, tt),
                          port_drafter(jbundle.d1_params),
                          port_drafter(jbundle.d2_params))


def port_greedy(bundle, prompt, n):
    """Plain greedy decoding of one prompt [P] through the port's target,
    one token at a time over a dense cache (the port's twin of
    ``conftest.pure_greedy``): [n] numpy tokens."""
    from repro_torch.models import lm as tlm
    cfg, params = bundle.target_cfg, bundle.target_params
    toks = torch.as_tensor(np.array(prompt)).long()[None]
    states = tlm.init_states(cfg, 1, toks.shape[1] + n + 4, device="cpu")
    out = tlm.forward(params, toks, cfg, states=states, write_kv=True)
    res = []
    for _ in range(n):
        tok = torch.argmax(out["logits"][:, -1].float(), -1)
        res.append(int(tok[0]))
        if len(res) == n:
            break
        out = tlm.forward(params, tok[:, None], cfg, states=out["states"],
                          write_kv=True, attend_cache_on_write=True)
    return np.asarray(res, np.int64)


def clone_state(state):
    """A copy of every tensor of a port ``EngineState``, tensors shared
    between leaves (the page table) staying shared."""
    memo = {}

    def cp(x):
        if isinstance(x, dict):
            return {k: cp(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cp(v) for v in x]
        if id(x) not in memo:
            memo[id(x)] = x.clone()
        return memo[id(x)]

    return dataclasses.replace(state, target=cp(state.target),
                               d1_feat=cp(state.d1_feat),
                               d2_feat=cp(state.d2_feat),
                               anchor=cp(state.anchor),
                               active=cp(state.active))


def jax_state_layers(jtarget, cfg):
    """The JAX target state's per-layer cache dicts (numpy), in depth
    order: the scanned periods' stacked leaves split into layers, then
    the tail layers; the port's ``target["layers"]`` layout."""
    from repro.models.blocks import period_spec
    spec, n_per, _ = period_spec(cfg)
    plen = len(spec)
    out = [None] * cfg.num_layers
    for j in range(plen if n_per else 0):
        for per in range(n_per):
            out[per * plen + j] = {k: np.asarray(v)[per]
                                   for k, v in jtarget[f"p{j}"].items()}
    for i in range(cfg.num_layers - n_per * plen):
        out[n_per * plen + i] = {k: np.asarray(v)
                                 for k, v in jtarget[f"tail{i}"].items()}
    return out


def assert_state_matches(tstate, jstate, cfg, tol=1e-6):
    """Every leaf of the port's EngineState against the JAX one: page
    tables, lengths and anchors exactly, caches (raw pools when paged)
    within ``tol`` of the leaf's largest magnitude (XLA and torch sum the
    matmuls in different orders)."""
    def leaf(got, want, name):
        got = got.detach().cpu().numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.floating):
            scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
            np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)

    for i, (tl, jl) in enumerate(zip(tstate.target["layers"],
                                     jax_state_layers(jstate.target, cfg))):
        assert set(tl) == set(jl), (i, set(tl), set(jl))
        for name in tl:
            leaf(tl[name], jl[name], f"layer {i} {name}")
    leaf(tstate.target["length"], jstate.target["length"], "length")
    for feat in ("d1_feat", "d2_feat"):
        td, jd = getattr(tstate, feat), getattr(jstate, feat)
        assert set(td) == set(jd), (feat, set(td), set(jd))
        for name in td:
            leaf(td[name], jd[name], f"{feat} {name}")
    leaf(tstate.anchor, jstate.anchor, "anchor")
    leaf(tstate.active, jstate.active, "active")

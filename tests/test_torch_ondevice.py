"""The port's on-device decode loop (``repro_torch.core.pipeline.
generate_ondevice``) and the fixed-shape writes it rests on, held to the
JAX package.

On a card every cycle after the first is one replay of a CUDA graph of
``OnDeviceLoop.step``; on the CPU the same step runs eagerly in the same
loop, so these tests run the code the graph captures:

* ``generate_ondevice`` is token-identical to JAX ``generate_ondevice``
  and ``generate``, to the port's ``generate`` and to plain greedy, with
  JAX's ``n_cycles`` and ``alpha``, for ``d2sd`` and ``dflash`` on dense
  and paged caches through both read paths; with ``chip_smoke.py``'s
  oracle drafts (several tokens a cycle, through branch rows) alpha is
  the oracle's count and the committed caches equal a plain prefill;
* every cache write of the cycle (``lm.commit_kv``,
  ``drafter.extend_feat_cache``, ``blocks._scatter_kv_``, and through them
  ``kvcache.pool_scatter_``) is bit-equal to its JAX ``mode="drop"`` twin
  on inputs built to break it: inactive rows, a batch with no row active,
  positions at or past capacity, a rolling buffer that wraps, sentinel
  page entries, and a valid write to the last physical page, where
  another row's sentinel entries would clamp;
* one step makes no device-to-host sync and no tensor from host data
  (what a CUDA graph cannot capture): no ``nonzero``, scalar read,
  ``masked_select``, ``lift_fresh`` or boolean-mask indexing.

float32, tiny shapes, inputs from a numpy seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_target
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import port_model_cfg, t
from repro.config.base import SpecConfig as JSpec
from repro.core import drafter as jdr
from repro.core import pipeline as jpl
from repro.models import blocks as jblocks
from repro.models import kvcache as jkv
from repro.models import lm as jlm
from repro_torch.config.base import SpecConfig
from repro_torch.core import drafter as tdr
from repro_torch.core import pipeline as tpl
from repro_torch.core.state import engine_init, prefill
from repro_torch.models import blocks as tblocks
from repro_torch.models import kvcache as tkv
from repro_torch.models import lm as tlm
from test_torch_modes import bundle_for
from test_torch_pipeline import (GAMMA, K, MAX_NEW, _chip_smoke,
                                 _greedy_tokens, _jax_tokens, _models,
                                 _prompts)

SENT = tkv.PAGE_SENTINEL


def _bundle(mode, impl, third_level=False):
    _, (tt, td, tp, d1, d2) = _models()
    return tpl.with_attn_impl(tpl.SpecBundle(tt, td, td, SpecConfig(
        gamma=GAMMA, top_k_branches=K, mode=mode, third_level=third_level),
        tp, d1, d2), impl)


@functools.lru_cache(maxsize=None)
def _jax_ondevice(mode, cache_impl):
    (jt, jd, tp, d1, d2), _ = _models()
    out = jpl.generate_ondevice(
        jpl.SpecBundle(jt, jd, jd, JSpec(gamma=GAMMA, top_k_branches=K,
                                         mode=mode), tp, d1, d2),
        jnp.asarray(_prompts()), MAX_NEW, cache_impl=cache_impl,
        page_size=8)
    return np.asarray(out["tokens"]), out["n_cycles"], out["alpha"]


# ------------------------------------------------------------ the loop ---
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["d2sd", "dflash"])
def test_generate_ondevice_matches_jax(mode, cache_impl, impl):
    jtok, jcycles, jalpha = _jax_ondevice(mode, cache_impl)
    ref = _greedy_tokens()
    np.testing.assert_array_equal(jtok, ref)
    np.testing.assert_array_equal(_jax_tokens(mode)[0], ref)
    bundle = _bundle(mode, impl)
    kw = dict(cache_impl=cache_impl, page_size=8, device="cpu")
    out = tpl.generate_ondevice(bundle, _prompts(), MAX_NEW, **kw)
    np.testing.assert_array_equal(out["tokens"], ref)
    assert (out["n_cycles"], out["alpha"]) == (jcycles, jalpha)
    host = tpl.generate(bundle, _prompts(), MAX_NEW, **kw)
    np.testing.assert_array_equal(host["tokens"], out["tokens"])
    assert (host["n_cycles"], host["alpha"]) == (jcycles, jalpha)
    assert out["capture_s"] == 0.0 and out["graph_pool_bytes"] == 0


def test_generate_ondevice_one_token_runs_no_cycle():
    """With max_new 1 the loop's condition fails before the first cycle,
    as JAX's ``lax.while_loop`` does: the prefill's token alone."""
    (jt, jd, tp, d1, d2), _ = _models()
    jout = jpl.generate_ondevice(
        jpl.SpecBundle(jt, jd, jd, JSpec(gamma=GAMMA, top_k_branches=K),
                       tp, d1, d2), jnp.asarray(_prompts()), 1)
    jtok, jcycles, jalpha = (np.asarray(jout["tokens"]), jout["n_cycles"],
                             jout["alpha"])
    out = tpl.generate_ondevice(_bundle("d2sd", "gather"), _prompts(), 1,
                                device="cpu")
    np.testing.assert_array_equal(out["tokens"], jtok)
    np.testing.assert_array_equal(out["tokens"], _greedy_tokens(1))
    assert (out["n_cycles"], out["alpha"]) == (jcycles, jalpha) == (0, 0.0)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_ondevice_oracle_accepts_into_branches(cache_impl, impl):
    """The oracle's drafts through the on-device loop, without and with
    the third level: tokens equal pure greedy and the host loop's, alpha
    is the oracle's own count (kept on the device, as the graph needs),
    some paths end in a branch (with the third level, some in a
    third-level branch) and the caches the loop commits equal a plain
    prefill of the same tokens."""
    ref = _greedy_tokens(MAX_NEW + GAMMA)
    seq = t(np.concatenate([_prompts(), ref], 1)).long()
    smoke = _chip_smoke()
    oracle = smoke.register_oracle(seq)
    kw = dict(cache_impl=cache_impl, page_size=8, device="cpu")
    for third in (False, True):
        oracle.reset()
        bundle = _bundle("oracle", impl, third_level=third)
        out = tpl.generate_ondevice(bundle, _prompts(), MAX_NEW, **kw)
        count = oracle.read()
        np.testing.assert_array_equal(out["tokens"], ref[:, :MAX_NEW])
        assert out["alpha"] == count["committed"] / count["row_cycles"]
        assert out["alpha"] > 2 and count["branch_paths"] > 0
        assert (count["third_paths"] > 0) == third
        oracle.reset()
        host = tpl.generate(bundle, _prompts(), MAX_NEW, **kw)
        assert (host["n_cycles"], host["alpha"]) == (out["n_cycles"],
                                                     out["alpha"])
        assert oracle.read() == count
        err = smoke.committed_cache_error(bundle, t(_prompts()).long(), seq,
                                          cache_impl, max_new=MAX_NEW,
                                          page_size=8, ondevice=True)
        assert err < 1e-5


class _NoHostSync(TorchDispatchMode):
    """Fails on every op that reads the device from the host or makes a
    tensor from host data, and on boolean-mask indexing (a nonzero
    inside the op)."""

    BANNED = {torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense,
              torch.ops.aten.masked_select, torch.ops.aten.lift_fresh}
    INDEXING = {torch.ops.aten.index, torch.ops.aten.index_put,
                torch.ops.aten.index_put_, torch.ops.aten._index_put_impl_}

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in self.BANNED:
            raise AssertionError(f"{func} in a step of the on-device loop")
        if packet in self.INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError(f"boolean-mask {func} in a step")
        self.ops.add(packet)
        return func(*args, **(kwargs or {}))


# the step's configurations beyond d2sd and the oracle: name -> (a mode
# of test_torch_modes.MODES or a registered mode, temperature)
STEP_CONFIGS = {"naive_k": ("naive_k", 0.0), "eagle": ("eagle", 0.0),
                "dflash_second": ("dflash_second", 0.0),
                "third_level": ("third_level", 0.0),
                "d2sd_t1": ("d2sd", 1.0), "dflash_t1": ("dflash", 1.0),
                "third_level_t1": ("third_level", 1.0),
                "naive_k_t0.5": ("naive_k", 0.5), "eagle_t1": ("eagle", 1.0)}


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["d2sd", "oracle", *STEP_CONFIGS])
def test_ondevice_step_makes_no_host_sync(mode, cache_impl, impl):
    """One step of the loop (a full cycle: drafts, tree, verify, the
    commit, the feature caches and the token buffer) under a dispatch
    mode that refuses what a CUDA graph cannot capture: every draft
    mode, greedy and sampled (the draws and the sampling verify)."""
    if mode == "oracle":
        ref = _greedy_tokens(MAX_NEW + GAMMA)
        _chip_smoke().register_oracle(
            t(np.concatenate([_prompts(), ref], 1)).long())
    if mode in STEP_CONFIGS:
        name, temp = STEP_CONFIGS[mode]
        bundle = bundle_for(name, impl, temperature=temp)
    else:
        bundle = _bundle(mode, impl)
    prompts = t(_prompts()).long()
    gen = torch.Generator()
    state = prefill(bundle, engine_init(bundle, 3, 40, cache_impl=cache_impl,
                                        page_size=8, device="cpu"), prompts,
                    gen, temperature=bundle.spec.temperature)
    loop = tpl.OnDeviceLoop(bundle, state, MAX_NEW, gen)
    loop.step()                          # the eager first cycle
    before = loop.state.length.clone()
    with _NoHostSync() as mode_:
        loop.step()
    assert (loop.state.length > before).all()
    assert torch.ops.aten.index_copy_ in mode_.ops     # the masked writes
    if bundle.spec.temperature > 0 or bundle.spec.mode == "naive_k":
        assert torch.ops.aten.rand in mode_.ops         # the draws


# ----------------------------------------------------- the masked writes --
def _bits(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# row 3 writes its first page, physical page 11, the last one; row 2's
# third logical page is the sentinel, which a read clamps onto page 11
TABLE = np.array([[0, 2, SENT], [5, 1, 7], [3, 9, SENT], [11, 4, 6]],
                 np.int32)
# n_commit per row: row 0 inactive; row 1 runs past the capacity (12) and
# wraps the rolling buffer (5); row 2 reaches the sentinel page
COMMITS = {"ragged": [0, 5, 3, 2], "none_active": [0, 0, 0, 0]}
LENGTH = np.array([0, 9, 10, 3], np.int32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(COMMITS))
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_commit_kv_drops_like_jax(cache_impl, case):
    """A rolling local layer (cap 5) and a global layer (dense cap 12, or
    pages of 4 through ``TABLE``): the accepted path's K/V written by
    ``commit_kv`` bit for bit as JAX writes it."""
    jcfg = tiny_target(dtype="float32", num_layers=2,
                       layer_pattern=("local", "global"), sliding_window=5)
    tcfg = port_model_cfg(jcfg)
    rng = np.random.default_rng(11)
    b, tb, p, h, d = 4, 7, 5, 2, 4
    local = [_rand(rng, b, 5, h, d) for _ in range(2)]
    glob = ([_rand(rng, 12, 4, h, d) for _ in range(2)]
            if cache_impl == "paged" else
            [_rand(rng, b, 12, h, d) for _ in range(2)])
    kv = [[_rand(rng, b, tb, h, d) for _ in range(2)] for _ in range(2)]
    path = rng.integers(0, tb, (b, p)).astype(np.int32)
    n_commit = np.asarray(COMMITS[case], np.int32)

    jg = {"k": jnp.asarray(glob[0])[None], "v": jnp.asarray(glob[1])[None]}
    tg = {"k": t(glob[0]), "v": t(glob[1])}
    if cache_impl == "paged":
        jg["pt"] = jnp.asarray(TABLE)[None]
        tg["pt"] = t(TABLE)
    jstates = {"length": jnp.asarray(LENGTH),
               "p0": {"k": jnp.asarray(local[0])[None],
                      "v": jnp.asarray(local[1])[None]},
               "p1": jg}
    jkv_outs = {"period": {f"p{i}": tuple(jnp.asarray(x)[None]
                                          for x in kv[i])
                           for i in range(2)}}
    want = jlm.commit_kv(jstates, jkv_outs, jcfg, jnp.asarray(path),
                         jnp.asarray(n_commit))
    tstates = {"length": t(LENGTH),
               "layers": [{"k": t(local[0]), "v": t(local[1])}, tg]}
    got = tlm.commit_kv(tstates, [tuple(t(x) for x in kv[i])
                                  for i in range(2)], tcfg, t(path),
                        t(n_commit))
    _bits(got["length"], want["length"])
    for i in range(2):
        for name in ("k", "v"):
            _bits(got["layers"][i][name], want[f"p{i}"][name][0])


@pytest.mark.parametrize("case", sorted(COMMITS))
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_extend_feat_cache_drops_like_jax(cache_impl, case, monkeypatch):
    """The feature-cache write of ``extend_feat_cache`` (stacked over two
    drafter layers; dense cap 12, or pages of 4 through ``TABLE``), with
    the projection replaced on both sides by the same K/V, so the write
    alone is compared bit for bit."""
    rng = np.random.default_rng(12)
    l, b, p, h, d = 2, 4, 5, 2, 4
    k_new, v_new = _rand(rng, l, b, p, h, d), _rand(rng, l, b, p, h, d)
    monkeypatch.setattr(jdr, "project_features", lambda *a: (
        jnp.asarray(k_new), jnp.asarray(v_new)))
    monkeypatch.setattr(tdr, "project_features", lambda *a: (
        t(k_new), t(v_new)))
    shape = (l, 12, 4, h, d) if cache_impl == "paged" else (l, b, 12, h, d)
    k, v = _rand(rng, *shape), _rand(rng, *shape)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "length": jnp.asarray(LENGTH)}
    tc = {"k": t(k), "v": t(v), "length": t(LENGTH)}
    if cache_impl == "paged":
        jc["pt"], tc["pt"] = jnp.asarray(TABLE), t(TABLE)
    pos = (LENGTH[:, None] + np.arange(p)).astype(np.int32)
    n_new = np.asarray(COMMITS[case], np.int32)
    feats = np.zeros((b, p, 3), np.float32)
    want = jdr.extend_feat_cache(None, None, jc, jnp.asarray(feats),
                                 jnp.asarray(pos), jnp.asarray(n_new))
    got = tdr.extend_feat_cache(None, None, tc, t(feats), t(pos), t(n_new))
    for name in ("k", "v", "length"):
        _bits(got[name], want[name])


@pytest.mark.parametrize("rolling,t_new,start", [
    (False, 4, (6, 7)),        # past the capacity (8)
    (True, 9, (6, 7)),         # more tokens than the rolling capacity
    (True, 8, (5, 0)),         # exactly the capacity, wrapping
    (True, 3, (6, 7))])        # a wrap inside the write
def test_scatter_kv_drops_like_jax(rolling, t_new, start):
    """``_scatter_kv_`` at per-row starts, bit for bit as JAX's drop."""
    rng = np.random.default_rng(13)
    buf, new = _rand(rng, 2, 8, 2, 4), _rand(rng, 2, t_new, 2, 4)
    start = np.asarray(start, np.int32)
    want = jblocks._scatter_kv(jnp.asarray(buf), jnp.asarray(new),
                               jnp.asarray(start), rolling)
    _bits(tblocks._scatter_kv_(t(buf), t(new), t(start), rolling), want)


@pytest.mark.parametrize("case", ["ragged", "none_kept", "race"])
@pytest.mark.parametrize("stacked", [False, True])
def test_pool_scatter_drops_like_jax(case, stacked):
    """``pool_scatter_`` on a 4-D pool and on a stacked 5-D one: invalid
    entries, positions off the table, sentinel pages, no entry kept, and
    a valid write to the last physical page beside entries of another
    row that a read would clamp onto it."""
    rng = np.random.default_rng(14)
    lead = (2,) if stacked else ()
    pool = _rand(rng, *lead, 12, 4, 2, 3)
    new = _rand(rng, *lead, 4, 5, 2, 3)
    pos = (LENGTH[:, None] + np.arange(5)).astype(np.int32)
    valid = np.ones((4, 5), bool)
    if case == "ragged":
        valid[0] = False
        pos[1, 2] = -3
    elif case == "none_kept":
        valid[:] = False
    else:                                   # only rows 2 and 3 write
        valid[:2] = False
        pos[2] = [6, 7, 8, 9, 10]            # page 9, then the sentinel
    want = jkv.pool_scatter(jnp.asarray(pool), jnp.asarray(TABLE),
                            jnp.asarray(new), jnp.asarray(pos),
                            jnp.asarray(valid))
    got = tkv.pool_scatter_(t(pool), t(TABLE), t(new), t(pos), t(valid))
    _bits(got, want)

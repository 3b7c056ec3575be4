"""The port's cascade kernels (``repro_torch.kernels``) held to the JAX
package's Pallas kernels, run in interpret mode as tests/test_kernels.py
runs them, and to the JAX ``ref.py`` oracles.

On the CPU the port's kernel wrappers run their plain torch versions, so
these tests pin the arithmetic the CUDA kernels are held to on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``). Inputs are float32
from a numpy seed. Tolerances: merged outputs atol 1e-5 (both sides fp32, only
the summation order differs); split partials compared where the split
has a live key (``m > -1e29``), since a fully masked split's ``l``/``acc``
are not meaningful and the merge weighs it by 0.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cascade_attention as jcasc
from repro.kernels import ref as jref
from repro_torch.kernels import cascade_attention as tcasc
from repro_torch.kernels import cascade_cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = 1e-5

# The JAX twins compiled once per static setting (the same values as the
# eager calls; the interpret-mode kernels run inside the compiled call).
_STATIC = {"window", "attn_softcap", "scale", "rolling", "n_splits", "bk",
           "interpret", "pos_stride", "pos_offset"}


def _jit(fn):
    names = set(inspect.signature(fn).parameters) & _STATIC
    return jax.jit(fn, static_argnames=tuple(names))


j_phase1 = _jit(jcasc.cascade_phase1)
j_phase1_paged = _jit(jcasc.cascade_phase1_paged)
j_merge = _jit(jcasc._merge_with_tree_block)
j_dense_ref = _jit(jref.cascade_attention_ref)
j_paged_ref = _jit(jref.cascade_attention_paged_ref)


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.array(x))


def _check_partials(jparts, tparts):
    jacc, jm, jl = (np.asarray(x) for x in jparts)
    tacc, tm, tl = (x.numpy() for x in tparts)
    assert jacc.shape == tacc.shape and jm.shape == tm.shape
    live = jm > -1e29
    assert np.array_equal(live, tm > -1e29)
    np.testing.assert_allclose(tm[live], jm[live], rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tl[live], jl[live], rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tacc[live], jacc[live], rtol=1e-5, atol=ATOL)


CASC_CASES = [
    # (B, Hq, Hkv, Tq, S, D, window, cap, rolling) — tests/test_kernels.py
    (1, 2, 2, 16, 512, 64, None, None, False),
    (2, 4, 2, 76, 1024, 64, None, None, False),
    (1, 8, 2, 32, 2048, 128, None, 50.0, False),
    (2, 2, 1, 16, 512, 64, 300, None, True),
    (1, 4, 4, 8, 768, 64, None, None, False),
]
RAGGED_CASES = [
    ((512, 256), None, False), ((505, 250), None, False),
    ((512, 256), 96, False), ((505, 131), 96, False),
    ((505, 250), 200, True),
]
ROLLING_CASES = [
    (97, 97, (40, 150)), (97, 50, (96, 300)), (100, 100, (100, 257)),
    (131, 96, (70, 200)), (505, 505, (505, 711)), (509, 200, (300, 1000)),
    (24, 24, (5, 30)),
]


def _dense_case(case_id, b, hq, hkv, tq, s, d, lens, window, cap, rolling,
                n_splits, bk):
    q, ck, cv, blk_k, blk_v = _inputs(case_id, [
        (b, hq, tq, d), (b, hkv, s, d), (b, hkv, s, d), (b, hkv, tq, d),
        (b, hkv, tq, d)])
    lens = np.asarray(lens, np.int32)
    q_abs = (lens[:, None] + np.arange(tq)[None, :]).astype(np.int32)
    tmask = np.tril(np.ones((tq, tq), bool))
    kw = dict(window=window, attn_softcap=cap, rolling=rolling,
              n_splits=n_splits, bk=bk)
    jparts = j_phase1(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        cache_len=jnp.asarray(lens), q_abs=jnp.asarray(q_abs),
        interpret=True, **kw)
    tparts = tcasc.cascade_phase1(_t(q), _t(ck), _t(cv), cache_len=_t(lens),
                                  q_abs=_t(q_abs), **kw)
    _check_partials(jparts, tparts)
    scale = d ** -0.5
    j_out = j_merge(
        jnp.asarray(q), jnp.asarray(blk_k), jnp.asarray(blk_v), *jparts,
        tree_mask=jnp.asarray(tmask), attn_softcap=cap, scale=scale)
    t_out = tcasc.merge_with_tree_block(
        _t(q), _t(blk_k), _t(blk_v), *tparts, tree_mask=_t(tmask),
        attn_softcap=cap, scale=scale)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    ref_kw = dict(cache_len=lens, q_abs=q_abs, window=window,
                  attn_softcap=cap, rolling=rolling)
    j_ref = j_dense_ref(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(blk_k),
        jnp.asarray(blk_v), tree_mask=jnp.asarray(tmask), **ref_kw)
    t_ref = tref.cascade_attention_ref(
        _t(q), _t(ck), _t(cv), _t(blk_k), _t(blk_v), tree_mask=_t(tmask),
        **ref_kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_ref), atol=ATOL)
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), atol=ATOL)


@pytest.mark.parametrize("i", range(len(CASC_CASES)))
def test_cascade_phase1_matches_jax_kernel(i):
    b, hq, hkv, tq, s, d, window, cap, rolling = CASC_CASES[i]
    lens = ([s - 5] + [s - 200] * (b - 1))[:b]
    _dense_case(i, b, hq, hkv, tq, s, d, lens, window, cap, rolling,
                n_splits=4, bk=256)


@pytest.mark.parametrize("window,cap", [(512, None), (256, 50.0)])
def test_cascade_phase1_d256_mqa_rolling_matches_jax_kernel(window, cap):
    """recurrentgemma-2b's local layers: head_dim 256, 10 query heads over
    one KV head, Tq 16, a rolling buffer wrapped at both lengths."""
    _dense_case(90 + window, 2, 10, 1, 16, 512, 256, (700, 1000), window,
                cap, True, n_splits=4, bk=256)


@pytest.mark.parametrize("i", range(len(RAGGED_CASES)))
def test_cascade_phase1_ragged_window_matches_jax_kernel(i):
    lens, window, rolling = RAGGED_CASES[i]
    _dense_case(100 + i, len(lens), 4, 2, 10, 512, 64, lens, window, None,
                rolling, n_splits=4, bk=64)


@pytest.mark.parametrize("i", range(len(ROLLING_CASES)))
def test_cascade_phase1_rolling_nonaligned_capacity(i):
    """Rolling position recovery must use rem (C's truncating %), not a
    floored mod, with the TRUE capacity as the modulus."""
    cap, window, lens = ROLLING_CASES[i]
    _dense_case(200 + i, len(lens), 4, 2, 6, cap, 32, lens, window, None,
                True, n_splits=4, bk=64)


def test_rolling_uses_truncating_rem():
    """The port's recovery: torch.fmod truncates like jax.lax.rem; the
    floored torch.remainder would differ on negative operands."""
    x = torch.tensor([-7, -1, 3])
    assert torch.fmod(x, 5).tolist() == [-2, -1, 3]
    assert torch.remainder(x, 5).tolist() == [3, 4, 3]


def test_cascade_phase1_split_count_invariant():
    """Effective splits == min(n_splits, ceil(S / bk)) at prime-ish
    capacities, as the JAX kernel pads instead of degrading split-K."""
    b, hq, hkv, tq, d = 1, 2, 2, 4, 32
    for s, n_req, bk, want in [(509, 8, 64, 8), (505, 4, 64, 4),
                               (512, 8, 64, 8), (100, 8, 64, 2),
                               (24, 4, 64, 1)]:
        q, ck, cv = _inputs(s, [(b, hq, tq, d), (b, hkv, s, d),
                                (b, hkv, s, d)])
        acc, m, l = tcasc.cascade_phase1(
            _t(q), _t(ck), _t(cv), cache_len=torch.tensor([s]),
            q_abs=torch.arange(tq)[None] + s, n_splits=n_req, bk=bk)
        jacc, _, _ = j_phase1(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
            cache_len=jnp.array([s]), q_abs=jnp.arange(tq)[None] + s,
            n_splits=n_req, bk=bk, interpret=True)
        assert acc.shape[2] == jacc.shape[2] == want, (s, n_req, bk)
        assert m.shape[2] == l.shape[2] == want


PAGED_CASES = [
    # (B, Hq, Hkv, Tq, page, mp, n_phys, cache_lens, window)
    (2, 4, 2, 12, 64, 8, 20, (512, 256), None),
    (2, 4, 2, 12, 64, 8, 20, (505, 250), None),
    (2, 4, 2, 12, 64, 8, 20, (505, 131), 100),
    (1, 8, 2, 16, 128, 4, 7, (333,), None),
    (3, 2, 2, 8, 32, 6, 24, (192, 100, 65), 64),
    (2, 4, 2, 8, 64, 7, 15, (410, 230), None),
]


@pytest.mark.parametrize("i", range(len(PAGED_CASES)))
def test_cascade_phase1_paged_matches_jax_kernel(i):
    """Shuffled disjoint page tables with PAGE_SENTINEL tails; the pools
    in the engine's [P, page, Hkv, D] storage handed over as views."""
    from repro_torch.models.kvcache import PAGE_SENTINEL
    b, hq, hkv, tq, page, mp, n_phys, lens, window = PAGED_CASES[i]
    d = 64
    rng = np.random.default_rng(300 + i)
    q, pk, pv, blk_k, blk_v = _inputs(300 + i, [
        (b, hq, tq, d), (n_phys, page, hkv, d), (n_phys, page, hkv, d),
        (b, hkv, tq, d), (b, hkv, tq, d)])
    perm = list(rng.permutation(n_phys))
    pt = np.full((b, mp), PAGE_SENTINEL, np.int32)
    for r, cl in enumerate(lens):
        need = -(-int(cl) // page)
        pt[r, :need] = [perm.pop() for _ in range(need)]
    lens = np.asarray(lens, np.int32)
    q_abs = (lens[:, None] + np.arange(tq)[None, :]).astype(np.int32)
    tmask = np.tril(np.ones((tq, tq), bool))
    pk_k, pv_k = (np.swapaxes(x, 1, 2) for x in (pk, pv))   # kernel layout
    jparts = j_phase1_paged(
        jnp.asarray(q), jnp.asarray(pk_k), jnp.asarray(pv_k), jnp.asarray(pt),
        cache_len=jnp.asarray(lens), q_abs=jnp.asarray(q_abs), window=window,
        n_splits=4, interpret=True)
    tparts = tcasc.cascade_phase1_paged(
        _t(q), _t(pk).transpose(1, 2), _t(pv).transpose(1, 2), _t(pt),
        cache_len=_t(lens), q_abs=_t(q_abs), window=window, n_splits=4)
    _check_partials(jparts, tparts)
    t_out = tops.cascade_attention_paged(
        _t(q).transpose(1, 2), _t(pk), _t(pv), _t(pt),
        _t(blk_k).transpose(1, 2), _t(blk_v).transpose(1, 2),
        cache_len=_t(lens), q_abs=_t(q_abs), tree_mask=_t(tmask),
        window=window, n_splits=4).transpose(1, 2)
    j_ref = j_paged_ref(
        jnp.asarray(q), jnp.asarray(pk_k), jnp.asarray(pv_k),
        jnp.asarray(pt), jnp.asarray(blk_k), jnp.asarray(blk_v),
        cache_len=jnp.asarray(lens), q_abs=jnp.asarray(q_abs),
        tree_mask=jnp.asarray(tmask), window=window)
    t_ref = tref.cascade_attention_paged_ref(
        _t(q), _t(pk_k), _t(pv_k), _t(pt), _t(blk_k), _t(blk_v),
        cache_len=_t(lens), q_abs=_t(q_abs), tree_mask=_t(tmask),
        window=window)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_ref), atol=ATOL)
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), atol=ATOL)


def test_cascade_paged_pos_stride_offset_shard_contract():
    """pos_stride/pos_offset: two shards each holding half of every page's
    slots, LSE-merged, equal the dense cascade over the whole cache."""
    b, hq, hkv, tq, d = 2, 4, 2, 6, 16
    page, mp, nsh = 8, 4, 2
    page_loc = page // nsh
    s = mp * page
    q, ck, cv, blk_k, blk_v = (_t(x) for x in _inputs(9, [
        (b, hq, tq, d), (b, hkv, s, d), (b, hkv, s, d), (b, hkv, tq, d),
        (b, hkv, tq, d)]))
    lens = torch.tensor([s - 3, 17])
    q_abs = lens[:, None] + torch.arange(tq)[None, :]
    tmask = torch.ones((tq, tq), dtype=torch.bool).tril()
    want = tcasc.cascade_attention(q, ck, cv, blk_k, blk_v, cache_len=lens,
                                   q_abs=q_abs, tree_mask=tmask, n_splits=2)
    pt = (torch.arange(b)[:, None] * mp + torch.arange(mp)[None]).int()
    parts = []
    for i in range(nsh):
        pool_k = torch.zeros((b * mp, hkv, page_loc, d))
        pool_v = torch.zeros_like(pool_k)
        for bb in range(b):
            for pg in range(mp):
                sl = slice(pg * page + i * page_loc,
                           pg * page + (i + 1) * page_loc)
                pool_k[bb * mp + pg] = ck[bb, :, sl]
                pool_v[bb * mp + pg] = cv[bb, :, sl]
        parts.append(tcasc.cascade_phase1_paged(
            q, pool_k, pool_v, pt, cache_len=lens, q_abs=q_abs, n_splits=2,
            pos_stride=page, pos_offset=i * page_loc))
    acc, m, l = (torch.cat([p[k] for p in parts], dim=2) for k in range(3))
    got = tcasc.merge_with_tree_block(q, blk_k, blk_v, acc, m, l,
                                      tree_mask=tmask, attn_softcap=None,
                                      scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_kernel_wrappers_count_only_kernel_launches():
    """On a CPU tensor the wrappers run the plain version and count no
    launch; the counters move only where a CUDA kernel is launched."""
    q, ck, cv = (_t(x) for x in _inputs(1, [(1, 2, 4, 16), (1, 2, 64, 16),
                                            (1, 2, 64, 16)]))
    wrappers = (tcasc.cascade_phase1, tcasc.cascade_phase1_paged)
    before = [(fn.launches, fn.sm90_launches) for fn in wrappers]
    tcasc.cascade_phase1(q, ck, cv, cache_len=torch.tensor([40]),
                         q_abs=torch.arange(4)[None] + 40)
    tcasc.cascade_phase1_paged(
        q, ck.reshape(4, 2, 16, 16), cv.reshape(4, 2, 16, 16),
        torch.arange(4)[None].int(), cache_len=torch.tensor([40]),
        q_abs=torch.arange(4)[None] + 40)
    assert [(fn.launches, fn.sm90_launches) for fn in wrappers] == before


@pytest.mark.parametrize("name", sorted(cascade_cases.CASES))
def test_card_case_table_builds_and_runs_on_cpu(name):
    """Each case of the table the card runs (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``) builds here and gives finite partials of
    the split geometry's shape; the paged cases' tables hold a page for
    every live position and the sentinel after it."""
    from repro_torch.models.kvcache import PAGE_SENTINEL
    case = cascade_cases.CASES[name]
    gen = torch.Generator()
    gen.manual_seed(0)
    fn, plain, args, kw = cascade_cases.case_inputs(
        gen, np.random.default_rng(0), torch.float32, **case)
    acc, m, l = fn(*args, **kw)
    q = args[0]
    b, hq, tq, d = q.shape
    if case["kind"] == "paged":
        ns = tcasc._paged_geometry(args[3].shape[1], kw.get("n_splits", 8))[0]
        span = kw.get("pos_stride", args[1].shape[2])
        for row, cl in zip(args[3].tolist(), kw["cache_len"].tolist()):
            need = -(-cl // span)
            assert PAGE_SENTINEL not in row[:need]
            assert set(row[need:]) <= {PAGE_SENTINEL}
    else:
        ns = tcasc._split_geometry(args[1].shape[2], kw.get("n_splits", 8),
                                   kw.get("bk", 512))[1]
    assert acc.shape == (b, hq, ns, tq, d) and m.shape == l.shape == (
        b, hq, ns, tq)
    assert all(torch.isfinite(x).all() for x in (acc, m, l))


# ------------------------------------------- the fp32 kernel's error budget --
# The gates (TOL_OUT, TOL_PART) and the 3xTF32 arithmetic (tf32_split,
# einsum_3xtf32) come from cascade_cases, as chip_smoke.py's gates do.
def _budget_errors(parts, out, ref_parts, ref_out):
    """max |out - ref| and the worst live partial (acc, m, l) relative to
    1 + |ref|, all against the fp64 reference."""
    live = ref_parts[1] > -1e29
    part = max(((x.double() - r).abs() / (1 + r.abs())
                ).reshape(*live.shape, -1).amax(-1)[live].max().item()
               for x, r in zip(parts, ref_parts))
    return (out.double() - ref_out).abs().max().item(), part


@pytest.mark.parametrize("name", ["dense_tq76", "paged_tq76",
                                  "dense_softcap", "rolling97_w50",
                                  "d256_rolling_wrap",
                                  "d256_softcap_window"])
def test_tf32x3_error_budget(name, monkeypatch):
    """The fp32 kernel (``csrc/cascade_phase1.cu``) forms Q K^T and P V in
    3xTF32 on the tensor cores. The plain version with every product made
    that way, at a card case's sizes, stays within the card's gates of an
    fp64 reference (the plain version in float64) and within 4x of the
    plain fp32 version's own error there."""
    case = cascade_cases.CASES[name]
    gen = torch.Generator()
    gen.manual_seed(0)
    _, plain, args, kw = cascade_cases.case_inputs(
        gen, np.random.default_rng(0), torch.float32, **case)
    q, ck = args[0], args[1]
    b, hkv, tq, d = q.shape[0], ck.shape[1], q.shape[2], q.shape[3]
    blk = [torch.randn((b, hkv, tq, d), generator=gen) for _ in range(2)]
    tm = torch.ones((tq, tq), dtype=torch.bool).tril()

    def run(dtype):
        cast = [x.to(dtype) if x.is_floating_point() else x for x in args]
        parts = plain(*cast, **kw)
        out = tcasc.merge_with_tree_block(
            cast[0], *(x.to(dtype) for x in blk), *parts, tree_mask=tm,
            attn_softcap=kw["attn_softcap"], scale=kw["scale"])
        return parts, out

    with monkeypatch.context() as mp:   # the same arithmetic in float64
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        ref_parts, ref_out = run(torch.float64)
    assert ref_out.dtype == ref_parts[0].dtype == torch.float64
    fp32 = _budget_errors(*run(torch.float32), ref_parts, ref_out)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "einsum", cascade_cases.einsum_3xtf32)
        emu_parts, _ = run(torch.float32)
    # the merge stays fp32 torch on the card: only phase 1 is the kernel's
    emu_out = tcasc.merge_with_tree_block(
        q, *blk, *emu_parts, tree_mask=tm, attn_softcap=kw["attn_softcap"],
        scale=kw["scale"])
    emu = _budget_errors(emu_parts, emu_out, ref_parts, ref_out)
    assert emu[0] <= cascade_cases.TOL_OUT, (emu, fp32)
    assert emu[1] <= cascade_cases.TOL_PART, (emu, fp32)
    assert emu[0] <= 4 * fp32[0] and emu[1] <= 4 * fp32[1], (emu, fp32)


def test_tf32_split_rule():
    """big holds x to half a tf32 ulp (ties away from zero), small is
    exactly x - big, and big + small keeps x to 2^-21."""
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      np.pi, -1e-3, 0.0], dtype=torch.float32)
    big, small = cascade_cases.tf32_split(x)
    assert big.tolist()[:4] == [1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                                -(1 + 2 ** -10)]
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x.double() - big.double()).abs()
            <= 2 ** -11 * x.double().abs()).all()
    assert ((x.double() - big.double() - small.double()).abs()
            <= 2 ** -21 * x.double().abs()).all()

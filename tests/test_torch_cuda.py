"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skip
without one. The file imports no JAX, so it also runs where JAX is not
installed; run it on the card with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances. Cascade partials, compared where the split has a live key
(``m > -1e29``): m and l relative to 1 + |plain| below 1e-4 in both
dtypes (fp32 scores and row sums on both sides, summation order only);
acc the same in fp32, and in bf16 relative to the largest |plain acc| of
its row and split below 8e-3, since the tensor-core kernels
(``csrc/cascade_phase1_sm90.cu``) round P to bf16 for P V, as the flash
kernels do. q comes in the cache's dtype, as every caller passes it.
Flash o/dq/dk/dv: max |kernel - plain| / max |plain| below
``cascade_cases.TOL_FLASH``, 2e-5 for fp32 (summation order and the
3xTF32 products) and 8e-3 for bf16 (outputs rounded to bf16
on both sides: one bf16 ulp); lse absolute ``TOL_LSE`` 1e-4; o and dq over
rows with a live key. bf16 runs all three flash kernels on the tensor
cores (``csrc/flash_attention_sm90.cu``), fp32 all three too (in
3xTF32, ``csrc/flash_attention.cu``, pinned to the split rule and shown
bitwise repeatable below); the tile-edge cases hold them at a
partial 128-row block, a single query row, a kv_len that ends inside a
key tile, key tiles that no query sees (dk = dv = 0 there), and head
dims 64 and 96 (the latter zero-filled to 128).

The on-device decode loop (``generate_ondevice``, one CUDA graph replay a
cycle) is held to the eager host loop at tiny size in fp32, token for
token, on both caches, for every draft mode, greedy and sampled (the
generator registered with the graph draws fresh numbers each replay, the
numbers the host loop draws); a step that syncs with the host cannot be
captured, and the loop raises. Sampling through the kernels is lossless
(``chip_smoke.py::first_token_tv``).
"""
import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import cascade_cases
from repro_torch.kernels import flash_attention as tfa


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return "cuda"


# test id -> a case of cascade_cases.CASES, the table chip_smoke.py runs
# whole: both caches, softcap, window, the shard contract, small pages, a
# rolling buffer and the tensor-core kernels' tile edges (Tq 1 and 136,
# GQA groups 1 and 8, D 64 and 96)
CARD_CASES = {"dense": "dense_tq76", "paged": "paged_tq76",
              "softcap": "paged_softcap", "window": "paged_window",
              "dense_window": "dense_window", "pos_stride": "pos_stride",
              "page8": "page8", "rolling": "rolling97_w50", "tq1": "tq1",
              "tq136": "tq136", "group1": "group1", "group8": "group8",
              "d64": "d64", "d96": "d96"}


def _inputs(dev, dtype, kind, **opts):
    """(wrapper, plain version, args, kwargs) of one case, from a fresh
    seed: q in the cache's dtype as a view of [B,Tq,Hq,D], the cache of
    [B,S,Hkv,D] or the pool of [P,page,Hkv,D], as the model hands them
    over."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cascade_cases.case_inputs(gen, np.random.default_rng(0), dtype,
                                     kind, **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernel_matches_plain(dev, case, dtype):
    kern_fn, plain_fn, args, kw = _inputs(
        dev, dtype, **cascade_cases.CASES[CARD_CASES[case]])
    before = (kern_fn.launches, kern_fn.sm90_launches)
    kern = kern_fn(*args, **kw)
    plain = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    sm90 = int(dtype == torch.bfloat16)    # bf16: the tensor-core kernel
    assert (kern_fn.launches, kern_fn.sm90_launches) == (
        before[0] + 1, before[1] + sm90)
    assert all(torch.isfinite(x).all() for x in kern)
    empty = kern[2] == 0                    # no key in the split's range
    assert (kern[0][empty] == 0).all() and (kern[1][empty] == -1e30).all()
    live = plain[1] > -1e29
    for a, b_ in zip(kern[1:], plain[1:]):
        assert ((a - b_).abs() / (1 + b_.abs()))[live].max().item() < 1e-4
    if sm90:
        acc = (kern[0] - plain[0]).abs().amax(-1) / plain[0].abs().amax(-1)
        assert acc[live].max().item() < 8e-3
    else:
        acc = ((kern[0] - plain[0]).abs() / (1 + plain[0].abs())).amax(-1)
        assert acc[live].max().item() < 1e-4


@pytest.mark.cuda
def test_cascade_refuses_mixed_dtypes(dev):
    """A bf16 cache with an fp32 q (or the reverse) raises TypeError
    before any launch: no caller mixes them, and the kernels take one
    dtype."""
    for dtype, q_dtype in ((torch.bfloat16, torch.float32),
                           (torch.float32, torch.bfloat16)):
        for kind in ("dense", "paged"):
            kern_fn, _, args, kw = _inputs(dev, dtype, kind, s=128,
                                           lens=(100,))
            args = (args[0].to(q_dtype), *args[1:])
            before = (kern_fn.launches, kern_fn.sm90_launches)
            with pytest.raises(TypeError, match="one dtype"):
                kern_fn(*args, **kw)
            assert (kern_fn.launches, kern_fn.sm90_launches) == before


@pytest.mark.cuda
def test_cascade_bf16_refuses_what_cp_async_cannot_load(dev):
    """The bf16 cascade kernels load rows in 16-byte chunks: a cache whose
    row stride is not a multiple of 8 elements raises before any launch,
    with no fallback."""
    for kind in ("dense", "paged"):
        kern_fn, _, args, kw = _inputs(dev, torch.bfloat16, kind, d=20,
                                       s=128, lens=(100,))
        args = (args[0][..., :16], *(x[..., :16] for x in args[1:3]),
                *args[3:])
        before = (kern_fn.launches, kern_fn.sm90_launches)
        with pytest.raises(ValueError, match="16-byte chunks"):
            kern_fn(*args, **kw)
        assert (kern_fn.launches, kern_fn.sm90_launches) == before


@pytest.mark.cuda
def test_tf32x3_split_rule_on_card(dev, monkeypatch):
    """The fp32 kernel splits each operand for the tf32 tensor cores
    without a cvt: big is x plus half a tf32 ulp, which the unit must read
    with its low 13 bits dropped, and small is read truncated (the rule of
    cascade_cases.tf32_split). On operands whose low 13 bits are set, the
    kernel's partials must match the plain version with every product
    formed by that rule to 1e-5. A unit that rounded its operands instead
    would move big by a tf32 ulp about half the time, as would a kernel
    that dropped the small terms, and both are 10x or more off; the test
    checks that its inputs show the latter."""
    from repro_torch.kernels import cascade_attention as casc
    rng = np.random.default_rng(0)
    hq, tq, s, d = 4, 16, 64, 128
    q = torch.tensor(rng.standard_normal((1, hq, tq, d)) * d ** -0.5,
                     dtype=torch.float32, device=dev)
    ck, cv = (torch.tensor(rng.standard_normal((1, 1, s, d)),
                           dtype=torch.float32, device=dev)
              for _ in range(2))
    assert all(((x.view(torch.int32) & 0x1FFF) != 0).float().mean() > 0.99
               for x in (q, ck, cv))
    cl = torch.tensor([s], device=dev)
    kw = dict(cache_len=cl, q_abs=cl[:, None] - 1 + torch.arange(
        tq, device=dev), scale=1.0)
    before = casc.cascade_phase1.launches
    kern = casc.cascade_phase1(q, ck, cv, **kw)
    torch.cuda.synchronize()
    assert casc.cascade_phase1.launches == before + 1
    real = torch.einsum

    def plain_with(einsum):
        with monkeypatch.context() as mp:
            mp.setattr(torch, "einsum", einsum)
            return casc.cascade_phase1_plain(q, ck, cv, **kw)

    def worst(a, b):
        return max(((x - y).abs() / (1 + y.abs())).max().item()
                   for x, y in zip(a, b))

    emu = plain_with(cascade_cases.einsum_3xtf32)
    one = plain_with(lambda eq, a, b: real(
        eq, cascade_cases.tf32_split(a)[0], cascade_cases.tf32_split(b)[0]))
    assert worst(kern, emu) < 1e-5, worst(kern, emu)
    assert worst(one, emu) > 1e-4, worst(one, emu)


FLASH_CASES = {   # b, hq, hkv, tq, tkv, d, [B,T,H,D] layout, options
    # the training shape's geometry at T 512, in the model's layout
    "causal": (2, 8, 2, 512, 512, 128, True, dict(causal=True)),
    # ragged: T not a multiple of 64, q_offset, kv_len, window, softcap
    "ragged": (2, 4, 4, 300, 300, 64, False,
               dict(causal=True, q_offset=24, kv_len=[300, 231],
                    window=128, attn_softcap=50.0)),
    # tile edges of the tensor-core kernels (128-row blocks, 128- and
    # 64-key tiles)
    "t129": (2, 8, 2, 129, 129, 128, True, dict(causal=True)),
    "one_row": (2, 8, 2, 1, 300, 128, True,
                dict(causal=True, q_offset=299)),
    "kv_len_mid_tile": (2, 8, 2, 200, 300, 128, True,
                        dict(causal=True, q_offset=100, kv_len=[300, 237])),
    "d64": (2, 8, 2, 129, 129, 64, True, dict(causal=True)),
    "d96": (2, 8, 2, 129, 129, 96, True,
            dict(causal=False, kv_len=[129, 70])),
    # a head dim under one 64-column panel; size-1 batch and head dims,
    # whose strides TMA never steps
    "d32": (2, 4, 2, 130, 130, 32, False, dict(causal=True)),
    "single_head": (1, 1, 1, 300, 300, 128, True, dict(causal=True)),
    # key tiles 1 and 2 lie past every query's causal edge: dk/dv must
    # write zeros there
    "unseen_keys": (2, 8, 2, 128, 384, 128, True, dict(causal=True)),
}


def _flash_case_inputs(dev, case, dtype=torch.float32):
    """(q, k, v, do) of a FLASH_CASES case from a fresh seed, as views of
    [B,T,H,D] buffers where the case says so, and its options."""
    b, hq, hkv, tq, tkv, d, bthd, kw = FLASH_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def mk(h, t):
        if bthd:
            return torch.randn((b, t, h, d), generator=gen,
                               device=dev).to(dtype).transpose(1, 2)
        return torch.randn((b, h, t, d), generator=gen, device=dev).to(dtype)

    q, k, v, do = mk(hq, tq), mk(hkv, tkv), mk(hkv, tkv), mk(hq, tq)
    kw = dict(kw)
    if "kv_len" in kw:
        kw["kv_len"] = torch.tensor(kw["kv_len"], device=dev)
    return (q, k, v, do), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(dev, case, dtype):
    (q, k, v, do), kw = _flash_case_inputs(dev, case, dtype)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    before = [getattr(tfa, n).launches for n in names]
    sm90_before = [getattr(tfa, n).sm90_launches for n in names]
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    o_p, lse_p = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta)
    dq = tfa.flash_attention_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(*args, **kw)
    dq_p = tfa.flash_attention_bwd_dq_plain(*args, **kw)
    dk_p, dv_p = tfa.flash_attention_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert [getattr(tfa, n).launches for n in names] == [x + 1 for x in before]
    sm90 = int(dtype == torch.bfloat16)    # bf16: the tensor-core kernels
    assert [getattr(tfa, n).sm90_launches for n in names] == [
        x + sm90 for x in sm90_before]
    live = lse_p > -1e29
    tol = cascade_cases.TOL_FLASH[dtype]

    def rel(a, b_):
        a, b_ = a.float(), b_.float()
        assert torch.isfinite(a).all()
        return ((a - b_).abs().max() / b_.abs().max()).item()

    assert rel(o[live], o_p[live]) < tol
    assert (lse[live] - lse_p[live]).abs().max().item() < \
        cascade_cases.TOL_LSE
    assert rel(dq[live], dq_p[live]) < tol
    assert rel(dk, dk_p) < tol and rel(dv, dv_p) < tol


def _bwd_args(q, k, v, do, kw):
    """The backward kernels' arguments: q, k, v, do and the plain
    forward's lse and delta."""
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    return (q, k, v, do, lse, (do * o).sum(-1))


@pytest.mark.cuda
def test_flash_bwd_tf32x3_split_on_card(dev, monkeypatch):
    """The fp32 dq and dk/dv kernels split each operand for the tf32
    tensor cores as the fp32 cascade kernels do (the rule of
    cascade_cases.tf32_split). On operands whose low 13 bits are set, the
    kernels' dq, dk and dv must match the plain versions with every
    product formed by that rule to 1e-5 (max |diff| / max |emulated|);
    the test checks that its inputs put that emulation more than 1e-4
    from one tf32 product in place of three."""
    qkvo, kw = _flash_case_inputs(dev, "causal")
    assert all(((x.contiguous().view(torch.int32) & 0x1FFF) != 0)
               .float().mean() > 0.99 for x in qkvo)
    args = _bwd_args(*qkvo, kw)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    kern = (tfa.flash_attention_bwd_dq(*args, **kw),
            *tfa.flash_attention_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    real = torch.einsum

    def plain_with(einsum):
        with monkeypatch.context() as mp:
            mp.setattr(torch, "einsum", einsum)
            return (tfa.flash_attention_bwd_dq_plain(*args, **kw),
                    *tfa.flash_attention_bwd_dkv_plain(*args, **kw))

    def rel(a, b):
        return [((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(a, b)]

    emu = plain_with(cascade_cases.einsum_3xtf32)
    one = plain_with(lambda eq, a, b: real(
        eq, cascade_cases.tf32_split(a)[0], cascade_cases.tf32_split(b)[0]))
    assert max(rel(kern, emu)) < 1e-5, rel(kern, emu)
    assert min(rel(one, emu)) > 1e-4, rel(one, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "ragged"])
def test_flash_bwd_fp32_is_deterministic(dev, case):
    """The fp32 dq and dk/dv kernels use no atomics (dk/dv sum the GQA
    group in the block): two calls on the same inputs give bitwise equal
    dq, dk and dv."""
    qkvo, kw = _flash_case_inputs(dev, case)
    args = _bwd_args(*qkvo, kw)
    first = (tfa.flash_attention_bwd_dq(*args, **kw),
             *tfa.flash_attention_bwd_dkv(*args, **kw))
    second = (tfa.flash_attention_bwd_dq(*args, **kw),
              *tfa.flash_attention_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_fwd_tf32x3_split_on_card(dev, monkeypatch):
    """The fp32 forward kernel forms S = (Q*scale) K^T and O += P V by the
    split rule of cascade_cases.tf32_split. On operands whose low 13 bits
    are set, its o must match the plain forward with both products formed
    by that rule to 1e-5 (max |diff| / max |emulated| over rows with a
    live key); the test checks that its inputs put that emulation more
    than 1e-4 from one tf32 product in place of three."""
    (q, k, v, _), kw = _flash_case_inputs(dev, "causal")
    assert all(((x.contiguous().view(torch.int32) & 0x1FFF) != 0)
               .float().mean() > 0.99 for x in (q, k, v))
    before = tfa.flash_attention_fwd.launches
    o, _ = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    real = torch.einsum

    def plain_with(einsum):
        with monkeypatch.context() as mp:
            mp.setattr(torch, "einsum", einsum)
            return tfa.flash_attention_fwd_plain(q, k, v, **kw)

    emu, lse = plain_with(cascade_cases.einsum_3xtf32)
    one, _ = plain_with(lambda eq, a, b: real(
        eq, cascade_cases.tf32_split(a)[0], cascade_cases.tf32_split(b)[0]))
    live = lse > -1e29

    def rel(a, b):
        return ((a - b)[live].abs().max() / b[live].abs().max()).item()

    assert rel(o, emu) < 1e-5, rel(o, emu)
    assert rel(one, emu) > 1e-4, rel(one, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "ragged"])
def test_flash_fwd_fp32_is_deterministic(dev, case):
    """The fp32 forward kernel uses no atomics: two calls on the same
    inputs give bitwise equal o and lse."""
    (q, k, v, _), kw = _flash_case_inputs(dev, case)
    first = tfa.flash_attention_fwd(q, k, v, **kw)
    second = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_bf16_refuses_what_tma_cannot_load(dev):
    """The bf16 flash kernels load by TMA: a row stride that is not a
    multiple of 8 elements raises before any launch."""
    q = torch.randn((1, 2, 16, 20), device=dev).to(torch.bfloat16)[..., :16]
    k = torch.randn((1, 2, 16, 16), device=dev).to(torch.bfloat16)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    before = [getattr(tfa, n).launches for n in names]
    with pytest.raises(ValueError, match="TMA"):
        tfa.flash_attention_fwd(q, k, k)
    rows = torch.zeros((1, 2, 16), device=dev)
    with pytest.raises(ValueError, match="TMA"):
        tfa.flash_attention_bwd_dq(q, k, k, q, rows, rows)
    with pytest.raises(ValueError, match="TMA"):
        tfa.flash_attention_bwd_dkv(q, k, k, q, rows, rows)
    assert [getattr(tfa, n).launches for n in names] == before


def _tiny_bundle(dev, mode="d2sd"):
    """The study's small target and drafters (fp32, random seeded
    weights), the cascade kernels as the read path."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.configs import paper_target
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import drafter_init
    from repro_torch.models import lm
    tcfg, dcfg = paper_target.smoke(), paper_target.drafter_small(gamma=4)
    return pl.with_attn_impl(pl.SpecBundle(
        tcfg, dcfg, dcfg, SpecConfig(gamma=4, top_k_branches=2, mode=mode),
        lm.lm_init(tcfg, seed=0, device=dev),
        drafter_init(dcfg, seed=1, device=dev),
        drafter_init(dcfg, seed=2, device=dev)), "kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_graph_loop_matches_eager_loop(dev, cache_impl):
    from repro_torch.core import pipeline as pl
    bundle = _tiny_bundle(dev)
    prompts = np.random.default_rng(0).integers(0, 512, (3, 24))
    kw = dict(cache_impl=cache_impl, page_size=16, device=dev)
    host = pl.generate(bundle, prompts, 12, **kw)
    graph = pl.generate_ondevice(bundle, prompts, 12, **kw)
    np.testing.assert_array_equal(graph["tokens"], host["tokens"])
    assert (graph["n_cycles"], graph["alpha"]) == (host["n_cycles"],
                                                   host["alpha"])
    assert graph["capture_s"] > 0 and graph["graph_pool_bytes"] > 0


@pytest.mark.cuda
def test_graph_loop_raises_when_capture_fails(dev):
    """A draft that reads the device from the host runs in the eager first
    cycle but cannot be captured: the loop raises, with no eager
    fallback."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core import strategies as st

    @st.register_strategy("host_sync")
    class HostSync(st.D2SDStrategy):
        def draft(self, bundle, state, gen):
            int(state.length.max())
            return super().draft(bundle, state, gen)

    bundle = _tiny_bundle(dev, mode="host_sync")
    prompts = np.random.default_rng(0).integers(0, 512, (2, 16))
    with pytest.raises(RuntimeError):
        pl.generate_ondevice(bundle, prompts, 8, device=dev)
    bundle = dataclasses.replace(bundle, spec=dataclasses.replace(
        bundle.spec, mode="d2sd"))
    assert pl.generate_ondevice(bundle, prompts, 8, device=dev)["n_cycles"]


# name -> (chip_smoke.mode_bundle's mode name, temperature)
LOOP_CONFIGS = {"naive_k": ("naive_k", 0.0), "eagle": ("eagle", 0.0),
                "dflash_second": ("dflash_second", 0.0),
                "third_level": ("third_level", 0.0),
                "d2sd_t1": ("d2sd", 1.0),
                "third_level_t1": ("third_level", 1.0),
                "naive_k_t0.5": ("naive_k", 0.5), "eagle_t1": ("eagle", 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("name", sorted(LOOP_CONFIGS))
def test_graph_loop_matches_eager_loop_by_mode(dev, name, cache_impl):
    """Every draft mode, greedy and sampled: the graph loop equals the
    host loop for one seed (tokens, cycles, alpha)."""
    from repro_torch.core import pipeline as pl
    mode, temp = LOOP_CONFIGS[name]
    bundle = _chip_smoke().mode_bundle(_tiny_bundle(dev), mode, temp)
    prompts = np.random.default_rng(0).integers(0, 512, (3, 24))
    kw = dict(cache_impl=cache_impl, page_size=16, device=dev, seed=3)
    host = pl.generate(bundle, prompts, 12, **kw)
    graph = pl.generate_ondevice(bundle, prompts, 12, **kw)
    np.testing.assert_array_equal(graph["tokens"], host["tokens"])
    assert (graph["n_cycles"], graph["alpha"]) == (host["n_cycles"],
                                                   host["alpha"])


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_graph_generator_draws_fresh_each_replay(dev):
    """The sampled graph loop's acceptance uniforms, logged on the device
    each cycle: the eager first cycle and every replay draw numbers of
    their own, and the same numbers the host loop draws for the seed."""
    from repro_torch.core import pipeline as pl
    bundle = _chip_smoke().mode_bundle(_tiny_bundle(dev), "d2sd", 1.0)
    prompts = np.random.default_rng(1).integers(0, 512, (3, 24))
    log = _chip_smoke().DrawLog(32, (3 * 3, 3))
    draws = {}
    try:
        for loop in (pl.generate, pl.generate_ondevice):
            log.n.zero_()
            out = loop(bundle, prompts, 12, seed=4, device=dev)
            draws[loop.__name__] = (log.read(), out["n_cycles"])
    finally:
        log.close()
    (host, n_host), (graph, n_graph) = draws["generate"], draws[
        "generate_ondevice"]
    assert n_graph == n_host == graph.shape[0] >= 3
    assert torch.equal(graph, host)
    flat = graph.reshape(n_graph, -1)
    assert int((flat[:, None] == flat[None]).all(-1).sum()) == n_graph


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["d2sd", "third_level", "naive_k_t0.5",
                                  "eagle"])
def test_sampling_is_lossless_through_the_kernels(dev, name):
    """``chip_smoke.py``'s batched check at tiny size, head_dim 64, on a
    paged cache: every cascade read through the fp32 kernel."""
    from repro_torch.kernels import cascade_attention as casc
    mode, third, temp = {"d2sd": ("d2sd", False, 1.0),
                         "third_level": ("d2sd", True, 1.0),
                         "naive_k_t0.5": ("naive_k", False, 0.5),
                         "eagle": ("eagle", False, 1.0)}[name]
    smoke = _chip_smoke()
    before = casc.cascade_phase1_paged.launches
    tv, bound = smoke.first_token_tv(
        smoke.lossless_bundle(mode, third, temp, impl="kernel", device=dev,
                              d_model=128, d_drafter=128),
        device=dev, cache_impl="paged")
    assert casc.cascade_phase1_paged.launches > before
    assert tv < bound, (tv, bound)

"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skip
without one. The file imports no JAX, so it also runs where JAX is not
installed; run it on the card with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances. Cascade partials: relative to 1 + |plain| below 1e-4,
compared where the split has a live key (``m > -1e29``); both sides
compute in fp32 from the same inputs and differ only in summation order.
Flash o/dq/dk/dv: max |kernel - plain| / max |plain| below 2e-5 for fp32
(summation order) and 8e-3 for bf16 (outputs rounded to bf16 on both
sides: one bf16 ulp); lse absolute 1e-4; o and dq over rows with a live
key. bf16 runs all three flash kernels on the tensor cores
(``csrc/flash_attention_sm90.cu``); the tile-edge cases hold them at a
partial 128-row block, a single query row, a kv_len that ends inside a
key tile, key tiles that no query sees (dk = dv = 0 there), and head
dims 64 and 96 (the latter zero-filled to 128).
"""
import pytest
import torch

from repro_torch.kernels import cascade_attention as tcasc
from repro_torch.kernels import flash_attention as tfa


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return "cuda"


def _inputs(dev, dtype, paged):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, hq, hkv, tq, d, page = 3, 8, 2, 76, 128, 64
    lens = torch.tensor([512, 701, 1100], device=dev)
    q_abs = lens[:, None] + torch.arange(tq, device=dev)
    q = torch.randn((b, hq, tq, d), generator=gen, device=dev)
    if paged:
        n_phys, mp = 3 * 18, 18
        pool = [torch.randn((n_phys, page, hkv, d), generator=gen,
                            device=dev).to(dtype).transpose(1, 2)
                for _ in range(2)]
        pt = torch.randperm(n_phys, device=dev, generator=gen)[
            :b * mp].reshape(b, mp).int()
        return (q, *pool, pt), dict(cache_len=lens, q_abs=q_abs)
    cache = [torch.randn((b, 1152, hkv, d), generator=gen,
                         device=dev).to(dtype).transpose(1, 2)
             for _ in range(2)]
    return (q, *cache), dict(cache_len=lens, q_abs=q_abs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_kernel_matches_plain(dev, paged, dtype):
    args, kw = _inputs(dev, dtype, paged)
    if paged:
        kern_fn, plain_fn = (tcasc.cascade_phase1_paged,
                             tcasc.cascade_phase1_paged_plain)
    else:
        kern_fn, plain_fn = tcasc.cascade_phase1, tcasc.cascade_phase1_plain
    before = kern_fn.launches
    kern = kern_fn(*args, **kw)
    plain = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    assert kern_fn.launches == before + 1
    live = plain[1] > -1e29
    for a, b_ in zip(kern, plain):
        rel = (a - b_).abs() / (1 + b_.abs())
        rel = rel.amax(-1) if rel.ndim == 5 else rel
        assert rel[live].max().item() < 1e-4


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(dev, case, dtype):
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
    tol = 2e-5 if dtype == torch.float32 else 8e-3

    def rel(a, b_):
        a, b_ = a.float(), b_.float()
        assert torch.isfinite(a).all()
        return ((a - b_).abs().max() / b_.abs().max()).item()

    assert rel(o[live], o_p[live]) < tol
    assert (lse[live] - lse_p[live]).abs().max().item() < 1e-4
    assert rel(dq[live], dq_p[live]) < tol
    assert rel(dk, dk_p) < tol and rel(dv, dv_p) < tol


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

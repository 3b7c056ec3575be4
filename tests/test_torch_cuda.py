"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skip
without one. The file imports no JAX, so it also runs where JAX is not
installed; run it on the card with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: partials relative to 1 + |plain| below 1e-4, compared where the
split has a live key (``m > -1e29``); both sides compute in fp32 from the
same inputs and differ only in summation order.
"""
import pytest
import torch

from repro_torch.kernels import cascade_attention as tcasc


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

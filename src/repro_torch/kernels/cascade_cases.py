"""The cases that hold the cascade phase-1 kernels to their plain versions,
and the gates of every kernel on the card.

One table for both places that run them on the card: ``chip_smoke.py``'s
kernels phase runs every case in both dtypes (and merges and checks
against the oracle), and ``tests/test_torch_cuda.py`` runs a subset. The
gates of the fp32 cascade kernels and of the flash kernels live here too,
with the 3xTF32 arithmetic of the fp32 tensor-core kernels (the cascade
pair and the flash kernels) in torch (``tf32_split``, ``einsum_3xtf32``),
which the tests hold the card and the gates to.
Defaults: B 4 (the lengths in ``LENS``), Tq 76, Hq 32, Hkv 8, D 128, a
cache of 1152 slots or a pool of 64-key pages, q in the cache's dtype as
a view of the model's [B,T,Hq,D] queries.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

LENS = (512, 700, 901, 1100)                # ragged cache lengths, S 1152

# The gates of the fp32 cascade kernels (3xTF32 on the card) against the
# plain version and the fp64 oracle:
TOL_OUT = 2e-5      # merged output, absolute: both sides compute in fp32;
                    # only sum order and the 3xTF32 split differ
TOL_PART = 1e-4     # partials relative to 1 + |plain|: m and l in both
                    # dtypes (fp32 scores and row sums on both sides), acc
                    # in fp32 (bf16 acc has a gate of its own: P is rounded
                    # to bf16 for P V as in the flash kernels)
# The gates of the flash kernels (o, dq, dk, dv) against their plain
# versions, max |diff| / max |plain|; the bf16 one also holds the bf16
# cascade kernels' merged output and acc:
TOL_FLASH = {
    torch.float32: 2e-5,     # fp32 both sides, sums over <= 4096 keys or
                             # 4 x 4096 queries in another order (and the
                             # 3xTF32 products)
    torch.bfloat16: 8e-3}    # fp32 inside, outputs rounded to bf16: one
                             # bf16 ulp (2^-8 of the value) either way
TOL_LSE = 1e-4      # flash lse (fp32 both sides), absolute

# recurrentgemma-2b's local attention at the state-replay read pass
D256 = dict(d=256, hq=10, hkv=1, tq=16)
HYBRID_LENS = tuple(2049 + (37 * i) % 105 for i in range(20))
# gemma2-2b's decoder verify: D 256, 8 query heads over 4, softcap 50;
# its local layers roll over a window of 4096 (the rows past it wrap),
# its global ones are paged
GEMMA2 = dict(d=256, hq=8, hkv=4, softcap=50.0, lens=(3990, 4100, 4507, 5003))
STUDY_LENS = (48, 70, 101, 143)

# name -> options of ``case_inputs`` (``nan``: the caller pre-fills the
# outputs with NaN, so a split with no key must write finite zeros)
CASES = {
    **{f"dense_tq{tq}": dict(kind="dense", tq=tq) for tq in (16, 64, 76)},
    # rolling buffers at the adversarial capacities of the JAX tests
    **{f"rolling{cap}_w{w}": dict(kind="dense", tq=16, s=cap, window=w,
                                  lens=lens, rolling=True, n_splits=4, bk=64)
       for cap, w, lens in [(97, 97, (40, 150)), (97, 50, (96, 300)),
                            (100, 100, (100, 257)), (131, 96, (70, 200)),
                            (505, 505, (505, 711)), (509, 200, (300, 1000)),
                            (24, 24, (5, 30))]},
    # paged: shuffled table with sentinel tails
    **{f"paged_tq{tq}": dict(kind="paged", tq=tq) for tq in (16, 64, 76)},
    "dense_softcap": dict(kind="dense", softcap=50.0),
    "paged_softcap": dict(kind="paged", softcap=50.0),
    # window 256: the first splits of the long rows hold only masked keys
    "paged_window": dict(kind="paged", window=256),
    "dense_window": dict(kind="dense", window=256),
    # the kv_seq shard contract: logical page i at i * 64 + 32
    "pos_stride": dict(kind="paged", page=16, pos=(64, 32)),
    # the kv_seq-sharded engine's reads (chip_smoke.py's sharded phases):
    # rank r of P holds page_loc = 64 // P slots of every 64-key page, at
    # i * 64 + r * page_loc; the verify block (Tq 76) and a drafter's
    # (Tq 16); each logical page spans 64 positions the pool page fills
    # only page_loc of, so tile spans hold dead slots
    "shard2_r0": dict(kind="paged", page=32, pos=(64, 0)),
    "shard2_r1": dict(kind="paged", page=32, pos=(64, 32)),
    "shard4_r3": dict(kind="paged", page=16, pos=(64, 48)),
    "shard4_r1_tq16": dict(kind="paged", page=16, pos=(64, 16), tq=16),
    "page8": dict(kind="paged", page=8),
    "page16": dict(kind="paged", page=16),
    # tile edges of the tensor-core kernels: 128 stacked rows a block, the
    # GQA group stacked, 64-key tiles, 64-column panels
    "tq1": dict(kind="dense", tq=1),
    "tq136": dict(kind="paged", tq=136),
    "group1": dict(kind="paged", hq=8, hkv=8),
    "group8": dict(kind="dense", hq=32, hkv=4),
    "d64": dict(kind="paged", d=64),
    "d96": dict(kind="dense", d=96),
    "paged_nan": dict(kind="paged", nan=True),
    "dense_nan": dict(kind="dense", nan=True),
    # head_dim 256, MQA 10 over 1 (recurrentgemma-2b's local layers): the
    # state-replay read pass (B*R = 20 folded rows, Tq 16, a rolling
    # buffer of 2048 wrapped at every length), a capacity that wraps
    # mid-split, Tq 1, softcap with window 256, and the paged kernel
    **{name: dict(D256, **opts) for name, opts in {
        "d256_hybrid": dict(kind="dense", s=2048, window=2048, rolling=True,
                            lens=HYBRID_LENS, nan=True),
        "d256_rolling_wrap": dict(kind="dense", s=1000, window=1000,
                                  rolling=True, lens=(1300, 2555),
                                  n_splits=4, bk=256),
        "d256_tq1": dict(kind="dense", tq=1),
        "d256_softcap_window": dict(kind="dense", softcap=50.0, window=256),
        "d256_paged": dict(kind="paged", nan=True),
        "d256_paged_softcap_window": dict(kind="paged", softcap=50.0,
                                          window=256, tq=1),
    }.items()},
    # the decoder verify of the other archs: stablelm-3b (D 80, MHA 32
    # over 32; bf16 pads D to its 128-wide template), grok-1-314b (GQA
    # group 6: 48 over 8), whisper-medium (D 64, MHA 16 over 16) and
    # gemma2-2b (GEMMA2)
    "d80_group1": dict(kind="dense", d=80, hq=32, hkv=32),
    "d80_group1_paged": dict(kind="paged", d=80, hq=32, hkv=32),
    "group6": dict(kind="dense", hq=48, hkv=8),
    "group6_paged": dict(kind="paged", hq=48, hkv=8),
    "d64_group1_paged": dict(kind="paged", d=64, hq=16, hkv=16),
    "d256_gemma2_rolling": dict(GEMMA2, kind="dense", s=4096, window=4096,
                                rolling=True),
    "d256_gemma2_paged": dict(GEMMA2, kind="paged", s=5120),
    # the study's models (paper_target.smoke() and drafter_small()): the
    # target's verify (D 64, 4 query heads over 2, Tq 76) and the
    # drafters' feature-cache reads (D 48, 4 over 2, a gamma-16 block),
    # over the caches of 48-token prompts and 96 new tokens
    **{name: dict(lens=STUDY_LENS, s=256, hq=4, hkv=2, **opts)
       for name, opts in {
           "d64_study": dict(kind="dense", d=64),
           "d64_study_paged": dict(kind="paged", d=64),
           "d48_drafter": dict(kind="dense", d=48, tq=16),
           "d48_drafter_paged": dict(kind="paged", d=48, tq=16, nan=True),
       }.items()},
}


# The fp32 kernels' accumulator over long splits: both cascade kernels at
# the longest cache paper-target allows (max_seq_len 32768), B 2, Tq 76,
# with 8 splits (4096 keys, 128 of the fp32 kernel's 32-key tiles a
# split) and with 1 (1024 tiles), held to a float64 run of the plain
# version under TOL_OUT / TOL_PART (``long_split_errors``)
LONG_S = 32768
LONG_CASES = {f"{kind}_32k_splits{ns}": dict(kind=kind, lens=(32692, 30001),
                                              s=LONG_S, n_splits=ns)
              for kind in ("dense", "paged") for ns in (8, 1)}


@contextlib.contextmanager
def float_as_double():
    """Inside, ``Tensor.float`` is ``Tensor.double``: the plain versions
    (which compute through ``.float()``) then run in float64."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real


def long_split_errors(gen, rng, case):
    """The fp32 kernel of ``case`` (a ``LONG_CASES`` entry) against the
    plain version run in float64: max |merged output - reference| (the
    merge in fp32 as on the decode path) and the worst live partial
    (acc, m, l) relative to 1 + |reference|."""
    from repro_torch.kernels import cascade_attention as casc
    kern, plain, args, kw = case_inputs(gen, rng, torch.float32, **case)
    q, ck = args[0], args[1]
    b, hkv, tq, d = q.shape[0], ck.shape[1], q.shape[2], q.shape[3]
    blk = [torch.randn((b, hkv, tq, d), generator=gen, device=q.device)
           for _ in range(2)]
    tm = torch.ones((tq, tq), dtype=torch.bool, device=q.device).tril()
    merge = dict(tree_mask=tm, attn_softcap=kw["attn_softcap"],
                 scale=kw["scale"])
    parts = kern(*args, **kw)
    out = casc.merge_with_tree_block(q, *blk, *parts, **merge)
    with float_as_double():
        ref_parts = plain(*(x.double() if x.is_floating_point() else x
                            for x in args), **kw)
        ref_out = casc.merge_with_tree_block(
            q.double(), *(x.double() for x in blk), *ref_parts, **merge)
    live = ref_parts[1] > -1e29
    part = max(((x.double() - r).abs() / (1 + r.abs())).reshape(
        *live.shape, -1).amax(-1)[live].max().item()
        for x, r in zip(parts, ref_parts))
    return {"out_abs": (out.double() - ref_out).abs().max().item(),
            "partials": part, "n_splits": parts[0].shape[2]}


def shuffled_table(rng, b, mp, lens, n_phys, span, device):
    """Disjoint shuffled pages per row, one per ``span`` positions (the
    page size, or a pos_stride); unallocated tail = PAGE_SENTINEL."""
    from repro_torch.models.kvcache import PAGE_SENTINEL
    perm = list(rng.permutation(n_phys))
    pt = np.full((b, mp), PAGE_SENTINEL, np.int64)
    for i, cl in enumerate(lens):
        need = -(-int(cl) // span)
        pt[i, :need] = [perm.pop() for _ in range(need)]
    return torch.as_tensor(pt, dtype=torch.int32, device=device)


def case_inputs(gen, rng, dtype, kind, *, tq=76, hq=32, hkv=8, d=128,
                lens=LENS, s=1152, page=64, window=None, softcap=None,
                rolling=False, pos=None, nan=False, **split):
    """(wrapper, plain version, args, kwargs) of one case, on ``gen``'s
    device: q, then the dense cache [B,Hkv,S,D] (a view of the model's
    [B,S,Hkv,D] buffer; a rolling buffer as its own tensor) or the pool
    [P,Hkv,page,D] (a view of [P,page,Hkv,D]) and its page table.
    ``nan`` is the caller's; it changes no input."""
    from repro_torch.kernels import cascade_attention as casc
    dev = gen.device

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b = len(lens)
    q = rand(b, tq, hq, d).transpose(1, 2)
    cl = torch.tensor(lens, device=dev)
    kw = dict(cache_len=cl, q_abs=cl[:, None] + torch.arange(tq, device=dev),
              scale=d ** -0.5, window=window, attn_softcap=softcap, **split)
    if kind == "paged":
        span = pos[0] if pos else page
        mp = s // span + 1
        n_phys = b * mp + 3
        pool = [rand(n_phys, page, hkv, d).transpose(1, 2) for _ in range(2)]
        pt = shuffled_table(rng, b, mp, lens, n_phys, span, dev)
        if pos:
            kw.update(pos_stride=pos[0], pos_offset=pos[1])
        return (casc.cascade_phase1_paged, casc.cascade_phase1_paged_plain,
                (q, *pool, pt), kw)
    if rolling:
        cache = [rand(b, hkv, s, d) for _ in range(2)]
    else:
        cache = [rand(b, s, hkv, d).transpose(1, 2) for _ in range(2)]
    return (casc.cascade_phase1, casc.cascade_phase1_plain, (q, *cache),
            dict(kw, rolling=rolling))


def tf32_split(x):
    """The fp32 tensor-core kernels' split of an fp32 operand
    (``split_tf32`` in ``csrc/sm90_common.cuh``) as the tensor cores read
    it: big is x rounded to tf32 (10 mantissa bits) to nearest, ties away
    (half a tf32 ulp added to the bits, the low 13 cleared: cvt.rna);
    small = x - big, exact in fp32, truncated to tf32."""
    low = ~0x1FFF                       # clears the low 13 bits, as int32
    big = ((x.view(torch.int32) + 0x1000) & low).view(torch.float32)
    small = ((x - big).view(torch.int32) & low).view(torch.float32)
    return big, small


def einsum_3xtf32(eq, a, b):
    """``torch.einsum`` of fp32 operands as the kernels form each product:
    small*big + big*small, then big*big, each of tf32 operands (exact)
    summed in fp32."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    ein = _EINSUM
    return (ein(eq, as_, bb) + ein(eq, ab, bs)) + ein(eq, ab, bb)


_EINSUM = torch.einsum      # the real one, when a caller patches torch's

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, full width and depth

Phases, each printing one JSON line (any failure exits non-zero):

  build    nvcc the CUDA kernels from ``src/repro_torch/csrc`` (sm_90a)
  kernels  each cascade phase-1 kernel against its plain torch version and
           the oracle on the card, fp32 (the 3xTF32 tensor-core kernels of
           cascade_phase1.cu) and bf16 (the wgmma kernels of
           cascade_phase1_sm90.cu), the merge
           included: verify shapes (Hq 32, Hkv 8, D 128, Tq 16/64/76,
           ragged cache lengths, q in the model's layout), adversarial
           rolling capacities, a shuffled page table with sentinel
           entries, softcap 50, window 256 (splits that hold only masked
           keys), the pos_stride/pos_offset shard contract, pages of 8 and
           16, Tq 1 and 136, GQA groups 1 and 8, D 64 and 96, and outputs
           pre-filled with NaN (splits with no key must write acc = l = 0,
           m = -1e30), and head_dim 256 with 10 query heads over one
           (the hybrid's read pass: 20 rows, Tq 16, a rolling buffer of
           2048 wrapped; a capacity that wraps mid-split; Tq 1; softcap
           with window 256; paged); then timed at the decode verify
           shape and at the D 256 read-pass shape beside its bound, its
           plain version and one scaled_dot_product_attention call (the
           yardstick, never used by the port); and both fp32
           kernels at a 32k-token cache (the longest paper-target
           allows) with 8 splits and with 1, against the plain version
           in float64 (``cascade_cases.LONG_CASES``)
  flash    each flash kernel (forward, dq, dk/dv) against its plain torch
           version: the training shape (B 2, Hq 32, Hkv 8, D 128, T 4096,
           causal, the model's [B,T,H,D] layout), ragged cases (T 1000,
           q_offset 24, kv_len (1000, 931), window 512, softcap 50; GQA
           groups 4 and 1) and tile edges (T 129, a single query row, Tkv
           300 with kv_len ending mid-tile, Tq 128 over Tkv 384 so that
           two key tiles see no query, D 64 and 96), fp32 (the kernels of
           flash_attention.cu: the forward, dq and dk/dv in 3xTF32 on the
           tensor cores, each also called twice at the training shape and
           held bitwise equal) and bf16 (the wgmma kernels of
           flash_attention_sm90.cu); then timed at the
           training shape beside its bound, its plain version and
           scaled_dot_product_attention (forward; its autograd backward)
  main     greedy D^2SD ``generate`` in fp32 at the full width and depth of
           paper_target.full() with random seeded weights: 4 prompts of 512
           tokens, 64 new tokens, paged (page 64) and dense caches through
           the kernels; tokens held to the gather path and to plain
           one-token-at-a-time greedy; launch counts read: both fp32
           cascade kernels (cascade_phase1.cu), no bf16 one
  oracle   the same fp32 runs with drafts that hold the greedy reference,
           spoiled from a depth that varies by row and cycle, so a cycle
           accepts a path along the trunk and on into a branch (and, with
           the third level, on into a third-level branch): tokens held
           to the gather path and to plain greedy, alpha to the oracle's
           own count of what each cycle must accept, and the target and
           feature caches the cycles commit to a plain prefill of the
           same tokens
  graph_fp32  the main and oracle phases' fp32 kernel runs through
           ``generate_ondevice`` (one CUDA graph replay a cycle), paged and
           dense: tokens held to the eager run and to plain greedy, cycles
           to the eager run's, the oracle's alpha to its count and the
           caches the graph loop commits to a plain prefill
  graph_profile_fp32  six fp32 graph replays a cache (kernel path), timed
           unprofiled and then under torch.profiler: device ms per cycle,
           idle share, top kernels, and the fp32 phase-1 kernel
           (phase1_tf32x3_kernel) by name: its launches and device ms a
           replay; the launches of the loop's first cycle and capture
           held exact (40 paged, 36 dense)
  modes    fp32 greedy through ``generate_ondevice`` (kernel path, 32
           new tokens, the main path's model cut to 18 of its 36 layers:
           the run's time limit) in the modes beside d2sd: naive_k, eagle
           (drafter 1 causal), dflash_second (drafter 1 as drafter 2) and
           d2sd with the third level, paged and dense: tokens held to
           plain greedy, cascade launches a cycle held to the mode's count
           (18 dense; paged 20, 48, 22, 24: 18 target layers and 2 a
           drafter pass), the third level's host loop held to its graph
           loop; each mode's paged loop profiled (ms and device ms a
           replay, graph pool bytes, phase-1 launches by name)
  sampled  fp32 d2sd at temperature 1, paged, kernel path, one seed (18
           layers, as modes): the
           graph loop's tokens and every cycle's acceptance uniforms
           held to the host loop's (and no two cycles' uniforms equal),
           the gather path's agreement reported, the graph loop
           profiled; then the lossless check at tiny size through the
           kernels (one cycle over 2000 copies of a prompt: TV of the
           first token against the target's softmax, every mode)
  serving  fp32 ``ServingEngine`` (batch 4, pages of 64, a pool of 160) at
           the main path's model cut to 18 of its 36 layers (the run's
           time limit), gamma 16, K 4: 10 requests behind a
           320-token system prompt (two sharing 352 tokens, one a second
           turn over an earlier answer; ``max_new`` 8-48; the first
           request served before the other nine) through legacy waves,
           dense refill, the paged engine pool, and the pool with the
           prefix cache through the kernels and through the gather path:
           per-request tokens equal across the runs and to plain greedy,
           prefix hits >= 8, COW copies >= 1, legacy row-cycles above
           refill's, the pool's books balanced after each run with every
           page in use the radix tree's, launches through #1 (dense) and
           #2 (paged) from the wrappers, and #2 held to its plain version
           on a live page table with shared pages and sentinel tails
  bf16     the same runs in bfloat16 (the config's dtype), paged and dense:
           tokens/s, agreement with the gather path (where a row first
           leaves it, the top-2 gap of a plain bf16 forward over the shared
           context must be a near tie in bf16 ulps), and at least 40
           (paged: 36 target layers, 2 x 2 drafter layers) or 36 (dense)
           launches a cycle through the bf16 cascade kernels
           (cascade_phase1_sm90.cu) and none through cascade_phase1.cu
  profile  six bf16 decode cycles (kernel path, paged cache) under
           torch.profiler: device time per cycle, the device's idle share
           and the kernels that take the most device time
  graph_bf16  the bf16 kernel runs of both caches through
           ``generate_ondevice``, beside the eager ones of this run: ms per
           cycle, decode tokens/s, capture time, graph pool bytes, token
           agreement with the eager run
  graph_profile  the same for six bf16 graph replays a cache, the
           phase-1 kernel being phase1_sm90_kernel (launches held exact
           through the sm90 kernels)
  modes_bf16  each mode of the modes phase and d2sd sampled in bf16
           (18 layers, as modes), paged, graph loop: ms a replay, decode tokens/s, launches
           through the sm90 kernels, profile
  serving_bf16  the serving requests in bfloat16 (18 layers, as
           serving) as a Poisson trace at 1 request/s through the overlapped front end and the
           synchronous baseline (paged, prefix cache, kernel path, the
           card's own clock): ms a cycle, engine cycles, tokens over the
           replay's wall time (set by the arrivals), TTFT and TPOT p50
           and max; each request's tokens held to a gather run's by the
           bf16 near-tie rule. A smoke reading of the path, not a serving
           metric: ten requests have no tail, and the slots are not kept
           full
  hybrid   recurrentgemma-2b at full width and depth (26 layers: RG-LRU
           blocks and MQA sliding-window layers of head_dim 256, vocab
           256000), random seeded weights, two drafters sized by JAX's
           production_drafter rule, gamma 16, K 4, 64 new tokens for 4
           prompts of 2000-2040 tokens (ragged: every row's rolling local
           buffers wrap): fp32 through the state-replay verifier, the
           kernel path through the host loop (paged) and the graph loop
           (both caches), the gather path through the graph loop (both
           caches); tokens held to plain greedy and to the gather path
           (near ties only), the graph loop's to the host loop's, cascade
           launches a cycle exact (#1 one a local layer: 8; #2 one a
           drafter layer and pass on a paged cache: 4; a graph run counts
           its eager first cycle and its capture); then bf16: six graph
           replays a cache profiled (wall and device ms a replay, idle
           share), the launches of the loop's first cycle and capture
           through the sm90 kernels held exact
  ssm      the same for rwkv6-1.6b (24 RWKV-6 layers, attention-free, d
           2048, vocab 65536) with 4 prompts of 512 and 32 new tokens:
           #1 0, #2 4 a paged cycle
  serving_recurrent  fp32 ``ServingEngine`` over the hybrid target,
           kernel path: the serving phase's 10 requests through dense
           refill and the paged engine pool (paged drafter feature
           caches; the prefix cache needs an all-global target):
           per-request tokens equal across both runs and to plain greedy
  moe      grok-1-314b (8 experts, top 2) at full width in fp32, cut to
           2 of 64 layers (45.8 GB), capacity factor 1.25: the kernel
           path on paged and dense caches through the host loop and the
           graph loop, the gather path on both: the graph loop's tokens
           held to the host loop's, the kernel path's to the gather
           path's (a first divergence passes only on a near tie of the
           logits);
           agreement with plain greedy and the (token, expert) pairs the
           verify passes dropped, worked out from the routing, reported;
           the same model at capacity factor E/k (nothing can drop) held
           to plain greedy; grok-1 in bf16 at 4 layers, six graph
           replays profiled (paged); kimi-k2-1t-a32b (384 experts, top 8,
           a shared expert) in bf16 at 1 of 61 layers, kernel against
           gather by the bf16 near-tie rule
  ctx      llama-3.2-vision-11b (8 cross layers over 1601 random vision
           tokens) and whisper-medium (24 encoder layers over 1500 random
           frames, then the decoder over the encoder's output) at full
           size in fp32 through ``generate(ctx=)``: the kernel path on
           paged and dense caches and the gather path, tokens held to
           each other and to plain greedy (a prefill with the context,
           then one-token steps that read the cross caches)
  archs    qwen2.5-3b, gemma2-2b and stablelm-3b at full size and
           internlm2-20b at full width cut to 16 of 48 layers, fp32,
           paged: the kernel path held to the gather path and plain
           greedy. Each of these three phases: 4 prompts of 512, 32 new
           tokens, random seeded weights, drafters by JAX's
           production_drafter rule, exact cascade launches a host cycle
  train_fp32   paper_target.full() cut to 8 layers (the only cut; 2.79e9
           params, AdamW as optimizer_for picks), remat on, batch 2 x 4096
           tokens of the mixture stream: three steps through the fp32 flash
           kernels and three through the plain chunked attention, from the
           same seeded weights and batches; loss and grad norm per step
           and the params after step 3 held to each other
  train_bf16   the same model in bf16: three steps through the plain
           chunked attention, then through the kernels one warm-up and
           five timed steps; the first three losses held to the plain
           path's, ms/step, tokens/s, peak memory, and 16 / 8 / 8 launches
           per step of the tensor-core forward / dq / dk-dv kernels
           (flash_fwd_sm90, flash_bwd_dq_sm90, flash_bwd_dkv_sm90) and
           none of the fp32 ones
  train_profile  one bf16 step under torch.profiler: device time, idle
           share, top kernels

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` next to this file, it exits non-zero and
prints no result. It takes no arguments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
DEVICE = "cuda"
MAX_NEW = 64                                # tokens generated per row
GAMMA, K_BRANCHES = 16, 4                   # 76 tree nodes per row
PEAK_BYTES_S = 3.35e12                      # H100 SXM HBM3
PEAK_BF16 = 989e12                          # bf16 tensor cores, dense
PEAK_TF32 = 495e12                          # TF32 tensor cores, dense: the
                                            # fp32 kernels form each
                                            # product from three TF32 ones
NEAR_TIE = 1e-4                             # top-2 logit gap that may flip
NEAR_TIE_BF16_ULPS = 4      # bf16: the same rule, the gap counted in bf16
                            # ulps of the top logit (2^-5 at the random
                            # weights' top logits, 4 to 8): each path rounds
                            # each logit to bf16 (up to 1 ulp apart, so 2 on
                            # a gap) and reads a bf16 residual stream that
                            # the two read paths round differently over 36
                            # layers (about 2 more); a wrong read moves the
                            # logits by far more (top-2 spacing ~8 ulps)
# the kernel gates TOL_OUT, TOL_PART (cascade), TOL_FLASH and TOL_LSE
# (flash): kernels/cascade_cases.py
TOL_CACHE = 1e-3    # committed fp32 caches vs a prefill of the same tokens,
                    # relative to the largest value: sum order only
TRAIN_LAYERS = 8    # paper-target cut in depth only: 2.79e9 params
TOL_TRAIN_LOSS = 1e-5   # fp32 step loss, kernel vs plain path, relative
TOL_TRAIN_GNORM = 1e-4  # fp32 global grad norm, relative
TOL_TRAIN_PARAM = 1e-3  # fp32 params after step 3: mean |kernel - plain|
                        # over mean |move from init|. The max is bounded by
                        # 2 * sum(lr): an element whose grad is rounding
                        # from zero may take an Adam step of either sign
TOL_TRAIN_BF16_LOSS = 2e-2  # bf16 step loss, kernel vs plain path, first
                        # three steps, relative: the kernels round P and dS
                        # to bf16 where the plain path keeps fp32


def emit(obj):
    """One phase's JSON line, stamped with the seconds since the script
    started (``at_s``)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing --
class Timer:
    """CUDA-event timing of one launch at a time, with the 50 MB L2 flushed
    before each (every layer's cache is read once per cycle, cold)."""

    def __init__(self):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                 device=DEVICE)

    def ms(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in pairs]))


# ----------------------------------------------------------- kernel checks --
def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _case_inputs(gen, rng, dtype, case):
    """One case of ``cascade_cases.CASES``: its (kernel, plain, oracle)
    callables and its merge inputs: q, the tree block, its mask, the
    scale and the softcap."""
    from repro_torch.kernels import cascade_cases
    from repro_torch.kernels import ref
    kern, plain, args, kw = cascade_cases.case_inputs(gen, rng, dtype,
                                                      **case)
    q, ck, cv = args[:3]
    b, hkv, tq, d = q.shape[0], ck.shape[1], q.shape[2], q.shape[3]
    bk, bv = (_rand(gen, (b, hkv, tq, d), dtype) for _ in range(2))
    tm = torch.ones((tq, tq), dtype=torch.bool, device=DEVICE).tril()
    oracle_kw = dict(cache_len=kw["cache_len"], q_abs=kw["q_abs"],
                     tree_mask=tm, window=kw["window"],
                     attn_softcap=kw["attn_softcap"])
    if case["kind"] == "paged":
        oracle = None if "pos_stride" in kw else (
            lambda: ref.cascade_attention_paged_ref(
                q.float(), ck, cv, args[3], bk, bv, **oracle_kw))
    else:
        oracle = lambda: ref.cascade_attention_ref(
            q.float(), ck, cv, bk, bv, rolling=kw["rolling"], **oracle_kw)
    return ((lambda: kern(*args, **kw), lambda: plain(*args, **kw), oracle),
            (q, bk, bv, tm, kw["scale"], kw["attn_softcap"]))


def _nan_outputs():
    """A stand-in for the wrappers' output allocator that fills with NaN."""
    from repro_torch.kernels import cascade_attention as casc
    real = casc._outputs
    return lambda *a: tuple(x.fill_(float("nan")) for x in real(*a))


def _compare(kern, plain, ref_out, merge_args):
    """Errors of one case: the merged outputs (kept in fp32: q upcast, so
    no final rounding to the input dtype) of kernel vs plain version and
    vs the oracle, absolute and over max |plain|; the live partials (m and
    l relative to 1 + |plain|; acc the same in fp32, and in bf16 relative
    to the largest |plain acc| of its row and split). Every partial the
    kernel wrote must be finite, and a split with no key in range (l = 0)
    must hold acc = 0 and m = -1e30."""
    from repro_torch.kernels import cascade_attention as casc
    q, bk, bv, tm, scale, softcap = merge_args
    if not all(torch.isfinite(x).all() for x in kern):
        fail("a cascade kernel wrote a partial that is not finite")
    empty = kern[2] == 0
    if not ((kern[0][empty] == 0).all() and (kern[1][empty] == -1e30).all()):
        fail("a cascade kernel's empty split is not acc = 0, m = -1e30")
    outs = [casc.merge_with_tree_block(q.float(), bk, bv, *parts,
                                       tree_mask=tm, attn_softcap=softcap,
                                       scale=scale).float()
            for parts in (kern, plain)]
    err = {"out_abs": (outs[0] - outs[1]).abs().max().item()}
    err["out_rel"] = err["out_abs"] / outs[1].abs().max().item()
    if ref_out is not None:
        d = (outs[0] - ref_out.float()).abs().max().item()
        err["ref_abs"] = d
        err["ref_rel"] = d / ref_out.float().abs().max().item()
    live = plain[1] > -1e29
    if q.dtype == torch.bfloat16:
        acc = (kern[0] - plain[0]).abs().amax(-1) / plain[0].abs().amax(
            -1).clamp_min(1e-30)
    else:
        acc = ((kern[0] - plain[0]).abs() / (1 + plain[0].abs())).amax(-1)
    err["acc"] = acc[live].max().item() if live.any() else 0.0
    err["m_l"] = max(((a - b_).abs() / (1 + b_.abs()))[live].max().item()
                     if live.any() else 0.0
                     for a, b_ in zip(kern[1:], plain[1:]))
    return err


def _within_tol(dtype, err):
    """fp32: merged outputs within TOL_OUT absolute, partials TOL_PART;
    bf16: merged outputs and acc within TOL_FLASH[bf16] relative (P is
    rounded to bf16 for P V), m and l TOL_PART."""
    from repro_torch.kernels.cascade_cases import (TOL_FLASH, TOL_OUT,
                                                   TOL_PART)
    if dtype == torch.float32:
        return (max(err["out_abs"], err.get("ref_abs", 0.0)) <= TOL_OUT
                and max(err["acc"], err["m_l"]) <= TOL_PART)
    tol = TOL_FLASH[torch.bfloat16]
    return (max(err["out_rel"], err.get("ref_rel", 0.0), err["acc"]) <= tol
            and err["m_l"] <= TOL_PART)


def check_kernels(timer):
    """Every case of ``cascade_cases.CASES`` through both wrappers, in
    both dtypes, against the plain version and the oracle; then the
    timings."""
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.kernels import cascade_cases
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    cases = []
    worst = {}                  # max |merged kernel - plain|, by row name
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for case_name, case in cascade_cases.CASES.items():
            (kern_fn, plain_fn, ref_fn), merge_args = _case_inputs(
                gen, rng, dtype, case)
            real = casc._outputs
            if case.get("nan"):
                casc._outputs = _nan_outputs()
            try:
                kern = kern_fn()
            finally:
                casc._outputs = real
            err = _compare(kern, plain_fn(), ref_fn and ref_fn(),
                           merge_args)
            wrapper = ("cascade_phase1_paged" if case["kind"] == "paged"
                       else "cascade_phase1")
            name = wrapper + ("_sm90" if dtype == torch.bfloat16 else "")
            rec = {"kernel": name, "dtype": dn, "case": case_name, **err}
            cases.append(rec)
            worst[name] = max(worst.get(name, 0.0), err["out_abs"],
                              err.get("ref_abs", 0.0))
            if not _within_tol(dtype, err):
                fail(f"{name} disagrees with its plain version: {rec}")
    long_splits = []
    for case_name, case in cascade_cases.LONG_CASES.items():
        # the fp32 accumulator over long splits, against float64
        err = cascade_cases.long_split_errors(gen, rng, case)
        name = ("cascade_phase1_paged" if case["kind"] == "paged"
                else "cascade_phase1")
        rec = {"kernel": name, "dtype": "float32", "case": case_name, **err}
        long_splits.append(rec)
        worst[name] = max(worst[name], err["out_abs"])
        if err["out_abs"] > cascade_cases.TOL_OUT \
                or err["partials"] > cascade_cases.TOL_PART:
            fail(f"{name} over a long split is off its float64 reference: "
                 f"{rec}")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    timing = time_kernels(timer, gen, rng)
    emit({"phase": "kernels", "ok": True, "n_cases": len(cases),
          "long_splits": long_splits,
          "tol": {"float32": {"out_abs": cascade_cases.TOL_OUT,
                              "partials": cascade_cases.TOL_PART},
                  "bfloat16": {"out_rel": cascade_cases.TOL_FLASH[
                                   torch.bfloat16],
                               "acc_rel": cascade_cases.TOL_FLASH[
                                   torch.bfloat16],
                               "m_l": cascade_cases.TOL_PART}},
          "cases": cases, "max_abs_err": worst, "timing": timing})
    return worst, timing


def _bound(dtype, live_tokens, b, hq, hkv, tq, d, ns):
    """Least time for the same work: each live K/V byte, q and the outputs
    moved once, or the QK and PV FLOPs on the route the kernel takes (bf16
    on the tensor cores; fp32 as 3xTF32 on the tensor cores, three TF32
    FLOPs a FLOP)."""
    es = torch.tensor([], dtype=dtype).element_size()
    byts = (2 * hkv * live_tokens * d * es + b * hq * tq * d * es
            + b * hq * ns * tq * (d + 2) * 4)
    flops = 4 * hq * tq * live_tokens * d
    t_b = byts / PEAK_BYTES_S * 1e3
    t_f = (3 * flops / PEAK_TF32 if dtype == torch.float32
           else flops / PEAK_BF16) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_kernels(timer, gen, rng):
    """Each kernel at the main path's verify shapes: B=4 rows, Tq=76 tree
    nodes (gamma 16, K 4), caches of max_len 616 at lengths 520-600."""
    import torch.nn.functional as F
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.kernels import cascade_cases
    from repro_torch.kernels import ref
    hq, hkv, d, tq = 32, 8, 128, 76
    lens = [520, 560, 580, 600]
    b, s, page = len(lens), 616, 64
    mp = -(-s // page)
    scale = d ** -0.5
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q = _rand(gen, (b, hq, tq, d), dtype)
        bk, bv = (_rand(gen, (b, hkv, tq, d), dtype) for _ in range(2))
        cl = torch.tensor(lens, device=DEVICE)
        qa = cl[:, None] + torch.arange(tq, device=DEVICE)
        tm = torch.ones((tq, tq), dtype=torch.bool, device=DEVICE).tril()
        kw = dict(cache_len=cl, q_abs=qa, scale=scale)
        # dense: the model's [B,S,Hkv,D] buffer as a strided view
        ck, cv = (_rand(gen, (b, s, hkv, d), dtype).transpose(1, 2)
                  for _ in range(2))
        pk, pv = (_rand(gen, (b * mp, page, hkv, d), dtype).transpose(1, 2)
                  for _ in range(2))
        pt = cascade_cases.shuffled_table(rng, b, mp, lens, b * mp, page,
                                          DEVICE)

        def sdpa(kc, vc):
            # one library call over the gathered [cache ++ block], bool mask
            kk = torch.cat([kc, bk], 2).repeat_interleave(hq // hkv, 1)
            vv = torch.cat([vc, bv], 2).repeat_interleave(hq // hkv, 1)
            slot = torch.arange(kc.shape[2], device=DEVICE)
            ok = (slot[None, None] < cl[:, None, None]) & (
                slot[None, None] <= qa[:, :, None])
            mask = torch.cat([ok, tm[None].expand(b, tq, tq)], -1)[:, None]
            return lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, scale=scale)

        live = sum(lens)
        gathered = ref.gather_pages(pk, pt)
        entries = {
            "cascade_phase1": (
                lambda: casc.cascade_phase1(q, ck, cv, **kw),
                lambda: casc.cascade_phase1_plain(q, ck, cv, **kw),
                sdpa(ck, cv), casc._split_geometry(s, 8, 512)[1]),
            "cascade_phase1_paged": (
                lambda: casc.cascade_phase1_paged(q, pk, pv, pt, **kw),
                lambda: casc.cascade_phase1_paged_plain(q, pk, pv, pt, **kw),
                sdpa(gathered, ref.gather_pages(pv, pt)),
                casc._paged_geometry(mp, 8)[0]),
        }
        for name, (kern, plain, lib, ns) in entries.items():
            bound, by = _bound(dtype, live, b, hq, hkv, tq, d, ns)
            out.setdefault(name, {})[dn] = {
                "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
                "library_ms": timer.ms(lib), "bound_ms": bound,
                "bound_by": by, "shape": {"B": b, "Hq": hq, "Hkv": hkv,
                                          "Tq": tq, "D": d, "lens": lens,
                                          "S": s, "page": page}}
        for name, rec in time_kernels_d256(timer, gen, rng, dtype).items():
            out[name][dn + "_d256"] = rec
    return out


def device_ms(fn, n=10):
    """Device time of one call of ``fn`` (torch.profiler, the mean of
    ``n`` calls after one untraced one), None if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(r[1] for r in _device_rows(prof))
    return busy / n or None


def time_kernels_d256(timer, gen, rng, dtype):
    """Both cascade kernels at head_dim 256, the shape of the hybrid
    target's state-replay read pass (recurrentgemma-2b: B*R = 20 folded
    rows, Tq 16, Hq 10 over Hkv 1; #1 over rolling buffers of 2048 at
    lengths 2049-2153, window 2048; #2 over a pool of 64-key pages at the
    same lengths): ms and device ms a call beside the bound, the plain
    version and one scaled_dot_product_attention call over the gathered
    keys."""
    import torch.nn.functional as F
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.kernels import cascade_cases
    from repro_torch.kernels import ref
    hq, hkv, d, tq, cap, page = 10, 1, 256, 16, 2048, 64
    lens = list(cascade_cases.HYBRID_LENS)
    b = len(lens)
    mp = -(-max(lens) // page)
    scale = d ** -0.5
    q = _rand(gen, (b, tq, hq, d), dtype).transpose(1, 2)
    bk, bv = (_rand(gen, (b, hkv, tq, d), dtype) for _ in range(2))
    cl = torch.tensor(lens, device=DEVICE)
    qa = cl[:, None] + torch.arange(tq, device=DEVICE)
    tm = torch.ones((tq, tq), dtype=torch.bool, device=DEVICE).tril()
    ck, cv = (_rand(gen, (b, cap, hkv, d), dtype).transpose(1, 2)
              for _ in range(2))
    pk, pv = (_rand(gen, (b * mp, page, hkv, d), dtype).transpose(1, 2)
              for _ in range(2))
    pt = cascade_cases.shuffled_table(rng, b, mp, lens, b * mp, page, DEVICE)
    dense_kw = dict(cache_len=cl, q_abs=qa, scale=scale, window=cap,
                    rolling=True)
    paged_kw = dict(cache_len=cl, q_abs=qa, scale=scale)

    def sdpa(kc, vc, kpos, window):
        ok = (kpos[:, None] >= 0) & (kpos[:, None] < cl[:, None, None]) & (
            kpos[:, None] <= qa[:, :, None])
        if window:
            ok &= kpos[:, None] > qa[:, :, None] - window
        kk = torch.cat([kc, bk], 2).repeat_interleave(hq // hkv, 1)
        vv = torch.cat([vc, bv], 2).repeat_interleave(hq // hkv, 1)
        mask = torch.cat([ok, tm[None].expand(b, tq, tq)], -1)[:, None]
        return lambda: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=mask, scale=scale)

    slot = torch.arange(cap, device=DEVICE)[None]
    last = cl[:, None] - 1
    roll_pos = last - torch.fmod(last - slot, cap)
    gathered = ref.gather_pages(pk, pt), ref.gather_pages(pv, pt)
    page_pos = torch.arange(gathered[0].shape[2], device=DEVICE)[None]
    entries = {
        "cascade_phase1": (
            lambda: casc.cascade_phase1(q, ck, cv, **dense_kw),
            lambda: casc.cascade_phase1_plain(q, ck, cv, **dense_kw),
            sdpa(ck, cv, roll_pos, cap),
            casc._split_geometry(cap, 8, 512)[1],
            sum(min(n, cap) for n in lens)),
        "cascade_phase1_paged": (
            lambda: casc.cascade_phase1_paged(q, pk, pv, pt, **paged_kw),
            lambda: casc.cascade_phase1_paged_plain(q, pk, pv, pt,
                                                    **paged_kw),
            sdpa(*gathered, page_pos.expand(b, -1), None),
            casc._paged_geometry(mp, 8)[0], sum(lens)),
    }
    out = {}
    for name, (kern, plain, lib, ns, live) in entries.items():
        bound, by = _bound(dtype, live, b, hq, hkv, tq, d, ns)
        out[name] = {
            "ms": timer.ms(kern), "device_ms": device_ms(kern),
            "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
            "bound_ms": bound, "bound_by": by,
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "Tq": tq, "D": d,
                      "lens": [min(lens), max(lens)], "live_keys": live,
                      "S": cap if name == "cascade_phase1" else None,
                      "page": page if name != "cascade_phase1" else None}}
    return out


# each cascade kernel by its name in the kernels line: (wrapper, dtype,
# source, line of the Pallas body it replaces in
# src/repro/kernels/cascade_attention.py)
CASCADE_KERNELS = {
    "cascade_phase1_sm90": ("cascade_phase1", torch.bfloat16,
                            "cascade_phase1_sm90.cu", 45),
    "cascade_phase1_paged_sm90": ("cascade_phase1_paged", torch.bfloat16,
                                  "cascade_phase1_sm90.cu", 243),
    "cascade_phase1": ("cascade_phase1", torch.float32,
                       "cascade_phase1.cu", 45),
    "cascade_phase1_paged": ("cascade_phase1_paged", torch.float32,
                             "cascade_phase1.cu", 243)}


# ------------------------------------------------------------ flash checks --
FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")
# each flash kernel by its C entry point: (wrapper, dtype, source, line of
# the Pallas body it replaces in src/repro/kernels/flash_attention.py)
FLASH_KERNELS = {
    "flash_fwd_sm90": ("flash_attention_fwd", torch.bfloat16,
                       "flash_attention_sm90.cu", 40),
    "flash_bwd_dq_sm90": ("flash_attention_bwd_dq", torch.bfloat16,
                          "flash_attention_sm90.cu", 146),
    "flash_bwd_dkv_sm90": ("flash_attention_bwd_dkv", torch.bfloat16,
                           "flash_attention_sm90.cu", 189),
    "flash_fwd": ("flash_attention_fwd", torch.float32,
                  "flash_attention.cu", 40),
    "flash_bwd_dq": ("flash_attention_bwd_dq", torch.float32,
                     "flash_attention.cu", 146),
    "flash_bwd_dkv": ("flash_attention_bwd_dkv", torch.float32,
                      "flash_attention.cu", 189)}
TRAIN_B, TRAIN_T = 2, 4096                  # batch and sequence of a step


def live_pairs(tq, tkv, q_offset, window, kv_len, causal=True):
    """(query, key) pairs the mask keeps, per query head: the work of a
    flash call on these inputs."""
    qpos = torch.arange(tq) + q_offset
    total = 0
    for kl in kv_len:
        hi = torch.clamp(qpos + 1, max=kl) if causal else torch.full_like(
            qpos, kl)
        lo = torch.clamp(qpos - window + 1, min=0) if window else 0
        total += int(torch.clamp(hi - lo, min=0).sum())
    return total


def _flash_bound(name, dtype, b, hq, hkv, tq, tkv, d, pairs):
    """Least time: FLOPs of the GEMMs the kernel computes per live pair
    (forward 2, dq 3, dk/dv 4) at the peak of its route (bf16 tensor
    cores; fp32 as 3xTF32 on the tensor cores, three TF32 FLOPs a FLOP),
    or each input read and each output written once at HBM rate."""
    es = torch.tensor([], dtype=dtype).element_size()
    q_b, kv_b, rows = b * hq * tq * d * es, b * hkv * tkv * d * es, b * hq * tq
    gemms, byts = {
        "flash_attention_fwd": (2, 2 * q_b + 2 * kv_b + 4 * rows),
        "flash_attention_bwd_dq": (3, 3 * q_b + 2 * kv_b + 8 * rows),
        "flash_attention_bwd_dkv": (4, 2 * q_b + 4 * kv_b + 8 * rows)}[name]
    flops = 2 * gemms * d * pairs * hq
    t_f = (3 * flops / PEAK_TF32 if dtype == torch.float32
           else flops / PEAK_BF16) * 1e3
    t_b = byts / PEAK_BYTES_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _flash_inputs(gen, b, hq, hkv, tq, tkv, d, dtype, bthd):
    """q, k, v, do: [B,H,T,D] views of [B,T,H,D] buffers (the model's
    layout) when ``bthd``, else contiguous."""
    def mk(h, t):
        if bthd:
            return _rand(gen, (b, t, h, d), dtype).transpose(1, 2)
        return _rand(gen, (b, h, t, d), dtype)
    return mk(hq, tq), mk(hkv, tkv), mk(hkv, tkv), mk(hq, tq)


def check_flash(timer):
    """Each flash kernel against its plain version on the card: the
    training shape (B 2, Hq 32, Hkv 8, D 128, T 4096, causal), ragged
    cases (T 1000, q_offset 24, kv_len (1000, 931), window 512, softcap
    50; GQA groups 4 and 1, D 128 and 64) and the tensor-core kernels'
    tile edges (T 129: a 128-row block and one row more; one query row
    over 300 keys; Tq 200 over Tkv 300 with kv_len 237 ending inside a
    key tile; Tq 128 over Tkv 384, whose last two key tiles no query
    sees, so dk/dv must be zero there; D 64 and D 96, the last
    zero-filled to 128, in the [B,T,H,D] layout), fp32 and bf16. Each
    backward kernel takes the plain forward's (o, lse), so each kernel is
    held alone. o, lse and dq are compared over rows with a live key.
    The fp32 kernels are also called a second time at the training shape
    and must give bitwise the same o, lse, dq, dk and dv (no atomics: the
    fp32 training step is deterministic)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.cascade_cases import TOL_FLASH, TOL_LSE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    cases = []
    worst = {n: {} for n in FLASH}            # relative, as the tolerance
    worst_abs = {n: {} for n in FLASH}
    ragged = dict(causal=True, q_offset=24, kv_len=[1000, 931], window=512,
                  attn_softcap=50.0)
    shapes = [dict(b=TRAIN_B, hq=32, hkv=8, tq=TRAIN_T, tkv=TRAIN_T, d=128,
                   bthd=True, kw=dict(causal=True)),
              dict(b=2, hq=32, hkv=8, tq=1000, tkv=1000, d=128, bthd=False,
                   kw=ragged),
              dict(b=2, hq=8, hkv=8, tq=1000, tkv=1000, d=64, bthd=True,
                   kw=ragged),
              dict(b=2, hq=8, hkv=2, tq=129, tkv=129, d=128, bthd=True,
                   kw=dict(causal=True)),
              dict(b=2, hq=8, hkv=2, tq=1, tkv=300, d=128, bthd=True,
                   kw=dict(causal=True, q_offset=299)),
              dict(b=2, hq=8, hkv=2, tq=200, tkv=300, d=128, bthd=True,
                   kw=dict(causal=True, q_offset=100, kv_len=[300, 237])),
              dict(b=2, hq=8, hkv=2, tq=128, tkv=384, d=128, bthd=True,
                   kw=dict(causal=True)),
              dict(b=2, hq=8, hkv=2, tq=129, tkv=129, d=64, bthd=True,
                   kw=dict(causal=True)),
              dict(b=2, hq=8, hkv=2, tq=129, tkv=129, d=96, bthd=True,
                   kw=dict(causal=False, kv_len=[129, 70]))]
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_FLASH[dtype]
        dn = str(dtype).replace("torch.", "")
        for sh in shapes:
            q, k, v, do = _flash_inputs(gen, sh["b"], sh["hq"], sh["hkv"],
                                        sh["tq"], sh["tkv"], sh["d"], dtype,
                                        sh["bthd"])
            kw = dict(sh["kw"])
            if "kv_len" in kw:
                kw["kv_len"] = torch.tensor(kw["kv_len"], device=DEVICE)
            o_k, lse_k = fa.flash_attention_fwd(q, k, v, **kw)
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
            delta = (do.float() * o_p.float()).sum(-1)
            args = (q, k, v, do, lse_p, delta)
            dq_k = fa.flash_attention_bwd_dq(*args, **kw)
            dq_p = fa.flash_attention_bwd_dq_plain(*args, **kw)
            dk_k, dv_k = fa.flash_attention_bwd_dkv(*args, **kw)
            dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(*args, **kw)
            if dtype == torch.float32 and sh is shapes[0]:
                same = {"o_lse": all(map(torch.equal, (o_k, lse_k),
                                         fa.flash_attention_fwd(q, k, v,
                                                                **kw))),
                        "dq": torch.equal(
                            dq_k, fa.flash_attention_bwd_dq(*args, **kw)),
                        "dk_dv": all(map(torch.equal, (dk_k, dv_k),
                                         fa.flash_attention_bwd_dkv(
                                             *args, **kw)))}
                if not all(same.values()):
                    fail(f"the fp32 flash kernels are not deterministic: "
                         f"{same}")
            torch.cuda.synchronize()
            live = lse_p > -1e29                           # [B,Hq,T]

            def err(pairs, rows=None):
                """(max |diff| / max |plain|, max |diff|) over pairs."""
                rel = ab = 0.0
                for a, b_ in pairs:
                    a, b_ = a.float(), b_.float()
                    if rows is not None:
                        a, b_ = a[rows], b_[rows]
                    if not (torch.isfinite(a).all() and
                            torch.isfinite(b_).all()):
                        fail("a flash output is not finite")
                    d = (a - b_).abs().max().item()
                    rel = max(rel, d / b_.abs().max().item())
                    ab = max(ab, d)
                return rel, ab

            errs = {"flash_attention_fwd": err([(o_k, o_p)], live),
                    "flash_attention_bwd_dq": err([(dq_k, dq_p)], live),
                    "flash_attention_bwd_dkv": err([(dk_k, dk_p),
                                                    (dv_k, dv_p)])}
            lse_err = (lse_k[live] - lse_p[live]).abs().max().item()
            case = {"dtype": dn,
                    **{k_: v_ for k_, v_ in sh.items() if k_ != "kw"},
                    **{k_: (v_ if not torch.is_tensor(v_) else v_.tolist())
                       for k_, v_ in kw.items()},
                    "rel_err": {n: e[0] for n, e in errs.items()},
                    "abs_err": {n: e[1] for n, e in errs.items()},
                    "lse_abs_err": lse_err,
                    "live_rows": float(live.float().mean())}
            cases.append(case)
            for n, (e, ab) in errs.items():
                worst[n][dn] = max(worst[n].get(dn, 0.0), e)
                worst_abs[n][dn] = max(worst_abs[n].get(dn, 0.0), ab)
            if max(e[0] for e in errs.values()) > tol or lse_err > TOL_LSE:
                fail(f"a flash kernel disagrees with its plain version: "
                     f"{case}")
            del o_k, o_p, dq_k, dq_p, dk_k, dk_p, dv_k, dv_p
    timing = time_flash(timer, gen)
    emit({"phase": "flash", "ok": True, "n_cases": len(cases),
          "fp32_bitwise_repeatable": same,
          "tol": {str(k).replace("torch.", ""): v
                  for k, v in TOL_FLASH.items()}, "tol_lse": TOL_LSE,
          "cases": cases, "max_rel_err": worst, "max_abs_err": worst_abs,
          "timing": timing})
    return worst_abs, timing


def time_flash(timer, gen):
    """Each flash kernel at the training shape, causal, in the model's
    layout: its time, its plain version's, one
    scaled_dot_product_attention call (forward for #3; its autograd
    backward for #4 and #5 together) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, t, d = TRAIN_B, 32, 8, TRAIN_T, 128
    pairs = live_pairs(t, t, 0, None, [t] * b)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v, do = _flash_inputs(gen, b, hq, hkv, t, t, d, dtype, True)
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        bw = (q, k, v, do, lse, delta)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                               enable_gqa=True)
        entries = {
            "flash_attention_fwd": (
                lambda: fa.flash_attention_fwd(q, k, v),
                lambda: fa.flash_attention_fwd_plain(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)),
            "flash_attention_bwd_dq": (
                lambda: fa.flash_attention_bwd_dq(*bw),
                lambda: fa.flash_attention_bwd_dq_plain(*bw),
                lambda: torch.autograd.grad(lib_o, (ql, kl, vl), do,
                                            retain_graph=True)),
            "flash_attention_bwd_dkv": (
                lambda: fa.flash_attention_bwd_dkv(*bw),
                lambda: fa.flash_attention_bwd_dkv_plain(*bw), None)}
        lib_bwd = None
        for name, (kern, plain, lib) in entries.items():
            bound, by = _flash_bound(name, dtype, b, hq, hkv, t, t, d, pairs)
            if lib is not None:
                lib_ms = timer.ms(lib, warmup=2)
                lib_bwd = lib_ms
            else:
                lib_ms = lib_bwd       # one backward call gives dq, dk, dv
            out.setdefault(name, {})[dn] = {
                "ms": timer.ms(kern, warmup=2),
                "plain_ms": timer.ms(plain, warmup=2),
                "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                "shape": {"B": b, "Hq": hq, "Hkv": hkv, "T": t, "D": d,
                          "causal": True, "live_pairs_per_q_head": pairs}}
        del lib_o, ql, kl, vl
    return out


# ------------------------------------------------------------- main path --
def greedy_reference(params, cfg, prompts, n, true_len=None, ctx=None):
    """Plain greedy decoding, one token at a time over a dense cache.
    ``true_len`` [B]: ragged prompts, padded in ``prompts``. ``ctx``: a
    cross-attention target's context, which the prefill writes into the
    cross caches and every step reads. Returns (tokens [B, n], top-2
    logit gap at each step [B, n])."""
    from repro_torch.models import lm
    b, p = prompts.shape
    states = lm.init_states(cfg, b, p + n + 4, device=prompts.device,
                            ctx_len=0 if ctx is None else ctx.shape[1])
    snap = (None if true_len is None else
            torch.as_tensor(true_len, device=prompts.device).int())
    out = lm.forward(params, prompts, cfg, states=states, write_kv=True,
                     snap_at=snap, ctx=ctx)
    toks, gaps = [], []
    last = (torch.full((b,), p - 1, device=prompts.device) if snap is None
            else snap.long() - 1)
    logits = out["logits"][torch.arange(b, device=prompts.device),
                           last].float()
    del out["logits"]
    for step in range(n):
        top = torch.topk(logits, 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).cpu())
        tok = torch.argmax(logits, -1)
        toks.append(tok.cpu())
        if step == n - 1:
            break
        out = lm.forward(params, tok[:, None], cfg, states=out["states"],
                         write_kv=True, attend_cache_on_write=True)
        logits = out["logits"][:, -1].float()
    return torch.stack(toks, 1).numpy(), torch.stack(gaps, 1).numpy()


def agreement(name, toks, ref_toks, gaps):
    """Rows must match the reference; a first divergence passes only on a
    near tie (reference top-2 gap < NEAR_TIE), and is reported."""
    ties = []
    for r in range(toks.shape[0]):
        diff = np.nonzero(toks[r] != ref_toks[r])[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        gap = float(gaps[r, j])
        rec = {"row": r, "pos": j, "ref_top2_gap": gap}
        ties.append(rec)
        if gap >= NEAR_TIE:
            fail(f"{name}: row {r} diverges at {j} with top-2 gap {gap}")
    return ties


def register_oracle(seq):
    """Register the draft strategy ``"oracle"`` and return its class.

    It runs the real D^2SD draft (both drafters, reading their feature
    caches, and with ``spec.third_level`` the third level), then puts the
    greedy reference ``seq`` [B, L] (prompt then greedy tokens, indexed by
    position) into the tree, spoiled from a depth that varies by row and
    cycle: on the trunk past ``cut_t < gamma/2``, on the second-level
    branches past ``cut_b > cut_t``, and on the third-level branches past
    ``cut_3 > cut_b`` (with the third level, ``cut_b <= gamma-2``).
    Whenever a fork lies at or below ``cut_t`` the
    accepted path runs along the trunk and on into that branch, and on
    into its third-level branch when that one forks at or below
    ``cut_b``, so a cycle commits up to gamma tokens through tree rows
    other than the root. Its counters, kept on ``seq``'s device so that a
    draft makes no host sync and a CUDA graph can capture it: what the
    active rows must commit and the active row-cycles, so that
    ``committed / row_cycles`` is the alpha ``generate`` must report, and
    the active row-cycles whose accepted path must end in a branch
    (``branch_paths``) and in a third-level branch (``third_paths``)
    (``Oracle.read()``, zeroed by ``Oracle.reset()``). Greedy only: the
    drafts replace sampled tokens without their distributions."""
    from repro_torch.core import strategies as st
    from repro_torch.core import tree as tree_lib
    seq = seq.long()
    keys = ("committed", "row_cycles", "branch_paths", "third_paths")

    @st.register_strategy("oracle")
    class Oracle(st.D2SDStrategy):
        counts = torch.zeros((len(keys),), dtype=torch.long,
                             device=seq.device)

        @classmethod
        def reset(cls):
            cls.counts.zero_()

        @classmethod
        def read(cls):
            return dict(zip(keys, cls.counts.tolist()))

        def draft(self, bundle, state, gen):
            res = super().draft(bundle, state, gen)
            tree = res.tree
            spec = bundle.spec
            if spec.temperature > 0:
                fail("the oracle's drafts are greedy only")
            g, vocab = spec.gamma, bundle.target_cfg.vocab_size
            n2 = g + spec.top_k_branches * (g - 1)      # first third-level
            length = state.length.long()
            rows = torch.arange(tree.b, device=length.device)
            pos = (length[:, None] + tree.depth).clamp(max=seq.shape[1] - 1)
            true = torch.gather(seq, 1, pos)
            cut_t = (7 * length + 3 * rows) % (g // 2)
            span = g - 1 - cut_t - int(spec.third_level)
            cut_b = cut_t + 1 + (5 * length + rows) % span
            cut_3 = cut_b + 1 + (3 * length + 2 * rows) % (g - 1 - cut_b
                                                           ).clamp(min=1)
            node = torch.arange(tree.n, device=length.device)[None]
            cut = torch.where(node < g, cut_t[:, None], torch.where(
                node < n2, cut_b[:, None], cut_3[:, None]))
            good = tree.depth <= cut
            tokens = torch.where(good, true, (true + 1) % vocab)
            tokens = torch.where(tree.valid, tokens, tree.tokens)
            tokens[:, 0] = tree.tokens[:, 0]
            acc = tree_lib.propagate_acceptance(tree, good & tree.valid)
            best, n_acc, _ = tree_lib.best_path(tree, acc)
            Oracle.counts += torch.stack([
                ((n_acc + 1) * state.active).sum(), state.active.sum(),
                ((best >= g) & state.active).sum(),
                ((best >= n2) & state.active).sum()])
            return dataclasses.replace(res, tree=dataclasses.replace(
                tree, tokens=tokens))

    return Oracle


def _kv_views(cache):
    """(k, v) logical views [L, B, S, Hkv, D] of a stacked drafter feature
    cache, or [B, S, Hkv, D] of a target layer's cache; dense or paged."""
    from repro_torch.models import kvcache as kvc
    if kvc.is_paged(cache):
        return (kvc.pool_view(cache["k"], cache["pt"]),
                kvc.pool_view(cache["v"], cache["pt"]))
    return cache["k"], cache["v"]


def committed_cache_error(bundle, prompts, seq, cache_impl,
                          max_new=MAX_NEW, page_size=64, ondevice=False):
    """Run decode cycles of ``bundle`` (a row is active until it has
    ``max_new`` tokens: the loop of ``generate``, or with ``ondevice`` the
    ``OnDeviceLoop`` of ``generate_ondevice``, a CUDA graph on a card) on
    ``prompts`` [B, P], then hold what the cycles committed to what a
    plain prefill of the same tokens ``seq`` writes: the target's K/V in
    every global layer, every recurrent state leaf (the prefill snaps each
    row at its committed length) and both drafters' feature caches, each
    row up to its committed length. Returns the largest difference
    relative to the largest value of the prefill's tensor."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.state import engine_init, prefill
    b, p = prompts.shape
    dev = prompts.device
    state = prefill(bundle, engine_init(
        bundle, b, p + max_new + 2 * bundle.spec.gamma + 8,
        cache_impl=cache_impl, page_size=page_size, device=dev), prompts)
    gen = torch.Generator(device=dev)
    if ondevice:
        state = pl.OnDeviceLoop(bundle, state, max_new, gen).run().state
    else:
        while True:
            active = state.length < p + max_new - 1
            if not bool(active.any()):
                break
            state, _ = pl.decode_cycle(bundle, state.replace(active=active),
                                       gen)
    lens = state.length.tolist()
    for feat in (state.d1_feat, state.d2_feat):
        if feat["length"].tolist() != lens:
            fail(f"feature cache length {feat['length'].tolist()} is not "
                 f"the target's {lens}")
    n = max(lens)
    plain = pl.with_attn_impl(bundle, "gather")
    ref = prefill(plain, engine_init(plain, b, n, device=dev), seq[:, :n],
                  true_len=torch.tensor(lens, device=dev))
    kinds = bundle.target_cfg.pattern_for_depth()
    pairs = [(_kv_views(a), _kv_views(r)) for kind, a, r in zip(
        kinds, state.target["layers"], ref.target["layers"])
        if kind == "global"]
    worst = 0.0
    for kind, a, r in zip(kinds, state.target["layers"], ref.target["layers"]):
        if kind in ("recurrent", "rwkv"):
            for name, w in r.items():
                err = (a[name].float() - w.float()).abs().max()
                worst = max(worst, (err / w.float().abs().max().clamp_min(
                    1e-30)).item())
    pairs += [(_kv_views(state.d1_feat), _kv_views(ref.d1_feat)),
              (_kv_views(state.d2_feat), _kv_views(ref.d2_feat))]
    for got2, want2 in pairs:
        for got, want in zip(got2, want2):
            got = got if got.ndim == 5 else got[None]
            want = want if want.ndim == 5 else want[None]
            for row, n_r in enumerate(lens):
                w = want[:, row, :n_r].float()
                err = (got[:, row, :n_r].float() - w).abs().max()
                worst = max(worst, (err / w.abs().max()).item())
    return worst


def build_bundle(dtype):
    from repro_torch.config.base import SpecConfig
    from repro_torch.configs import paper_target
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import DrafterConfig, drafter_init
    from repro_torch.models import lm
    tcfg = dataclasses.replace(paper_target.full(), dtype=dtype)
    # two drafters at the target's own widths (4096, 32/8 heads, ff 12288)
    dcfg = DrafterConfig(d_model=tcfg.d_model, num_layers=2,
                         num_heads=tcfg.num_heads,
                         num_kv_heads=tcfg.num_kv_heads, d_ff=tcfg.d_ff,
                         vocab_size=tcfg.vocab_size,
                         target_feature_dim=lm.feature_dim(tcfg),
                         gamma=GAMMA, dtype=dtype)
    spec = SpecConfig(gamma=GAMMA, top_k_branches=K_BRANCHES, mode="d2sd")
    return pl.SpecBundle(tcfg, dcfg, dcfg, spec,
                         lm.lm_init(tcfg, seed=0, device=DEVICE),
                         drafter_init(dcfg, seed=1, device=DEVICE),
                         drafter_init(dcfg, seed=2, device=DEVICE))


def run_generate(bundle, prompts, impl, cache_impl, ondevice=False,
                 max_new=MAX_NEW, seed=0, true_len=None, ctx=None):
    """One ``generate`` call (the host loop) or, with ``ondevice``, one
    ``generate_ondevice`` call (the CUDA graph loop): its tokens and a
    record of its times. ``true_len``: ragged prompts, padded. ``ctx``:
    a cross-attention target's context (the host loop only, as JAX)."""
    from repro_torch.core import pipeline as pl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn = pl.generate_ondevice if ondevice else pl.generate
    kw = {} if ctx is None else {"ctx": ctx}
    res = fn(pl.with_attn_impl(bundle, impl), prompts, max_new, seed=seed,
             cache_impl=cache_impl, page_size=64, device=DEVICE,
             true_len=true_len, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = res["tokens"]
    vocab = bundle.target_cfg.vocab_size
    if toks.shape != (prompts.shape[0], max_new) or toks.min() < 0 \
            or toks.max() >= vocab:
        fail(f"{impl}/{cache_impl}: bad tokens {toks.shape}")
    n_tok = toks.size
    info = {"impl": impl, "cache": cache_impl, "mode": bundle.spec.mode,
            "third_level": bundle.spec.third_level,
            "temperature": bundle.spec.temperature,
            "loop": "graph" if ondevice else "host",
            "cycles": res["n_cycles"], "alpha": res["alpha"],
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "ms_per_cycle": 1e3 * res["decode_s"] / res["n_cycles"],
            "tokens_per_s": n_tok / wall,
            "decode_tokens_per_s": (n_tok - toks.shape[0]) / res["decode_s"],
            "wall_s": wall}
    if ondevice:
        info["capture_s"] = res["capture_s"]
        info["graph_pool_bytes"] = res["graph_pool_bytes"]
    return toks, info


def _launches():
    """Cascade launches by kernel: each wrapper counts its tensor-core
    (bf16) launches apart from the rest (fp32)."""
    from repro_torch.kernels import cascade_attention as casc
    out = {}
    for name in ("cascade_phase1", "cascade_phase1_paged"):
        fn = getattr(casc, name)
        out[f"{name}_sm90"] = fn.sm90_launches
        out[name] = fn.launches - fn.sm90_launches
    return out


def _zero_launches():
    from repro_torch.kernels import cascade_attention as casc
    for fn in (casc.cascade_phase1, casc.cascade_phase1_paged):
        fn.launches = fn.sm90_launches = 0


def _check_fp32_launches(launches, where):
    """The fp32 runs go through the fp32 kernels of cascade_phase1.cu alone
    (3xTF32 on the tensor cores), none through the bf16 ones of
    cascade_phase1_sm90.cu."""
    if min(launches["cascade_phase1"], launches["cascade_phase1_paged"]) \
            <= 0 or launches["cascade_phase1_sm90"] \
            or launches["cascade_phase1_paged_sm90"]:
        fail(f"{where}: fp32 cascade launches {launches}: expected both "
             "fp32 kernels (cascade_phase1.cu) and no bf16 one "
             "(cascade_phase1_sm90.cu)")


def _check_runs(toks, ref_toks, gaps):
    """Each run held to plain greedy, each kernel run to its gather run;
    returns the near ties that passed."""
    ties = {}
    for (impl, cache), t in toks.items():
        ties[f"{impl}/{cache} vs greedy"] = agreement(impl, t, ref_toks, gaps)
        if impl == "kernel":
            ties[f"kernel/{cache} vs gather"] = agreement(
                impl, t, toks[("gather", cache)], gaps)
    return {k: v for k, v in ties.items() if v}


def main_path():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = build_bundle("float32")
    prompts = np.random.default_rng(0).integers(
        0, bundle.target_cfg.vocab_size, size=(4, 512))
    prompts_t = torch.as_tensor(prompts, device=DEVICE)

    # the main path: counts zeroed just before, read just after
    _zero_launches()
    runs, toks = [], {}
    for cache in ("paged", "dense"):
        toks[("kernel", cache)], info = run_generate(bundle, prompts,
                                                     "kernel", cache)
        runs.append(info)
    launches = _launches()
    _check_fp32_launches(launches, "main")

    for cache in ("paged", "dense"):
        toks[("gather", cache)], info = run_generate(bundle, prompts,
                                                     "gather", cache)
        runs.append(info)
    # GAMMA more reference tokens than generated: the oracle's drafts
    # reach that far past the last committed position
    ref_toks, gaps = greedy_reference(bundle.target_params,
                                      bundle.target_cfg, prompts_t,
                                      MAX_NEW + GAMMA)
    ties = _check_runs(toks, ref_toks[:, :MAX_NEW], gaps)
    per_cycle = {"cascade_phase1": launches["cascade_phase1"]
                 / runs[1]["cycles"],
                 "cascade_phase1_paged": launches["cascade_phase1_paged"]
                 / runs[0]["cycles"]}
    emit({"phase": "main", "ok": True, "dtype": "float32",
          "layers": bundle.target_cfg.num_layers, "batch": 4, "prompt": 512,
          "max_new": MAX_NEW, "runs": runs, "launches": launches,
          "launches_per_cycle": per_cycle, "near_ties": ties,
          "min_ref_top2_gap": float(gaps[:, :MAX_NEW].min())})
    oracle_path(bundle, prompts, ref_toks, gaps)
    eager = {cache: (toks[("kernel", cache)], info["cycles"])
             for cache, info in zip(("paged", "dense"), runs)}
    return bundle, prompts, launches, (eager, ref_toks, gaps)


def graph_fp32(bundle, prompts, eager, ref_toks, gaps):
    """The main and oracle phases' fp32 kernel runs again through
    ``generate_ondevice`` (one CUDA graph replay a cycle): tokens held to
    the eager kernel run and to plain greedy, the cycle count to the eager
    run's; with the oracle's drafts, alpha held to the oracle's count and
    the caches the graph loop commits to a plain prefill. The launch
    counts, zeroed before the two runs and read after, count the eager
    first cycles and the captures (a replay runs no Python)."""
    from repro_torch.core import pipeline as pl
    runs, ties = [], {}
    _zero_launches()
    for cache in ("paged", "dense"):
        gt, info = run_generate(bundle, prompts, "kernel", cache,
                                ondevice=True)
        runs.append(info)
        ties[f"graph/{cache} vs greedy"] = agreement(
            "graph", gt, ref_toks[:, :MAX_NEW], gaps)
        ties[f"graph/{cache} vs eager"] = agreement(
            "graph", gt, eager[cache][0], gaps)
        if not ties[f"graph/{cache} vs eager"] and \
                info["cycles"] != eager[cache][1]:
            fail(f"graph {cache}: {info['cycles']} cycles, the eager loop "
                 f"{eager[cache][1]}")
    launches = _launches()
    _check_fp32_launches(launches, "graph")
    seq = torch.as_tensor(np.concatenate([prompts, ref_toks], 1),
                          device=DEVICE)
    oracle = register_oracle(seq)
    ob = dataclasses.replace(
        bundle, spec=dataclasses.replace(bundle.spec, mode="oracle"))
    exact = gaps.min() >= NEAR_TIE      # no near tie: the oracle's count holds
    for cache in ("paged", "dense"):
        oracle.reset()
        ot, info = run_generate(ob, prompts, "kernel", cache, ondevice=True)
        count = oracle.read()
        info["oracle_alpha"] = count["committed"] / count["row_cycles"]
        info["branch_paths"] = count["branch_paths"]
        runs.append(info)
        ties[f"graph oracle/{cache} vs greedy"] = agreement(
            "graph oracle", ot, ref_toks[:, :MAX_NEW], gaps)
        if exact and info["alpha"] != info["oracle_alpha"]:
            fail(f"graph oracle {cache}: alpha {info['alpha']} but the "
                 f"drafts must give {info['oracle_alpha']}")
        if info["oracle_alpha"] < 2 or count["branch_paths"] == 0:
            fail(f"graph oracle {cache}: drafts too weak: {info}")
        info["cache_rel_err"] = committed_cache_error(
            pl.with_attn_impl(ob, "kernel"),
            torch.as_tensor(prompts, device=DEVICE), seq, cache,
            ondevice=True)
        if info["cache_rel_err"] > TOL_CACHE:
            fail(f"graph oracle {cache}: committed caches differ from a "
                 f"prefill of the same tokens: {info}")
    emit({"phase": "graph_fp32", "ok": True, "dtype": "float32",
          "alpha_checked": bool(exact), "tol_cache": TOL_CACHE,
          "runs": runs, "launches": launches,
          "near_ties": {k: v for k, v in ties.items() if v}})


# the draft modes beside d2sd: name -> (mode, third_level), wired as the
# paper's tables run them (``mode_bundle``)
MODES = {"naive_k": ("naive_k", False), "eagle": ("eagle", False),
         "dflash_second": ("dflash_second", False),
         "third_level": ("d2sd", True)}
MODE_NEW = 32           # tokens a row in the modes and sampled phases
MODE_LAYERS = 18        # paper-target cut in depth for them (time limit)
SAMPLE_T, SAMPLE_SEED = 1.0, 5


def mode_bundle(bundle, name, temperature=0.0):
    """``bundle`` in a mode of ``MODES`` (or a registered mode's name):
    eagle drafts with drafter 1 made causal, dflash_second reuses drafter
    1's weights as drafter 2."""
    mode, third = MODES.get(name, (name, False))
    out = dataclasses.replace(bundle, spec=dataclasses.replace(
        bundle.spec, mode=mode, third_level=third, temperature=temperature))
    if mode == "eagle":
        out = dataclasses.replace(out, d1_cfg=dataclasses.replace(
            out.d1_cfg, causal=True))
    if mode == "dflash_second":
        out = dataclasses.replace(out, d2_params=out.d1_params)
    return out


def _mode_run(bundle, prompts, cache, sm90=False, **kw):
    """One graph-loop run of ``bundle`` (kernel path) with the cascade
    counts zeroed just before and read just after: the eager first cycle
    and the capture each run a cycle's wrappers once, so each wrapper of
    the cache must have counted twice ``replay_launches`` and the others
    nothing (``sm90``: the bf16 kernels' counts)."""
    from repro_torch.core import pipeline as pl
    bundle = pl.with_attn_impl(bundle, "kernel")
    entry = ("cascade_phase1_paged" if cache == "paged"
             else "cascade_phase1") + ("_sm90" if sm90 else "")
    want = replay_launches(bundle, cache)
    _zero_launches()
    toks, info = run_generate(bundle, prompts, "kernel", cache,
                              ondevice=True, max_new=MODE_NEW, **kw)
    counts = _launches()
    info["launches"] = counts
    info["replay_launches"] = want
    if counts[entry] != 2 * want or sum(counts.values()) != counts[entry]:
        fail(f"{bundle.spec.mode} {cache}: cascade launches {counts} in "
             f"the eager cycle and the capture, expected {2 * want} through "
             f"{entry} alone")
    return toks, info


def modes_path(bundle, prompts):
    """fp32 greedy, full width, through ``generate_ondevice`` (kernel
    path): each mode of ``MODES`` on the paged and dense caches, tokens
    held to plain greedy of ``bundle``'s target (near ties excepted), the
    cascade launches of a cycle held to ``replay_launches`` (at 18
    layers: 18 dense; paged 20 naive_k, 22 dflash_second, 24
    third_level, 48 eagle), the third level's host loop (``generate``)
    held to its graph run; then each mode's paged loop profiled
    (``profile_loop``: wall and device ms a replay, the phase-1 kernel's
    launches by name)."""
    from repro_torch.core import pipeline as pl
    ref_toks, gaps = greedy_reference(
        bundle.target_params, bundle.target_cfg,
        torch.as_tensor(prompts, device=DEVICE), MODE_NEW)
    runs, ties, profiles = [], {}, {}
    for name in MODES:
        mb = pl.with_attn_impl(mode_bundle(bundle, name), "kernel")
        for cache in ("paged", "dense"):
            toks, info = _mode_run(mb, prompts, cache)
            info["name"] = name
            runs.append(info)
            ties[f"{name}/{cache} vs greedy"] = agreement(
                name, toks, ref_toks[:, :MODE_NEW], gaps)
            if name == "third_level" and cache == "paged":
                ht, hinfo = run_generate(mb, prompts, "kernel", cache,
                                         max_new=MODE_NEW)
                hinfo["name"] = name
                runs.append(hinfo)
                if not np.array_equal(ht, toks) or \
                        hinfo["cycles"] != info["cycles"]:
                    fail(f"third_level: the host loop ({hinfo['cycles']} "
                         f"cycles) and the graph loop ({info['cycles']}) "
                         "commit other tokens")
        profiles[name] = profile_loop(mb, prompts, "paged",
                                      replay_launches(mb, "paged"))
    emit({"phase": "modes", "ok": True, "dtype": "float32",
          "layers": bundle.target_cfg.num_layers, "max_new": MODE_NEW,
          "runs": runs, "min_ref_top2_gap": float(gaps.min()),
          "near_ties": {k: v for k, v in ties.items() if v},
          "profile_paged": profiles})
    return profiles


class DrawLog:
    """Records the acceptance uniforms of every sampling verify into a
    device buffer (``index_copy_`` at a device counter, which a CUDA
    graph captures), so that the graph loop's draws can be held to the
    host loop's and to each other."""

    def __init__(self, cap, shape):
        from repro_torch.core import verify as verify_lib
        self.lib, self.real = verify_lib, verify_lib.sampling_draws
        self.buf = torch.zeros((cap, *shape), device=DEVICE)
        self.n = torch.zeros((1,), dtype=torch.long, device=DEVICE)
        verify_lib.sampling_draws = self._draws

    def _draws(self, gen, tree, vocab, max_children):
        u, noise = self.real(gen, tree, vocab, max_children)
        self.buf.index_copy_(0, self.n.clamp(max=self.buf.shape[0] - 1),
                             u[None])
        self.n += 1
        return u, noise

    def read(self):
        return self.buf[:int(self.n)].clone()

    def close(self):
        self.lib.sampling_draws = self.real


def sampled_path(bundle, prompts):
    """fp32 at temperature SAMPLE_T, d2sd, paged, kernel path, one seed:
    the graph loop token-identical to the host loop, both drawing the
    same acceptance uniforms every cycle and no two cycles the same ones;
    the gather path's agreement for the same seed reported; the graph
    loop profiled (``profile_loop``); then the
    lossless check at tiny size through the kernels (``first_token_tv``
    for every mode)."""
    from repro_torch.core import pipeline as pl
    sb = pl.with_attn_impl(mode_bundle(bundle, "d2sd",
                                       temperature=SAMPLE_T), "kernel")
    b, g, k = prompts.shape[0], sb.spec.gamma, sb.spec.top_k_branches
    log = DrawLog(MODE_NEW + 16, ((g - 1) * (k + 1), b))
    res = {}
    try:
        for loop in ("host", "graph"):
            log.n.zero_()
            if loop == "graph":
                toks, info = _mode_run(sb, prompts, "paged",
                                       seed=SAMPLE_SEED)
            else:
                toks, info = run_generate(sb, prompts, "kernel", "paged",
                                          max_new=MODE_NEW,
                                          seed=SAMPLE_SEED)
            res[loop] = (toks, info, log.read())
    finally:
        log.close()
    (ht, hinfo, hu), (gt, ginfo, gu) = res["host"], res["graph"]
    flat = gu.reshape(gu.shape[0], -1)
    same = (flat[:, None] == flat[None]).all(-1)
    repeats = int(same.sum()) - flat.shape[0]
    if not np.array_equal(ht, gt) or hinfo["cycles"] != ginfo["cycles"]:
        fail(f"sampled: the graph loop ({ginfo['cycles']} cycles) and the "
             f"host loop ({hinfo['cycles']}) commit other tokens")
    if gu.shape[0] != ginfo["cycles"] or not torch.equal(gu, hu) or repeats:
        fail(f"sampled: graph draws {tuple(gu.shape)} against the host "
             f"loop's {tuple(hu.shape)} over {ginfo['cycles']} cycles, "
             f"equal {torch.equal(gu, hu) if gu.shape == hu.shape else 0}, "
             f"{repeats} repeated")
    at, ainfo = run_generate(sb, prompts, "gather", "paged", ondevice=True,
                             max_new=MODE_NEW, seed=SAMPLE_SEED)
    prof = profile_loop(sb, prompts, "paged", replay_launches(sb, "paged"),
                        seed=SAMPLE_SEED)
    tvs = lossless_on_card()
    emit({"phase": "sampled", "ok": True, "dtype": "float32",
          "temperature": SAMPLE_T, "seed": SAMPLE_SEED, "max_new": MODE_NEW,
          "runs": [hinfo, ginfo, ainfo], "draw_cycles": gu.shape[0],
          "draws_equal_host": True, "repeated_draws": repeats,
          "agree_with_gather": float((at == gt).mean()),
          "profile_paged": prof, "lossless": tvs})


# test_lossless.py's tiny model: vocabulary, rows of the one-cycle check
LOSSLESS_V, LOSSLESS_ROWS = 13, 2000
LOSSLESS_MODES = [("d2sd", False, 1.0), ("d2sd", True, 1.0),
                  ("naive_k", False, 1.0), ("naive_k", False, 0.5),
                  ("eagle", False, 1.0), ("dflash", False, 1.0)]


def lossless_bundle(mode, third=False, temperature=1.0, impl="gather",
                    device=None, d_model=32, d_drafter=16):
    """``tests/test_lossless.py``'s sampling model (V 13, a 2-layer target,
    1-layer drafters, gamma 4, K 2) with random seeded weights on
    ``device`` (default DEVICE), two heads of ``d_model`` / ``d_drafter``
    width; eagle's drafter causal."""
    from repro_torch.config.base import ModelConfig, SpecConfig
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import DrafterConfig, drafter_init
    from repro_torch.models import lm
    device = device or DEVICE
    tcfg = ModelConfig(num_layers=2, d_model=d_model, num_heads=2,
                       num_kv_heads=2, d_ff=2 * d_model,
                       vocab_size=LOSSLESS_V, max_seq_len=64, remat=False,
                       dtype="float32", attn_impl=impl)
    dcfg = DrafterConfig(d_model=d_drafter, num_layers=1, num_heads=2,
                         num_kv_heads=2, d_ff=2 * d_drafter,
                         vocab_size=LOSSLESS_V,
                         target_feature_dim=lm.feature_dim(tcfg), gamma=4,
                         dtype="float32", causal=mode == "eagle",
                         attn_impl=impl)
    spec = SpecConfig(gamma=4, top_k_branches=2, mode=mode,
                      third_level=third, temperature=temperature)
    return pl.SpecBundle(tcfg, dcfg, dcfg, spec,
                         lm.lm_init(tcfg, seed=0, device=device),
                         drafter_init(dcfg, seed=1, device=device),
                         drafter_init(dcfg, seed=2, device=device))


def first_token_tv(bundle, n_rows=LOSSLESS_ROWS, device=None, seed=11,
                   cache_impl="dense"):
    """One decode cycle over ``n_rows`` copies of one prompt (a greedy
    prefill, so every row shares the anchor; each row its own draws):
    (TV of the first committed token against the target's softmax at the
    anchor and temperature, the bound max(0.06, 2.5 sqrt(V/4n)) of
    ``tests/test_lossless.py``)."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.state import engine_init, prefill
    from repro_torch.models import lm
    dev = torch.device(device or DEVICE)
    prompt = torch.as_tensor([[3, 1, 4, 1, 5, 9]], device=dev)
    v = bundle.target_cfg.vocab_size
    state = prefill(bundle, engine_init(bundle, n_rows, 32,
                                        cache_impl=cache_impl, page_size=16,
                                        device=dev),
                    prompt.expand(n_rows, -1))
    full = torch.cat([prompt, state.anchor[:1, None]], 1)
    logits = lm.forward(bundle.target_params, full, bundle.target_cfg)[
        "logits"][0, -1].float()
    p_ref = torch.softmax(logits / bundle.spec.temperature, -1).cpu().numpy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    _, out = pl.decode_cycle(bundle, state, gen, collect_stats=False)
    first = out["tokens"][:, 0].cpu().numpy()
    tv = 0.5 * np.abs(np.bincount(first, minlength=v) / n_rows - p_ref).sum()
    return float(tv), max(0.06, 2.5 * float(np.sqrt(v / (4 * n_rows))))


def lossless_on_card():
    """``first_token_tv`` of every mode of LOSSLESS_MODES through the
    kernels on a paged cache (head_dim 64), each cycle's cascade
    launches counted."""
    out = []
    for mode, third, temp in LOSSLESS_MODES:
        _zero_launches()
        tv, bound = first_token_tv(lossless_bundle(
            mode, third, temp, impl="kernel", d_model=128, d_drafter=128),
            cache_impl="paged")
        launches = _launches()
        rec = {"mode": mode, "third_level": third, "temperature": temp,
               "tv": tv, "bound": bound, "launches": launches}
        out.append(rec)
        if tv >= bound or not launches["cascade_phase1_paged"]:
            fail(f"lossless on the card: {rec}")
    return out


def modes_bf16(bundle, prompts):
    """bf16, paged, kernel path, graph loop: each mode's ms a replay and
    decode tokens/s, its cascade launches (through the sm90 kernels) and
    its profile (``profile_loop``); then the same for d2sd sampled at
    SAMPLE_T."""
    from repro_torch.core import pipeline as pl
    runs, profiles = [], {}
    for name in MODES:
        mb = pl.with_attn_impl(mode_bundle(bundle, name), "kernel")
        _, info = _mode_run(mb, prompts, "paged", sm90=True)
        info["name"] = name
        runs.append(info)
        profiles[name] = profile_loop(mb, prompts, "paged",
                                      replay_launches(mb, "paged"))
    sb = pl.with_attn_impl(mode_bundle(bundle, "d2sd",
                                       temperature=SAMPLE_T), "kernel")
    _, info = _mode_run(sb, prompts, "paged", sm90=True,
                        seed=SAMPLE_SEED)
    info["name"] = "d2sd_sampled"
    runs.append(info)
    profiles["d2sd_sampled"] = profile_loop(sb, prompts, "paged",
                                            replay_launches(sb, "paged"),
                                            seed=SAMPLE_SEED)
    emit({"phase": "modes_bf16", "ok": True, "dtype": "bfloat16",
          "layers": bundle.target_cfg.num_layers, "max_new": MODE_NEW,
          "runs": runs, "profile_paged": profiles})


def oracle_path(bundle, prompts, ref_toks, gaps):
    """The fp32 runs again with the oracle's drafts, which accept several
    tokens a cycle through trunk and branch rows of the tree, and then
    with the third level too, whose drafts accept paths that end in a
    third-level branch; after each run the caches those cycles commit,
    held to a plain prefill."""
    from repro_torch.core import pipeline as pl
    seq = torch.as_tensor(np.concatenate([prompts, ref_toks], 1),
                          device=DEVICE)
    oracle = register_oracle(seq)
    prompts_t = torch.as_tensor(prompts, device=DEVICE)
    exact = gaps.min() >= NEAR_TIE      # no near tie: the oracle's count holds
    runs, toks, launches, ties = [], {}, {}, {}
    for third in (False, True):
        ob = dataclasses.replace(bundle, spec=dataclasses.replace(
            bundle.spec, mode="oracle", third_level=third))
        level = "third" if third else "second"
        _zero_launches()
        for impl in ("kernel", "gather"):
            for cache in ("paged", "dense"):
                oracle.reset()
                toks[(impl, cache)], info = run_generate(ob, prompts, impl,
                                                         cache)
                count = oracle.read()
                info["oracle_alpha"] = count["committed"] / count[
                    "row_cycles"]
                info["branch_paths"] = count["branch_paths"]
                info["third_paths"] = count["third_paths"]
                runs.append(info)
                if exact and info["alpha"] != info["oracle_alpha"]:
                    fail(f"oracle {level} {impl}/{cache}: alpha "
                         f"{info['alpha']} but the drafts must give "
                         f"{info['oracle_alpha']}")
                if info["oracle_alpha"] < 2 or count["branch_paths"] == 0 \
                        or (count["third_paths"] > 0) != third:
                    fail(f"oracle {level} {impl}/{cache}: drafts too weak: "
                         f"{info}")
                info["cache_rel_err"] = committed_cache_error(
                    pl.with_attn_impl(ob, impl), prompts_t, seq, cache)
                if info["cache_rel_err"] > TOL_CACHE:
                    fail(f"oracle {level} {impl}/{cache}: committed caches "
                         f"differ from a prefill of the same tokens: {info}")
            if impl == "kernel":
                launches[level] = _launches()
                _check_fp32_launches(launches[level], f"oracle {level}")
        ties.update({f"{level} {k}": v for k, v in _check_runs(
            toks, ref_toks[:, :MAX_NEW], gaps).items()})
    emit({"phase": "oracle", "ok": True, "dtype": "float32",
          "alpha_checked": bool(exact), "tol_cache": TOL_CACHE,
          "runs": runs, "launches": launches, "near_ties": ties})


def to_bf16(bundle):
    """``bundle`` in bfloat16: each weight is replaced by its bf16 copy
    inside the param dicts, so the fp32 copy is freed as it goes."""
    def cast_(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in list(items):
            if isinstance(v, (dict, list)):
                cast_(v)
            else:
                tree[k] = v.to(torch.bfloat16)

    for params in (bundle.target_params, bundle.d1_params, bundle.d2_params):
        cast_(params)
    torch.cuda.empty_cache()
    return dataclasses.replace(
        bundle, target_cfg=dataclasses.replace(bundle.target_cfg,
                                               dtype="bfloat16"),
        d1_cfg=dataclasses.replace(bundle.d1_cfg, dtype="bfloat16"),
        d2_cfg=dataclasses.replace(bundle.d2_cfg, dtype="bfloat16"))


def bf16_path(bundle, prompts):
    """The same run in bfloat16 (:func:`to_bf16`)."""
    b16 = to_bf16(bundle)
    runs, agree, first, launches, per_cycle, eager = [], {}, {}, {}, {}, {}
    n_target = b16.target_cfg.num_layers
    n_drafter = b16.d1_cfg.num_layers + b16.d2_cfg.num_layers
    # each cache's kernel run: the counts zeroed just before, read just
    # after; the paged run reads the drafters' feature caches too
    for cache, entry, want in (
            ("paged", "cascade_phase1_paged", n_target + n_drafter),
            ("dense", "cascade_phase1", n_target)):
        _zero_launches()
        kt, kinfo = run_generate(b16, prompts, "kernel", cache)
        counts = _launches()
        gt, ginfo = run_generate(b16, prompts, "gather", cache)
        runs += [kinfo, ginfo]
        n = counts[f"{entry}_sm90"]
        per_cycle[f"{entry}_sm90"] = n / kinfo["cycles"]
        if n < want * kinfo["cycles"] or counts["cascade_phase1"] \
                or counts["cascade_phase1_paged"]:
            fail(f"bf16 {cache}: cascade launches {counts} over "
                 f"{kinfo['cycles']} cycles: expected >= {want} a cycle "
                 f"through {entry}_sm90 and none through cascade_phase1.cu")
        launches[f"{entry}_sm90"] = n
        same = kt == gt
        agree[cache] = float(same.mean())
        first[cache] = bf16_divergences(b16, prompts, kt, gt, cache)
        eager[cache] = (kt, kinfo)
    kinfo = runs[0]
    emit({"phase": "bf16", "ok": True, "runs": runs,
          "tokens_per_s": kinfo["tokens_per_s"],
          "decode_tokens_per_s": kinfo["decode_tokens_per_s"],
          "ms_per_cycle": kinfo["ms_per_cycle"],
          "agree_with_gather": agree, "first_divergence_per_row": first,
          "near_tie_ulps": NEAR_TIE_BF16_ULPS,
          "launches": launches, "launches_per_cycle": per_cycle})
    return b16, kinfo["ms_per_cycle"], launches, per_cycle, eager


def bf16_divergences(bundle, prompts, kt, gt, cache):
    """Where each row of the bf16 kernel run first leaves the gather run,
    the top-2 gap of a plain bf16 forward over the context the two runs
    share (the prompt and the tokens before it), in bf16 ulps of the top
    logit. A divergence passes only on a gap below NEAR_TIE_BF16_ULPS.
    Each record also says how far one verify step over that context moves
    the same gap when the read path changes (``step_shift_ulps``)."""
    from repro_torch.models import lm
    out = []
    for r in range(kt.shape[0]):
        diff = np.nonzero(kt[r] != gt[r])[0]
        if diff.size == 0:
            out.append(None)
            continue
        j = int(diff[0])
        ctx = torch.as_tensor(np.concatenate([prompts[r], kt[r, :j]]),
                              device=DEVICE)[None]
        with torch.no_grad():
            logits = lm.forward(bundle.target_params, ctx,
                                bundle.target_cfg)["logits"][0, -1]
        top, ids = torch.topk(logits.float(), 2)
        top = top.tolist()
        ulp = float(2.0 ** (np.floor(np.log2(abs(top[0]))) - 7))
        rec = {"pos": j, "ref_top2_gap": top[0] - top[1],
               "ref_top_logit": top[0], "ulps": (top[0] - top[1]) / ulp,
               "step_shift_ulps": _step_gap_shift(bundle, ctx, cache,
                                                  ids) / ulp}
        out.append(rec)
        if rec["ulps"] >= NEAR_TIE_BF16_ULPS:
            fail(f"bf16 {cache}: row {r}: the kernel run leaves the "
                 f"gather run on a wide gap: {rec}")
    return out


def _step_gap_shift(bundle, ctx, cache, ids):
    """|kernel - gather| of the gap between tokens ``ids`` [2] in the
    logits of one verify step: the last token of ``ctx`` [1, L] read over
    a cache that a plain prefill of the rest wrote, through each read
    path."""
    from repro_torch.core import pipeline as pl
    from repro_torch.models import lm
    n = ctx.shape[1]
    gaps = []
    for impl in ("kernel", "gather"):
        cfg = pl.with_attn_impl(bundle, impl).target_cfg
        states = lm.init_states(cfg, 1, n, cache_impl=cache, page_size=64,
                                device=DEVICE)
        with torch.no_grad():
            states = lm.forward(bundle.target_params, ctx[:, :-1], cfg,
                                states=states, write_kv=True)["states"]
            logits = lm.forward(
                bundle.target_params, ctx[:, -1:], cfg, states=states,
                extra_mask=torch.ones((1, 1), dtype=torch.bool,
                                      device=DEVICE),
                positions=torch.full((1, 1), n - 1, device=DEVICE))[
                    "logits"][0, -1].float()
        gaps.append((logits[ids[0]] - logits[ids[1]]).item())
    return abs(gaps[0] - gaps[1])


def graph_bf16(bundle, prompts, eager):
    """The bf16 kernel runs of both caches through ``generate_ondevice``,
    in this run beside the eager ones (``eager``: cache -> (tokens,
    record)): ms per cycle, decode tokens/s, the capture's time and its
    graph pool, and the share of tokens equal to the eager run's."""
    runs, agree = [], {}
    for cache, entry in (("paged", "cascade_phase1_paged"),
                         ("dense", "cascade_phase1")):
        _zero_launches()
        gt, info = run_generate(bundle, prompts, "kernel", cache,
                                ondevice=True)
        counts = _launches()
        if not counts[f"{entry}_sm90"] or counts["cascade_phase1"] \
                or counts["cascade_phase1_paged"]:
            fail(f"graph bf16 {cache}: cascade launches {counts}: expected "
                 f"{entry}_sm90 and none through cascade_phase1.cu")
        info["reserved_gb_after"] = torch.cuda.memory_reserved() / 1e9
        et, einfo = eager[cache]
        agree[cache] = float((gt == et).mean())
        runs.append({"cache": cache, "graph": info, "eager": {
            k: einfo[k] for k in ("cycles", "ms_per_cycle", "tokens_per_s",
                                  "decode_tokens_per_s", "decode_s")}})
    torch.cuda.empty_cache()
    emit({"phase": "graph_bf16", "ok": True, "dtype": "bfloat16",
          "runs": runs, "agree_with_eager": agree,
          "reserved_gb_after_empty_cache": torch.cuda.memory_reserved() / 1e9})


def _device_rows(prof):
    """(kernel name, device ms, calls) of a trace's device events, most
    time first: a CPU op (aten::mm) also reports the time of the kernels
    it launched, which would count them twice, and so does the device
    span of a profiler schedule's step (ProfilerStep*)."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


# the phase-1 cascade kernel of each dtype, by its name in a trace
PHASE1_KERNEL = {"float32": "phase1_tf32x3_kernel",
                 "bfloat16": "phase1_sm90_kernel"}


def profile_loop(bundle, prompts, cache, want, n_cycles=6, seed=0,
                 true_len=None):
    """``n_cycles`` replays of the graph loop of ``bundle`` (its read path)
    on ``cache``, each followed by the loop's condition read as
    ``generate_ondevice`` reads it: first unprofiled (host clock, the
    cycle's wall time), then under torch.profiler (device time, top
    kernels, and the phase-1 cascade kernel's launches and device time a
    cycle, counted by kernel name: a replay runs no wrapper). The
    profiler traces one more replay first and discards it (its warm-up
    step): the first traced replay of a graph can lose kernels from the
    trace (a bf16 paged trace once counted 236 of six replays' 240
    phase-1 launches). Fails if the trace holds more than ``want``
    phase-1 launches a replay; fewer is a trace that lost events, which
    the caller judges. ``true_len``: ragged prompts, padded in
    ``prompts``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import pipeline as pl
    from repro_torch.core.state import engine_init, prefill
    prompts_t = torch.as_tensor(prompts, device=DEVICE)
    b, p = prompts_t.shape
    dn = bundle.target_cfg.dtype
    kernel = PHASE1_KERNEL[dn]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    state = prefill(bundle, engine_init(
        bundle, b, p + MAX_NEW + 2 * bundle.spec.gamma + 8,
        cache_impl=cache, page_size=64, device=DEVICE), prompts_t, gen,
        temperature=bundle.spec.temperature,
        true_len=None if true_len is None else torch.as_tensor(
            true_len, device=DEVICE).int())
    loop = pl.OnDeviceLoop(bundle, state, MAX_NEW, gen)
    try:
        loop.start()
        first = {"first_cycle_s": loop.first_s, "capture_s": loop.capture_s,
                 "graph_pool_bytes": loop.graph_pool_bytes}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_cycles):
            loop.advance()
            loop.more()
        wall = 1e3 * (time.perf_counter() - t0) / n_cycles
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n_cycles,
                                       repeat=1)) as prof:
            for _ in range(1 + n_cycles):
                loop.advance()
                loop.more()
                torch.cuda.synchronize()
                prof.step()
    finally:
        loop.close()
    del loop, state
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows) / n_cycles or None
    phase1 = [(ms, c) for k, ms, c in rows if kernel in k]
    n = sum(c for _, c in phase1)
    out = {**first, "replays": n_cycles, "ms_per_cycle": wall,
           "device_ms_per_cycle": busy,
           "idle_share": busy and 1.0 - busy / wall,
           "kernels_per_cycle": sum(r[2] for r in rows) / n_cycles,
           "phase1_launches_per_cycle": n / n_cycles,
           "replay_launches": want,
           "phase1_ms_per_cycle": sum(ms for ms, _ in phase1) / n_cycles,
           "top": [{"name": k[:90], "ms_per_cycle": ms / n_cycles,
                    "calls_per_cycle": c / n_cycles}
                   for k, ms, c in rows[:16]]}
    if n > want * n_cycles:
        fail(f"graph profile {dn} {bundle.spec.mode} {cache}: {n} {kernel} "
             f"launches in {n_cycles} replays, expected {want} a replay")
    torch.cuda.empty_cache()
    return out


def profile_graph(bundle, prompts, n_cycles=6):
    """:func:`profile_loop` of the kernel path on both caches. The gate is
    the wrappers' exact counts of the loop's eager first cycle and its
    capture (40 a cycle paged: 36 target layers, 2 x 2 drafter layers;
    36 dense): a replay launches what the capture recorded. The trace's
    count by name is reported beside them, and may fall short (a trace
    can lose events: ROADMAP.md queue 3), never over."""
    from repro_torch.core import pipeline as pl
    bundle = pl.with_attn_impl(bundle, "kernel")
    dn = bundle.target_cfg.dtype
    out = {}
    for cache in ("paged", "dense"):
        _zero_launches()
        out[cache] = profile_loop(bundle, prompts, cache,
                                  replay_launches(bundle, cache), n_cycles)
        counts = _launches()
        _launch_check(f"graph profile {dn} {cache}", counts,
                      _want_launches(bundle, cache, dn == "bfloat16"), 2)
        out[cache]["replay_launches_per_cycle"] = {
            k: v / 2 for k, v in counts.items() if v}
    emit({"phase": "graph_profile" + ("_fp32" if dn == "float32" else ""),
          "ok": True, "dtype": dn, "impl": "kernel",
          "kernel": PHASE1_KERNEL[dn], **out})
    return out


def replay_launches(bundle, cache):
    """Phase-1 cascade launches a cycle: one a target attention layer
    (global or local), and on a paged cache one more a drafter layer and
    drafter pass (the draft strategy's ``n_draft_passes``; a dense
    feature cache gathers)."""
    from repro_torch.core import strategies as st
    n = sum(k in ("global", "local")
            for k in bundle.target_cfg.pattern_for_depth())
    if cache == "paged":
        n += bundle.d1_cfg.num_layers * st.get_strategy(
            bundle.spec.mode).n_draft_passes(bundle.spec)
    return n


def profile_cycles(bundle, prompts, ms_per_cycle, n_cycles=6):
    """Where a decode cycle's device time goes: ``n_cycles`` cycles of the
    kernel path on the paged cache under torch.profiler (prefill and one
    warm-up cycle outside it). The idle share is read against the cycle
    time of the unprofiled run (``ms_per_cycle``), since the profiler
    slows the host."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import pipeline as pl
    from repro_torch.core.state import engine_init, prefill
    bundle = pl.with_attn_impl(bundle, "kernel")
    prompts_t = torch.as_tensor(prompts, device=DEVICE)
    b, p = prompts_t.shape
    state = engine_init(bundle, b, p + 2 * n_cycles * bundle.spec.gamma,
                        cache_impl="paged", page_size=64, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    state, _ = pl.decode_cycle(bundle, prefill(bundle, state, prompts_t),
                               gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_cycles):
            state, out = pl.decode_cycle(bundle, state, gen)
            out["n_out"].cpu()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    # no device time recorded means the profiler could not trace the card
    busy = sum(r[1] for r in rows) / n_cycles or None
    emit({"phase": "profile", "ok": True, "dtype": "bfloat16",
          "cache": "paged", "impl": "kernel", "cycles": n_cycles,
          "device_ms_per_cycle": busy,
          "unprofiled_ms_per_cycle": ms_per_cycle,
          "idle_share": busy and 1.0 - busy / ms_per_cycle,
          "kernels_per_cycle": sum(r[2] for r in rows) / n_cycles,
          "top": [{"name": k[:90], "ms_per_cycle": ms / n_cycles,
                   "calls_per_cycle": c / n_cycles}
                  for k, ms, c in rows[:16]]})


# ------------------------------------------------------------- train path --
def _flash_launches():
    """Launches by C entry point: each flash wrapper counts its
    tensor-core (bf16) launches apart from the rest (fp32)."""
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for wrapper, entry in zip(FLASH, ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")):
        fn = getattr(fa, wrapper)
        out[f"{entry}_sm90"] = fn.sm90_launches
        out[entry] = fn.launches - fn.sm90_launches
    return out


def _zero_flash_launches():
    from repro_torch.kernels import flash_attention as fa
    for n in FLASH:
        getattr(fa, n).launches = 0
        getattr(fa, n).sm90_launches = 0


def _check_flash_launches(launches, n_steps, sm90):
    """16 forward (remat runs it twice), 8 dq and 8 dk/dv launches per
    step, each through the kernel of the step's dtype, and none through
    the other dtype's."""
    sfx = "_sm90" if sm90 else ""
    want = {f"flash_fwd{sfx}": 2 * TRAIN_LAYERS,
            f"flash_bwd_dq{sfx}": TRAIN_LAYERS,
            f"flash_bwd_dkv{sfx}": TRAIN_LAYERS}
    per_step = {k: v / n_steps for k, v in launches.items() if v}
    if per_step != want:
        fail(f"train: flash launches per step {per_step}, expected {want}")
    return per_step


def train_cfg(dtype):
    """paper-target at full width, cut to TRAIN_LAYERS layers, remat on."""
    from repro_torch.configs import paper_target
    return dataclasses.replace(paper_target.full(), num_layers=TRAIN_LAYERS,
                               remat=True, dtype=dtype)


def _start_training(cfg, impl):
    """Seeded weights, the step ``optimizer_for`` gives, its state and the
    mixture data stream, all from seed 0."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.steps import make_train_step, optimizer_for
    from repro_torch.models import api
    if optimizer_for(cfg).name != "adamw":
        fail(f"optimizer_for picks {optimizer_for(cfg).name} at "
             f"{cfg.param_count():.3g} params, not adamw")
    params = api.init_model(cfg, seed=0, device=DEVICE)
    step, opt_init = make_train_step(cfg, attn_impl=impl, device=DEVICE)
    return (params, opt_init(params), step,
            SyntheticDataset("mixture", TRAIN_B, TRAIN_T, seed=0))


def _run_steps(params, state, step, ds, n):
    losses, gnorms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        params, state, m = step(params, state, ds.next_batch())
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    if not np.isfinite(losses + gnorms).all():
        fail(f"train: a loss or grad norm is not finite: {losses} {gnorms}")
    return params, state, losses, gnorms, time.perf_counter() - t0


def train_identity():
    """fp32: three steps through the flash kernels and three through the
    plain path (``attn_impl="auto"``: chunked attention), from the same
    seeded weights and batches; loss and grad norm per step and the
    params after step 3 held to each other."""
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import lr_schedule
    cfg = train_cfg("float32")
    runs, host = {}, {}
    for impl in ("kernel", "auto"):
        params, state, step, ds = _start_training(cfg, impl)
        if impl == "kernel":
            host["init"] = {k: v.to("cpu", copy=True)
                            for k, v in pm.flatten(params).items()}
            _zero_flash_launches()
        params, state, losses, gnorms, secs = _run_steps(params, state, step,
                                                         ds, 3)
        runs[impl] = {"losses": losses, "grad_norms": gnorms,
                      "s_per_step": secs / 3}
        if impl == "kernel":
            launches = _flash_launches()
            per_step = _check_flash_launches(launches, 3, sm90=False)
            host["kernel"] = {k: v.to("cpu", copy=True)
                              for k, v in pm.flatten(params).items()}
        else:
            diff_max = diff_sum = move_sum = 0.0
            n = 0
            for path, p in pm.flatten(params).items():
                d = (p - host["kernel"][path].to(DEVICE)).abs()
                mv = (p - host["init"][path].to(DEVICE)).abs()
                diff_max = max(diff_max, d.max().item())
                diff_sum += d.sum().item()
                move_sum += mv.sum().item()
                n += p.numel()
        del params, state, step
        torch.cuda.empty_cache()
    del host
    k, a = runs["kernel"], runs["auto"]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(k["losses"],
                                                      a["losses"]))
    gn_rel = max(abs(x - y) / abs(y) for x, y in zip(k["grad_norms"],
                                                    a["grad_norms"]))
    from repro_torch.launch.steps import optimizer_for
    hp = optimizer_for(cfg)
    sign_bound = 2 * sum(float(lr_schedule(hp, s)) for s in (1, 2, 3))
    param_rel = diff_sum / max(move_sum, 1e-30)
    out = {"phase": "train_fp32", "layers": cfg.num_layers,
           "params": cfg.param_count(), "batch": TRAIN_B, "seq": TRAIN_T,
           "optimizer": hp.name, "runs": runs, "loss_rel_err": loss_rel,
           "grad_norm_rel_err": gn_rel, "param_max_abs_diff": diff_max,
           "param_mean_abs_diff": diff_sum / n,
           "param_mean_abs_move": move_sum / n,
           "param_rel_err": param_rel, "param_sign_bound": sign_bound,
           "launches": launches, "launches_per_step": per_step,
           "tol": {"loss": TOL_TRAIN_LOSS, "grad_norm": TOL_TRAIN_GNORM,
                   "param": TOL_TRAIN_PARAM}}
    if loss_rel > TOL_TRAIN_LOSS or gn_rel > TOL_TRAIN_GNORM or \
            param_rel > TOL_TRAIN_PARAM or diff_max > sign_bound:
        fail(f"train: the kernel path disagrees with the plain path: {out}")
    emit({**out, "ok": True})
    return launches


def train_bf16(n_timed=5):
    """bf16 (the config's dtype): three steps through the plain chunked
    attention, freed, then through the kernels one warm-up step and
    ``n_timed`` timed ones from the same seeded weights and batches; the
    kernel run's first three losses are held to the plain run's, and the
    flash launch counts are zeroed just before the kernel run and read
    just after. Returns what the profile phase continues from."""
    cfg = train_cfg("bfloat16")
    params, state, step, ds = _start_training(cfg, "chunked")
    _, _, plain_losses, _, plain_s = _run_steps(params, state, step, ds, 3)
    del params, state, step, ds
    torch.cuda.empty_cache()
    params, state, step, ds = _start_training(cfg, "kernel")
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_launches()
    params, state, warm_losses, _, warm_s = _run_steps(params, state, step,
                                                       ds, 1)
    params, state, losses, gnorms, secs = _run_steps(params, state, step, ds,
                                                     n_timed)
    launches = _flash_launches()
    per_step = _check_flash_launches(launches, 1 + n_timed, sm90=True)
    ms = 1e3 * secs / n_timed
    kernel_losses = warm_losses + losses
    loss_rel = max(abs(x - y) / abs(y)
                   for x, y in zip(kernel_losses[:3], plain_losses))
    out = {"phase": "train_bf16", "layers": cfg.num_layers,
           "params": cfg.param_count(), "batch": TRAIN_B, "seq": TRAIN_T,
           "warmup_s": warm_s, "ms_per_step": ms,
           "tokens_per_s": TRAIN_B * TRAIN_T * n_timed / secs,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "losses": kernel_losses, "grad_norms": gnorms,
           "plain_losses": plain_losses, "plain_s_per_step": plain_s / 3,
           "loss_rel_err": loss_rel, "tol_loss": TOL_TRAIN_BF16_LOSS,
           "launches": launches, "launches_per_step": per_step}
    if loss_rel > TOL_TRAIN_BF16_LOSS:
        fail(f"train: bf16 kernel losses disagree with the plain path: {out}")
    emit({**out, "ok": True})
    return (params, state, step, ds), launches, ms


def profile_train_step(run, ms_per_step):
    """One bf16 training step under torch.profiler: device time, the
    idle share against the unprofiled step time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    params, state, step, ds = run
    batch = ds.next_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, m = step(params, state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows) or None
    flash = sum(ms for k, ms, _ in rows if "flash_" in k)
    emit({"phase": "train_profile", "ok": True, "dtype": "bfloat16",
          "steps": 1, "device_ms_per_step": busy,
          "unprofiled_ms_per_step": ms_per_step,
          "idle_share": busy and 1.0 - busy / ms_per_step,
          "flash_kernels_ms": flash,
          "top": [{"name": k[:90], "ms": ms, "calls": c}
                  for k, ms, c in rows[:16]]})


# --------------------------------------------------------------- serving --
SERVE_BATCH, SERVE_PAGE, SERVE_POOL = 4, 64, 160
SERVE_PREFIX = 5              # pages of the shared system prompt (320)
SERVE_SFX = (1, 2, 3, 14, 5, 7, 9, 2, 11)  # suffixes, in half pages (32)
SERVE_NEW = (24, 8, 40, 16, 48, 12, 32, 20, 36, 28)
SERVE_RATE = 1.0              # requests/s of the bf16 phase's Poisson trace
SERVE_LAYERS = 18             # paper-target cut in depth for the serving
                              # phases (half of 36: their eager cycles are
                              # host-bound and the run's time limit binds)


def serving_traffic(bundle):
    """The serving phases' 10 requests, behind a chat endpoint: each
    prompt is the 320-token system prompt and a suffix of its own of
    32-448 tokens; requests 1 and 7 share 352 tokens (a match that ends
    inside a page: a COW copy); request 9 is request 0's prompt, its
    plain greedy answer (``greedy_reference``) and 40 new tokens (a
    second turn, hitting generated tokens); ``max_new`` 8-48. Request 0
    is served first on its own (the earlier turn), the other nine after
    it, FIFO. Returns [(prompt, max_new)]."""
    rng = np.random.default_rng(21)
    vocab = bundle.target_cfg.vocab_size
    half = SERVE_PAGE // 2
    n_sys = SERVE_PREFIX * SERVE_PAGE
    sysp = rng.integers(0, vocab, n_sys)
    prompts = [np.concatenate([sysp, rng.integers(0, vocab, n * half)])
               for n in SERVE_SFX]
    prompts[7] = np.concatenate([prompts[1][:n_sys + half],
                                 rng.integers(0, vocab, 3 * half)])
    answer, _ = greedy_reference(bundle.target_params, bundle.target_cfg,
                                 torch.as_tensor(prompts[0][None],
                                                 device=DEVICE), SERVE_NEW[0])
    prompts.append(np.concatenate([prompts[0], answer[0],
                                   rng.integers(0, vocab, 40)]))
    return [(p.astype(np.int32), n) for p, n in zip(prompts, SERVE_NEW)]


def greedy_gaps(bundle, reqs, toks):
    """Plain fp32 greedy, teacher-forced: one plain forward (no cache, no
    kernel) over each request's prompt and served tokens. Returns, per
    request, the argmax before each served token and the top-2 gap
    there: the served tokens are plain greedy's exactly when they equal
    those argmaxes (``greedy_reference`` decodes the same argmaxes one
    token at a time)."""
    from repro_torch.models import lm
    out = []
    for (p, n), t in zip(reqs, toks):
        seq = torch.as_tensor(np.concatenate([p, t[:-1]]), device=DEVICE)
        with torch.no_grad():
            logits = lm.forward(bundle.target_params, seq[None].long(),
                                bundle.target_cfg)["logits"][0, len(p) - 1:]
        top = torch.topk(logits.float(), 2, dim=-1)
        out.append((top.indices[:, 0].cpu().numpy()[None],
                    (top.values[:, 0] - top.values[:, 1]).cpu().numpy()[None]))
    return out


def _pool_owned_by_tree(eng, where):
    """After a run: the pool's books balance, and every page in use is
    the radix tree's (refcount 1, no row holds it)."""
    if eng.pool is None:
        return
    eng.pool.sanity_check()
    tree = {p for node in eng.cache._nodes() for _, p in node.pages} \
        if eng.cache is not None else set()
    rc = eng.pool.refcounts()
    if eng.pool.pages_in_use != len(tree) or any(rc[p] != 1 for p in tree):
        fail(f"{where}: {eng.pool.pages_in_use} pages in use, the radix "
             f"tree owns {len(tree)}")


def serve_run(bundle, reqs, name, snoop=None, **kw):
    """Request 0, then the other nine, through one ``ServingEngine``
    (batch 4, pages of 64): per-request tokens and a record of the run.
    ``snoop(eng, state)``, when given, sees the state before each cycle."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(bundle, batch_size=SERVE_BATCH, device=DEVICE, **kw)
    n_cycles = [0]
    cycle = eng._cycle

    def counted(state, gen):
        n_cycles[0] += 1
        if snoop is not None:
            snoop(eng, state)
        return cycle(state, gen)

    eng._cycle = counted
    cycle_s = _time_cycles(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for part in (reqs[:1], reqs[1:]):
        for p, n in part:
            eng.submit(p, n)
        stats = eng.run()
        _pool_owned_by_tree(eng, name)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = {r.uid: r.out for r in eng.done}
    vocab = bundle.target_cfg.vocab_size
    for uid, (p, n) in enumerate(reqs):
        t = toks.get(uid)
        if t is None or t.shape != (n,) or t.min() < 0 or t.max() >= vocab:
            fail(f"serving {name}: request {uid} gave {t}")
    keep = ("cycles", "tokens", "alpha", "wasted_row_cycles", "refills",
            "installs", "install_calls", "install_traces", "pool_pages",
            "pool_peak_pages", "pool_utilization", "prefix_hits",
            "prefix_misses", "prefix_hit_tokens", "prefill_tokens_saved",
            "cow_copies", "prefix_evictions", "refill_copy_bytes", "waves")
    info = {"run": name, **{k: stats[k] for k in keep},
            "decode_cycles": n_cycles[0], "wall_s": wall,
            "ms_per_cycle": 1e3 * float(np.median(cycle_s)),
            "wall_ms_per_cycle": 1e3 * wall / max(n_cycles[0], 1),
            "tokens_per_s": stats["tokens"] / wall}
    return eng, toks, info


class SharedTableSnoop:
    """Keeps, at the first cycle whose page table holds a page in two rows
    (a prefix hit) beside sentinel tails, layer 0's pools, the table and
    the lengths, to hold kernel #2 to its plain version there."""

    def __init__(self):
        self.snap = None

    def __call__(self, eng, state):
        if self.snap is not None:
            return
        from repro_torch.models import kvcache as kvc
        pt = state.d1_feat["pt"]
        rows = [set(r) - {kvc.PAGE_SENTINEL} for r in pt.tolist()]
        shared = set.intersection(*rows) if len(rows) > 1 else set()
        dup = {p for i, a in enumerate(rows) for b in rows[i + 1:]
               for p in a & b}
        if not dup or not (pt == kvc.PAGE_SENTINEL).any():
            return
        layer = state.target["layers"][0]
        self.snap = {"k": layer["k"].clone(), "v": layer["v"].clone(),
                     "pt": pt.clone(), "len": state.length.clone(),
                     "shared_pages": len(dup), "in_every_row": len(shared),
                     "sentinels": int((pt == kvc.PAGE_SENTINEL).sum())}

    def check(self, bundle):
        """#2 and its plain version on the kept table: random fp32 queries
        at the verify shape (Tq 76), through the wave's real pools."""
        from repro_torch.kernels import cascade_attention as casc
        from repro_torch.kernels import cascade_cases
        if self.snap is None:
            fail("serving: no cycle ran with a shared page beside a "
                 "sentinel tail")
        s = self.snap
        cfg = bundle.target_cfg
        b, tq = s["pt"].shape[0], 76
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(3)
        q = torch.randn((b, tq, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=DEVICE).transpose(1, 2)
        qa = s["len"][:, None].long() + torch.arange(tq, device=DEVICE)
        args = (q, s["k"].transpose(1, 2), s["v"].transpose(1, 2), s["pt"])
        kw = dict(cache_len=s["len"], q_abs=qa, scale=cfg.head_dim ** -0.5)
        kern = casc.cascade_phase1_paged(*args, **kw)
        plain = casc.cascade_phase1_paged_plain(*args, **kw)
        live = plain[1] > -1e29
        err = {"acc_m_l": max(((a - p).abs() / (1 + p.abs())).reshape(
            *live.shape, -1).amax(-1)[live].max().item()
            for a, p in zip(kern, plain)),
            "live_splits": int(live.sum())}
        if err["acc_m_l"] > cascade_cases.TOL_PART:
            fail(f"serving: #2 on the live shared table is off its plain "
                 f"version: {err}")
        return {**{k: v for k, v in s.items() if isinstance(v, int)}, **err}


def _serve_agreement(name, bundle, reqs, toks):
    """Each request held to plain greedy (``greedy_gaps``): a served token
    that is not the argmax before it passes only on a near tie."""
    ties = {}
    for uid, (ref, gaps) in enumerate(greedy_gaps(
            bundle, reqs, [toks[u] for u in range(len(reqs))])):
        diff = np.nonzero(toks[uid] != ref[0])[0]
        t = [{"pos": int(j), "ref_top2_gap": float(gaps[0, j])}
             for j in diff]
        if any(x["ref_top2_gap"] >= NEAR_TIE for x in t):
            fail(f"{name}: request {uid} is not plain greedy: {t}")
        if t:
            ties[uid] = t
    return ties


def cut_depth(bundle, n_layers):
    """``bundle`` with its target cut to its first ``n_layers`` layers (the
    weights shared, not copied)."""
    params = dict(bundle.target_params,
                  layers=bundle.target_params["layers"][:n_layers])
    return dataclasses.replace(
        bundle, target_params=params,
        target_cfg=dataclasses.replace(bundle.target_cfg,
                                       num_layers=n_layers))


def serving_path(bundle):
    """fp32, the identity gates of serving (module docstring)."""
    from repro_torch.core import pipeline as pl
    t0 = time.perf_counter()
    reqs = serving_traffic(bundle)
    kern = pl.with_attn_impl(bundle, "kernel")
    paged = dict(cache_impl="paged", page_size=SERVE_PAGE,
                 pool_pages=SERVE_POOL)
    runs, toks, launches, ties = [], {}, {}, {}
    snoop = SharedTableSnoop()
    plan = [("legacy", kern, dict(early_exit=False, refill=False), None),
            ("dense_refill", kern, {}, None),
            ("paged", kern, paged, None),
            ("prefix_kernel", kern, dict(paged, prefix_cache=True), snoop),
            ("prefix_gather", pl.with_attn_impl(bundle, "gather"),
             dict(paged, prefix_cache=True), None)]
    for name, b, kw, sn in plan:
        _zero_launches()
        eng, toks[name], info = serve_run(b, reqs, name, snoop=sn, **kw)
        counts = _launches()
        info["launches"] = counts
        info["launches_per_cycle"] = {k: v / info["decode_cycles"]
                                      for k, v in counts.items() if v}
        runs.append(info)
        launches[name] = counts
        if name == "legacy" or any(
                not np.array_equal(toks[name][u], toks["legacy"][u])
                for u in toks[name]):
            ties[f"{name} vs greedy"] = _serve_agreement(
                name, bundle, reqs, toks[name])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    by = {r["run"]: r for r in runs}
    for name, entry in (("legacy", "cascade_phase1"),
                        ("dense_refill", "cascade_phase1"),
                        ("paged", "cascade_phase1_paged"),
                        ("prefix_kernel", "cascade_phase1_paged")):
        if launches[name][entry] <= 0 or launches[name][f"{entry}_sm90"]:
            fail(f"serving {name}: cascade launches {launches[name]}: "
                 f"expected the fp32 {entry} kernel")
    if any(launches["prefix_gather"].values()):
        fail(f"serving prefix_gather launched {launches['prefix_gather']}")
    pk = by["prefix_kernel"]
    if pk["prefix_hits"] < 8 or pk["cow_copies"] < 1 \
            or pk["prefill_tokens_saved"] <= 0:
        fail(f"serving: prefix cache barely used: {pk}")
    if by["legacy"]["tokens"] != by["dense_refill"]["tokens"] or \
            by["legacy"]["cycles"] <= by["dense_refill"]["cycles"]:
        fail(f"serving: legacy {by['legacy']['cycles']} cycles, refill "
             f"{by['dense_refill']['cycles']}, tokens "
             f"{by['legacy']['tokens']} / {by['dense_refill']['tokens']}")
    live_table = snoop.check(bundle)
    emit({"phase": "serving", "ok": True, "dtype": "float32",
          "batch": SERVE_BATCH, "page": SERVE_PAGE, "pool_pages": SERVE_POOL,
          "prompt_lens": [len(p) for p, _ in reqs],
          "max_new": list(SERVE_NEW), "runs": runs,
          "tokens_equal_across_runs": all(
              np.array_equal(toks[n][u], toks["legacy"][u])
              for n in toks for u in toks[n]),
          "near_ties": {k: v for k, v in ties.items() if v},
          "live_table_check": live_table,
          "seconds": time.perf_counter() - t0})
    return reqs, {n: toks[n] for n in ("prefix_gather",)}, by


def serving_bf16(bundle, reqs):
    """bf16, paged engine pool with the prefix cache, kernel path: the
    requests as a Poisson trace at SERVE_RATE through the overlapped
    front-end and through the synchronous baseline, on the card's own
    clock; then a drain run through the gather path, which the kernel
    runs' tokens are held to (``bf16_divergences``' near-tie rule)."""
    from repro_torch.core import pipeline as pl
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.frontend import ReplayDriver
    from repro_torch.serving.metrics import MetricsRecorder, MonotonicClock
    from repro_torch.serving.traffic import Arrival
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    times = np.cumsum(rng.exponential(1.0 / SERVE_RATE, len(reqs)))
    trace = [Arrival(t=float(t), prompt=p, max_new=n)
             for t, (p, n) in zip(times, reqs)]
    kern = pl.with_attn_impl(bundle, "kernel")
    kw = dict(batch_size=SERVE_BATCH, cache_impl="paged",
              page_size=SERVE_PAGE, pool_pages=SERVE_POOL, prefix_cache=True,
              device=DEVICE)
    runs, toks = {}, {}
    for name, overlap in (("overlapped", True), ("sync", False)):
        _zero_launches()
        clock = MonotonicClock()
        eng = ServingEngine(kern, clock=clock,
                            recorder=MetricsRecorder(clock), **kw)
        cycle_s = _time_cycles(eng)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        st = ReplayDriver(eng, trace, overlap=overlap).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        _pool_owned_by_tree(eng, f"serving_bf16 {name}")
        counts = _launches()
        if counts["cascade_phase1_paged_sm90"] <= 0 or \
                counts["cascade_phase1_paged"]:
            fail(f"serving_bf16 {name}: cascade launches {counts}")
        toks[name] = {r.uid: r.out for r in eng.done}
        sla = st["sla"]
        runs[name] = {
            "engine_cycles": st["engine_cycles"], "tokens": st["tokens"],
            "alpha": st["alpha"], "wall_s": wall,
            # generated tokens over a wall time that waits for arrivals
            "tokens_per_replay_s": st["tokens"] / wall,
            "ms_per_cycle": 1e3 * float(np.median(cycle_s)),
            "ms_per_cycle_mean": 1e3 * float(np.mean(cycle_s)),
            "cycles_share_of_wall": float(np.sum(cycle_s)) / wall,
            "prefix_hits": st["prefix_hits"], "cow_copies": st["cow_copies"],
            "launches_per_cycle": counts["cascade_phase1_paged_sm90"]
            / st["engine_cycles"],
            # over ten requests a nearest-rank p99 is the max
            "ttft_s": {k: sla["ttft"][k] for k in ("p50", "max")},
            "tpot_s": {k: sla["tpot"][k] for k in ("p50", "max")},
            "e2e_s": {k: sla["e2e"][k] for k in ("p50", "max")},
            "queue_max": sla["queue_depth"]["max"]}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    _, gather, ginfo = serve_run(pl.with_attn_impl(bundle, "gather"), reqs,
                                 "bf16_gather", cache_impl="paged",
                                 page_size=SERVE_PAGE, pool_pages=SERVE_POOL,
                                 prefix_cache=True)
    first, seen = {}, {}
    for name in toks:
        for uid, (p, _) in enumerate(reqs):
            key = (uid, toks[name][uid].tobytes())
            if key not in seen:      # the other run gave the same tokens
                seen[key] = bf16_divergences(
                    bundle, [p], toks[name][uid][None], gather[uid][None],
                    "paged")[0]
            if seen[key] is not None:
                first[f"{name}/{uid}"] = seen[key]
    emit({"phase": "serving_bf16", "ok": True, "dtype": "bfloat16",
          "rate": SERVE_RATE, "arrivals_s": times.tolist(), "runs": runs,
          "gather_run": ginfo, "first_divergence": first,
          "agree_with_gather": {n: float(np.mean([
              np.array_equal(toks[n][u], gather[u]) for u in gather]))
              for n in toks},
          "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _time_cycles(eng):
    """The host time of each engine cycle, from the start of its dispatch
    to the end of its complete (the admission work between them, which
    the overlapped front end does, included): a list the engine fills."""
    durs, t = [], [0.0]
    dispatch, complete = eng.dispatch_cycle, eng.complete_cycle

    def timed_dispatch():
        t[0] = time.perf_counter()
        return dispatch()

    def timed_complete(handle):
        out = complete(handle)
        if handle is not None:
            durs.append(time.perf_counter() - t[0])
        return out

    eng.dispatch_cycle, eng.complete_cycle = timed_dispatch, timed_complete
    return durs


# ------------------------------------------------------------------ main --
def _timing_keys(t):
    return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}


# ------------------------------------------------------ recurrent targets --
# phase -> (arch, prompt length of each row, new tokens a row): the
# hybrid's prompts are ragged and long enough that every row's rolling
# local buffers (window 2048) wrap during its 64 new tokens; the ssm
# phase is cut to 32 (its eager fp32 cycle is host-bound, about 230 ms)
RECURRENT = {"hybrid": ("recurrentgemma-2b", (2000, 2013, 2027, 2040), 64),
             "ssm": ("rwkv6-1.6b", (512, 512, 512, 512), 32)}


def production_drafter(tcfg, dtype, gamma=GAMMA):
    """The drafter JAX's ``launch/steps.py::production_drafter`` sizes for
    a target, copied: d = max(512, d_model / 4 rounded down to 128),
    heads of 128, 2 KV heads when the heads are even (else 1), ff 3d, two
    layers."""
    from repro_torch.core.drafter import DrafterConfig
    from repro_torch.models import lm
    d = max(512, (tcfg.d_model // 4) // 128 * 128)
    heads = max(4, d // 128)
    return DrafterConfig(
        d_model=d, num_layers=2, num_heads=heads,
        num_kv_heads=2 if heads % 2 == 0 else 1, d_ff=3 * d,
        vocab_size=tcfg.vocab_size, target_feature_dim=lm.feature_dim(tcfg),
        gamma=gamma, dtype=dtype)


def recurrent_bundle(arch):
    """fp32 full-width, full-depth ``arch`` with random seeded weights and
    two production drafters, d2sd at gamma 16, K 4."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.config.registry import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import drafter_init
    from repro_torch.models import lm
    tcfg = dataclasses.replace(get_config(arch), dtype="float32")
    dcfg = production_drafter(tcfg, "float32")
    spec = SpecConfig(gamma=GAMMA, top_k_branches=K_BRANCHES, mode="d2sd")
    return pl.SpecBundle(tcfg, dcfg, dcfg, spec,
                         lm.lm_init(tcfg, seed=0, device=DEVICE),
                         drafter_init(dcfg, seed=1, device=DEVICE),
                         drafter_init(dcfg, seed=2, device=DEVICE))


def _recurrent_runs(bundle, prompts, lens, max_new, where,
                    check_launches):
    """The kernel path through the host loop on the paged cache, and the
    kernel and gather paths through the graph loop on both caches:
    tokens and records by (impl, cache, loop). Each kernel run's cascade
    counts are zeroed just before it and read just after:
    ``check_launches(counts, cache, cycles)`` judges a host run's over
    its cycles and a graph run's over two (a replay runs no wrapper: the
    eager first cycle and the capture count)."""
    toks, runs, per_cycle = {}, [], {}
    plan = [("kernel", "paged", False), ("kernel", "paged", True),
            ("gather", "paged", True), ("kernel", "dense", True),
            ("gather", "dense", True)]
    for impl, cache, ondevice in plan:
        _zero_launches()
        t, info = run_generate(bundle, prompts, impl, cache,
                               ondevice=ondevice, max_new=max_new,
                               true_len=lens)
        counts = _launches()
        if impl == "kernel":
            cycles = 2 if ondevice else info["cycles"]
            info["launches"] = counts
            check_launches(counts, cache, cycles)
            per_cycle.setdefault(cache, {k: v / cycles for k, v in
                                         counts.items()})
        elif any(counts.values()):
            fail(f"{where} gather/{cache}: cascade launches {counts}")
        toks[(impl, cache, "graph" if ondevice else "host")] = t
        runs.append(info)
    if not np.array_equal(toks[("kernel", "paged", "graph")],
                          toks[("kernel", "paged", "host")]):
        fail(f"{where}: the graph loop's tokens are not the host loop's")
    return toks, runs, per_cycle


def recurrent_path(phase):
    """fp32 identity and bf16 speed of a recurrent target (module
    docstring: ``hybrid``, ``ssm``). Frees its models before it returns
    the cascade launches a cycle, by dtype, cache and kernel."""
    from repro_torch.core import pipeline as pl
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, lens, max_new = RECURRENT[phase]
    bundle = recurrent_bundle(arch)
    cfg = bundle.target_cfg
    kinds = cfg.pattern_for_depth()
    n_local = sum(k in ("global", "local") for k in kinds)
    n_draft = replay_launches(bundle, "paged") - n_local
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (len(lens), max(lens)))
    lens = np.asarray(lens)
    ref_toks, gaps = greedy_reference(
        bundle.target_params, cfg, torch.as_tensor(prompts, device=DEVICE),
        max_new, true_len=lens)

    def check(counts, cache, cycles, sm90=""):
        want = {f"cascade_phase1{sm90}": n_local * cycles,
                f"cascade_phase1_paged{sm90}":
                    n_draft * cycles if cache == "paged" else 0}
        other = {k: v for k, v in counts.items() if k not in want and v}
        if any(counts[k] != v for k, v in want.items()) or other:
            fail(f"{phase} {cache}: cascade launches {counts} over {cycles} "
                 f"cycles: expected {n_local} #1 and {want} in all")

    toks, runs, per_cycle = _recurrent_runs(bundle, prompts, lens, max_new,
                                            phase, check)
    ties = {}
    for (impl, cache, loop), t in toks.items():
        ties[f"{impl}/{cache}/{loop} vs greedy"] = agreement(
            f"{phase} {impl}/{cache}/{loop}", t, ref_toks, gaps)
        if impl == "kernel":
            ties[f"kernel/{cache}/{loop} vs gather"] = agreement(
                f"{phase} kernel/{cache}/{loop}", t,
                toks[("gather", cache, "graph")], gaps)
    fp32 = {"runs": runs, "launches_per_cycle": per_cycle,
            "near_ties": {k: v for k, v in ties.items() if v},
            "min_ref_top2_gap": float(gaps.min())}
    del toks
    # bf16: six graph replays a cache under the profiler. The gate is the
    # wrappers' exact counts of the loop's eager first cycle and capture;
    # the trace's count by name is reported beside them (a trace can lose
    # events: ROADMAP.md queue 3)
    b16 = pl.with_attn_impl(to_bf16(bundle), "kernel")
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    profiles, bf16_per_cycle = {}, {}
    for cache in ("paged", "dense"):
        _zero_launches()
        profiles[cache] = profile_loop(b16, prompts, cache,
                                       replay_launches(b16, cache),
                                       true_len=lens)
        counts = _launches()
        check(counts, cache, 2, sm90="_sm90")
        bf16_per_cycle[cache] = {k: v / 2 for k, v in counts.items()}
    emit({"phase": phase, "ok": True, "arch": arch,
          "layers": cfg.num_layers, "pattern": list(cfg.layer_pattern),
          "params": cfg.param_count(), "drafter": {
              k: getattr(b16.d1_cfg, k) for k in (
                  "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "num_layers")},
          "batch": len(lens), "prompt_lens": lens.tolist(),
          "max_new": max_new, "gamma": GAMMA, "k": K_BRANCHES,
          "launches_per_cycle_want": {"cascade_phase1": n_local,
                                      "cascade_phase1_paged": n_draft},
          "float32": fp32, "bfloat16": {"graph_profile": profiles},
          "seconds": time.perf_counter() - t0})
    del b16
    gc.collect()
    torch.cuda.empty_cache()
    return {"float32": per_cycle, "bfloat16": bf16_per_cycle}


def serving_recurrent():
    """fp32 ``ServingEngine`` over the hybrid target (kernel path): the
    serving phase's 10 requests through dense refill and the paged engine
    pool (the drafters' feature caches paged; the prefix cache is refused
    for a target that is not all-global). Per-request tokens equal across
    both runs and plain greedy (near ties reported)."""
    from repro_torch.core import pipeline as pl
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = recurrent_bundle(RECURRENT["hybrid"][0])
    reqs = serving_traffic(bundle)
    kern = pl.with_attn_impl(bundle, "kernel")
    runs, toks, ties = [], {}, {}
    for name, kw in (("dense_refill", {}),
                     ("paged", dict(cache_impl="paged", page_size=SERVE_PAGE,
                                    pool_pages=SERVE_POOL))):
        _zero_launches()
        eng, toks[name], info = serve_run(kern, reqs, name, **kw)
        counts = _launches()
        info["launches"] = counts
        info["launches_per_cycle"] = {k: v / info["decode_cycles"]
                                      for k, v in counts.items() if v}
        if not counts["cascade_phase1"] or counts["cascade_phase1_sm90"] \
                or counts["cascade_phase1_paged_sm90"] or (
                    name == "paged") != bool(counts["cascade_phase1_paged"]):
            fail(f"serving_recurrent {name}: cascade launches {counts}")
        runs.append(info)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    ties["dense_refill vs greedy"] = _serve_agreement(
        "serving_recurrent", bundle, reqs, toks["dense_refill"])
    if any(not np.array_equal(toks["paged"][u], toks["dense_refill"][u])
           for u in toks["paged"]):
        ties["paged vs greedy"] = _serve_agreement(
            "serving_recurrent paged", bundle, reqs, toks["paged"])
    emit({"phase": "serving_recurrent", "ok": True, "dtype": "float32",
          "arch": bundle.target_cfg.name, "batch": SERVE_BATCH,
          "prompt_lens": [len(p) for p, _ in reqs],
          "max_new": list(SERVE_NEW), "runs": runs,
          "tokens_equal_across_runs": all(
              np.array_equal(toks["paged"][u], toks["dense_refill"][u])
              for u in toks["paged"]),
          "near_ties": {k: v for k, v in ties.items() if v},
          "seconds": time.perf_counter() - t0})
    del bundle, kern
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------- MoE, cross, other archs --
ARCH_PROMPT, ARCH_NEW = 512, 32   # 4 prompts a phase, tokens a row
# full width; depth cut only where one card cannot hold the model:
# grok-1-314b 4.92e9 parameters a layer and 1.61e9 in the embedding and
# head (fp32 2 layers: 45.8 GB; bf16 4 layers: 42.6 GB); kimi-k2's 384
# experts 16.9e9 a layer (bf16 1 layer: about 39 GB); internlm2-20b
# 79 GB in fp32 at its 48 layers (16: about 30 GB)
GROK_LAYERS, GROK_BF16_LAYERS, KIMI_LAYERS = 2, 4, 1
CTX_ARCHS = ("llama-3.2-vision-11b", "whisper-medium")
DENSE_ARCHS = (("qwen2.5-3b", None), ("gemma2-2b", None),
               ("stablelm-3b", None), ("internlm2-20b", 16))


def arch_bundle(arch, dtype, layers=None):
    """``arch`` at full width (cut to ``layers`` when given) in ``dtype``
    with random seeded weights and two drafters by JAX's
    ``production_drafter`` rule, d2sd at gamma 16, K 4. A MoE's expert
    stacks are drawn straight into ``dtype`` (``param_dtype``); the other
    weights are drawn in fp32 and, for bf16, cast in place. Returns
    (bundle, the encoder's params or None)."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.config.registry import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import drafter_init
    from repro_torch.models import encdec, lm
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                              num_layers=layers or cfg.num_layers)
    dcfg = production_drafter(cfg, dtype)
    enc = None
    if cfg.is_encoder_decoder:
        both = encdec.encdec_init(cfg, seed=0, device=DEVICE)
        enc, tp = both["encoder"], both["decoder"]
    else:
        tp = lm.lm_init(cfg, seed=0, device=DEVICE)
    spec = SpecConfig(gamma=GAMMA, top_k_branches=K_BRANCHES, mode="d2sd")
    bundle = pl.SpecBundle(cfg, dcfg, dcfg, spec, tp,
                           drafter_init(dcfg, seed=1, device=DEVICE),
                           drafter_init(dcfg, seed=2, device=DEVICE))
    if dtype == "bfloat16":
        bundle = to_bf16(bundle)
    return bundle, enc


def _arch_prompts(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, ARCH_PROMPT))


def _free():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _launch_check(where, counts, want, cycles):
    """fp32 runs: exact launches of the fp32 cascade kernels over
    ``cycles`` (``want``: kernel -> launches a cycle), none of the bf16
    ones; bf16 the same through the sm90 kernels."""
    expect = {k: v * cycles for k, v in want.items()}
    other = {k: v for k, v in counts.items() if k not in want and v}
    if any(counts[k] != v for k, v in expect.items()) or other:
        fail(f"{where}: cascade launches {counts} over {cycles} cycles, "
             f"expected {want} a cycle")


def _want_launches(bundle, cache, sm90=False):
    """Launches a decode cycle: #1 one a local layer (and every attention
    layer on a dense cache), #2 one a global layer on a paged cache and
    one a drafter layer and pass."""
    kinds = bundle.target_cfg.pattern_for_depth()
    n_local = sum(k == "local" for k in kinds)
    n_paged = replay_launches(bundle, cache) - n_local
    sfx = "_sm90" if sm90 else ""
    if cache == "dense":
        return {f"cascade_phase1{sfx}": n_local + n_paged,
                f"cascade_phase1_paged{sfx}": 0}
    return {f"cascade_phase1{sfx}": n_local,
            f"cascade_phase1_paged{sfx}": n_paged}


def _arch_runs(where, bundle, prompts, plan, ctx=None, probes=None):
    """Each (impl, cache, graph loop?) of ``plan``, counts zeroed just
    before a run and read just after: tokens by (impl, cache, loop), the
    runs' records, launches a cycle of each kernel run (a host run over
    its cycles, exact; a graph run over its eager first cycle and its
    capture). ``probes`` (a dict): each host run of a MoE target under a
    :class:`MoeProbe` of its own, kept by (impl, cache)."""
    toks, runs, per_cycle = {}, [], {}
    for impl, cache, graph in plan:
        _zero_launches()
        probe = MoeProbe() if probes is not None and not graph else None
        with probe or contextlib.nullcontext():
            t, info = run_generate(bundle, prompts, impl, cache,
                                   ondevice=graph, max_new=ARCH_NEW, ctx=ctx)
        if probe is not None:
            probes[(impl, cache)] = probe
        counts = _launches()
        sm90 = bundle.target_cfg.dtype == "bfloat16"
        if impl == "kernel":
            cycles = 2 if graph else info["cycles"]
            _launch_check(f"{where} {cache}", counts,
                          _want_launches(bundle, cache, sm90), cycles)
            info["launches"] = counts
            if not graph:
                per_cycle[cache] = {k: v / cycles for k, v in counts.items()
                                    if v}
        elif any(counts.values()):
            fail(f"{where} gather/{cache}: cascade launches {counts}")
        toks[(impl, cache, "graph" if graph else "host")] = t
        runs.append(info)
    return toks, runs, per_cycle


def _hold(where, toks, ref, gaps, greedy=True):
    """Every run held to plain greedy (``greedy``) and every kernel run to
    the gather run of its cache (or of the paged one), if there is one; a
    first divergence passes only on a near tie of the reference. Returns
    the near ties that passed."""
    ties = {}
    for (impl, cache, loop), t in toks.items():
        if greedy:
            ties[f"{impl}/{cache}/{loop} vs greedy"] = agreement(
                f"{where} {impl}/{cache}/{loop}", t, ref, gaps)
        g = toks.get(("gather", cache, "host"),
                     toks.get(("gather", "paged", "host")))
        if impl == "kernel" and g is not None:
            ties[f"kernel/{cache}/{loop} vs gather"] = agreement(
                f"{where} kernel/{cache}/{loop}", t, g, gaps)
    return {k: v for k, v in ties.items() if v}


class MoeProbe:
    """While installed, works out from the routing itself
    (``moe._capacity``, ``_positions``) what each MoE pass did, kept on
    the card: by the pass's token count (the prefill's B x P, a verify
    pass's B x n_tree) the passes, (token, expert) pairs and dropped
    pairs. The program keeps no such record."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.moe_apply
        self.counts = {}

        def probed(p, x, cfg, dispatch=None):
            m = cfg.moe
            x2 = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(x2.float() @ p["router"].float(), -1)
            idx = torch.topk(probs, m.top_k, dim=-1).indices
            keep = (moe._positions(idx, m.num_experts)
                    < moe._capacity(x2.shape[0], cfg))
            rec = self.counts.setdefault(x2.shape[0], torch.zeros(
                3, dtype=torch.long, device=x.device))
            rec += torch.stack([torch.ones_like(rec[0]),
                                torch.full_like(rec[0], idx.numel()),
                                (~keep).sum()])
            return self.real(p, x, cfg, dispatch)

        moe.moe_apply = probed
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.real

    def drops(self):
        return {str(n): dict(zip(("passes", "pairs", "dropped"),
                                 v.tolist()))
                for n, v in sorted(self.counts.items())}


def moe_path():
    """grok-1-314b in fp32 (2 of 64 layers, capacity factor 1.25): the
    kernel path on the paged and dense caches through both loops, the
    gather path on both caches (host loop); the graph loop's tokens held
    to the host loop's, the kernel path's to the gather path's (a
    divergence passes only on a near tie of the logits);
    agreement with plain greedy and the dropped (token, expert) pairs
    reported. Then the same model with the capacity factor at E/k
    (nothing can drop): tokens held to plain greedy. Then grok-1 in bf16
    at 4 layers, six profiled graph replays (paged), and kimi-k2-1t-a32b
    in bf16 at 1 of 61 layers (384 experts, top 8, a shared expert):
    kernel against gather by the bf16 near-tie rule. Returns launches a
    cycle by model, dtype and cache."""
    from repro_torch.core import pipeline as pl
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    out, launches = {}, {}
    bundle, _ = arch_bundle("grok-1-314b", "float32", GROK_LAYERS)
    cfg = bundle.target_cfg
    prompts = _arch_prompts(cfg, 21)
    ref, gaps = greedy_reference(bundle.target_params, cfg,
                                 torch.as_tensor(prompts, device=DEVICE),
                                 ARCH_NEW)
    probes = {}
    toks, runs, per_cycle = _arch_runs(
        "moe grok-1", bundle, prompts,
        [("kernel", "paged", False), ("kernel", "dense", False),
         ("gather", "paged", False), ("gather", "dense", False),
         ("kernel", "paged", True), ("kernel", "dense", True)],
        probes=probes)
    for cache in ("paged", "dense"):
        if not np.array_equal(toks[("kernel", cache, "graph")],
                              toks[("kernel", cache, "host")]):
            fail(f"moe grok-1 {cache}: the graph loop's tokens are not the "
                 "host loop's")
    ties = _hold("moe grok-1", {k: v for k, v in toks.items()
                                if k[2] == "host"}, ref, gaps, greedy=False)
    launches["grok-1-314b"] = {"float32": per_cycle}
    out["grok_fp32"] = {
        "layers": cfg.num_layers, "capacity_factor": cfg.moe.capacity_factor,
        "runs": runs, "near_ties": ties,
        "drops_kernel_paged_host": probes[("kernel", "paged")].drops(),
        "agree_with_greedy": {f"{i}/{c}/{lp}": float((t == ref).mean())
                              for (i, c, lp), t in toks.items()},
        "min_ref_top2_gap": float(gaps.min())}
    # nothing can drop: capacity C = T (a token's k experts are
    # distinct), in the prefill too, so plain greedy is taken anew
    nodrop = dataclasses.replace(bundle, target_cfg=dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)))
    ref, gaps = greedy_reference(nodrop.target_params, nodrop.target_cfg,
                                 torch.as_tensor(prompts, device=DEVICE),
                                 ARCH_NEW)
    probes = {}
    toks, runs, _ = _arch_runs("moe grok-1 no-drop", nodrop, prompts,
                               [("kernel", "paged", False)], probes=probes)
    drops = probes[("kernel", "paged")].drops()
    if any(v["dropped"] for v in drops.values()):
        fail(f"moe grok-1 at capacity E/k dropped pairs: {drops}")
    out["grok_fp32_no_drop"] = {
        "capacity_factor": nodrop.target_cfg.moe.capacity_factor,
        "runs": runs, "drops": drops,
        "near_ties": _hold("moe grok-1 no-drop", toks, ref, gaps),
        "min_ref_top2_gap": float(gaps.min())}
    del bundle, nodrop, probes
    _free()
    # bf16, 4 layers: six graph replays profiled (paged)
    b16, _ = arch_bundle("grok-1-314b", "bfloat16", GROK_BF16_LAYERS)
    b16 = pl.with_attn_impl(b16, "kernel")
    _zero_launches()
    prof = profile_loop(b16, prompts, "paged", replay_launches(b16, "paged"))
    counts = _launches()
    _launch_check("moe grok-1 bf16 graph", counts,
                  _want_launches(b16, "paged", sm90=True), 2)
    out["grok_bf16_graph_profile"] = dict(prof, layers=GROK_BF16_LAYERS)
    launches["grok-1-314b"]["bfloat16"] = {"paged": {
        k: v / 2 for k, v in counts.items() if v}}
    del b16
    _free()
    # kimi-k2 in bf16, 1 layer: kernel against gather (paged)
    kimi, _ = arch_bundle("kimi-k2-1t-a32b", "bfloat16", KIMI_LAYERS)
    kp = _arch_prompts(kimi.target_cfg, 22)
    probes = {}
    toks, runs, per_cycle = _arch_runs(
        "moe kimi-k2", kimi, kp, [("kernel", "paged", False),
                                  ("gather", "paged", False)],
        probes=probes)
    kt, gt = toks[("kernel", "paged", "host")], toks[("gather", "paged",
                                                      "host")]
    out["kimi_bf16"] = {
        "layers": KIMI_LAYERS, "runs": runs,
        "agree_with_gather": float((kt == gt).mean()),
        "first_divergence_per_row": bf16_divergences(kimi, kp, kt, gt,
                                                     "paged"),
        "near_tie_ulps": NEAR_TIE_BF16_ULPS,
        "drops": {k[0]: v.drops() for k, v in probes.items()}}
    launches["kimi-k2-1t-a32b"] = {"bfloat16": per_cycle}
    del kimi, probes
    _free()
    emit({"phase": "moe", "ok": True, "gamma": GAMMA, "k": K_BRANCHES,
          "batch": 4, "prompt": ARCH_PROMPT, "max_new": ARCH_NEW,
          "cuts": {"grok-1-314b": f"fp32 {GROK_LAYERS} of 64 layers, bf16 "
                                  f"{GROK_BF16_LAYERS} of 64",
                   "kimi-k2-1t-a32b": f"bf16 {KIMI_LAYERS} of 61 layers"},
          **out, "launches_per_cycle": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def ctx_path():
    """llama-3.2-vision-11b (8 cross layers over 1601 random vision
    tokens) and whisper-medium (24 encoder layers over 1500 random
    frames, then the decoder reading the encoder's output), full size,
    fp32: ``generate(ctx=)`` through the kernel path on paged and dense
    caches and the gather path (paged), held to each other and to plain
    greedy (a prefill with ``ctx``, then one-token steps that read the
    cross caches). Returns launches a cycle by model."""
    from repro_torch.launch.steps import ctx_len_for
    from repro_torch.models import encdec
    from repro_torch.models.blocks import layer_specs
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    recs, launches = {}, {}
    for seed, arch in enumerate(CTX_ARCHS):
        bundle, enc = arch_bundle(arch, "float32")
        cfg = bundle.target_cfg
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(31 + seed)
        feats = torch.randn((4, ctx_len_for(cfg), cfg.d_model),
                            generator=gen, device=DEVICE)
        rec = {"params": cfg.param_count(), "ctx_len": feats.shape[1]}
        if enc is not None:
            torch.cuda.synchronize()
            te = time.perf_counter()
            with torch.no_grad():
                ctx = encdec.encode(enc, feats, cfg)
            torch.cuda.synchronize()
            rec["encode_s"] = time.perf_counter() - te
            if ctx.shape != feats.shape or not torch.isfinite(ctx).all():
                fail(f"ctx {arch}: encoder output {tuple(ctx.shape)}")
        else:
            ctx = feats                       # the image embeddings
        prompts = _arch_prompts(cfg, 40 + seed)
        ref, gaps = greedy_reference(
            bundle.target_params, cfg, torch.as_tensor(prompts,
                                                       device=DEVICE),
            ARCH_NEW, ctx=ctx)
        toks, runs, per_cycle = _arch_runs(
            f"ctx {arch}", bundle, prompts,
            [("kernel", "paged", False), ("kernel", "dense", False),
             ("gather", "paged", False)], ctx=ctx)
        rec.update(runs=runs, near_ties=_hold(f"ctx {arch}", toks, ref,
                                              gaps),
                   min_ref_top2_gap=float(gaps.min()),
                   cross_layers=sum(s.cross for s in layer_specs(cfg)))
        recs[arch] = rec
        launches[arch] = {"float32": per_cycle}
        del bundle, enc, ctx, feats
        _free()
    emit({"phase": "ctx", "ok": True, "dtype": "float32", "batch": 4,
          "prompt": ARCH_PROMPT, "max_new": ARCH_NEW, "models": recs,
          "launches_per_cycle": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def archs_path():
    """qwen2.5-3b, gemma2-2b and stablelm-3b at full size and
    internlm2-20b at full width cut to 16 of 48 layers, fp32, paged: the
    kernel path held to the gather path and plain greedy, launches a
    cycle exact (gemma2-2b: #1 on its 13 local layers' rolling buffers,
    #2 at head_dim 256 on its 13 global layers). Returns launches a
    cycle by model."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    recs, launches = {}, {}
    for seed, (arch, layers) in enumerate(DENSE_ARCHS):
        bundle, _ = arch_bundle(arch, "float32", layers)
        cfg = bundle.target_cfg
        prompts = _arch_prompts(cfg, 50 + seed)
        ref, gaps = greedy_reference(
            bundle.target_params, cfg, torch.as_tensor(prompts,
                                                       device=DEVICE),
            ARCH_NEW)
        toks, runs, per_cycle = _arch_runs(
            f"archs {arch}", bundle, prompts,
            [("kernel", "paged", False), ("gather", "paged", False)])
        recs[arch] = {"layers": cfg.num_layers, "params": cfg.param_count(),
                      "head_dim": cfg.head_dim, "heads": [
                          cfg.num_heads, cfg.num_kv_heads], "runs": runs,
                      "near_ties": _hold(f"archs {arch}", toks, ref, gaps),
                      "min_ref_top2_gap": float(gaps.min())}
        launches[arch] = {"float32": per_cycle}
        del bundle
        _free()
    emit({"phase": "archs", "ok": True, "dtype": "float32", "cache": "paged",
          "batch": 4, "prompt": ARCH_PROMPT, "max_new": ARCH_NEW,
          "cuts": {"internlm2-20b": "16 of 48 layers"}, "models": recs,
          "launches_per_cycle": launches,
          "seconds": time.perf_counter() - t0})
    return launches


def main():
    if len(sys.argv) > 1:
        fail(f"chip_smoke.py takes no arguments: {sys.argv[1:]}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    smi = nvidia_smi_line()

    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.load(stem)
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "libs": [str(p.relative_to(ROOT)) for p in libs.values()],
          "ptxas": {stem: [ln.strip() for ln in build.build_log(stem)
                           .splitlines() if "registers" in ln
                           or "spill" in ln or "Compiling entry" in ln
                           or "Performance" in ln]
                    for stem in libs},
          "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    timer = Timer()
    worst, timing = check_kernels(timer)
    flash_worst, flash_timing = check_flash(timer)
    del timer
    bundle, prompts, launches, fp32_runs = main_path()
    graph_fp32(bundle, prompts, *fp32_runs)
    graph_prof_fp32 = profile_graph(bundle, prompts)
    modes_path(cut_depth(bundle, MODE_LAYERS), prompts)
    sampled_path(cut_depth(bundle, MODE_LAYERS), prompts)
    serve_reqs, _, serve_fp32 = serving_path(cut_depth(bundle, SERVE_LAYERS))
    bundle, ms_cycle, bf16_casc, bf16_per_cycle, eager = bf16_path(
        bundle, prompts)
    profile_cycles(bundle, prompts, ms_cycle)
    graph_bf16(bundle, prompts, eager)
    graph_prof = profile_graph(bundle, prompts)
    modes_bf16(cut_depth(bundle, MODE_LAYERS), prompts)
    serve_bf16 = serving_bf16(cut_depth(bundle, SERVE_LAYERS), serve_reqs)
    del bundle, eager
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    recurrent = {phase: recurrent_path(phase) for phase in RECURRENT}
    serving_recurrent()
    more_archs = {**moe_path(), **ctx_path(), **archs_path()}

    fp32_launches = train_identity()
    run, bf16_launches, ms_step = train_bf16()
    profile_train_step(run, ms_step)
    del run
    torch.cuda.synchronize()

    # cascade rows: one per kernel at its dtype, the decode verify shape,
    # launches of the decode runs in that dtype (the fp32 main path, or the
    # bf16 kernel runs of both caches); flash rows: one per kernel at its dtype, the training shape, launches
    # of the training path in that dtype (the bf16 step, or the kernel
    # side of the fp32 identity run)
    rows = []
    for name, (wrapper, dtype, src, line) in CASCADE_KERNELS.items():
        dn = str(dtype).replace("torch.", "")
        cache = "paged" if "paged" in name else "dense"
        graph = graph_prof_fp32 if dtype == torch.float32 else graph_prof
        extra = ({"launches": launches[name]} if dtype == torch.float32
                 else {"launches": bf16_casc[name],
                       "launches_per_cycle": bf16_per_cycle[name]})
        extra["graph_launches_per_cycle"] = graph[cache][
            "replay_launches_per_cycle"][name]
        # decode cycles of the serving phases: fp32 dense refill (#1) and
        # prefix-cache (#2) runs, bf16 overlapped front-end (#2)
        if dtype == torch.float32:
            run = serve_fp32["dense_refill" if cache == "dense"
                             else "prefix_kernel"]
            extra["serving_launches_per_cycle"] = run[
                "launches_per_cycle"].get(name)
        else:
            extra["serving_launches_per_cycle"] = (
                serve_bf16["overlapped"]["launches_per_cycle"]
                if cache == "paged" else None)
        # the recurrent targets' kernel runs (host loop) in this dtype
        for phase, rec in recurrent.items():
            extra[f"{phase}_launches_per_cycle"] = rec[dn][cache][name]
        # the moe, ctx and archs phases' kernel runs, by model and cache
        extra["archs_launches_per_cycle"] = {
            arch: {c: n[name] for c, n in rec[dn].items() if n.get(name)}
            for arch, rec in more_archs.items()
            if any(n.get(name) for n in rec.get(dn, {}).values())}
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"src/repro/kernels/cascade_attention.py:"
                                 f"{line}",
                     **extra, "max_abs_err": worst[name], "dtype": dn,
                     **_timing_keys(timing[wrapper][dn]),
                     "d256": timing[wrapper][dn + "_d256"]})
    for name, (wrapper, dtype, src, line) in FLASH_KERNELS.items():
        dn = str(dtype).replace("torch.", "")
        counts = bf16_launches if dtype == torch.bfloat16 else fp32_launches
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{line}",
                     "launches": counts[name],
                     "max_abs_err": flash_worst[wrapper][dn], "dtype": dn,
                     **_timing_keys(flash_timing[wrapper][dn])})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

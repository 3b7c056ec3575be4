#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, full width, cut depth

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
           keys), the pos_stride/pos_offset shard contract (and the
           sharded engine's reads: a rank's 32- or 16-slot runs of
           64-key pages at offsets 0-48, Tq 76 and 16), pages of 8 and
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
           two key tiles see no query, D 64 and 96), and at head_dim 256
           (the D 256 instantiations) gemma2-2b's training shape (B 2, Hq
           8, Hkv 4, T 4096, softcap 50, window 4096), recurrentgemma-2b's
           (Hq 10, Hkv 1, window 2048), the ragged case and D 192
           (zero-filled to 256); fp32 (the kernels of
           flash_attention.cu: the forward, dq and dk/dv in 3xTF32 on the
           tensor cores, each also called twice at the training shape and
           at gemma2-2b's and held bitwise equal) and bf16 (the wgmma
           kernels of flash_attention_sm90.cu); then timed at the
           training shape and at gemma2-2b's beside its bound, its plain
           version and scaled_dot_product_attention (forward; its
           autograd backward; at D 256 the backend's kernel named)
  main     greedy D^2SD ``generate`` in fp32 at the full width and depth of
           paper_target.full() with random seeded weights: 4 prompts of 512
           tokens, 64 new tokens, paged (page 64) and dense caches through
           the kernels; tokens held to the gather path and to plain
           one-token-at-a-time greedy; launch counts read: both fp32
           cascade kernels (cascade_phase1.cu), no bf16 one
  oracle   the same fp32 runs (32 new tokens a row: the run's time limit)
           with drafts that hold the greedy reference,
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
  modes    fp32 greedy through ``generate_ondevice`` (kernel path, 16
           new tokens, the main path's model cut to 3 of its 36 layers:
           the run's time limit) in the modes beside d2sd: naive_k, eagle
           (drafter 1 causal), dflash_second (drafter 1 as drafter 2) and
           d2sd with the third level, paged and dense: tokens held to
           plain greedy, cascade launches a cycle held to the mode's count
           (3 dense; paged 5, 33, 7, 9: 3 target layers and 2 a
           drafter pass), the third level's host loop held to its graph
           loop; each mode's paged loop profiled (ms and device ms a
           replay, graph pool bytes, phase-1 launches by name)
  sampled  fp32 d2sd at temperature 1, paged, kernel path, one seed (3
           layers, as modes): the
           graph loop's tokens and every cycle's acceptance uniforms
           held to the host loop's (and no two cycles' uniforms equal),
           the gather path's agreement reported, the graph loop
           profiled; then the lossless check at tiny size through the
           kernels (one cycle over 2000 copies of a prompt: TV of the
           first token against the target's softmax, every mode)
  serving  fp32 ``ServingEngine`` (batch 4, pages of 64, a pool of 160) at
           the main path's model cut to 3 of its 36 layers (the run's
           time limit), gamma 16, K 4: 10 requests behind a
           320-token system prompt (two sharing 352 tokens, one a second
           turn over an earlier answer; ``max_new`` 4-24; the first
           request served before the other nine) through legacy waves,
           dense refill, the paged engine pool, and the pool with the
           prefix cache through the kernels and through the gather path:
           per-request tokens equal across the runs and to plain greedy,
           prefix hits >= 8, COW copies >= 1, legacy row-cycles above
           refill's, the pool's books balanced after each run with every
           page in use the radix tree's, launches through #1 (dense) and
           #2 (paged) from the wrappers, and #2 held to its plain version
           on a live page table with shared pages and sentinel tails
  bf16     the same runs in bfloat16 (the config's dtype), paged and dense,
           24 new tokens a row (the run's time limit):
           tokens/s, agreement with the gather path (where a row first
           leaves it, the top-2 gap of a plain bf16 forward over the shared
           context must be a near tie in bf16 ulps), and at least 40
           (paged: 36 target layers, 2 x 2 drafter layers) or 36 (dense)
           launches a cycle through the bf16 cascade kernels
           (cascade_phase1_sm90.cu) and none through cascade_phase1.cu
  profile  three bf16 decode cycles (kernel path, paged cache) under
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
           (3 layers, as modes), paged, graph loop: ms a replay, decode
           tokens/s, launches through the sm90 kernels, profile
  serving_bf16  the serving requests in bfloat16 (3 layers, as
           serving) as a Poisson trace at 1 request/s through the
           overlapped front end and the synchronous baseline (paged, prefix cache, kernel path, the
           card's own clock): ms a cycle, engine cycles, tokens over the
           replay's wall time (set by the arrivals), TTFT and TPOT p50
           and max; each request's tokens held to a gather run's by the
           bf16 near-tie rule. A smoke reading of the path, not a serving
           metric: ten requests have no tail, and the slots are not kept
           full
  sharded  the serving phase's engine (the same requests, batch 4, pages
           of 64, a pool of 160, prefix cache, fp32, 3 layers, weights
           from the same seeds) spanning a 2-rank kv_seq mesh: two gloo
           ranks spawned on this card (``launch/mesh.py::run_ranks``),
           each holding 32 slots of every page, every verify and drafter
           feature-cache read through kernel #2 on the rank's pool with
           pos_stride 64 and pos_offset 0 / 32, merged by the LSE
           all-reduce; the kernel path and the gather path: tokens equal
           across ranks and held to plain greedy by the serving phase's
           near-tie rule (so to the unsharded engine), kv_shards,
           pool_shard_slots, decode_collective_bytes equal to the byte
           formula, prefix hits, and each rank's #2 launches with a
           pos_stride (the wrapper's exact count) equal a cycle to the
           unsharded engine's #2 launches, none without one, none through
           the bf16 kernels, none on the gather path; ms a cycle beside
           the unsharded engine's, the host time in the merges, bytes a
           cycle, each rank's peak memory. Ranks time-share one card: a
           record, not a multi-card speed
  sharded_bf16  the same in bfloat16 over 4 ranks (16 slots of every
           page, pos_offset up to 48): the kernel path held to the
           gather path inside the mesh by the bf16 near-tie rule, the
           sm90 #2 launches with a pos_stride equal a cycle to the
           unsharded engine's
  data     the same engine with a wave's rows split over a data axis:
           fp32 over a (2, 1) mesh, kv_seq off (each rank 2 of a wave's
           4 rows and its replica of the whole pool, #2 unsharded on
           it; the pool writes gathered into every replica once a cycle
           and once an install, the results of each cycle gathered),
           the kernel and gather paths: tokens equal across ranks and
           held to plain greedy by the near-tie rule, the stats to the
           unsharded engine's, each rank's #2 launches a cycle to the
           unsharded engine's, #2 on the rank's live replica to its
           plain version, the replicas compared at every wave's end
           (the engine's own check); then ``generate`` on a dense cache
           over the same mesh (4 x 512 prompts, 16 new: #1 on each
           rank's 2 rows, launches a cycle held to an unsharded run's,
           tokens to plain greedy); ms a cycle, the write gather's bytes
           and host ms, the results gather's ms, peak memory a rank
  data_bf16  the same in bfloat16 over a (2, 2) mesh (4 ranks: 2 rows
           and 32 slots of every page a rank, #2 with a pos_stride):
           the kernel path held to the gather path by the bf16 near-tie
           rule
  hybrid   recurrentgemma-2b at full width cut to 8 of its 26 layers
           (RG-LRU blocks and 2 MQA sliding-window layers of head_dim
           256, vocab 256000; the cut pays for train_archs), random
           seeded weights, two drafters sized by JAX's
           production_drafter rule, gamma 16, K 4, 32 new tokens for 4
           prompts of 2020-2041 tokens (ragged: every row's rolling local
           buffers wrap): fp32 through the state-replay verifier, the
           kernel path through the host loop (paged) and the graph loop
           (both caches), the gather path through the graph loop (both
           caches); tokens held to plain greedy and to the gather path
           (near ties only), the graph loop's to the host loop's, cascade
           launches a cycle exact (#1 one a local layer: 2; #2 one a
           drafter layer and pass on a paged cache: 4; a graph run counts
           its eager first cycle and its capture); then bf16: six graph
           replays a cache profiled (wall and device ms a replay, idle
           share), the launches of the loop's first cycle and capture
           through the sm90 kernels held exact
  ssm      the same for rwkv6-1.6b (6 of its 24 RWKV-6 layers,
           attention-free, d 2048, vocab 65536) with 4 prompts of 512 and
           16 new tokens: #1 0, #2 4 a paged cycle
  serving_recurrent  fp32 ``ServingEngine`` over the hybrid target (8
           layers, as the hybrid phase), kernel path: the serving phase's
           10 requests through dense refill and the paged engine pool (paged drafter feature
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
  ep       expert parallelism: grok-1-314b in fp32 at the moe phase's
           depth over 2 gloo ranks spawned on the card, each drawing only
           its 4 of the 8 experts from the seeds (the rest of the model
           whole on every rank), kv_seq and experts on the same axis
           (pages of 64: 32 slots a rank); the moe phase's four prompts
           as engine requests of 6 new tokens (one wave, prefix
           cache; the moe phase runs 16: the time limit): the kernel
           and gather paths at capacity factor 1.25 and the kernel path
           at E/k; tokens equal across ranks; on every rank #2's launches
           with a pos_stride a cycle equal to the unsharded count and no
           other cascade launch (none on the gather path), #2 on the
           rank's live pools held to its plain version, the EP layer on
           the kernel run's first verify pass (304 tokens) held to a
           plain fp32 sum of the rank's experts, all-reduced (1e-4 of
           its largest magnitude), the kernel run held to the gather run
           by the near-tie rule and the no-drop run to the moe phase's
           plain greedy; ms a cycle, the EP all-reduces' and the merges'
           host time a cycle, dropped pairs a cycle, peak and expert
           memory a rank
  ep_bf16  the same for kimi-k2-1t-a32b in bf16 at 1 layer over 4 ranks
           (96 of its 384 experts a rank, the shared expert on every
           rank; 16 slots of each page), kernel and gather paths, the EP
           layer held within 16 roundings of bf16 (2^-5 of the largest
           magnitude); each request's first divergence of the kernel run
           from the gather run reported with its gap in bf16 ulps, not
           held (they part on gaps wider than the near-tie rule's); the
           same pair with the kv_seq axis off (pools replicated, reads
           through the unsharded #2: launches held to the same count a
           cycle, none with a pos_stride), its divergences reported beside
           them
  ctx      llama-3.2-vision-11b cut to 20 of its 40 layers (4 cross
           layers over 1601 random vision tokens) and whisper-medium (24
           encoder layers over 1500 random frames, then 12 of its 24
           decoder layers over the encoder's output) at full width in
           fp32 (the cuts pay for study and distill_full) through ``generate(ctx=)``: the kernel path on
           paged and dense caches and the gather path, tokens held to
           each other and to plain greedy (a prefill with the context,
           then one-token steps that read the cross caches)
  archs    qwen2.5-3b, gemma2-2b, stablelm-3b and internlm2-20b at
           full width cut to 18 of 36, 13 of 26, 16 of 32 and 8 of 48
           layers (the run's time limit), fp32, paged: the kernel path held to the gather path and plain
           greedy. Each of these three phases: 4 prompts of 512, 8 new
           tokens, random seeded weights, drafters by JAX's
           production_drafter rule, exact cascade launches a host cycle
  train_fp32   paper_target.full() cut to 4 layers (the only cut; 2.02e9
           params, AdamW as optimizer_for picks), remat on, batch 2 x 4096
           tokens of the mixture stream: three steps through the fp32 flash
           kernels and three through the plain chunked attention, from the
           same seeded weights and batches; loss and grad norm per step
           and the params after step 3 held to each other
  train_bf16   the same model in bf16: three steps through the plain
           chunked attention, then through the kernels one warm-up and
           five timed steps; the first three losses held to the plain
           path's, ms/step, tokens/s, peak memory, and 8 / 4 / 4 launches
           per step of the tensor-core forward / dq / dk-dv kernels
           (flash_fwd_sm90, flash_bwd_dq_sm90, flash_bwd_dkv_sm90) and
           none of the fp32 ones
  train_profile  one bf16 step under torch.profiler: device time, idle
           share, top kernels
  train_archs  training at head_dim 256 and through the recurrent
           layers, full width, batch 2 x 4096, the cross entropy in
           chunks of 512 (``make_train_step(loss_seq_chunk=)``):
           gemma2-2b cut to 2 of 26 layers and recurrentgemma-2b to 3
           (its RG-LRU layers through the associative scan) in fp32,
           three
           kernel steps against three plain ones, held as train_fp32
           holds them; both at 6 of 26 layers in bf16 (these depths pay
           for the mesh phases' time), three
           plain steps then a warm-up and three timed kernel steps, the
           first three losses held to the plain path's, ms a step,
           tokens/s, peak memory and one step profiled; flash launches a
           step exact (remat: 2 / 1 / 1 an attention layer, so 12 / 6 /
           6 for gemma2-2b and 4 / 2 / 2 for recurrentgemma-2b in
           bf16); rwkv6-1.6b cut to 1 of 24 layers in
           bf16 at batch 2 x 1024: finite losses that fall over four
           steps, ms a step, no flash launch
  mesh_train  training on a (data 2, model 2) mesh with FSDP: 4 gloo
           ranks on this card, paper_target.full() cut to 2 of 36
           layers (remat), fp32, AdamW, batch 4 x 1024 (2 rows a data
           rank, each row's mask cut at 1024, 1024, 700 and 300 tokens:
           the data ranks' counts differ), the cross entropy in chunks
           of 512; a rank stores its slices by JAX's parameter rules,
           runs its 16 of the 32 query heads and the 4 KV heads they
           read through the flash kernels, its 512 of the 1024 tokens
           between blocks (sequence parallelism), its vocab columns of
           the head (vocab-parallel cross entropy), and gathers its FSDP
           leaves at use; held to the unsharded kernel step run first
           on the same weights and batches: the loss and grad norm of
           three steps, every leaf of step 1's gradient (each rank's
           shard against the unsharded gradient's slice) and the params
           after step 3; flash launches a step a rank exact (4 / 2 / 2)
           at (Hq, Hkv) (16, 4); ms a step, the collectives' calls and
           MB a step, peak memory a rank
  mesh_train_bf16  the same mesh and model in bf16: a warm-up and two
           timed steps (ms a step, the median; tokens/s), each
           collective timed on the host after a synchronize (host ms and
           MB a step of the gathers, reduce-scatters and all-reduces),
           peak memory a rank, sm90 flash launches a step exact, the
           losses beside the unsharded bf16 step's (readings: ranks
           time-share one card). The step's collectives between ranks on
           one card exchange on the card through CUDA IPC
           (``distributed/device_exchange.py``), gloo carrying only the
           barriers
  pipeline GPipe over a pod axis of 2 (ranks 0 and 1 of the same spawn):
           one full-width paper-target block a stage, 4 microbatches of
           1 x 512, stateless through the fp32 flash forward: every
           rank's result held to sequential application of both blocks
           (1e-5 of the largest magnitude), 5 #3 launches a rank (M + S
           - 1, JAX's schedule)
  mesh_optimizers  the mesh_train cell with adamw8bit and with Adafactor
           (one more spawn of 4 ranks): three fp32 steps held to the
           unsharded step with the same optimizer (loss, grad norm, the
           params after; every moment leaf against the rank's slice of
           the unsharded state: int8 moments within a quantum a step,
           under 1 % of them differing at all, a block's scale within a
           quantum of its own a step, Adafactor's statistics within 1e-4
           of their leaf's largest); state bytes a rank beside AdamW's;
           bf16 ms a step a rank
  dryrun   the multi-device dry run (``launch/dryrun.py``): the mesh
           cell of each optimizer traced on the meta device for each
           rank of a shape-only (2, 2) mesh (on a thread while the ranks
           run) and held to the ranks' real fp32 step: storage bytes of
           the params and the optimizer state and the collectives a step
           by kind exactly equal, the flash stand-ins' calls equal to
           the launches a step, the peak estimate beside the peak
           allocated; and the launcher, started niced as the mesh phases
           begin, on qwen2.5-3b's train_4k (16x16 and 2x16x16) and
           decode_32k (16x16): each ok, its FLOPs, collective bytes,
           argument bytes, peak estimate and roofline terms a rank
           (modelled at the H100 SXM's peaks)
  study    the empirical study at its own size: ``run_study.main`` at
           its defaults but the steps (paper_target.smoke() in fp32
           pretrained 120 steps, 48 greedy rollouts a task of 32 + 160
           tokens, the DFlash, VP and AR drafters (drafter_small, D 48)
           150 steps each at batch 24: these steps, below run_study's
           defaults of 240 and 400, pay for the run's time limit): every
           loss falls (mean of the last tenth
           below the first tenth's), flash launches exact (4 forward, dq
           and dk/dv a pretrain step, 4 forward a teacher pass); then
           ``load_study`` and the held-out decode of
           benchmarks/common.py::measure (8 prompts of 48 tokens a task
           from seed 777 at offset 5e6, 24 new tokens) in d2sd, dflash,
           eagle, naive_k and dflash_second, the kernel path on the paged
           cache (and for d2sd the dense one: the run's time limit) and
           the gather path (host loop): tokens held to
           plain greedy and to the gather run, cascade launches a cycle
           exact, alpha by method and task; d2sd with seeded random
           drafters beside it: the trained drafters' alpha must be above
           1.0 and above the random ones' on every task; seconds of each
           stage
  distill_full  paper_target.full() cut to 6 of 36 layers (the run's
           time limit) in bf16, random seeded weights: 16 greedy
           rollouts of 128 + 128 tokens, then d1 (DFlash) and d2 (VP)
           for ``production_drafter`` (d 1024, 8 heads over 2, vocab
           151936, features 3 x 4096) distilled 60 steps each at batch
           16, the teacher through the bf16 flash forward (6 launches a
           step, exact): falling losses, ms a step, peak memory; then d2sd
           through the bf16 graph loop (paged, 4 prompts of 128, 64 new)
           with the trained and with random drafters: alpha, ms a
           replay, decode tokens/s, launches of the eager cycle and the
           capture exact, the kernel path held to the gather path by the
           bf16 near-tie rule

Then a ``{"kernels": [...]}`` line (each flash row with a ``d256`` entry:
gemma2-2b's shape, the launches a step of train_archs; and a rank's
launches a step of the mesh phases and of the pipeline), the card's name
and power limit as
nvidia-smi prints them, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` next to this file, it exits non-zero and
prints no result. It takes no arguments.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
DEVICE = "cuda"
MAX_NEW = 64                                # tokens generated per row
ORACLE_NEW = 32     # a row's tokens with the oracle's drafts (time limit)
BF16_NEW = 24       # a row's tokens in the bf16 phases at 36 layers (time;
                    # 32 before the dryrun phases)
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
TRAIN_LAYERS = 4    # paper-target cut in depth only (the run's time
                    # limit): 2.02e9 params
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
# gemma2-2b's attention options (its local layers; at T 4096 the window of
# 4096 masks nothing the causal mask keeps, as on its global layers)
GEMMA_FLASH_KW = dict(causal=True, attn_softcap=50.0, window=4096)


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
    zero-filled to 128, in the [B,T,H,D] layout), and at head_dim 256
    gemma2-2b's and recurrentgemma-2b's training shapes (B 2, T 4096;
    GQA 8/4 with softcap 50 and window 4096; MQA 10/1 with window 2048),
    the ragged case and D 192 (zero-filled to 256), fp32 and bf16. Each
    backward kernel takes the plain forward's (o, lse), so each kernel is
    held alone. o, lse and dq are compared over rows with a live key.
    The fp32 kernels are also called a second time at the training shape
    and at gemma2-2b's, and must give bitwise the same o, lse, dq, dk and
    dv (no atomics: the fp32 training step is deterministic)."""
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
                   kw=dict(causal=False, kv_len=[129, 70])),
              # head_dim 256, the D 256 instantiations: gemma2-2b's
              # training shape (GQA 8/4, softcap 50, window 4096, the
              # fp32 kernels called twice as at D 128), recurrentgemma-
              # 2b's (MQA 10/1, window 2048), the ragged case, and D 192
              # zero-filled to 256
              dict(b=TRAIN_B, hq=8, hkv=4, tq=TRAIN_T, tkv=TRAIN_T, d=256,
                   bthd=True, kw=GEMMA_FLASH_KW),
              dict(b=TRAIN_B, hq=10, hkv=1, tq=TRAIN_T, tkv=TRAIN_T, d=256,
                   bthd=True, kw=dict(causal=True, window=2048)),
              dict(b=2, hq=8, hkv=4, tq=1000, tkv=1000, d=256, bthd=True,
                   kw=ragged),
              dict(b=2, hq=8, hkv=2, tq=129, tkv=129, d=192, bthd=True,
                   kw=dict(causal=True))]
    repeat = {0: "d128", 9: "d256"}       # fp32 cases called twice
    same = {}
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
            tag = repeat.get(shapes.index(sh))
            if dtype == torch.float32 and tag:
                same[tag] = {
                    "o_lse": all(map(torch.equal, (o_k, lse_k),
                                     fa.flash_attention_fwd(q, k, v, **kw))),
                    "dq": torch.equal(
                        dq_k, fa.flash_attention_bwd_dq(*args, **kw)),
                    "dk_dv": all(map(torch.equal, (dk_k, dv_k),
                                     fa.flash_attention_bwd_dkv(
                                         *args, **kw)))}
                if not all(same[tag].values()):
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


def library_kernel(fn):
    """The name of the kernel that takes the most device time in one call
    of ``fn`` (torch.profiler), or None if the trace holds none: which
    backend scaled_dot_product_attention picked."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    return rows[0][0][:120] if rows else None


def time_flash(timer, gen):
    """Each flash kernel at the training shapes in the model's layout:
    paper-target's (B 2, Hq 32, Hkv 8, T 4096, D 128, causal) and, as
    ``<dtype>_d256``, gemma2-2b's (Hq 8, Hkv 4, D 256, softcap 50, window
    4096, with device ms): its time, its plain version's, one
    scaled_dot_product_attention call (forward for #3; its autograd
    backward for #4 and #5 together; causal with no softcap, which it
    lacks; at D 256 the backend it picked, by kernel name) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for tag, hq, hkv, d, kw in (("", 32, 8, 128, {}),
                                ("_d256", 8, 4, 256, GEMMA_FLASH_KW)):
        b, t = TRAIN_B, TRAIN_T
        pairs = live_pairs(t, t, 0, kw.get("window"), [t] * b)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).replace("torch.", "")
            q, k, v, do = _flash_inputs(gen, b, hq, hkv, t, t, d, dtype,
                                        True)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            bw = (q, k, v, do, lse, delta)
            ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
            lib_o = F.scaled_dot_product_attention(ql, kl, vl,
                                                   is_causal=True,
                                                   enable_gqa=True)
            entries = {
                "flash_attention_fwd": (
                    lambda: fa.flash_attention_fwd(q, k, v, **kw),
                    lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)),
                "flash_attention_bwd_dq": (
                    lambda: fa.flash_attention_bwd_dq(*bw, **kw),
                    lambda: fa.flash_attention_bwd_dq_plain(*bw, **kw),
                    lambda: torch.autograd.grad(lib_o, (ql, kl, vl), do,
                                                retain_graph=True)),
                "flash_attention_bwd_dkv": (
                    lambda: fa.flash_attention_bwd_dkv(*bw, **kw),
                    lambda: fa.flash_attention_bwd_dkv_plain(*bw, **kw),
                    None)}
            lib_bwd = None
            for name, (kern, plain, lib) in entries.items():
                bound, by = _flash_bound(name, dtype, b, hq, hkv, t, t, d,
                                         pairs)
                if lib is not None:
                    lib_ms = lib_bwd = timer.ms(lib, warmup=2)
                    lib_name = library_kernel(lib) if tag else None
                else:
                    lib_ms = lib_bwd   # one backward call gives dq, dk, dv
                extra = ({"library_kernel": lib_name,
                          "device_ms": device_ms(kern)} if tag else {})
                out.setdefault(name, {})[dn + tag] = {
                    "ms": timer.ms(kern, warmup=2), **extra,
                    "plain_ms": timer.ms(plain, warmup=2),
                    "library_ms": lib_ms, "bound_ms": bound,
                    "bound_by": by,
                    "shape": {"B": b, "Hq": hq, "Hkv": hkv, "T": t, "D": d,
                              "causal": True, **kw,
                              "live_pairs_per_q_head": pairs}}
            del lib_o, ql, kl, vl, q, k, v, do, o, lse, delta, bw
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


def build_bundle(dtype, layers=None):
    """paper-target at full width and depth (or cut to ``layers``: the
    same weights as ``cut_depth`` of the full bundle, since ``lm_init``
    draws the embedding and head before the layers, in order) and two
    2-layer drafters at its widths, random weights from seeds 0, 1, 2."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.configs import paper_target
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import DrafterConfig, drafter_init
    from repro_torch.models import lm
    tcfg = dataclasses.replace(paper_target.full(), dtype=dtype)
    if layers is not None:
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
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
        ot, info = run_generate(ob, prompts, "kernel", cache, ondevice=True,
                                max_new=ORACLE_NEW)
        count = oracle.read()
        info["oracle_alpha"] = count["committed"] / count["row_cycles"]
        info["branch_paths"] = count["branch_paths"]
        runs.append(info)
        ties[f"graph oracle/{cache} vs greedy"] = agreement(
            "graph oracle", ot, ref_toks[:, :ORACLE_NEW], gaps)
        if exact and info["alpha"] != info["oracle_alpha"]:
            fail(f"graph oracle {cache}: alpha {info['alpha']} but the "
                 f"drafts must give {info['oracle_alpha']}")
        if info["oracle_alpha"] < 2 or count["branch_paths"] == 0:
            fail(f"graph oracle {cache}: drafts too weak: {info}")
        info["cache_rel_err"] = committed_cache_error(
            pl.with_attn_impl(ob, "kernel"),
            torch.as_tensor(prompts, device=DEVICE), seq, cache,
            max_new=ORACLE_NEW, ondevice=True)
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
MODE_NEW = 16           # tokens a row in the modes and sampled phases
MODE_LAYERS = 3         # paper-target cut in depth for them (time limit)
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
    cascade launches of a cycle held to ``replay_launches`` (at 6
    layers: 6 dense; paged 8 naive_k, 10 dflash_second, 12
    third_level, 36 eagle), the third level's host loop (``generate``)
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
                toks[(impl, cache)], info = run_generate(
                    ob, prompts, impl, cache, max_new=ORACLE_NEW)
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
                    pl.with_attn_impl(ob, impl), prompts_t, seq, cache,
                    max_new=ORACLE_NEW)
                if info["cache_rel_err"] > TOL_CACHE:
                    fail(f"oracle {level} {impl}/{cache}: committed caches "
                         f"differ from a prefill of the same tokens: {info}")
            if impl == "kernel":
                launches[level] = _launches()
                _check_fp32_launches(launches[level], f"oracle {level}")
        ties.update({f"{level} {k}": v for k, v in _check_runs(
            toks, ref_toks[:, :ORACLE_NEW], gaps).items()})
    emit({"phase": "oracle", "ok": True, "dtype": "float32",
          "max_new": ORACLE_NEW, "alpha_checked": bool(exact),
          "tol_cache": TOL_CACHE,
          "runs": runs, "launches": launches, "near_ties": ties})


def cast_bf16_(tree):
    """Each weight of a param tree replaced by its bf16 copy inside its
    dict or list, so the fp32 copy is freed as it goes."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            cast_bf16_(v)
        else:
            tree[k] = v.to(torch.bfloat16)


def to_bf16(bundle):
    """``bundle`` in bfloat16 (:func:`cast_bf16_` on each param tree)."""
    for params in (bundle.target_params, bundle.d1_params, bundle.d2_params):
        cast_bf16_(params)
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
        kt, kinfo = run_generate(b16, prompts, "kernel", cache,
                                 max_new=BF16_NEW)
        counts = _launches()
        gt, ginfo = run_generate(b16, prompts, "gather", cache,
                                 max_new=BF16_NEW)
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
    emit({"phase": "bf16", "ok": True, "max_new": BF16_NEW, "runs": runs,
          "tokens_per_s": kinfo["tokens_per_s"],
          "decode_tokens_per_s": kinfo["decode_tokens_per_s"],
          "ms_per_cycle": kinfo["ms_per_cycle"],
          "agree_with_gather": agree, "first_divergence_per_row": first,
          "near_tie_ulps": NEAR_TIE_BF16_ULPS,
          "launches": launches, "launches_per_cycle": per_cycle})
    return b16, kinfo["ms_per_cycle"], launches, per_cycle, eager


def bf16_divergences(bundle, prompts, kt, gt, cache, gate=True):
    """Where each row of the bf16 kernel run first leaves the gather run,
    the top-2 gap of a plain bf16 forward over the context the two runs
    share (the prompt and the tokens before it), in bf16 ulps of the top
    logit. A divergence passes only on a gap below NEAR_TIE_BF16_ULPS.
    Each record also says how far one verify step over that context moves
    the same gap when the read path changes (``step_shift_ulps``).
    ``gate=False``: the records only (the caller holds them)."""
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
        if gate and rec["ulps"] >= NEAR_TIE_BF16_ULPS:
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
                                ondevice=True, max_new=BF16_NEW)
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


def profile_cycles(bundle, prompts, ms_per_cycle, n_cycles=3):
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


def _check_flash_launches(launches, n_steps, sm90, n_attn=TRAIN_LAYERS,
                          where="train"):
    """Per step, two forward launches an attention layer (remat runs it
    twice), one dq and one dk/dv, each through the kernel of the step's
    dtype, and none through the other dtype's."""
    sfx = "_sm90" if sm90 else ""
    want = {f"flash_fwd{sfx}": 2 * n_attn,
            f"flash_bwd_dq{sfx}": n_attn,
            f"flash_bwd_dkv{sfx}": n_attn}
    per_step = {k: v / n_steps for k, v in launches.items() if v}
    if per_step != want:
        fail(f"{where}: flash launches per step {per_step}, expected {want}")
    return per_step


def train_cfg(dtype):
    """paper-target at full width, cut to TRAIN_LAYERS layers, remat on."""
    from repro_torch.configs import paper_target
    return dataclasses.replace(paper_target.full(), num_layers=TRAIN_LAYERS,
                               remat=True, dtype=dtype)


def _start_training(cfg, impl, loss_seq_chunk=None, hp=None, seq=TRAIN_T):
    """Seeded weights, the step (with the optimizer ``optimizer_for``
    picks unless ``hp`` is given), its state and the mixture data stream,
    all from seed 0."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.steps import make_train_step, optimizer_for
    from repro_torch.models import api
    if optimizer_for(cfg).name != "adamw":
        fail(f"optimizer_for picks {optimizer_for(cfg).name} at "
             f"{cfg.param_count():.3g} params, not adamw")
    params = api.init_model(cfg, seed=0, device=DEVICE)
    step, opt_init = make_train_step(cfg, loss_seq_chunk=loss_seq_chunk,
                                     hp=hp, attn_impl=impl, device=DEVICE)
    return (params, opt_init(params), step,
            SyntheticDataset("mixture", TRAIN_B, seq, seed=0))


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


def _identity(cfg, n_attn, loss_seq_chunk=None, where="train_fp32"):
    """fp32: three steps through the flash kernels and three through the
    plain path (``attn_impl="auto"``: chunked attention), from the same
    seeded weights and batches; loss and grad norm per step and the
    params after step 3 held to each other. Returns the result and the
    kernel run's flash launches (gated: ``n_attn`` attention layers)."""
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import lr_schedule
    runs, host = {}, {}
    for impl in ("kernel", "auto"):
        params, state, step, ds = _start_training(cfg, impl, loss_seq_chunk)
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
            per_step = _check_flash_launches(launches, 3, False, n_attn,
                                             where)
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
        gc.collect()
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
    out = {"layers": cfg.num_layers, "params": cfg.param_count(),
           "batch": TRAIN_B, "seq": TRAIN_T,
           "loss_seq_chunk": loss_seq_chunk, "optimizer": hp.name,
           "runs": runs, "loss_rel_err": loss_rel,
           "grad_norm_rel_err": gn_rel, "param_max_abs_diff": diff_max,
           "param_mean_abs_diff": diff_sum / n,
           "param_mean_abs_move": move_sum / n,
           "param_rel_err": param_rel, "param_sign_bound": sign_bound,
           "launches": launches, "launches_per_step": per_step,
           "tol": {"loss": TOL_TRAIN_LOSS, "grad_norm": TOL_TRAIN_GNORM,
                   "param": TOL_TRAIN_PARAM}}
    if loss_rel > TOL_TRAIN_LOSS or gn_rel > TOL_TRAIN_GNORM or \
            param_rel > TOL_TRAIN_PARAM or diff_max > sign_bound:
        fail(f"{where}: the kernel path disagrees with the plain path: "
             f"{out}")
    return out, launches


def train_identity():
    """fp32 identity of ``train_cfg``'s paper-target (:func:`_identity`)."""
    cfg = train_cfg("float32")
    out, launches = _identity(cfg, TRAIN_LAYERS)
    emit({"phase": "train_fp32", **out, "ok": True})
    return launches


def _bf16_run(cfg, n_attn, n_timed, loss_seq_chunk=None, where="train_bf16"):
    """bf16 (the config's dtype): three steps through the plain chunked
    attention, freed, then through the kernels one warm-up step and
    ``n_timed`` timed ones from the same seeded weights and batches; the
    kernel run's first three losses are held to the plain run's, and the
    flash launch counts are zeroed just before the kernel run and read
    just after (gated: ``n_attn`` attention layers). Returns the result,
    what a profile continues from, the launches and ms a step."""
    params, state, step, ds = _start_training(cfg, "chunked", loss_seq_chunk)
    _, _, plain_losses, _, plain_s = _run_steps(params, state, step, ds, 3)
    del params, state, step, ds
    gc.collect()
    torch.cuda.empty_cache()
    params, state, step, ds = _start_training(cfg, "kernel", loss_seq_chunk)
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_launches()
    params, state, warm_losses, _, warm_s = _run_steps(params, state, step,
                                                       ds, 1)
    params, state, losses, gnorms, secs = _run_steps(params, state, step, ds,
                                                     n_timed)
    launches = _flash_launches()
    per_step = _check_flash_launches(launches, 1 + n_timed, True, n_attn,
                                     where)
    ms = 1e3 * secs / n_timed
    kernel_losses = warm_losses + losses
    loss_rel = max(abs(x - y) / abs(y)
                   for x, y in zip(kernel_losses[:3], plain_losses))
    out = {"layers": cfg.num_layers, "params": cfg.param_count(),
           "batch": TRAIN_B, "seq": TRAIN_T,
           "loss_seq_chunk": loss_seq_chunk, "warmup_s": warm_s,
           "ms_per_step": ms,
           "tokens_per_s": TRAIN_B * TRAIN_T * n_timed / secs,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "losses": kernel_losses, "grad_norms": gnorms,
           "plain_losses": plain_losses, "plain_s_per_step": plain_s / 3,
           "loss_rel_err": loss_rel, "tol_loss": TOL_TRAIN_BF16_LOSS,
           "launches": launches, "launches_per_step": per_step}
    if loss_rel > TOL_TRAIN_BF16_LOSS:
        fail(f"{where}: bf16 kernel losses disagree with the plain path: "
             f"{out}")
    return out, (params, state, step, ds), launches, ms


def train_bf16(n_timed=5):
    """bf16 ``train_cfg`` paper-target (:func:`_bf16_run`). Returns what
    the profile phase continues from."""
    out, run, launches, ms = _bf16_run(train_cfg("bfloat16"), TRAIN_LAYERS,
                                       n_timed)
    emit({"phase": "train_bf16", **out, "ok": True})
    return run, launches, ms


def _profile_step(run, ms_per_step, n_top=16):
    """One training step under torch.profiler: device time, the idle
    share against the unprofiled step time, the flash kernels' device ms
    and the top kernels by device time."""
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
    return {"steps": 1, "device_ms_per_step": busy,
            "unprofiled_ms_per_step": ms_per_step,
            "idle_share": busy and 1.0 - busy / ms_per_step,
            "flash_kernels_ms": flash,
            "top": [{"name": k[:90], "ms": ms, "calls": c}
                    for k, ms, c in rows[:n_top]]}


def profile_train_step(run, ms_per_step):
    """One bf16 training step under torch.profiler (:func:`_profile_step`)."""
    emit({"phase": "train_profile", "ok": True, "dtype": "bfloat16",
          **_profile_step(run, ms_per_step)})


# arch -> (layers of the fp32 identity run, of the bf16 run): full width;
# the fp32 identity (three kernel and three plain steps, fp32 AdamW state)
# at a depth that keeps both runs short (a local and a global layer; two
# RG-LRU layers and a local one), the bf16 run at 6 of 26 layers (once 4,
# 6 and full depth: cut for the mesh phases' time)
TRAIN_ARCHS = {"gemma2-2b": (2, 6), "recurrentgemma-2b": (3, 6)}
# arch, layers, sequence length: T 1024, since a four-layer step at T 4096
# takes 18.2 s on an H100 (the time-mix scan is a host-bound loop of T
# steps a layer); 1 layer (4, then 2: cut for the mesh and dryrun phases'
# time)
RWKV_TRAIN = ("rwkv6-1.6b", 1, 1024)
LOSS_SEQ_CHUNK = 512                      # the cross entropy's chunks
TRAIN_ARCH_TIMED = 3                      # bf16 steps timed after a warm-up


def arch_train_cfg(arch, layers, dtype):
    """``arch`` at full width, cut to ``layers`` layers, remat on."""
    from repro_torch.config.registry import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               remat=True, dtype=dtype)


def _n_attn(cfg):
    return sum(k in ("global", "local") for k in cfg.pattern_for_depth())


def train_archs():
    """Training at head_dim 256 and through the recurrent layers, all
    with the cross entropy in ``LOSS_SEQ_CHUNK`` chunks: for gemma2-2b
    and recurrentgemma-2b the fp32 identity (:func:`_identity`) at the
    depth ``TRAIN_ARCHS`` gives, then the bf16 run (:func:`_bf16_run`) at
    its bf16 depth with one step profiled; rwkv6-1.6b (no attention) in bf16
    cut to ``RWKV_TRAIN``'s depth: finite losses that fall over a warm-up
    and three timed steps (AdamW at lr 1e-3 after one warm-up step, as
    the launcher schedules it). Flash launches gated exact in each run.
    Returns the flash launches a step by arch and dtype."""
    from repro_torch.config.base import OptimizerConfig
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    out, per_step = {}, {}
    for arch, (l32, l16) in TRAIN_ARCHS.items():
        cfg = arch_train_cfg(arch, l32, "float32")
        fp32, _ = _identity(cfg, _n_attn(cfg), LOSS_SEQ_CHUNK,
                            f"train_archs {arch} fp32")
        cfg = arch_train_cfg(arch, l16, "bfloat16")
        bf16, run, _, ms = _bf16_run(cfg, _n_attn(cfg), TRAIN_ARCH_TIMED,
                                     LOSS_SEQ_CHUNK,
                                     f"train_archs {arch} bf16")
        bf16["profile"] = _profile_step(run, ms, n_top=10)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = {"float32": fp32, "bfloat16": bf16}
        per_step[arch] = {"float32": fp32["launches_per_step"],
                          "bfloat16": bf16["launches_per_step"]}
    arch, layers, seq = RWKV_TRAIN
    cfg = arch_train_cfg(arch, layers, "bfloat16")
    hp = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=1,
                         total_steps=100)
    params, state, step, ds = _start_training(cfg, "kernel", LOSS_SEQ_CHUNK,
                                              hp=hp, seq=seq)
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_launches()
    params, state, warm, _, warm_s = _run_steps(params, state, step, ds, 1)
    params, state, losses, gnorms, secs = _run_steps(params, state, step, ds,
                                                     TRAIN_ARCH_TIMED)
    if any(_flash_launches().values()):
        fail(f"train_archs {arch}: flash launches {_flash_launches()}")
    losses = warm + losses
    if not losses[-1] < losses[0]:
        fail(f"train_archs {arch}: losses do not fall: {losses}")
    out[arch] = {"bfloat16": {
        "layers": layers, "params": cfg.param_count(), "batch": TRAIN_B,
        "seq": seq, "loss_seq_chunk": LOSS_SEQ_CHUNK, "lr": hp.lr,
        "warmup_s": warm_s, "ms_per_step": 1e3 * secs / TRAIN_ARCH_TIMED,
        "tokens_per_s": TRAIN_B * seq * TRAIN_ARCH_TIMED / secs,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "grad_norms": gnorms}}
    del params, state, step, ds
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_archs", "ok": True, **out,
          "seconds": time.perf_counter() - t0})
    return per_step


# ---------------------------------------------------- training on the mesh --
# paper-target at full width cut to MESH_LAYERS layers (remat) on a (data
# 2, model 2) mesh with FSDP, 4 gloo ranks on this card; batch 4 x 1024
# (2 rows a data rank), the cross entropy in chunks of MESH_CHUNK; each
# row's mask cut at MESH_ROWS tokens, so the data ranks' counts differ
MESH_SHAPE = (2, 2)
MESH_LAYERS = 2
MESH_B, MESH_T, MESH_CHUNK = 4, 1024, 512
MESH_ROWS = (1024, 1024, 700, 300)
MESH_STEPS = 3                 # fp32 steps held to the unsharded ones
MESH_BF16_TIMED = 2            # bf16 steps timed after a warm-up
TOL_MESH_GRAD = 1e-4    # fp32 step-1 gradient, each leaf's max |diff| over
                        # its largest magnitude: sums in other orders (the
                        # ranks' partial products, gloo's host sums)
#: production cells the dryrun phase runs through the launcher
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", "single"),
                ("qwen2.5-3b", "train_4k", "multi"),
                ("qwen2.5-3b", "decode_32k", "single"))
DRYRUN_TIMEOUT = 300           # s a launcher cell may take
#: the dryrun phase's small serving cell: a decode cycle of the mesh
#: phases' target (bf16) with its production drafters, this many rows and
#: prompt tokens (dense caches of 1280 slots, 640 a rank), JAX's serving
#: rules on the (2, 2) mesh
DRYRUN_SERVE_B, DRYRUN_SERVE_T = 4, 256
#: the sharded optimizers held to their unsharded steps (ROADMAP item 10c)
MESH_OPTS = ("adamw8bit", "adafactor")
TOL_MESH_MOMENT = 1e-4  # Adafactor's statistics after MESH_STEPS: each
                        # leaf's max |diff| over its largest magnitude;
                        # they are running means of the gradient's square,
                        # whose shards the gradient gate holds to
                        # TOL_MESH_GRAD
# adamw8bit's int8 moments: gradients that agree to the last bits land an
# element near a rounding boundary on either side, and the next steps
# carry that quantum (dequantized) and may move its block's maximum; so
# after MESH_STEPS steps an int8 entry may differ by one quantum a step,
# a block's scale (its maximum over 127) by one quantum of its own a
# step, MESH_STEPS / 127 relative; and the share of entries that differ
# at all stays small (a misplaced block would scramble most of them)
TOL_Q_SHARE = 1e-2
PIPE_M, PIPE_T = 4, 512        # microbatches of 1 x 512 through 2 stages
TOL_PIPE = 1e-5         # pipeline vs sequential, relative to the largest
                        # magnitude (the same kernels on the same inputs)


def mesh_train_cfg(dtype):
    """paper-target at full width, cut to MESH_LAYERS layers, remat on."""
    from repro_torch.configs import paper_target
    return dataclasses.replace(paper_target.full(), num_layers=MESH_LAYERS,
                               remat=True, dtype=dtype)


def mesh_batches(n):
    """``n`` batches of the mixture stream (seed 0), each row's mask cut
    at its ``MESH_ROWS`` length."""
    from repro_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset("mixture", MESH_B, MESH_T, seed=0)
    out = []
    for _ in range(n):
        b = ds.next_batch()
        for i, n_tok in enumerate(MESH_ROWS):
            b["mask"][i, n_tok:] = 0.0
        out.append(b)
    return out


def _first_step(cfg, params, batch, grad_hook=None):
    """Step 1 of ``make_train_step`` taken in its two parts, so that its
    gradient can be read: ``make_grad_fn`` (loss and gradient, on the
    mesh the rank's summed shards), ``grad_hook(grads, plan)`` on it,
    then the optimizer's update (``shards`` on the mesh). Returns
    (params, state, step, loss, grad norm, seconds)."""
    from repro_torch.launch.steps import (make_grad_fn, make_train_step,
                                          optimizer_for)
    from repro_torch.optim import optimizers as opt_lib
    gf = make_grad_fn(cfg, loss_seq_chunk=MESH_CHUNK, device=DEVICE)
    step, init = make_train_step(cfg, loss_seq_chunk=MESH_CHUNK,
                                 device=DEVICE)
    state = init(params)
    update = opt_lib.make_optimizer(optimizer_for(cfg), cfg)[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, plan = gf(params, batch)
    if grad_hook is not None:
        grad_hook(grads, plan)
    params, state, m = update(grads, state, params, shards=None
                              if plan is None else plan.leaves)
    gnorm = float(m["grad_norm"])
    torch.cuda.synchronize()
    return params, state, step, float(loss), gnorm, time.perf_counter() - t0


def _mesh_unsharded():
    """The unsharded kernel steps the mesh phases are held to: fp32 from
    seed 0 (step 1's gradient, then MESH_STEPS steps: losses, grad norms,
    the params after), bf16 (the losses of 1 + MESH_BF16_TIMED steps).
    The seed-0 params (both phases' start: a bf16 model keeps fp32
    params) and the fp32 trees stay on the card: the ranks map them."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.models import param as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mesh_train_cfg("float32")
    batches = mesh_batches(MESH_STEPS)
    params = api.init_model(cfg, seed=0, device=DEVICE)
    init = pm.tree_map(torch.clone, params)
    kept = {}

    def keep(grads, _):
        kept.update({k: g.clone() for k, g in pm.flatten(grads).items()})

    params, state, step, loss1, gn1, s1 = _first_step(cfg, params,
                                                      batches[0], keep)
    _, _, losses, gnorms, secs = _run_list(params, state, step, batches[1:])
    del state, step
    _free()
    ref = {"init": init, "grads": kept, "params": pm.flatten(params),
           "losses": [loss1] + losses, "grad_norms": [gn1] + gnorms,
           "ms_per_step": 1e3 * (s1 + secs) / MESH_STEPS}
    cfg = mesh_train_cfg("bfloat16")
    params = api.init_model(cfg, seed=0, device=DEVICE)
    step, init = make_train_step(cfg, loss_seq_chunk=MESH_CHUNK,
                                 device=DEVICE)
    _, _, ref["bf16_losses"], _, secs = _run_list(
        params, init(params), step, mesh_batches(1 + MESH_BF16_TIMED))
    ref["bf16_ms_per_step"] = 1e3 * secs / (1 + MESH_BF16_TIMED)
    del params, step
    _free()
    return ref


def _run_list(params, state, step, batches, times=None):
    """``step`` over ``batches``: (params, state, losses, grad norms,
    seconds); ``times`` gets each step's seconds (synchronized)."""
    losses, gnorms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        t1 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        if times is not None:
            times.append(time.perf_counter() - t1)
    if not np.isfinite(losses + gnorms).all():
        fail(f"mesh training: a loss or grad norm is not finite: {losses} "
             f"{gnorms}")
    return params, state, losses, gnorms, time.perf_counter() - t0


def _mesh_params(init, plan):
    """The rank's storage of the seed-0 params ``init`` (the parent's, on
    the card): its slices by the plan, every leaf a copy of its own (the
    replicated ones too: the optimizer writes in place)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import param as pm
    return pm.tree_map(torch.clone, sh.constrain_params(init,
                                                         plan.shardings))


def _collectives(steps):
    """Calls, MB and (when timed) host ms a step of the training
    collectives since the last reset."""
    from repro_torch.distributed import train_mesh as tm
    return {name: {"calls": c.calls / steps, "mb": c.bytes / steps / 1e6,
                   "host_ms": 1e3 * c.merge_s / steps if c.timed else None}
            for name, c in (("gathers", tm.GATHERS),
                            ("reduce_scatters", tm.SCATTERS),
                            ("all_reduces", tm.REDUCES))}


def _kinds(steps):
    """Calls and bytes sent a step of every collective by kind
    (``sharding.COLLECTIVES``) since the last reset."""
    from repro_torch.distributed import sharding as sh
    return {k: {"calls": c["calls"] / steps, "bytes": c["bytes"] / steps}
            for k, c in sh.collective_counts().items()}


def _mesh_fp32(ref, mesh_heads):
    """The fp32 phase on one rank: step 1's gradient shards against the
    unsharded gradient's slices, then MESH_STEPS steps (losses, grad
    norms, launches a step, the params after against the unsharded
    params' slices), and what the ``dryrun`` phase holds its trace to:
    the rank's storage bytes, the collectives a step by kind (steps 2 on)
    and the peak allocated."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import train_mesh as tm
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import param as pm
    from repro_torch.roofline.trace_analysis import storage_bytes
    cfg = mesh_train_cfg("float32")
    plan = make_grad_fn(cfg, loss_seq_chunk=MESH_CHUNK,
                        device=DEVICE).plan()
    params = _mesh_params(ref["init"], plan)
    torch.cuda.reset_peak_memory_stats()
    batches = mesh_batches(MESH_STEPS)
    init_p = pm.flatten(ref["init"])
    _zero_flash_launches()
    tm.reset_counters()
    mesh_heads.clear()
    errs = {}

    def hold(grads, _):
        # each leaf of this rank's gradient shard against the unsharded
        # gradient's slice
        for path, g in pm.flatten(grads).items():
            r = ref["grads"][path][plan.leaves[path].index]
            errs[path] = ((g - r).abs().max() / r.abs().max().clamp_min(
                1e-30)).item()

    storage = {"params": storage_bytes(params)}
    params, state, step, loss1, gn1, s1 = _first_step(cfg, params,
                                                      batches[0], hold)
    storage["opt_state"] = storage_bytes(state)
    times = [s1]
    sh.reset_collectives()
    params, state, losses, gnorms, secs = _run_list(params, state, step,
                                                    batches[1:], times)
    kinds = _kinds(MESH_STEPS - 1)
    losses, gnorms, secs = [loss1] + losses, [gn1] + gnorms, secs + s1
    launches = _flash_launches()
    coll = _collectives(MESH_STEPS)
    diff_max = diff_sum = move_sum = 0.0
    count = 0
    for path, p in pm.flatten(params).items():
        index = plan.leaves[path].index
        r = ref["params"][path][index]
        d = (p - r).abs()
        diff_max = max(diff_max, d.max().item())
        diff_sum += d.sum().item()
        move_sum += (r - init_p[path][index]).abs().sum().item()
        count += p.numel()
    worst = max(errs, key=errs.get)
    out = {"losses": losses, "grad_norms": gnorms, "launches": launches,
           "heads": sorted(mesh_heads), "grad_rel_err": errs[worst],
           "grad_worst_leaf": worst, "param_max_abs_diff": diff_max,
           "param_diff_sum": diff_sum, "param_move_sum": move_sum,
           "param_count": count, "ms_per_step": 1e3 * secs / MESH_STEPS,
           "step_ms": [1e3 * t for t in times], "collectives": coll,
           "storage_gb": sum(t.numel() * t.element_size() for t in
                             pm.flatten(params).values()) / 1e9,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "plan": {"hq": plan.hq, "hkv": plan.hkv, "q_lo": plan.q_lo,
                    "kv_lo": plan.kv_lo},
           "dryrun": {"storage": storage, "collectives": kinds,
                      "peak_bytes": torch.cuda.max_memory_allocated()}}
    del params, state, init_p, step
    _free()
    return out


def _mesh_bf16(ref, mesh_heads):
    """The bf16 phase on one rank: a warm-up and MESH_BF16_TIMED timed
    steps, each collective counted and timed on the host after a
    synchronize (the staging through the host synchronizes anyway)."""
    from repro_torch.distributed import train_mesh as tm
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    cfg = mesh_train_cfg("bfloat16")
    plan = make_grad_fn(cfg, loss_seq_chunk=MESH_CHUNK,
                        device=DEVICE).plan()
    params = _mesh_params(ref["init"], plan)
    step, init = make_train_step(cfg, loss_seq_chunk=MESH_CHUNK,
                                 device=DEVICE)
    state = init(params)
    batches = mesh_batches(1 + MESH_BF16_TIMED)
    torch.cuda.reset_peak_memory_stats()
    mesh_heads.clear()
    params, state, warm, _, warm_s = _run_list(params, state, step,
                                               batches[:1])
    _zero_flash_launches()
    tm.reset_counters(timed=True)
    times = []
    params, state, losses, _, secs = _run_list(params, state, step,
                                               batches[1:], times)
    coll = _collectives(MESH_BF16_TIMED)
    tm.reset_counters()
    launches = _flash_launches()
    ms = 1e3 * float(np.median(times))
    out = {"losses": warm + losses, "warmup_s": warm_s,
           "ms_per_step": ms, "step_ms": [1e3 * t for t in times],
           "tokens_per_s": MESH_B * MESH_T / (ms / 1e3),
           "collectives": coll, "heads": sorted(mesh_heads),
           "launches": launches, "peak_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30}
    del params, state, step
    _free()
    return out


def _param_diffs(params, ref_params, init, plan):
    """(max |diff|, sum |diff|, sum |ref - init|, count) of the rank's
    param shards against the unsharded run's slices."""
    from repro_torch.models import param as pm
    init_p = pm.flatten(init)
    dmax = dsum = msum = 0.0
    count = 0
    for path, p in pm.flatten(params).items():
        index = plan.leaves[path].index
        r = ref_params[path][index]
        d = (p - r).abs()
        dmax = max(dmax, d.max().item())
        dsum += d.sum().item()
        msum += (r - init_p[path][index]).abs().sum().item()
        count += p.numel()
    return dmax, dsum, msum, count


def _mesh_opt_ref(init, name):
    """The unsharded fp32 kernel steps with optimizer ``name`` from the
    seed-0 params ``init`` (MESH_STEPS of them): the params and the whole
    state after, losses, grad norms, ms a step; kept on the card for the
    ranks to map."""
    from repro_torch.config.base import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import param as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step, init_o = make_train_step(mesh_train_cfg("float32"),
                                   loss_seq_chunk=MESH_CHUNK,
                                   hp=OptimizerConfig(name=name),
                                   device=DEVICE)
    params = pm.tree_map(torch.clone, init)
    params, state, losses, gnorms, secs = _run_list(
        params, init_o(params), step, mesh_batches(MESH_STEPS))
    del step
    _free()
    # the ranks map what is on the card; a CPU tensor would go through
    # shared memory
    state["step"] = state["step"].to(DEVICE)
    return {"name": name, "init": init, "params": pm.flatten(params),
            "state": state, "losses": losses, "grad_norms": gnorms,
            "ms_per_step": 1e3 * secs / MESH_STEPS}


def _mesh_opt(ref):
    """One rank's fp32 MESH_STEPS steps with ``ref``'s optimizer on the
    mesh (from the seed-0 params): losses, grad norms, the params after
    against the unsharded run's slices, every moment leaf against the
    rank's slice of the unsharded state (``optimizers.shard_state``:
    int8 moments in quanta, the rest relative to the leaf's largest
    magnitude), and the ``dryrun`` readings (storage, collectives a
    step by kind from step 2, peak allocated)."""
    from repro_torch.config.base import OptimizerConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import param as pm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.roofline.trace_analysis import storage_bytes
    cfg = mesh_train_cfg("float32")
    step, init = make_train_step(cfg, loss_seq_chunk=MESH_CHUNK,
                                 hp=OptimizerConfig(name=ref["name"]),
                                 device=DEVICE)
    plan = step.plan()
    params = _mesh_params(ref["init"], plan)
    torch.cuda.reset_peak_memory_stats()
    state = init(params)
    storage = {"params": storage_bytes(params),
               "opt_state": storage_bytes(state)}
    batches = mesh_batches(MESH_STEPS)
    params, state, l1, g1, s1 = _run_list(params, state, step, batches[:1])
    sh.reset_collectives()
    params, state, losses, gnorms, secs = _run_list(params, state, step,
                                                    batches[1:])
    kinds = _kinds(MESH_STEPS - 1)
    want = pm.flatten(opt_lib.shard_state(ref["state"], params, cfg,
                                          plan.leaves))
    quanta, differ, n_q, rel, scale_rel = 0, 0, 0, {}, 0.0
    for k, t in pm.flatten(state).items():
        w = want[k]
        if t.dtype == torch.int8:
            d = (t.int() - w.int()).abs()
            quanta = max(quanta, d.max().item())
            differ += (d > 0).sum().item()
            n_q += d.numel()
        elif k.endswith("/s"):
            # a block's scale against its own
            scale_rel = max(scale_rel, ((t - w).abs() / w.abs().clamp_min(
                1e-30)).max().item())
        elif t.is_floating_point():
            rel[k] = ((t - w).abs().max() / w.abs().max().clamp_min(
                1e-30)).item()
    dmax, dsum, msum, count = _param_diffs(params, ref["params"],
                                           ref["init"], plan)
    worst = max(rel, key=rel.get) if rel else None
    out = {"losses": l1 + losses, "grad_norms": g1 + gnorms,
           "q_max_quanta": quanta, "q_share_differing": differ / max(n_q, 1),
           "scale_rel_err": scale_rel,
           "moment_rel_err": rel[worst] if rel else 0.0,
           "moment_worst_leaf": worst, "param_max_abs_diff": dmax,
           "param_diff_sum": dsum, "param_move_sum": msum,
           "param_count": count,
           "ms_per_step": 1e3 * (s1 + secs) / MESH_STEPS,
           "dryrun": {"storage": storage, "collectives": kinds,
                      "peak_bytes": torch.cuda.max_memory_allocated()}}
    del params, state, step, want
    _free()
    return out


def _mesh_opt_bf16(ref):
    """One rank's bf16 steps with ``ref``'s optimizer from the seed-0
    params (a bf16 model keeps fp32 params): a warm-up, then
    MESH_BF16_TIMED timed steps (median ms a step), and the rank's
    optimizer state bytes."""
    from repro_torch.config.base import OptimizerConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.roofline.trace_analysis import storage_bytes
    step, init = make_train_step(mesh_train_cfg("bfloat16"),
                                 loss_seq_chunk=MESH_CHUNK,
                                 hp=OptimizerConfig(name=ref["name"]),
                                 device=DEVICE)
    params = _mesh_params(ref["init"], step.plan())
    state = init(params)
    state_bytes = storage_bytes(state)
    batches = mesh_batches(1 + MESH_BF16_TIMED)
    params, state, warm, _, _ = _run_list(params, state, step, batches[:1])
    times = []
    params, state, losses, _, _ = _run_list(params, state, step,
                                            batches[1:], times)
    out = {"losses": warm + losses, "state_bytes": state_bytes,
           "ms_per_step": 1e3 * float(np.median(times))}
    del params, state, step
    _free()
    return out


def mesh_opt_rank(rank, n, refs):
    """One rank of ``mesh_optimizers``: each optimizer of ``refs`` ({name:
    its unsharded run}) on the (data 2, model 2) mesh with FSDP, fp32
    against the unsharded run, then bf16 timed."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*MESH_SHAPE)
    out = {"rank": rank}
    with sh.use_sharding(mesh, sh.LOGICAL_RULES, fsdp=True):
        for name, ref in refs.items():
            out[name] = {"fp32": _mesh_opt(ref), "bf16": _mesh_opt_bf16(ref)}
    # every rank lets go of its peers' exchange buffers before any exits
    _free()
    dist.barrier()
    return out


def _pipeline_rank(rank, group):
    """GPipe over a pod axis of 2 (ranks 0 and 1): one full-width
    paper-target block a stage (drawn from seed 7 on both ranks, each
    keeping its own as its stage slice), PIPE_M microbatches of 1 x
    PIPE_T, stateless through #3; held to sequential application of both
    blocks on this rank; #3 launches counted around the pipeline only."""
    from repro_torch.distributed import pipeline_parallel as pp
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import param as pm
    from repro_torch.models.blocks import block_apply, block_init, layer_specs
    cfg = mesh_train_cfg("float32")
    spec = layer_specs(cfg)[0]
    gen = pm.make_generator(7, torch.device(DEVICE))
    blocks = [block_init(gen, cfg, spec) for _ in range(2)]
    xs = torch.randn((PIPE_M, 1, PIPE_T, cfg.d_model), generator=gen,
                     device=DEVICE)

    def stage(p, x):
        return block_apply(p, x, cfg, spec, attn_impl="kernel")[0]

    mesh = sh.Mesh(("pod", "data", "model"), (2, 1, 1), (rank, 0, 0),
                   (group, None, None))
    with torch.no_grad():
        seq = torch.stack([stage(blocks[1], stage(blocks[0], x)) for x in xs])
        own = pm.tree_map(lambda t: t[None], blocks[rank])
        with sh.use_sharding(mesh):
            _zero_flash_launches()
            pp.STAGE_CALLS["n"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = pp.pipeline_apply(stage, own, xs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in _flash_launches().items() if v}
    return {"rel_err": ((y - seq).abs().max() / seq.abs().max()).item(),
            "launches": launches, "stage_calls": pp.STAGE_CALLS["n"],
            "ms": 1e3 * secs}


def dryrun_serve_cell():
    """The dryrun phase's small serving cell (``launch/steps.py::
    build_cell``): a decode cycle of the mesh phases' target in bf16 at
    DRYRUN_SERVE_B rows of DRYRUN_SERVE_T tokens."""
    from repro_torch.config.base import ShapeSpec
    from repro_torch.launch.steps import build_cell
    cfg = dataclasses.replace(mesh_train_cfg("bfloat16"), remat=False)
    return build_cell("paper-target", "serve", cfg=cfg, shape=ShapeSpec(
        "serve", DRYRUN_SERVE_T, DRYRUN_SERVE_B, "decode"))


def _serve_cell_real(mesh):
    """One real run of :func:`dryrun_serve_cell` on this rank: the cell's
    meta bundle replaced by random weights (seeds 0, 1, 2, cast to bf16)
    on the card, cut as ``rank_args`` cuts them (the whole let go), and
    one decode cycle from the zeroed state: the rank's argument bytes by
    part, the cycle's collectives by kind (the weight gathers through the
    on-card exchange among them)."""
    from repro_torch.core.drafter import drafter_init
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import rank_args
    from repro_torch.models import api
    from repro_torch.models import param as pm
    cell = dryrun_serve_cell()
    meta = cell.args[0]

    def bf16(tree):
        return pm.tree_map(lambda t: t.to(torch.bfloat16)
                           if t.is_floating_point() else t, tree)

    cell.args = (dataclasses.replace(
        meta, target_params=bf16(api.init_model(meta.target_cfg, seed=0,
                                                device=DEVICE)),
        d1_params=bf16(drafter_init(meta.d1_cfg, 1, DEVICE)),
        d2_params=bf16(drafter_init(meta.d2_cfg, 2, DEVICE))),
        ) + cell.args[1:]
    with sh.use_sharding(mesh, cell.rules, fsdp=cell.fsdp), \
            torch.no_grad():
        args = rank_args(cell)
        cell.args = None
        _free()
        parts = dryrun.arg_parts(cell, args)
        sh.reset_collectives()
        cell.fn(*args)
        torch.cuda.synchronize()
        out = {"parts": parts, "collectives": sh.collective_counts()}
    del args
    _free()
    return out


def mesh_rank(rank, n, ref):
    """One rank of the mesh phases: fp32 and bf16 training on the (data
    2, model 2) mesh with FSDP, then (ranks 0 and 1) the pipeline.
    Returns this rank's record."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*MESH_SHAPE)
    heads = set()
    flash = kops.flash_attention

    def seen(q, k, v, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)

    kops.flash_attention = seen
    out = {"rank": rank}
    with sh.use_sharding(mesh, sh.LOGICAL_RULES, fsdp=True):
        out["fp32"] = _mesh_fp32(ref, heads)
        out["bf16"] = _mesh_bf16(ref, heads)
    kops.flash_attention = flash
    _free()
    out["serve_cell"] = _serve_cell_real(mesh)
    # every rank lets go of its peers' exchange buffers before any exits
    _free()
    dist.barrier()
    group = dist.new_group([0, 1])
    if rank < 2:
        out["pipeline"] = _pipeline_rank(rank, group)
    dist.barrier()
    return out


def mesh_train_path():
    """The mesh phases: the unsharded kernel steps first (fp32, bf16),
    then 4 ranks on this card (:func:`mesh_rank`), held here: ``mesh_train``
    (fp32 against the unsharded step), ``mesh_train_bf16`` (readings) and
    ``pipeline``; then the same cell with each of MESH_OPTS in one more
    spawn (``mesh_optimizers``). Returns the flash launches a step a
    rank by dtype, the pipeline's #3 launches a rank, the ranks' dryrun
    readings by optimizer and the dryrun phase's traces."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.steps import optimizer_for
    from repro_torch.optim.optimizers import lr_schedule
    t0 = time.perf_counter()
    ref = _mesh_unsharded()
    ref_s = time.perf_counter() - t0
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    # the dryrun phase's traces, on a thread of this process while the
    # ranks run on the card
    traces = {}
    tracer = threading.Thread(target=lambda: traces.update(dryrun_traces()))
    tracer.start()
    recs = run_ranks(mesh_rank, n, n, ref)
    cfg = mesh_train_cfg("float32")
    r32 = [r["fp32"] for r in recs]
    for r in r32[1:]:
        if r["losses"] != r32[0]["losses"] or r["grad_norms"] != r32[0][
                "grad_norms"]:
            fail(f"mesh_train: the ranks' losses differ: {r32}")
    f = r32[0]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(f["losses"],
                                                      ref["losses"]))
    gn_rel = max(abs(x - y) / abs(y) for x, y in zip(f["grad_norms"],
                                                     ref["grad_norms"]))
    grad_rel = max(r["grad_rel_err"] for r in r32)
    diff_max = max(r["param_max_abs_diff"] for r in r32)
    param_rel = sum(r["param_diff_sum"] for r in r32) / max(
        sum(r["param_move_sum"] for r in r32), 1e-30)
    hp = optimizer_for(cfg)
    sign_bound = 2 * sum(float(lr_schedule(hp, s))
                         for s in range(1, MESH_STEPS + 1))
    per_step = [_check_flash_launches(r["launches"], MESH_STEPS, False,
                                      MESH_LAYERS, "mesh_train")
                for r in r32]
    for r in r32:
        if [tuple(h) for h in r["heads"]] != [(16, 4)]:
            fail(f"mesh_train: flash ran at (Hq, Hkv) {r['heads']}, not "
                 "(16, 4)")
    out = {"mesh": list(MESH_SHAPE), "fsdp": True, "ranks": n,
           "layers": MESH_LAYERS, "params": cfg.param_count(),
           "batch": MESH_B, "seq": MESH_T, "loss_seq_chunk": MESH_CHUNK,
           "mask_rows": list(MESH_ROWS), "optimizer": hp.name,
           "losses": f["losses"], "grad_norms": f["grad_norms"],
           "unsharded": {k: ref[k] for k in ("losses", "grad_norms",
                                             "ms_per_step")},
           "loss_rel_err": loss_rel, "grad_norm_rel_err": gn_rel,
           "grad_rel_err": grad_rel,
           "grad_worst_leaf": max(r32, key=lambda r: r["grad_rel_err"])[
               "grad_worst_leaf"],
           "param_max_abs_diff": diff_max, "param_rel_err": param_rel,
           "param_sign_bound": sign_bound,
           "launches_per_step": per_step[0], "heads": f["heads"],
           "plans": [r["plan"] for r in r32],
           "ms_per_step": [r["ms_per_step"] for r in r32],
           "collectives_per_step": f["collectives"],
           "storage_gb_per_rank": [r["storage_gb"] for r in r32],
           "peak_gib_per_rank": [r["peak_gib"] for r in r32],
           "unsharded_s": ref_s, "gpu": nvidia_smi_line(),
           "tol": {"loss": TOL_TRAIN_LOSS, "grad_norm": TOL_TRAIN_GNORM,
                   "grad": TOL_MESH_GRAD, "param": TOL_TRAIN_PARAM},
           "note": "ranks time-share one card"}
    if loss_rel > TOL_TRAIN_LOSS or gn_rel > TOL_TRAIN_GNORM or \
            grad_rel > TOL_MESH_GRAD or param_rel > TOL_TRAIN_PARAM or \
            diff_max > sign_bound:
        fail(f"mesh_train: the sharded step disagrees with the unsharded "
             f"one: {out}")
    emit({"phase": "mesh_train", "ok": True, **out})
    b16 = [r["bf16"] for r in recs]
    for r in b16[1:]:
        if r["losses"] != b16[0]["losses"]:
            fail(f"mesh_train_bf16: the ranks' losses differ: {b16}")
    b = b16[0]
    per16 = [_check_flash_launches(r["launches"], MESH_BF16_TIMED, True,
                                   MESH_LAYERS, "mesh_train_bf16")
             for r in b16]
    rel16 = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                   ref["bf16_losses"]))
    out16 = {"mesh": list(MESH_SHAPE), "fsdp": True, "ranks": n,
             "layers": MESH_LAYERS, "batch": MESH_B, "seq": MESH_T,
             "losses": b["losses"], "unsharded_losses": ref["bf16_losses"],
             "loss_rel_err": rel16, "tol_loss": TOL_TRAIN_BF16_LOSS,
             "ms_per_step": [r["ms_per_step"] for r in b16],
             "step_ms": b["step_ms"],
             "unsharded_ms_per_step": ref["bf16_ms_per_step"],
             "tokens_per_s": b["tokens_per_s"],
             "collectives_per_step": b["collectives"],
             "launches_per_step": per16[0], "heads": b["heads"],
             "peak_gib_per_rank": [r["peak_gib"] for r in b16],
             "warmup_s": b["warmup_s"], "gpu": nvidia_smi_line(),
             "note": "readings: ranks time-share one card; the "
                     "collectives exchange on the card (CUDA IPC)"}
    if rel16 > TOL_TRAIN_BF16_LOSS:
        fail(f"mesh_train_bf16: losses off the unsharded bf16 step's: "
             f"{out16}")
    emit({"phase": "mesh_train_bf16", "ok": True, **out16})
    pipe = [r["pipeline"] for r in recs if "pipeline" in r]
    want = PIPE_M + 2 - 1
    for p in pipe:
        if p["launches"] != {"flash_fwd": want} or p["stage_calls"] != want \
                or p["rel_err"] > TOL_PIPE:
            fail(f"pipeline: {pipe}")
    emit({"phase": "pipeline", "ok": True, "stages": 2, "microbatches":
          PIPE_M, "microbatch": [1, PIPE_T], "layers_per_stage": 1,
          "launches_per_rank": pipe[0]["launches"],
          "stage_calls_per_rank": [p["stage_calls"] for p in pipe],
          "rel_err": [p["rel_err"] for p in pipe], "tol": TOL_PIPE,
          "ms": [p["ms"] for p in pipe], "gpu": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    readings = {"adamw": [r["fp32"]["dryrun"] for r in recs]}
    serve_cell = [r["serve_cell"] for r in recs]
    adamw_state = [r["fp32"]["dryrun"]["storage"]["opt_state"] for r in recs]
    # the optimizers' runs: one more spawn, with only their unsharded
    # runs on the card beside the seed-0 params
    init = ref["init"]
    del ref, recs
    _free()
    t_opt = time.perf_counter()
    refs = {name: _mesh_opt_ref(init, name) for name in MESH_OPTS}
    recs = run_ranks(mesh_opt_rank, n, n, refs)
    opts = {}
    for name in MESH_OPTS:
        u = refs[name]
        rs = [r[name]["fp32"] for r in recs]
        for r in rs[1:]:
            if r["losses"] != rs[0]["losses"] or \
                    r["grad_norms"] != rs[0]["grad_norms"]:
                fail(f"mesh_optimizers: the ranks' {name} losses differ")
        o = {"losses": rs[0]["losses"], "unsharded_losses": u["losses"],
             "loss_rel_err": max(abs(x - y) / abs(y) for x, y in
                                 zip(rs[0]["losses"], u["losses"])),
             "grad_norm_rel_err": max(abs(x - y) / abs(y) for x, y in
                                      zip(rs[0]["grad_norms"],
                                          u["grad_norms"])),
             "param_max_abs_diff": max(r["param_max_abs_diff"] for r in rs),
             "param_rel_err": sum(r["param_diff_sum"] for r in rs) / max(
                 sum(r["param_move_sum"] for r in rs), 1e-30),
             "q_max_quanta": max(r["q_max_quanta"] for r in rs),
             "q_share_differing": max(r["q_share_differing"] for r in rs),
             "scale_rel_err": max(r["scale_rel_err"] for r in rs),
             "moment_rel_err": max(r["moment_rel_err"] for r in rs),
             "moment_worst_leaf": max(rs, key=lambda r: r[
                 "moment_rel_err"])["moment_worst_leaf"],
             "ms_per_step_fp32": [r["ms_per_step"] for r in rs],
             "unsharded_ms_per_step_fp32": u["ms_per_step"],
             "state_bytes_per_rank": [r["dryrun"]["storage"]["opt_state"]
                                      for r in rs],
             "adamw_state_bytes_per_rank": adamw_state,
             "bf16_ms_per_step": [r[name]["bf16"]["ms_per_step"]
                                  for r in recs],
             "bf16_losses": recs[0][name]["bf16"]["losses"]}
        if o["loss_rel_err"] > TOL_TRAIN_LOSS or \
                o["grad_norm_rel_err"] > TOL_TRAIN_GNORM or \
                o["param_rel_err"] > TOL_TRAIN_PARAM or \
                o["q_max_quanta"] > MESH_STEPS or \
                o["q_share_differing"] > TOL_Q_SHARE or \
                o["scale_rel_err"] > MESH_STEPS / 127 or \
                o["moment_rel_err"] > TOL_MESH_MOMENT or \
                not np.isfinite(o["bf16_losses"]).all():
            fail(f"mesh_optimizers: sharded {name} disagrees with the "
                 f"unsharded step: {o}")
        opts[name] = o
        readings[name] = [r["dryrun"] for r in rs]
    del refs, recs
    _free()
    emit({"phase": "mesh_optimizers", "ok": True, "mesh": list(MESH_SHAPE),
          "fsdp": True, "ranks": n, "layers": MESH_LAYERS, "batch": MESH_B,
          "seq": MESH_T, "steps": MESH_STEPS, **opts,
          "tol": {"loss": TOL_TRAIN_LOSS, "grad_norm": TOL_TRAIN_GNORM,
                  "param": TOL_TRAIN_PARAM, "q_quanta": MESH_STEPS,
                  "q_share": TOL_Q_SHARE, "scale": MESH_STEPS / 127,
                  "moment": TOL_MESH_MOMENT},
          "gpu": nvidia_smi_line(), "note": "ranks time-share one card",
          "seconds": time.perf_counter() - t_opt})
    del init
    _free()
    tracer.join()
    return {"float32": per_step[0], "bfloat16": per16[0],
            "pipeline": pipe[0]["launches"], "readings": readings,
            "serve_cell": serve_cell, "traces": traces}


def start_dryrun_cells():
    """Start ``python -m repro_torch.launch.dryrun`` on DRYRUN_CELLS, all
    together and niced (they trace on the host while the mesh phases
    run on the card): (their output directory, [(cell, start, process)])."""
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out-dir", out_dir]
        procs.append(((arch, shape, mesh), time.perf_counter(),
                      subprocess.Popen(cmd, env=env,
                                       stdout=subprocess.DEVNULL,
                                       stderr=subprocess.PIPE,
                                       preexec_fn=lambda: os.nice(10))))
    # a phase that fails before the dryrun phase exits the script: stop
    # them and remove their directory then too
    atexit.register(_stop_dryrun_cells, out_dir, procs)
    return out_dir, procs


def _stop_dryrun_cells(out_dir, procs):
    for _, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(out_dir, ignore_errors=True)


def _finish_dryrun_cells(started):
    """Wait for :func:`start_dryrun_cells`' processes: {cell: (exit code,
    record, seconds)}; their directory is removed."""
    out_dir, procs = started
    out = {}
    try:
        for key, t0, proc in procs:
            try:
                _, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                fail(f"dryrun: {key} ran past {DRYRUN_TIMEOUT} s")
            path = Path(out_dir) / f"{'_'.join(key)}.json"
            rec = json.loads(path.read_text()) if path.exists() else {
                "error": err.decode()[-2000:]}
            out[key] = (proc.returncode, rec, time.perf_counter() - t0)
    finally:
        _stop_dryrun_cells(out_dir, procs)
    return out


def dryrun_traces():
    """The mesh phases' (2, 2) FSDP cell of AdamW and of each of MESH_OPTS
    traced on the meta device for each rank of a shape-only mesh:
    {optimizer: [(parts, counts, seconds) a rank]}. Runs on a thread of
    the parent while the ranks run on the card."""
    from repro_torch.config.base import OptimizerConfig, ShapeSpec
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.steps import build_cell
    cfg = mesh_train_cfg("float32")
    names = ("data", "model")
    out = {}
    for name in ("adamw",) + MESH_OPTS:
        cell = build_cell("paper-target", "mesh", cfg=cfg,
                          shape=ShapeSpec("mesh", MESH_T, MESH_B, "train"),
                          loss_seq_chunk=MESH_CHUNK,
                          hp=OptimizerConfig(name=name))
        out[name] = []
        for r in range(MESH_SHAPE[0] * MESH_SHAPE[1]):
            coords = tuple(int(c) for c in np.unravel_index(r, MESH_SHAPE))
            mesh = sh.Mesh(names, MESH_SHAPE, coords,
                           tuple(sh.ShapeOnlyGroup((a,)) for a in names))
            t1 = time.perf_counter()
            parts, counts = trace_cell(cell, mesh, sh.LOGICAL_RULES, True)
            out[name].append((parts, counts, time.perf_counter() - t1))
    out["serve_cell"] = []
    for r in range(MESH_SHAPE[0] * MESH_SHAPE[1]):
        coords = tuple(int(c) for c in np.unravel_index(r, MESH_SHAPE))
        mesh = sh.Mesh(names, MESH_SHAPE, coords,
                       tuple(sh.ShapeOnlyGroup((a,)) for a in names))
        t1 = time.perf_counter()
        parts, counts = trace_cell(dryrun_serve_cell(), mesh)
        out["serve_cell"].append((parts, counts, time.perf_counter() - t1))
    return out


def dryrun_path(mesh_steps, started):
    """The multi-device dry run on this machine (``launch/dryrun.py``).
    (a) The mesh phases' (2, 2) FSDP cell of each optimizer traced on the
    meta device for each rank of a shape-only mesh (:func:`dryrun_traces`,
    ``mesh_steps["traces"]``), held to the ranks'
    real fp32 step: storage bytes of the params and the optimizer state
    and the collectives a step by kind exactly equal, the flash kernels'
    stand-ins called as often a step as the kernels launched; the peak
    estimate beside each rank's peak allocated. (b) The launcher as
    subprocesses on DRYRUN_CELLS (production cells of the 16x16 and
    2x16x16 meshes; ``started``: :func:`start_dryrun_cells`), each ok;
    its headline numbers, modelled at the H100 SXM's peaks."""
    t0 = time.perf_counter()
    want_kernels = mesh_steps["float32"]
    cells = {}
    for name, reals in mesh_steps["readings"].items():
        ranks = []
        for r, (real, (parts, counts, trace_s)) in enumerate(zip(
                reals, mesh_steps["traces"][name])):
            got = {k: {"calls": counts["coll_calls"][k],
                       "bytes": counts[k]}
                   for k in real["collectives"]}
            calls = counts["kernels"]
            est = (sum(parts.values()) + counts["temp_peak_bytes"])
            rec = {"rank": r, "storage": parts,
                   "real_storage": real["storage"],
                   "collectives": got,
                   "real_collectives": real["collectives"],
                   "attention_calls": calls,
                   "peak_estimate_gib": est / 2 ** 30,
                   "peak_allocated_gib": real["peak_bytes"] / 2 ** 30,
                   "peak_ratio": est / real["peak_bytes"],
                   "flops": counts["flops"], "trace_s": trace_s}
            if parts["params"] != real["storage"]["params"] or \
                    parts["opt_state"] != real["storage"][
                        "opt_state"] or got != real["collectives"] or \
                    calls != want_kernels:
                fail(f"dryrun: the {name} trace of rank {r} disagrees "
                     f"with its real step (kernels a step "
                     f"{want_kernels}): {rec}")
            ranks.append(rec)
        cells[name] = ranks
    serve = []
    for r, (real, (parts, counts, trace_s)) in enumerate(zip(
            mesh_steps["serve_cell"], mesh_steps["traces"]["serve_cell"])):
        got = {k: {"calls": counts["coll_calls"][k], "bytes": counts[k]}
               for k in real["collectives"]}
        rec = {"rank": r, "argument_bytes": parts,
               "real_argument_bytes": real["parts"], "collectives": got,
               "real_collectives": real["collectives"], "trace_s": trace_s}
        if parts != real["parts"] or got != real["collectives"] or \
                real["collectives"]["all-gather"]["calls"] <= 0:
            fail(f"dryrun: the serving cell's trace of rank {r} disagrees "
                 f"with its real run: {rec}")
        serve.append(rec)
    sub = _finish_dryrun_cells(started)
    launched = {}
    for key, (rc, rec, secs) in sub.items():
        if rc != 0 or not rec.get("ok"):
            fail(f"dryrun: the launcher's {key} cell failed (rc {rc}): "
                 f"{ {k: v for k, v in rec.items() if k != 'traceback'} }")
        t = rec["terms"]
        launched["_".join(key)] = {
            "seconds": secs, "trace_s": rec["trace_s"],
            "flops_per_rank": rec["counts"]["flops"],
            "coll_bytes_per_rank": rec["counts"]["coll_bytes"],
            "argument_gib_per_rank": rec["memory"][
                "argument_bytes_per_dev"] / 2 ** 30,
            "peak_estimate_gb": rec["memory"]["peak_estimate_gb"],
            "dominant": t["dominant"],
            "roofline_fraction": t["roofline_fraction"],
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"],
            "read_path": rec["read_path"]}
    emit({"phase": "dryrun", "ok": True, "mesh": list(MESH_SHAPE),
          "layers": MESH_LAYERS, "batch": MESH_B, "seq": MESH_T,
          "traced": cells, "launcher": launched,
          "serve_cell": {"rows": DRYRUN_SERVE_B, "seq": DRYRUN_SERVE_T,
                         "kind": "decode", "ranks": serve},
          "terms": "modelled at H100 SXM peaks (roofline/analysis.py)",
          "gpu": nvidia_smi_line(), "seconds": time.perf_counter() - t0})


# --------------------------------------------------------------- serving --
SERVE_BATCH, SERVE_PAGE, SERVE_POOL = 4, 64, 160
SERVE_PREFIX = 5              # pages of the shared system prompt (320)
SERVE_SFX = (1, 2, 3, 14, 5, 7, 9, 2, 11)  # suffixes, in half pages (32)
SERVE_NEW = (12, 4, 20, 8, 24, 6, 16, 10, 18, 14)
SERVE_RATE = 1.0              # requests/s of the bf16 phase's Poisson trace
SERVE_LAYERS = 3              # paper-target cut in depth for the serving
                              # and sharded phases (a twelfth of 36, the
                              # drafters' 3 feature layers: their eager
                              # cycles are host-bound and the run's time
                              # limit binds)


def serving_traffic(bundle):
    """The serving phases' 10 requests, behind a chat endpoint: each
    prompt is the 320-token system prompt and a suffix of its own of
    32-448 tokens; requests 1 and 7 share 352 tokens (a match that ends
    inside a page: a COW copy); request 9 is request 0's prompt, its
    plain greedy answer (``greedy_reference``) and 40 new tokens (a
    second turn, hitting generated tokens); ``max_new`` 4-24. Request 0
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


def serve_run(bundle, reqs, name, snoop=None, first_alone=True,
              in_cycle=contextlib.nullcontext, **kw):
    """Request 0, then the other nine (``first_alone``; else all at once),
    through one ``ServingEngine`` (batch 4, pages of 64): per-request
    tokens and a record of the run. ``snoop(eng, state)``, when given,
    sees the state before each cycle; each cycle runs inside
    ``in_cycle()``."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(bundle, batch_size=SERVE_BATCH, device=DEVICE, **kw)
    n_cycles = [0]
    cycle = eng._cycle

    def counted(state, gen):
        n_cycles[0] += 1
        if snoop is not None:
            snoop(eng, state)
        with in_cycle():
            return cycle(state, gen)

    eng._cycle = counted
    cycle_s = _time_cycles(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for part in (reqs[:1], reqs[1:]) if first_alone else (reqs,):
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
    return reqs, {n: toks[n] for n in ("prefix_gather", "prefix_kernel")}, by


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
    return runs, toks["sync"]


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


# ------------------------------------------------- kv_seq-sharded serving --
# phase -> (ranks, dtype): fp32 over 2 ranks (32 slots of each 64-key
# page a rank), bf16 over 4 (16 slots, pos_offset up to 48)
SHARDED = {"sharded": (2, "float32"), "sharded_bf16": (4, "bfloat16")}


def _merge_bytes(bundle, batches, md=4):
    """The LSE-merge payload a rank sends over the given cycles (one row
    count each), by JAX's formula (acc and l in the merge dtype, m in
    fp32) summed over the cycle's sharded reads: every target layer over
    the verify tree (gamma + K (gamma - 1) rows), every drafter-1 layer
    over its block (gamma) and every drafter-2 layer over the K forks'
    blocks (K gamma)."""
    g, k = bundle.spec.gamma, bundle.spec.top_k_branches
    rows = (bundle.target_cfg.num_layers * (g + k * (g - 1))
            + bundle.d1_cfg.num_layers * g + bundle.d2_cfg.num_layers * k * g)
    tc = bundle.target_cfg
    return sum(b * tc.num_heads * rows * ((tc.head_dim + 1) * md + 4)
               for b in batches)


class WeightGathers:
    """``serve_run``'s ``in_cycle``: the serving weight gathers inside
    decode cycles (``sharding.WEIGHTS``, timed after a synchronize while
    inside): calls, bytes a rank received, host seconds; ``inner``: an
    ``in_cycle`` it runs inside."""

    def __init__(self, inner=contextlib.nullcontext):
        self.calls = self.bytes = 0
        self.seconds = 0.0
        self.inner = inner

    @contextlib.contextmanager
    def __call__(self):
        from repro_torch.distributed import sharding as sh
        w = sh.WEIGHTS
        before = (w.calls, w.bytes, w.merge_s)
        w.timed = True
        try:
            with self.inner():
                yield
        finally:
            w.timed = False
            self.calls += w.calls - before[0]
            self.bytes += w.bytes - before[1]
            self.seconds += w.merge_s - before[2]

    def per_cycle(self, cycles):
        return {"weight_gathers_per_cycle": self.calls / cycles,
                "weight_gather_bytes_per_cycle": self.bytes / cycles,
                "weight_gather_ms_per_cycle": 1e3 * self.seconds / cycles}


def _bundle_bytes(bundle):
    from repro_torch.roofline.trace_analysis import storage_bytes
    return storage_bytes(bundle.target_params, bundle.d1_params,
                         bundle.d2_params)


def stored_bundle(build):
    """A mesh serving phase's bundle on this rank (inside the mesh):
    ``build()``'s whole bundle cut to the rank's serving storage
    (``pipeline.serve_storage``: every weight's slice by the parameter
    rules, a MoE's expert stacks EP's part) and the whole one let go.
    Returns (the stored bundle, its record: the weight bytes it stores
    beside the whole bundle's, and the bytes allocated on the card with
    the whole bundle and with the storage alone)."""
    from repro_torch.core import pipeline as pl
    bundle = build()
    _free()
    rec = {"whole_weight_bytes": _bundle_bytes(bundle),
           "allocated_gib_whole": torch.cuda.memory_allocated() / 2 ** 30}
    stored = pl.serve_storage(bundle)
    del bundle
    _free()
    rec.update(weight_bytes=_bundle_bytes(stored),
               allocated_gib_storage=torch.cuda.memory_allocated() / 2 ** 30)
    rec["weight_share"] = rec["weight_bytes"] / rec["whole_weight_bytes"]
    return stored, rec


class StateBytes:
    """A ``serve_run`` snoop: at the first cycle, the bytes of the wave's
    engine state this rank holds beside the unsharded engine's (the same
    wave's state made outside the mesh, on meta); ``inner``: a snoop it
    calls too."""

    def __init__(self, inner=None):
        self.rec = None
        self.inner = inner

    def __call__(self, eng, state):
        if self.inner is not None:
            self.inner(eng, state)
        if self.rec is not None:
            return
        from repro_torch.core.state import engine_init
        from repro_torch.distributed import sharding as sh
        from repro_torch.models import kvcache as kvc
        from repro_torch.roofline.trace_analysis import storage_bytes
        b = state.run.b if state.run is not None else state.batch
        paged = state.cache_impl == "paged"
        kw = (dict(cache_impl="paged", page_size=state.page_size,
                   pool_pages=kvc.page_geometry(state.d1_feat)[2])
              if paged else {})
        max_len = state.max_len
        with sh.use_sharding(None):
            whole = engine_init(eng.bundle, b, max_len, device="meta", **kw)
        self.rec = {"state_bytes": storage_bytes(state),
                    "unsharded_state_bytes": storage_bytes(whole)}


def _layout_gate(where, layout, cut):
    """A mesh serving phase's rank holds less than the whole bundle where
    its rules cut a weight (``cut``), and gathers weights in its cycles;
    its state no more than the unsharded engine's."""
    if cut and (layout["weight_bytes"] >= layout["whole_weight_bytes"]
                or layout["weight_gathers_per_cycle"] <= 0):
        fail(f"{where}: the rank's weights are not its storage: {layout}")
    if layout["state_bytes"] > layout["unsharded_state_bytes"]:
        fail(f"{where}: the rank's state exceeds the unsharded one: "
             f"{layout}")


def sharded_rank(rank, n, dtype, reqs):
    """One rank of a sharded phase: the serving bundle built from the
    seeds (one rank after another, so that at most one fp32 build is on
    the card beside the finished ranks), then the serving requests
    through the engine inside the mesh, by the kernel path (merges timed)
    and the gather path. Returns this rank's record; rank 0 also holds
    each run to plain greedy (fp32) or the kernel run to the gather run
    (bf16) by the near-tie rules, outside the mesh."""
    import torch.distributed as dist
    from repro_torch.core import pipeline as pl
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import spdecode as sp
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, n)
    rules = dict(sh.LOGICAL_RULES, kv_seq="model")

    def build():
        b = build_bundle("float32", layers=SERVE_LAYERS)
        return to_bf16(b) if dtype == "bfloat16" else b

    for i in range(n):
        if i == rank:
            with sh.use_sharding(mesh, rules):
                bundle, layout = stored_bundle(build)
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    paged = casc.cascade_phase1_paged
    runs, toks = {}, {}
    with sh.use_sharding(mesh, rules):
        for impl in ("kernel", "gather"):
            _zero_launches()
            paged.sharded_launches = 0
            sp.PAYLOAD.reset()
            sp.PAYLOAD.timed = impl == "kernel"
            batches = []
            gathers, state_bytes = WeightGathers(), StateBytes(
                lambda _, state: batches.append(state.batch))
            eng, toks[impl], info = serve_run(
                pl.with_attn_impl(bundle, impl), reqs, f"sharded_{impl}",
                snoop=state_bytes, in_cycle=gathers,
                cache_impl="paged", page_size=SERVE_PAGE,
                pool_pages=SERVE_POOL, prefix_cache=True)
            sp.PAYLOAD.timed = False
            st = eng.stats
            if impl == "kernel":
                layout.update(state_bytes.rec, **gathers.per_cycle(
                    info["decode_cycles"]))
            info.update(
                launches=_launches(), sharded_launches=paged.sharded_launches,
                kv_shards=st["kv_shards"],
                pool_shard_slots=st["pool_shard_slots"],
                decode_collective_bytes=st["decode_collective_bytes"],
                collective_bytes_formula=_merge_bytes(bundle, batches),
                merge_calls=sp.PAYLOAD.calls,
                merge_ms_per_cycle=1e3 * sp.PAYLOAD.merge_s
                / info["decode_cycles"])
            runs[impl] = info
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    rec = {"rank": rank, "runs": runs, "layout": layout,
           "tokens": {impl: {u: t.tolist() for u, t in tk.items()}
                      for impl, tk in toks.items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del bundle
    _free()
    if rank == 0:
        # single-rank plain forwards, outside the mesh (no collective),
        # on the whole bundle built again from the seeds
        bundle = build()
        if dtype == "float32":
            rec["near_ties"] = {impl: _serve_agreement(
                f"sharded {impl}", bundle, reqs, toks[impl])
                for impl in toks}
        else:
            rec["first_divergence"] = {
                uid: bf16_divergences(bundle, [p], toks["kernel"][uid][None],
                                      toks["gather"][uid][None], "paged")[0]
                for uid, (p, _) in enumerate(reqs)
                if not np.array_equal(toks["kernel"][uid],
                                      toks["gather"][uid])}
    dist.barrier()
    return rec


def sharded_path(phase, reqs, unsharded):
    """A sharded phase (``SHARDED``): spawn its ranks on this card and
    hold what they return. ``unsharded``: the unsharded engine's record
    of the same requests in this dtype ({"tokens", "launches_per_cycle",
    "ms_per_cycle"})."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    n, dtype = SHARDED[phase]
    entry = ("cascade_phase1_paged_sm90" if dtype == "bfloat16"
             else "cascade_phase1_paged")
    recs = run_ranks(sharded_rank, n, n, dtype, reqs)
    for impl in ("kernel", "gather"):
        if any(r["tokens"][impl] != recs[0]["tokens"][impl] for r in recs):
            fail(f"{phase} {impl}: the ranks' tokens differ")
    for r in recs:
        _layout_gate(f"{phase} rank {r['rank']}", r["layout"], True)
        for impl, info in r["runs"].items():
            where = f"{phase} rank {r['rank']} {impl}"
            counts = info["launches"]
            if info["kv_shards"] != n or info["pool_shard_slots"] * n != \
                    info["pool_pages"] * SERVE_PAGE or info["prefix_hits"] \
                    <= 0 or info["decode_collective_bytes"] != info[
                        "collective_bytes_formula"]:
                fail(f"{where}: mesh stats {info}")
            if impl == "gather":
                if any(counts.values()) or info["sharded_launches"]:
                    fail(f"{where} launched {counts}")
                continue
            per_cycle = info["sharded_launches"] / info["decode_cycles"]
            others = {k: v for k, v in counts.items() if k != entry}
            if counts[entry] != info["sharded_launches"] or any(
                    others.values()) or per_cycle != unsharded[
                        "launches_per_cycle"]:
                fail(f"{where}: #2 launches {counts}, "
                     f"{info['sharded_launches']} with a pos_stride, "
                     f"{per_cycle} a cycle against the unsharded "
                     f"{unsharded['launches_per_cycle']}")
    r0 = recs[0]
    kern = r0["runs"]["kernel"]
    same = {impl: float(np.mean([
        np.array_equal(r0["tokens"][impl][u], unsharded["tokens"][u])
        for u in unsharded["tokens"]])) for impl in ("kernel", "gather")}
    emit({"phase": phase, "ok": True, "dtype": dtype, "ranks": n,
          "page": SERVE_PAGE, "page_loc": SERVE_PAGE // n,
          "layers": SERVE_LAYERS, "gpu": nvidia_smi_line(),
          "ms_per_cycle": kern["ms_per_cycle"],
          "unsharded_ms_per_cycle": unsharded["ms_per_cycle"],
          "merge_ms_per_cycle": kern["merge_ms_per_cycle"],
          "merge_share": kern["merge_ms_per_cycle"] / kern["ms_per_cycle"],
          "collective_bytes_per_cycle": kern["decode_collective_bytes"]
          / kern["decode_cycles"],
          "peak_gib_per_rank": [r["peak_gib"] for r in recs],
          "layout_per_rank": [r["layout"] for r in recs],
          "sharded_launches_per_cycle": kern["sharded_launches"]
          / kern["decode_cycles"],
          "unsharded_launches_per_cycle": unsharded["launches_per_cycle"],
          "tokens_equal_to_unsharded": same,
          "runs": {impl: {k: v for k, v in info.items() if k != "launches"}
                   for impl, info in r0["runs"].items()},
          "near_ties": r0.get("near_ties"),
          "first_divergence": r0.get("first_divergence"),
          "note": "ranks time-share one card",
          "seconds": time.perf_counter() - t0})
    return kern["sharded_launches"] / kern["decode_cycles"]


# --------------------------------------------- the mesh's batch axes --
# phase -> (data, model, dtype): fp32 over data 2 (a rank holds 2 of a
# wave's 4 rows and the whole pool, kv_seq off: #2 unsharded on each
# replica), bf16 over a (2, 2) mesh (2 rows a rank, 32 slots of every
# page: #2 with pos_stride / pos_offset)
DATA = {"data": (2, 1, "float32"), "data_bf16": (2, 2, "bfloat16")}
DATA_NEW = 16        # new tokens a row of the data phase's dense generate
_SERVE_STATS = ("cycles", "tokens", "alpha", "wasted_row_cycles", "refills",
                "installs", "install_calls", "install_traces", "pool_pages",
                "pool_peak_pages", "pool_utilization", "prefix_hits",
                "prefix_misses", "prefix_hit_tokens", "prefill_tokens_saved",
                "cow_copies", "prefix_evictions", "refill_copy_bytes",
                "waves")


def _split_run(state):
    return state.run is not None and state.run.split


class CycleGathers:
    """``serve_run``'s ``in_cycle``: the batch axes' pool-write and
    result gathers inside decode cycles (their calls, the bytes this rank
    sent, host seconds); what ``sharding.WRITES`` holds beyond them is
    the installs'."""

    def __init__(self):
        self.calls, self.bytes, self.write_s, self.result_s = 0, 0, 0.0, 0.0

    @contextlib.contextmanager
    def __call__(self):
        from repro_torch.distributed import sharding as sh
        w, r = sh.WRITES, sh.RESULTS
        c0, b0, s0, t0 = w.calls, w.bytes, w.merge_s, r.merge_s
        yield
        self.calls += w.calls - c0
        self.bytes += w.bytes - b0
        self.write_s += w.merge_s - s0
        self.result_s += r.merge_s - t0


def data_rank(rank, n, phase, reqs):
    """One rank of a batch-axes phase (``DATA``): the serving bundle built
    from the seeds (one rank after another), then the serving requests
    through the engine inside the mesh, a wave's rows split over data
    (request 0's wave of one row is not split), by the kernel path (the
    pool-write, host-result and LSE-merge gathers timed) and the gather
    path; #2 on this rank's live replica at the first split cycle held to
    its plain version (:class:`LiveRead`). The fp32 phase also runs
    ``generate`` on a dense cache over the same mesh, 4 x 512 prompts,
    ``DATA_NEW`` new tokens (#1 on the rank's 2 rows). Rank 0 then holds
    the runs outside the mesh: fp32 to plain greedy by the near-tie rules
    (and runs the unsharded ``generate`` the mesh's is held to), bf16 the
    kernel run to the gather run. Returns this rank's record."""
    import torch.distributed as dist
    from repro_torch.core import pipeline as pl
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import spdecode as sp
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model, dtype = DATA[phase]
    mesh = make_mesh(data, model)
    rules = dict(sh.LOGICAL_RULES, kv_seq="model" if model > 1 else None)

    def build():
        b = build_bundle("float32", layers=SERVE_LAYERS)
        return to_bf16(b) if dtype == "bfloat16" else b

    for i in range(n):
        if i == rank:
            with sh.use_sharding(mesh, rules):
                bundle, layout = stored_bundle(build)
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    paged = casc.cascade_phase1_paged
    counters = (sp.PAYLOAD, sh.WRITES, sh.RESULTS)
    prompts = np.random.default_rng(0).integers(
        0, bundle.target_cfg.vocab_size, size=(4, 512))
    runs, toks, gen = {}, {}, None
    with sh.use_sharding(mesh, rules):
        kv_i, kv_n = sp.kv_seq_index(), sp.kv_seq_shards()
        for impl in ("kernel", "gather"):
            _zero_launches()
            paged.sharded_launches = 0
            for c in counters:
                c.reset()
                c.timed = impl == "kernel"
            batches, splits, live = [], [], LiveRead(when=_split_run)
            gathers = CycleGathers()
            weights = WeightGathers(gathers)

            def snoop(eng, state):
                batches.append(state.batch)
                splits.append(_split_run(state))
                if impl == "kernel":
                    live(eng, state)

            state_bytes = StateBytes(snoop)
            eng, toks[impl], info = serve_run(
                pl.with_attn_impl(bundle, impl), reqs, f"{phase}_{impl}",
                snoop=state_bytes, in_cycle=weights, cache_impl="paged",
                page_size=SERVE_PAGE, pool_pages=SERVE_POOL,
                prefix_cache=True)
            if impl == "kernel":
                layout.update(state_bytes.rec, **weights.per_cycle(
                    info["decode_cycles"]))
            for c in counters:
                c.timed = False
            st, cyc = eng.stats, info["decode_cycles"]
            # the gathers a cycle of a split wave (request 0's wave of
            # one row splits nothing), and the installs' apart
            n_split = max(sum(splits), 1)
            info.update(
                launches=_launches(), sharded_launches=paged.sharded_launches,
                batch_shards=eng.batch_shards, kv_shards=st["kv_shards"],
                split_cycles=sum(splits),
                decode_collective_bytes=st["decode_collective_bytes"],
                collective_bytes_formula=_merge_bytes(bundle, batches)
                if kv_n > 1 else 0,
                write_gathers=sh.WRITES.calls,
                cycle_write_gathers=gathers.calls,
                write_bytes_per_cycle=gathers.bytes / n_split,
                write_ms_per_cycle=1e3 * gathers.write_s / n_split,
                install_write_bytes=sh.WRITES.bytes - gathers.bytes,
                install_write_ms=1e3 * (sh.WRITES.merge_s
                                        - gathers.write_s),
                result_gathers=sh.RESULTS.calls,
                results_ms_per_cycle=1e3 * gathers.result_s / n_split,
                merge_ms_per_cycle=1e3 * sp.PAYLOAD.merge_s / cyc)
            if impl == "kernel":
                info["live_read"] = live.check(f"{phase} rank {rank}",
                                               bundle, kv_i, kv_n)
            runs[impl] = info
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        if phase == "data":
            _zero_launches()
            gtoks, ginfo = run_generate(bundle, prompts, "kernel", "dense",
                                        max_new=DATA_NEW)
            gen = {"tokens": gtoks.tolist(), **ginfo,
                   "launches": _launches()}
    rec = {"rank": rank, "runs": runs, "generate": gen, "layout": layout,
           "tokens": {impl: {u: t.tolist() for u, t in tk.items()}
                      for impl, tk in toks.items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del bundle
    _free()
    if rank == 0:
        # single-rank plain forwards and runs, outside the mesh, on the
        # whole bundle built again from the seeds
        bundle = build()
        if dtype == "float32":
            rec["near_ties"] = {impl: _serve_agreement(
                f"{phase} {impl}", bundle, reqs, toks[impl])
                for impl in toks}
            _zero_launches()
            rtoks, rinfo = run_generate(bundle, prompts, "kernel", "dense",
                                        max_new=DATA_NEW)
            rinfo["launches"] = _launches()
            ref, gaps = greedy_reference(
                bundle.target_params, bundle.target_cfg,
                torch.as_tensor(prompts, device=DEVICE), DATA_NEW)
            rec["generate_ref"] = {"tokens": rtoks.tolist(), **rinfo}
            rec["generate_near_ties"] = {
                "mesh": agreement(f"{phase} generate", np.asarray(
                    gen["tokens"]), ref, gaps),
                "unsharded": agreement(f"{phase} unsharded generate",
                                       rtoks, ref, gaps)}
        else:
            rec["first_divergence"] = {
                uid: bf16_divergences(bundle, [p], toks["kernel"][uid][None],
                                      toks["gather"][uid][None], "paged")[0]
                for uid, (p, _) in enumerate(reqs)
                if not np.array_equal(toks["kernel"][uid],
                                      toks["gather"][uid])}
    dist.barrier()
    return rec


def data_path(phase, reqs, unsharded):
    """A batch-axes phase (``DATA``): spawn its ranks on this card and
    hold what they return. ``unsharded``: the unsharded engine's record
    of the same requests in this dtype ({"tokens", "launches_per_cycle",
    "ms_per_cycle"}, and in fp32 "stats": the run's record). Returns the
    kernel run's #2 launches a
    cycle and (fp32) the dense generate's #1 launches a cycle."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    data, model, dtype = DATA[phase]
    n = data * model
    sfx = "_sm90" if dtype == "bfloat16" else ""
    entry = "cascade_phase1_paged" + sfx
    recs = run_ranks(data_rank, n, n, phase, reqs)
    for impl in ("kernel", "gather"):
        if any(r["tokens"][impl] != recs[0]["tokens"][impl] for r in recs):
            fail(f"{phase} {impl}: the ranks' tokens differ")
    for r in recs:
        _layout_gate(f"{phase} rank {r['rank']}", r["layout"], model > 1)
        for impl, info in r["runs"].items():
            where = f"{phase} rank {r['rank']} {impl}"
            counts = info["launches"]
            if info["batch_shards"] != data or info["kv_shards"] != model \
                    or info["split_cycles"] <= 0 \
                    or info["cycle_write_gathers"] != info["split_cycles"] \
                    or info["prefix_hits"] <= 0 \
                    or info["decode_collective_bytes"] != info[
                        "collective_bytes_formula"]:
                fail(f"{where}: mesh stats {info}")
            if impl == "gather":
                if any(counts.values()) or info["sharded_launches"]:
                    fail(f"{where} launched {counts}")
                continue
            per_cycle = counts[entry] / info["decode_cycles"]
            others = {k: v for k, v in counts.items() if k != entry}
            pos = info["sharded_launches"]
            if any(others.values()) or per_cycle != unsharded[
                    "launches_per_cycle"] or pos != (counts[entry]
                                                     if model > 1 else 0):
                fail(f"{where}: #2 launches {counts}, {pos} with a "
                     f"pos_stride, {per_cycle} a cycle against the "
                     f"unsharded {unsharded['launches_per_cycle']}")
    r0 = recs[0]
    kern = r0["runs"]["kernel"]
    same = {impl: float(np.mean([
        np.array_equal(r0["tokens"][impl][u], unsharded["tokens"][u])
        for u in unsharded["tokens"]])) for impl in ("kernel", "gather")}
    # fp32: the serving phase's prefix_kernel run is the same engine on
    # the same requests (bf16's unsharded runs replay a trace)
    stats_diff = None if dtype != "float32" else {
        k: (kern[k], unsharded["stats"][k]) for k in _SERVE_STATS
        if kern[k] != unsharded["stats"][k]}
    if same["kernel"] == 1.0 and stats_diff:
        fail(f"{phase}: the stats leave the unsharded engine's: "
             f"{stats_diff}")
    gen = None
    if r0["generate"] is not None:
        ref = r0["generate_ref"]
        g_cyc = {r["rank"]: r["generate"]["launches"]["cascade_phase1"]
                 / r["generate"]["cycles"] for r in recs}
        ref_cyc = ref["launches"]["cascade_phase1"] / ref["cycles"]
        if any(r["generate"]["tokens"] != r0["generate"]["tokens"]
               for r in recs) or any(v != ref_cyc for v in g_cyc.values()) \
                or any(sum(v for k, v in r["generate"]["launches"].items()
                           if k != "cascade_phase1") for r in recs):
            fail(f"{phase} generate: launches {g_cyc} a cycle against the "
                 f"unsharded {ref_cyc}, or the ranks' tokens differ")
        gen = {"ms_per_cycle": r0["generate"]["ms_per_cycle"],
               "unsharded_ms_per_cycle": ref["ms_per_cycle"],
               "cycles": r0["generate"]["cycles"],
               "unsharded_cycles": ref["cycles"],
               "launches_per_cycle": g_cyc[0],
               "unsharded_launches_per_cycle": ref_cyc,
               "tokens_equal_to_unsharded": r0["generate"]["tokens"]
               == ref["tokens"],
               "near_ties": {k: v for k, v in r0[
                   "generate_near_ties"].items() if v}}
    emit({"phase": phase, "ok": True, "dtype": dtype, "mesh": [data, model],
          "ranks": n, "rows_a_rank": SERVE_BATCH // data,
          "layers": SERVE_LAYERS, "gpu": nvidia_smi_line(),
          "ms_per_cycle": kern["ms_per_cycle"],
          "unsharded_ms_per_cycle": unsharded["ms_per_cycle"],
          # a cycle of a split wave; the installs' gathers apart
          "write_gather_bytes_per_cycle": kern["write_bytes_per_cycle"],
          "write_gather_ms_per_cycle": kern["write_ms_per_cycle"],
          "install_write_gathers": kern["write_gathers"]
          - kern["cycle_write_gathers"],
          "install_write_bytes": kern["install_write_bytes"],
          "install_write_ms": kern["install_write_ms"],
          "results_gather_ms_per_cycle": kern["results_ms_per_cycle"],
          "merge_ms_per_cycle": kern["merge_ms_per_cycle"],
          "peak_gib_per_rank": [r["peak_gib"] for r in recs],
          "layout_per_rank": [r["layout"] for r in recs],
          "launches_per_cycle": kern["launches"][entry]
          / kern["decode_cycles"],
          "unsharded_launches_per_cycle": unsharded["launches_per_cycle"],
          "tokens_equal_to_unsharded": same,
          "stats_differ_from_unsharded": stats_diff,
          "live_read": {r["rank"]: r["runs"]["kernel"]["live_read"]
                        for r in recs},
          "generate": gen,
          "runs": {impl: {k: v for k, v in info.items() if k != "launches"}
                   for impl, info in r0["runs"].items()},
          "near_ties": r0.get("near_ties"),
          "first_divergence": r0.get("first_divergence"),
          "note": "ranks time-share one card",
          "seconds": time.perf_counter() - t0})
    return {"paged": kern["launches"][entry] / kern["decode_cycles"],
            "dense": gen["launches_per_cycle"] if gen else None}


# ------------------------------------------------------------------ main --
def _timing_keys(t):
    return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}


# ------------------------------------------------------ recurrent targets --
# phase -> (arch, prompt length of each row, new tokens a row, layers):
# the hybrid's prompts are ragged and long enough that every row's rolling
# local buffers (window 2048) wrap during its 32 new tokens; the ssm
# phase is cut to 16 (its eager fp32 cycle is host-bound, about 230 ms).
# Both run at full width cut in depth (recurrentgemma-2b 8 of 26 layers:
# 2 of its 8 local layers; rwkv6-1.6b 6 of 24), which pays for the
# train_archs phase within the run's time limit; serving_recurrent
# serves the hybrid at the same depth
RECURRENT = {"hybrid": ("recurrentgemma-2b", (2020, 2027, 2034, 2041), 32,
                        8),
             "ssm": ("rwkv6-1.6b", (512, 512, 512, 512), 16, 6)}


def recurrent_bundle(arch, layers=None):
    """fp32 full-width ``arch`` (cut to ``layers`` layers when given) with
    random seeded weights and two production drafters, d2sd at gamma 16,
    K 4."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.config.registry import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import drafter_init
    from repro_torch.launch.steps import production_drafter
    from repro_torch.models import lm
    tcfg = get_config(arch)
    tcfg = dataclasses.replace(tcfg, dtype="float32",
                               num_layers=layers or tcfg.num_layers)
    dcfg = dataclasses.replace(production_drafter(tcfg, gamma=GAMMA),
                               dtype="float32")
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
    arch, lens, max_new, layers = RECURRENT[phase]
    bundle = recurrent_bundle(arch, layers)
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
    arch, _, _, layers = RECURRENT["hybrid"]
    bundle = recurrent_bundle(arch, layers)
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
ARCH_PROMPT, ARCH_NEW = 512, 8    # 4 prompts a phase, tokens a row (16
                                  # before the dryrun phases)
# full width; depth cut where one card cannot hold the model:
# grok-1-314b 4.92e9 parameters a layer and 1.61e9 in the embedding and
# head (fp32 2 layers: 45.8 GB; bf16 4 layers: 42.6 GB); kimi-k2's 384
# experts 16.9e9 a layer (bf16 1 layer: about 39 GB); internlm2-20b
# 79 GB in fp32 at its 48 layers. The dense archs run at about half
# their depth or less (internlm2-20b 8 of 48), which pays for the
# train_archs phase within the run's time limit; the cross-attention
# targets at half their decoder depth (llama-3.2-vision-11b 20 of 40, 4
# of its 8 cross layers; whisper-medium's decoder 12 of 24, its encoder
# whole), which pays for the study and distill_full phases
GROK_LAYERS, GROK_BF16_LAYERS, KIMI_LAYERS = 2, 4, 1
CTX_ARCHS = (("llama-3.2-vision-11b", 20), ("whisper-medium", 12))
DENSE_ARCHS = (("qwen2.5-3b", 18), ("gemma2-2b", 13),
               ("stablelm-3b", 16), ("internlm2-20b", 8))


def arch_bundle(arch, dtype, layers=None, mesh=None):
    """``arch`` at full width (cut to ``layers`` when given) in ``dtype``
    with random seeded weights and two drafters by JAX's
    ``production_drafter`` rule, d2sd at gamma 16, K 4. A MoE's expert
    stacks are drawn straight into ``dtype`` (``param_dtype``); the other
    weights are drawn in fp32 and, for bf16, cast in place (the target's
    before the drafters are drawn). ``mesh``: a MoE target keeps only
    this rank's part of each expert stack (``lm_init(expert_part=)``:
    every expert drawn, the rest dropped). Returns (bundle, the encoder's
    params or None)."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.config.registry import get_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import drafter_init
    from repro_torch.distributed import ep
    from repro_torch.launch.steps import production_drafter
    from repro_torch.models import encdec, lm
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                              num_layers=layers or cfg.num_layers)
    dcfg = dataclasses.replace(production_drafter(cfg, gamma=GAMMA),
                               dtype=dtype)
    enc = None
    if cfg.is_encoder_decoder:
        both = encdec.encdec_init(cfg, seed=0, device=DEVICE)
        enc, tp = both["encoder"], both["decoder"]
    else:
        tp = lm.lm_init(cfg, seed=0, device=DEVICE, expert_part=(
            None if mesh is None else ep.mesh_expert_part(cfg, mesh)))
    if dtype == "bfloat16":
        cast_bf16_(tp)
        torch.cuda.empty_cache()
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
    (``moe._capacity``, ``_positions``; inside an experts mesh, expert
    parallelism's own capacity ``ep.ep_capacity`` of the rank's tokens)
    what each MoE pass did, kept on the card: by the pass's token count
    (the prefill's B x P, a verify pass's B x n_tree) the passes, (token,
    expert) pairs and dropped pairs, over all experts (every rank routes
    every token). The program keeps no such record."""

    def __enter__(self):
        from repro_torch.distributed import ep
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.moe_apply
        self.counts = {}

        def probed(p, x, cfg, dispatch=None):
            m = cfg.moe
            x2 = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(x2.float() @ p["router"].float(), -1)
            idx = torch.topk(probs, m.top_k, dim=-1).indices
            cap = (ep.ep_capacity(x2.shape[0], cfg) if ep.ep_available(cfg)
                   else moe._capacity(x2.shape[0], cfg))
            keep = moe._positions(idx, m.num_experts) < cap
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
    cycle by model, dtype and cache, and the no-drop run's plain greedy
    reference ({"layers", "tokens", "gaps"}: the ``ep`` phase's)."""
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
    nodrop_ref = {"layers": cfg.num_layers, "tokens": ref, "gaps": gaps}
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
    return launches, nodrop_ref


# ------------------------------------------------- expert parallelism --
# phase -> (ranks, dtype, arch, layers, prompt seed): grok-1 fp32 over 2
# ranks (4 of its 8 experts a rank) at the moe phase's depth and prompts;
# kimi-k2 bf16 over 4 (96 of 384 experts a rank, the shared expert on
# every rank) at 1 of 61 layers. Every rank holds its part of the expert
# stacks and a whole copy of everything else, on the one card; kv_seq
# shards the pools over the same axis (page 64: 32 or 16 slots a rank)
EP = {"ep": (2, "float32", "grok-1-314b", GROK_LAYERS, 21),
      "ep_bf16": (4, "bfloat16", "kimi-k2-1t-a32b", KIMI_LAYERS, 22)}
EP_NEW = 6      # new tokens a request (the moe phase's first ARCH_NEW: time;
                # 8 before the dryrun phases)


class CycleReduces:
    """Inside each decode cycle (``serve_run(in_cycle=)``): the EP
    all-reduces timed after a synchronize (``ep.REDUCES.timed``), their
    calls, bytes and host seconds kept apart from the installs'."""

    def __init__(self):
        self.calls = self.bytes = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def __call__(self):
        from repro_torch.distributed import ep
        r = ep.REDUCES
        before = (r.calls, r.bytes, r.merge_s)
        r.timed = True
        try:
            yield
        finally:
            r.timed = False
            self.calls += r.calls - before[0]
            self.bytes += r.bytes - before[1]
            self.seconds += r.merge_s - before[2]


def _first_divergences(bundle, reqs, kt, gt):
    """Each request's first divergence of the kernel run from the gather
    run ({uid: record}) with the near-tie measure of its dtype: fp32, the
    top-2 gap there of a teacher-forced plain forward over the gather
    run's tokens (``greedy_gaps``; ``_serve_agreement``'s rule: a tie
    below NEAR_TIE); bf16, ``bf16_divergences``' gap in bf16 ulps (a tie
    below NEAR_TIE_BF16_ULPS) and its one-step read shift. Inside an
    experts mesh every rank runs the forwards (collectives)."""
    uids = [u for u in range(len(reqs)) if not np.array_equal(kt[u], gt[u])]
    if bundle.target_cfg.dtype == "bfloat16":
        return {u: dict(rec, tie=rec["ulps"] < NEAR_TIE_BF16_ULPS)
                for u in uids for rec in bf16_divergences(
                    bundle, [reqs[u][0]], kt[u][None], gt[u][None], "paged",
                    gate=False)}
    out = {}
    for u, (_, gaps) in zip(uids, greedy_gaps(
            bundle, [reqs[u] for u in uids], [gt[u] for u in uids])):
        j = int(np.nonzero(kt[u] != gt[u])[0][0])
        out[u] = {"pos": j, "ref_top2_gap": float(gaps[0, j]),
                  "tie": float(gaps[0, j]) < NEAR_TIE}
    return out


class LiveRead:
    """A snoop for ``serve_run``: at the first decode cycle, this rank's
    layer-0 pools (its run of every page), the page table and the
    lengths; :meth:`check` then holds #2 on them, with this rank's
    ``pos_stride`` / ``pos_offset``, to its plain version at the verify
    shape (random queries in the model's dtype) under the kernels
    phase's gates."""

    def __init__(self, when=None):
        self.snap = None
        self.when = when        # a state predicate (default: the first)

    def __call__(self, eng, state):
        if self.snap is None and (self.when is None or self.when(state)):
            layer = state.target["layers"][0]
            self.snap = {"k": layer["k"].clone(), "v": layer["v"].clone(),
                         "pt": state.d1_feat["pt"].clone(),
                         "len": state.length.clone()}

    def check(self, where, bundle, rank, n):
        from repro_torch.kernels import cascade_attention as casc
        from repro_torch.kernels.cascade_cases import TOL_FLASH, TOL_PART
        s, cfg = self.snap, bundle.target_cfg
        dt = getattr(torch, cfg.dtype)
        b, tq = s["pt"].shape[0], GAMMA + K_BRANCHES * (GAMMA - 1)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(3)
        q = torch.randn((b, tq, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=DEVICE).to(dt).transpose(1, 2)
        args = (q, s["k"].transpose(1, 2), s["v"].transpose(1, 2), s["pt"])
        kw = dict(cache_len=s["len"], q_abs=s["len"][:, None].long()
                  + torch.arange(tq, device=DEVICE),
                  scale=cfg.head_dim ** -0.5, pos_stride=SERVE_PAGE,
                  pos_offset=rank * (SERVE_PAGE // n))
        kern = casc.cascade_phase1_paged(*args, **kw)
        plain = casc.cascade_phase1_paged_plain(*args, **kw)
        live = plain[1] > -1e29
        if dt == torch.bfloat16:
            acc = (kern[0] - plain[0]).abs().amax(-1) / plain[0].abs().amax(
                -1).clamp_min(1e-30)
        else:
            acc = ((kern[0] - plain[0]).abs() / (1 + plain[0].abs())).amax(-1)
        err = {"acc": acc[live].max().item() if live.any() else 0.0,
               "m_l": max(((a - p).abs() / (1 + p.abs()))[live].max().item()
                          if live.any() else 0.0
                          for a, p in zip(kern[1:], plain[1:])),
               "live_splits": int(live.sum()), "rows": b, "tq": tq,
               "pos_offset": kw["pos_offset"]}
        tol = TOL_FLASH[dt] if dt == torch.bfloat16 else TOL_PART
        if err["acc"] > tol or err["m_l"] > TOL_PART:
            fail(f"{where}: #2 on this rank's live pools is off its plain "
                 f"version: {err}")
        return err


# the EP layer on the card against a plain fp32 sum of the same experts
# (EpLayerHold), max |error| over max |plain|: fp32, the products' orders
# of summation differ; bf16, a pair's output takes 6 roundings (three
# products, the activation, the gated product, the gate's), a token's sum
# 7 adds of its pairs and 3 of the all-reduce: 16 roundings at bf16's
# unit roundoff 2^-9. A wrong expert part, combine or all-reduce moves
# the output by an expert's share of it
TOL_EP_LAYER = {"float32": 1e-4, "bfloat16": 16 * 2.0 ** -9}


class EpLayerHold:
    """While installed: the hidden state entering the first MoE pass of
    ``n_tokens`` tokens (a verify pass of the live run, this rank's copy)
    and that layer's params. :meth:`check` then runs the program's EP
    layer (``ep.moe_apply_ep``) on it and holds it to :func:`plain_ep_sum`
    of the same experts at ``TOL_EP_LAYER``, on every rank."""

    def __init__(self, n_tokens):
        self.n, self.snap = n_tokens, None

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.moe_apply

        def probed(p, x, cfg, dispatch=None):
            if self.snap is None and x.shape[0] * x.shape[1] == self.n:
                self.snap = (p, x.detach().clone())
            return self.real(p, x, cfg, dispatch)

        moe.moe_apply = probed
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.real

    def check(self, where, cfg, mesh):
        from repro_torch.distributed import ep
        if self.snap is None:
            fail(f"{where}: no MoE pass of {self.n} tokens to hold")
        p, x = self.snap
        with torch.no_grad():
            got = ep.moe_apply_ep(p, x, cfg).float()
            want = plain_ep_sum(p, x, cfg, mesh)
        err = ((got - want).abs().max() / want.abs().max()).item()
        rec = {"rel_err": err, "tol": TOL_EP_LAYER[cfg.dtype],
               "tokens": self.n, "max_abs": want.abs().max().item()}
        if not err <= rec["tol"]:
            fail(f"{where}: the EP layer is off a plain fp32 sum of the "
                 f"same experts: {rec}")
        return rec


def plain_ep_sum(p, x, cfg, mesh):
    """The routed experts' output [B, T, d] in fp32, written out plainly:
    fp32 routing (softmax, top-k, gates renormalised), each expert's queue
    in row-major (token, choice) order cut at EP's capacity max(8, int(T k
    / E cf) + 1), and for each of this rank's experts (E / M of them from
    rank r E / M, the stacks ``p`` holds) its products in fp32 on its kept
    tokens, gate-weighted into the output; the ranks' sums all-reduced in
    fp32 over "model"."""
    import torch.distributed as dist
    from repro_torch.models.layers import act_fn
    m, d = cfg.moe, cfg.d_model
    x2 = x.reshape(-1, d).float()
    n = x2.shape[0]
    g, idx = torch.topk(torch.softmax(x2 @ p["router"].float(), -1),
                        m.top_k, dim=-1)
    g = g / g.sum(-1, keepdim=True)
    cap = max(8, int(n * m.top_k / m.num_experts * m.capacity_factor) + 1)
    ranks, rank = mesh.size("model"), mesh.index("model")
    e_loc = m.num_experts // ranks
    if e_loc * ranks != m.num_experts or p["moe_w_in"].shape[0] != e_loc:
        fail(f"plain_ep_sum: {m.num_experts} experts over {ranks} ranks")
    act = act_fn(cfg.mlp_act)
    y = torch.zeros_like(x2)
    for j in range(e_loc):
        tok, choice = (idx == rank * e_loc + j).nonzero(as_tuple=True)
        tok, choice = tok[:cap], choice[:cap]
        if tok.numel() == 0:
            continue
        xe = x2[tok]
        h = xe @ p["moe_w_in"][j].float()
        if cfg.mlp_gated:
            h = act(xe @ p["moe_w_gate"][j].float()) * h
        else:
            h = act(h)
        y.index_add_(0, tok, g[tok, choice, None]
                     * (h @ p["moe_w_out"][j].float()))
    mesh.all_reduce_(y, dist.ReduceOp.SUM, "model")
    return y.reshape(x.shape)


def ep_rank(rank, n, phase, nodrop_ref):
    """One rank of an EP phase: the target built from the seeds with this
    rank's part of the expert stacks (one rank after another), then the
    moe phase's four prompts as engine requests of ``EP_NEW`` new tokens
    (one wave, page 64, the prefix cache) inside the ``(1, n)`` mesh,
    kv_seq and experts on "model": the kernel and gather paths at the
    config's capacity factor, and for fp32 the kernel path at E/k. Every
    rank (the plain forwards and the EP layer are collective) holds #2
    on its live pools to the plain version (:class:`LiveRead`) and the
    EP layer on the kernel
    run's first verify pass to a plain fp32 sum of the same experts
    (:class:`EpLayerHold`); in fp32 the kernel run to the gather run by
    the near-tie rule and the no-drop run to plain greedy. bf16's first
    divergences of the kernel run from the gather run are recorded with
    their gaps in bf16 ulps and not held: they part on gaps wider than
    the rule's (PERF.md, PR 27); bf16 also runs the pair with the kv_seq
    axis off, whose divergences are recorded beside them (a witness that
    parts the sharded read from the rest). Returns this rank's record."""
    import torch.distributed as dist
    from repro_torch.core import pipeline as pl
    from repro_torch.distributed import ep
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import spdecode as sp
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dtype, arch, layers, seed = EP[phase]
    mesh = make_mesh(1, n)
    paged = casc.cascade_phase1_paged
    with sh.use_sharding(mesh, dict(sh.LOGICAL_RULES, kv_seq="model")):
        t0 = time.perf_counter()
        for i in range(n):
            if i == rank:
                bundle, layout = stored_bundle(lambda: arch_bundle(
                    arch, dtype, layers, mesh=mesh)[0])
                torch.cuda.empty_cache()
            dist.barrier()
        build_s = time.perf_counter() - t0
        cfg = bundle.target_cfg
        expert_bytes = sum(w.numel() * w.element_size()
                           for lp in bundle.target_params["layers"]
                           for k, w in lp["ffn"].items()
                           if k.startswith("moe_w_"))
        sm90 = dtype == "bfloat16"
        sfx = "_sm90" if sm90 else ""
        want = _want_launches(bundle, "paged", sm90)
        reqs = [(p.astype(np.int32), EP_NEW)
                for p in _arch_prompts(cfg, seed)]
        nodrop = dataclasses.replace(bundle, target_cfg=dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts
                / cfg.moe.top_k)))
        # (run, bundle, kv_seq on): bf16 adds the same EP engine with the
        # pools replicated (kv_seq off: every read through the unsharded
        # #2 or the gather), the witness that parts the EP layer from the
        # sharded read
        plan = [("kernel", bundle, True), ("gather", bundle, True)]
        if phase == "ep":
            plan.append(("kernel_nodrop", nodrop, True))
        else:
            plan += [("kernel_kvoff", bundle, False),
                     ("gather_kvoff", bundle, False)]
        torch.cuda.reset_peak_memory_stats()
        runs, toks = {}, {}
        live = LiveRead()
        verify_rows = SERVE_BATCH * (GAMMA + K_BRANCHES * (GAMMA - 1))
        layer_hold = EpLayerHold(verify_rows)
        for name, b, kv in plan:
            impl = name.split("_")[0]
            _zero_launches()
            paged.sharded_launches = 0
            sp.PAYLOAD.reset()
            sp.PAYLOAD.timed = impl == "kernel"
            ep.REDUCES.reset()
            red = WeightGathers(CycleReduces())
            state_bytes = StateBytes(live if name == "kernel" else None)
            with sh.use_sharding(mesh, dict(
                    sh.LOGICAL_RULES, kv_seq="model" if kv else None)), \
                    MoeProbe() as probe, (
                        layer_hold if name == "kernel"
                        else contextlib.nullcontext()):
                eng, toks[name], info = serve_run(
                    pl.with_attn_impl(b, impl), reqs, f"{phase}_{name}",
                    snoop=state_bytes, first_alone=False, in_cycle=red,
                    cache_impl="paged", page_size=SERVE_PAGE,
                    prefix_cache=True)
            sp.PAYLOAD.timed = False
            cycles = info["decode_cycles"]
            if name == "kernel":
                layout.update(state_bytes.rec, **red.per_cycle(cycles))
            red = red.inner
            drops = probe.drops()
            info.update(
                launches=_launches(), sharded_launches=paged.sharded_launches,
                kv_shards=eng.stats["kv_shards"], kv_seq=kv,
                merge_ms_per_cycle=1e3 * sp.PAYLOAD.merge_s / cycles,
                ep_reduce_ms_per_cycle=1e3 * red.seconds / cycles,
                ep_reduces_per_cycle=red.calls / cycles,
                ep_reduce_bytes_per_cycle=red.bytes / cycles,
                ep_reduces_all_passes=ep.REDUCES.calls, drops=drops,
                dropped_per_cycle=drops.get(str(verify_rows), {}).get(
                    "dropped", 0) / cycles)
            runs[name] = info
            del eng
            _free()
        peak = torch.cuda.max_memory_allocated()
        where = f"{phase} rank {rank}"
        holds = {"live_read": live.check(where, bundle, rank, n),
                 "ep_layer": layer_hold.check(where, cfg, mesh),
                 "kernel_vs_gather": _first_divergences(
                     bundle, reqs, toks["kernel"], toks["gather"])}
        if "kernel_kvoff" in toks:
            with sh.use_sharding(mesh, dict(sh.LOGICAL_RULES, kv_seq=None)):
                holds["kvoff_kernel_vs_gather"] = _first_divergences(
                    bundle, reqs, toks["kernel_kvoff"], toks["gather_kvoff"])
        if dtype == "float32":
            # fp32: a first divergence passes only on a near tie
            wide = {u: r for u, r in holds["kernel_vs_gather"].items()
                    if not r["tie"]}
            if wide:
                fail(f"{where}: the kernel run leaves the gather run on a "
                     f"wide gap: {wide}")
            if nodrop_ref["layers"] != cfg.num_layers:
                # plain greedy at this depth, inside the mesh: one-token
                # passes and a prefill at E/k drop nothing either way
                nodrop_ref = dict(zip(("tokens", "gaps"), greedy_reference(
                    nodrop.target_params, nodrop.target_cfg, torch.as_tensor(
                        np.stack([p for p, _ in reqs]), device=DEVICE),
                    EP_NEW)))
            holds["nodrop_vs_greedy"] = agreement(
                f"{phase} rank {rank} no-drop",
                np.stack([toks["kernel_nodrop"][u]
                          for u in range(len(reqs))]),
                nodrop_ref["tokens"][:, :EP_NEW],
                nodrop_ref["gaps"][:, :EP_NEW])
        dist.barrier()
    return {"rank": rank, "runs": runs, "holds": holds, "layout": layout,
            "want": want[f"cascade_phase1_paged{sfx}"], "entry":
            f"cascade_phase1_paged{sfx}", "layers": cfg.num_layers,
            "tokens": {k: {u: t.tolist() for u, t in v.items()}
                       for k, v in toks.items()},
            "peak_gib": peak / 2 ** 30, "expert_gib": expert_bytes / 2 ** 30,
            "build_s": build_s}


def ep_path(phase, nodrop_ref):
    """An EP phase (``EP``): spawn its ranks on this card and hold what
    they return: tokens equal across ranks; on every rank the kernel
    runs' #2 launches ``_want_launches`` a cycle, all with a pos_stride
    (none with the kv_seq axis off), with no #1 launch, and the gather
    runs launch nothing. Returns #2's
    launches a cycle with a pos_stride (the kernel run at the config's
    capacity)."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    n, dtype, arch, layers, _ = EP[phase]
    recs = run_ranks(ep_rank, n, n, phase, nodrop_ref)
    r0 = recs[0]
    for r in recs:
        _layout_gate(f"{phase} rank {r['rank']}", r["layout"], True)
    for name in r0["tokens"]:
        if any(r["tokens"][name] != r0["tokens"][name] for r in recs):
            fail(f"{phase} {name}: the ranks' tokens differ")
    for r in recs:
        for name, info in r["runs"].items():
            where = f"{phase} rank {r['rank']} {name}"
            counts = info["launches"]
            if info["kv_shards"] != (n if info["kv_seq"] else 1):
                fail(f"{where}: kv_shards {info['kv_shards']}")
            if name.startswith("gather"):
                if any(counts.values()) or info["sharded_launches"]:
                    fail(f"{where} launched {counts}")
                continue
            # kv_seq on: every #2 launch carries a pos_stride; off: none
            per_cycle = counts[r["entry"]] / info["decode_cycles"]
            others = {k: v for k, v in counts.items() if k != r["entry"]}
            if info["sharded_launches"] != (
                    counts[r["entry"]] if info["kv_seq"] else 0) or any(
                    others.values()) or per_cycle != r["want"]:
                fail(f"{where}: #2 launches {counts}, "
                     f"{info['sharded_launches']} with a pos_stride, "
                     f"{per_cycle} a cycle against {r['want']}")
    kern = r0["runs"]["kernel"]
    emit({"phase": phase, "ok": True, "dtype": dtype, "arch": arch,
          "ranks": n, "layers": r0["layers"], "max_new": EP_NEW,
          "page": SERVE_PAGE,
          "page_loc": SERVE_PAGE // n, "gpu": nvidia_smi_line(),
          "ms_per_cycle": kern["ms_per_cycle"],
          "ep_reduce_ms_per_cycle": kern["ep_reduce_ms_per_cycle"],
          "ep_reduces_per_cycle": kern["ep_reduces_per_cycle"],
          "ep_reduce_bytes_per_cycle": kern["ep_reduce_bytes_per_cycle"],
          "merge_ms_per_cycle": kern["merge_ms_per_cycle"],
          "dropped_per_cycle": kern["dropped_per_cycle"],
          "peak_gib_per_rank": [r["peak_gib"] for r in recs],
          "layout_per_rank": [r["layout"] for r in recs],
          "expert_gib_per_rank": [r["expert_gib"] for r in recs],
          "build_s_per_rank": [r["build_s"] for r in recs],
          "ep_launches_per_cycle": kern["sharded_launches"]
          / kern["decode_cycles"],
          "want_launches_per_cycle": r0["want"],
          "runs": {name: {k: v for k, v in info.items() if k != "launches"}
                   for name, info in r0["runs"].items()},
          "holds": r0["holds"],
          "live_read_per_rank": [r["holds"]["live_read"] for r in recs],
          "ep_layer_per_rank": [r["holds"]["ep_layer"] for r in recs],
          "note": "ranks time-share one card",
          "seconds": time.perf_counter() - t0})
    return kern["sharded_launches"] / kern["decode_cycles"]


def ctx_path():
    """llama-3.2-vision-11b (20 of 40 layers: 4 cross layers over 1601
    random vision tokens) and whisper-medium (24 encoder layers over
    1500 random frames, then 12 of the 24 decoder layers reading the
    encoder's output), full width, fp32: ``generate(ctx=)`` through the kernel path on paged and dense
    caches and the gather path (paged), held to each other and to plain
    greedy (a prefill with ``ctx``, then one-token steps that read the
    cross caches). Returns launches a cycle by model."""
    from repro_torch.launch.steps import ctx_len_for
    from repro_torch.models import encdec
    from repro_torch.models.blocks import layer_specs
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    recs, launches = {}, {}
    for seed, (arch, layers) in enumerate(CTX_ARCHS):
        bundle, enc = arch_bundle(arch, "float32", layers)
        cfg = bundle.target_cfg
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(31 + seed)
        feats = torch.randn((4, ctx_len_for(cfg), cfg.d_model),
                            generator=gen, device=DEVICE)
        rec = {"layers": cfg.num_layers, "params": cfg.param_count(),
               "ctx_len": feats.shape[1]}
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
    """qwen2.5-3b, gemma2-2b, stablelm-3b and internlm2-20b at full width
    cut in depth (``DENSE_ARCHS``), fp32, paged: the kernel path held to
    the gather path and plain greedy, launches a cycle exact (gemma2-2b:
    #1 on its 7 local layers' rolling buffers, #2 at head_dim 256 on its
    6 global layers). Returns launches a cycle by model."""
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
          "cuts": {arch: layers for arch, layers in DENSE_ARCHS},
          "models": recs,
          "launches_per_cycle": launches,
          "seconds": time.perf_counter() - t0})
    return launches


# ------------------------------------------------------------------ study --
# The held-out decode of benchmarks/common.py::measure: prompts of 48
# tokens a task from seed 777 at offset 5e6, gamma from the study, K 4;
# 8 prompts of 24 new tokens (12 of 96 there; 12 of 48 before the dryrun
# phases took the time)
STUDY_PROMPTS, STUDY_PROMPT_LEN, STUDY_NEW = 8, 48, 24
STUDY_SEED, STUDY_OFFSET, STUDY_K = 777, 5 * 10 ** 6, 4
STUDY_METHODS = ("d2sd", "dflash", "eagle", "naive_k", "dflash_second")
# the target's pretraining steps and each drafter's (below run_study's
# defaults of 240 and 400: cut for the run's time limit)
STUDY_TARGET_STEPS, STUDY_DRAFTER_STEPS = 120, 150


def study_bundle(method, tcfg, dcfg, dcfg_ar, params, gamma):
    """``benchmarks/common.py::build_bundle``'s bundle of ``method`` over
    the study's weights: eagle drafts with the AR drafter, naive_k and
    dflash_second reuse the DFlash drafter as drafter 2."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.core import pipeline as pl
    spec = SpecConfig(gamma=gamma, top_k_branches=STUDY_K, mode=method)
    d1cfg = dcfg_ar if method == "eagle" else dcfg
    d1 = params["ar"] if method == "eagle" else params["d1"]
    d2 = params["d1"] if method in ("dflash_second", "naive_k") \
        else params["d2"]
    return pl.SpecBundle(tcfg, d1cfg, dcfg, spec, params["target"], d1, d2)


def _falls(name, losses):
    """Finite losses whose mean over the last tenth is below the first
    tenth's; returns the two means."""
    n = max(len(losses) // 10, 1)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    if not np.isfinite(losses).all() or not last < first:
        fail(f"{name}: losses do not fall: first tenth {first}, last "
             f"tenth {last}")
    return {"first_tenth": first, "last_tenth": last}


def _study_runs(bundle, prompts, ref_toks, gaps, where, dense=True):
    """The kernel path on the paged and (``dense``) dense caches and the
    gather path on the paged one (host loop), counts zeroed just before
    each run and read just after: exact cascade launches a cycle, tokens
    held to plain greedy and each kernel run to the gather run. Returns
    the runs' records by (impl, cache) and the near ties that passed."""
    plan = (("kernel", "paged"),) + ((("kernel", "dense"),) if dense
                                     else ()) + (("gather", "paged"),)
    toks, runs, ties = {}, {}, {}
    for impl, cache in plan:
        _zero_launches()
        toks[impl, cache], info = run_generate(bundle, prompts, impl, cache,
                                               max_new=STUDY_NEW)
        counts = _launches()
        if impl == "kernel":
            _launch_check(f"{where} {cache}", counts,
                          _want_launches(bundle, cache), info["cycles"])
            info["launches_per_cycle"] = {
                k: v / info["cycles"] for k, v in counts.items() if v}
        elif any(counts.values()):
            fail(f"{where} gather: cascade launches {counts}")
        runs[f"{impl}/{cache}"] = info
    for (impl, cache), t in toks.items():
        ties[f"{impl}/{cache} vs greedy"] = agreement(where, t, ref_toks,
                                                      gaps)
        if impl == "kernel":
            ties[f"{impl}/{cache} vs gather"] = agreement(
                where, t, toks[("gather", "paged")], gaps)
    return runs, {k: v for k, v in ties.items() if v}


def study_path():
    """``run_study.main`` at its defaults but the steps
    (``STUDY_TARGET_STEPS``, ``STUDY_DRAFTER_STEPS``; the smoke target in
    fp32, drafter_small), then the held-out decode of every method with the
    trained drafters and d2sd with seeded random ones."""
    from repro_torch.core.drafter import drafter_init
    from repro_torch.data.synthetic import TASKS, SyntheticDataset
    from repro_torch.training import run_study
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _zero_flash_launches()
    _zero_launches()
    rec = run_study.main(["--target-steps", str(STUDY_TARGET_STEPS),
                          "--drafter-steps", str(STUDY_DRAFTER_STEPS)])
    flash, casc = _flash_launches(), _launches()
    falls = {"target": _falls("study target", rec["target_losses"])}
    for name, losses in rec["drafter_losses"].items():
        falls[name] = _falls(f"study drafter {name}", losses)
    # smoke(): 4 attention layers, no remat; every pretrain step runs the
    # forward, dq and dk/dv once a layer, every drafter step one teacher
    # forward a layer
    n_t, n_d = rec["target_steps"], rec["drafter_steps"]
    want = {"flash_fwd": 4 * (n_t + 3 * n_d), "flash_bwd_dq": 4 * n_t,
            "flash_bwd_dkv": 4 * n_t}
    if {k: v for k, v in flash.items() if v} != want or any(casc.values()):
        fail(f"study: flash launches {flash} (expected {want}), cascade "
             f"{casc} (expected none: rollouts read through gather)")

    t0 = time.perf_counter()
    tcfg, dcfg, dcfg_ar, params, meta = run_study.load_study(DEVICE)
    gamma = meta["gamma"]
    random = {**params, "d1": drafter_init(dcfg, seed=1, device=DEVICE),
              "d2": drafter_init(dcfg, seed=2, device=DEVICE)}
    alpha, alpha_random, runs, ties = {}, {}, {}, {}
    for task in TASKS:
        prompts = SyntheticDataset(task, 1, 64, seed=STUDY_SEED).prompts(
            STUDY_PROMPTS, STUDY_PROMPT_LEN, offset=STUDY_OFFSET)
        ref_toks, gaps = greedy_reference(
            params["target"], tcfg, torch.as_tensor(prompts, device=DEVICE),
            STUDY_NEW)
        for method in STUDY_METHODS:
            where = f"study {method}/{task}"
            # the dense cache for d2sd alone (the run's time limit)
            r, t = _study_runs(study_bundle(method, tcfg, dcfg, dcfg_ar,
                                            params, gamma),
                               prompts, ref_toks, gaps, where,
                               dense=method == "d2sd")
            runs[where], ties[where] = r, t
            alpha.setdefault(method, {})[task] = r["kernel/paged"]["alpha"]
        rb = study_bundle("d2sd", tcfg, dcfg, dcfg_ar, random, gamma)
        _zero_launches()
        _, info = run_generate(rb, prompts, "kernel", "paged",
                               max_new=STUDY_NEW)
        _launch_check(f"study d2sd/{task} random", _launches(),
                      _want_launches(rb, "paged"), info["cycles"])
        alpha_random[task] = info["alpha"]
        if alpha["d2sd"][task] <= max(1.0, info["alpha"]):
            fail(f"study {task}: d2sd alpha {alpha['d2sd'][task]} with the "
                 f"trained drafters, {info['alpha']} with random ones")
    seconds = {**rec["seconds"], "eval": time.perf_counter() - t0}
    emit({"phase": "study", "ok": True, "dtype": "float32",
          "target": tcfg.name, "drafter_d_model": dcfg.d_model,
          "head_dims": {"target": tcfg.d_model // tcfg.num_heads,
                        "drafter": dcfg.head_dim},
          "args": {k: rec[k] for k in ("gamma", "target_steps",
                                       "drafter_steps", "rollouts")},
          "losses": falls, "seconds": seconds, "flash_launches": flash,
          "flash_launches_per_step": {"pretrain": 4, "teacher": 4},
          "alpha": alpha, "alpha_random_d2sd": alpha_random,
          "near_ties": {k: v for k, v in ties.items() if v},
          "runs": {k: {name: {f: r[f] for f in (
              "cycles", "alpha", "ms_per_cycle", "launches_per_cycle")
              if f in r} for name, r in v.items()} for k, v in runs.items()}})
    first = runs[f"study d2sd/{TASKS[0]}"]
    return {"flash": flash, "cascade_per_cycle": {
        cache: first[f"kernel/{cache}"]["launches_per_cycle"]
        for cache in ("paged", "dense")}}


# -------------------------------------------------- distillation at width --
DISTILL_LAYERS = 6       # paper-target cut in depth (the run's time limit)
DISTILL_ROWS, DISTILL_PROMPT, DISTILL_NEW = 16, 128, 128   # rollouts
DISTILL_STEPS, DISTILL_BATCH = 60, 16    # 100 before the dryrun phases
DISTILL_DECODE = (4, 128, 64)     # rows, prompt, new tokens of the decode


def distill_full():
    """paper-target at full width cut to DISTILL_LAYERS layers, bf16,
    random seeded weights: greedy rollouts, then d1 (DFlash) and d2 (VP)
    for ``production_drafter`` distilled on them with the teacher through
    the bf16 flash forward; then d2sd through the bf16 graph loop (paged)
    with the trained and with random drafters, each held to its gather
    run by the bf16 near-tie rule."""
    from repro_torch.config.base import SpecConfig
    from repro_torch.configs import paper_target
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import drafter_init
    from repro_torch.launch.steps import production_drafter
    from repro_torch.models import lm
    from repro_torch.training import distill
    tcfg = dataclasses.replace(paper_target.full(), num_layers=DISTILL_LAYERS,
                               dtype="bfloat16")
    params = lm.lm_init(tcfg, seed=0, device=DEVICE)
    cast_bf16_(params)
    _free()
    rng = np.random.default_rng(21)
    prompts = rng.integers(0, tcfg.vocab_size, (DISTILL_ROWS,
                                                DISTILL_PROMPT))
    t0 = time.perf_counter()
    rolls = distill.generate_rollouts(params, tcfg, prompts, DISTILL_NEW,
                                      device=DEVICE)
    rollout_s = time.perf_counter() - t0
    dcfg = production_drafter(tcfg, gamma=GAMMA)
    drafters, train = {}, {}
    for name, vp in (("d1", False), ("d2", True)):
        _zero_flash_launches()
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drafters[name], losses = distill.train_drafter(
            dcfg, params, tcfg, rolls, vp=vp, steps=DISTILL_STEPS,
            batch=DISTILL_BATCH, device=DEVICE, log=lambda *_: None)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        flash, casc = _flash_launches(), _launches()
        want = {"flash_fwd_sm90": DISTILL_STEPS * DISTILL_LAYERS}
        if {k: v for k, v in flash.items() if v} != want \
                or any(casc.values()):
            fail(f"distill_full {name}: flash launches {flash} (expected "
                 f"{want}: one teacher pass a step), cascade {casc}")
        train[name] = {"losses": _falls(f"distill_full {name}", losses),
                       "first_loss": losses[0], "last_loss": losses[-1],
                       "seconds": sec, "ms_per_step": 1e3 * sec
                       / DISTILL_STEPS,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "flash_launches": flash}
    n_rows, p_len, n_new = DISTILL_DECODE
    prompts = rng.integers(0, tcfg.vocab_size, (n_rows, p_len))
    spec = SpecConfig(gamma=GAMMA, top_k_branches=K_BRANCHES, mode="d2sd")
    decode = {}
    for label, (p1, p2) in (
            ("trained", (drafters["d1"], drafters["d2"])),
            ("random", (drafter_init(dcfg, seed=1, device=DEVICE),
                        drafter_init(dcfg, seed=2, device=DEVICE)))):
        bundle = to_bf16(pl.SpecBundle(tcfg, dcfg, dcfg, spec, params, p1,
                                       p2))
        want = replay_launches(bundle, "paged")
        # the gather run first: the kernel run, timed, finds the graph
        # path warm
        gt, ginfo = run_generate(bundle, prompts, "gather", "paged",
                                 ondevice=True, max_new=n_new)
        _zero_launches()
        kt, kinfo = run_generate(bundle, prompts, "kernel", "paged",
                                 ondevice=True, max_new=n_new)
        counts = _launches()
        if counts["cascade_phase1_paged_sm90"] != 2 * want \
                or sum(counts.values()) != 2 * want:
            fail(f"distill_full {label}: cascade launches {counts} in the "
                 f"eager cycle and the capture, expected {2 * want} "
                 "through cascade_phase1_paged_sm90 alone")
        decode[label] = {
            "alpha": kinfo["alpha"], "cycles": kinfo["cycles"],
            "ms_per_replay": kinfo["ms_per_cycle"],
            "capture_s": kinfo["capture_s"],
            "decode_tokens_per_s": kinfo["decode_tokens_per_s"],
            "gather_alpha": ginfo["alpha"],
            "agree_with_gather": float((kt == gt).mean()),
            "first_divergence_per_row": bf16_divergences(
                bundle, prompts, kt, gt, "paged"),
            "replay_launches": want}
    emit({"phase": "distill_full", "ok": True, "dtype": "bfloat16",
          "target": tcfg.name, "layers": DISTILL_LAYERS,
          "drafter": dataclasses.asdict(dcfg),
          "rollouts": list(rolls.shape), "rollout_s": rollout_s,
          "steps": DISTILL_STEPS, "batch": DISTILL_BATCH, "train": train,
          "decode": {"rows": n_rows, "prompt": p_len, "max_new": n_new,
                     **decode}})
    del params, drafters, bundle
    _free()
    return {"teacher_fwd_per_step": DISTILL_LAYERS,
            "graph_launches_per_cycle": decode["trained"]["replay_launches"]}


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
    serve_reqs, serve_toks, serve_fp32 = serving_path(
        cut_depth(bundle, SERVE_LAYERS))
    bundle, ms_cycle, bf16_casc, bf16_per_cycle, eager = bf16_path(
        bundle, prompts)
    profile_cycles(bundle, prompts, ms_cycle)
    graph_bf16(bundle, prompts, eager)
    graph_prof = profile_graph(bundle, prompts)
    modes_bf16(cut_depth(bundle, MODE_LAYERS), prompts)
    serve_bf16, serve_bf16_toks = serving_bf16(
        cut_depth(bundle, SERVE_LAYERS), serve_reqs)
    del bundle, eager
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the engine spanning a kv_seq mesh of ranks on this card, held to the
    # unsharded engine's runs of the same requests above
    pk, sy = serve_fp32["prefix_kernel"], serve_bf16["sync"]
    sharded = {
        "sharded": sharded_path("sharded", serve_reqs, {
            "tokens": serve_toks["prefix_kernel"],
            "launches_per_cycle": pk["launches_per_cycle"][
                "cascade_phase1_paged"],
            "ms_per_cycle": pk["ms_per_cycle"]}),
        "sharded_bf16": sharded_path("sharded_bf16", serve_reqs, {
            "tokens": serve_bf16_toks,
            "launches_per_cycle": sy["launches_per_cycle"],
            "ms_per_cycle": sy["ms_per_cycle"]})}
    # the engine's rows split over the mesh's batch axes, the pool
    # replicated over them, held to the same unsharded runs
    data = {
        "data": data_path("data", serve_reqs, {
            "tokens": serve_toks["prefix_kernel"],
            "launches_per_cycle": pk["launches_per_cycle"][
                "cascade_phase1_paged"],
            "ms_per_cycle": pk["ms_per_cycle"], "stats": pk}),
        "data_bf16": data_path("data_bf16", serve_reqs, {
            "tokens": serve_bf16_toks,
            "launches_per_cycle": sy["launches_per_cycle"],
            "ms_per_cycle": sy["ms_per_cycle"]})}
    recurrent = {phase: recurrent_path(phase) for phase in RECURRENT}
    serving_recurrent()
    moe_launches, nodrop_ref = moe_path()
    _free()
    # expert parallelism over ranks on this card: grok-1 fp32, kimi-k2
    # bf16 (#2's launches with a pos_stride a cycle)
    ep_runs = {phase: ep_path(phase, nodrop_ref) for phase in EP}
    more_archs = {**moe_launches, **ctx_path(), **archs_path()}

    fp32_launches = train_identity()
    run, bf16_launches, ms_step = train_bf16()
    profile_train_step(run, ms_step)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    arch_steps = train_archs()
    _free()
    # training on a (data 2, model 2) mesh of ranks on this card (fp32
    # held to the unsharded step, bf16 readings) and GPipe over pod 2
    # the multi-device dry run's production cells, traced on the host
    # while the mesh phases run
    started = start_dryrun_cells()
    mesh_steps = mesh_train_path()
    # the mesh cell traced on meta held to the ranks' real step, and the
    # production cells' records
    dryrun_path(mesh_steps, started)
    study = study_path()
    distilled = distill_full()

    # cascade rows: one per kernel at its dtype, the decode verify shape,
    # launches of the decode runs in that dtype (the fp32 main path, or
    # the bf16 kernel runs of both caches); flash rows: one per kernel at
    # its dtype, the training shape, launches of the training path in that
    # dtype (the bf16 step, or the kernel side of the fp32 identity run),
    # and under "d256" the same at head_dim 256
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
        # each rank's launches with a pos_stride a cycle of the sharded
        # phases (kv_seq mesh: fp32 over 2 ranks, bf16 over 4); #2 only
        if cache == "paged":
            extra["sharded_launches_per_cycle"] = sharded[
                "sharded" if dtype == torch.float32 else "sharded_bf16"]
            # the same on the EP phases (grok-1 fp32 over 2 ranks, kimi-k2
            # bf16 over 4)
            extra["ep_launches_per_cycle"] = ep_runs[
                "ep" if dtype == torch.float32 else "ep_bf16"]
        # each batch rank's launches a cycle of the batch-axes phases: the
        # engine's run of a wave's rows (#2: fp32 over data 2, bf16 over
        # (2, 2) with a pos_stride), the dense generate's (#1, fp32)
        extra["data_launches_per_cycle"] = data[
            "data" if dtype == torch.float32 else "data_bf16"][cache]
        # the recurrent targets' kernel runs (host loop) in this dtype
        for phase, rec in recurrent.items():
            extra[f"{phase}_launches_per_cycle"] = rec[dn][cache][name]
        # the study's d2sd host runs (fp32), distill_full's graph loop
        # (bf16, paged)
        if dtype == torch.float32:
            extra["study_launches_per_cycle"] = study["cascade_per_cycle"][
                cache].get(name)
        elif cache == "paged":
            extra["distill_full_graph_launches_per_cycle"] = distilled[
                "graph_launches_per_cycle"]
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
        d256 = flash_timing[wrapper][dn + "_d256"]
        # the study's pretraining and teacher passes (fp32, in all);
        # distill_full's teacher passes (bf16, a drafter step)
        extra = ({"study_launches": study["flash"][name]}
                 if dtype == torch.float32 else
                 {"distill_full_launches_per_step": distilled[
                     "teacher_fwd_per_step"] if name == "flash_fwd_sm90"
                  else 0})
        # a rank's launches a step on the (2, 2) mesh (16 of the 32 query
        # heads, 4 of the 8 KV heads), and the pipeline's a rank (fp32)
        extra["mesh_train_launches_per_step"] = mesh_steps[dn][name]
        extra["pipeline_launches"] = (
            mesh_steps["pipeline"].get(name, 0)
            if dtype == torch.float32 else None)
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"src/repro/kernels/flash_attention.py:"
                                 f"{line}",
                     "launches": counts[name], **extra,
                     "max_abs_err": flash_worst[wrapper][dn], "dtype": dn,
                     **_timing_keys(flash_timing[wrapper][dn]),
                     # gemma2-2b's shape; launches a step of train_archs
                     # (fp32: the identity run's depth, bf16: 6 layers)
                     "d256": {**_timing_keys(d256),
                              "device_ms": d256["device_ms"],
                              "library_kernel": d256["library_kernel"],
                              "launches_per_step": {
                                  arch: st[dn][name]
                                  for arch, st in arch_steps.items()}}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

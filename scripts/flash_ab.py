#!/usr/bin/env python3
"""Time the flash kernels and the cascade kernels of two checkouts on one
card, in turns.

    python3 scripts/flash_ab.py OTHER_ROOT [--rounds N]

Each round times OTHER_ROOT's kernels, then this checkout's twice, then
OTHER_ROOT's again (A B B A), each run in a process of its own that
imports that checkout's ``repro_torch``, so both are measured on the same
card within one call. A run times ``flash_attention_fwd``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` in bf16 and in
fp32 (the ``*_fp32`` keys), each also as ``*_device_ms``, at the training
shape of ``chip_smoke.py`` (B 2, Hq 32, Hkv 8, T 4096, D 128,
causal, the model's [B,T,H,D] layout), and ``cascade_phase1`` and
``cascade_phase1_paged`` in bf16 and in fp32 (the ``*_fp32`` keys) at its
decode verify shape (B 4, Hq 32, Hkv 8, D 128, Tq 76, caches of 520-600
keys of 616, pages of 64, a shuffled page table): CUDA events around one
call, the 50 MB L2 flushed before each, median of 20 after 3 warm-up
calls. That time also holds the host's enqueue of the wrapper, so
``*_device_ms`` puts a device sleep between the flush and the first
event, and the events bracket the call's device work alone. For a
cascade call, whose kernel takes tens of microseconds, ``*_host_us`` is
also the host's time per call over 100 calls made while the card sleeps
(median of 5).
It prints one JSON line per run, then the medians per checkout, the
card's name and power limit, and exits non-zero without a CUDA device.

``--time ROOT`` runs one timing of ROOT's kernels in this process.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SLEEP_CYCLES = 1_000_000        # about 0.5 ms of device clock


def time_checkout(root: Path) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import cascade_attention as casc
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, t, d = 2, 32, 8, 4096, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def ms(fn, iters=20, warmup=3, sleep=False):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            if sleep:
                torch.cuda._sleep(SLEEP_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return float(np.median([x.elapsed_time(y) for x, y in pairs]))

    def host_us(fn, calls=100, reps=5):
        fn()
        per = []
        for _ in range(reps):
            torch.cuda.synchronize()
            torch.cuda._sleep(20 * SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return float(np.median(per))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    out = {"root": str(root)}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype).transpose(1, 2)
                       for h in (hq, hkv, hkv, hq))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        bw = (q, k, v, do, lse, delta)
        calls = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(
                     q, k, v),
                 "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                     *bw),
                 "flash_attention_bwd_dkv":
                     lambda: fa.flash_attention_bwd_dkv(*bw)}
        for name, fn in calls.items():
            out[name + tag] = ms(fn)
            out[name + tag + "_device_ms"] = ms(fn, sleep=True)
        del q, k, v, do, o, lse, delta, bw, calls

    b, tq, s, page = 4, 76, 616, 64
    lens = torch.tensor([520, 560, 580, 600], device="cuda")
    mp = -(-s // page)
    kw = dict(cache_len=lens, q_abs=lens[:, None] + torch.arange(
        tq, device="cuda"))
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        qc = torch.randn((b, tq, hq, d), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
        kv = [torch.randn((b * mp, page, hkv, d), generator=gen,
                          device="cuda").to(dtype) for _ in range(2)]
        # the dense cache [B,S,Hkv,D] and the pool [P,page,Hkv,D], as views
        ck, cv = (x.reshape(b, mp * page, hkv, d)[:, :s].transpose(1, 2)
                  for x in kv)
        pk, pv = (x.transpose(1, 2) for x in kv)
        table = torch.randperm(b * mp, generator=gen,
                               device="cuda").reshape(b, mp).int()
        calls = {"cascade_phase1": lambda: casc.cascade_phase1(
                     qc, ck, cv, **kw),
                 "cascade_phase1_paged": lambda: casc.cascade_phase1_paged(
                     qc, pk, pv, table, **kw)}
        for name, fn in calls.items():
            out[name + tag] = ms(fn)
            out[name + tag + "_device_ms"] = ms(fn, sleep=True)
            out[name + tag + "_host_us"] = host_us(fn)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_ab.py: no CUDA device")
    if args.time is not None:
        print(json.dumps(time_checkout(args.time.resolve())), flush=True)
        return
    if args.other is None:
        ap.error("give the other checkout's root")
    roots = {"A": args.other.resolve(), "B": HERE}
    runs = []
    for _ in range(args.rounds):
        for tag in "ABBA":
            out = subprocess.run(
                [sys.executable, __file__, "--time", str(roots[tag])],
                capture_output=True, text=True, check=True).stdout
            res = {"checkout": tag, **json.loads(out.strip().splitlines()[-1])}
            print(json.dumps(res), flush=True)
            runs.append(res)
    import numpy as np
    names = [n for n in runs[0] if n not in ("checkout", "root")]
    print(json.dumps({tag: {n: float(np.median([r[n] for r in runs
                                                if r["checkout"] == tag]))
                            for n in names} for tag in "AB"}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

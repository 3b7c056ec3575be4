#!/usr/bin/env python3
"""Build the flash kernels and check their head_dim 256 instantiations
on one card, quickly: the first call to make after a change to
``csrc/flash_attention*.cu``.

    python3 scripts/flash_probe.py [--parent OTHER_ROOT]

Builds every kernel source (``kernels/build.py``), prints the ptxas
report of both flash sources (registers, spills), holds the flash
forward, dq and dk/dv in fp32 and bf16 to their plain versions at head
dims 256, 192 and 136 (gemma2-2b's GQA 8/4 with softcap 50 and
recurrentgemma-2b's MQA 10/1 with a window at T 1024, a ragged case,
one query row, key tiles no query sees, a kv_len inside a tile) within
``cascade_cases.TOL_FLASH`` and ``TOL_LSE``, checks that a head dim over
256 raises ``ValueError``, and times the three kernels at gemma2-2b's
training shape (B 2, Hq 8, Hkv 4, T 4096, D 256, causal, softcap 50):
CUDA events around five calls after one. With ``--parent``, it also
runs ``scripts/sass_diff.py`` on both flash sources against that
checkout for the D 64 and D 128 instantiations. Prints one line per
case and ``ALL_OK`` last, or exits non-zero; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = [   # b, hq, hkv, tq, tkv, d, options
    (2, 8, 4, 1024, 1024, 256, dict(causal=True, attn_softcap=50.0,
                                    window=4096)),
    (2, 10, 1, 1024, 1024, 256, dict(causal=True, window=512)),
    (2, 8, 4, 200, 300, 256, dict(causal=True, q_offset=100,
                                  kv_len=[300, 237], attn_softcap=50.0)),
    (2, 8, 2, 129, 129, 192, dict(causal=True)),
    (2, 8, 2, 1, 300, 256, dict(causal=True, q_offset=299)),
    (2, 8, 2, 128, 384, 256, dict(causal=True)),
    (2, 8, 2, 129, 129, 136, dict(causal=False, kv_len=[129, 70])),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_probe.py: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.cascade_cases import TOL_FLASH, TOL_LSE

    t0 = time.perf_counter()
    build.build_all()
    print("build_s", time.perf_counter() - t0, flush=True)
    for stem in ("flash_attention", "flash_attention_sm90"):
        build.load(stem)
        for ln in build.build_log(stem).splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(stem, ln.strip())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def mk(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def bthd(b, t, h, d, dtype):
        return mk((b, t, h, d), dtype).transpose(1, 2)

    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, tq, tkv, d, kw in CASES:
            q, do = bthd(b, tq, hq, d, dtype), bthd(b, tq, hq, d, dtype)
            k, v = bthd(b, tkv, hkv, d, dtype), bthd(b, tkv, hkv, d, dtype)
            kw = dict(kw)
            if "kv_len" in kw:
                kw["kv_len"] = torch.tensor(kw["kv_len"], device="cuda")
            o_k, lse_k = fa.flash_attention_fwd(q, k, v, **kw)
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
            delta = (do.float() * o_p.float()).sum(-1)
            bw = (q, k, v, do, lse_p, delta)
            dq_k = fa.flash_attention_bwd_dq(*bw, **kw)
            dq_p = fa.flash_attention_bwd_dq_plain(*bw, **kw)
            dk_k, dv_k = fa.flash_attention_bwd_dkv(*bw, **kw)
            dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(*bw, **kw)
            torch.cuda.synchronize()
            live = lse_p > -1e29

            def rel(a, b_, rows=None):
                a, b_ = a.float(), b_.float()
                if rows is not None:
                    a, b_ = a[rows], b_[rows]
                return ((a - b_).abs().max() / b_.abs().max()).item()

            r = {"o": rel(o_k, o_p, live), "dq": rel(dq_k, dq_p, live),
                 "dk": rel(dk_k, dk_p), "dv": rel(dv_k, dv_p),
                 "lse": (lse_k[live] - lse_p[live]).abs().max().item()}
            bad = (max(r["o"], r["dq"], r["dk"], r["dv"]) > TOL_FLASH[dtype]
                   or r["lse"] > TOL_LSE)
            ok &= not bad
            print("BAD" if bad else "ok", str(dtype), d, hq, hkv, tq, tkv,
                  json.dumps(r), flush=True)
    q = torch.zeros((1, 2, 8, 264), device="cuda", dtype=torch.bfloat16)
    try:
        fa.flash_attention_fwd(q, q, q)
        print("no ValueError at head_dim 264")
        ok = False
    except ValueError as e:
        print("ValueError ok:", e)

    def ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    kw = dict(causal=True, attn_softcap=50.0, window=4096)
    for dtype in (torch.float32, torch.bfloat16):
        q, do = bthd(2, 4096, 8, 256, dtype), bthd(2, 4096, 8, 256, dtype)
        k, v = bthd(2, 4096, 4, 256, dtype), bthd(2, 4096, 4, 256, dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        bw = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
        print("ms", str(dtype), json.dumps({
            "fwd": ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
            "dq": ms(lambda: fa.flash_attention_bwd_dq(*bw, **kw)),
            "dkv": ms(lambda: fa.flash_attention_bwd_dkv(*bw, **kw))}),
            flush=True)
    if args.parent is not None:
        for stem in ("flash_attention_sm90", "flash_attention"):
            out = subprocess.run(
                [sys.executable, str(ROOT / "scripts" / "sass_diff.py"),
                 str(args.parent), stem, "ILi64E", "ILi128E"],
                capture_output=True, text=True)
            print("sass", stem, out.stdout.strip(), flush=True)
            ok &= out.returncode == 0 and '"same": false' not in out.stdout
    print("ALL_OK" if ok else "SOME_BAD", flush=True)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()

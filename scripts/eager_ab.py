#!/usr/bin/env python3
"""Time the eager bf16 decode cycle of several checkouts on one card, in
turns.

    python3 scripts/eager_ab.py ROOT [ROOT ...] [--runs N]

The checkouts run in the order given, then in reverse (A B C C B A),
each run in a process of its own that imports that checkout's
``repro_torch``, so all are measured on the same card and host within
one call. A run builds ``chip_smoke.py``'s decode model (``paper-target``
at full width and depth, random weights from seeds 0, 1 and 2, cast to
bf16; two 2-layer drafters; gamma 16, K 4) and calls the host loop
``pipeline.generate`` on the kernel path and the paged cache (pages of
64) with 4 prompts of 512 tokens and 64 new tokens: one warm-up call,
then ``--runs`` timed ones. "ms a cycle" is a call's ``decode_s`` over
its ``n_cycles``, as ``chip_smoke.py``'s bf16 phase reads it. The eager
cycle is host-bound, so this compares the host's enqueue cost of the
trees; a last call under a ``TorchDispatchMode`` counts the aten ops
the host dispatches (``aten_ops_per_call``), which does not vary with
the host's load. It prints one JSON line per run, then the median per checkout,
the card's name and power limit, and exits non-zero without a CUDA
device.

``--time ROOT`` runs one timing of ROOT in this process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

GAMMA, K_BRANCHES, MAX_NEW = 16, 4, 64


def _cast_(tree, dtype):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _cast_(v, dtype)
        else:
            tree[k] = v.to(dtype)


def time_checkout(root: Path, runs: int) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.config.base import SpecConfig
    from repro_torch.configs import paper_target
    from repro_torch.core import pipeline as pl
    from repro_torch.core.drafter import DrafterConfig, drafter_init
    from repro_torch.kernels import build
    from repro_torch.models import lm
    build.build_all()
    tcfg = dataclasses.replace(paper_target.full(), dtype="bfloat16")
    dcfg = DrafterConfig(d_model=tcfg.d_model, num_layers=2,
                         num_heads=tcfg.num_heads,
                         num_kv_heads=tcfg.num_kv_heads, d_ff=tcfg.d_ff,
                         vocab_size=tcfg.vocab_size,
                         target_feature_dim=lm.feature_dim(tcfg),
                         gamma=GAMMA, dtype="bfloat16")
    params = [lm.lm_init(tcfg, seed=0, device="cuda"),
              drafter_init(dcfg, seed=1, device="cuda"),
              drafter_init(dcfg, seed=2, device="cuda")]
    for p in params:
        _cast_(p, torch.bfloat16)
    torch.cuda.empty_cache()
    spec = SpecConfig(gamma=GAMMA, top_k_branches=K_BRANCHES, mode="d2sd")
    bundle = pl.with_attn_impl(
        pl.SpecBundle(tcfg, dcfg, dcfg, spec, *params), "kernel")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                                size=(4, 512))
    ms = []
    for i in range(1 + runs):
        res = pl.generate(bundle, prompts, MAX_NEW, cache_impl="paged",
                          page_size=64, device="cuda")
        if i:
            ms.append(1e3 * res["decode_s"] / res["n_cycles"])
    # the host's work, counted: aten ops one call dispatches (prefill and
    # every cycle), the same for two trees whose cycles do the same work
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with CountOps() as ops:
        counted = pl.generate(bundle, prompts, MAX_NEW, cache_impl="paged",
                              page_size=64, device="cuda")
    return {"root": str(root), "cycles": res["n_cycles"],
            "ms_per_cycle": ms, "median_ms": float(np.median(ms)),
            "aten_ops_per_call": ops.n, "counted_cycles": counted["n_cycles"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--time", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("eager_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.time is not None:
        print(json.dumps(time_checkout(args.time.resolve(), args.runs)),
              flush=True)
        return 0
    roots = [r.resolve() for r in args.roots]
    by_root = {str(r): [] for r in roots}
    for root in roots + roots[::-1]:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--time", str(root),
                              "--runs", str(args.runs)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        by_root[str(root)].extend(rec["ms_per_cycle"])
    import numpy as np
    print(json.dumps({r: {"median_ms": float(np.median(v)), "runs": len(v)}
                      for r, v in by_root.items()}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

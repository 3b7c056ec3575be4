"""One-shot empirical study: pretrain the target, distill all drafters,
save the artifacts (twin of ``repro/training/run_study.py``).

    PYTHONPATH=src python -m repro_torch.training.run_study [--fast] \\
        [--device cpu]

Artifacts land in ``experiments/study_torch/`` (a checkpoint and
``meta.json``); :func:`load_study` reads them back. The JAX package's own
study lives in ``experiments/study/`` and is never written here.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.paper_target import drafter_small, smoke
from repro_torch.core.drafter import drafter_init
from repro_torch.data.synthetic import TASKS, SyntheticDataset
from repro_torch.models import lm
from repro_torch.training import distill

STUDY_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "study_torch"


def _wait(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """Run the study; returns its record: ``meta.json``'s fields, the
    per-step losses of the target and of each drafter, and the seconds
    of each stage."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--target-steps", type=int, default=240)
    ap.add_argument("--drafter-steps", type=int, default=400)
    ap.add_argument("--gamma", type=int, default=16)
    ap.add_argument("--rollouts-per-task", type=int, default=48)
    ap.add_argument("--rollout-new", type=int, default=160)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fast:
        args.target_steps, args.drafter_steps = 60, 80
        args.rollouts_per_task, args.rollout_new = 8, 48
    dev = resolve_device(args.device)

    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    tcfg = smoke()
    seconds = {}
    t_all = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        _wait(dev)
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    # 1. pretrain target ----------------------------------------------------
    print("== pretraining target ==")
    tparams, tmetrics = distill.pretrain_target(
        tcfg, steps=args.target_steps, batch=24, seq_len=160, device=dev)
    print(f"target final loss {tmetrics[-1]['loss']:.4f}")
    lap("pretrain")

    # 2. rollouts ------------------------------------------------------------
    print("== generating target rollouts ==")
    rolls = []
    for task in TASKS:
        ds = SyntheticDataset(task, 1, 64, seed=123)
        prompts = ds.prompts(args.rollouts_per_task, 32)
        rolls.append(distill.generate_rollouts(tparams, tcfg, prompts,
                                               args.rollout_new, device=dev))
    rollouts = np.concatenate(rolls, axis=0)
    print(f"rollouts: {rollouts.shape}")
    lap("rollouts")

    # 3. drafters ------------------------------------------------------------
    dcfg = drafter_small(gamma=args.gamma)
    print("== training DFlash drafter (first draft) ==")
    d1, l1 = distill.train_drafter(dcfg, tparams, tcfg, rollouts, vp=False,
                                   steps=args.drafter_steps, batch=24,
                                   device=dev)
    lap("dflash")
    print("== training VP-Drafter (Eq. 6/7 recipe) ==")
    d2, l2 = distill.train_drafter(dcfg, tparams, tcfg, rollouts, vp=True,
                                   steps=args.drafter_steps, batch=24,
                                   device=dev)
    lap("vp")
    print("== training EAGLE-style AR baseline drafter ==")
    dcfg_ar = drafter_small(gamma=args.gamma, causal=True)
    dar, l3 = distill.train_drafter(dcfg_ar, tparams, tcfg, rollouts,
                                    vp=False, causal=True,
                                    steps=args.drafter_steps, batch=24,
                                    device=dev)
    lap("ar")

    # 4. save ---------------------------------------------------------------
    ck = Checkpointer(str(STUDY_DIR / "ckpt"))
    ck.save(1, {"target": tparams, "d1": d1, "d2": d2, "ar": dar},
            extra={"gamma": args.gamma,
                   "target_loss": float(tmetrics[-1]["loss"]),
                   "drafter_losses": {"dflash": l1[-1], "vp": l2[-1],
                                      "ar": l3[-1]}})
    lap("save")
    meta = {"gamma": args.gamma, "target_steps": args.target_steps,
            "drafter_steps": args.drafter_steps,
            "rollouts": list(rollouts.shape),
            "wall_min": round((time.perf_counter() - t_all) / 60, 1),
            "seconds": seconds}
    (STUDY_DIR / "meta.json").write_text(json.dumps(meta, indent=2))
    print(f"saved study artifacts to {STUDY_DIR} "
          f"({meta['wall_min']} min)")
    return {**meta, "target_losses": [m["loss"] for m in tmetrics],
            "drafter_losses": {"dflash": l1, "vp": l2, "ar": l3}}


def load_study(device="cuda"):
    """(tcfg, dcfg, dcfg_ar, params, meta) saved by :func:`main`, the
    params on ``device``."""
    dev = resolve_device(device)
    tcfg = smoke()
    meta = json.loads((STUDY_DIR / "meta.json").read_text())
    gamma = meta["gamma"]
    dcfg = drafter_small(gamma=gamma)
    dcfg_ar = drafter_small(gamma=gamma, causal=True)
    like = {"target": lm.lm_init(tcfg, device=dev),
            "d1": drafter_init(dcfg, device=dev),
            "d2": drafter_init(dcfg, device=dev),
            "ar": drafter_init(dcfg_ar, device=dev)}
    params, _ = Checkpointer(str(STUDY_DIR / "ckpt")).restore(like)
    return tcfg, dcfg, dcfg_ar, params, meta


if __name__ == "__main__":
    main()

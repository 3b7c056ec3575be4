"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(twin of ``repro/launch/train.py``).

Runs the fault-tolerant training loop on the reduced (smoke) config by
default; ``--full`` trains the full config, which needs the card's
memory. Each step runs the flash kernels (``attn_impl="kernel"``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import OptimizerConfig, TrainConfig
from repro_torch.config.registry import all_archs, get_config
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch.steps import make_train_step, optimizer_for
from repro_torch.models import api
from repro_torch.training.trainer import train


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-target",
                    choices=("paper-target",) + all_archs())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = get_config(args.arch, smoke=not args.full)
    hp = OptimizerConfig(name=optimizer_for(cfg).name, lr=args.lr,
                         total_steps=args.steps,
                         warmup_steps=max(args.steps // 10, 1))
    tc = TrainConfig(batch_size=args.batch, seq_len=args.seq, optimizer=hp,
                     checkpoint_every=max(args.steps // 4, 10),
                     checkpoint_dir=args.ckpt_dir,
                     log_every=max(args.steps // 20, 1))
    print(f"training {cfg.name}: {cfg.param_count():.3g} params, "
          f"opt={hp.name}, device={dev}")

    params = api.init_model(cfg, seed=0, device=dev)
    step_fn, opt_init = make_train_step(cfg, hp=hp, device=dev)
    opt_state = opt_init(params)
    ds = SyntheticDataset("mixture", args.batch, args.seq, seed=0)

    state = {"params": params, "opt_state": opt_state, "step": 0}
    if args.resume:
        ck = Checkpointer(args.ckpt_dir)
        if ck.latest_step() is not None:
            restored, extra = ck.restore(
                {"params": params, "opt_state": opt_state})
            state.update(params=restored["params"],
                         opt_state=restored["opt_state"],
                         step=int(extra["step"]))
            ds.load_state_dict(extra["data"])
            print(f"resumed from step {state['step']}")
    out = train(step_fn, state, ds, tc)
    print(f"done: final loss {out['metrics'][-1]['loss']:.4f}, "
          f"restarts={out['restarts']}, stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()

"""Training loop with checkpoint/restart, failure injection and a
straggler monitor (twin of ``repro/training/trainer.py``).

The loop is framework-shaped: a ``step_fn``, a checkpointable data
iterator, a Checkpointer, and a restart wrapper that resumes from the
latest checkpoint after a (simulated or real) failure. Steps on the card
are timed to their end: the loop synchronizes on a CUDA loss before it
reads the clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import TrainConfig


class InjectedFailure(RuntimeError):
    """Raised by tests to simulate a node failure mid-run."""


@dataclasses.dataclass
class StragglerMonitor:
    """Tracks per-step wall time and flags outliers (a step slower than
    ``threshold`` times the median of the last ``window``)."""
    window: int = 50
    threshold: float = 3.0
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float):
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 10 and dt > self.threshold * float(np.median(hist)):
            self.flagged.append(step)
            return True
        return False


def _wait(loss):
    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)


def train(step_fn: Callable, state: Dict[str, Any], dataset,
          tc: TrainConfig, *, hooks: Optional[Dict[str, Callable]] = None,
          ckpt: Optional[Checkpointer] = None,
          log: Callable = print) -> Dict[str, Any]:
    """Run ``tc.optimizer.total_steps`` steps with checkpoint + restart.

    state: dict with at least {params, opt_state, step:int}.
    step_fn(params, opt_state, batch) -> (params, opt_state, metrics).
    hooks: {"pre_step": fn(step) -> None} — tests inject failures here.
    """
    hooks = hooks or {}
    ckpt = ckpt or Checkpointer(tc.checkpoint_dir,
                                async_save=tc.async_checkpoint)
    monitor = StragglerMonitor()
    restarts = 0
    metrics_hist: List[Dict] = []

    while True:
        try:
            while state["step"] < tc.optimizer.total_steps:
                step = state["step"]
                if "pre_step" in hooks:
                    hooks["pre_step"](step)
                t0 = time.time()
                batch = dataset.next_batch()
                params, opt_state, metrics = step_fn(
                    state["params"], state["opt_state"], batch)
                _wait(metrics["loss"])
                dt = time.time() - t0
                state["params"], state["opt_state"] = params, opt_state
                state["step"] = step + 1
                slow = monitor.record(step, dt)
                if step % tc.log_every == 0:
                    log(f"step {step} loss {float(metrics['loss']):.4f} "
                        f"({dt * 1e3:.0f} ms{' STRAGGLER' if slow else ''})")
                metrics_hist.append(
                    {k: float(v) for k, v in metrics.items()})
                if (step + 1) % tc.checkpoint_every == 0:
                    ckpt.save(step + 1,
                              {"params": state["params"],
                               "opt_state": state["opt_state"]},
                              extra={"step": step + 1,
                                     "data": dataset.state_dict()})
            break
        except InjectedFailure as e:
            restarts += 1
            if restarts > tc.max_restarts:
                raise
            log(f"FAILURE at step {state['step']}: {e}; restarting "
                f"({restarts}/{tc.max_restarts})")
            ckpt.wait()
            last = ckpt.latest_step()
            if last is not None:
                restored, extra = ckpt.restore(
                    {"params": state["params"],
                     "opt_state": state["opt_state"]})
                state["params"] = restored["params"]
                state["opt_state"] = restored["opt_state"]
                state["step"] = int(extra["step"])
                dataset.load_state_dict(extra["data"])
            else:
                state["step"] = 0

    ckpt.wait()
    return {"state": state, "metrics": metrics_hist,
            "stragglers": monitor.flagged, "restarts": restarts}

"""Training step and optimizer choice (twin of the training half of
``repro/launch/steps.py``).

The step is ``loss.backward()`` on ``models.api.train_loss`` with
``attn_impl="kernel"``: on the card every attention layer runs the CUDA
flash forward kernel (again under remat) and both flash backward
kernels. Then the optimizer updates params and moments in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig, OptimizerConfig
from repro_torch.models import api
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as opt_lib


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    # factored moments for the giant MoEs; int8 moments for mid-size; plain
    # AdamW for small models
    n = cfg.param_count()
    if n > 1e11:
        return OptimizerConfig(name="adafactor")
    if n > 3e9:
        return OptimizerConfig(name="adamw8bit")
    return OptimizerConfig(name="adamw")


def make_train_step(cfg: ModelConfig, hp: Optional[OptimizerConfig] = None,
                    attn_impl: str = "kernel", device="cuda"):
    """(train_step, opt_init). ``train_step(params, opt_state, batch)``
    returns ``(params, opt_state, {"loss", "lr", "grad_norm"})``, with
    params and moments updated in place; the batch may be numpy (it is
    moved to ``device``). ``hp`` defaults to :func:`optimizer_for`."""
    dev = resolve_device(device)
    hp = hp if hp is not None else optimizer_for(cfg)
    opt_init, opt_update = opt_lib.make_optimizer(hp, cfg)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        flat = pm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        try:
            loss = api.train_loss(params, batch, cfg, attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, list(flat.values()))
        finally:
            for p in flat.values():
                p.requires_grad_(False)
        grads = pm.unflatten_like(params, dict(zip(flat, grads)))
        new_p, new_o, metrics = opt_update(grads, opt_state, params)
        return new_p, new_o, {"loss": loss.detach(), **metrics}

    return train_step, opt_init

"""Carry weights across from the JAX package to the port.

The JAX params are handed over as a nested dict of numpy arrays (for
example ``jax.tree.map(np.asarray, params)`` on the caller's side); this
module takes numpy only and never imports JAX. The target's scanned
period axis (``params["period"]["p{j}"]``, stacked over periods, plus the
unrolled ``tail{i}`` layers) is unstacked here into the port's per-layer
list in depth order. Weight orientation is unchanged: both packages
compute ``dense(w, x) = x @ w`` with ``w`` shaped [d_in, d_out].
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models.blocks import check_supported, period_spec


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def convert_lm(np_params, cfg: ModelConfig, device="cuda"):
    """JAX ``lm.lm_init`` params (numpy leaves) -> port ``lm`` params."""
    check_supported(cfg)
    return convert_tree(np_params, cfg, device=device)


def convert_tree(np_params, cfg: ModelConfig, device="cuda"):
    """Any tree shaped like the JAX ``lm`` params (params, grads, AdamW
    ``m``/``v``; numpy leaves) -> the port's layout, the period axis
    unstacked into ``layers``."""
    dev = resolve_device(device)
    plen, n_periods = period_spec(cfg)
    out = {k: _tree(v, lambda a: to_tensor(a, dev))
           for k, v in np_params.items()
           if k != "period" and not k.startswith("tail")}
    layers = []
    for i in range(n_periods):
        for j in range(plen):
            layers.append(_tree(np_params["period"][f"p{j}"],
                                lambda a, i=i: to_tensor(np.asarray(a)[i],
                                                         dev)))
    for i in range(cfg.num_layers - n_periods * plen):
        layers.append(_tree(np_params[f"tail{i}"],
                            lambda a: to_tensor(a, dev)))
    out["layers"] = layers
    return out


def convert_drafter(np_params, device="cuda"):
    """JAX ``drafter.drafter_init`` params (numpy leaves) -> port params
    (the layouts are the same)."""
    dev = resolve_device(device)
    return _tree(np_params, lambda a: to_tensor(a, dev))

"""The empirical pipeline at reduced scale, paper §4 (twin of
``repro/training/distill.py``):

 1. pretrain a small target LM on the synthetic mixture;
 2. generate target greedy rollouts ("training responses generated by the
    target model itself", §4.1) and teacher features;
 3. train the DFlash drafter (fixed anchor) and the VP-Drafter (Eq. 6
    geometric prefixes, Eq. 7 anchor-decayed CE) on those rollouts;
 4. optionally train the EAGLE-style AR chain drafter baseline.

Everything returns the port's param trees, ready for
``core.pipeline.SpecBundle``. On the card the target's training step runs
the flash forward and backward kernels and the teacher pass the flash
forward (``attn_impl="kernel"``); the drafter's attention over
[feature cache ++ block] is the gather path with autograd on. Where JAX
splits a key, a drafter step draws from one ``torch.Generator``: the
rollout rows (with replacement), then the window starts, then (VP) the
prefix lengths. :func:`drafter_loss` takes those draws as arguments.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.core import losses as losses_lib
from repro_torch.core.drafter import (DrafterConfig, drafter_init,
                                      project_features)
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as opt_lib
from repro_torch.training.trainer import train


# ------------------------------------------------------------- pretrain ----
def pretrain_target(tcfg: ModelConfig, steps: int = 300, batch: int = 32,
                    seq_len: int = 160, seed: int = 0, log=print,
                    device="cuda"):
    """AdamW (lr 1e-3, warm-up 20) on the ``mixture`` stream from weights
    drawn with ``seed``, through ``make_train_step`` (the flash kernels on
    the card). Returns (params, per-step metrics)."""
    hp = OptimizerConfig(lr=1e-3, total_steps=steps, warmup_steps=20)
    tc = TrainConfig(batch_size=batch, seq_len=seq_len,
                     optimizer=hp, checkpoint_every=10 ** 9,
                     log_every=max(steps // 10, 1))
    dataset = SyntheticDataset("mixture", batch, seq_len, seed=seed)
    params = lm.lm_init(tcfg, seed=seed, device=device)
    step_fn, opt_init = make_train_step(tcfg, hp=hp, device=device)
    out = train(step_fn, {"params": params, "opt_state": opt_init(params),
                          "step": 0}, dataset, tc, log=log)
    return out["state"]["params"], out["metrics"]


# -------------------------------------------------------------- rollouts ---
@torch.no_grad()
def generate_rollouts(tparams, tcfg: ModelConfig, prompts: np.ndarray,
                      n_new: int, log=print, device="cuda"):
    """Greedy target rollouts: a prefill, then ``n_new`` one-token steps
    over a dense cache. Returns [B, P + n_new + 1] int32 numpy: the
    prompts, the ``n_new`` tokens fed back, and the token after the
    last."""
    dev = resolve_device(device)
    prompts_t = torch.as_tensor(np.asarray(prompts), device=dev).long()
    b, p = prompts_t.shape
    states = lm.init_states(tcfg, b, p + n_new + 1, device=dev)
    out = lm.forward(tparams, prompts_t, tcfg, states=states, write_kv=True)
    tok = torch.argmax(out["logits"][:, -1], -1)
    gen = []
    for _ in range(n_new):
        out = lm.forward(tparams, tok[:, None], tcfg, states=out["states"],
                         write_kv=True, attend_cache_on_write=True)
        gen.append(tok)
        tok = torch.argmax(out["logits"][:, -1], -1)
    seqs = torch.cat([prompts_t, *(t[:, None] for t in gen), tok[:, None]],
                     dim=1)
    return seqs.cpu().numpy().astype(np.int32)


# --------------------------------------------------------- drafter train ---
def make_teacher_fn(tparams, tcfg: ModelConfig):
    """tokens [B, S] -> the target's drafter features [B, S, Fd]: one
    stateless pass with no logits and no autograd, its attention the
    flash op (the forward kernel on the card)."""
    @torch.no_grad()
    def teacher(tokens):
        return lm.forward(tparams, tokens, tcfg, want_features=True,
                          want_logits=False, attn_impl="kernel")["features"]
    return teacher


def draw_windows(gen: torch.Generator, mode: str, batch: int, s_len: int,
                 gamma: int, beta: float):
    """One step's (start [B], l [B] or None): start in [0, S-g-1) for the
    AR chain (its labels reach one further), else in [1, S-g); l by Eq. 6
    for the VP-Drafter."""
    if mode == "ar":
        return losses_lib.draw_start(gen, batch, 0, s_len - gamma - 1), None
    start = losses_lib.draw_start(gen, batch, 1, s_len - gamma)
    if mode == "vp":
        return start, losses_lib.sample_prefix_geometric(gen, batch, gamma,
                                                         beta)
    return start, None


def feat_cache_from(dparams, dcfg: DrafterConfig, feats, start):
    """The drafter feature cache of a whole rollout, visible below
    ``start``: every position's features projected through each layer's
    ``wk``/``wv``, with ``length = start``."""
    b, s = feats.shape[:2]
    pos = torch.arange(s, device=feats.device)[None].expand(b, s)
    fk, fv = project_features(dparams, dcfg, feats, pos)
    return {"k": fk, "v": fv, "length": start}


def drafter_loss(dparams, dcfg: DrafterConfig, tokens, feats, start, l, *,
                 mode: str, tau: Optional[float] = 4.0,
                 dflash_tau: Optional[float] = 8.0):
    """The loss of one step's draws. ``mode`` "dflash": the anchor
    visible, weights decayed by ``dflash_tau``; "vp": the Eq. 6 prefix
    ``l`` visible, decayed by ``tau``; "ar" (``dcfg.causal``): the window
    predicts the tokens one further on, uniform weights on every slot."""
    g = dcfg.gamma
    b = tokens.shape[0]
    idx = start[:, None] + torch.arange(g, device=tokens.device)[None, :]
    cache = feat_cache_from(dparams, dcfg, feats, start)
    if mode == "ar":
        blocks = losses_lib.window(tokens, start, g)
        labels = losses_lib.window(tokens, start + 1, g)
        prefix_len = torch.full((b,), -1, dtype=torch.long,
                                device=tokens.device)
        tau_ = None
    else:
        labels = losses_lib.window(tokens, start, g)
        if mode == "vp":
            blocks = losses_lib.prefix_blocks(labels, l, dcfg.mask_token)
            prefix_len, tau_ = l, tau
        else:
            blocks = losses_lib.dflash_blocks(labels, dcfg.mask_token)
            prefix_len = torch.zeros((b,), dtype=torch.long,
                                     device=tokens.device)
            tau_ = dflash_tau
    loss, _ = losses_lib.block_loss(dparams, dcfg, blocks, labels, cache,
                                    prefix_len=prefix_len, tau=tau_,
                                    positions=idx)
    return loss


def train_drafter(dcfg: DrafterConfig, tparams, tcfg: ModelConfig,
                  rollouts: np.ndarray, *, vp: bool, steps: int = 400,
                  batch: int = 32, lr: float = 1e-3,
                  beta: float = 0.8, tau: Optional[float] = 4.0,
                  dflash_tau: Optional[float] = 8.0,
                  causal: bool = False, seed: int = 1, log=print,
                  device="cuda"):
    """Train one drafter (DFlash when vp=False, VP-Drafter when vp=True,
    EAGLE chain when causal=True) with AdamW on rollout rows picked with
    replacement, the teacher's features formed inside every step.
    Returns (params, per-step losses)."""
    dev = resolve_device(device)
    teacher = make_teacher_fn(tparams, tcfg)
    params = drafter_init(dcfg, seed=seed, device=dev)
    hp = OptimizerConfig(lr=lr, total_steps=steps, warmup_steps=20)
    opt_init, opt_update = opt_lib.make_optimizer(hp)
    opt_state = opt_init(params)
    mode = "ar" if causal else ("vp" if vp else "dflash")
    n_roll, s_len = rollouts.shape
    rolls = torch.as_tensor(np.asarray(rollouts), device=dev).long()
    gen = pm.make_generator(seed + 7, dev)
    flat = pm.flatten(params)
    losses = []
    for step in range(steps):
        sel = torch.randint(0, n_roll, (batch,), generator=gen, device=dev)
        tokens = rolls[sel]
        start, l = draw_windows(gen, mode, batch, s_len, dcfg.gamma, beta)
        feats = teacher(tokens)
        for p in flat.values():
            p.requires_grad_(True)
        try:
            loss = drafter_loss(params, dcfg, tokens, feats, start, l,
                                mode=mode, tau=tau, dflash_tau=dflash_tau)
            grads = torch.autograd.grad(loss, list(flat.values()))
        finally:
            for p in flat.values():
                p.requires_grad_(False)
        grads = pm.unflatten_like(params, dict(zip(flat, grads)))
        params, opt_state, _ = opt_update(grads, opt_state, params)
        losses.append(float(loss.detach()))
        if step % max(steps // 10, 1) == 0:
            log(f"  drafter[{mode}] step {step} loss {losses[-1]:.4f}")
    return params, losses

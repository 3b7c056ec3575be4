"""Drafter training objectives, paper §3.4 (twin of ``repro/core/losses.py``).

* DFlash loss: the anchor at block slot 0 is visible, slots 1..gamma-1 are
  masked; the CE weights decay with the slot.
* VP loss (Eqs. 6-7): a prefix length l ~ truncated Geometric(beta)
  (Eq. 6); the anchor and the next l ground-truth (target rollout) tokens
  are visible; anchor-decayed CE over the masked slots
      L = sum_k w_k * CE_k / sum_k w_k,  w_k = exp(-(k - l - 1)/tau)   (Eq. 7)

Both train on (sequence tokens, target features) pairs where the sequences
are target-model rollouts and the features come from the same teacher
pass. Where JAX takes a key, these functions take a ``torch.Generator``
and draw on its device. The window and block functions that take
``start`` and ``l`` are the draws' consumers: the batch makers and
``training/distill.py`` share them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.drafter import DrafterConfig, drafter_forward
from repro_torch.models import param as pm


def sample_prefix_geometric(gen: torch.Generator, batch: int, gamma: int,
                            beta: float):
    """Eq. 6: Pr(l = j) ∝ beta^j, j = 0..gamma-2. [batch] long."""
    logp = torch.arange(gamma - 1, dtype=torch.float32,
                        device=gen.device) * math.log(beta)
    return pm.categorical(gen, logp[None, :].expand(batch, gamma - 1))


def draw_start(gen: torch.Generator, batch: int, low: int, high: int):
    """[batch] window starts uniform in [low, high), as
    ``jax.random.randint``."""
    return torch.randint(low, high, (batch,), generator=gen,
                         device=gen.device)


def window(tokens, start, gamma: int):
    """tokens[b, start[b] : start[b] + gamma] for every row: [B, gamma]."""
    idx = start[:, None] + torch.arange(gamma, device=tokens.device)[None, :]
    return torch.gather(tokens, 1, idx)


def dflash_blocks(labels, mask_token: int):
    """[anchor, MASK, ..., MASK]: the first label visible, the rest
    masked."""
    blocks = torch.full_like(labels, mask_token)
    blocks[:, 0] = labels[:, 0]
    return blocks


def prefix_blocks(labels, l, mask_token: int):
    """The anchor and the next ``l[b]`` labels visible, the rest masked."""
    slot = torch.arange(labels.shape[1], device=labels.device)[None, :]
    return torch.where(slot <= l[:, None], labels,
                       torch.full_like(labels, mask_token))


def block_loss(dparams, dcfg: DrafterConfig, blocks, labels, feat_cache,
               prefix_len, tau: Optional[float], positions=None):
    """Shared CE for both drafters.

    blocks: [B, gamma] drafter inputs (anchor+prefix visible, rest MASK)
    labels: [B, gamma] ground-truth tokens for every slot
    prefix_len: [B] visible prefix length l (0 => only anchor visible)
    tau: decay temperature (None => uniform weights over masked slots)
    Returns (loss, {"nll": [B, gamma], "weights": [B, gamma]}).
    """
    g = blocks.shape[1]
    logits = drafter_forward(dparams, dcfg, blocks, feat_cache,
                             positions=positions)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll                                        # [B, gamma]
    slot = torch.arange(g, device=blocks.device)[None, :]
    masked = slot > prefix_len[:, None]                   # slots l+1..gamma-1
    if tau is None:
        w = masked.float()
    else:
        w = torch.exp(-(slot - prefix_len[:, None] - 1).float() / tau) \
            * masked
    per_ex = (w * nll).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)
    return per_ex.mean(), {"nll": nll, "weights": w}


def make_dflash_batch(gen: torch.Generator, tokens, gamma: int,
                      mask_token: int):
    """Block windows for DFlash training: a start s per row in
    [0, S - gamma); block = [tokens[s], MASK * (gamma-1)], labels =
    tokens[s..s+gamma-1]. Returns (blocks, labels, start [B])."""
    b, s = tokens.shape
    start = draw_start(gen, b, 0, s - gamma)
    labels = window(tokens, start, gamma)
    return dflash_blocks(labels, mask_token), labels, start


def make_vp_batch(gen: torch.Generator, tokens, gamma: int, mask_token: int,
                  beta: float):
    """Variable-prefix blocks (Eq. 6): (blocks, labels, start, l)."""
    b, s = tokens.shape
    start = draw_start(gen, b, 0, s - gamma)
    labels = window(tokens, start, gamma)
    l = sample_prefix_geometric(gen, b, gamma, beta)      # [B] in 0..g-2
    return prefix_blocks(labels, l, mask_token), labels, start, l

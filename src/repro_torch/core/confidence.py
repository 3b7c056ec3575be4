"""Rejection-boundary estimation from drafter confidence (twin of
``repro/core/confidence.py``, paper §3.1-3.2).

Eq. 3: c_k = max_v p_k(v)
Eq. 4: r(i) = prod_{k<i} c_k * (1 - c_i)
Eq. 5: S = TopK_i r(i)
"""
from __future__ import annotations

import torch


def confidences(draft_logits, draft_tokens=None):
    """Eq. 3. draft_logits: [..., G, V] -> [..., G]."""
    probs = torch.softmax(draft_logits.float(), dim=-1)
    if draft_tokens is None:
        return probs.amax(dim=-1)
    return torch.gather(probs, -1, draft_tokens.long()[..., None])[..., 0]


def boundary_posterior(conf):
    """Eq. 4. conf: [..., G] -> r[..., G], r[i] = prod_{k<i} c_k * (1-c_i)."""
    cf = conf.float()
    prefix = torch.cumprod(cf, dim=-1)
    prefix_excl = prefix / cf.clamp_min(1e-30)
    return prefix_excl * (1.0 - cf)


def topk_prefixes(r, k: int):
    """Eq. 5. r: [..., G] -> (scores [..., K], idx [..., K]).

    Ties go to the lower index, as ``jax.lax.top_k`` breaks them (a
    stable descending sort; ``torch.topk`` makes no such promise).
    """
    vals, idx = torch.sort(r, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]

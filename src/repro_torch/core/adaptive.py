"""Adaptive branch budgeting from the boundary posterior (twin of
``repro/core/adaptive.py``; beyond the paper).

The paper fixes K per deployment and observes (§4.2) that gains shrink on
open-ended chat, where the boundary posterior r(i) is more diffuse. That
inverts into a scheduler that spends second-draft branches where they
pay: few when r(i) is concentrated, more when it is diffuse, none when
the all-accept probability prod(c) dominates (the first draft will
likely survive whole). ``choose_k`` maps the posterior to a per-example
branch count in [0, k_max]; a caller takes the wave's maximum, so the
tree keeps one shape per cycle.
"""
from __future__ import annotations

import torch


def posterior_coverage_k(r, coverage: float = 0.85, k_max: int = 4):
    """Smallest K with top-K posterior mass >= coverage * total mass. [B]."""
    total = r.sum(-1, keepdim=True).clamp_min(1e-9)
    top = torch.topk(r, min(k_max, r.shape[-1]), dim=-1).values
    cum = torch.cumsum(top / total, dim=-1)
    need = (cum < coverage).sum(-1) + 1
    return need.clamp(max=k_max).to(torch.int32)


def skip_second_draft(conf, threshold: float = 0.7):
    """True where P(whole first draft accepted) = prod(c_k) >= threshold:
    the VP pass is unlikely to add tokens. [B] bool."""
    return torch.prod(conf.float(), dim=-1) >= threshold


def choose_k(conf, r, *, coverage: float = 0.85, k_max: int = 4,
             skip_threshold: float = 0.7):
    """Per-example branch budget; 0 = skip the second draft. [B] int32 in
    {0, 1, .., k_max}."""
    k = posterior_coverage_k(r, coverage, k_max)
    return torch.where(skip_second_draft(conf, skip_threshold),
                       torch.zeros_like(k), k)


def expected_recovery(r, fork_idx, gamma: int):
    """Upper bound on the extra tokens a branch at fork i recovers:
    sum_i r(i) * (G - i) over the selected forks (G = r's length)."""
    g1 = r.shape[-1]
    sel = torch.gather(r, -1, fork_idx.long())
    return (sel * (g1 - fork_idx).float()).sum(-1)

"""Pluggable draft strategies (twin of ``repro/core/strategies.py``).

The port registers the greedy ``d2sd`` and ``dflash`` modes. ``naive_k``,
``eagle`` and ``dflash_second``, the ``third_level`` option and sampled
drafts (temperature > 0) are ROADMAP items and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

import torch

from repro_torch.config.base import SpecConfig
from repro_torch.core import confidence as conf_lib
from repro_torch.core import drafter as dr
from repro_torch.core import tree as tree_lib

_NOT_PORTED = "ROADMAP.md queue 1, slice 1 (remaining modes)"


class DraftStrategy:
    """Protocol for draft-phase plugins. Subclass and register by name.

    ``draft`` returns the candidate prefix tree rooted at the anchor. (The
    JAX twin returns a ``DraftResult`` that also carries the trunk
    confidences for calibration and the proposal distributions and
    sibling bound that only sampling verify reads.)"""

    name: str = "?"

    def draft(self, bundle, state) -> tree_lib.Tree:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[DraftStrategy]] = {}


def register_strategy(name: str):
    """Class decorator: ``@register_strategy("d2sd")``."""
    def deco(cls: Type[DraftStrategy]) -> Type[DraftStrategy]:
        if cls.__dict__.get("name", "?") == "?":
            cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> DraftStrategy:
    if name not in _REGISTRY:
        if name in ("naive_k", "eagle", "dflash_second"):
            raise NotImplementedError(
                f"draft strategy {name!r} is not ported: {_NOT_PORTED}")
        raise KeyError(f"unknown draft strategy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def registered_strategies() -> Dict[str, Type[DraftStrategy]]:
    return dict(_REGISTRY)


def mask_inactive(t: tree_lib.Tree, active) -> tree_lib.Tree:
    """Degenerate inactive rows' trees to the root-only node (nothing is
    accepted, nothing committed)."""
    keep = active[:, None] | (torch.arange(t.n, device=active.device)
                              == 0)[None, :]
    return dataclasses.replace(
        t, tokens=torch.where(keep, t.tokens, torch.zeros_like(t.tokens)),
        valid=t.valid & keep)


def _require_greedy(spec: SpecConfig):
    if spec.temperature > 0:
        raise NotImplementedError(
            "sampled drafts / sampling verify are not ported: "
            "ROADMAP.md queue 1, slice 1 (sampling verify)")


# ----------------------------------------------------- shared draft steps --
def first_draft(bundle, state):
    """DFlash pass (greedy): returns (trunk [B,g-1], d1_logits [B,g,V])."""
    g = bundle.spec.gamma
    blk = dr.dflash_block(state.anchor, g, bundle.d1_cfg.mask_token)
    logits = dr.drafter_forward(bundle.d1_params, bundle.d1_cfg, blk,
                                state.d1_feat)
    return torch.argmax(logits[:, 1:], dim=-1), logits


def second_draft(params, dcfg, feat_cache, anchor, trunk, fork_idx,
                 feat_len):
    """VP pass (greedy), K branches in one forward via sequence-axis
    concatenation with a block-diagonal mask.

    Returns (branch_tokens [B,K,g-1], d2_logits [B,K,g,V]).
    """
    b, k = fork_idx.shape
    g = trunk.shape[-1] + 1
    dev = anchor.device
    vp_in = dr.vp_blocks(anchor, trunk, fork_idx, dcfg.mask_token)  # [B,K,g]
    flat = vp_in.reshape(b, k * g)
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    bmask = eye.repeat_interleave(g, 0).repeat_interleave(g, 1)    # [Kg,Kg]
    slots = torch.arange(g, device=dev).repeat(k)[None, :]        # [1,Kg]
    positions = feat_len.long()[:, None] + slots
    logits = dr.drafter_forward(params, dcfg, flat, feat_cache,
                                positions=positions, block_mask=bmask)
    logits = logits.reshape(b, k, g, -1)
    return torch.argmax(logits[:, :, 1:], dim=-1), logits


# ------------------------------------------------------------ strategies ---
@register_strategy("dflash")
class DFlashStrategy(DraftStrategy):
    """Single-chain first-draft baseline."""

    def draft(self, bundle, state):
        _require_greedy(bundle.spec)
        trunk, _ = first_draft(bundle, state)
        return tree_lib.chain_tree(state.anchor, trunk)


@register_strategy("d2sd")
class D2SDStrategy(DraftStrategy):
    """DFlash trunk -> Eq. 5 top-K forks -> batched VP second draft."""

    def draft(self, bundle, state):
        spec = bundle.spec
        _require_greedy(spec)
        if spec.third_level:
            raise NotImplementedError(
                "third_level is not ported: ROADMAP.md queue 1, slice 1")
        g, kbr = spec.gamma, spec.top_k_branches
        trunk, d1_logits = first_draft(bundle, state)
        conf = conf_lib.confidences(d1_logits[:, 1:])
        r = conf_lib.boundary_posterior(conf)
        _, fork_idx = conf_lib.topk_prefixes(r, kbr)             # [B, K]
        branch_tokens, _ = second_draft(
            bundle.d2_params, bundle.d2_cfg, state.d2_feat, state.anchor,
            trunk, fork_idx, state.d2_feat["length"])
        return tree_lib.comb_tree(state.anchor, trunk, branch_tokens,
                                  fork_idx, g)

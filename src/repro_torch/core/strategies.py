"""Pluggable draft strategies (twin of ``repro/core/strategies.py``).

A :class:`DraftStrategy` turns ``(bundle, state, gen)`` into a
:class:`DraftResult`: the candidate prefix tree and the per-node proposal
distributions that sampling verify reads. Each paper mode is one
registered class (``d2sd``, ``dflash``, ``naive_k``, ``eagle``,
``dflash_second``; ``SpecConfig.third_level`` adds a level to ``d2sd``).
At temperature > 0 every token is drawn from the cycle's generator
``gen`` (``models/param.py::categorical``); ``naive_k`` draws its
resamples from it at any temperature.

``DraftResult.dprobs`` holds, for every node, the categorical its token
was drawn from. In two places the JAX twin's differs, and the port
follows that rule instead (ROADMAP.md, queue 3, "Reference quirks"):
third-level nodes take the third draft's distribution (JAX: branch K-1's
second-draft one), and ``naive_k``'s resamples take the temperature they
were drawn at, max(T, 1) (JAX: T).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

import torch

from repro_torch.config.base import SpecConfig
from repro_torch.core import confidence as conf_lib
from repro_torch.core import drafter as dr
from repro_torch.core import tree as tree_lib
from repro_torch.models import param as pm


@dataclasses.dataclass(frozen=True)
class DraftResult:
    """Output of one draft phase.

    tree:         candidate prefix tree rooted at the anchor.
    dprobs:       [B, N, V] per-node proposal categoricals q_n for sampling
                  verify (None under greedy decoding, temperature 0).
    conf:         [B, gamma-1] trunk confidences (Eq. 3) for calibration
                  stats; None for strategies without a diffusion trunk.
    max_children: static sibling bound for the verifier's child scan.
    """
    tree: tree_lib.Tree
    dprobs: Optional[torch.Tensor]
    conf: Optional[torch.Tensor]
    max_children: int


class DraftStrategy:
    """Protocol for draft-phase plugins. Subclass and register by name."""

    name: str = "?"

    def draft(self, bundle, state, gen) -> DraftResult:
        raise NotImplementedError

    # ---- static cost metadata ----
    def n_draft_passes(self, spec: SpecConfig) -> int:
        raise NotImplementedError

    def n_tree_nodes(self, spec: SpecConfig) -> int:
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
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown draft strategy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_strategies() -> Dict[str, Type[DraftStrategy]]:
    return dict(_REGISTRY)


def mask_inactive(result: DraftResult, active) -> DraftResult:
    """Degenerate inactive rows' trees to the root-only node (nothing is
    accepted, nothing committed). Shape-stable."""
    t = result.tree
    keep = active[:, None] | (torch.arange(t.n, device=active.device)
                              == 0)[None, :]
    tree = dataclasses.replace(
        t, tokens=torch.where(keep, t.tokens, torch.zeros_like(t.tokens)),
        valid=t.valid & keep)
    return dataclasses.replace(result, tree=tree)


def _draw(gen, logits, temperature):
    """Tokens from logits [..., V]: sampled at ``temperature`` > 0, else
    the argmax."""
    if temperature > 0:
        return pm.categorical(gen, logits.float() / temperature)
    return torch.argmax(logits, dim=-1)


# ----------------------------------------------------- shared draft steps --
def first_draft(bundle, state, gen, temperature):
    """DFlash pass: returns (trunk [B,g-1], d1_logits [B,g,V])."""
    g = bundle.spec.gamma
    blk = dr.dflash_block(state.anchor, g, bundle.d1_cfg.mask_token)
    logits = dr.drafter_forward(bundle.d1_params, bundle.d1_cfg, blk,
                                state.d1_feat)
    return _draw(gen, logits[:, 1:], temperature), logits


def second_draft(params, dcfg, feat_cache, anchor, trunk, fork_idx, gen,
                 temperature, feat_len):
    """VP pass, K branches in one forward via sequence-axis concatenation
    with a block-diagonal mask. ``trunk`` is [B,g-1], or [B,K,g-1] for
    the third level.

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
    return _draw(gen, logits[:, :, 1:], temperature), logits


def _splice(trunk, branch_tokens, fork_idx):
    """Per-branch completed block: trunk up to the fork, branch tokens
    after. trunk [B,g-1], branch_tokens [B,K,g-1], fork_idx [B,K] ->
    [B,K,g-1], the visible prefixes of the third-level drafts."""
    slot = torch.arange(1, trunk.shape[1] + 1, device=trunk.device)
    use_trunk = slot[None, None, :] <= fork_idx[:, :, None]
    return torch.where(use_trunk, trunk[:, None, :].long(),
                       branch_tokens.long())


def comb_draft_probs(tree, d1_logits, d2_logits, g, temp, d3_logits=None,
                     d2_temp=None):
    """Per-node drafter categoricals q_n [B,N,V] for sampling verify:
    softmax(logits / temperature) of the pass and slot that drew node n's
    token. Trunk nodes (n < g) from d1 [B,g,V]; second-level nodes from
    branch b's row of d2 [B,K2,g,V] (b clipped to K2-1, so K2 = 1 gives
    every branch the same rows, as ``naive_k``'s resamples of d1), at
    ``d2_temp`` (default ``temp``); third-level nodes (the last
    K3*(g-1)) from d3 [B,K3,g,V]. d2 None: every node from d1."""
    b, n = tree.tokens.shape
    dev = tree.tokens.device
    node = torch.arange(n, device=dev)
    slot = tree.depth.clamp(0, g - 1)                          # [B,N]
    rows, row = [d1_logits.float() / temp], slot
    if d2_logits is not None:
        k2 = d2_logits.shape[1]
        n3 = 0 if d3_logits is None else d3_logits.shape[1] * (g - 1)
        bidx = torch.div(node - g, g - 1, rounding_mode="floor").clamp(
            0, k2 - 1)
        rows.append(d2_logits.float().reshape(b, k2 * g, -1)
                    / (d2_temp or temp))
        row = torch.where((node < g)[None], slot, g + bidx[None] * g + slot)
        if n3:
            k3 = d3_logits.shape[1]
            b3 = torch.div(node - (n - n3), g - 1,
                           rounding_mode="floor").clamp(0, k3 - 1)
            rows.append(d3_logits.float().reshape(b, k3 * g, -1) / temp)
            row = torch.where((node >= n - n3)[None],
                              g + k2 * g + b3[None] * g + slot, row)
    q = torch.softmax(torch.cat(rows, 1), dim=-1)
    return torch.gather(q, 1, row[..., None].expand(-1, -1, q.shape[-1]))


# ------------------------------------------------------------ strategies ---
@register_strategy("dflash")
class DFlashStrategy(DraftStrategy):
    """Single-chain first-draft baseline (Table 1 rows "DFlash")."""

    def draft(self, bundle, state, gen):
        spec = bundle.spec
        temp = spec.temperature
        trunk, d1_logits = first_draft(bundle, state, gen, temp)
        conf = conf_lib.confidences(d1_logits[:, 1:],
                                    trunk if temp > 0 else None)
        tree = tree_lib.chain_tree(state.anchor, trunk)
        dprobs = (comb_draft_probs(tree, d1_logits, None, spec.gamma, temp)
                  if temp > 0 else None)
        return DraftResult(tree=tree, dprobs=dprobs, conf=conf,
                           max_children=1)

    def n_draft_passes(self, spec):
        return 1

    def n_tree_nodes(self, spec):
        return spec.gamma


@register_strategy("eagle")
class EagleStrategy(DraftStrategy):
    """Autoregressive chain drafter baseline (EAGLE-style, Table 1): g-1
    causal forwards of drafter 1."""

    def draft(self, bundle, state, gen):
        spec = bundle.spec
        g, temp = spec.gamma, spec.temperature
        trunk, chain_logits = dr.ar_chain_draft(
            bundle.d1_params, bundle.d1_cfg, state.anchor, state.d1_feat,
            steps=g - 1, temperature=temp, gen=gen)
        tree = tree_lib.chain_tree(state.anchor, trunk)
        dprobs = None
        if temp > 0:
            q = torch.softmax(chain_logits.float() / temp, dim=-1)
            dprobs = torch.cat([torch.zeros_like(q[:, :1]), q], 1)
        return DraftResult(tree=tree, dprobs=dprobs, conf=None,
                           max_children=1)

    def n_draft_passes(self, spec):
        return spec.gamma - 1

    def n_tree_nodes(self, spec):
        return spec.gamma


@register_strategy("naive_k")
class NaiveKStrategy(DraftStrategy):
    """Trunk + K resamples of the same d1 pass at temperature max(T, 1),
    all forked at the root (Table 5)."""

    def draft(self, bundle, state, gen):
        spec = bundle.spec
        g, kbr, temp = spec.gamma, spec.top_k_branches, spec.temperature
        b = state.batch
        trunk, d1_logits = first_draft(bundle, state, gen, temp)
        conf = conf_lib.confidences(d1_logits[:, 1:],
                                    trunk if temp > 0 else None)
        t_res = max(temp, 1.0)
        resampled = pm.categorical(gen, (d1_logits[:, None, 1:].float()
                                         / t_res).expand(b, kbr, -1, -1))
        fork_idx = torch.zeros((b, kbr), dtype=torch.long,
                               device=trunk.device)
        tree = tree_lib.comb_tree(state.anchor, trunk, resampled, fork_idx,
                                  g)
        dprobs = (comb_draft_probs(tree, d1_logits, d1_logits[:, None], g,
                                   temp, d2_temp=t_res)
                  if temp > 0 else None)
        return DraftResult(tree=tree, dprobs=dprobs, conf=conf,
                           max_children=kbr + 1)

    def n_draft_passes(self, spec):
        return 1

    def n_tree_nodes(self, spec):
        return spec.gamma + spec.top_k_branches * (spec.gamma - 1)


@register_strategy("d2sd")
class D2SDStrategy(DraftStrategy):
    """DFlash trunk -> Eq. 5 top-K forks -> batched VP second draft (+ the
    optional third level, Table 7)."""

    def draft(self, bundle, state, gen):
        spec = bundle.spec
        g, kbr, temp = spec.gamma, spec.top_k_branches, spec.temperature
        b = state.batch
        trunk, d1_logits = first_draft(bundle, state, gen, temp)
        conf = conf_lib.confidences(d1_logits[:, 1:],
                                    trunk if temp > 0 else None)
        r = conf_lib.boundary_posterior(conf)
        _, fork_idx = conf_lib.topk_prefixes(r, kbr)             # [B, K]
        feat_len = state.d2_feat["length"]
        branch_tokens, d2_logits = second_draft(
            bundle.d2_params, bundle.d2_cfg, state.d2_feat, state.anchor,
            trunk, fork_idx, gen, temp, feat_len)
        tree = tree_lib.comb_tree(state.anchor, trunk, branch_tokens,
                                  fork_idx, g)
        max_children = kbr + 1
        d3_logits = None
        if spec.third_level:
            conf2 = conf_lib.confidences(
                d2_logits[:, :, 1:].reshape(b * kbr, g - 1, -1),
                branch_tokens.reshape(b * kbr, g - 1) if temp > 0
                else None).reshape(b, kbr, g - 1)
            # only suffix slots (> fork) are third-level candidates
            slot = torch.arange(1, g, device=conf2.device)[None, None, :]
            c2 = torch.where(slot > fork_idx[:, :, None] + 1, conf2,
                             torch.ones_like(conf2))
            r2 = conf_lib.boundary_posterior(c2)
            fork3 = torch.maximum(torch.argmax(r2, dim=-1),
                                  fork_idx + 1).clamp(0, g - 2)
            third_tokens, d3_logits = second_draft(
                bundle.d2_params, bundle.d2_cfg, state.d2_feat,
                state.anchor, _splice(trunk, branch_tokens, fork_idx),
                fork3, gen, temp, feat_len)
            tree = tree_lib.extend_third_level(tree, third_tokens, fork_idx,
                                               fork3, g)
            max_children += 1
        dprobs = (comb_draft_probs(tree, d1_logits, d2_logits, g, temp,
                                   d3_logits=d3_logits)
                  if temp > 0 else None)
        return DraftResult(tree=tree, dprobs=dprobs, conf=conf,
                           max_children=max_children)

    def n_draft_passes(self, spec):
        return 3 if spec.third_level else 2

    def n_tree_nodes(self, spec):
        base = spec.gamma + spec.top_k_branches * (spec.gamma - 1)
        if spec.third_level:
            base += spec.top_k_branches * (spec.gamma - 1)
        return base


@register_strategy("dflash_second")
class DFlashSecondStrategy(D2SDStrategy):
    """Table 6 ablation: the d2sd pipeline with drafter 1's weights reused
    as the second drafter (the caller wires ``bundle.d2_params`` to drafter
    1's params; the draft phase is d2sd's)."""

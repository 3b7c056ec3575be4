"""Verification (twin of ``repro/core/verify.py``): greedy acceptance and
the tree-attention verify backend for pure-attention targets.

Greedy rule: node n is ok iff argmax(target logits at parent(n)) ==
token(n); acceptance propagates along ancestors; the deepest accepted
node's path is committed; bonus = target argmax there. Output equals
pure greedy target decoding exactly.

Sampling verify and the state-replay backend (recurrent targets) are
ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import Tree, best_path, propagate_acceptance
from repro_torch.models import lm


def greedy_verify(tree: Tree, target_logits):
    """target_logits: [B, N, V] at every tree node.

    Returns dict(best [B], n_acc [B], path [B, D+1], bonus [B],
    accepted [B,N], ok [B,N]).
    """
    n = target_logits.shape[1]
    pred = torch.argmax(target_logits, dim=-1)                # [B, N]
    pred_at_parent = torch.gather(pred, 1, tree.parent.clamp(0, n - 1))
    ok = (pred_at_parent == tree.tokens) & tree.valid
    accepted = propagate_acceptance(tree, ok)
    best, n_acc, path = best_path(tree, accepted)
    bonus = torch.gather(pred, 1, best[:, None])[:, 0]
    return {"best": best, "n_acc": n_acc, "path": path, "bonus": bonus,
            "accepted": accepted, "ok": ok}


@dataclasses.dataclass(frozen=True)
class VerifyOutcome:
    """res: acceptance dict; target: target states advanced by n_acc+1
    tokens; path_feats: [B, D+1, Fd] target features along the path."""
    res: dict
    target: Any
    path_feats: torch.Tensor


class VerifierBackend:
    """Protocol: run the target over a tree and commit the accepted path."""

    name: str = "?"

    def verify(self, bundle, state, tree: Tree) -> VerifyOutcome:
        raise NotImplementedError


def uses_tree_attention(cfg) -> bool:
    """Tree-masked verification requires a pure-attention target."""
    return not (set(cfg.pattern_for_depth()) & {"recurrent", "rwkv"})


def select_backend(cfg) -> VerifierBackend:
    if not uses_tree_attention(cfg):
        raise NotImplementedError(
            "StateReplayVerifier is not ported: ROADMAP.md queue 1, slice 3")
    return TreeAttentionVerifier()


class TreeAttentionVerifier(VerifierBackend):
    """Cascade tree-attention verify + KV gather-commit. With
    ``ModelConfig.attn_impl="kernel"`` the target forward reads its caches
    through the CUDA cascade kernels (``models/blocks.py``)."""

    name = "tree_attention"

    def verify(self, bundle, state, tree):
        tcfg = bundle.target_cfg
        if bundle.spec.temperature > 0:
            raise NotImplementedError(
                "sampling verify is not ported: ROADMAP.md queue 1, slice 1")
        mask = tree_lib.attention_mask(tree)
        positions = tree_lib.positions(tree, state.target["length"])
        vout = lm.forward(bundle.target_params, tree.tokens, tcfg,
                          states=state.target, write_kv=False,
                          extra_mask=mask, positions=positions,
                          want_features=True)
        logits = vout["logits"].float()
        logits = torch.where(tree.valid[:, :, None], logits, -1e9)
        res = greedy_verify(tree, logits)
        # inactive rows commit nothing (length frozen, no cache writes)
        n_commit = torch.where(state.active, res["n_acc"] + 1,
                               torch.zeros_like(res["n_acc"]))
        new_target = lm.commit_kv(state.target, vout["kv_outs"], tcfg,
                                  res["path"], n_commit)
        feats = vout["features"]
        path_feats = torch.gather(
            feats, 1, res["path"][..., None].expand(-1, -1, feats.shape[-1]))
        return VerifyOutcome(res=res, target=new_target,
                             path_feats=path_feats)

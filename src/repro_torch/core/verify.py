"""Verification (twin of ``repro/core/verify.py``): the acceptance rules
and the tree-attention verify backend for pure-attention targets.

Greedy (T=0): node n is ok iff argmax(target logits at parent(n)) ==
token(n); acceptance propagates along ancestors; the deepest accepted
node's path is committed; bonus = target argmax there. Output equals
pure greedy target decoding exactly.

Sampling (T>0): SpecInfer-style recursive rejection sampling across
sibling branches. At the frontier node we hold the target residual
distribution p; children are tried in node order: accept child c (token
x, drafter distribution q_c, the categorical x was drawn from) with
probability min(1, p(x)/q_c(x)); on rejection p <- normalize(max(p - q_c,
0)). If no child is accepted the bonus is drawn from the final residual.
Every random number of a verify is drawn up front in fixed-shape calls on
the cycle's generator (:func:`sampling_verify`); the rule itself
(:func:`sampling_verify_core`) takes them as inputs.

The state-replay backend (recurrent targets) is a ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import (Tree, best_path, children_table,
                                   propagate_acceptance)
from repro_torch.models import lm
from repro_torch.models import param as pm


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


def sampling_draws(gen, tree: Tree, vocab: int, max_children: int):
    """Every random number one :func:`sampling_verify_core` reads, in two
    fixed-shape draws on ``gen``: the acceptance uniforms [D*C, B] (one
    per depth and child slot, in the order the rule visits them) and the
    bonus's Gumbel noise [B, V]."""
    b, d = tree.b, tree.max_depth
    u = torch.rand((d * max_children, b), generator=gen, device=gen.device)
    return u, pm.gumbel(gen, (b, vocab))


def sampling_verify(tree: Tree, target_logits, draft_probs, gen,
                    max_children: int, temperature: float = 1.0):
    """Lossless multi-branch speculative sampling: the draws of
    :func:`sampling_draws`, then :func:`sampling_verify_core`."""
    u, noise = sampling_draws(gen, tree, target_logits.shape[-1],
                              max_children)
    return sampling_verify_core(tree, target_logits, draft_probs, u, noise,
                                max_children, temperature)


def _rows(arr, idx):
    """arr [B,N,V] or [B,N], idx [B] -> [B,V] or [B]."""
    if arr.ndim == 3:
        return torch.gather(arr, 1, idx[:, None, None].expand(
            -1, 1, arr.shape[-1]))[:, 0]
    return torch.gather(arr, 1, idx[:, None])[:, 0]


def sampling_verify_core(tree: Tree, target_logits, draft_probs, u, noise,
                         max_children: int, temperature: float = 1.0):
    """The rule of JAX ``sampling_verify`` on given random numbers.

    draft_probs: [B, N, V] the categorical q_n each node's token was drawn
    from (root row ignored); u: [D*C, B] uniforms in [0, 1), entry d*C + c
    for child slot c at depth d (JAX draws ``uniform(keys[d*C + c])``);
    noise: [B, V] Gumbel noise for the bonus draw (JAX:
    ``categorical(keys[D*C], log p)``). Fixed-shape: D*C unrolled steps.
    Returns the dict of :func:`greedy_verify` (bonus sampled).
    """
    b, n, _ = target_logits.shape
    c_max = max_children
    dev = target_logits.device
    kids = children_table(tree, c_max)                         # [B, N, C]
    p_target = torch.softmax(
        target_logits.float() / max(temperature, 1e-6), dim=-1)
    cur = torch.zeros((b,), dtype=torch.long, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((b,), dtype=torch.long, device=dev)
    p_res = _rows(p_target, cur)                               # [B, V]
    chosen = [cur]
    node = torch.arange(n, device=dev)
    accepted = (node == 0)[None].expand(b, n)
    for d in range(tree.max_depth):
        nxt = cur
        took = torch.zeros((b,), dtype=torch.bool, device=dev)
        for c in range(c_max):
            child = _rows(kids[:, :, c], cur)
            has = (child >= 0) & alive & ~took
            child_s = child.clamp(0, n - 1)
            tok = _rows(tree.tokens, child_s)
            qc = _rows(draft_probs, child_s)
            px = torch.gather(p_res, 1, tok[:, None])[:, 0]
            qx = torch.gather(qc, 1, tok[:, None])[:, 0]
            accept = has & (u[d * c_max + c] <= px / qx.clamp_min(1e-30))
            nxt = torch.where(accept, child_s, nxt)
            took = took | accept
            p_new = (p_res - qc).clamp_min(0.0)
            p_new = p_new / p_new.sum(-1, keepdim=True).clamp_min(1e-30)
            p_res = torch.where((has & ~accept)[:, None], p_new, p_res)
        p_res = torch.where(took[:, None], _rows(p_target, nxt), p_res)
        n_acc = n_acc + took.long()
        alive = alive & took
        cur = nxt
        chosen.append(cur)
        accepted = accepted | ((node[None] == cur[:, None]) & took[:, None])
    bonus = torch.argmax(torch.log(p_res.clamp_min(1e-30)) + noise, dim=-1)
    return {"best": cur, "n_acc": n_acc, "path": torch.stack(chosen, 1),
            "bonus": bonus, "accepted": accepted, "ok": accepted}


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

    def verify(self, bundle, state, tree: Tree, dprobs, max_children: int,
               gen) -> VerifyOutcome:
        raise NotImplementedError


def uses_tree_attention(cfg) -> bool:
    """Tree-masked verification requires a pure-attention target."""
    return not (set(cfg.pattern_for_depth()) & {"recurrent", "rwkv"})


def select_backend(cfg) -> VerifierBackend:
    if not uses_tree_attention(cfg):
        raise NotImplementedError(
            "StateReplayVerifier is not ported: ROADMAP.md queue 1, slice C")
    return TreeAttentionVerifier()


class TreeAttentionVerifier(VerifierBackend):
    """Cascade tree-attention verify + KV gather-commit. With
    ``ModelConfig.attn_impl="kernel"`` the target forward reads its caches
    through the CUDA cascade kernels (``models/blocks.py``)."""

    name = "tree_attention"

    def verify(self, bundle, state, tree, dprobs, max_children, gen):
        tcfg = bundle.target_cfg
        temp = bundle.spec.temperature
        mask = tree_lib.attention_mask(tree)
        positions = tree_lib.positions(tree, state.target["length"])
        vout = lm.forward(bundle.target_params, tree.tokens, tcfg,
                          states=state.target, write_kv=False,
                          extra_mask=mask, positions=positions,
                          want_features=True)
        logits = vout["logits"].float()
        logits = torch.where(tree.valid[:, :, None], logits, -1e9)
        if temp > 0:
            res = sampling_verify(tree, logits, dprobs, gen, max_children,
                                  temperature=temp)
        else:
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

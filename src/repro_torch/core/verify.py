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

Backends: :class:`TreeAttentionVerifier` (one forward over the whole tree
with an ancestor mask, then a KV gather-commit; pure-attention targets)
and :class:`StateReplayVerifier` (recurrent and hybrid targets: the tree's
root-to-leaf rows folded into the batch for one read-only forward, then a
replay of the accepted path that advances every state by exactly the
committed tokens). :func:`select_backend` picks by the target's blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.tree import (Tree, best_path, children_table,
                                   propagate_acceptance)
from repro_torch.models import kvcache as kvc
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
    u = pm.uniform(gen, (d * max_children, b), dim=1)
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
    """Pick the verify backend from the target's blocks."""
    return (TreeAttentionVerifier() if uses_tree_attention(cfg)
            else StateReplayVerifier())


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


class StateReplayVerifier(VerifierBackend):
    """Verification for recurrent (SSM / hybrid) targets (JAX DESIGN §5.1).

    Enumerate the root-to-leaf token row of every branch (R rows of
    ``max_depth + 1`` tokens), run the target once with the rows folded
    into the batch (read-only: no cache or state is written; the
    attention layers read their caches through the cascade kernels under
    ``attn_impl="kernel"``), accept each row's longest greedy prefix and
    take the best row per example, then REPLAY the accepted path with
    ``write_kv`` and ``snap_at`` so every cache and recurrent state
    advances by exactly ``n_acc + 1`` tokens, in place.

    As in JAX, acceptance is greedy at every temperature: ``dprobs`` and
    the generator are not used, so a recurrent target's sampled output is
    its greedy output (not a lossless sample of the target).
    """

    name = "state_replay"

    def verify(self, bundle, state, tree, dprobs, max_children, gen):
        del dprobs, max_children, gen
        tcfg = bundle.target_cfg
        g = tree.max_depth + 1
        b = tree.tokens.shape[0]
        rows = _paths_to_leaves(tree)                          # [B, R, g]
        r = rows.shape[1]
        flat_rows = rows.reshape(b * r, g)
        row_tokens = torch.gather(
            tree.tokens.repeat_interleave(r, dim=0), 1, flat_rows)

        vout = lm.forward(bundle.target_params, row_tokens, tcfg,
                          states=_repeat_rows(state.target, r),
                          write_kv=False)
        pred_full = torch.argmax(vout["logits"].float(), dim=-1)  # [B*R, g]
        ok = pred_full[:, :-1] == row_tokens[:, 1:]
        # padded path entries repeat the leaf node: nothing past its depth
        depth_leaf = torch.gather(tree.depth, 1, rows[:, :, -1])   # [B, R]
        ok = ok & (torch.arange(g - 1, device=ok.device)[None, :]
                   < depth_leaf.reshape(b * r)[:, None])
        n_acc_r = torch.cumprod(ok.long(), dim=1).sum(1).reshape(b, r)
        best_row = torch.argmax(n_acc_r, dim=1)                # first max
        n_acc = torch.gather(n_acc_r, 1, best_row[:, None])[:, 0]
        pick = best_row[:, None, None].expand(b, 1, g)
        path = torch.gather(rows, 1, pick)[:, 0]               # [B, g]
        pred_best = torch.gather(pred_full.reshape(b, r, g), 1, pick)[:, 0]
        bonus = torch.gather(pred_best, 1, n_acc[:, None])[:, 0]

        # replay the accepted path; inactive rows snap at 0: no cache
        # write and no length change (JAX's clip still moves their rg_h
        # and x_prev leaves by the path's first token: ROADMAP queue 3)
        n_commit = torch.where(state.active, n_acc + 1,
                               torch.zeros_like(n_acc))
        path_tokens = torch.gather(tree.tokens, 1, path)
        rout = lm.forward(bundle.target_params, path_tokens, tcfg,
                          states=state.target, write_kv=True,
                          snap_at=n_commit, attend_cache_on_write=True,
                          want_features=True, want_logits=False)
        res = {"best": torch.gather(path, 1, n_acc[:, None])[:, 0],
               "n_acc": n_acc, "path": path, "bonus": bonus,
               "accepted": None, "ok": None}
        return VerifyOutcome(res=res, target=rout["states"],
                             path_feats=rout["features"])


def _repeat_rows(target, r):
    """The target states with every batch row repeated ``r`` times, for
    the read-only pass (new tensors: the pass writes nothing, and the
    caller's states stay as they are). Every leaf of the port's layout is
    batch-leading; a paged cache's pools have no batch axis and are
    shared, only its page-table rows repeat (JAX ``rep_block``)."""
    def blk(d):
        paged = kvc.is_paged(d)
        return {name: (v if paged and name in ("k", "v")
                       else kvc.like(v, v.repeat_interleave(r, dim=0)))
                for name, v in d.items()}

    return {"layers": [blk(d) for d in target["layers"]],
            "length": target["length"].repeat_interleave(r, dim=0)}


def _paths_to_leaves(tree: Tree):
    """[B, R, g] node-index rows, one per leaf (the trunk, then each
    branch), root first.

    Each row is a parent walk from the last valid node of a branch
    segment: the layout the comb and chain trees of the built-in
    strategies have (trunk nodes 0..g-1, then K segments of g-1 nodes).
    Entries past a leaf's depth repeat the leaf.
    """
    b, n = tree.tokens.shape
    g = tree.max_depth + 1
    dev = tree.tokens.device
    if n == g:                                     # chain
        leaves = torch.full((b, 1), n - 1, dtype=torch.long, device=dev)
    else:
        k = (n - g) // (g - 1)
        cols = [torch.full((b,), g - 1, dtype=torch.long, device=dev)]
        for s in range(k):
            start = g + s * (g - 1)
            n_valid = tree.valid[:, start:start + g - 1].long().sum(1)
            cols.append(start + (n_valid - 1).clamp(min=0))
        leaves = torch.stack(cols, dim=1)
    parent = tree.parent.long()
    ups = [leaves]
    cur = leaves
    for _ in range(g - 1):
        cur = torch.gather(parent, 1, cur).clamp(min=0)
        ups.append(cur)
    up = torch.stack(ups, dim=2)                   # [B, R, g] leaf -> root
    depth_leaf = torch.gather(tree.depth.long(), 1, leaves)        # [B, R]
    d_idx = torch.arange(g, device=dev)[None, None, :]
    take = (depth_leaf[:, :, None] - d_idx).clamp(0, g - 1)
    path = torch.gather(up, 2, take)
    return torch.where(d_idx <= depth_leaf[:, :, None], path,
                       leaves[:, :, None])


def chain_prefix_accept_greedy(tokens, target_logits):
    """Sequential prefix acceptance for branch-batched (SSM) verification.

    tokens: [B, T] candidate tokens whose parents are the previous
    positions (logits[:, i] predicts tokens[:, i]); target_logits:
    [B, T, V]. Returns (n_acc [B], pred [B, T]).
    """
    pred = torch.argmax(target_logits, dim=-1)
    ok = pred == tokens
    return torch.cumprod(ok.long(), dim=1).sum(1), pred

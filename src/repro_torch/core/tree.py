"""Candidate prefix trees for joint verification (twin of
``repro/core/tree.py``, paper §3.2-3.3).

A tree is a static-shape node table (size N) with per-example parent
pointers. Node 0 is the anchor (root); invalid (padding) nodes carry
valid=False. All fields are batched [B, N].
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.kvcache import drop_put_


@dataclasses.dataclass(frozen=True)
class Tree:
    tokens: torch.Tensor     # [B, N] long
    parent: torch.Tensor     # [B, N] long (parent[0] = -1)
    depth: torch.Tensor      # [B, N] long (root depth 0)
    valid: torch.Tensor      # [B, N] bool
    max_depth: int           # static bound on depth

    @property
    def n(self) -> int:
        return self.parent.shape[-1]

    @property
    def b(self) -> int:
        return self.parent.shape[0]


def _gather(arr, idx):
    """arr [B,N], idx [B,M] -> [B,M]."""
    return torch.gather(arr, 1, idx)


def comb_tree(anchor, trunk_tokens, branch_tokens, fork_idx, gamma: int):
    """The D2SD comb tree.

    anchor [B]; trunk_tokens [B, gamma-1]; branch_tokens [B, K, gamma-1];
    fork_idx [B, K] prefix lengths in 0..gamma-2.

    Node layout (N = gamma + K*(gamma-1)): node 0 anchor; nodes 1..gamma-1
    trunk token i at depth i; node gamma + b*(gamma-1) + j: branch b suffix
    node j at slot fork_b+1+j, valid iff slot <= gamma-1.
    """
    b = anchor.shape[0]
    g = gamma
    k = branch_tokens.shape[1]
    n = g + k * (g - 1)
    dev = anchor.device
    fork_idx = fork_idx.long()

    node = torch.arange(n, device=dev)
    trunk_part = node < g
    bidx = torch.div(node - g, g - 1, rounding_mode="floor").clamp(
        0, max(k - 1, 0))
    j = (node - g - bidx * (g - 1)).clamp(0, g - 2)
    fork = fork_idx[:, bidx]                               # [B, N]
    slot = torch.where(trunk_part[None], node[None], fork + 1 + j[None])
    depth = slot
    valid = torch.where(trunk_part[None], torch.ones_like(slot, dtype=torch.bool),
                        slot <= g - 1)
    parent = torch.where(trunk_part[None], node[None] - 1,
                         torch.where((j == 0)[None], fork, node[None] - 1))
    parent = torch.where(node[None] == 0, torch.full_like(parent, -1), parent)

    slot_c = (slot - 1).clamp(0, g - 2)
    trunk_tok = _gather(trunk_tokens.long(), slot_c)
    br_tok = _gather(branch_tokens.long().reshape(b, -1),
                     bidx[None] * (g - 1) + slot_c)
    tokens = torch.where(trunk_part[None], trunk_tok, br_tok)
    tokens = torch.where(node[None] == 0, anchor.long()[:, None], tokens)
    tokens = torch.where(valid, tokens, torch.zeros_like(tokens))
    return Tree(tokens=tokens, parent=parent.expand(b, n),
                depth=depth.expand(b, n), valid=valid.expand(b, n),
                max_depth=g - 1)


def extend_third_level(tree: Tree, branch_tokens3, fork_idx, fork3_idx,
                       gamma: int):
    """Table 7: one more VP level, one branch per second-level branch,
    forked at that branch's own boundary.

    branch_tokens3: [B, K, gamma-1] third-draft tokens for slots
    1..gamma-1; fork_idx: [B, K] second-level forks i_b; fork3_idx: [B, K]
    third-level fork slots s_b >= i_b. The third branch of b hangs off
    branch b's node at slot s_b (off trunk node i_b when s_b == i_b) and
    re-drafts slots s_b+1..gamma-1: node n0 + b*(gamma-1) + j at slot
    s_b+1+j, valid iff slot <= gamma-1.
    """
    b, k = fork_idx.shape
    g = gamma
    n0 = tree.n
    dev = fork_idx.device
    fork_idx, fork3_idx = fork_idx.long(), fork3_idx.long()
    node = torch.arange(k * (g - 1), device=dev)
    bidx = torch.div(node, g - 1, rounding_mode="floor")
    j = node - bidx * (g - 1)
    s = fork3_idx[:, bidx]                                  # [B, n3]
    slot = s + 1 + j[None]
    valid = slot <= g - 1
    ib = fork_idx[:, bidx]
    head = torch.where(s > ib, g + bidx[None] * (g - 1) + (s - ib - 1), ib)
    parent = torch.where((j == 0)[None], head, n0 + node[None] - 1)
    slot_c = (slot - 1).clamp(0, g - 2)
    toks = _gather(branch_tokens3.long().reshape(b, -1),
                   bidx[None] * (g - 1) + slot_c)
    toks = torch.where(valid, toks, torch.zeros_like(toks))
    return Tree(tokens=torch.cat([tree.tokens, toks], 1),
                parent=torch.cat([tree.parent, parent], 1),
                depth=torch.cat([tree.depth, slot], 1),
                valid=torch.cat([tree.valid, valid], 1),
                max_depth=tree.max_depth)


def chain_tree(anchor, tokens):
    """Single chain (DFlash / EAGLE baseline): tokens [B,G]."""
    b, g = tokens.shape
    n = g + 1
    node = torch.arange(n, device=anchor.device)
    toks = torch.cat([anchor.long()[:, None], tokens.long()], dim=1)
    return Tree(tokens=toks, parent=(node - 1).expand(b, n),
                depth=node.expand(b, n),
                valid=torch.ones((b, n), dtype=torch.bool,
                                 device=anchor.device),
                max_depth=g)


def ancestor_mask(tree: Tree):
    """[B, N, N] bool: M[u, v] = v is ancestor-of-or-equal-to u."""
    b, n = tree.parent.shape
    dev = tree.parent.device
    m = torch.eye(n, dtype=torch.bool, device=dev).expand(b, n, n).clone()
    cur = tree.parent
    for _ in range(tree.max_depth):
        hot = cur.clamp(0, n - 1)[..., None] == torch.arange(n, device=dev)
        m = m | (hot & (cur >= 0)[..., None])
        cur = torch.where(cur >= 0, _gather(tree.parent, cur.clamp(0, n - 1)),
                          torch.full_like(cur, -1))
    return m


def attention_mask(tree: Tree):
    """Tree attention mask including validity: [B, N, N]."""
    m = ancestor_mask(tree)
    b, n = tree.parent.shape
    eye = torch.eye(n, dtype=torch.bool, device=m.device).expand(b, n, n)
    return (m & tree.valid[:, None, :] & tree.valid[:, :, None]) | eye


def positions(tree: Tree, base):
    """Absolute positions for RoPE: base + depth. base: [B] -> [B, N]."""
    return (base.long()[:, None] + tree.depth).to(torch.int32)


def children_table(tree: Tree, max_children: int):
    """[B, N, C] children per node (-1 padded), siblings in node order
    (the trunk child first in a comb tree). A child past the C-th of its
    parent is dropped, as JAX's ``mode="drop"`` scatter drops it; the
    write is fixed-shape (``kvcache.drop_put_``)."""
    b, n = tree.parent.shape
    dev = tree.parent.device
    parent = torch.where(tree.valid, tree.parent,
                         torch.full_like(tree.parent, -2))
    order = torch.arange(n, device=dev)
    same = (parent[:, None, :] == parent[:, :, None]) & (
        order[None, None, :] < order[None, :, None])
    rank = same.sum(2)                                      # [B, N]
    ok = (parent >= 0) & (rank < max_children)
    flat = (torch.arange(b, device=dev)[:, None] * n
            + parent.clamp(0, n - 1)) * max_children + rank.clamp(
                max=max_children - 1)
    tbl = torch.full((b * n * max_children,), -1, dtype=torch.long,
                     device=dev)
    drop_put_(tbl, 0, flat.reshape(-1), order.expand(b, n).reshape(-1),
              ok.reshape(-1))
    return tbl.view(b, n, max_children)


def best_path(tree: Tree, accepted):
    """Longest accepted prefix across branches (paper step iv).

    accepted: [B, N] bool. Returns (best [B], n_acc [B], path [B, D+1]):
    path[d] = node at depth d along the best root-to-leaf walk (padded with
    the leaf beyond n_acc).
    """
    acc = accepted & tree.valid
    acc[:, 0].fill_(True)
    score = torch.where(acc, tree.depth, torch.full_like(tree.depth, -1))
    best = torch.argmax(score, dim=1)            # first max, as jnp.argmax
    n_acc = _gather(score, best[:, None])[:, 0]

    d_max = tree.max_depth
    path_rev = [best]
    cur = best
    for _ in range(d_max):
        cur = _gather(tree.parent, cur[:, None])[:, 0].clamp_min(0)
        path_rev.append(cur)
    path_up = torch.stack(path_rev, dim=1)       # [B, D+1] leaf->root
    d_idx = torch.arange(d_max + 1, device=best.device)[None, :]
    take = (n_acc[:, None] - d_idx).clamp(0, d_max)
    path = _gather(path_up, take)
    path = torch.where(d_idx <= n_acc[:, None], path, best[:, None])
    return best, n_acc, path


def propagate_acceptance(tree: Tree, node_ok):
    """accepted[n] = node_ok[n] AND all ancestors ok (root True). [B,N]."""
    n = node_ok.shape[1]
    acc = node_ok.clone()
    acc[:, 0].fill_(True)
    parent_c = tree.parent.clamp(0, n - 1)
    has_parent = tree.parent >= 0
    for _ in range(2 * tree.max_depth + 1):
        acc = acc & torch.where(has_parent, _gather(acc, parent_c),
                                torch.ones_like(acc))
    return acc

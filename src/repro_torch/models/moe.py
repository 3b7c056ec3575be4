"""Mixture-of-Experts FFN (twin of ``repro/models/moe.py``).

Dispatch paths (same math; held to each other and to JAX):

* ``einsum``  — GShard-style one-hot dispatch and combine (the oracle).
* ``scatter`` — capacity buckets: the kept (token, expert) pairs are
  written into ``[E, C, d]`` expert inputs, the experts run as batched
  products, and each token gathers its k outputs back. ``all_to_all``
  runs this path too.

Inside a mesh whose ``experts`` axis is active (``distributed/ep.py``:
``ep_available``), both non-einsum dispatches go to expert parallelism,
``ep.moe_apply_ep``, with its own capacity; the shared experts are added
on every rank.

Routing: softmax over the experts, top-k, the k gates renormalized;
capacity ``C = max(ceil(T*k/E * capacity_factor), min(8, T))`` over all
B*T tokens of the pass, with priority in row-major token order; a pair
past its expert's capacity drops that expert's contribution (GShard).
Shared experts (DeepSeek-style) bypass routing.

Every shape is fixed by the pass's token count and the config, and no
step reads the device from the host, so a CUDA graph captures a MoE
verify as it does a dense one. The combine sums each token's k
contributions in a fixed order (``[T, k, d]`` summed over k), not with
atomics, so fp32 results repeat bitwise from run to run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import param as pm
from repro_torch.models.layers import act_fn
from repro_torch.models.mlp import mlp, mlp_init


def moe_init(gen, cfg, expert_part=None):
    """Router [d, E], expert stacks [E, d, ff] / [E, ff, d] and the shared
    expert's MLP. The stacks are allocated once in ``cfg.param_dtype`` and
    filled an expert at a time, so a stack never exists twice (kimi-k2's
    three stacks are 16.9e9 parameters a layer). ``expert_part`` (an
    expert-parallel rank's ``ep.expert_part``): every expert is drawn as
    here, and only that part of each stack is kept."""
    m = cfg.moe
    d, dff, e = cfg.d_model, cfg.d_ff, m.num_experts
    dtype = getattr(torch, cfg.param_dtype)
    e0, ne, f0, nf = expert_part or (0, e, 0, dff)

    def stack(name, din, dout, scale=None):
        out = name == "moe_w_out"
        w = torch.empty((ne, nf if out else din, dout if out else nf),
                        dtype=dtype, device=gen.device)
        for i in range(e):
            wi = pm.dense_init(gen, din, dout, scale=scale)
            if e0 <= i < e0 + ne:
                w[i - e0].copy_(wi[f0:f0 + nf] if out else wi[:, f0:f0 + nf])
        return w

    p = {"router": pm.dense_init(gen, d, e, scale=0.02),
         "moe_w_in": stack("moe_w_in", d, dff),
         "moe_w_out": stack("moe_w_out", dff, d, scale=dff ** -0.5)}
    if cfg.mlp_gated:
        p["moe_w_gate"] = stack("moe_w_gate", d, dff)
    if m.num_shared_experts:
        p["shared"] = mlp_init(gen, d, dff * m.num_shared_experts,
                               cfg.mlp_gated)
    return p


def _route(p, x2, cfg):
    """x2: [T, d] -> (gates [T, k] fp32, idx [T, k])."""
    logits = x2.float() @ p["router"].float()
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), cfg.moe.top_k,
                            dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def _capacity(t: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(t * m.top_k / m.num_experts * m.capacity_factor))
    return max(c, min(8, t))


def _expert_ffn(p, xin, cfg):
    """xin: [E, C, d] -> [E, C, d], batched expert products."""
    h = torch.bmm(xin, p["moe_w_in"].to(xin.dtype))
    if cfg.mlp_gated:
        g = torch.bmm(xin, p["moe_w_gate"].to(xin.dtype))
        h = act_fn(cfg.mlp_act)(g) * h
    else:
        h = act_fn(cfg.mlp_act)(h)
    return torch.bmm(h, p["moe_w_out"].to(xin.dtype))


def moe_apply(p, x, cfg, dispatch: Optional[str] = None):
    """x: [B, T, d] -> [B, T, d]."""
    m = cfg.moe
    dispatch = dispatch or m.dispatch
    b, t, d = x.shape
    if dispatch != "einsum":
        from repro_torch.distributed import ep
        if ep.ep_available(cfg):
            y = ep.moe_apply_ep(p, x, cfg)
            if m.num_shared_experts:
                y = y + mlp(p["shared"], x, cfg.mlp_act,
                            cfg.mlp_gated).to(y.dtype)
            return y.to(x.dtype)
    x2 = x.reshape(b * t, d)
    gates, idx = _route(p, x2, cfg)
    cap = _capacity(b * t, cfg)
    if dispatch == "einsum":
        y2 = _apply_einsum(p, x2, gates, idx, cap, cfg)
    elif dispatch in ("scatter", "all_to_all"):
        y2 = _apply_scatter(p, x2, gates, idx, cap, cfg).sum(1)
    else:
        raise ValueError(dispatch)
    if m.num_shared_experts:
        y2 = y2 + mlp(p["shared"], x2[None], cfg.mlp_act,
                      cfg.mlp_gated)[0].to(y2.dtype)
    return y2.reshape(b, t, d).to(x.dtype)


def _positions(idx, e: int):
    """Rank of each (token, choice) within its expert's queue, [T, k]:
    a running count over the row-major (token, choice) order."""
    flat = idx.reshape(-1)
    onehot = (flat[:, None] == torch.arange(e, device=idx.device)).long()
    pos = onehot.cumsum(0) - 1                           # [T*k, E]
    return pos.gather(1, flat[:, None])[:, 0].reshape(idx.shape)


def _apply_einsum(p, x2, gates, idx, cap, cfg):
    e = cfg.moe.num_experts
    dev, dt = x2.device, x2.dtype
    pos = _positions(idx, e)
    keep = pos < cap
    # one-hot dispatch/combine tensors [T, E, C]; a dropped pair's slot
    # index is C, out of range: an all-zero row
    oh_e = (idx[..., None] == torch.arange(e, device=dev)).to(dt)
    slot = torch.where(keep, pos, cap)
    oh_c = (slot[..., None] == torch.arange(cap, device=dev)).to(dt)
    disp = torch.einsum("tke,tkc->tec", oh_e, oh_c)
    comb = torch.einsum("tke,tkc,tk->tec", oh_e, oh_c, gates.to(dt))
    xin = torch.einsum("tec,td->ecd", disp, x2)
    xout = _expert_ffn(p, xin, cfg)
    return torch.einsum("tec,ecd->td", comb, xout)


def _apply_scatter(p, x2, gates, idx, cap, cfg, experts=None):
    """The (token, choice) pairs' gated expert outputs, [T, k, d]. The kept
    pairs of the experts ``experts`` = (first, count) (all of them by
    default; an expert-parallel rank's part, whose stacks ``p`` holds) are
    written into ``[count, C, d]`` buckets, the experts run as batched
    products, and each pair gathers its output back; every other pair
    gives zero."""
    e = cfg.moe.num_experts
    e0, e_loc = experts or (0, e)
    t, d = x2.shape
    k = idx.shape[1]
    dt = x2.dtype
    pos = _positions(idx, e).reshape(-1)
    le = idx.reshape(-1) - e0
    keep = (le >= 0) & (le < e_loc) & (pos < cap)
    # the kept pairs own distinct slots; every other pair goes to one
    # spare slot past the buckets, which no one reads
    slot = torch.where(keep, le * cap + pos, e_loc * cap)
    xin = x2.new_zeros((e_loc * cap + 1, d)).index_copy(
        0, slot, x2.repeat_interleave(k, dim=0))[:-1].view(e_loc, cap, d)
    xout = _expert_ffn(p, xin, cfg).reshape(e_loc * cap, d)
    picked = xout[torch.where(keep, slot, 0)] * keep[:, None].to(dt)
    return (picked * gates.reshape(-1)[:, None].to(dt)).view(t, k, d)

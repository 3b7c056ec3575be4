"""Mixture-of-Experts FFN (twin of ``repro/models/moe.py``).

Dispatch paths (same math; held to each other and to JAX):

* ``einsum``  — GShard-style one-hot dispatch and combine (the oracle).
* ``scatter`` — capacity buckets: the kept (token, expert) pairs are
  written into ``[E, C, d]`` expert inputs, the experts run as batched
  products, and each token gathers its k outputs back. ``all_to_all``
  (JAX's expert-parallel dispatch under a mesh) runs this path here: the
  port has no mesh yet.

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


def moe_init(gen, cfg):
    """Router [d, E], expert stacks [E, d, ff] / [E, ff, d] and the shared
    expert's MLP. The stacks are allocated once in ``cfg.param_dtype`` and
    filled an expert at a time, so a stack never exists twice (kimi-k2's
    three stacks are 16.9e9 parameters a layer)."""
    m = cfg.moe
    d, dff, e = cfg.d_model, cfg.d_ff, m.num_experts
    dtype = getattr(torch, cfg.param_dtype)

    def stack(din, dout, scale=None):
        w = torch.empty((e, din, dout), dtype=dtype, device=gen.device)
        for i in range(e):
            w[i].copy_(pm.dense_init(gen, din, dout, scale=scale))
        return w

    p = {"router": pm.dense_init(gen, d, e, scale=0.02),
         "moe_w_in": stack(d, dff),
         "moe_w_out": stack(dff, d, scale=dff ** -0.5)}
    if cfg.mlp_gated:
        p["moe_w_gate"] = stack(d, dff)
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
    x2 = x.reshape(b * t, d)
    gates, idx = _route(p, x2, cfg)
    cap = _capacity(b * t, cfg)
    if dispatch == "einsum":
        y2 = _apply_einsum(p, x2, gates, idx, cap, cfg)
    elif dispatch in ("scatter", "all_to_all"):
        y2 = _apply_scatter(p, x2, gates, idx, cap, cfg)
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


def _apply_scatter(p, x2, gates, idx, cap, cfg):
    e = cfg.moe.num_experts
    t, d = x2.shape
    k = idx.shape[1]
    dt = x2.dtype
    pos = _positions(idx, e).reshape(-1)
    keep = pos < cap
    ef = idx.reshape(-1)
    # the kept pairs own distinct slots; every dropped pair of an expert
    # goes to one spare slot past the capacity, which no one reads
    slot = ef * (cap + 1) + torch.where(keep, pos, cap)
    xin = x2.new_zeros((e * (cap + 1), d)).index_copy(
        0, slot, x2.repeat_interleave(k, dim=0))
    xin = xin.view(e, cap + 1, d)[:, :cap]
    xout = _expert_ffn(p, xin, cfg)
    picked = xout[ef, torch.where(keep, pos, 0)] * keep[:, None].to(dt)
    w = gates.reshape(-1)[:, None].to(dt)
    return (picked * w).reshape(t, k, d).sum(1)

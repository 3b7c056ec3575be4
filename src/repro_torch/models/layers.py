"""Primitive layers: norms, dense projections, embeddings, RoPE, softcap
(twin of ``repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- norms ----
def rmsnorm(p, x, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * p["scale"].float()).to(dt)


# ---------------------------------------------------------------- dense ----
def dense(w, x, bias=None):
    """``x @ w`` with ``w`` shaped [d_in, d_out], computed in x's dtype."""
    y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ----------------------------------------------------------------- rope ----
def rope_freqs(head_dim, theta, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10000.0):
    """Half-split rotation, computed in fp32.

    x: [..., T, H, Dh]; positions: [..., T] integer.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # [Dh/2]
    ang = positions[..., None].float() * freqs               # [..., T, Dh/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., T, 1, Dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- softcap ----
def softcap(x, cap):
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ----------------------------------------------------------- activation ----
def act_fn(name):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "relu2": lambda x: F.relu(x).square()}[name]


# ------------------------------------------------------------ embedding ----
def embed(p, tokens, dtype):
    return p["embedding"][tokens].to(dtype)


def unembed(w, x):
    """lm head: x [..., d] @ w [d, vocab]."""
    return x @ w.to(x.dtype)

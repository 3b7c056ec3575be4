"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
twin of ``repro/models/rglru.py``).

Block:  y = W_out( GeLU(W_gate x) * RGLRU( conv1d( W_branch x ) ) )
RG-LRU: r_t = sigmoid(W_a u_t + b_a)         (recurrence gate)
        i_t = sigmoid(W_x u_t + b_x)         (input gate)
        a_t = exp(c * r_t * log(sigmoid(lam)))  in (0,1),  c = 8
        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Order of operations: a pass that carries state (prefill, decode, the
replay of an accepted path: ``state`` or ``snap_at`` given) runs the
recurrence as a plain sequential loop over time, ``h = a_t * h + b_t``
with the carried state as ``h`` before the first step. The loop rounds a
T-token pass exactly as T one-token passes given the same gates, so a
replay of the accepted path advances the state as that many single-token
decodes would (the projections' matmuls may still round differently at a
different number of rows); JAX's scan rounds differently in the last
bits, and the port is held to it at the tests' tolerance. A stateless
pass over a whole sequence (``lm.forward(states=None)``: the training
loss) runs JAX's associative scan instead, the same tree of combines
(:func:`associative_scan`), in log2(T) steps of whole-sequence torch ops
where the loop took T.

Decode carries (h, conv buffer) state, both fp32 as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import param as pm
from repro_torch.models.layers import dense

STATE_KEYS = ("rg_h", "conv_buf")
_C = 8.0


def rglru_block_init(gen, cfg):
    d = cfg.d_model
    w = cfg.rglru_width or d
    dev = gen.device
    return {
        "w_branch": pm.dense_init(gen, d, w),
        "w_gate": pm.dense_init(gen, d, w),
        "w_out": pm.dense_init(gen, w, d, scale=w ** -0.5),
        "conv_w": pm.trunc_normal(gen, (cfg.conv1d_width, w), stddev=0.1),
        "wa": pm.dense_init(gen, w, w),
        "ba": pm.zeros((w,), dev),
        "wx": pm.dense_init(gen, w, w),
        "bx": pm.zeros((w,), dev),
        # lambda such that a^c = sigmoid(lam)^c is in about [0.9, 0.999]
        "lam": torch.linspace(2.0, 6.0, w, device=dev),
    }


def rglru_state_init(cfg, batch: int, device,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    w = cfg.rglru_width or cfg.d_model
    return {
        "rg_h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv_buf": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device),
    }


def snap_rows(x, snap_at):
    """x [B, T, ...] -> the rows at ``clip(snap_at - 1, 0, T - 1)`` [B,
    ...]: the value after exactly ``snap_at`` tokens (JAX clips, so a row
    with ``snap_at`` 0 takes the first token's value)."""
    t = x.shape[1]
    idx = (snap_at.long() - 1).clamp(0, t - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _causal_conv1d(x, w, buf, snap_at=None):
    """x: [B,T,W]; w: [K,W] depthwise; buf: [B,K-1,W] left context.

    snap_at: optional [B]: the new buffer is the state after exactly
    ``snap_at`` tokens, else after all T.
    """
    k = w.shape[0]
    t = x.shape[1]
    xx = torch.cat([buf.to(x.dtype), x], dim=1)           # [B, K-1+T, W]
    out = sum(xx[:, i:i + t] * w[i].to(x.dtype) for i in range(k))
    if k == 1:
        return out, buf
    if snap_at is None:
        return out, xx[:, -(k - 1):]
    idx = snap_at.long()[:, None] + torch.arange(k - 1, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return out, xx[rows, idx]


def _combine(a1, b1, a2, b2):
    """Two steps of h -> a h + b, the first (a1, b1), as one (JAX's
    ``combine``)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """[even0, odd0, even1, odd1, ...] along axis 1; ``even`` is as long
    as ``odd`` or one longer."""
    n = even.shape[1] + odd.shape[1]
    if even.shape[1] > odd.shape[1]:
        odd = torch.cat([odd, even[:, -1:]], dim=1)       # cut off below
    return torch.stack([even, odd], dim=2).flatten(1, 2)[:, :n]


def associative_scan(a, b):
    """The prefix compositions of h -> a_t h + b_t along axis 1: (a_1 ...
    a_t, h_t with h_{-1} = 0), as ``jax.lax.associative_scan`` forms them
    (pairs combined, the half-length scan recursively, then the even
    positions), so each element is the same tree of products and sums."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_block(p, x, cfg, state: Optional[Dict] = None, snap_at=None):
    """x: [B,T,d] -> (y [B,T,d], new_state).

    snap_at: optional [B] in [1, T]: the returned state is the one after
    exactly ``snap_at`` tokens (outputs still cover all T).
    """
    b, t, _ = x.shape
    st = state or rglru_state_init(cfg, b, x.device)
    gate = F.gelu(dense(p["w_gate"], x), approximate="tanh")
    u = dense(p["w_branch"], x)
    u, conv_buf = _causal_conv1d(u, p["conv_w"], st["conv_buf"], snap_at)

    uf = u.float()
    r = torch.sigmoid(dense(p["wa"], uf) + p["ba"])
    i = torch.sigmoid(dense(p["wx"], uf) + p["bx"])
    log_a1 = F.logsigmoid(p["lam"].float())                 # [W]
    a = torch.exp(_C * r * log_a1)                           # [B,T,W]
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i * uf)

    h = st["rg_h"].float()
    if state is None and snap_at is None:
        # stateless (training): the scan, h_{-1} = 0 folded into b_0 as JAX
        b0 = gated_in[:, :1] + a[:, :1] * h[:, None]
        _, hseq = associative_scan(a, torch.cat([b0, gated_in[:, 1:]], 1))
        h = hseq[:, -1]
    else:
        hs = []
        for s in range(t):
            h = a[:, s] * h + gated_in[:, s]
            hs.append(h)
        hseq = torch.stack(hs, dim=1)                        # [B,T,W]
    y = dense(p["w_out"], (gate.float() * hseq).to(x.dtype))
    h_fin = h if snap_at is None else snap_rows(hseq, snap_at)
    return y, {"rg_h": h_fin, "conv_buf": conv_buf.to(st["conv_buf"].dtype)}

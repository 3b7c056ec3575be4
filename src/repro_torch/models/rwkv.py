"""RWKV-6 "Finch" blocks (arXiv:2404.05892; twin of
``repro/models/rwkv.py``): data-dependent decay time-mix and squared-ReLU
channel-mix.

Time-mix per head (state S in R^{Dh x Dh}):
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with data-dependent decay w_t = exp(-exp(w0 + tanh(x_t A) B)) in (0,1).
Token shift mixes x_t with x_{t-1} via learned interpolation.

Two evaluation paths (held to each other by the tests):
  * ``scan``    -- a sequential loop over time (decode, replay, prefill;
                   the exact reference). A T-token pass runs the same
                   per-token arithmetic as T one-token passes.
  * ``chunked`` -- parallel intra-chunk + sequential inter-chunk state
                   pass (for training; O(T/C) sequential steps).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import param as pm
from repro_torch.models.layers import dense
from repro_torch.models.rglru import snap_rows

TM_STATE_KEYS = ("tm_x_prev", "tm_s")
CM_STATE_KEYS = ("cm_x_prev",)
_LORA = 64


def _heads(cfg):
    dh = cfg.rwkv_head_dim
    return cfg.d_model // dh, dh


def time_mix_init(gen, cfg):
    d = cfg.d_model
    h, dh = _heads(cfg)
    dev = gen.device
    half = lambda: pm.zeros((d,), dev) + 0.5        # noqa: E731
    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "wr": pm.dense_init(gen, d, h * dh),
        "wk": pm.dense_init(gen, d, h * dh),
        "wv": pm.dense_init(gen, d, h * dh),
        "wg": pm.dense_init(gen, d, h * dh),
        "wo": pm.dense_init(gen, h * dh, d, scale=(h * dh) ** -0.5),
        "w0": pm.zeros((h * dh,), dev) - 0.5,
        "w_lora_a": pm.dense_init(gen, d, _LORA),
        "w_lora_b": pm.dense_init(gen, _LORA, h * dh, scale=0.01),
        "u": pm.trunc_normal(gen, (h, dh), stddev=0.5),
        "ln_x": pm.ones((h * dh,), dev),
    }


def rwkv_state_init(cfg, batch: int, device,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h, dh = _heads(cfg)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return {"tm_x_prev": z(batch, d), "tm_s": z(batch, h, dh, dh),
            "cm_x_prev": z(batch, d)}


def _token_shift(x, x_prev, mu):
    """lerp(x_t, x_{t-1}); x: [B,T,d], x_prev: [B,d]."""
    prev = torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return x + (prev - x) * mu.to(x.dtype)


def _last(x, snap_at):
    """The input row whose token is the last one consumed, fp32."""
    return (x[:, -1] if snap_at is None else snap_rows(x, snap_at)).float()


def time_mix(p, x, cfg, state: Optional[Dict] = None, chunk: int = 64,
             snap_at=None, impl: str = "scan"):
    """x: [B,T,d] -> (y [B,T,d], {"tm_x_prev", "tm_s"}). snap_at: optional
    [B]: the state after exactly ``snap_at`` tokens."""
    b, t, d = x.shape
    h, dh = _heads(cfg)
    st = state or rwkv_state_init(cfg, b, x.device)
    xp = st["tm_x_prev"]
    xr, xk, xv, xw, xg = (_token_shift(x, xp, p[f"mu_{n}"])
                          for n in "rkvwg")
    r = dense(p["wr"], xr).reshape(b, t, h, dh).float()
    k = dense(p["wk"], xk).reshape(b, t, h, dh).float()
    v = dense(p["wv"], xv).reshape(b, t, h, dh).float()
    g = F.silu(dense(p["wg"], xg)).float()
    # data-dependent decay in (0,1)
    ww = p["w0"] + dense(p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], xw)))
    w = torch.exp(-torch.exp(ww.float())).reshape(b, t, h, dh)
    u = p["u"].float()

    s0 = st["tm_s"].float()
    if impl == "chunked" and snap_at is None and t % min(chunk, t) == 0 \
            and t > 1:
        out, s = time_mix_chunked(r, k, v, w, u, s0, chunk=chunk)
    else:
        # decode (t == 1), replay and prefill: the scan
        out, s = _time_mix_scan(r, k, v, w, u, s0, snap_at=snap_at)

    # per-head group norm
    mu_ = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu_) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, t, h * dh) * p["ln_x"].float()
    y = dense(p["wo"], (out * g).to(x.dtype))
    return y, {"tm_x_prev": _last(x, snap_at), "tm_s": s}


def _time_mix_scan(r, k, v, w, u, s0, snap_at=None):
    """Sequential reference: a loop over time. All inputs fp32.

    Order of operations: o_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t, the
    second term and every k_t v_t^T formed for all t at once before the
    loop, which then does one product and one update a step (JAX
    forms r_t^T (S_{t-1} + diag(u) k_t v_t^T) inside its scan: the same
    value, rounded differently in the last bits). Decode (t == 1) runs
    this too, so a replay of T tokens rounds as T one-token passes.

    snap_at: optional [B]: the returned state is the one after exactly
    ``snap_at`` tokens (a conditional snapshot carried through the loop,
    as JAX carries it through its scan).

    The loop reads each step's slices from ``unbind(1)``: autograd then
    stacks the T slices' grads once, where indexing ``x[:, i]`` gave each
    step a zero-filled gradient of the whole [B,T,...] input to add up
    (O(T^2) bytes: 103 s a training step of four layers at T 4096 on an
    H100). The values are the same either way."""
    t = r.shape[1]
    kv = k[..., :, None] * v[..., None, :]                  # [B,T,H,K,V]
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    s, snap = s0, s0
    os_ = []
    rs, ws, kvs = r.unbind(1), w.unbind(1), kv.unbind(1)
    for i in range(t):
        os_.append(torch.einsum("bhk,bhkv->bhv", rs[i], s))
        s = ws[i][..., None] * s + kvs[i]
        if snap_at is not None:
            take = (i + 1) <= snap_at                       # [B]
            snap = torch.where(take[:, None, None, None], s, snap)
    return torch.stack(os_, dim=1) + bonus, (snap if snap_at is not None
                                             else s)


def time_mix_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """Chunked-parallel WKV: intra-chunk attention-like matmuls + an
    inter-chunk state recurrence. Equals the scan path in fp32 while the
    cumulative decay within a chunk stays within about 35 nats (the
    factored exponents are clamped there; see the JAX twin).

    Shapes: r,k,v,w [B,T,H,Dh]; u [H,Dh]; s0 [B,H,Dh,Dh].
    """
    b, t, h, dh = r.shape
    c = min(chunk, t)
    assert t % c == 0, "pad T to chunk multiple"
    n = t // c
    rc, kc, vc, wc = (a.reshape(b, n, c, h, dh) for a in (r, k, v, w))
    logw = torch.log(torch.clamp(wc, min=1e-38))
    cuml = torch.cumsum(logw, dim=2)                 # log P (inclusive)
    cuml_ex = cuml - logw                            # log P^ex
    tot = cuml[:, :, -1:]                            # log prod over chunk
    clamp = 35.0
    rq = rc * torch.exp(torch.clamp(cuml_ex, min=-clamp))
    kq = kc * torch.exp(-torch.clamp(cuml, min=-clamp))
    att = torch.einsum("bnchd,bnkhd->bnhck", rq, kq)
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    att = att * tri
    intra = torch.einsum("bnhck,bnkhd->bnchd", att, vc)
    bonus = torch.einsum("bnchd,hd,bnchd->bnch", rc, u, kc)
    intra = intra + bonus[..., None] * vc

    kv_chunk = torch.einsum("bnchd,bnche->bnhde", kc * torch.exp(tot - cuml),
                            vc)                      # decayed to chunk end
    decay_chunk = torch.exp(tot[:, :, 0])            # [B,n,h,dh]
    s = s0
    inter = []
    for j in range(n):
        inter.append(torch.einsum("bchd,bhde->bche", rq[:, j], s))
        s = decay_chunk[:, j][..., None] * s + kv_chunk[:, j]
    out = (intra + torch.stack(inter, dim=1)).reshape(b, t, h, dh)
    return out, s


def channel_mix_init(gen, cfg):
    d, dff = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "mu_k": pm.zeros((d,), dev) + 0.5, "mu_r": pm.zeros((d,), dev) + 0.5,
        "wk": pm.dense_init(gen, d, dff),
        "wv": pm.dense_init(gen, dff, d, scale=dff ** -0.5),
        "wr": pm.dense_init(gen, d, d),
    }


def channel_mix(p, x, cfg, state: Optional[Dict] = None, snap_at=None):
    b, t, d = x.shape
    xp = (state["cm_x_prev"] if state is not None else
          torch.zeros((b, d), dtype=torch.float32, device=x.device))
    xk = _token_shift(x, xp, p["mu_k"])
    xr = _token_shift(x, xp, p["mu_r"])
    k = torch.square(F.relu(dense(p["wk"], xk)))
    r = torch.sigmoid(dense(p["wr"], xr))
    y = r * dense(p["wv"], k)
    return y, {"cm_x_prev": _last(x, snap_at)}

"""Attention: GQA projections, masks and the plain attention paths (twin
of ``repro/models/attention.py``).

``attend`` dispatches between ``dense`` (materialized scores) and
``chunked`` (running softmax over KV chunks) exactly as the JAX
``impl="auto"`` rule does, or, with ``impl="kernel"`` (the twin of JAX
``impl="pallas"``), to the differentiable flash op of
``kernels/ops.py``: the CUDA flash forward and backward kernels on a
card, their plain torch versions on CPU tensors. Training takes that path
through ``lm.loss_fn(attn_impl="kernel")``.

The decode/verify read path over a KV cache is
:func:`attend_cache_plus_block` (``attn_impl="gather"``) or the CUDA
cascade kernels (``attn_impl="kernel"``, see ``models/blocks.py``).

Masked scores use ``-0.7 * finfo(f32).max`` here, as the JAX module
does; the cascade kernels use ``-1e30`` (``kernels/cascade_attention``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import param as pm
from repro_torch.models.layers import apply_rope, dense, softcap

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _as_long(x, device):
    return torch.as_tensor(x, device=device).long()


def _offset(x, device):
    """A Python int as it is, anything else as a long tensor on
    ``device``: a mask built from an int offset makes no tensor from host
    data (a copy a CUDA graph cannot capture)."""
    return x if isinstance(x, int) else _as_long(x, device)


def _per_row(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim > 0


def _rows(x):
    """A per-row [B] offset as [B, 1, 1]; an int or 0-d one as it is."""
    return x.reshape(-1, 1, 1) if _per_row(x) else x


# ------------------------------------------------------------------ masks --
def make_attention_mask(tq: int, tkv: int, *, causal: bool, q_offset,
                        window: Optional[int] = None, kv_len=None,
                        device=None):
    """Boolean mask (True = attend): [Tq,Tkv], or [B,Tq,Tkv] when
    ``q_offset``/``kv_len`` are per-example vectors.

    Query i has absolute position q_offset + i; key j has absolute position j.
    """
    q_off = _offset(q_offset, device)
    kl = None if kv_len is None else _offset(kv_len, device)
    batched = _per_row(q_off) or _per_row(kl)
    ar_q = torch.arange(tq, device=device)
    ar_k = torch.arange(tkv, device=device)
    if batched:
        qpos = ar_q[None, :, None] + _rows(q_off)             # [B,Tq,1]
        kpos = ar_k[None, None, :]
    else:
        qpos = ar_q[:, None] + q_off                          # [Tq,1]
        kpos = ar_k[None, :]
    shape = torch.broadcast_shapes(qpos.shape, kpos.shape)
    mask = (kpos <= qpos) if causal else torch.ones(shape, dtype=torch.bool,
                                                    device=device)
    mask = mask.expand(shape)
    if window is not None:
        mask = mask & (kpos > (qpos - window))
    if kl is not None:
        mask = mask & (kpos < _rows(kl))
    return mask


# ------------------------------------------------------------ dense impl --
def attend_dense(q, k, v, mask=None, *, scale=None, attn_softcap=None,
                 sinks=None):
    """q:[B,Tq,Hq,Dh] k,v:[B,Tkv,Hkv,Dh] mask:[B?,Tq,Tkv].

    ``sinks`` is taken and not used, as in the JAX twin, whose signature
    has it and whose body never reads it (ROADMAP.md queue 3)."""
    del sinks
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = (q.float() * scale).reshape(b, tq, hkv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    logits = softcap(logits, attn_softcap)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, tq, hq, dh).to(q.dtype)


# ---------------------------------------------------------- chunked impl --
def attend_chunked(q, k, v, *, causal, q_offset, window=None, kv_len=None,
                   extra_mask=None, scale=None, attn_softcap=None,
                   kv_chunk: int = 1024, return_stats: bool = False,
                   key_offset=0):
    """Running softmax over KV chunks; never builds [Tq,Tkv] scores.

    return_stats: return the un-normalized flash stats (acc [B,Hkv,G,Tq,Dh],
    m/l [B,Hkv,G,Tq]) for LSE merging.
    """
    b, tq, hq, dh = q.shape
    tkv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = scale if scale is not None else dh ** -0.5
    kv_chunk = min(kv_chunk, tkv)
    n_chunks = (tkv + kv_chunk - 1) // kv_chunk
    if extra_mask is not None and extra_mask.ndim == 2:
        extra_mask = extra_mask[None]
    eff = _rows(_offset(kv_len if kv_len is not None else tkv, dev))
    qpos = torch.arange(tq, device=dev)[None, :, None] + _rows(
        _offset(q_offset, dev))
    qf = (q.float() * scale).reshape(b, tq, hkv, g, dh)

    m_i = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32,
                     device=dev)
    l_i = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, tq, dh), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        lo, hi = c * kv_chunk, min((c + 1) * kv_chunk, tkv)
        kc, vc = k[:, lo:hi].float(), v[:, lo:hi].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)
        logits = softcap(logits, attn_softcap)
        kpos = key_offset + torch.arange(lo, hi, device=dev)[None, None, :]
        mask = kpos < eff
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > (qpos - window))
        if extra_mask is not None:
            mask = mask & extra_mask[..., lo:hi]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        m_new = torch.maximum(m_i, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    p, vc)
        m_i = m_new
    if return_stats:
        return acc, m_i, l_i
    out = acc / l_i.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)                    # [B,Tq,Hkv,g,Dh]
    return out.reshape(b, tq, hq, dh).to(q.dtype)


def merge_attn_stats(parts, q_shape, dtype):
    """Merge flash partials [(acc, m, l), ...] by log-sum-exp -> [B,Tq,Hq,Dh].
    """
    b, tq, hq, dh = q_shape
    m_g = parts[0][1]
    for _, m, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = sum(l * torch.exp(m - m_g) for _, m, l in parts)
    acc_g = sum(acc * torch.exp(m - m_g)[..., None] for acc, m, _ in parts)
    out = acc_g / l_g.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)
    return out.reshape(b, tq, hq, dh).to(dtype)


def attend_cache_plus_block(q, kk, vv, *, cache_cap, cache_len, q_abs,
                            window, extra_mask, attn_softcap, impl,
                            kv_chunk, rolling):
    """Single-softmax attention over [cache(cap) ++ block(T)] — the plain
    decode/verify read path (``attn_impl="gather"``).

    ``kk``/``vv``: the cache's logical view concatenated with the block's
    K/V. ``q_abs``: [Tq] or [B,Tq] absolute query positions.
    ``cache_len``: scalar or [B]. A rolling cache slot j holds the largest
    t < cache_len with t % cap == j. ``extra_mask``: [Tq,T_blk] or
    [B,Tq,T_blk] mask over the block tail (default: causal by block order).
    """
    b, tq = q.shape[:2]
    dev = q.device
    total = kk.shape[1]
    t_blk = total - cache_cap
    clen = _as_long(cache_len, dev)
    qa = _as_long(q_abs, dev)
    batched = (clen.ndim > 0) or (qa.ndim > 1) or (
        extra_mask is not None and extra_mask.ndim > 2)
    if batched:
        clen = clen.reshape(-1, 1, 1).expand(b, 1, 1)
        qpos = qa.reshape(-1, tq)[..., None].expand(b, tq, 1)
        jc = torch.arange(cache_cap, device=dev)[None, None, :]
    else:
        qpos = qa[:, None]
        jc = torch.arange(cache_cap, device=dev)[None, :]
    if rolling:
        last = clen - 1
        # jnp.mod floors, like torch.remainder
        abs_kpos = last - torch.remainder(last - jc, cache_cap)
        cache_ok = (abs_kpos >= 0) & (abs_kpos < clen) & (abs_kpos <= qpos)
        if window is not None:
            cache_ok = cache_ok & (abs_kpos > (qpos - window))
    else:
        cache_ok = (jc < clen) & (jc <= qpos)
        if window is not None:
            cache_ok = cache_ok & (jc > (qpos - window))
    tgt_shape = (b, tq, cache_cap) if batched else (tq, cache_cap)
    cache_ok = cache_ok.expand(tgt_shape)
    if extra_mask is not None:
        blk = extra_mask
        if batched and blk.ndim == 2:
            blk = blk[None].expand(b, tq, t_blk)
    else:
        blk = torch.ones((tq, t_blk), dtype=torch.bool, device=dev).tril(
            t_blk - tq)
        if window is not None:
            ji = torch.arange(t_blk, device=dev)[None, :]
            ii = torch.arange(tq, device=dev)[:, None] + (t_blk - tq)
            blk = blk & (ji > (ii - window))
        if batched:
            blk = blk[None].expand(b, tq, t_blk)
    full_mask = torch.cat([cache_ok, blk], dim=-1)
    return attend(q, kk, vv, causal=False, q_offset=0, extra_mask=full_mask,
                  attn_softcap=attn_softcap, impl=impl, kv_chunk=kv_chunk)


def attend(q, k, v, *, causal=True, q_offset=0, window=None, kv_len=None,
           extra_mask=None, scale=None, attn_softcap=None, impl="auto",
           kv_chunk=1024):
    """Unified attention entry point: ``impl`` is "auto", "dense",
    "chunked" or "kernel" (the flash kernels)."""
    tq, tkv = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "dense" if (tq * tkv <= 256 * 1024) else "chunked"
    if impl == "dense":
        mask = make_attention_mask(tq, tkv, causal=causal, q_offset=q_offset,
                                   window=window, kv_len=kv_len,
                                   device=q.device)
        if extra_mask is not None:
            mask = mask & extra_mask
        return attend_dense(q, k, v, mask, scale=scale,
                            attn_softcap=attn_softcap)
    if impl == "chunked":
        return attend_chunked(q, k, v, causal=causal, q_offset=q_offset,
                              window=window, kv_len=kv_len,
                              extra_mask=extra_mask, scale=scale,
                              attn_softcap=attn_softcap, kv_chunk=kv_chunk)
    if impl == "kernel":
        # JAX's impl="pallas" drops extra_mask silently; the kernels take
        # no free-form mask, so the port refuses one.
        if extra_mask is not None:
            raise ValueError("attend(impl='kernel') takes no extra_mask")
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, window=window,
            kv_len=kv_len, scale=scale, attn_softcap=attn_softcap)
    raise ValueError(f"unknown attention impl {impl!r}")


# ------------------------------------------------------------- module -----
def attn_init(gen, cfg, cross: bool = False):
    """QKV/O projections. Fused layouts: wq [d, Hq*Dh], wk/wv [d, Hkv*Dh].
    A cross-attention sub-layer (``cross``) has no QKV bias; with
    ``qk_norm`` it gets ``q_norm``/``k_norm``, which it never reads (as in
    JAX, so that the trees match)."""
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": pm.dense_init(gen, d, hq * dh),
        "wk": pm.dense_init(gen, d, hkv * dh),
        "wv": pm.dense_init(gen, d, hkv * dh),
        "wo": pm.dense_init(gen, hq * dh, d, scale=(hq * dh) ** -0.5),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = pm.zeros((hq * dh,), dev)
        p["bk"] = pm.zeros((hkv * dh,), dev)
        p["bv"] = pm.zeros((hkv * dh,), dev)
    if cfg.qk_norm:
        p["q_norm"] = pm.ones((dh,), dev)
        p["k_norm"] = pm.ones((dh,), dev)
    return p


def _rms_head(x, scale, eps):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def project_qkv(p, x, cfg, positions=None, rope: bool = True):
    """x:[B,T,d] -> q:[B,T,Hq,Dh], k,v:[B,T,Hkv,Dh] (+rope, +qknorm)."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x, p.get("bq")).reshape(b, t, hq, dh)
    k = dense(p["wk"], x, p.get("bk")).reshape(b, t, hkv, dh)
    v = dense(p["wv"], x, p.get("bv")).reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p, attn_out):
    b, t, hq, dh = attn_out.shape
    return dense(p["wo"], attn_out.reshape(b, t, hq * dh))

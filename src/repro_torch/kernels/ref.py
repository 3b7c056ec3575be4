"""Plain torch oracles of the kernels (twin of ``repro/kernels/ref.py``).

:func:`flash_attention_ref` is one softmax over the whole key axis; its
torch autograd is the gradient oracle of the flash backward. The cascade
oracles take one softmax over [cache ++ tree block] with the kernels'
absolute-position masking. Each is independent of the block arithmetic
in ``kernels/flash_attention.py`` and ``kernels/cascade_attention.py``,
so the two check each other."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _flash_mask(b, tq, tkv, *, causal, q_offset, window, kv_len, device):
    q_off = torch.as_tensor(q_offset, device=device).long().reshape(-1)
    qpos = (torch.arange(tq, device=device)[None, :, None]
            + q_off.expand(b)[:, None, None])
    kpos = torch.arange(tkv, device=device)[None, None, :]
    m = torch.ones((b, tq, tkv), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > (qpos - window))
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=device).long().reshape(-1)
        m = m & (kpos < kl.expand(b)[:, None, None])
    return m


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0, window=None,
                        kv_len=None, attn_softcap=None, scale=None):
    """q [B,Hq,Tq,D]; k,v [B,Hkv,Tkv,D] -> (o, lse). Differentiable."""
    b, hq, tq, d = q.shape
    hkv, tkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kq)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    m = _flash_mask(b, tq, tkv, causal=causal, q_offset=q_offset,
                    window=window, kv_len=kv_len, device=q.device)
    s = torch.where(m[:, None], s, s.new_tensor(NEG_INF))
    mx = s.amax(dim=-1)
    p = torch.exp(s - mx[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-30)[..., None], vq)
    return o.to(q.dtype), mx + torch.log(l.clamp_min(1e-30))


def cascade_attention_ref(q, cache_k, cache_v, blk_k, blk_v, *, cache_len,
                          q_abs, tree_mask, window=None, attn_softcap=None,
                          scale=None, rolling=False):
    """q [B,Hq,Tq,D]; cache [B,Hkv,S,D]; blk [B,Hkv,Tb,D]; tree_mask
    [B,Tq,Tb] or [Tq,Tb] -> [B,Hq,Tq,D]."""
    b, hq, tq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    clen = torch.as_tensor(cache_len, device=dev).long().reshape(-1).expand(b)
    qa = torch.as_tensor(q_abs, device=dev).long().reshape(-1, tq).expand(b, tq)

    kq = torch.cat([cache_k, blk_k], dim=2).float().repeat_interleave(g, 1)
    vq = torch.cat([cache_v, blk_v], dim=2).float().repeat_interleave(g, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kq)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)

    slot = torch.arange(s_len, device=dev)[None, None, :]
    qp = qa[:, :, None]
    cl = clen[:, None, None]
    if rolling:
        last = cl - 1
        kpos = last - torch.remainder(last - slot, s_len)
        ok_c = (kpos >= 0) & (kpos < cl) & (kpos <= qp)
    else:
        kpos = slot
        ok_c = (kpos < cl) & (kpos <= qp)
    if window is not None:
        ok_c = ok_c & (kpos > (qp - window))
    tm = (tree_mask if tree_mask.ndim == 3
          else tree_mask[None]).expand(b, tq, blk_k.shape[2])
    full = torch.cat([ok_c.expand(b, tq, s_len), tm], dim=-1)
    s = torch.where(full[:, None], s, s.new_tensor(NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    o = torch.einsum("bhqk,bhkd->bhqd",
                     p / p.sum(-1, keepdim=True).clamp_min(1e-30), vq)
    return o.to(q.dtype)


def gather_pages(pool, page_table):
    """Logical [B,Hkv,MP*page,D] view of a page pool [P,Hkv,page,D] (kernel
    layout). Out-of-range entries clamp to the last physical page."""
    n_phys = pool.shape[0]
    pt = torch.as_tensor(page_table, device=pool.device).long().clamp(
        0, n_phys - 1)
    v = pool[pt]                                   # [B, MP, Hkv, page, D]
    b, mp, hkv, page, d = v.shape
    return v.permute(0, 2, 1, 3, 4).reshape(b, hkv, mp * page, d)


def cascade_attention_paged_ref(q, pool_k, pool_v, page_table, blk_k, blk_v,
                                *, cache_len, q_abs, tree_mask, window=None,
                                attn_softcap=None, scale=None):
    """Gather the logical view, then the dense oracle."""
    return cascade_attention_ref(
        q, gather_pages(pool_k, page_table), gather_pages(pool_v, page_table),
        blk_k, blk_v, cache_len=cache_len, q_abs=q_abs, tree_mask=tree_mask,
        window=window, attn_softcap=attn_softcap, scale=scale, rolling=False)

"""Layout dispatch for the kernels (twin of ``repro/kernels/ops.py``).

Inputs are in the model's storage layout: q [B,T,Hq,D], k/v and caches
[B,S,Hkv,D], pools [P,page,Hkv,D]. They are handed to the kernels as
transposed VIEWS in the kernel layout [.., H, T, D] — the kernels take
strides — so no per-layer copy of the cache or pool is made.

``flash_attention`` is a ``torch.autograd.Function`` wired to the flash
backward kernels, as the JAX op's ``custom_vjp`` is, so the same op
serves training.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cascade_attention as casc
from repro_torch.kernels import flash_attention as fa


# ---------------------------------------------------------------- flash ----
class _Flash(torch.autograd.Function):
    """Kernel layout [B,H,T,D]; saves q, k, v, o and lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window, kv_len,
                attn_softcap, scale):
        kw = dict(causal=causal, q_offset=q_offset, window=window,
                  kv_len=kv_len, attn_softcap=attn_softcap, scale=scale)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        # dq comes in q's dtype, dk/dv in k's (the JAX op's contract)
        return fa.flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw) + \
            (None,) * 6


def flash_attention(q, k, v, *, causal=True, q_offset=0, window=None,
                    kv_len=None, attn_softcap=None, scale=None):
    """Differentiable flash attention on the model's layout: q [B,T,Hq,D],
    k/v [B,T,Hkv,D] -> [B,T,Hq,D]. ``q_offset`` is a scalar."""
    q_, k_, v_ = (x.transpose(1, 2) for x in (q, k, v))
    o = _Flash.apply(q_, k_, v_, causal, int(q_offset), window, kv_len,
                     attn_softcap, scale)
    return o.transpose(1, 2)


# -------------------------------------------------------------- cascade ----


def cascade_attention(q, cache_k, cache_v, blk_k, blk_v, *, cache_len,
                      q_abs, tree_mask, window=None, attn_softcap=None,
                      scale=None, rolling=False, n_splits=8, bk=512):
    """The paper's cascade verify op over a dense cache."""
    q, cache_k, cache_v, blk_k, blk_v = (
        x.transpose(1, 2) for x in (q, cache_k, cache_v, blk_k, blk_v))
    o = casc.cascade_attention(
        q, cache_k, cache_v, blk_k, blk_v, cache_len=cache_len, q_abs=q_abs,
        tree_mask=tree_mask, window=window, attn_softcap=attn_softcap,
        scale=scale, rolling=rolling, n_splits=n_splits, bk=bk)
    return o.transpose(1, 2)


def cascade_attention_paged(q, pool_k, pool_v, page_table, blk_k, blk_v, *,
                            cache_len, q_abs, tree_mask, window=None,
                            attn_softcap=None, scale=None, n_splits=8,
                            pos_stride=None, pos_offset=None):
    """Cascade verify over a PAGED cache: pools [P,page,Hkv,D] plus
    page_table [B, max_pages]; logical page ``i`` at positions
    ``i*pos_stride + pos_offset + [0, page)`` (default: ``i*page``)."""
    q, blk_k, blk_v, pool_k, pool_v = (
        x.transpose(1, 2) for x in (q, blk_k, blk_v, pool_k, pool_v))
    o = casc.cascade_attention_paged(
        q, pool_k, pool_v, page_table, blk_k, blk_v, cache_len=cache_len,
        q_abs=q_abs, tree_mask=tree_mask, window=window,
        attn_softcap=attn_softcap, scale=scale, n_splits=n_splits,
        pos_stride=pos_stride, pos_offset=pos_offset)
    return o.transpose(1, 2)

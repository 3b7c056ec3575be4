"""Layout dispatch for the cascade kernels (twin of the cascade half of
``repro/kernels/ops.py``).

Inputs are in the model's storage layout: q [B,T,Hq,D], caches
[B,S,Hkv,D], pools [P,page,Hkv,D]. They are handed to the kernels as
transposed VIEWS in the kernel layout [.., H, T, D] — the kernels take
strides — so no per-layer copy of the cache or pool is made.
"""
from __future__ import annotations

from repro_torch.kernels import cascade_attention as casc


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
                            attn_softcap=None, scale=None, n_splits=8):
    """Cascade verify over a PAGED cache: pools [P,page,Hkv,D] plus
    page_table [B, max_pages]."""
    q, blk_k, blk_v, pool_k, pool_v = (
        x.transpose(1, 2) for x in (q, blk_k, blk_v, pool_k, pool_v))
    o = casc.cascade_attention_paged(
        q, pool_k, pool_v, page_table, blk_k, blk_v, cache_len=cache_len,
        q_abs=q_abs, tree_mask=tree_mask, window=window,
        attn_softcap=attn_softcap, scale=scale, n_splits=n_splits)
    return o.transpose(1, 2)

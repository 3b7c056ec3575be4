"""Transformer blocks (twin of ``repro/models/blocks.py``).

The JAX stack scans a period of layers; here the stack is a Python loop
over per-layer params (``models/lm.py``), so one block is one layer.

Modes (driven by arguments, not flags):
  * train:         state None                     -> causal (or windowed)
                                                      self-attention; with
                                                      attn_impl="kernel" the
                                                      differentiable flash op
  * prefill:       state given, write_kv=True     -> causal self-attention,
                                                      block KV written to the cache
  * replay:        write_kv=True and attend_cache_on_write=True
                                                   -> attend [cache ++ block], then write
  * decode/verify: state given, write_kv=False    -> attend [cache ++ block]
                   with an optional ``extra_mask`` (tree mask); the block's
                   K/V are returned for the commit after acceptance.

Block kinds: ``global`` / ``local`` attention, ``recurrent`` (RG-LRU,
``models/rglru.py``) and ``rwkv`` (RWKV-6 time-mix, whose channel-mix
takes the MLP's place, ``models/rwkv.py``). MoE and cross-attention
blocks raise ``NotImplementedError``.

Recurrent state leaves (fp32, batch-leading) are written in place by a
pass with ``write_kv`` (prefill, replay), like the KV caches; with
``snap_at`` they hold the state after exactly ``snap_at`` tokens. A pass
without ``write_kv`` (the read-only verify pass) leaves them as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache as kvc
from repro_torch.models.attention import (attend, attend_cache_plus_block,
                                          attn_init, out_proj, project_qkv)
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.layers import rmsnorm
from repro_torch.models.mlp import mlp, mlp_init

KINDS = ("global", "local", "recurrent", "rwkv")
_NOT_PORTED = {
    "moe": "ROADMAP.md queue 1, slice C (models/moe.py)",
    "cross": "ROADMAP.md queue 1, slice C (cross-attention blocks)",
}


def check_supported(cfg: ModelConfig):
    """Raise for configs whose blocks the port does not have yet."""
    for kind in set(cfg.pattern_for_depth()):
        if kind not in KINDS:
            raise NotImplementedError(f"block kind {kind!r} is not ported")
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE FFN is not ported: {_NOT_PORTED['moe']}")
    if cfg.cross_attn_every or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"cross-attention is not ported: {_NOT_PORTED['cross']}")


def period_spec(cfg: ModelConfig) -> Tuple[int, int]:
    """(period length, n_periods) of the JAX scanned stack; layers past
    ``n_periods * period`` form the unrolled tail. Features for the
    drafter are the hiddens at period ends and after each tail layer."""
    plen = len(cfg.layer_pattern)
    return plen, cfg.num_layers // plen


# ----------------------------------------------------------------- block ---
def block_init(gen, cfg: ModelConfig, kind: str):
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    dev = gen.device
    ones = lambda: {"scale": torch.ones((cfg.d_model,), device=dev)}  # noqa: E731
    p: Dict[str, Any] = {"ln1": ones()}
    if kind == "recurrent":
        p["rec"] = rglru_lib.rglru_block_init(gen, cfg)
    elif kind == "rwkv":
        p["rwkv_tm"] = rwkv_lib.time_mix_init(gen, cfg)
    else:
        p["attn"] = attn_init(gen, cfg)
    p["ln2"] = ones()
    if kind == "rwkv":
        p["rwkv_cm"] = rwkv_lib.channel_mix_init(gen, cfg)
    else:
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated)
    if cfg.use_post_norm:
        p["ln1_post"] = ones()
        p["ln2_post"] = ones()
    return p


def block_state_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, cache_impl: str = "dense",
                     page_size: int = 64, pool_pages: int = 0,
                     page_table=None, ext_pool=None):
    """Per-layer decode state: a page pool + table for global layers under
    ``cache_impl="paged"``, else a dense [B, cap, Hkv, Dh] buffer (local
    layers keep a window-capped rolling buffer in both modes); recurrent
    and rwkv layers hold their fp32 recurrent states in both modes.

    ext_pool: optional ``(k, v)`` pool buffers retained from an earlier
    wave (``core.state.capture_pools``), taken as they are in place of
    fresh zeroed pools."""
    if kind == "recurrent":
        return rglru_lib.rglru_state_init(cfg, batch, device)
    if kind == "rwkv":
        return rwkv_lib.rwkv_state_init(cfg, batch, device)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    if kind == "global" and cache_impl == "paged":
        if ext_pool is not None:
            k, v = ext_pool
            assert k.shape == (pool_pages, page_size, hkv, dh) \
                and k.dtype == dtype, ("retained pool geometry mismatch",
                                       tuple(k.shape))
            return {"k": k, "v": v, "pt": page_table}
        return {"k": kvc.init_pool(pool_pages, page_size, hkv, dh, dtype,
                                   device),
                "v": kvc.init_pool(pool_pages, page_size, hkv, dh, dtype,
                                   device),
                "pt": page_table}
    cap = max_len if kind == "global" else min(max_len, cfg.sliding_window)
    return {"k": torch.zeros((batch, cap, hkv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cap, hkv, dh), dtype=dtype,
                             device=device)}


def default_block_mask(tb: int, window, device):
    """Causal-in-block mask, window-limited like
    :func:`attend_cache_plus_block`'s default."""
    blk = torch.ones((tb, tb), dtype=torch.bool, device=device).tril()
    if window is not None:
        ji = torch.arange(tb, device=device)[None, :]
        ii = torch.arange(tb, device=device)[:, None]
        blk = blk & (ji > (ii - window))
    return blk


def block_apply(p, x, cfg: ModelConfig, kind: str, *, state=None,
                cache_len=None, positions=None, write_kv: bool = False,
                extra_mask=None, attn_impl: str = "auto",
                kv_chunk: int = 1024, attend_cache_on_write: bool = False,
                snap_at=None):
    """Apply one block. Returns (y, kv_out); cache writes are in place.

    kv_out: (k, v) of this pass in decode/verify mode, for the commit
    (None for recurrent and rwkv blocks).
    snap_at: optional [B]: each row consumes exactly ``snap_at`` tokens (a
    prompt padded to a bucket, or a replay of the accepted path): KV
    writes past it are dropped and recurrent states snap there.
    """
    kv_out = None
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "recurrent":
        y, new = rglru_lib.rglru_block(p["rec"], h, cfg, state=state,
                                       snap_at=snap_at)
        _write_states_(state, new, write_kv)
    elif kind == "rwkv":
        y, new = rwkv_lib.time_mix(p["rwkv_tm"], h, cfg, state=state,
                                   snap_at=snap_at)
        _write_states_(state, new, write_kv)
    else:
        y, kv_out = _attention(
            p, h, cfg, kind, state=state, cache_len=cache_len,
            positions=positions, write_kv=write_kv, extra_mask=extra_mask,
            attn_impl=attn_impl, kv_chunk=kv_chunk,
            attend_cache_on_write=attend_cache_on_write, snap_at=snap_at)
    if cfg.use_post_norm:
        y = rmsnorm(p["ln1_post"], y, cfg.norm_eps)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == "rwkv":
        y, new = rwkv_lib.channel_mix(p["rwkv_cm"], h, cfg, state=state,
                                      snap_at=snap_at)
        _write_states_(state, new, write_kv)
    else:
        y = mlp(p["ffn"], h, cfg.mlp_act, cfg.mlp_gated)
    if cfg.use_post_norm:
        y = rmsnorm(p["ln2_post"], y, cfg.norm_eps)
    return x + y, kv_out


def _write_states_(state, new, write_kv):
    """Copy a recurrent block's new states into ``state``'s tensors, in
    place (so a captured CUDA graph reads and writes fixed storage);
    nothing without ``write_kv`` or without a state."""
    if state is not None and write_kv:
        for name, val in new.items():
            state[name].copy_(val)


def _attention(p, h, cfg, kind, *, state, cache_len, positions, write_kv,
               extra_mask, attn_impl, kv_chunk, attend_cache_on_write,
               snap_at):
    """The attention mixer of a global or local block: (y, kv_out)."""
    kv_out = None
    window = cfg.sliding_window if kind == "local" else None
    q, k, v = project_qkv(p["attn"], h, cfg, positions=positions)
    if state is None:
        y = attend(q, k, v, causal=True, q_offset=0, window=window,
                   extra_mask=extra_mask, attn_softcap=cfg.attn_softcap,
                   impl=attn_impl, kv_chunk=kv_chunk)
    else:
        paged = kvc.is_paged(state)
        rolling = kind == "local"
        cap = kvc.logical_len(state) if paged else state["k"].shape[1]

        def cache_view():
            if paged:
                ck = kvc.pool_view(state["k"], state["pt"])
                cv = kvc.pool_view(state["v"], state["pt"])
            else:
                ck, cv = state["k"], state["v"]
            return ck.to(k.dtype), cv.to(v.dtype)

        def q_abs():
            if positions is not None:
                return positions
            return (torch.as_tensor(cache_len, device=h.device)[..., None]
                    + torch.arange(q.shape[1], device=h.device))

        if write_kv:
            if attend_cache_on_write:
                ck, cv = cache_view()
                y = attend_cache_plus_block(
                    q, torch.cat([ck, k], 1), torch.cat([cv, v], 1),
                    cache_cap=cap, cache_len=cache_len, q_abs=q_abs(),
                    window=window, extra_mask=extra_mask,
                    attn_softcap=cfg.attn_softcap, impl=attn_impl,
                    kv_chunk=kv_chunk, rolling=rolling)
            else:
                y = attend(q, k, v, causal=True, q_offset=0, window=window,
                           attn_softcap=cfg.attn_softcap, impl=attn_impl,
                           kv_chunk=kv_chunk)
            for name, new in (("k", k), ("v", v)):
                if paged:
                    b, t = new.shape[:2]
                    clen = torch.as_tensor(cache_len, device=h.device)
                    clen = clen.reshape(-1).expand(b)
                    ar = torch.arange(t, device=h.device)
                    pos = clen[:, None] + ar
                    valid = (ar[None, :] < snap_at[:, None]
                             if snap_at is not None else None)
                    kvc.pool_scatter_(state[name], state["pt"], new, pos,
                                      valid)
                else:
                    _scatter_kv_(state[name], new, cache_len, rolling,
                                 write_len=snap_at)
        elif cfg.attn_impl == "kernel":
            # the CUDA cascade kernels read the cache buffers in place
            from repro_torch.kernels import ops as kops
            blk_mask = extra_mask
            if blk_mask is None:
                blk_mask = default_block_mask(k.shape[1], window, h.device)
            b, tq = q.shape[:2]
            qa = torch.as_tensor(q_abs(), device=h.device).to(torch.int32)
            qa = qa.reshape(-1, tq).expand(b, tq)
            if paged:
                y = kops.cascade_attention_paged(
                    q, state["k"].to(k.dtype), state["v"].to(v.dtype),
                    state["pt"], k, v, cache_len=cache_len, q_abs=qa,
                    tree_mask=blk_mask, window=window,
                    attn_softcap=cfg.attn_softcap)
            else:
                y = kops.cascade_attention(
                    q, state["k"].to(k.dtype), state["v"].to(v.dtype), k, v,
                    cache_len=cache_len, q_abs=qa, tree_mask=blk_mask,
                    window=window, attn_softcap=cfg.attn_softcap,
                    rolling=rolling)
            kv_out = (k, v)
        else:
            ck, cv = cache_view()
            y = attend_cache_plus_block(
                q, torch.cat([ck, k], 1), torch.cat([cv, v], 1),
                cache_cap=cap, cache_len=cache_len, q_abs=q_abs(),
                window=window, extra_mask=extra_mask,
                attn_softcap=cfg.attn_softcap, impl=attn_impl,
                kv_chunk=kv_chunk, rolling=rolling)
            kv_out = (k, v)
    return out_proj(p["attn"], y), kv_out


def _scatter_kv_(buf, new, start, rolling: bool, write_len=None):
    """Write [B,T,H,D] into [B,cap,H,D] at ``start`` (scalar or [B]; mod
    cap when rolling), in place. Out-of-range writes are dropped
    (``kvcache.drop_put_``); so are entries at or past ``write_len`` [B]
    (a padded prompt's tail)."""
    b, cap = buf.shape[:2]
    t = new.shape[1]
    dev = buf.device
    start = torch.as_tensor(start, device=dev).long().reshape(-1).expand(b)
    if rolling and t >= cap and write_len is None:
        # only the last ``cap`` tokens survive a full wrap
        new = new[:, -cap:]
        start = start + (t - cap)
        t = cap
    ar = torch.arange(t, device=dev)[None, :]
    idx = start[:, None] + ar
    if rolling:
        idx = torch.remainder(idx, cap)
    ok = (idx >= 0) & (idx < cap)
    if write_len is not None:
        keep = ar < write_len[:, None]
        if rolling:
            # only the last ``cap`` real tokens survive a wrap; dropping
            # the earlier ones keeps the write free of duplicate indices
            keep = keep & (ar >= write_len[:, None] - cap)
        ok = ok & keep
    ok = ok.reshape(-1)
    flat = (torch.arange(b, device=dev)[:, None] * cap + idx).reshape(-1)
    kvc.drop_put_(buf.view(b * cap, *buf.shape[2:]), 0, flat,
                  new.reshape(b * t, *new.shape[2:]), ok)
    return buf

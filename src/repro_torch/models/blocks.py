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
takes the MLP's place, ``models/rwkv.py``). The FFN is the MLP, or with
``cfg.moe`` the mixture of experts of ``models/moe.py``. A block may
carry a cross-attention sub-layer before its mixer (VLM, encoder-decoder
decoder; :func:`period_spec` says which): a pass with ``ctx`` projects the
context's K/V (and writes them into the block's ``ck``/``cv`` cache, in
place, when it has a state); a pass without it reads that cache.

Recurrent state leaves (fp32, batch-leading) are written in place by a
pass with ``write_kv`` (prefill, replay), like the KV caches; with
``snap_at`` they hold the state after exactly ``snap_at`` tokens. A pass
without ``write_kv`` (the read-only verify pass) leaves them as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.distributed import spdecode
from repro_torch.models import kvcache as kvc
from repro_torch.models.attention import (attend, attend_cache_plus_block,
                                          attn_init, out_proj, project_qkv)
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.layers import dense, rmsnorm
from repro_torch.models.mlp import mlp, mlp_init

KINDS = ("global", "local", "recurrent", "rwkv")


def check_supported(cfg: ModelConfig):
    """Raise for a layer kind the port has no block for."""
    for kind in set(cfg.pattern_for_depth()):
        if kind not in KINDS:
            raise NotImplementedError(f"block kind {kind!r} is not ported")


# ------------------------------------------------------------ period spec --
@dataclasses.dataclass(frozen=True)
class BlockSpec2:
    kind: str            # global | local | recurrent | rwkv
    cross: bool = False  # a cross-attention sub-layer before the mixer


def period_spec(cfg: ModelConfig) -> Tuple[Tuple[BlockSpec2, ...], int,
                                           Tuple[BlockSpec2, ...]]:
    """(period, n_periods, tail) of the JAX scanned stack, covering
    ``cfg.num_layers`` layers: with ``cross_attn_every`` the pattern is
    expanded to ``lcm(len(pattern), cross_attn_every)`` layers and every
    ``cross_attn_every``-th one carries cross-attention. Features for the
    drafter are the hiddens at period ends and after each tail layer."""
    pat = list(cfg.layer_pattern)
    ce = cfg.cross_attn_every
    if ce:
        pat = pat * (math.lcm(len(pat), ce) // len(pat))
        spec = tuple(BlockSpec2(k, cross=(i + 1) % ce == 0)
                     for i, k in enumerate(pat))
    else:
        spec = tuple(BlockSpec2(k) for k in pat)
    plen = len(spec)
    n_periods = cfg.num_layers // plen
    tail = tuple(spec[i % plen] for i in range(cfg.num_layers
                                               - n_periods * plen))
    return spec, n_periods, tail


def layer_specs(cfg: ModelConfig) -> Tuple[BlockSpec2, ...]:
    """Each layer's spec, in depth order (the periods, then the tail)."""
    spec, n_periods, tail = period_spec(cfg)
    return spec * n_periods + tail


# ----------------------------------------------------------------- block ---
def block_init(gen, cfg: ModelConfig, spec: BlockSpec2, expert_part=None):
    kind = spec.kind
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
    elif cfg.moe is not None:
        p["ffn"] = moe_lib.moe_init(gen, cfg, expert_part)
    else:
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated)
    if spec.cross:
        p["ln_x"] = ones()
        p["xattn"] = attn_init(gen, cfg, cross=True)
    if cfg.use_post_norm:
        p["ln1_post"] = ones()
        p["ln2_post"] = ones()
    return p


def block_state_init(cfg: ModelConfig, spec: BlockSpec2, batch: int,
                     max_len: int, dtype, device, ctx_len: int = 0,
                     cache_impl: str = "dense", page_size: int = 64,
                     pool_pages: int = 0, page_table=None, ext_pool=None):
    """Per-layer decode state: a page pool + table for global layers under
    ``cache_impl="paged"``, else a dense [B, cap, Hkv, Dh] buffer (local
    layers keep a window-capped rolling buffer in both modes); recurrent
    and rwkv layers hold their fp32 recurrent states in both modes. Inside
    a mesh a dense buffer holds this rank's run of the slots under a
    kv_seq axis (``kvcache.dense_cache``) and a recurrent state its slice
    by JAX's state rules (``kvcache.state_leaf``). A
    cross block also holds its context's K/V, ``ck``/``cv`` [B,
    max(ctx_len, 1), Hkv, Dh], which a pass with ``ctx`` writes in place.

    ext_pool: optional ``(k, v)`` pool buffers retained from an earlier
    wave (``core.state.capture_pools``), taken as they are in place of
    fresh zeroed pools."""
    st = _self_state(cfg, spec.kind, batch, max_len, dtype, device,
                     cache_impl, page_size, pool_pages, page_table, ext_pool)
    if spec.cross:
        shape = (batch, max(ctx_len, 1), cfg.num_kv_heads, cfg.head_dim)
        st["ck"] = torch.zeros(shape, dtype=dtype, device=device)
        st["cv"] = torch.zeros(shape, dtype=dtype, device=device)
    return st


def _self_state(cfg, kind, batch, max_len, dtype, device, cache_impl,
                page_size, pool_pages, page_table, ext_pool):
    if kind in ("recurrent", "rwkv"):
        init = (rglru_lib.rglru_state_init if kind == "recurrent"
                else rwkv_lib.rwkv_state_init)
        return {k: kvc.state_leaf(k, v)
                for k, v in init(cfg, batch, device).items()}
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    if kind == "global" and cache_impl == "paged":
        if ext_pool is not None:
            k, v = ext_pool
            assert k.shape == (pool_pages, kvc.local_page(page_size), hkv,
                               dh) and k.dtype == dtype, (
                "retained pool geometry mismatch", tuple(k.shape))
            return {"k": k, "v": v, "pt": page_table}
        return {"k": kvc.init_pool(pool_pages, page_size, hkv, dh, dtype,
                                   device),
                "v": kvc.init_pool(pool_pages, page_size, hkv, dh, dtype,
                                   device),
                "pt": page_table}
    cap = max_len if kind == "global" else min(max_len, cfg.sliding_window)
    return {name: kvc.dense_cache((batch, cap, hkv, dh), 1, dtype, device)
            for name in ("k", "v")}


def default_block_mask(tb: int, window, device):
    """Causal-in-block mask, window-limited like
    :func:`attend_cache_plus_block`'s default."""
    blk = torch.ones((tb, tb), dtype=torch.bool, device=device).tril()
    if window is not None:
        ji = torch.arange(tb, device=device)[None, :]
        ii = torch.arange(tb, device=device)[:, None]
        blk = blk & (ji > (ii - window))
    return blk


def block_apply(p, x, cfg: ModelConfig, spec: BlockSpec2, *, state=None,
                cache_len=None, positions=None, write_kv: bool = False,
                extra_mask=None, ctx=None, attn_impl: str = "auto",
                kv_chunk: int = 1024, attend_cache_on_write: bool = False,
                snap_at=None, tp=None):
    """Apply one block. Returns (y, kv_out); cache writes are in place.

    tp: a train step's view of the mesh (``distributed/train_mesh.py``;
    stateless passes only), whose ``p`` holds the rank's storage with the
    FSDP leaves gathered: ``x`` is the rank's tokens, the sequence is
    gathered before the attention and the MLP, which run at the rank's
    heads and ffn columns, and their partial sums are reduce-scattered
    back to its tokens (JAX's ``constrain`` sites of the residual
    stream); a MoE FFN runs on the whole batch's rows, gathered over the
    batch axes, as JAX fits its capacity over the whole batch.

    kv_out: (k, v) of this pass in decode/verify mode, for the commit
    (None for recurrent and rwkv blocks).
    snap_at: optional [B]: each row consumes exactly ``snap_at`` tokens (a
    prompt padded to a bucket, or a replay of the accepted path): KV
    writes past it are dropped and recurrent states snap there.
    ctx: optional [B, T_ctx, d] context of a cross block (image
    embeddings, the encoder's output); without it a cross block reads its
    state's ``ck``/``cv``.
    """
    kind = spec.kind
    kv_out = None
    if spec.cross:
        x = x + _cross_attention(p, x, cfg, state=state, ctx=ctx,
                                 attn_impl=attn_impl, kv_chunk=kv_chunk)
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
        if tp is not None:
            h = tp.seq_gather(h)
        y, kv_out = _attention(
            p, h, cfg, kind, state=state, cache_len=cache_len,
            positions=positions, write_kv=write_kv, extra_mask=extra_mask,
            attn_impl=attn_impl, kv_chunk=kv_chunk,
            attend_cache_on_write=attend_cache_on_write, snap_at=snap_at,
            tp=tp)
        if tp is not None:
            y = tp.seq_scatter(y)
    if cfg.use_post_norm:
        y = rmsnorm(p["ln1_post"], y, cfg.norm_eps)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == "rwkv":
        y, new = rwkv_lib.channel_mix(p["rwkv_cm"], h, cfg, state=state,
                                      snap_at=snap_at)
        _write_states_(state, new, write_kv)
    elif cfg.moe is not None:
        if tp is not None:
            y = tp.rows_mine(moe_lib.moe_apply(p["ffn"], tp.rows_whole(h),
                                               cfg))
        else:
            y = moe_lib.moe_apply(p["ffn"], h, cfg)
    else:
        if tp is not None:
            h = tp.seq_gather(h)
        y = mlp(p["ffn"], h, cfg.mlp_act, cfg.mlp_gated)
        if tp is not None:
            y = tp.seq_scatter(y)
    if cfg.use_post_norm:
        y = rmsnorm(p["ln2_post"], y, cfg.norm_eps)
    return x + y, kv_out


def _cross_attention(p, x, cfg, *, state, ctx, attn_impl, kv_chunk):
    """The cross sub-layer's residual branch (before the mixer, as in
    Flamingo and Llama 3.2 Vision): queries from the stream, keys and
    values from ``ctx`` (written into ``state``'s ``ck``/``cv`` in place,
    which must be as long as ``ctx``) or, without ``ctx``, from that
    cache. No RoPE, no QKV bias, no qk-norm."""
    h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    if ctx is not None:
        b, tc = ctx.shape[:2]
        ck = dense(p["xattn"]["wk"], ctx).reshape(b, tc, hkv, dh)
        cv = dense(p["xattn"]["wv"], ctx).reshape(b, tc, hkv, dh)
        if state is not None:
            if state["ck"].shape != ck.shape:
                raise ValueError(
                    f"cross cache {tuple(state['ck'].shape)} does not fit a "
                    f"context of {tuple(ctx.shape)}: size the states with "
                    f"ctx_len={tc}")
            state["ck"].copy_(ck)
            state["cv"].copy_(cv)
    elif state is not None:
        ck, cv = state["ck"], state["cv"]
    else:
        raise ValueError("a cross block needs ctx or a state with its "
                         "cross cache")
    b, t = h.shape[:2]
    q = dense(p["xattn"]["wq"], h).reshape(b, t, cfg.num_heads, dh)
    if attn_impl == "kernel":       # the flash kernels take one dtype
        ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    xo = attend(q, ck, cv, causal=False, q_offset=0,
                attn_softcap=cfg.attn_softcap, impl=attn_impl,
                kv_chunk=kv_chunk)
    return out_proj(p["xattn"], xo)


def _write_states_(state, new, write_kv):
    """Copy a recurrent block's new states into ``state``'s tensors, in
    place (so a captured CUDA graph reads and writes fixed storage);
    nothing without ``write_kv`` or without a state."""
    if state is not None and write_kv:
        for name, val in new.items():
            state[name].copy_(val)


def _attention(p, h, cfg, kind, *, state, cache_len, positions, write_kv,
               extra_mask, attn_impl, kv_chunk, attend_cache_on_write,
               snap_at, tp=None):
    """The attention mixer of a global or local block: (y, kv_out)."""
    kv_out = None
    window = cfg.sliding_window if kind == "local" else None
    q, k, v = project_qkv(p["attn"], h, cfg, positions=positions, tp=tp)
    if state is None:
        y = attend(q, k, v, causal=True, q_offset=0, window=window,
                   extra_mask=extra_mask, attn_softcap=cfg.attn_softcap,
                   impl=attn_impl, kv_chunk=kv_chunk)
    else:
        paged = kvc.is_paged(state)
        rolling = kind == "local"
        cap = (kvc.logical_len(state) if paged
               else kvc.slot_run(state["k"], 1).cap)

        def cache_view():
            if paged:
                ck = kvc.logical_view(state["k"], state["pt"])
                cv = kvc.logical_view(state["v"], state["pt"])
            else:
                ck = kvc.dense_view(state["k"], 1)
                cv = kvc.dense_view(state["v"], 1)
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
        elif (y := _sharded_read(q, k, v, state, cfg, paged, rolling,
                                 window, cap, cache_len, q_abs, extra_mask,
                                 kv_chunk)) is not None:
            kv_out = (k, v)
        elif cfg.attn_impl == "kernel" and spdecode.kv_seq_axis() is None:
            # the CUDA cascade kernels read the cache buffers in place (as
            # in JAX, not inside a kv_seq mesh: what the sharded hook
            # leaves there reads through the gather path)
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


def _sharded_read(q, k, v, state, cfg, paged, rolling, window, cap,
                  cache_len, q_abs, extra_mask, kv_chunk):
    """The decode read under a kv_seq mesh (twin of the JAX hook in
    ``blocks.py``), or None where it does not apply: a paged, non-rolling,
    windowless cache goes to ``sharded_paged_cache_attend`` with
    ``read_impl=cfg.attn_impl`` (the local pool: kernel #2 with
    pos_stride/pos_offset, or the gather of the local run); a dense one
    stored as runs of at least 128 slots a rank to
    ``sharded_cache_attend`` on the local run (merged in bfloat16, as
    JAX's hook passes no merge dtype); anything else reads unsharded,
    through the gathered view (and so does every read without a kv_seq
    axis). ``q_abs``: a function that gives the queries' absolute
    positions."""
    if spdecode.kv_seq_axis() is None:
        return None
    blk_mask = extra_mask
    if blk_mask is None:
        tb = k.shape[1]
        blk_mask = torch.ones((tb, tb), dtype=torch.bool,
                              device=q.device).tril()
    if not paged:
        run = kvc.slot_run(state["k"], 1)
        if run.whole or run.n < 128:
            return None
        return spdecode.sharded_cache_attend(
            q, state["k"].to(k.dtype), state["v"].to(v.dtype), k, v,
            cache_len=cache_len, q_abs=q_abs(), window=window,
            attn_softcap=cfg.attn_softcap, blk_mask=blk_mask,
            rolling=rolling, kv_chunk=kv_chunk)
    if rolling or window is not None:
        return None
    page_size = kvc.page_geometry(state)[0]
    return spdecode.sharded_paged_cache_attend(
        q, state["k"].to(k.dtype), state["v"].to(v.dtype), state["pt"], k, v,
        cache_len=cache_len, q_abs=q_abs(), attn_softcap=cfg.attn_softcap,
        blk_mask=blk_mask, page_size=page_size, kv_chunk=kv_chunk,
        read_impl=cfg.attn_impl)


def _scatter_kv_(buf, new, start, rolling: bool, write_len=None):
    """Write [B,T,H,D] into [B,cap,H,D] at ``start`` (scalar or [B]; mod
    cap when rolling), in place. Out-of-range writes are dropped
    (``kvcache.drop_put_``); so are entries at or past ``write_len`` [B]
    (a padded prompt's tail), and under a kv_seq mesh those whose slot
    lies outside this rank's run (``kvcache.dense_slots``)."""
    b, n = buf.shape[:2]
    cap = kvc.slot_run(buf, 1).cap
    t = new.shape[1]
    dev = buf.device
    start = torch.as_tensor(start, device=dev).long().reshape(-1).expand(b)
    if rolling and t >= cap and write_len is None:
        # only the last ``cap`` tokens survive a full wrap
        new = new[:, -cap:]
        start = start + (t - cap)
        t = cap
    ar = torch.arange(t, device=dev)[None, :]
    idx, ok = kvc.dense_slots(buf, 1, start[:, None] + ar, rolling)
    if write_len is not None:
        keep = ar < write_len[:, None]
        if rolling:
            # only the last ``cap`` real tokens survive a wrap; dropping
            # the earlier ones keeps the write free of duplicate indices
            keep = keep & (ar >= write_len[:, None] - cap)
        ok = ok & keep
    ok = ok.reshape(-1)
    flat = (torch.arange(b, device=dev)[:, None] * n + idx).reshape(-1)
    kvc.drop_put_(buf.view(b * n, *buf.shape[2:]), 0, flat,
                  new.reshape(b * t, *new.shape[2:]), ok)
    return buf

"""Causal LM: embedding -> block stack -> final norm -> lm head (twin of
``repro/models/lm.py``).

Params: ``{"tok": {"embedding"}, "ln_f": {"scale"}, "lm_head",
"layers": [block params, in depth order]}`` — the JAX period axis
(``params["period"]``, a ``lax.scan`` over stacked layers) is a Python
loop here; ``repro_torch.convert`` unstacks it. States:
``{"layers": [per-layer cache dicts], "length": [B] int32}``.

Training: :func:`loss_fn` (cross entropy with z-loss, optionally chunked
over the sequence) through :func:`forward`, whose layers are
rematerialized under ``cfg.remat`` as the JAX period scan is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import param as pm
from repro_torch.models.blocks import (block_apply, block_init,
                                       block_state_init, check_supported,
                                       layer_specs, period_spec)
from repro_torch.models.layers import embed, rmsnorm, softcap, unembed

FEATURE_LAYERS = 3


# ------------------------------------------------------------------ init ---
def lm_init(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights drawn on ``device`` from a generator seeded ``seed``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = pm.make_generator(seed, dev)
    p: Dict[str, Any] = {
        "tok": {"embedding": pm.trunc_normal(
            gen, (cfg.vocab_size, cfg.d_model), stddev=0.02)},
        "ln_f": {"scale": torch.ones((cfg.d_model,), device=dev)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = pm.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                     scale=0.02)
    p["layers"] = [block_init(gen, cfg, spec) for spec in layer_specs(cfg)]
    return p


def init_states(cfg: ModelConfig, batch: int, max_len: int, ctx_len: int = 0,
                dtype=None, cache_impl: str = "dense", page_size: int = 64,
                pool_pages: Optional[int] = None, page_table=None,
                device="cuda", ext_pools=None):
    """Allocate per-layer decode states.

    ctx_len: the context length the cross blocks' ``ck``/``cv`` caches
    hold (at least 1, as in JAX): a pass with ``ctx`` of that length
    writes them, every later pass reads them.

    cache_impl="paged": global-attention KV lives in page pools shared
    across the batch; ``page_table`` [B, max_pages] (default: the identity
    layout) is one tensor shared by every paged layer, so patching one of
    its rows in place reaches every layer.

    ext_pools: optional ``{layer index: (k, v)}`` pool buffers retained
    from an earlier wave (``core.state.capture_pools``), adopted in place
    of fresh zeroed pools.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else getattr(torch, cfg.dtype)
    if cache_impl == "paged":
        pool_pages, page_table = kvcache.default_page_layout(
            batch, max_len, page_size, pool_pages, page_table, dev)
        page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                     device=dev)
    elif cache_impl != "dense":
        raise ValueError(f"cache_impl={cache_impl!r}")
    ext_pools = ext_pools or {}
    assert not ext_pools or cache_impl == "paged", \
        "retained pool buffers require cache_impl='paged'"
    layers = [block_state_init(cfg, spec, batch, max_len, dtype, dev,
                               ctx_len=ctx_len, cache_impl=cache_impl,
                               page_size=page_size,
                               pool_pages=pool_pages or 0,
                               page_table=page_table,
                               ext_pool=ext_pools.get(i))
              for i, spec in enumerate(layer_specs(cfg))]
    return {"layers": layers,
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


# --------------------------------------------------------------- forward ---
def forward(params, tokens, cfg: ModelConfig, *, states=None, cache_len=None,
            positions=None, write_kv: bool = False, extra_mask=None,
            ctx=None, attn_impl: str = "auto", kv_chunk: int = 1024,
            want_features: bool = False, want_logits: bool = True,
            attend_cache_on_write: bool = False, snap_at=None):
    """tokens: [B,T] integer.

    ctx: optional [B, T_ctx, d] context of the cross blocks (image
    embeddings, the encoder's output); with states, the pass writes the
    cross caches, and a pass without ``ctx`` reads them.

    Returns dict(logits, states, features, kv_outs, hidden). With
    ``write_kv`` the block K/V are written into ``states``' buffers in
    place and the returned states carry the advanced ``length``.
    snap_at: optional [B]: each row advances by exactly ``snap_at`` tokens
    and its KV writes past them are dropped (a prompt padded to a bucket).

    Under ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), so its activations are recomputed in the backward,
    as JAX checkpoints each scanned period. Policy "dots" (JAX keeps the
    matmul outputs) runs as "full" here. It applies to the stateless
    (training) pass with autograd on; a pass over caches writes them in
    place and is never recomputed.
    """
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["tok"], tokens, dtype)
    b, t = x.shape[:2]
    dev = x.device
    if states is not None and cache_len is None:
        cache_len = states["length"]
    if cache_len is None:
        cache_len = torch.zeros((), dtype=torch.int32, device=dev)
    cache_len = torch.as_tensor(cache_len, device=dev)
    if positions is None:
        ar = torch.arange(t, dtype=torch.int32, device=dev)
        positions = (cache_len[:, None] + ar[None, :] if cache_len.ndim
                     else cache_len + ar)
    spec, n_periods, _ = period_spec(cfg)
    plen = len(spec)
    remat = cfg.remat and states is None and torch.is_grad_enabled()
    hiddens = []
    kv_outs = []
    for i, bs in enumerate(layer_specs(cfg)):
        st = states["layers"][i] if states is not None else None

        def layer(x, i=i, bs=bs, st=st):
            return block_apply(
                params["layers"][i], x, cfg, bs, state=st,
                cache_len=cache_len, positions=positions, write_kv=write_kv,
                extra_mask=extra_mask, ctx=ctx, attn_impl=attn_impl,
                kv_chunk=kv_chunk,
                attend_cache_on_write=attend_cache_on_write, snap_at=snap_at)

        if remat:
            x, kv = checkpoint(layer, x, use_reentrant=False)
        else:
            x, kv = layer(x)
        kv_outs.append(kv)
        if want_features and ((i + 1) % plen == 0 or i >= n_periods * plen):
            hiddens.append(x)
            del hiddens[:-FEATURE_LAYERS]
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)

    features = None
    if want_features:
        features = torch.stack(hiddens, dim=2).reshape(
            b, t, len(hiddens) * cfg.d_model)

    logits = None
    if want_logits:
        logits = softcap(unembed(_head(params, cfg), x), cfg.logit_softcap)

    out_states = None
    if states is not None:
        out_states = dict(states)
        if write_kv:
            new_len = cache_len + (t if snap_at is None else snap_at)
            # a tensor of its own (not a broadcast view), so that a row
            # of it can be written in place
            out_states["length"] = new_len.expand(
                states["length"].shape).to(torch.int32).contiguous()
    return {"logits": logits, "states": out_states, "features": features,
            "kv_outs": kv_outs, "hidden": x}


def _head(params, cfg: ModelConfig):
    return (params["tok"]["embedding"].T if cfg.tie_embeddings
            else params["lm_head"])


# ------------------------------------------------------------ loss/train ---
def _token_nll(logits, labels, z_loss: float = 1e-4):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return nll + z_loss * torch.square(lse) if z_loss else nll


def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """logits [B,T,V] (any float), labels [B,T] integer; mean NLL (over
    the mask's ones) plus ``z_loss * lse^2``."""
    nll = _token_nll(logits, labels, z_loss)
    if mask is not None:
        nll = nll * mask
        denom = mask.sum().clamp_min(1.0)
    else:
        denom = nll.numel()
    return nll.sum() / denom


def _chunk_nll(head, hj, lj, mj, logit_softcap):
    return (_token_nll(softcap(unembed(head, hj), logit_softcap), lj)
            * mj).sum()


def loss_fn(params, batch, cfg: ModelConfig, *, attn_impl="auto",
            kv_chunk=1024, loss_seq_chunk: Optional[int] = None, ctx=None):
    """batch: dict(tokens [B,S], labels [B,S], mask [B,S]) of tensors;
    ``ctx``: the cross blocks' context (:func:`forward`).

    ``loss_seq_chunk``: the cross entropy over sequence chunks of that
    length, each rematerialized, so [B,S,V] logits never exist at once.
    """
    out = forward(params, batch["tokens"], cfg, attn_impl=attn_impl,
                  kv_chunk=kv_chunk, ctx=ctx,
                  want_logits=loss_seq_chunk is None)
    if loss_seq_chunk is None:
        return cross_entropy(out["logits"], batch["labels"],
                             batch.get("mask"))
    h = out["hidden"]
    head = _head(params, cfg)
    s = h.shape[1]
    c = loss_seq_chunk
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of "
                         f"loss_seq_chunk {c}")
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                          device=h.device)
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for j in range(0, s, c):
        mj = mask[:, j:j + c]
        tot = tot + checkpoint(_chunk_nll, head, h[:, j:j + c],
                               batch["labels"][:, j:j + c], mj,
                               cfg.logit_softcap, use_reentrant=False)
        cnt = cnt + mj.sum()
    return tot / cnt.clamp_min(1.0)


def feature_dim(cfg: ModelConfig) -> int:
    """Width of the drafter-conditioning features ``forward`` emits:
    min(3, period-end + tail hiddens) * d_model."""
    _, n_periods, tail = period_spec(cfg)
    avail = n_periods + len(tail)
    return min(FEATURE_LAYERS, max(avail, 1)) * cfg.d_model


# -------------------------------------------------------------- KV commit --
def commit_kv(states, kv_outs, cfg: ModelConfig, path_idx, n_commit):
    """Write the accepted path's KV into the caches, in place.

    path_idx: [B, P] tree-node indices of the best path (anchor first).
    n_commit: [B] tokens to commit per example; entries past it are not
    written (a fixed-shape write, ``kvcache.drop_put_``). Returns the states with ``length`` advanced by ``n_commit``.
    """
    length = states["length"].long()
    b, p = path_idx.shape
    dev = path_idx.device
    valid = torch.arange(p, device=dev)[None, :] < n_commit[:, None]
    wpos = length[:, None] + torch.arange(p, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None]
    gidx = path_idx.long()[:, :, None, None]
    for kind, st, kv in zip(cfg.pattern_for_depth(), states["layers"],
                            kv_outs):
        if kv is None:
            continue
        k, v = kv                                   # [B, T_tree, H, D]
        idx = gidx.expand(b, p, k.shape[2], k.shape[3])
        k_path = torch.gather(k, 1, idx)
        v_path = torch.gather(v, 1, idx)
        if kvcache.is_paged(st):
            kvcache.pool_scatter_(st["k"], st["pt"], k_path, wpos, valid)
            kvcache.pool_scatter_(st["v"], st["pt"], v_path, wpos, valid)
            continue
        cap = st["k"].shape[1]
        pos = torch.remainder(wpos, cap) if kind == "local" else wpos
        flat = (rows * cap + pos).reshape(-1)
        ok = (valid & (pos < cap)).reshape(-1)
        for name, new in (("k", k_path), ("v", v_path)):
            buf = st[name]
            kvcache.drop_put_(buf.view(b * cap, *buf.shape[2:]), 0, flat,
                              new.reshape(b * p, *new.shape[2:]), ok)
    out = dict(states)
    out["length"] = (length + n_commit).to(torch.int32)
    return out

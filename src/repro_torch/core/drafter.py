"""Block-diffusion drafters: DFlash first draft + VP-Drafter second draft
(twin of ``repro/core/drafter.py``).

A drafter layer attends ``[W_k/v(proj(target features)) ; W_k/v(block)]``:
target features are FC-projected once and injected into the key/value
projections of every layer ("KV injection"). The projected per-layer
context K/V live in a feature cache (dense or paged) that grows by the
committed tokens of each cycle.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ATTN_IMPLS
from repro_torch.models import kvcache as kvc
from repro_torch.models import param as pm
from repro_torch.models.attention import attend
from repro_torch.models.layers import apply_rope, dense, rmsnorm
from repro_torch.models.mlp import mlp, mlp_init


@dataclasses.dataclass(frozen=True)
class DrafterConfig:
    """Copy of ``repro.core.drafter.DrafterConfig``; ``attn_impl`` takes
    the port's values ("gather" | "kernel")."""
    d_model: int = 256
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 512
    target_feature_dim: int = 768      # feature_layers * target d_model
    gamma: int = 16
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    causal: bool = False               # True => EAGLE-style AR drafter
    # Feature-cache read path: "kernel" reads paged feature pools through
    # the paged cascade kernel per layer; dense caches always gather.
    attn_impl: str = "gather"

    def __post_init__(self):
        assert self.attn_impl in ATTN_IMPLS, (
            f"attn_impl={self.attn_impl!r} not in {ATTN_IMPLS}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def mask_token(self) -> int:
        return self.vocab_size         # embedding table has vocab+1 rows


def drafter_init(dcfg: DrafterConfig, seed: int = 0, device="cuda"):
    """Random drafter weights drawn on ``device`` (seeded generator)."""
    dev = resolve_device(device)
    gen = pm.make_generator(seed, dev)
    hq, hkv, dh = dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim
    d = dcfg.d_model
    ones = lambda: {"scale": torch.ones((d,), device=dev)}  # noqa: E731
    p = {
        "tok": {"embedding": pm.trunc_normal(
            gen, (dcfg.vocab_size + 1, d), stddev=0.02)},
        "feat_proj": pm.dense_init(gen, dcfg.target_feature_dim, d),
        "ln_f": ones(),
        "head": pm.dense_init(gen, d, dcfg.vocab_size, scale=0.02),
    }
    for i in range(dcfg.num_layers):
        p[f"layer{i}"] = {
            "ln1": ones(),
            "wq": pm.dense_init(gen, d, hq * dh),
            "wk": pm.dense_init(gen, d, hkv * dh),
            "wv": pm.dense_init(gen, d, hkv * dh),
            "wo": pm.dense_init(gen, hq * dh, d, scale=(hq * dh) ** -0.5),
            "ln2": ones(),
            "mlp": mlp_init(gen, d, dcfg.d_ff, gated=True),
        }
    return p


# ----------------------------------------------------------- feature cache --
def init_feat_cache(dcfg: DrafterConfig, batch: int, max_len: int, dtype,
                    device, cache_impl: str = "dense", page_size: int = 64,
                    pool_pages=None, page_table=None, ext_pool=None):
    """Dense: k/v [L, B, S_max, Hkv, Dh]. Paged: stacked page pools
    [L, P, page, Hkv, Dh] plus the page table ``pt`` [B, max_pages] (the
    same page-id space as the target's pools). ``ext_pool``: ``(k, v)``
    pools retained from an earlier wave, adopted as they are."""
    l, hkv, dh = dcfg.num_layers, dcfg.num_kv_heads, dcfg.head_dim
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cache_impl == "paged":
        pool_pages, page_table = kvc.default_page_layout(
            batch, max_len, page_size, pool_pages, page_table, device)
        if ext_pool is not None:
            k, v = ext_pool
            assert k.shape == (l, pool_pages, page_size, hkv, dh) \
                and k.dtype == dtype, ("retained pool geometry mismatch",
                                       tuple(k.shape))
        else:
            k, v = (kvc.init_pool(pool_pages, page_size, hkv, dh, dtype,
                                  device, lead=(l,)) for _ in range(2))
        return {"k": k, "v": v,
                "pt": torch.as_tensor(page_table, dtype=torch.int32,
                                      device=device),
                "length": length}
    shape = (l, batch, max_len, hkv, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": length}


def project_features(p, dcfg: DrafterConfig, target_features, positions):
    """target_features: [B,T,Fd]; positions: [B,T] absolute.

    Returns per-layer context (k, v): ([L,B,T,Hkv,Dh], [L,B,T,Hkv,Dh]).
    """
    b, t, _ = target_features.shape
    hkv, dh = dcfg.num_kv_heads, dcfg.head_dim
    f = dense(p["feat_proj"], target_features.to(getattr(torch, dcfg.dtype)))
    ks, vs = [], []
    for i in range(dcfg.num_layers):
        lp = p[f"layer{i}"]
        k = dense(lp["wk"], f).reshape(b, t, hkv, dh)
        ks.append(apply_rope(k, positions, dcfg.rope_theta))
        vs.append(dense(lp["wv"], f).reshape(b, t, hkv, dh))
    return torch.stack(ks), torch.stack(vs)


def extend_feat_cache(p, dcfg, cache, target_features, positions, n_new):
    """Append features of newly committed tokens (per-example ragged), in
    place, by a fixed-shape write (``kvcache.drop_put_``). positions:
    [B,P] absolute; n_new: [B] valid counts. Returns the cache dict with
    ``length`` advanced."""
    k_new, v_new = project_features(p, dcfg, target_features, positions)
    b, pl = positions.shape
    dev = positions.device
    valid = torch.arange(pl, device=dev)[None, :] < n_new[:, None]
    if kvc.is_paged(cache):
        kvc.pool_scatter_(cache["k"], cache["pt"], k_new, positions, valid)
        kvc.pool_scatter_(cache["v"], cache["pt"], v_new, positions, valid)
    else:
        l, cap = cache["k"].shape[0], cache["k"].shape[2]
        pos = positions.long()
        ok = (valid & (pos >= 0) & (pos < cap)).reshape(-1)
        flat = (torch.arange(b, device=dev)[:, None] * cap + pos).reshape(-1)
        for name, new in (("k", k_new), ("v", v_new)):
            buf = cache[name]
            kvc.drop_put_(buf.view(l, b * cap, *buf.shape[3:]), 1, flat,
                          new.reshape(l, b * pl, *new.shape[3:]), ok)
    out = dict(cache)
    out["length"] = (cache["length"] + n_new).to(torch.int32)
    return out


# ----------------------------------------------------------------- forward --
def drafter_forward(p, dcfg: DrafterConfig, block_tokens, feat_cache,
                    positions=None, block_mask=None, attn_impl: str = "auto",
                    kv_chunk: int = 1024):
    """block_tokens: [B,T] (mask token = dcfg.mask_token).

    positions: [B,T] absolute positions of block slots (default:
    feat_len + i). block_mask: optional [T,T] or [B,T,T] intra-block mask;
    default bidirectional (diffusion) or causal when dcfg.causal.
    Returns logits [B,T,V].
    """
    b, t = block_tokens.shape
    dev = block_tokens.device
    dtype = getattr(torch, dcfg.dtype)
    hq, hkv, dh = dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim
    feat_len = feat_cache["length"]
    if positions is None:
        positions = feat_len[:, None] + torch.arange(t, device=dev)[None, :]
    x = p["tok"]["embedding"][block_tokens].to(dtype)
    if block_mask is None:
        block_mask = torch.ones((t, t), dtype=torch.bool, device=dev)
        if dcfg.causal:
            block_mask = block_mask.tril()
    blk = block_mask[None].expand(b, t, t) if block_mask.ndim == 2 \
        else block_mask

    paged = kvc.is_paged(feat_cache)
    # Kernel read: every layer hands its pool slice + the page table to the
    # paged cascade kernel, no gathered copy of the cache. Block slots sit
    # at positions >= feat_len, so the kernel's kpos <= q_abs clamp is
    # implied by its kpos < feat_len mask and both paths attend alike.
    use_kernel = paged and dcfg.attn_impl == "kernel"
    ctx_k, ctx_v = feat_cache["k"], feat_cache["v"]
    full_mask = None
    if not use_kernel:
        if paged:
            # logical per-row view gathered once for all drafter layers
            ctx_k = kvc.pool_view(ctx_k, feat_cache["pt"])
            ctx_v = kvc.pool_view(ctx_v, feat_cache["pt"])
        cap = ctx_k.shape[2]
        ctx_ok = (torch.arange(cap, device=dev)[None, None, :]
                  < feat_len[:, None, None]).expand(b, t, cap)
        full_mask = torch.cat([ctx_ok, blk], dim=-1)

    for i in range(dcfg.num_layers):
        lp = p[f"layer{i}"]
        h = rmsnorm(lp["ln1"], x, dcfg.norm_eps)
        q = dense(lp["wq"], h).reshape(b, t, hq, dh)
        k = dense(lp["wk"], h).reshape(b, t, hkv, dh)
        v = dense(lp["wv"], h).reshape(b, t, hkv, dh)
        q = apply_rope(q, positions, dcfg.rope_theta)
        k = apply_rope(k, positions, dcfg.rope_theta)
        if use_kernel:
            from repro_torch.kernels import ops as kops
            y = kops.cascade_attention_paged(
                q, ctx_k[i].to(k.dtype), ctx_v[i].to(v.dtype),
                feat_cache["pt"], k, v, cache_len=feat_len, q_abs=positions,
                tree_mask=blk)
        else:
            kk = torch.cat([ctx_k[i].to(k.dtype), k], dim=1)
            vv = torch.cat([ctx_v[i].to(v.dtype), v], dim=1)
            y = attend(q, kk, vv, causal=False, extra_mask=full_mask,
                       impl=attn_impl, kv_chunk=kv_chunk)
        x = x + dense(lp["wo"], y.reshape(b, t, hq * dh))
        h = rmsnorm(lp["ln2"], x, dcfg.norm_eps)
        x = x + mlp(lp["mlp"], h)
    x = rmsnorm(p["ln_f"], x, dcfg.norm_eps)
    return dense(p["head"], x)


def dflash_block(anchor, gamma: int, mask_token: int):
    """[B] -> [B, gamma]: [anchor, MASK, ..., MASK]."""
    blk = torch.full((anchor.shape[0], gamma), mask_token, dtype=torch.long,
                     device=anchor.device)
    blk[:, 0] = anchor
    return blk


def vp_blocks(anchor, trunk_tokens, fork_idx, mask_token: int):
    """Second-draft inputs: [B, K, gamma] where branch b keeps the anchor
    and the first fork_b trunk tokens visible and re-masks the rest.

    anchor: [B]; trunk_tokens: [B, gamma-1] (or [B, K, gamma-1]);
    fork_idx: [B, K].
    """
    k = fork_idx.shape[1]
    g1 = trunk_tokens.shape[-1]
    dev = anchor.device
    if trunk_tokens.ndim == 2:
        trunk_tokens = trunk_tokens[:, None, :].expand(-1, k, g1)
    b = trunk_tokens.shape[0]
    full = torch.cat([anchor.long()[:, None, None].expand(b, k, 1),
                      trunk_tokens.long()], dim=2)             # [B,K,gamma]
    slots = torch.arange(g1 + 1, device=dev)[None, None, :]
    visible = slots <= fork_idx[:, :, None]
    return torch.where(visible, full, torch.full_like(full, mask_token))


def ar_chain_draft(p, dcfg: DrafterConfig, anchor, feat_cache, steps: int,
                   temperature: float = 0.0, gen=None):
    """EAGLE-style baseline: draft ``steps`` tokens autoregressively, one
    causal forward over the whole block per token (the JAX twin's
    ``lax.scan``); slots not drafted yet hold token 0. At temperature > 0
    each token is drawn from ``gen``. Returns (tokens [B,steps] long,
    logits [B,steps,V])."""
    b = anchor.shape[0]
    g = steps + 1
    dev = anchor.device
    blk = torch.zeros((b, g), dtype=torch.long, device=dev)
    blk[:, 0] = anchor
    tril = torch.ones((g, g), dtype=torch.bool, device=dev).tril()
    slot = torch.arange(g, device=dev)
    seq = []
    for i in range(steps):
        li = drafter_forward(p, dcfg, blk, feat_cache, block_mask=tril)[:, i]
        if temperature > 0:
            tok = pm.categorical(gen, li.float() / temperature)
        else:
            tok = torch.argmax(li, dim=-1)
        blk = torch.where(slot[None] == i + 1, tok[:, None], blk)
        seq.append(li)
    return blk[:, 1:], torch.stack(seq, 1)

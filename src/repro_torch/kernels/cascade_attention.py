"""Cascade tree-verification attention (twin of
``repro/kernels/cascade_attention.py``).

phase 1 (CUDA): split-K flash partials of the tree query block over the
  long KV cache — dense/rolling buffers (:func:`cascade_phase1`) or a page
  pool read through a page table (:func:`cascade_phase1_paged`). Both
  dtypes run on the tensor cores: bfloat16 with wgmma
  (``csrc/cascade_phase1_sm90.cu``), float32 in 3xTF32, each product formed
  from three TF32 ones to fp32 accuracy (``csrc/cascade_phase1.cu``).
phase 2 (torch, :func:`merge_with_tree_block`): log-sum-exp merge of the
  split partials with the tree-masked attention over the block itself.

Every kernel wrapper dispatches on the device of its query tensor: a CPU
tensor runs the plain torch version (``*_plain``, the same arithmetic
the kernel does, and the oracle the kernel is held to on the card), a
CUDA tensor launches the kernel or raises. There is no fallback (a meta
tensor runs the plain version only inside
``kernels/trace.py::plain_on_meta``, counted by name). Each
wrapper counts its launches in ``<wrapper>.launches``, and those of them
that went to the bf16 kernel in ``<wrapper>.sm90_launches``; the paged
one also counts in ``sharded_launches`` those made with a ``pos_stride``
(the kv_seq-sharded reads of ``distributed/spdecode.py``).

Split semantics match the Pallas kernels so partials compare one to one:
dense ``ns = min(n_splits, ceil(S/bk))`` splits over the cache padded to
``ns*bk`` multiples (padded slots dead); paged ``ns = min(n_splits,
max_pages)`` splits over the table padded to an ``ns`` multiple with
out-of-range entries. A split with no live key reports ``m = -1e30``;
its ``l``/``acc`` are not meaningful and the merge weighs it by 0 (the
kernels write ``acc = l = 0`` for a split with no key in range at all).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import trace

NEG_INF = -1e30


def _split_geometry(s_len: int, n_splits: int, bk: int):
    bk = min(bk, s_len)
    ns = max(1, min(n_splits, -(-s_len // bk)))
    s_pad = s_len + (-s_len) % (ns * bk)
    nk_inner = s_pad // (ns * bk)
    return bk, ns, nk_inner, s_pad


def _paged_geometry(mp: int, n_splits: int):
    ns = max(1, min(n_splits, mp))
    mp_pad = mp + (-mp) % ns
    return ns, mp_pad // ns, mp_pad


def _int_rows(x, b, n, device):
    """Broadcast a scalar / [B] / [B,n] integer to a contiguous int32
    [B, n] (n=None: [B])."""
    t = torch.as_tensor(x, device=device).to(torch.int32)
    if n is None:
        return t.reshape(-1).expand(b).contiguous()
    return t.reshape(-1, n).expand(b, n).contiguous()


def _split_partials(sc, v, ns):
    """Masked scores [B,Hkv,g,Tq,Spad] + values [B,Hkv,Spad,D] -> per-split
    (acc [B,Hq,ns,Tq,D], m, l [B,Hq,ns,Tq])."""
    b, hkv, g, tq, s_pad = sc.shape
    span = s_pad // ns
    sc = sc.reshape(b, hkv, g, tq, ns, span)
    m = sc.amax(dim=-1)                                   # [B,Hkv,g,Tq,ns]
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqsk,bhskd->bhgsqd", p,
                       v.float().reshape(b, hkv, ns, span, -1))
    d = acc.shape[-1]
    return (acc.reshape(b, hkv * g, ns, tq, d),
            m.permute(0, 1, 2, 4, 3).reshape(b, hkv * g, ns, tq),
            l.permute(0, 1, 2, 4, 3).reshape(b, hkv * g, ns, tq))


def _mask_scores(sc, kpos, live, clen, qa, window, attn_softcap):
    """Softcap, then mask (kernel semantics) scores [B,Hkv,g,Tq,S].
    kpos/live: [B or 1, S]; clen [B]; qa [B,Tq]."""
    if attn_softcap is not None:
        sc = attn_softcap * torch.tanh(sc / attn_softcap)
    qp = qa[:, :, None].long()
    kp = kpos[:, None, :]
    ok = live[:, None, :] & (kp < clen[:, None, None]) & (kp <= qp)
    if window is not None:
        ok = ok & (kp > (qp - window))
    return torch.where(ok[:, None, None], sc, NEG_INF)


# ------------------------------------------------------------- dense -------
def cascade_phase1_plain(q, cache_k, cache_v, *, cache_len, q_abs,
                         window=None, attn_softcap=None, scale=None,
                         rolling=False, n_splits=8, bk=512):
    """Plain torch version of :func:`cascade_phase1` (``_phase1_kernel``).

    q [B,Hq,Tq,D]; cache [B,Hkv,S,D] -> acc [B,Hq,ns,Tq,D], m/l [B,Hq,ns,Tq].
    """
    b, hq, tq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    _, ns, _, s_pad = _split_geometry(s_len, n_splits, bk)
    pad = s_pad - s_len
    ck = torch.nn.functional.pad(cache_k.float(), (0, 0, 0, pad))
    cv = torch.nn.functional.pad(cache_v.float(), (0, 0, 0, pad))
    clen = _int_rows(cache_len, b, None, dev).long()
    qa = _int_rows(q_abs, b, tq, dev)
    qf = (q.float() * scale).reshape(b, hkv, g, tq, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, ck)
    slot = torch.arange(s_pad, device=dev)[None, :]
    live = slot < s_len
    if rolling:
        last = clen[:, None] - 1
        # rem, not mod: jax.lax.rem truncates like C's %, as torch.fmod
        kpos = last - torch.fmod(last - slot, s_len)
        live = live & (kpos >= 0)
    else:
        kpos = slot
    sc = _mask_scores(sc, kpos, live, clen, qa, window, attn_softcap)
    return _split_partials(sc, cv, ns)


def cascade_phase1(q, cache_k, cache_v, *, cache_len, q_abs, window=None,
                   attn_softcap=None, scale=None, rolling=False, n_splits=8,
                   bk=512):
    """Split-K flash partials over a DENSE cache (kernel #1).

    q [B,Hq,Tq,D]; cache [B,Hkv,S,D]; q and cache both float32 or both
    bfloat16, any strides with a contiguous last axis (the model passes
    transposed views of its [B,T,Hq,D] queries and [B,S,Hkv,D] buffer; no
    copy).
    ``cache_len`` scalar or [B]; ``q_abs`` [B,Tq] absolute query positions.
    Returns acc [B,Hq,ns,Tq,D], m/l [B,Hq,ns,Tq] in fp32.
    """
    kw = dict(cache_len=cache_len, q_abs=q_abs, window=window,
              attn_softcap=attn_softcap, scale=scale, rolling=rolling,
              n_splits=n_splits, bk=bk)
    if q.device.type == "cpu" or trace.meta_plain("cascade_phase1", q):
        return cascade_phase1_plain(q, cache_k, cache_v, **kw)
    fn, sm90 = _entry("cascade_phase1_dense", q, cache_k, cache_v)
    b, hq, tq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    bk_, ns, nk_inner, _ = _split_geometry(s_len, n_splits, bk)
    qk, q_strides, scale_arg = _q_args(q, scale, sm90)
    clen = _int_rows(cache_len, b, None, q.device)
    qa = _int_rows(q_abs, b, tq, q.device)
    acc, m, l = _outputs(b, hq, ns, tq, d, q.device)
    rc = fn(qk.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            *q_strides, *cache_k.stride()[:3], *cache_v.stride()[:3],
            clen.data_ptr(), qa.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, hq, hkv, tq, d, s_len, bk_, nk_inner, ns,
            int(rolling), int(window) if window is not None else 0,
            float(attn_softcap) if attn_softcap is not None else 0.0,
            *scale_arg, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, fn)
    cascade_phase1.launches += 1
    cascade_phase1.sm90_launches += sm90
    return acc, m, l


cascade_phase1.launches = 0
cascade_phase1.sm90_launches = 0


def merge_with_tree_block(q, blk_k, blk_v, acc, m, l, *, tree_mask,
                          attn_softcap, scale):
    """Phase 2: merge the phase-1 split partials by log-sum-exp with the
    tree-masked attention over the block (fp32 torch, T_tree^2)."""
    g = q.shape[1] // blk_k.shape[1]
    m_g = m.amax(dim=2)                                      # [B,Hq,Tq]
    corr = torch.exp(m - m_g[:, :, None])
    l_g = (l * corr).sum(dim=2)
    acc_g = (acc * corr[..., None]).sum(dim=2)               # [B,Hq,Tq,D]

    qf = q.float() * scale
    kq = blk_k.float().repeat_interleave(g, dim=1)
    vq = blk_v.float().repeat_interleave(g, dim=1)
    sc = torch.einsum("bhqd,bhtd->bhqt", qf, kq)
    if attn_softcap is not None:
        sc = attn_softcap * torch.tanh(sc / attn_softcap)
    tm = tree_mask if tree_mask.ndim == 3 else tree_mask[None]
    sc = torch.where(tm[:, None], sc, NEG_INF)
    m_b = sc.amax(dim=-1)
    p_b = torch.exp(sc - m_b[..., None])
    l_b = p_b.sum(dim=-1)
    acc_b = torch.einsum("bhqt,bhtd->bhqd", p_b, vq)

    m_tot = torch.maximum(m_g, m_b)
    a1 = torch.exp(m_g - m_tot)
    a2 = torch.exp(m_b - m_tot)
    out = (acc_g * a1[..., None] + acc_b * a2[..., None]) / (
        l_g * a1 + l_b * a2).clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def cascade_attention(q, cache_k, cache_v, blk_k, blk_v, *, cache_len,
                      q_abs, tree_mask, window=None, attn_softcap=None,
                      scale=None, rolling=False, n_splits=8, bk=512):
    """Full cascade verify over a dense cache: phase 1 + phase 2.

    q [B,Hq,Tq,D]; cache [B,Hkv,S,D]; blk [B,Hkv,Tb,D]; tree_mask
    [B,Tq,Tb] or [Tq,Tb]; returns [B,Hq,Tq,D].
    """
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    acc, m, l = cascade_phase1(
        q, cache_k, cache_v, cache_len=cache_len, q_abs=q_abs, window=window,
        attn_softcap=attn_softcap, scale=scale_v, rolling=rolling,
        n_splits=n_splits, bk=bk)
    return merge_with_tree_block(q, blk_k, blk_v, acc, m, l,
                                 tree_mask=tree_mask,
                                 attn_softcap=attn_softcap, scale=scale_v)


# ------------------------------------------------------------- paged -------
def cascade_phase1_paged_plain(q, pool_k, pool_v, page_table, *, cache_len,
                               q_abs, window=None, attn_softcap=None,
                               scale=None, n_splits=8, pos_stride=None,
                               pos_offset=None):
    """Plain torch version of :func:`cascade_phase1_paged`
    (``_phase1_paged_kernel``): gathers the table's pages, then the same
    split partials over logical positions
    ``i*pos_stride + pos_offset + [0, page)`` of logical page ``i``."""
    b, hq, tq, d = q.shape
    n_phys, hkv, page = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    mp = page_table.shape[-1]
    ns, _, mp_pad = _paged_geometry(mp, n_splits)
    table = torch.as_tensor(page_table, device=dev).long().reshape(-1, mp)
    table = torch.nn.functional.pad(table, (0, mp_pad - mp), value=n_phys)
    table = table.clamp(0, n_phys - 1)
    stride = page if pos_stride is None else pos_stride
    off = 0 if pos_offset is None else int(pos_offset)

    def gather(pool):                                   # -> [B,Hkv,S,D]
        x = pool[table].float()                        # [B,MP,Hkv,page,D]
        return x.permute(0, 2, 1, 3, 4).reshape(b, hkv, mp_pad * page, d)

    ck, cv = gather(pool_k), gather(pool_v)
    clen = _int_rows(cache_len, b, None, dev).long()
    qa = _int_rows(q_abs, b, tq, dev)
    qf = (q.float() * scale).reshape(b, hkv, g, tq, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, ck)
    t = torch.arange(mp_pad * page, device=dev)
    kpos = ((t // page) * stride + off + t % page)[None, :]
    live = torch.ones_like(kpos, dtype=torch.bool)
    sc = _mask_scores(sc, kpos, live, clen, qa, window, attn_softcap)
    return _split_partials(sc, cv, ns)


def cascade_phase1_paged(q, pool_k, pool_v, page_table, *, cache_len, q_abs,
                         window=None, attn_softcap=None, scale=None,
                         n_splits=8, pos_stride=None, pos_offset=None):
    """Split-K flash partials over a PAGED cache (kernel #2).

    q [B,Hq,Tq,D]; pools [P,Hkv,page,D] (any strides with a contiguous
    last axis: the model passes a transposed view of its [P,page,Hkv,D]
    pool, never a copy); page_table [B,max_pages] physical page ids,
    out-of-range entries (PAGE_SENTINEL) unallocated. Each split loops
    only over its live pages, so dead pages move no bytes.
    """
    kw = dict(cache_len=cache_len, q_abs=q_abs, window=window,
              attn_softcap=attn_softcap, scale=scale, n_splits=n_splits,
              pos_stride=pos_stride, pos_offset=pos_offset)
    if q.device.type == "cpu" or trace.meta_plain("cascade_phase1_paged", q):
        return cascade_phase1_paged_plain(q, pool_k, pool_v, page_table, **kw)
    fn, sm90 = _entry("cascade_phase1_paged", q, pool_k, pool_v)
    b, hq, tq, d = q.shape
    n_phys, hkv, page = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    mp = page_table.shape[-1]
    ns, nk_inner, _ = _paged_geometry(mp, n_splits)
    qk, q_strides, scale_arg = _q_args(q, scale, sm90)
    table = torch.as_tensor(page_table, device=q.device).to(
        torch.int32).reshape(-1, mp).expand(b, mp).contiguous()
    clen = _int_rows(cache_len, b, None, q.device)
    qa = _int_rows(q_abs, b, tq, q.device)
    acc, m, l = _outputs(b, hq, ns, tq, d, q.device)
    rc = fn(qk.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            *q_strides, *pool_k.stride()[:3], *pool_v.stride()[:3],
            table.data_ptr(), clen.data_ptr(), qa.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, hq, hkv, tq, d, page, mp, n_phys,
            nk_inner, ns, page if pos_stride is None else int(pos_stride),
            0 if pos_offset is None else int(pos_offset),
            int(window) if window is not None else 0,
            float(attn_softcap) if attn_softcap is not None else 0.0,
            *scale_arg, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, fn)
    cascade_phase1_paged.launches += 1
    cascade_phase1_paged.sm90_launches += sm90
    cascade_phase1_paged.sharded_launches += pos_stride is not None
    return acc, m, l


cascade_phase1_paged.launches = 0
cascade_phase1_paged.sm90_launches = 0
cascade_phase1_paged.sharded_launches = 0


def cascade_attention_paged(q, pool_k, pool_v, page_table, blk_k, blk_v, *,
                            cache_len, q_abs, tree_mask, window=None,
                            attn_softcap=None, scale=None, n_splits=8,
                            pos_stride=None, pos_offset=None):
    """Paged cascade verify: page-table phase 1 + the shared phase 2."""
    scale_v = scale if scale is not None else q.shape[-1] ** -0.5
    acc, m, l = cascade_phase1_paged(
        q, pool_k, pool_v, page_table, cache_len=cache_len, q_abs=q_abs,
        window=window, attn_softcap=attn_softcap, scale=scale_v,
        n_splits=n_splits, pos_stride=pos_stride, pos_offset=pos_offset)
    return merge_with_tree_block(q, blk_k, blk_v, acc, m, l,
                                 tree_mask=tree_mask,
                                 attn_softcap=attn_softcap, scale=scale_v)


# ------------------------------------------------------------ helpers ------
def _entry(name, q, k, v):
    """(C function, is it the bf16 kernel) for the tensors' dtype, after
    the checks that kernel needs: bf16 q and cache go to
    ``csrc/cascade_phase1_sm90.cu``, fp32 to ``csrc/cascade_phase1.cu``
    (which takes any strides with a contiguous head dim). Raises before
    any launch on what neither takes."""
    if q.device.type != "cuda":
        raise RuntimeError(f"cascade kernels run on CUDA or CPU tensors, "
                           f"not {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("the cascade kernels take float32 or bfloat16 q, k "
                        f"and v of one dtype, not {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the cache's head-dim axis must be contiguous")
    if q.shape[-1] > 256:
        raise ValueError(f"head_dim {q.shape[-1]} > 256 is not supported")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("query heads must be a multiple of KV heads")
    from repro_torch.kernels import build
    if q.dtype == torch.float32:
        return getattr(build.load("cascade_phase1"), name), False
    # one pass over the three tensors: a stride of a size-1 axis is never
    # stepped, so only the others need to be multiples of 8
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if (q.stride(-1) != 1 or q.shape[-1] % 8
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16
            or any(s % 8 for s in strides) and any(
                s % 8 and n > 1 for n, s in zip(
                    (*q.shape[:3], *k.shape[:3], *v.shape[:3]), strides))):
        raise ValueError(
            "the bf16 cascade kernels load rows in 16-byte chunks: q, k "
            "and v need 16-byte-aligned bases, a contiguous head dim that "
            "is a multiple of 8 and strides that are multiples of 8, not "
            f"shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}, "
            f"strides {q.stride()} {k.stride()} {v.stride()}")
    return getattr(build.load("cascade_phase1_sm90"), name + "_sm90"), True


def _q_args(q, scale, sm90):
    """(q tensor, its strides, the scale) as the entry point takes them:
    the bf16 kernel reads q in place and scales the fp32 scores; the fp32
    kernel takes a pre-scaled contiguous copy, no strides
    and no scale. The caller holds the tensor until the launch."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if sm90:
        return q, q.stride()[:3], [float(scale)]
    return (q * scale).contiguous(), (), []


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def _outputs(b, hq, ns, tq, d, device):
    acc = torch.empty((b, hq, ns, tq, d), dtype=torch.float32, device=device)
    m = torch.empty((b, hq, ns, tq), dtype=torch.float32, device=device)
    l = torch.empty((b, hq, ns, tq), dtype=torch.float32, device=device)
    return acc, m, l

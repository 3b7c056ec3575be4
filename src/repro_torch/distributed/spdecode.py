"""KV-sequence-sharded decode attention (twin of
``repro/distributed/spdecode.py``).

At decode time the KV cache dominates memory and bandwidth, and GQA's
2-8 KV heads cannot fill a wide model axis, so the cache is sharded along
its SEQUENCE axis over the ``kv_seq`` mesh axis instead. Each rank
computes flash partials (acc, m, l) over its slice of the cache; the
partials merge across ranks by a log-sum-exp all-reduce, whose payload
is O(q tokens * head_dim) against the KV bytes that stay put. The
in-flight tree / block KV is replicated: every rank computes its part
alike and merges it locally.

SPMD form: every function here runs in each rank on that rank's tensors.
A rank holds its run of the batch's rows (every row when the batch axes
do not split them: ``sharding.batch_run``), which is JAX's ``bspec``
slice of its ``shard_map``: queries, blocks, lengths and page tables are
the run's, the same on every rank of the kv_seq axis; a dense cache
holds the run's rows and this rank's run of the slots
(``kvcache.dense_cache``), which it reads; a page pool holds this rank's
run of every page (``models/kvcache.py``), replicated over the batch
axes.
"""
from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import PayloadCounter
from repro_torch.models.attention import attend_chunked, merge_attn_stats


def kv_seq_axis() -> Optional[str]:
    """The mesh axis the KV cache sequence dim is sharded over, if any."""
    return sh.mesh_axis("kv_seq")


def kv_seq_shards() -> int:
    """Size of the kv_seq mesh axis (1 without a mesh / unsharded)."""
    axis = kv_seq_axis()
    return 1 if axis is None else sh.active_mesh().size(axis)


def kv_seq_index() -> int:
    """This rank's index along the kv_seq mesh axis (0 when unsharded)."""
    axis = kv_seq_axis()
    return 0 if axis is None else sh.active_mesh().index(axis)


#: bytes each rank sends into the LSE merges of
#: :func:`sharded_paged_cache_attend`, by JAX's formula (acc and l in the
#: merge dtype, m in float32), counted at every call over this rank's
#: rows (JAX's ``PAYLOAD_TRACE`` logs once per trace, which is once per
#: call of a jitted cycle that runs each read once, over the whole
#: batch: under a batch split a rank's count is its run's ``n / b`` of
#: it). ``timed``: each merge is timed on the host after a device
#: synchronize, into ``merge_s``.
PAYLOAD = PayloadCounter()


def _rows(x, b, n, device):
    """A scalar / [B] / [B, n] integer as a long [B] (n None) or [B, n]."""
    t = torch.as_tensor(x, device=device).long()
    if n is None:
        return t.reshape(-1).expand(b)
    return t.reshape(-1, n).expand(b, n)


def _block_mask(blk_mask, b, tq):
    if blk_mask is not None and blk_mask.ndim == 2:
        return blk_mask[None].expand(b, tq, blk_mask.shape[-1])
    return blk_mask


def _block_stats(q, bk, bv, bm, attn_softcap):
    """Flash partials of the replicated block (computed alike per rank)."""
    return attend_chunked(q, bk, bv, causal=False, q_offset=0,
                          extra_mask=bm, attn_softcap=attn_softcap,
                          kv_chunk=max(bk.shape[1], 8), return_stats=True)


def sharded_cache_attend(q, cache_k, cache_v, blk_k, blk_v, *, cache_len,
                         q_abs, window, attn_softcap, blk_mask, rolling,
                         kv_chunk: int = 1024, merge_dtype=torch.bfloat16):
    """Single-softmax attention over [sharded cache ++ replicated block].

    q: [B,Tq,Hq,Dh]; cache_k/v: [B,S/P,Hkv,Dh], this rank's run of a
    dense cache of S slots, slots ``[r*S/P, (r+1)*S/P)`` on rank r;
    blk_k/v: [B,Tblk,Hkv,Dh]; blk_mask [B,Tq,Tblk] or [Tq,Tblk];
    cache_len: [B] or scalar; q_abs: [B,Tq] or [Tq] absolute positions.

    merge_dtype: dtype of the cross-rank LSE-merge payload. The default is
    JAX's bfloat16, which the model's read hooks keep whatever the model's
    dtype (ROADMAP.md queue 3, reference quirks); pass float32 for exact
    merging.
    """
    mesh, axis = sh.active_mesh(), kv_seq_axis()
    assert mesh is not None and axis is not None
    b, tq = q.shape[:2]
    dev = q.device
    blk_mask = _block_mask(blk_mask, b, tq)
    clen = _rows(cache_len, b, None, dev)
    qa = _rows(q_abs, b, tq, dev)
    s_loc = cache_k.shape[1]
    cap = s_loc * mesh.size(axis)
    offset = mesh.index(axis) * s_loc
    # mask by absolute key position (rolling caches store position p at
    # slot p % cap, recovered against the local slot offset)
    acc, m, l = _cache_stats(q, cache_k, cache_v, offset=offset, cap=cap,
                             clen=clen,
                             qab=qa, window=window,
                             attn_softcap=attn_softcap, rolling=rolling,
                             kv_chunk=kv_chunk)
    acc_g, m_g, l_g = _axis_lse_merge(acc, m, l, mesh, axis, merge_dtype)
    parts = [(acc_g, m_g, l_g),
             _block_stats(q, blk_k, blk_v, blk_mask, attn_softcap)]
    return merge_attn_stats(parts, q.shape, q.dtype)


def _axis_lse_merge(acc, m, l, mesh, axis, merge_dtype):
    """LSE-merge flash partials across a mesh axis: a MAX all-reduce of m,
    then one SUM all-reduce of ``l*corr`` and ``acc*corr`` in
    ``merge_dtype`` (one buffer, l as the last column of acc). The
    partials are first normalized by the global max, so the payload can
    travel in bfloat16 without range loss (values in [0, l_local])."""
    if PAYLOAD.timed and acc.device.type == "cuda":
        torch.cuda.synchronize(acc.device)
    t0 = time.perf_counter()
    m_g = mesh.all_reduce_(m.clone(), dist.ReduceOp.MAX, axis)
    corr = torch.exp(m - m_g)
    pay = torch.cat([acc * corr[..., None], (l * corr)[..., None]], dim=-1)
    pay = mesh.all_reduce_(pay.to(merge_dtype), dist.ReduceOp.SUM,
                           axis).float()
    if PAYLOAD.timed:
        PAYLOAD.merge_s += time.perf_counter() - t0
    return pay[..., :-1], m_g, pay[..., -1]


def sharded_paged_cache_attend(q, pool_k, pool_v, table, blk_k, blk_v, *,
                               cache_len, q_abs, attn_softcap, blk_mask,
                               page_size: int, kv_chunk: int = 1024,
                               merge_dtype=torch.float32,
                               read_impl: str = "gather"):
    """Paged cascade-verify attention with the pool's page PAYLOADS
    sharded along the kv_seq axis: single softmax over [paged cache ++
    replicated block].

    Layout ("page identity is global, page bytes are per-rank"): rank r
    of P holds slots ``[r*page_loc, (r+1)*page_loc)`` of EVERY page,
    ``page_loc = page_size // P``; page tables are global page ids, so
    each rank resolves its local view with no cross-rank page traffic.
    The absolute position of local flat slot t is
    ``(t // page_loc)*page_size + r*page_loc + (t % page_loc)``.

    q: [B,Tq,Hq,Dh]; pool_k/v: this rank's pool [P_pages, page_loc, Hkv,
    Dh]; table: [B, MP] page ids (PAGE_SENTINEL tails masked by
    ``cache_len``); blk_k/v: [B,Tblk,Hkv,Dh]; cache_len [B]; q_abs [B,Tq]
    or [Tq]. Non-rolling, windowless reads only (the verify KV layers and
    the drafter feature caches).

    read_impl: "kernel" (JAX's "pallas") runs the paged cascade phase-1
    kernel (#2) on the local pool, placing logical page i at positions
    ``i*page_size + r*page_loc + [0, page_loc)`` through its
    pos_stride/pos_offset arguments; anything else gathers the local
    logical view (``pool_view``). Both feed the same float32 LSE merge.
    """
    from repro_torch.models import kvcache as kvc
    mesh, axis = sh.active_mesh(), kv_seq_axis()
    assert mesh is not None and axis is not None
    nsh = mesh.size(axis)
    assert page_size % nsh == 0, (page_size, nsh)
    page_loc = page_size // nsh
    assert pool_k.shape[-3] == page_loc, (
        "the pool must hold this rank's run of each page",
        tuple(pool_k.shape), page_loc)
    r = mesh.index(axis)
    b, tq, hq, dh = q.shape
    hkv = pool_k.shape[-2]
    mp = table.shape[-1]
    dev = q.device
    blk_mask = _block_mask(blk_mask, b, tq)
    clen = _rows(cache_len, b, None, dev)
    qa = _rows(q_abs, b, tq, dev)

    # per-rank collective payload: acc + l in merge_dtype, m in fp32
    md = torch.empty((), dtype=merge_dtype).element_size()
    PAYLOAD.calls += 1
    PAYLOAD.bytes += int(b * hkv * (hq // hkv) * tq * ((dh + 1) * md + 4))

    if read_impl == "kernel":
        from repro_torch.kernels import cascade_attention as casc
        acc, m, l = casc.cascade_phase1_paged(
            q.transpose(1, 2), pool_k.transpose(1, 2),
            pool_v.transpose(1, 2), table, cache_len=clen, q_abs=qa,
            window=None, attn_softcap=attn_softcap, pos_stride=page_size,
            pos_offset=r * page_loc)
        # local split merge, then [B,Hq,...] -> the attend_chunked stats
        # layout [B,Hkv,G,...] (head h = (h // g, h % g))
        m_l = m.amax(dim=2)
        cr = torch.exp(m - m_l[:, :, None])
        l_l = (l * cr).sum(dim=2)
        acc_l = (acc * cr[..., None]).sum(dim=2)
        g = hq // hkv
        acc = acc_l.reshape(b, hkv, g, tq, dh)
        m = m_l.reshape(b, hkv, g, tq)
        l = l_l.reshape(b, hkv, g, tq)
    else:
        # local logical view [B, MP*page_loc, Hkv, Dh]: every page's local
        # slot run, in page-table order
        vk = kvc.pool_view(pool_k, table)
        vv = kvc.pool_view(pool_v, table)
        t = torch.arange(mp * page_loc, device=dev)
        pos = ((t // page_loc) * page_size + r * page_loc
               + (t % page_loc))[None, None, :]
        acc, m, l = _cache_stats(q, vk, vv, offset=0, cap=mp * page_size,
                                 clen=clen, qab=qa, window=None,
                                 attn_softcap=attn_softcap, rolling=False,
                                 kv_chunk=kv_chunk, pos=pos)
    acc_g, m_g, l_g = _axis_lse_merge(acc, m, l, mesh, axis, merge_dtype)
    parts = [(acc_g, m_g, l_g),
             _block_stats(q, blk_k, blk_v, blk_mask, attn_softcap)]
    return merge_attn_stats(parts, q.shape, q.dtype)


def _cache_stats(q, k, v, *, offset, cap, clen, qab, window, attn_softcap,
                 rolling, kv_chunk, pos=None):
    """Flash partials over a local cache slice with absolute-position
    masks. ``pos``: precomputed absolute key positions [1,1,S_loc] (the
    paged layout's positions are not contiguous within a rank); default
    the contiguous ``offset + arange`` of a sequence-sliced dense cache."""
    s_loc = k.shape[1]
    if pos is None:
        jc = offset + torch.arange(s_loc, device=q.device)[None, None, :]
    else:
        jc = pos
    qpos = qab[:, :, None]
    cl = clen[:, None, None]
    if rolling:
        last = cl - 1
        abs_kpos = last - torch.remainder(last - jc, cap)
        ok = (abs_kpos >= 0) & (abs_kpos < cl) & (abs_kpos <= qpos)
        if window is not None:
            ok = ok & (abs_kpos > (qpos - window))
    else:
        ok = (jc < cl) & (jc <= qpos)
        if window is not None:
            ok = ok & (jc > (qpos - window))
    return attend_chunked(q, k, v, causal=False, q_offset=0, extra_mask=ok,
                          attn_softcap=attn_softcap,
                          kv_chunk=min(kv_chunk, s_loc), return_stats=True)

"""Flash attention forward and backward (twin of
``repro/kernels/flash_attention.py``).

CUDA kernels with GQA, causal masking at a scalar ``q_offset``, a sliding
window, a per-row ``kv_len`` and the attention-logit softcap, numbered as
in PERF.md's kernel table:

  #3 :func:`flash_attention_fwd`      ``_fwd_kernel``     -> (o, lse)
  #4 :func:`flash_attention_bwd_dq`   ``_bwd_dq_kernel``  -> dq
  #5 :func:`flash_attention_bwd_dkv`  ``_bwd_dkv_kernel`` -> (dk, dv), the
                                      GQA group summed inside the kernel

For bfloat16 all three run on the tensor cores (``wgmma`` on TMA-staged
tiles, ``csrc/flash_attention_sm90.cu``). For float32 all three run on
the tensor cores in 3xTF32 in ``csrc/flash_attention.cu`` (``mma.sync``
tf32, each product formed from three tf32 products, within 2^-21 of its
fp32 value, each key tile's products summed in fp32); so the fp32 path
keeps fp32 accuracy and the training identity.

and :func:`flash_attention_bwd`, which computes ``delta = sum(do * o)`` in
fp32 and composes the two backward kernels, as the JAX wrapper does.

Every kernel wrapper dispatches on the device of its query tensor: a CPU
tensor runs the plain torch version (``*_plain``: the running softmax
over 128-key blocks forward, ``p = exp(s - lse)`` and the explicit ``ds``
backward, the arithmetic the kernels do, and the oracle they are held to
on the card); a CUDA tensor launches the kernel for its dtype or raises.
There is no fallback. Each wrapper counts its launches in
``<wrapper>.launches`` and those of its tensor-core kernel again in
``<wrapper>.sm90_launches``. The tensor-core kernels read their
inputs by TMA, which takes 16-byte-aligned bases, head dims that are a
multiple of 8 and strides that are multiples of 8 elements; the wrappers
raise on anything else.

Layouts are the kernel layout of the JAX module: q [B,Hq,Tq,D], k/v
[B,Hkv,Tkv,D], with any strides whose head-dim axis is contiguous (the
model hands over transposed views of its [B,T,H,D] tensors); outputs
take the memory layout of the input they belong to. Masked keys give
``p = 0`` exactly, so a row with no live key has o = 0 and l = 0, where
the Pallas forward counts masked keys into l; rows with a live key agree.
No row is padded (the Pallas wrapper pads T to 128-multiples and so needs
``lse = 1.0`` on padded rows; nothing here does).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
BLOCK = 128          # keys per block of the plain versions (the Pallas bk)


def _kv_len_rows(kv_len, b, tkv, device):
    """kv_len (None, scalar or [B]) as a contiguous int32 [B]."""
    if kv_len is None:
        return torch.full((b,), tkv, dtype=torch.int32, device=device)
    t = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return t.reshape(-1).expand(b).contiguous()


def _live(tq, lo, hi, kvl, causal, q_offset, window, device):
    """[B, Tq, hi-lo] mask of the live keys lo..hi-1 (``_mask_block``)."""
    qpos = torch.arange(tq, device=device)[:, None] + q_offset
    kpos = torch.arange(lo, hi, device=device)[None, :]
    ok = (kpos < kvl.long()[:, None, None])
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _scores(qf, kb, attn_softcap):
    """Scaled scores [B,Hkv,g,Tq,bk] and the softcap derivative (or None)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
    if attn_softcap is None:
        return s, None
    t = torch.tanh(s / attn_softcap)
    return attn_softcap * t, 1.0 - t * t


# --------------------------------------------------------------- forward ---
def flash_attention_fwd_plain(q, k, v, *, causal=True, q_offset=0,
                              window=None, kv_len=None, attn_softcap=None,
                              scale=None):
    """Plain torch version of :func:`flash_attention_fwd`."""
    b, hq, tq, d = q.shape
    hkv, tkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    kvl = _kv_len_rows(kv_len, b, tkv, dev)
    qf = (q.float() * scale).reshape(b, hkv, g, tq, d)
    m = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, tq, d), dtype=torch.float32, device=dev)
    for lo in range(0, tkv, BLOCK):
        hi = min(lo + BLOCK, tkv)
        s, _ = _scores(qf, k[:, :, lo:hi].float(), attn_softcap)
        live = _live(tq, lo, hi, kvl, causal, int(q_offset), window, dev)
        s = s.masked_fill(~live[:, None, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])           # masked: exactly 0
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v[:, :, lo:hi].float())
        m = m_new
    ls = l.clamp_min(1e-30)
    o = (acc / ls[..., None]).reshape(b, hq, tq, d).to(q.dtype)
    return o, (m + torch.log(ls)).reshape(b, hq, tq)


def flash_attention_fwd(q, k, v, *, causal=True, q_offset=0, window=None,
                        kv_len=None, attn_softcap=None, scale=None):
    """Flash forward (kernel #3). q [B,Hq,Tq,D]; k,v [B,Hkv,Tkv,D] float32
    or bfloat16, one dtype -> (o [B,Hq,Tq,D] in q's dtype, lse [B,Hq,Tq]
    fp32). ``q_offset`` is a scalar; ``kv_len`` None, a scalar or [B]."""
    kw = dict(causal=causal, q_offset=q_offset, window=window, kv_len=kv_len,
              attn_softcap=attn_softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    _check_cuda(q, k, v)
    b, hq, tq, d = q.shape
    o = torch.empty_like(q)                   # q's memory layout
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    fn, sm90 = _entry("flash_fwd", q, k, v)
    head, kvl, tail = _common(q, k, v, None, kw)
    rc = fn(*head, kvl.data_ptr(), o.data_ptr(), *o.stride()[:3],
            lse.data_ptr(), *tail)
    _raise_on(rc, fn.__name__)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.sm90_launches += sm90
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.sm90_launches = 0


# -------------------------------------------------------------- backward ---
def _bwd_blocks(q, k, v, do, lse, delta, causal, q_offset, window, kv_len,
                attn_softcap, scale):
    """Per 128-key block (lo, hi, p, ds), each [B,Hkv,g,Tq,bk], and the
    scaled queries and do reshaped [B,Hkv,g,Tq,D]."""
    b, hq, tq, d = q.shape
    hkv, tkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    kvl = _kv_len_rows(kv_len, b, tkv, dev)
    qf = (q.float() * scale).reshape(b, hkv, g, tq, d)
    dof = do.float().reshape(b, hkv, g, tq, d)
    lse = lse.float().reshape(b, hkv, g, tq, 1)
    delta = delta.float().reshape(b, hkv, g, tq, 1)

    def blocks():
        for lo in range(0, tkv, BLOCK):
            hi = min(lo + BLOCK, tkv)
            s, dcap = _scores(qf, k[:, :, lo:hi].float(), attn_softcap)
            live = _live(tq, lo, hi, kvl, causal, int(q_offset), window, dev)
            p = torch.where(live[:, None, None], torch.exp(s - lse),
                            s.new_zeros(()))
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dof,
                              v[:, :, lo:hi].float())
            ds = p * (dp - delta)
            if dcap is not None:
                ds = ds * dcap
            yield lo, hi, p, ds

    return qf, dof, blocks()


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True,
                                 q_offset=0, window=None, kv_len=None,
                                 attn_softcap=None, scale=None):
    """Plain torch version of :func:`flash_attention_bwd_dq`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qf, _, blocks = _bwd_blocks(q, k, v, do, lse, delta, causal, q_offset,
                                window, kv_len, attn_softcap, scale)
    dq = torch.zeros_like(qf)
    for lo, hi, _, ds in blocks:
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, k[:, :, lo:hi].float())
    return (dq * scale).reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True,
                                  q_offset=0, window=None, kv_len=None,
                                  attn_softcap=None, scale=None):
    """Plain torch version of :func:`flash_attention_bwd_dkv`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qf, dof, blocks = _bwd_blocks(q, k, v, do, lse, delta, causal, q_offset,
                                  window, kv_len, attn_softcap, scale)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for lo, hi, p, ds in blocks:
        dk[:, :, lo:hi] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
        dv[:, :, lo:hi] = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           q_offset=0, window=None, kv_len=None,
                           attn_softcap=None, scale=None):
    """dq of the flash backward (kernel #4), in q's dtype. ``lse`` from the
    forward and ``delta = sum(do * o, -1)``, both [B,Hq,Tq] fp32."""
    kw = dict(causal=causal, q_offset=q_offset, window=window, kv_len=kv_len,
              attn_softcap=attn_softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    _check_cuda(q, k, v, do)
    dq = torch.empty_like(q)
    fn, sm90 = _entry("flash_bwd_dq", q, k, v, do)
    head, kvl, tail = _common(q, k, v, do, kw)
    lse, delta = _rows(lse, q), _rows(delta, q)
    rc = fn(*head, lse.data_ptr(), delta.data_ptr(), kvl.data_ptr(),
            dq.data_ptr(), *dq.stride()[:3], *tail)
    _raise_on(rc, fn.__name__)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.sm90_launches += sm90
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.sm90_launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            q_offset=0, window=None, kv_len=None,
                            attn_softcap=None, scale=None):
    """(dk, dv) of the flash backward (kernel #5), summed over each KV
    head's group of query heads, in k's dtype."""
    kw = dict(causal=causal, q_offset=q_offset, window=window, kv_len=kv_len,
              attn_softcap=attn_softcap, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    _check_cuda(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn, sm90 = _entry("flash_bwd_dkv", q, k, v, do)
    head, kvl, tail = _common(q, k, v, do, kw)
    lse, delta = _rows(lse, q), _rows(delta, q)
    rc = fn(*head, lse.data_ptr(), delta.data_ptr(), kvl.data_ptr(),
            dk.data_ptr(), *dk.stride()[:3], dv.data_ptr(), *dv.stride()[:3],
            *tail)
    _raise_on(rc, fn.__name__)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.sm90_launches += sm90
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.sm90_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, q_offset=0,
                        window=None, kv_len=None, attn_softcap=None,
                        scale=None):
    """(dq, dk, dv): ``delta`` in fp32, then the dq and dk/dv kernels."""
    kw = dict(causal=causal, q_offset=q_offset, window=window, kv_len=kv_len,
              attn_softcap=attn_softcap, scale=scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ------------------------------------------------------------- helpers -----
def _check_cuda(q, k, v, do=None):
    if q.device.type != "cuda":
        raise RuntimeError(f"flash kernels run on CUDA or CPU tensors, "
                           f"not {q.device}")
    ts = (q, k, v) if do is None else (q, k, v, do)
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v (and do) must be on one device")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("the flash kernels take float32 or bfloat16 q/k/v/do "
                        f"of one dtype, not {[t.dtype for t in ts]}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("the head-dim axis of q/k/v/do must be contiguous")
    if q.shape[-1] > 128:
        raise ValueError(f"head_dim {q.shape[-1]} > 128 is not supported")
    if q.shape[1] % k.shape[1] != 0 or k.shape != v.shape:
        raise ValueError("query heads must be a multiple of KV heads and k, "
                         "v of one shape")
    if do is not None and do.shape != q.shape:
        raise ValueError("do must have q's shape")


def _rows(x, q):
    """lse / delta as contiguous fp32 [B,Hq,Tq]."""
    return x.to(torch.float32).reshape(q.shape[:3]).contiguous()


def _entry(name, *ts):
    """(C function, is it the tensor-core kernel) for ``name`` at the
    tensors' dtype: bf16 goes to ``csrc/flash_attention_sm90.cu`` (after
    the checks its TMA loads need), fp32 to ``csrc/flash_attention.cu``."""
    from repro_torch.kernels import build
    if ts[0].dtype != torch.bfloat16:
        return getattr(build.load("flash_attention"), name), False
    for t in ts:
        bad = [s for n, s in zip(t.shape[:3], t.stride()[:3])
               if n > 1 and s % 8]
        if t.data_ptr() % 16 or t.shape[-1] % 8 or bad:
            raise ValueError(
                "the bf16 flash kernels load by TMA: each of q/k/v/do needs "
                "a 16-byte-aligned base, a head dim that is a multiple of 8 "
                f"and strides that are multiples of 8, not shape "
                f"{tuple(t.shape)} stride {t.stride()} at {t.data_ptr():#x}")
    return getattr(build.load("flash_attention_sm90"), name + "_sm90"), True


def _common(q, k, v, do, kw):
    """What the C functions share: the input pointers then their strides,
    ``kv_len`` as int32 [B] (the caller keeps the tensor alive through the
    launch), and the dims, flags and stream."""
    b, hq, tq, d = q.shape
    hkv, tkv = k.shape[1], k.shape[2]
    scale = kw["scale"] if kw["scale"] is not None else d ** -0.5
    kvl = _kv_len_rows(kw["kv_len"], b, tkv, q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    if do is not None:
        ptrs.append(do.data_ptr())
        strides += do.stride()[:3]
    window, cap = kw["window"], kw["attn_softcap"]
    tail = [b, hq, hkv, tq, tkv, d, int(bool(kw["causal"])),
            int(kw["q_offset"]), int(window) if window is not None else 0,
            float(cap) if cap is not None else 0.0, float(scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream]
    return ptrs + strides, kvl, tail


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

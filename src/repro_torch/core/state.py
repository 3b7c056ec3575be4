"""Typed decode-engine state (twin of ``repro/core/state.py``).

:class:`EngineState` carries the target states (per-layer KV caches +
committed ``length``), the two drafter feature caches, the anchor token
of the next block and the per-row ``active`` mask. Cache buffers are
updated in place by prefill and by each cycle's commit; the small leaves
(lengths, anchor) are replaced.

KV storage is ``dense`` (per-row buffers) or ``paged`` (page pools plus
one page table ``pt`` [B, max_pages], a single tensor that every paged
cache of the wave reads). Slot refill for the serving engine:

* paged installs are copy-free: :func:`rows_template` builds a batch-K
  state that holds the wave's pool tensors themselves with K table rows
  of freshly allocated pages, :func:`prefill` writes the prompts' KV
  straight into those pages, and :meth:`EngineState.adopt_row` then
  patches the wave's table rows and splices the small dense leaves, all
  in place;
* dense installs prefill a fresh batch-K state and copy its rows into the
  wave's buffers in place.

Every install writes only its own rows and freshly allocated pages, and
never rebinds a pool or page-table tensor of the wave, so installs for
idle slots may be enqueued on the stream behind a decode cycle of the
other rows. Pool ownership is external (the borrowed-pool contract):
:func:`capture_pools` harvests the pool tensors at wave turnover and
:func:`engine_init` (``pools=``) adopts them into the next wave, so pages
the radix prefix cache retained keep their KV across waves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import drafter as dr
from repro_torch.models import kvcache as kvc
from repro_torch.models import lm
from repro_torch.models import param as pm

# the anchor's width in the accounting of :func:`refill_copy_bytes`: the
# JAX layout's int32 (the port holds it as int64 for indexing)
_ANCHOR_BYTES = 4


@dataclasses.dataclass(frozen=True)
class EngineState:
    target: Dict[str, Any]
    d1_feat: Dict[str, Any]
    d2_feat: Dict[str, Any]
    anchor: torch.Tensor          # [B] long
    active: torch.Tensor          # [B] bool

    @property
    def batch(self) -> int:
        return self.anchor.shape[0]

    @property
    def length(self) -> torch.Tensor:
        """[B] number of committed target positions."""
        return self.target["length"]

    @property
    def cache_impl(self) -> str:
        """"dense" | "paged" (the feature caches are paged exactly when
        the wave is)."""
        return "paged" if kvc.is_paged(self.d1_feat) else "dense"

    @property
    def max_len(self) -> int:
        """Logical cache capacity (max_pages * page_size when paged)."""
        if kvc.is_paged(self.d1_feat):
            return kvc.logical_len(self.d1_feat)
        return self.d1_feat["k"].shape[2]

    @property
    def page_size(self) -> int:
        return kvc.page_geometry(self.d1_feat)[0]

    @property
    def max_pages(self) -> int:
        return kvc.page_geometry(self.d1_feat)[1]

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)

    def adopt_row(self, row: int, other: "EngineState",
                  src_row: int = 0) -> "EngineState":
        """Splice ``other``'s ``src_row`` into this state's ``row``, in
        place; returns this state.

        Paged caches follow the shared-pool contract: ``other`` holds this
        state's pool tensors themselves (built by :func:`rows_template`),
        so its prefill already wrote the pages and only the page-table row
        is patched. No tensor of this state is rebound."""
        seen = set()
        for dst, src in zip(self.target["layers"], other.target["layers"]):
            _adopt_block_(dst, src, row, src_row, 0, seen)
        _splice_(self.target["length"], other.target["length"], row,
                 src_row, 0)
        for dst, src in ((self.d1_feat, other.d1_feat),
                         (self.d2_feat, other.d2_feat)):
            _adopt_block_(dst, src, row, src_row, 1, seen)
        _splice_(self.anchor, other.anchor, row, src_row, 0)
        _splice_(self.active, other.active, row, src_row, 0)
        return self


def _splice_(dst, src, row, src_row, axis):
    """dst[.., row, ..] = src[.., src_row, ..] along ``axis``, in place."""
    dst.select(axis, int(row)).copy_(src.select(axis, int(src_row)))


def _adopt_block_(dst, src, row, src_row, axis, seen):
    """Adopt one cache dict: paged pools must be the same tensors (the
    prefill wrote them), the page table splices along its batch axis
    (once per distinct table tensor: ``seen``), dense leaves along
    ``axis`` ("length" along 0)."""
    paged = kvc.is_paged(dst)
    for name, v in dst.items():
        if paged and name in ("k", "v"):
            assert src[name] is v, \
                "paged install must write the wave's own pools"
        elif name == "pt":
            if id(v) not in seen:
                seen.add(id(v))
                _splice_(v, src[name], row, src_row, 0)
        else:
            _splice_(v, src[name], row, src_row,
                     0 if name == "length" else axis)


def engine_init(bundle, batch: int, max_len: int, ctx_len: int = 0,
                cache_impl: str = "dense", page_size: int = 64,
                pool_pages=None, page_table=None, device="cuda",
                pools: Optional[Dict[str, Any]] = None) -> EngineState:
    """Allocate the caches of a request wave. Under ``cache_impl="paged"``
    every paged cache (target global KV and both feature caches) shares
    one page-id space and one page-table tensor (default: the identity
    layout). ``ctx_len``: the length of the cross blocks' context caches
    (``lm.init_states``), which :func:`prefill` with ``ctx`` fills.

    pools: pool tensors retained from the previous wave
    (:func:`capture_pools`), adopted as they are instead of allocating
    zeroed pools; their geometry must match this allocation."""
    dev = resolve_device(device)
    tcfg = bundle.target_cfg
    if cache_impl == "paged":
        pool_pages, page_table = kvc.default_page_layout(
            batch, max_len, page_size, pool_pages, page_table, dev)
        page_table = _to_device(page_table, dev, torch.int32)
    else:
        assert not pools, "retained pool buffers require cache_impl='paged'"
    pools = pools or {}
    kw = dict(cache_impl=cache_impl, page_size=page_size,
              pool_pages=pool_pages, page_table=page_table)
    tgt_pools = {int(name[len("target/"):]): kv
                 for name, kv in pools.items() if name.startswith("target/")}
    return EngineState(
        target=lm.init_states(tcfg, batch, max_len, ctx_len=ctx_len,
                              dtype=getattr(torch, tcfg.dtype), device=dev,
                              ext_pools=tgt_pools, **kw),
        d1_feat=dr.init_feat_cache(bundle.d1_cfg, batch, max_len,
                                   getattr(torch, bundle.d1_cfg.dtype), dev,
                                   ext_pool=pools.get("d1_feat"), **kw),
        d2_feat=dr.init_feat_cache(bundle.d2_cfg, batch, max_len,
                                   getattr(torch, bundle.d2_cfg.dtype), dev,
                                   ext_pool=pools.get("d2_feat"), **kw),
        anchor=torch.zeros((batch,), dtype=torch.long, device=dev),
        active=torch.ones((batch,), dtype=torch.bool, device=dev),
    )


def prefill(bundle, state: EngineState, prompts, gen=None, ctx=None,
            temperature: float = 0.0, true_len=None,
            start=None) -> EngineState:
    """Process prompts [B, P]; anchor = the first generated token: the
    argmax, or at ``temperature`` > 0 a draw from ``gen`` (a generator on
    the prompts' device).

    ctx ([B, T_ctx, d]): the cross blocks' context (image embeddings, or
    the encoder's output); the pass writes it into the cross caches,
    which the state must size to ``T_ctx`` (``engine_init(ctx_len=)``),
    and every later cycle reads them.

    true_len ([B] or scalar): ``prompts`` is padded to a bucket and only
    the first ``true_len`` tokens of each row are real: KV and feature
    writes past them are dropped, ``length`` advances by ``true_len`` and
    the anchor reads the logits at ``true_len - 1``.

    start ([B] or scalar): warm start. The caches already hold ``start``
    committed positions (a prefix-cache hit spliced shared pages into the
    row), ``prompts`` is only the uncached suffix, and the forward attends
    [cache ++ suffix] (the gather view of the cache) at positions offset
    by ``start``. The state's lengths must already be ``start``.
    """
    b, p = prompts.shape
    dev = prompts.device
    warm = start is not None
    if warm:
        cl = torch.as_tensor(start, device=dev).to(torch.int32).reshape(
            -1).expand(b)
    else:
        cl = torch.zeros((), dtype=torch.int32, device=dev)
    snap = None
    if true_len is not None:
        snap = torch.as_tensor(true_len, device=dev).to(torch.int32).reshape(
            -1).expand(b)
    out = lm.forward(bundle.target_params, prompts, bundle.target_cfg,
                     states=state.target, cache_len=cl, write_kv=True,
                     snap_at=snap, attend_cache_on_write=warm, ctx=ctx,
                     want_features=True)
    base = cl[:, None] if warm else torch.zeros((b, 1), dtype=torch.int32,
                                                device=dev)
    positions = base + torch.arange(p, dtype=torch.int32, device=dev)[None]
    counts = (snap if snap is not None
              else torch.full((b,), p, dtype=torch.int32, device=dev))
    d1_feat = dr.extend_feat_cache(bundle.d1_params, bundle.d1_cfg,
                                   state.d1_feat, out["features"], positions,
                                   counts)
    d2_feat = dr.extend_feat_cache(bundle.d2_params, bundle.d2_cfg,
                                   state.d2_feat, out["features"], positions,
                                   counts)
    if snap is None:
        last = out["logits"][:, -1].float()
    else:
        at = (snap.long() - 1).clamp(min=0)
        last = out["logits"][torch.arange(b, device=dev), at].float()
    if temperature > 0:
        anchor = pm.categorical(gen, last / temperature)
    else:
        anchor = torch.argmax(last, dim=-1)
    return state.replace(target=out["states"], d1_feat=d1_feat,
                         d2_feat=d2_feat, anchor=anchor)


# ------------------------------------------------------- slot install -------
def _to_device(x, dev, dtype):
    """Host data (numpy or list) as a tensor of its own on ``dev`` (never a
    view of the caller's array, which a later in-place write would
    reach). On a card the copy goes through pinned memory without
    blocking, so an install enqueued behind a decode cycle does not wait
    for it on the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    t = torch.tensor(np.asarray(x), dtype=dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _zeros_rows(a, axis, k):
    shape = list(a.shape)
    shape[axis] = k
    return torch.zeros(shape, dtype=a.dtype, device=a.device)


def rows_template(state: EngineState, row_tables) -> EngineState:
    """Batch-K install target holding this wave's page pools.

    ``row_tables`` [K, max_pages]: one row of physical pages per incoming
    request (unallocated slots :data:`kvc.PAGE_SENTINEL`), one tensor that
    every paged cache of the template reads. Dense leaves (local rolling
    KV, lengths, anchor) are zeroed batch-K rows; the paged pools are the
    wave's tensors themselves, so a :func:`prefill` on the result writes
    every request's KV into the wave's pools at its own pages."""
    dev = state.anchor.device
    rt = _to_device(row_tables, dev, torch.int32)
    k = rt.shape[0]

    def blk(d, axis):
        out = {}
        for name, v in d.items():
            if kvc.is_paged(d) and name in ("k", "v"):
                out[name] = v
            elif name == "pt":
                out[name] = rt
            else:
                out[name] = _zeros_rows(v, 0 if name == "length" else axis,
                                        k)
        return out

    return EngineState(
        target={"layers": [blk(d, 0) for d in state.target["layers"]],
                "length": _zeros_rows(state.target["length"], 0, k)},
        d1_feat=blk(state.d1_feat, 1),
        d2_feat=blk(state.d2_feat, 1),
        anchor=torch.zeros((k,), dtype=torch.long, device=dev),
        active=torch.ones((k,), dtype=torch.bool, device=dev))


def _with_lengths(sub: EngineState, length) -> EngineState:
    """``sub`` with every committed-length leaf set to ``length`` ([K]: a
    warm install's spliced shared pages already hold that many
    positions)."""
    lk = length.to(torch.int32).reshape(-1).expand(sub.batch).clone()
    return sub.replace(target={**sub.target, "length": lk},
                       d1_feat={**sub.d1_feat, "length": lk},
                       d2_feat={**sub.d2_feat, "length": lk})


def _paged_dicts(state: EngineState):
    """(name, cache dict) of every paged cache, named as
    :func:`capture_pools` names them."""
    for i, d in enumerate(state.target["layers"]):
        if kvc.is_paged(d):
            yield f"target/{i}", d
    for name in ("d1_feat", "d2_feat"):
        d = getattr(state, name)
        if kvc.is_paged(d):
            yield name, d


# ------------------------------------------------- borrowed-pool contract ---
def capture_pools(state: EngineState) -> Dict[str, Any]:
    """The k/v page-pool tensors of every paged cache, by name
    ("target/<layer>", "d1_feat", "d2_feat"): batch-free, so an
    engine-lifetime :class:`~repro_torch.models.kvcache.PagePool` carries
    them across waves (``engine_init(pools=)``) and every page the radix
    prefix cache owns keeps its KV."""
    return {name: (d["k"], d["v"]) for name, d in _paged_dicts(state)}


def cow_copy_page(state: EngineState, src: int, dst: int) -> EngineState:
    """Copy physical page ``src`` to ``dst`` in every paged pool of the
    wave (target global KV and both feature caches), in place: the
    copy-on-write step of a prefix-cache hit whose match ends inside a
    page. Returns ``state``."""
    assert state.cache_impl == "paged", "COW only exists for paged caches"
    for _, d in _paged_dicts(state):
        kvc.copy_page_(d["k"], src, dst)
        kvc.copy_page_(d["v"], src, dst)
    return state


def install_rows(bundle, state: EngineState, rows, prompts, gen=None,
                 temperature: float = 0.0, row_tables=None, true_len=None,
                 prefix_hits=None) -> EngineState:
    """Prefill K prompts into rows ``rows`` of the wave, in place (one
    batch-K prefill and K row splices). Returns ``state``.

    rows:        K slot indices.
    prompts:     [K, P], all padded to one bucket length.
    row_tables:  [K, max_pages] allocated pages per request (paged only).
    true_len:    [K] real prompt lengths under bucket padding.
    prefix_hits: [K] warm-start lengths (paged only): row i's table
        already holds ``prefix_hits[i]`` committed tokens of shared
        prefix-cache pages, so ``prompts[i]`` is only its uncached suffix.
        Every COW copy must be done before this call.

    At temperature > 0 the K anchors come from one draw of ``gen``; the
    engine routes only greedy installs here.
    """
    dev = state.anchor.device
    prompts = _to_device(prompts, dev, torch.long)
    k = prompts.shape[0]
    if state.cache_impl == "paged":
        assert row_tables is not None, "paged install needs allocated pages"
        sub = rows_template(state, row_tables)
    else:
        assert prefix_hits is None, "prefix-cache hits require paged KV"
        sub = engine_init(bundle, k, state.max_len, device=dev)
    if true_len is not None:
        true_len = _to_device(true_len, dev, torch.int32)
    if prefix_hits is not None:
        prefix_hits = _to_device(prefix_hits, dev, torch.int32)
        sub = _with_lengths(sub, prefix_hits)
    sub = prefill(bundle, sub, prompts, gen, temperature=temperature,
                  true_len=true_len, start=prefix_hits)
    for i, row in enumerate(rows):
        state.adopt_row(int(row), sub, src_row=i)
    return state


# ------------------------------------------------------- install accounting -
def _row_nbytes(a, axis) -> int:
    if a.ndim == 0 or axis >= a.ndim:
        return 0
    return a.numel() * a.element_size() // a.shape[axis]


def refill_copy_bytes(state: EngineState, n_tokens: int) -> int:
    """Bytes one slot install writes into the wave state (the accounting
    model of ``repro.core.state.refill_copy_bytes``, with its counting
    rules).

    Dense: a full row of every cache, ``max_len`` positions of target KV
    and drafter features whatever the prompt's length. Paged: only the
    ``n_tokens`` prompt positions land in the pools, plus one page-table
    row per paged cache and the small dense leaves (window-capped local
    KV, lengths, anchor, active)."""
    def block_bytes(d, axis) -> int:
        total = 0
        paged = kvc.is_paged(d)
        for name, v in d.items():
            if paged and name in ("k", "v"):
                lead = int(np.prod(v.shape[:-4], dtype=np.int64))
                h, dh = v.shape[-2], v.shape[-1]
                total += int(n_tokens) * lead * h * dh * v.element_size()
            elif name == "pt":
                total += _row_nbytes(v, 0)
            else:
                total += _row_nbytes(v, 0 if name == "length" else axis)
        return total

    total = sum(block_bytes(d, 0) for d in state.target["layers"])
    total += _row_nbytes(state.target["length"], 0)
    total += block_bytes(state.d1_feat, 1) + block_bytes(state.d2_feat, 1)
    return total + _ANCHOR_BYTES + _row_nbytes(state.active, 0)

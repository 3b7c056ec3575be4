"""Typed decode-engine state (twin of ``repro/core/state.py``).

:class:`EngineState` carries the target states (per-layer KV caches +
committed ``length``), the two drafter feature caches, the anchor token
of the next block and the per-row ``active`` mask. Cache buffers are
updated in place by prefill and by each cycle's commit; the small leaves
(lengths, anchor) are replaced.

The serving install/refill plumbing of the JAX module (``install_row``,
``row_template``, ``capture_pools``, ...) is slice 2 of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.core import drafter as dr
from repro_torch.models import kvcache as kvc
from repro_torch.models import lm
from repro_torch.models import param as pm


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

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


def engine_init(bundle, batch: int, max_len: int, cache_impl: str = "dense",
                page_size: int = 64, pool_pages=None, page_table=None,
                device="cuda") -> EngineState:
    """Allocate the caches of a request wave. Under ``cache_impl="paged"``
    every paged cache (target global KV and both feature caches) shares
    one page-id space and one page table (default: the identity layout)."""
    dev = resolve_device(device)
    tcfg = bundle.target_cfg
    if cache_impl == "paged":
        pool_pages, page_table = kvc.default_page_layout(
            batch, max_len, page_size, pool_pages, page_table, dev)
        page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                     device=dev)
    kw = dict(cache_impl=cache_impl, page_size=page_size,
              pool_pages=pool_pages, page_table=page_table)
    return EngineState(
        target=lm.init_states(tcfg, batch, max_len,
                              dtype=getattr(torch, tcfg.dtype), device=dev,
                              **kw),
        d1_feat=dr.init_feat_cache(bundle.d1_cfg, batch, max_len,
                                   getattr(torch, bundle.d1_cfg.dtype), dev,
                                   **kw),
        d2_feat=dr.init_feat_cache(bundle.d2_cfg, batch, max_len,
                                   getattr(torch, bundle.d2_cfg.dtype), dev,
                                   **kw),
        anchor=torch.zeros((batch,), dtype=torch.long, device=dev),
        active=torch.ones((batch,), dtype=torch.bool, device=dev),
    )


def prefill(bundle, state: EngineState, prompts, gen=None,
            temperature: float = 0.0) -> EngineState:
    """Process prompts [B, P] from an empty cache; anchor = the first
    generated token: the argmax, or at ``temperature`` > 0 a draw from
    ``gen`` (a generator on the prompts' device)."""
    b, p = prompts.shape
    dev = prompts.device
    out = lm.forward(bundle.target_params, prompts, bundle.target_cfg,
                     states=state.target,
                     cache_len=torch.zeros((), dtype=torch.int32, device=dev),
                     write_kv=True, want_features=True)
    positions = torch.arange(p, device=dev)[None, :].expand(b, p)
    counts = torch.full((b,), p, dtype=torch.int32, device=dev)
    d1_feat = dr.extend_feat_cache(bundle.d1_params, bundle.d1_cfg,
                                   state.d1_feat, out["features"], positions,
                                   counts)
    d2_feat = dr.extend_feat_cache(bundle.d2_params, bundle.d2_cfg,
                                   state.d2_feat, out["features"], positions,
                                   counts)
    last = out["logits"][:, -1].float()
    if temperature > 0:
        anchor = pm.categorical(gen, last / temperature)
    else:
        anchor = torch.argmax(last, dim=-1)
    return state.replace(target=out["states"], d1_feat=d1_feat,
                         d2_feat=d2_feat, anchor=anchor)

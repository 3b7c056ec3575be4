"""D2SD decode engine: one decode cycle and the host generation loop (twin
of ``repro/core/pipeline.py``).

A cycle runs the draft strategy (DFlash trunk, boundary posterior, top-K
forks, batched VP second draft, comb tree), the tree-attention verify
over the target (the cascade read path), the KV commit of the accepted
path and the feature-cache extension of both drafters.

``generate_ondevice`` (the JAX ``lax.while_loop`` loop; a CUDA graph
here) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig, SpecConfig
from repro_torch.core import drafter as dr
from repro_torch.core import strategies as strat_lib
from repro_torch.core import verify as verify_lib
from repro_torch.core.state import EngineState, engine_init, prefill


@dataclasses.dataclass(frozen=True)
class SpecBundle:
    target_cfg: ModelConfig
    d1_cfg: dr.DrafterConfig
    d2_cfg: dr.DrafterConfig
    spec: SpecConfig
    target_params: Any
    d1_params: Any
    d2_params: Any


def with_attn_impl(bundle: SpecBundle, impl: str) -> SpecBundle:
    """Bundle with the KV/feature-cache read path set to ``impl``
    ("gather" | "kernel") on the target and both drafters."""
    return dataclasses.replace(
        bundle,
        target_cfg=dataclasses.replace(bundle.target_cfg, attn_impl=impl),
        d1_cfg=dataclasses.replace(bundle.d1_cfg, attn_impl=impl),
        d2_cfg=dataclasses.replace(bundle.d2_cfg, attn_impl=impl))


# -------------------------------------------------------------- the cycle --
def decode_cycle(bundle: SpecBundle, state: EngineState):
    """One full speculative decoding cycle (greedy).

    Rows with ``state.active == False`` draft a root-only tree, commit
    nothing and keep their anchor. Returns (state', out) with out =
    dict(tokens [B, D+1], n_out [B]): row b's first n_out[b] tokens are
    its accepted draft tokens then the bonus token.
    """
    strategy = strat_lib.get_strategy(bundle.spec.mode)
    backend = verify_lib.select_backend(bundle.target_cfg)
    active = state.active

    tree = strat_lib.mask_inactive(strategy.draft(bundle, state), active)
    vo = backend.verify(bundle, state, tree)
    res = vo.res
    zero = torch.zeros_like(res["n_acc"])

    # ---------------- feature-cache extension ----------------
    n_acc = torch.where(active, res["n_acc"], zero)
    n_commit = torch.where(active, res["n_acc"] + 1, zero)
    p = res["path"].shape[1]
    fpos = state.length.long()[:, None] + torch.arange(
        p, device=n_acc.device)[None, :]
    state2 = state.replace(
        target=vo.target,
        d1_feat=dr.extend_feat_cache(bundle.d1_params, bundle.d1_cfg,
                                     state.d1_feat, vo.path_feats, fpos,
                                     n_commit),
        d2_feat=dr.extend_feat_cache(bundle.d2_params, bundle.d2_cfg,
                                     state.d2_feat, vo.path_feats, fpos,
                                     n_commit),
        anchor=torch.where(active, res["bonus"], state.anchor))

    # ---------------- outputs ----------------
    path_tokens = torch.gather(tree.tokens, 1, res["path"])
    d_idx = torch.arange(p, device=n_acc.device)[None, :]
    out_tok = torch.where(d_idx < n_acc[:, None],
                          torch.roll(path_tokens, -1, dims=1),
                          torch.zeros_like(path_tokens))
    out_tok = torch.where((d_idx == n_acc[:, None]) & active[:, None],
                          res["bonus"][:, None], out_tok)
    return state2, {"tokens": out_tok, "n_out": n_commit}


# -------------------------------------------------------------- generate ---
def generate(bundle: SpecBundle, prompts, max_new: int,
             max_len: Optional[int] = None, cache_impl: str = "dense",
             page_size: int = 64, device="cuda"):
    """Generate up to ``max_new`` tokens for prompts [B, P] (host loop over
    decode cycles). Returns dict(tokens [B, max_new] numpy, n_cycles,
    alpha, prefill_s, decode_s). The two times are host clock readings;
    each ends at a device-to-host copy, so they include the device work.

    Rows that reached ``max_new`` are masked inactive (they stop
    committing, as JAX ``generate(early_exit=True)``); alpha counts
    committed tokens per active row-cycle.
    cache_impl: "dense" | "paged" KV storage (identity page layout).
    """
    dev = resolve_device(device)
    prompts = torch.as_tensor(np.asarray(prompts), device=dev).long()
    b, p = prompts.shape
    g = bundle.spec.gamma
    max_len = max_len or (p + max_new + 2 * g + 8)
    t0 = time.perf_counter()
    state = engine_init(bundle, b, max_len, cache_impl=cache_impl,
                        page_size=page_size, device=dev)
    state = prefill(bundle, state, prompts)

    out_buf = np.zeros((b, max_new + g + 1), np.int64)
    out_buf[:, 0] = state.anchor.cpu().numpy()
    t1 = time.perf_counter()
    filled = np.ones((b,), np.int64)
    n_cycles = act_cycles = committed = 0
    while filled.min() < max_new:
        below = filled < max_new
        act_cycles += int(below.sum())
        state = state.replace(active=torch.as_tensor(below, device=dev))
        state, out = decode_cycle(bundle, state)
        toks = out["tokens"].cpu().numpy()
        n_out = out["n_out"].cpu().numpy()
        for i in range(b):
            m = min(int(n_out[i]), out_buf.shape[1] - int(filled[i]))
            if m > 0:
                out_buf[i, filled[i]: filled[i] + m] = toks[i, :m]
        filled = np.minimum(filled + n_out, out_buf.shape[1])
        n_cycles += 1
        committed += int(n_out.sum())
        if n_cycles > max_new + 8:
            break
    return {"tokens": out_buf[:, :max_new], "n_cycles": n_cycles,
            "alpha": committed / act_cycles if act_cycles else 0.0,
            "prefill_s": t1 - t0,
            "decode_s": time.perf_counter() - t1}

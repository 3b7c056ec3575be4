"""D2SD decode engine: one decode cycle, the host generation loop and the
on-device loop (twin of ``repro/core/pipeline.py``).

A cycle runs the draft strategy of ``SpecConfig.mode`` (for ``d2sd``:
DFlash trunk, boundary posterior, top-K forks, batched VP second draft,
comb tree, and with ``third_level`` one more VP level), the
tree-attention verify over the target (the cascade read path; greedy at
temperature 0, rejection sampling above), the KV commit of the accepted
path and the feature-cache extension of both drafters.

Random numbers come from one ``torch.Generator`` per call, made from
``seed`` on the run's device and consumed in a fixed order: the prefill's
anchor, then in each cycle the draft and then the verify. Every draw is a
fixed-shape ``torch.rand``, so the graph loop (which registers the
generator with its CUDA graph) draws what the host loop draws and is
token-identical to it for the same seed.

``generate`` drives the cycles from the host and reads each cycle's
tokens back. ``generate_ondevice`` is the twin of the JAX
``lax.while_loop`` loop: on a card it replays one CUDA graph of a cycle
(:class:`OnDeviceLoop`), with no Python and no device-to-host sync
inside a cycle; on the CPU the same step runs eagerly.
"""
from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.models import kvcache as kvc
from repro_torch.models import param as pm


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
def decode_cycle(bundle: SpecBundle, state: EngineState, gen,
                 collect_stats: bool = True):
    """One full speculative decoding cycle; ``gen`` feeds the draft's and
    then the verify's random draws.

    Rows with ``state.active == False`` draft a root-only tree, commit
    nothing and keep their anchor. Returns (state', out) with out =
    dict(tokens [B, D+1], n_out [B], n_acc [B]): row b's first n_out[b]
    tokens are its accepted draft tokens then the bonus token. With
    ``collect_stats`` and a strategy that has a diffusion trunk, out also
    holds ``conf`` [B, gamma-1] (the trunk confidences) and ``trunk_ok``
    [B, gamma-1] (the trunk nodes' acceptance).
    """
    strategy = strat_lib.get_strategy(bundle.spec.mode)
    backend = verify_lib.select_backend(bundle.target_cfg)
    active = state.active

    draft = strat_lib.mask_inactive(strategy.draft(bundle, state, gen),
                                    active)
    tree = draft.tree
    vo = backend.verify(bundle, state, tree, draft.dprobs,
                        draft.max_children, gen)
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
    out = {"tokens": out_tok, "n_out": n_commit, "n_acc": n_acc}
    if collect_stats and draft.conf is not None:
        out["conf"] = draft.conf
        out["trunk_ok"] = res["ok"][:, 1:bundle.spec.gamma]
    return state2, out


# -------------------------------------------------------------- generate ---
def generate(bundle: SpecBundle, prompts, max_new: int, seed: int = 0,
             max_len: Optional[int] = None, collect_stats: bool = True,
             cache_impl: str = "dense", page_size: int = 64,
             device="cuda"):
    """Generate up to ``max_new`` tokens for prompts [B, P] (host loop over
    decode cycles). Returns dict(tokens [B, max_new] numpy, n_cycles,
    alpha, stats, prefill_s, decode_s). The two times are host clock
    readings; each ends at a device-to-host copy, so they include the
    device work.

    seed: the generator of the run's random draws (sampled prefill,
    drafts and verify at ``spec.temperature`` > 0; ``naive_k``'s
    resamples at any temperature), in place of JAX's ``key``.
    Rows that reached ``max_new`` are masked inactive (they stop
    committing, as JAX ``generate(early_exit=True)``); alpha counts
    committed tokens per active row-cycle. stats, as JAX's: per cycle
    ``n_acc`` and ``n_out`` [B], and with ``collect_stats`` ``conf`` and
    ``trunk_ok`` of the rows that were active (strategies with a trunk).
    cache_impl: "dense" | "paged" KV storage (identity page layout).
    """
    dev = resolve_device(device)
    gen = pm.make_generator(seed, dev)
    prompts = torch.as_tensor(np.asarray(prompts), device=dev).long()
    b, p = prompts.shape
    g = bundle.spec.gamma
    max_len = max_len or (p + max_new + 2 * g + 8)
    t0 = time.perf_counter()
    state = engine_init(bundle, b, max_len, cache_impl=cache_impl,
                        page_size=page_size, device=dev)
    state = prefill(bundle, state, prompts, gen,
                    temperature=bundle.spec.temperature)

    out_buf = np.zeros((b, max_new + g + 1), np.int64)
    out_buf[:, 0] = state.anchor.cpu().numpy()
    t1 = time.perf_counter()
    filled = np.ones((b,), np.int64)
    n_cycles = act_cycles = committed = 0
    stats = {"n_acc": [], "n_out": [], "conf": [], "trunk_ok": []}
    while filled.min() < max_new:
        below = filled < max_new
        act_cycles += int(below.sum())
        state = state.replace(active=torch.as_tensor(below, device=dev))
        state, out = decode_cycle(bundle, state, gen,
                                  collect_stats=collect_stats)
        toks = out["tokens"].cpu().numpy()
        n_out = out["n_out"].cpu().numpy()
        for i in range(b):
            m = min(int(n_out[i]), out_buf.shape[1] - int(filled[i]))
            if m > 0:
                out_buf[i, filled[i]: filled[i] + m] = toks[i, :m]
        filled = np.minimum(filled + n_out, out_buf.shape[1])
        n_cycles += 1
        committed += int(n_out.sum())
        stats["n_acc"].append(out["n_acc"].cpu().numpy())
        stats["n_out"].append(n_out)
        if "conf" in out:
            stats["conf"].append(out["conf"].cpu().numpy()[below])
            stats["trunk_ok"].append(out["trunk_ok"].cpu().numpy()[below])
        if n_cycles > max_new + 8:
            break
    return {"tokens": out_buf[:, :max_new], "n_cycles": n_cycles,
            "alpha": committed / act_cycles if act_cycles else 0.0,
            "stats": stats, "prefill_s": t1 - t0,
            "decode_s": time.perf_counter() - t1}


# ------------------------------------------------------- on-device loop ---
@functools.lru_cache(maxsize=None)
def _side_stream(dev):
    """One warm-up stream per card, kept: cuBLAS holds a workspace for
    every stream it has run on, so a new stream a call would leak one."""
    return torch.cuda.Stream(dev)


class OnDeviceLoop:
    """The decode loop of :func:`generate_ondevice` over a prefilled
    ``state`` (the body and condition of JAX ``_ondevice_loop``).

    Every cycle runs :meth:`step`, which reads and writes fixed tensors
    only: the caches (updated in place), the state's small leaves (the
    target's and both feature caches' ``length``, ``anchor``, ``active``),
    the output buffer ``buf`` [B, max_new+gamma+1], ``filled`` [B] and
    ``counts`` (cycles with an active row, committed tokens, active
    row-cycles), and the generator ``gen`` of the cycle's random draws.
    A row is active while ``filled < max_new``; a finished row commits
    nothing, so a cycle after the last row finished changes nothing.

    :meth:`start` runs the first cycle; on a card it runs eagerly on a
    side stream (the warm-up ``torch.cuda.graphs`` asks for, which also
    builds the kernels) and then captures :meth:`step` into a CUDA graph,
    which executes nothing. The graph registers ``gen``, so each replay
    draws from where the generator stands, as an eager cycle would, and
    not the capture's numbers again. :meth:`advance` runs the next
    cycle: a replay of that graph on a card, :meth:`step` on the CPU.
    :meth:`more` reads
    the loop's condition (one 4-byte copy to the host). A capture or a
    replay that fails raises; nothing falls back to eager execution.
    :meth:`close` releases the graph, whose private memory pool then
    goes back to the allocator. On a card ``first_s`` and ``capture_s``
    hold the host time of the eager first cycle (to its synchronize) and
    of the capture, ``graph_pool_bytes`` the memory the capture reserved.
    """

    def __init__(self, bundle: SpecBundle, state: EngineState, max_new: int,
                 gen: torch.Generator):
        dev = state.anchor.device
        b = state.anchor.shape[0]

        def own(cache):          # a length of its own, updated in place
            return dict(cache, length=cache["length"].clone(
                memory_format=torch.contiguous_format))

        self.bundle, self.max_new, self.device = bundle, max_new, dev
        self.gen = gen
        self.cycle_cap = max_new + 9     # the host loop's bailout
        self.state = state.replace(
            target=own(state.target), d1_feat=own(state.d1_feat),
            d2_feat=own(state.d2_feat), anchor=state.anchor.clone(),
            active=torch.ones((b,), dtype=torch.bool, device=dev))
        self.buf = torch.zeros((b, max_new + bundle.spec.gamma + 1),
                               dtype=torch.long, device=dev)
        self.buf[:, 0] = state.anchor
        self.filled = torch.ones((b,), dtype=torch.long, device=dev)
        self.counts = torch.zeros((3,), dtype=torch.long, device=dev)
        self.cond = torch.ones((), dtype=torch.int32, device=dev)
        self.cycles = 0                  # cycles run, counted on the host
        self.graph = None
        self.first_s = self.capture_s = 0.0     # card only: host clock
        self.graph_pool_bytes = 0

    def step(self):
        """One cycle, on the loop's fixed tensors only."""
        st = self.state
        below = self.filled < self.max_new
        st.active.copy_(below)
        new, out = decode_cycle(self.bundle, st, self.gen,
                                collect_stats=False)
        for key in ("target", "d1_feat", "d2_feat"):
            getattr(st, key)["length"].copy_(getattr(new, key)["length"])
        st.anchor.copy_(new.anchor)
        # the cycle's tokens into buf; slots past n_out or past the buffer
        # are dropped, as JAX's mode="drop" scatter drops them
        tok, n_out = out["tokens"], out["n_out"]
        b, t = tok.shape
        w = self.buf.shape[1]
        ar = torch.arange(t, device=tok.device)
        idx = self.filled[:, None] + ar[None, :]
        ok = (ar[None, :] < n_out[:, None]) & (idx < w)
        flat = torch.arange(b, device=tok.device)[:, None] * w + idx
        kvc.drop_put_(self.buf.view(-1), 0, flat.reshape(-1),
                      tok.reshape(-1), ok.reshape(-1))
        self.filled.copy_(torch.clamp(self.filled + n_out, max=w))
        self.counts += torch.stack([below.any().long(), n_out.sum(),
                                    below.sum()])
        self.cond.copy_(self.filled.min() < self.max_new)

    def start(self):
        """Run the first cycle; on a card, then capture the step."""
        dev = self.device
        self.cycles = 1
        if dev.type != "cuda":
            self.step()
            return
        with torch.cuda.device(dev):
            t0 = time.perf_counter()
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream(dev).wait_stream(side)
            # torch.cuda.graph empties the cache before it captures; done
            # here first, the memory reserved after the capture less this
            # is the graph's private pool
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            self.first_s = t1 - t0
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.gen)
            with torch.cuda.graph(graph):
                self.step()
            self.capture_s = time.perf_counter() - t1
            self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.graph = graph

    def advance(self):
        """Run the next cycle."""
        if self.graph is not None:
            self.graph.replay()
        else:
            self.step()
        self.cycles += 1

    def more(self) -> bool:
        """The loop's condition: a row is short of ``max_new`` tokens and
        the cycle cap is not reached."""
        return self.cycles < self.cycle_cap and bool(self.cond.item())

    def run(self):
        """Every cycle of the loop, then :meth:`close`. Returns self."""
        try:
            if self.max_new > 1:         # every row starts with 1 token
                self.start()
                while self.more():
                    self.advance()
        finally:
            self.close()
        return self

    def close(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def generate_ondevice(bundle: SpecBundle, prompts, max_new: int,
                      seed: int = 0, max_len: Optional[int] = None,
                      cache_impl: str = "dense", page_size: int = 64,
                      device="cuda"):
    """On-device generation (twin of JAX ``generate_ondevice``): prefill
    eagerly, then :class:`OnDeviceLoop`; on a card every cycle after the
    first is one CUDA graph replay, and the token buffer stays on the
    device until the end. Token-identical to :func:`generate` for the
    same ``seed``, with the same ``n_cycles`` (counted on the device) and
    ``alpha`` (committed tokens per active row-cycle).

    Returns dict(tokens [B, max_new] numpy, n_cycles, alpha, prefill_s,
    capture_s, decode_s, graph_pool_bytes). prefill_s and decode_s are
    host clock readings that end at a synchronize (decode_s: the cycles,
    the eager first one included, not the capture); capture_s is the
    capture alone and graph_pool_bytes the memory its private pool took
    (both 0 on the CPU).
    """
    dev = resolve_device(device)
    gen = pm.make_generator(seed, dev)
    prompts = torch.as_tensor(np.asarray(prompts), device=dev).long()
    b, p = prompts.shape
    max_len = max_len or (p + max_new + 2 * bundle.spec.gamma + 8)
    t0 = time.perf_counter()
    state = prefill(bundle, engine_init(bundle, b, max_len,
                                        cache_impl=cache_impl,
                                        page_size=page_size, device=dev),
                    prompts, gen, temperature=bundle.spec.temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    loop = OnDeviceLoop(bundle, state, max_new, gen).run()
    tokens = loop.buf[:, :max_new].cpu().numpy()
    n_cycles, total, act = loop.counts.tolist()
    return {"tokens": tokens, "n_cycles": n_cycles,
            "alpha": total / act if act else 0.0, "prefill_s": t1 - t0,
            "capture_s": loop.capture_s,
            "decode_s": time.perf_counter() - t1 - loop.capture_s,
            "graph_pool_bytes": loop.graph_pool_bytes}

"""Training step, optimizer choice, the production drafter's size and the
prefill and serve steps (twin of ``repro/launch/steps.py`` but its
``build_cell`` and abstract specs, which only the multi-device dry run
uses).

The step is ``loss.backward()`` on ``models.api.train_loss`` with
``attn_impl="kernel"``: on the card every attention layer runs the CUDA
flash forward kernel (again under remat) and both flash backward
kernels. Then the optimizer updates params and moments in place.

The prefill step of a cross-attention target takes its context: an
encoder-decoder encodes the audio frames and prefills with the encoder's
output, a VLM prefills with the image embeddings (``ctx_len_for`` sizes
the engine's cross caches for them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig, OptimizerConfig
from repro_torch.core import pipeline as pl
from repro_torch.core import state as state_lib
from repro_torch.core.drafter import DrafterConfig
from repro_torch.models import api, encdec, lm
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as opt_lib


GAMMA_PROD = 16
K_PROD = 4


def production_drafter(tcfg: ModelConfig, gamma: int = GAMMA_PROD,
                       causal: bool = False) -> DrafterConfig:
    """The drafter served beside ``tcfg``: d = max(512, d_model / 4
    rounded down to 128), heads of 128, 2 KV heads when the heads are
    even (else 1), ff 3d, two layers, reading the target's features."""
    d = max(512, (tcfg.d_model // 4) // 128 * 128)
    heads = max(4, d // 128)
    kv = 2 if heads % 2 == 0 else 1          # must divide heads
    return DrafterConfig(
        d_model=d, num_layers=2, num_heads=heads,
        num_kv_heads=kv, d_ff=3 * d,
        vocab_size=tcfg.vocab_size, target_feature_dim=lm.feature_dim(tcfg),
        gamma=gamma, causal=causal)


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    # factored moments for the giant MoEs; int8 moments for mid-size; plain
    # AdamW for small models
    n = cfg.param_count()
    if n > 1e11:
        return OptimizerConfig(name="adafactor")
    if n > 3e9:
        return OptimizerConfig(name="adamw8bit")
    return OptimizerConfig(name="adamw")


def make_train_step(cfg: ModelConfig, loss_seq_chunk: Optional[int] = None,
                    hp: Optional[OptimizerConfig] = None,
                    attn_impl: str = "kernel", device="cuda"):
    """(train_step, opt_init). ``train_step(params, opt_state, batch)``
    returns ``(params, opt_state, {"loss", "lr", "grad_norm"})``, with
    params and moments updated in place; the batch may be numpy (it is
    moved to ``device``). ``loss_seq_chunk``: the cross entropy over
    sequence chunks of that length (``lm.loss_fn``), so the [B,S,V]
    logits and their gradient never exist whole. ``hp`` defaults to
    :func:`optimizer_for`."""
    dev = resolve_device(device)
    hp = hp if hp is not None else optimizer_for(cfg)
    opt_init, opt_update = opt_lib.make_optimizer(hp, cfg)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        flat = pm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        try:
            loss = api.train_loss(params, batch, cfg, attn_impl=attn_impl,
                                  loss_seq_chunk=loss_seq_chunk)
            grads = torch.autograd.grad(loss, list(flat.values()))
        finally:
            for p in flat.values():
                p.requires_grad_(False)
        grads = pm.unflatten_like(params, dict(zip(flat, grads)))
        new_p, new_o, metrics = opt_update(grads, opt_state, params)
        return new_p, new_o, {"loss": loss.detach(), **metrics}

    return train_step, opt_init


def ctx_len_for(cfg: ModelConfig) -> int:
    """Length of the context a target's cross caches hold (0: none)."""
    if cfg.is_encoder_decoder:
        return cfg.enc_max_len
    if cfg.cross_attn_every:
        return max(cfg.num_vision_tokens, 1)
    return 0


def make_prefill_step(cfg: ModelConfig):
    """The prefill of ``cfg``'s family: ``step(enc_params, bundle, state,
    prompts, audio_feats)`` for an encoder-decoder, ``step(bundle, state,
    prompts, image_embeds)`` for a VLM, else ``step(bundle, state,
    prompts)``; each returns the prefilled ``EngineState``."""
    if cfg.is_encoder_decoder:
        def step(enc_params, bundle, est, prompts, audio_feats):
            ctx = encdec.encode(enc_params, audio_feats, cfg)
            return state_lib.prefill(bundle, est, prompts, ctx=ctx)
        return step
    if cfg.cross_attn_every:
        def step(bundle, est, prompts, image_embeds):
            return state_lib.prefill(bundle, est, prompts, ctx=image_embeds)
        return step

    def step(bundle, est, prompts):
        return state_lib.prefill(bundle, est, prompts)
    return step


def make_serve_step():
    """``serve_step(bundle, state, gen)``: one decode cycle, no stats."""
    def serve_step(bundle, est, gen):
        return pl.decode_cycle(bundle, est, gen, collect_stats=False)
    return serve_step

"""Unified per-architecture model API: init / train loss / batch synthesis
(twin of ``repro/models/api.py``).

Dispatches on the config family: an encoder-decoder (whisper) composes
an encoder (``models/encdec.py``); VLM and audio batches carry stub
modality embeddings (``image_embeds``, ``audio_feats``), random tensors
from the port's own generator.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models import param as pm


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    if cfg.is_encoder_decoder:
        return encdec.encdec_init(cfg, seed=seed, device=device)
    return lm.lm_init(cfg, seed=seed, device=device)


def decoder_params(params, cfg: ModelConfig):
    return params["decoder"] if cfg.is_encoder_decoder else params


def train_loss(params, batch, cfg: ModelConfig, **kw):
    if cfg.is_encoder_decoder:
        return encdec.encdec_loss(params, batch, cfg, **kw)
    return lm.loss_fn(params, batch, cfg, ctx=batch.get("image_embeds"),
                      **kw)


def _ctx_shape(cfg: ModelConfig, batch: int):
    """(key, shape) of the batch's modality embeddings, or None."""
    if cfg.is_encoder_decoder:
        return "audio_feats", (batch, cfg.enc_max_len, cfg.d_model)
    if cfg.cross_attn_every:
        return "image_embeds", (batch, max(cfg.num_vision_tokens, 1),
                                cfg.d_model)
    return None


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int,
               device="cuda") -> Dict[str, Any]:
    """Random but well-formed training batch (smoke tests / shapes); the
    modality embeddings are standard normal, in bfloat16 as JAX's."""
    dev = resolve_device(device)
    gen = pm.make_generator(seed, dev)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    out = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
           "mask": torch.ones((batch, seq), dtype=torch.float32,
                              device=dev)}
    extra = _ctx_shape(cfg, batch)
    if extra is not None:
        key, shape = extra
        out[key] = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    return out


def batch_specs(cfg: ModelConfig, batch: int, seq: int):
    """Stand-ins for ``make_batch``: tensors on the ``meta`` device, with
    shapes and dtypes and no storage."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    out = {"tokens": meta((batch, seq), torch.int32),
           "labels": meta((batch, seq), torch.int32),
           "mask": meta((batch, seq), torch.float32)}
    extra = _ctx_shape(cfg, batch)
    if extra is not None:
        out[extra[0]] = meta(extra[1], torch.bfloat16)
    return out

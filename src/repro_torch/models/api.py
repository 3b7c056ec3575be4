"""Unified model API: init / train loss / batch synthesis (twin of
``repro/models/api.py``) for decoder-only configs.

Encoder-decoder (whisper) and VLM configs raise: their blocks are not
ported (ROADMAP.md queue 1, slice C).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models import param as pm

_SLICE_C = ("encoder-decoder and VLM models are not ported: ROADMAP.md "
            "queue 1, slice C")


def _decoder_only(cfg: ModelConfig):
    if cfg.is_encoder_decoder or cfg.cross_attn_every:
        raise NotImplementedError(_SLICE_C)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    _decoder_only(cfg)
    return lm.lm_init(cfg, seed=seed, device=device)


def train_loss(params, batch, cfg: ModelConfig, **kw):
    _decoder_only(cfg)
    return lm.loss_fn(params, batch, cfg, **kw)


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int,
               device="cuda") -> Dict[str, Any]:
    """Random but well-formed training batch (smoke tests / shapes)."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    gen = pm.make_generator(seed, dev)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
            "mask": torch.ones((batch, seq), dtype=torch.float32,
                               device=dev)}


def batch_specs(cfg: ModelConfig, batch: int, seq: int):
    """Stand-ins for ``make_batch``: tensors on the ``meta`` device, with
    shapes and dtypes and no storage."""
    _decoder_only(cfg)
    meta = lambda dt: torch.empty((batch, seq), dtype=dt, device="meta")  # noqa: E731
    return {"tokens": meta(torch.int32), "labels": meta(torch.int32),
            "mask": meta(torch.float32)}

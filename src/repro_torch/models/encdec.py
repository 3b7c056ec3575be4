"""Encoder-decoder composition, Whisper-style (twin of
``repro/models/encdec.py``).

Encoder: a bidirectional transformer over precomputed frame embeddings
(the conv frontend is a stub, as in JAX: callers hand over the frame
embeddings), RoPE at ``arange(T_enc)``, a final norm. Decoder: the
causal LM of ``models/lm.py`` whose blocks cross-attend to the encoder's
output (``cfg.cross_attn_every=1``).

Params: ``{"encoder": {"ln_f", "layers": [per-layer dicts]}, "decoder":
lm params}``; ``repro_torch.convert.convert_encdec`` unstacks JAX's
scanned encoder layers into the list.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import train_mesh
from repro_torch.models import lm
from repro_torch.models import param as pm
from repro_torch.models.attention import (attend, attn_init, out_proj,
                                          project_qkv)
from repro_torch.models.layers import rmsnorm
from repro_torch.models.mlp import mlp, mlp_init


def encoder_init(gen, cfg: ModelConfig):
    dev = gen.device
    ones = lambda: {"scale": torch.ones((cfg.d_model,), device=dev)}  # noqa: E731
    p: Dict[str, Any] = {"ln_f": ones()}
    p["layers"] = [{"ln1": ones(), "attn": attn_init(gen, cfg),
                    "ln2": ones(),
                    "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.mlp_gated)}
                   for _ in range(cfg.enc_num_layers)]
    return p


def encode(p, feats, cfg: ModelConfig, attn_impl: str = "auto"):
    """feats: [B, T_enc, d] (the stub frontend's output) -> [B, T_enc, d].
    Under ``attn_impl="auto"`` a long input (T_enc^2 > 256 * 1024, as
    whisper's 1500 frames) attends in 1024-key chunks, the last one short.
    ``p`` may hold a serving rank's storage (``sharding.Stored``): each
    layer is made whole as it starts.
    """
    x = feats.to(getattr(torch, cfg.dtype))
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    for i in range(len(p["layers"])):
        lp = sh.whole(p, p["layers"][i], f"layers/{i}")
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = project_qkv(lp["attn"], h, cfg, positions=positions)
        y = attend(q, k, v, causal=False, impl=attn_impl)
        x = x + out_proj(lp["attn"], y)
        h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h, cfg.mlp_act, cfg.mlp_gated)
    return rmsnorm(p["ln_f"], x, cfg.norm_eps)


def encdec_init(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights on ``device``: the decoder drawn as ``lm.lm_init``
    draws it from ``seed``, the encoder from a generator seeded
    ``seed + 1``."""
    dev = resolve_device(device)
    return {"encoder": encoder_init(pm.make_generator(seed + 1, dev), cfg),
            "decoder": lm.lm_init(cfg, seed=seed, device=dev)}


def encdec_loss(params, batch, cfg: ModelConfig, **kw):
    """batch: dict(tokens, labels, mask, audio_feats [B, T_enc, d]). In a
    train step on the mesh (data parallelism and FSDP,
    ``distributed/train_mesh.py``) the encoder's FSDP leaves are gathered
    as the loss starts, the decoder's as each of its layers does."""
    tp = train_mesh.active()
    enc_p = (params["encoder"] if tp is None
             else tp.gather(params["encoder"], "encoder"))
    enc = encode(enc_p, batch["audio_feats"], cfg,
                 attn_impl=kw.get("attn_impl", "auto"))
    with train_mesh.within("decoder"):
        return lm.loss_fn(params["decoder"], batch, cfg, ctx=enc, **kw)

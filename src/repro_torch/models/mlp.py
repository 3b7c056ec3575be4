"""Dense (gated) MLP block: SwiGLU / GeGLU / plain (twin of
``repro/models/mlp.py``)."""
from __future__ import annotations

from repro_torch.models import param as pm
from repro_torch.models.layers import act_fn, dense


def mlp_init(gen, d_model, d_ff, gated=True):
    p = {"w_in": pm.dense_init(gen, d_model, d_ff),
         "w_out": pm.dense_init(gen, d_ff, d_model, scale=d_ff ** -0.5)}
    if gated:
        p["w_gate"] = pm.dense_init(gen, d_model, d_ff)
    return p


def mlp(p, x, act="silu", gated=True):
    h = dense(p["w_in"], x)
    if gated:
        g = dense(p["w_gate"], x)
        h = act_fn(act)(g) * h
    else:
        h = act_fn(act)(h)
    return dense(p["w_out"], h)

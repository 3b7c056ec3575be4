"""Optimizers: AdamW, AdamW with int8 block-wise moments, and Adafactor
(twin of ``repro/optim/optimizers.py``).

The interface is the JAX one, with the model config beside the
hyperparameters: ``init(params) -> state`` and
``update(grads, state, params) -> (params, state, metrics)``, over the
port's param trees (nested dicts and the ``layers`` list). Unlike JAX's
immutable arrays, ``update`` writes the new params and moments into the
tensors it is given, and scales the grads in place, under
``torch.no_grad()``: the card holds one copy of each, which is what lets
an 8-layer ``paper-target`` train on one H100. The returned trees are the
objects passed in. The arithmetic is plain torch in fp32 and follows the
JAX expressions term for term.

The moments are laid out as JAX holds them, not as the params are: each
period position's leaf is stacked over the periods (``period/p{j}/...``,
[n_periods, ...]), the tail layers are ``tail{i}/...``. An int8 block of
256, Adafactor's factored second moment (a stacked 1-D leaf is 2-D) and
its update clip all span the layers of one stack, so they need that view.
AdamW proper is elementwise and updates one layer at a time, into views
of the stacked moments.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig, OptimizerConfig
from repro_torch.models import param as pm
from repro_torch.models.blocks import period_spec


# ------------------------------------------------------------- schedules ---
def lr_schedule(hp: OptimizerConfig, step):
    """Warmup then cosine to 10 %: an fp32 0-d tensor for an int ``step``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - hp.warmup_steps)
                       / max(hp.total_steps - hp.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return hp.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in pm.flatten(tree).values()))


def clip_by_global_norm(grads, max_norm):
    """Grads scaled to global norm <= ``max_norm`` (fp32 grads in place)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return pm.tree_map(lambda g: g.mul_(scale) if g.dtype == torch.float32
                       else g.float() * scale, grads), gn


# ---------------------------------------------------------- JAX layout ----
def _groups(tree, cfg: ModelConfig):
    """{JAX path: (port leaves, stacked)}: the leaves of a port param tree
    regrouped as the JAX package holds them. A ``period/p{j}`` group lists
    its layers in period order and is ``stacked``; the others hold one."""
    spec, n_periods, _ = period_spec(cfg)
    plen = len(spec)
    groups = {}
    for path, t in pm.flatten(tree).items():
        parts = path.split("/")
        if parts[0] == "layers":
            i = int(parts[1])
            head = (f"period/p{i % plen}" if i < plen * n_periods
                    else f"tail{i - plen * n_periods}")
            path = "/".join([head] + parts[2:])
        groups.setdefault(path, ([], path.startswith("period/")))[0].append(t)
    return groups


def _nest(flat):
    """{"/"-joined path: leaf} -> nested dicts."""
    out = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def _shape(leaves, stacked):
    return (len(leaves),) + tuple(leaves[0].shape) if stacked \
        else tuple(leaves[0].shape)


def _gather(leaves, stacked):
    """The group as one fp32 tensor: stacked over periods, or the leaf."""
    return torch.stack([t.float() for t in leaves]) if stacked \
        else leaves[0].float()


def _scatter(leaves, stacked, new):
    for t, n in zip(leaves, new if stacked else [new]):
        t.copy_(n)


def _init_state(params, cfg: ModelConfig, make):
    return _nest({path: make(_shape(ts, stacked), ts[0].device)
                  for path, (ts, stacked) in _groups(params, cfg).items()})


# ------------------------------------------------------- int8 moment util --
_Q8_BLOCK = 256


def _q8(x):
    """Symmetric BLOCK-WISE int8 quantization: a scale per 256 elements
    (the second moment spans many orders of magnitude within a tensor).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % _Q8_BLOCK)).reshape(-1, _Q8_BLOCK)
    amax = fp.abs().amax(dim=1, keepdim=True) + 1e-12
    scale = (amax / 127.0).float()
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dq8(q, scale, shape):
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ------------------------------------------------------------------ AdamW --
def _step0():
    return torch.zeros((), dtype=torch.int32)


def adamw_init(params, cfg: ModelConfig, quantized: bool = False):
    def zero_like(shape, dev):
        if quantized:
            nblk = (math.prod(shape) + _Q8_BLOCK - 1) // _Q8_BLOCK
            return {"q": torch.zeros((nblk, _Q8_BLOCK), dtype=torch.int8,
                                     device=dev),
                    "s": torch.zeros((nblk,), dtype=torch.float32,
                                     device=dev)}
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {"m": _init_state(params, cfg, zero_like),
            "v": _init_state(params, cfg, zero_like), "step": _step0()}


@torch.no_grad()
def adamw_update(grads, state, params, hp: OptimizerConfig, cfg: ModelConfig,
                 quantized: bool = False):
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    grads, gn = clip_by_global_norm(grads, hp.grad_clip)
    b1, b2, eps = hp.b1, hp.b2, hp.eps
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    g_groups = _groups(grads, cfg)

    def upd(p, g, m_f, v_f):
        m_new = b1 * m_f + (1 - b1) * g
        v_new = b2 * v_f + (1 - b2) * torch.square(g)
        upd_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if quantized:
            # quantization can zero tiny v entries whose m survived
            upd_ = torch.clamp(upd_, -3.0, 3.0)
        return p - lr * (upd_ + hp.weight_decay * p), m_new, v_new

    for path, (ps, stacked) in _groups(params, cfg).items():
        gs = g_groups[path][0]
        m, v = pm.get_path(state["m"], path), pm.get_path(state["v"], path)
        if not quantized:
            # elementwise: a layer at a time, into views of the stacked moments
            for p, g, m_i, v_i in zip(ps, gs, m if stacked else [m],
                                      v if stacked else [v]):
                p_new, m_new, v_new = upd(p.float(), g.float(), m_i, v_i)
                p.copy_(p_new)
                m_i.copy_(m_new)
                v_i.copy_(v_new)
            continue
        shape = _shape(ps, stacked)
        m_f = _dq8(m["q"], m["s"], shape)
        # v stored in the sqrt domain (halves the dynamic range an int8
        # linear code must span)
        v_f = torch.square(_dq8(v["q"], v["s"], shape))
        p_new, m_new, v_new = upd(_gather(ps, stacked), _gather(gs, stacked),
                                  m_f, v_f)
        _scatter(ps, stacked, p_new)
        for mom, new in ((m, m_new), (v, torch.sqrt(v_new))):
            q, s = _q8(new)
            mom["q"].copy_(q)
            mom["s"].copy_(s)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gn}


# -------------------------------------------------------------- Adafactor --
def adafactor_init(params, cfg: ModelConfig):
    def factored(shape, dev):
        z = lambda sh: torch.zeros(sh, dtype=torch.float32,  # noqa: E731
                                   device=dev)
        if len(shape) >= 2:
            return {"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
        return {"v": z(shape)}

    return {"v": _init_state(params, cfg, factored), "step": _step0()}


@torch.no_grad()
def adafactor_update(grads, state, params, hp: OptimizerConfig,
                     cfg: ModelConfig):
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    grads, gn = clip_by_global_norm(grads, hp.grad_clip)
    decay = 1.0 - step.float() ** -0.8
    eps = 1e-30
    g_groups = _groups(grads, cfg)
    for path, (ps, stacked) in _groups(params, cfg).items():
        p = _gather(ps, stacked)
        g = _gather(g_groups[path][0], stacked)
        v = pm.get_path(state["v"], path)
        g2 = torch.square(g) + eps
        if p.ndim >= 2:
            vr = decay * v["vr"] + (1 - decay) * g2.mean(-1)
            vc = decay * v["vc"] + (1 - decay) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vv = decay * v["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(torch.clamp(vv, min=eps))
            v["v"].copy_(vv)
        # update clipping (Adafactor d=1.0)
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms_u, min=1.0)
        _scatter(ps, stacked, p - lr * (u + hp.weight_decay * p))
    return params, {"v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gn}


# ------------------------------------------------------------- dispatcher --
def make_optimizer(hp: OptimizerConfig, cfg: ModelConfig):
    """(init, update) for ``hp.name``; ``cfg`` gives the period layout of
    the moments."""
    if hp.name == "adamw":
        return (lambda p: adamw_init(p, cfg, False),
                lambda g, s, p: adamw_update(g, s, p, hp, cfg, False))
    if hp.name == "adamw8bit":
        return (lambda p: adamw_init(p, cfg, True),
                lambda g, s, p: adamw_update(g, s, p, hp, cfg, True))
    if hp.name == "adafactor":
        return (lambda p: adafactor_init(p, cfg),
                lambda g, s, p: adafactor_update(g, s, p, hp, cfg))
    raise ValueError(hp.name)

"""Compressed gradient all-reduce with error feedback (twin of
``repro/distributed/collectives.py``).

int8 gradient exchange over the data axis: each rank quantizes its local
gradient block-wise to int8 against a scale the ranks share, SUM
all-reduces the int8 payload widened to int32 (an exact sum), and
dequantizes. Each rank's quantization residual is kept in its
error-feedback buffer and added back at the next step (Karimireddy et
al., "Error Feedback Fixes SignSGD", arXiv:1901.09847).

SPMD form: every rank calls :func:`compressed_grad_allreduce` with its own
local gradients inside a mesh (``distributed/sharding.py``), where JAX's
runs inside ``shard_map`` over the axis. Nothing calls it yet in either
package: the trainer leaves ``OptimizerConfig.compress_grads`` unread
("not ported", ``config/base.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.models import param as pm

_BLOCK = 256


def compressed_grad_allreduce(grads, err_state, axis: str = "data"):
    """grads / err_state: matching trees of this rank's LOCAL (unreduced)
    gradients and error buffers. Per block of 256: a MAX all-reduce of
    the block's amax gives the shared scale s = amax / 127; the int8
    payload, widened to int32, is SUM all-reduced; the mean is acc * s /
    n. Returns (mean grads, new error state), trees of fp32 tensors; the
    leaves go through the collectives in the tree's order, the same on
    every rank."""
    mesh = sh.active_mesh()
    n = mesh.size(axis)

    def one(g, e):
        g = g.float() + e
        flat = g.reshape(-1)
        fp = F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
        amax = fp.abs().amax(1, keepdim=True) + 1e-12
        amax = mesh.all_reduce_(amax, dist.ReduceOp.MAX, axis)  # shared
        scale = amax / 127.0
        q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
        deq_local = (q.float() * scale).reshape(-1)[:flat.numel()]
        acc = mesh.all_reduce_(q.to(torch.int32), dist.ReduceOp.SUM, axis)
        mean = (acc.float() * scale / n).reshape(-1)[:flat.numel()]
        return mean.reshape(g.shape), g - deq_local.reshape(g.shape)

    flat_g, flat_e = pm.flatten(grads), pm.flatten(err_state)
    out = {k: one(g, flat_e[k]) for k, g in flat_g.items()}
    return (pm.unflatten_like(grads, {k: v[0] for k, v in out.items()}),
            pm.unflatten_like(grads, {k: v[1] for k, v in out.items()}))


def init_error_state(grads):
    return pm.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)

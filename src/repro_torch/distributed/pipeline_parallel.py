"""GPipe-style pipeline parallelism over the ``pod`` axis (twin of
``repro/distributed/pipeline_parallel.py``).

The layer stack is split into S contiguous stages, one a rank of the
``pod`` axis; M microbatches stream through them in M + S - 1 ticks, the
bubble fraction (S - 1) / (M + S - 1). JAX runs the schedule in a
``shard_map`` over the axis; here every rank of the axis runs the same
ticks (SPMD over ``torch.distributed`` ranks, ``launch/mesh.py``): on
every tick each rank applies its stage to what it holds, stage 0 having
injected microbatch t while t < M, and the activations hop one stage on,
i -> (i + 1) mod S, by a paired non-blocking send and receive over the
axis's group (blocking sends around a ring would deadlock). The last
stage records microbatch t - (S - 1) from tick S - 1 on, and its
outputs are summed to every rank (JAX's ``psum`` of the masked
outputs).

Forward only: the hop has no backward yet, so a call that autograd
would record raises (ROADMAP.md queue 1, item 10e).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh
from repro_torch.models import param as pm

#: calls of the stage function on this rank since the last reset
STAGE_CALLS = {"n": 0}


def _hop(y: torch.Tensor, group, prev: int, nxt: int) -> torch.Tensor:
    """``y`` sent to global rank ``nxt`` while this rank receives the
    previous stage's from ``prev`` (gloo: staged through the host)."""
    host = y.detach().cpu().contiguous()
    buf = torch.empty_like(host)
    reqs = [dist.irecv(buf, src=prev, group=group),
            dist.isend(host, dst=nxt, group=group)]
    for r in reqs:
        r.wait()
    return buf.to(y.device)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   axis: str = "pod"):
    """Run microbatches through the pipeline stages of ``axis``.

    stage_fn(params_slice, x) -> y: one stage's computation (y shaped as
    x). stage_params: a tree whose leaves lead with the stage axis, [S,
    ...] (every stage's; the rank takes its own) or [1, ...] (the rank's
    own slice, as JAX's shard_map hands it). x_microbatches: [M, mb, ...],
    the same on every rank of the axis. Returns the final stage's [M, mb,
    ...] outputs on every rank."""
    mesh = sh.active_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"pipeline_apply needs a mesh with a {axis!r} axis")
    s = mesh.size(axis)
    rank = mesh.index(axis)
    m = x_microbatches.shape[0]
    leaves = pm.flatten(stage_params)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in list(leaves.values())
            + [x_microbatches]):
        raise NotImplementedError(
            "pipeline_apply runs forward only: its hop has no backward "
            "(ROADMAP.md queue 1, item 10e)")
    for k, t in leaves.items():
        if t.shape[0] not in (s, 1):
            raise ValueError(f"stage_params {k}: leading axis {t.shape[0]}, "
                             f"not the {s} stages or this rank's one")
    params = pm.tree_map(lambda t: t[rank] if t.shape[0] == s and s > 1
                         else t[0], stage_params)
    group = mesh.group(axis)
    if s > 1:
        ranks = dist.get_process_group_ranks(group)
        prev, nxt = ranks[(rank - 1) % s], ranks[(rank + 1) % s]
    buf = torch.zeros_like(x_microbatches[0])
    outs = torch.zeros_like(x_microbatches)
    for t in range(m + s - 1):
        x_in = x_microbatches[min(t, m - 1)] if rank == 0 and t < m else buf
        y = stage_fn(params, x_in)
        STAGE_CALLS["n"] += 1
        if rank == s - 1 and t >= s - 1:
            outs[t - (s - 1)] = y
        buf = _hop(y, group, prev, nxt) if s > 1 else y
    if rank != s - 1:
        outs.zero_()
    return mesh.all_reduce_(outs, dist.ReduceOp.SUM, axis)

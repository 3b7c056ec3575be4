"""Expert parallelism over the ``experts`` mesh axis (twin of
``repro/distributed/ep.py``).

Token activations are replicated over the ``model`` axis, so expert
parallelism needs no all-to-all: every rank routes every token, runs only
the experts it holds (capacity buckets, as ``models/moe.py``), and one
SUM all-reduce over the axis merges the ranks' partial outputs.

Expert-to-rank mapping, for an axis of size M and E experts:

* ``E % M == 0``: rank r holds experts ``[r E/M, (r + 1) E/M)``;
* ``M % E == 0``: the experts are split along d_ff, ``split = M / E``:
  rank r holds the ``(r % split)``-th d_ff slice of expert ``r // split``
  (the expert's activation is elementwise in d_ff, so the slices' outputs
  sum to the expert's).

SPMD form: a rank holds only its part of every expert stack
(:func:`ep_local_params`, or :func:`ep_shard_target` over a target, or
``lm_init(expert_part=)``, which draws the whole stacks' numbers and
keeps the part); the router and the shared experts stay whole. ``x`` is
JAX's global view of the rows the rank holds. JAX fits the flattened
tokens over the batch axes (``ep.py:83-91``: ``pod``, then ``data``, each
kept while it divides the count) and gives each (pod, data) index a
contiguous run of them, whose capacity comes from its own count:

* when the rank holds every row (the batch axes did not split them), it
  runs its experts over its own run (:func:`data_slice`) and the runs are
  all-gathered back over the fitted axes;
* when it holds its part of a batch split over the batch axes
  (``sharding.row_subset``: a cycle's run of a wave, an install's rows),
  it runs its experts over each of JAX's runs that fall in its rows
  (:func:`row_runs`), with no gather: its batch peers hold the others.

JAX's ``shard_map`` makes its function differentiable; here ``x`` and
the gates enter the rank's experts through :class:`_SumGrad` (identity
forward, SUM all-reduce backward) and the output leaves through
:class:`_SumOut` (SUM all-reduce forward, identity backward); under a
token split, :class:`_DataRun` and :class:`_DataGather` carry the runs
and the expert stacks' gradients are summed over the fitted axes. So the
router's and ``x``'s gradients are whole and equal on every rank, and
each rank's expert gradients are its part of JAX's.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.spdecode import PayloadCounter

#: the EP all-reduces' calls, bytes a rank sends and (``timed``: after a
#: device synchronize) host seconds, counted at every call
REDUCES = PayloadCounter()

_STACKS = ("moe_w_in", "moe_w_gate", "moe_w_out")
#: the paths of the expert stacks in a target's params
STACKS_PATTERN = r"(^|/)moe_w_(in|gate|out)$"


def experts_axis(mesh) -> Optional[str]:
    """The mesh axis the active rules map ``experts`` to, if it is one of
    ``mesh``'s axes of size > 1."""
    ax = sh.mesh_axis("experts", mesh) if mesh is not None else None
    return ax if ax is not None and mesh.size(ax) > 1 else None


def _fits(cfg, m: int) -> bool:
    e = cfg.moe.num_experts
    return e % m == 0 or (m % e == 0 and cfg.d_ff % (m // e) == 0)


def ep_available(cfg) -> bool:
    """A MoE ``cfg`` inside a mesh whose ``experts`` axis has size M > 1
    that the experts divide, or that divides into the experts' d_ff."""
    mesh = sh.active_mesh()
    if mesh is None or cfg.moe is None:
        return False
    ax = experts_axis(mesh)
    return ax is not None and _fits(cfg, mesh.size(ax))


def expert_part(cfg, rank: int, m: int) -> Tuple[int, int, int, int]:
    """The part of the expert stacks rank ``rank`` of an experts axis of
    size ``m`` holds: (first expert, experts, first d_ff column, d_ff
    columns)."""
    e, f = cfg.moe.num_experts, cfg.d_ff
    if not _fits(cfg, m):
        raise ValueError(f"{e} experts with d_ff {f} do not split over an "
                         f"experts axis of size {m}")
    if e % m == 0:
        e_loc = e // m
        return rank * e_loc, e_loc, 0, f
    split = m // e
    f_loc = f // split
    return rank // split, 1, (rank % split) * f_loc, f_loc


def mesh_expert_part(cfg, mesh) -> Optional[Tuple[int, int, int, int]]:
    """This rank's :func:`expert_part` in ``mesh`` under the active rules,
    or None where expert parallelism does not apply."""
    ax = experts_axis(mesh)
    if cfg.moe is None or ax is None or not _fits(cfg, mesh.size(ax)):
        return None
    return expert_part(cfg, mesh.index(ax), mesh.size(ax))


def slice_stack(name: str, w: torch.Tensor, part) -> torch.Tensor:
    """``w``'s rows ``part`` selects (an ``[E, d, f]`` stack cut along f,
    ``moe_w_out`` ``[E, f, d]`` along its rows), as a contiguous copy."""
    e0, ne, f0, nf = part
    w = w[e0:e0 + ne]
    w = w[:, f0:f0 + nf] if name == "moe_w_out" else w[..., f0:f0 + nf]
    return w.clone(memory_format=torch.contiguous_format)


def ep_local_params(moe_params, cfg, mesh):
    """A rank's MoE params: its part of each expert stack (JAX's relayout,
    ``ep.py:68-81``), the router and the shared experts whole."""
    part = mesh_expert_part(cfg, mesh)
    if part is None:
        raise ValueError("ep_local_params: expert parallelism does not "
                         "apply to this config in this mesh")
    return {k: slice_stack(k, v, part) if k in _STACKS else v
            for k, v in moe_params.items()}


def ep_shard_target(params, cfg, mesh):
    """``params`` of a target with every MoE layer's stacks cut to this
    rank's part (:func:`ep_local_params`); the same params where expert
    parallelism does not apply. The full stacks are not kept."""
    if mesh_expert_part(cfg, mesh) is None:
        return params
    layers = [dict(lp, ffn=ep_local_params(lp["ffn"], cfg, mesh))
              if "router" in lp.get("ffn", {}) else lp
              for lp in params["layers"]]
    return dict(params, layers=layers)


def data_slice(n_tokens: int, mesh) -> Tuple[int, int]:
    """The contiguous run ``[start, stop)`` of ``n_tokens`` flattened
    tokens (every row of the batch) that this rank computes under JAX's
    batch fit (``ep.py:83-91``, the batch rule's axes: ``pod``, then
    ``data``, each kept while the product divides the count): its
    flattened (pod, data) index's share, all of them when no axis
    divides the count."""
    axes = sh.batch_axes(n_tokens, mesh)
    k = mesh.size(axes)
    t_loc = n_tokens // k
    i = mesh.index(axes)
    return i * t_loc, (i + 1) * t_loc


def row_runs(total: int, keep, t: int, mesh) -> List[Tuple[int, int]]:
    """JAX's token runs (:func:`data_slice` over ``total`` rows of ``t``
    tokens) that fall in this rank's rows ``keep`` (positions among the
    ``total``, in the order the rank holds them), as ranges of the rank's
    own flattened tokens. A run that straddles rows of two batch ranks
    raises ``NotImplementedError``: no rank holds all of its tokens."""
    n = total * t
    axes = sh.batch_axes(n, mesh)
    t_loc = n // mesh.size(axes)
    at = {r: i for i, r in enumerate(keep)}
    out = []
    for a in range(0, n, t_loc):
        rows = range(a // t, (a + t_loc - 1) // t + 1)
        mine = [r in at for r in rows]
        if not any(mine):
            continue
        if not all(mine) or any(at[r] - at[rows[0]] != r - rows[0]
                                for r in rows):
            raise NotImplementedError(
                f"expert parallelism: a token run of {t_loc} of {n} "
                f"straddles rows {list(rows)} held by different batch "
                "ranks")
        lo = at[rows[0]] * t + a - rows[0] * t
        out.append((lo, lo + t_loc))
    assert sum(z - a for a, z in out) == len(keep) * t, (out, keep, t)
    return out


def ep_capacity(t_loc: int, cfg) -> int:
    """EP's capacity a rank's expert (``ep.py:92``): from the rank's own
    token count, at least 8 (no ``min(8, T)`` as ``moe._capacity``)."""
    m = cfg.moe
    return max(8, int(t_loc * m.top_k / m.num_experts * m.capacity_factor)
               + 1)


def _reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """SUM all-reduce of a fresh tensor over ``axis``, counted."""
    if REDUCES.timed and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    mesh.all_reduce_(t, dist.ReduceOp.SUM, axis)
    REDUCES.calls += 1
    REDUCES.bytes += t.numel() * t.element_size()
    if REDUCES.timed:
        REDUCES.merge_s += time.perf_counter() - t0
    return t


class _SumGrad(torch.autograd.Function):
    """Identity forward; the cotangent SUM all-reduced over the axis."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _SumOut(torch.autograd.Function):
    """SUM all-reduce forward over the axis; identity backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _reduce(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _gather_runs(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's run of rows over ``axes``, in rank order."""
    return mesh.all_gather(t.contiguous(), axes).flatten(0, 1)


class _DataRun(torch.autograd.Function):
    """Rows ``[a, z)`` of a tensor replicated over ``axes``; backward: the
    ranks' runs of the cotangent all-gathered, the whole gradient."""

    @staticmethod
    def forward(ctx, t, a, z, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t[a:z].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_runs(g, ctx.mesh, ctx.axes), None, None, None, None


class _DataGather(torch.autograd.Function):
    """The ranks' runs all-gathered over ``axes``; backward: this rank's
    run."""

    @staticmethod
    def forward(ctx, t, a, z, mesh, axes):
        ctx.a, ctx.z = a, z
        return _gather_runs(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.a:ctx.z], None, None, None, None


def moe_apply_ep(p, x, cfg):
    """x: [B, T, d], the tokens of the rows this rank holds (replicated
    over the experts axis) -> [B, T, d], the same on every rank of that
    axis: the routed experts' sum over the experts axis (the caller adds
    the shared experts). Requires :func:`ep_available` and this rank's
    part of every expert stack in ``p``."""
    from repro_torch.models.moe import _apply_scatter, _route
    mesh = sh.active_mesh()
    ax = experts_axis(mesh)
    e0, e_loc, _, f_loc = expert_part(cfg, mesh.index(ax), mesh.size(ax))
    k, d = cfg.moe.top_k, cfg.d_model
    want = (e_loc, d, f_loc)
    if tuple(p["moe_w_in"].shape) != want:
        raise ValueError(
            f"moe_apply_ep: the expert stack is {tuple(p['moe_w_in'].shape)}"
            f", this rank's part is {want}: build the rank's params with "
            "ep_shard_target (or lm_init(expert_part=))")
    b, t, _ = x.shape
    dt = x.dtype
    x2 = x.reshape(b * t, d)

    # routing of every token, replicated: fp32 softmax, top-k,
    # renormalised gates cast to x's dtype (ep.py:60-64)
    gates, idx = _route(p, x2, cfg)
    gates = gates.to(dt)
    rows = sh.active_rows()
    if rows is None:
        # every row here: this rank's run of JAX's fit, gathered back
        axes = sh.batch_axes(b * t, mesh)
        a, z = data_slice(b * t, mesh)
        runs = [(0, z - a)]
    else:
        # this rank's rows of a split batch: each of JAX's runs in them
        assert len(rows[1]) == b, (rows, b)
        axes, a, z = (), 0, b * t
        runs = row_runs(rows[0], rows[1], t, mesh)
    split = z - a < b * t
    if split:
        x2 = _DataRun.apply(x2, a, z, mesh, axes)
        gates = _DataRun.apply(gates, a, z, mesh, axes)
        idx = idx[a:z]
        p = {n: _SumGrad.apply(w, mesh, axes) if n in _STACKS else w
             for n, w in p.items()}
    # the rank's experts over each run at EP's capacity; priority in
    # row-major (token, choice) order over each expert's queue
    xe = _SumGrad.apply(x2, mesh, ax)
    ge = _SumGrad.apply(gates, mesh, ax)
    contrib = torch.cat([_apply_scatter(
        p, xe[s:e], ge[s:e], idx[s:e], ep_capacity(e - s, cfg), cfg,
        (e0, e_loc)) for s, e in runs])
    # the combine in JAX's order and rounding: from zero, a token's pairs
    # added in x's dtype by ascending expert (its loop over the rank's
    # experts), then the ranks' partial sums, in x's dtype
    order = torch.argsort(idx, dim=1, stable=True)
    contrib = contrib.gather(1, order[..., None].expand(-1, -1, d))
    y = torch.zeros_like(x2)
    for j in range(k):
        y = y + contrib[:, j]
    y = _SumOut.apply(y, mesh, ax)
    if split:
        y = _DataGather.apply(y, a, z, mesh, axes)
    return y.reshape(b, t, d)

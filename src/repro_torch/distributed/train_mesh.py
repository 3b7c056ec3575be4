"""Training on the mesh: the SPMD form of JAX's train step inside a mesh
(``repro/launch/steps.py::make_train_step`` under ``use_sharding``,
which pjit partitions by the parameter rules and the model's
``constrain`` sites).

One rank is one shard. A leaf's storage is its slice of
``fit_spec(param_pspec(path, ndim), shape)`` (``sharding.py``), and the
collectives that pjit would insert are made here, as autograd
Functions whose backward makes the reverse collective:

1. ``batch`` -> (``pod``, ``data``): the rank runs its run of the rows
   (``sharding.batch_run``). The loss is JAX's global masked mean: the
   numerator and the mask count are summed over the batch axes apart.
2. ``heads``, ``ffn``, ``vocab`` -> ``model`` (tensor parallelism):
   ``wq``, ``w_in``, ``w_gate`` hold the rank's columns and ``wo``,
   ``w_out`` its rows; the embedding is a masked lookup over the rank's
   vocab rows whose partial sums meet over ``model``; the head holds the
   rank's vocab columns and the cross entropy is vocab-parallel (max,
   sum of exponentials and the label's logit reduced over ``model``), so
   no rank holds the whole ``[B, S, V]`` logits. ``kv_heads`` is None in
   the rules, so ``wk`` / ``wv`` are whole on every rank, which computes
   the KV heads its query heads read.
3. ``act_seq`` -> ``model`` (sequence parallelism, JAX's constraints at
   ``blocks.py:373``, ``:391`` and ``lm.py:135``): the residual stream
   holds the rank's T/m tokens; the sequence is gathered before the
   attention and the MLP and reduce-scattered after their row-parallel
   products; norms run on the rank's tokens; the final norm's output is
   gathered before the head (JAX's logits constraint: sequence whole,
   vocab over ``model``).
4. ``embed_fsdp`` -> ``data`` under ``use_sharding(..., fsdp=True)``:
   a layer's data-sharded leaves are all-gathered in one collective as
   the layer starts (again in its recompute under remat), the embedding
   and the head where they are used; the backward reduce-scatters each
   gradient back to the rank's shard, the data-parallel sum and the
   shard in one collective.
5. After the backward each gradient is summed over the mesh axes along
   which ranks computed different contributions to it and that it is
   not sharded over: :data:`USE_RULES` names the logical axes a leaf's
   use is split over, the leaf's spec the axes it is stored over, and
   :meth:`TrainPlan.grad_axes` takes the one from the other. A leaf that
   every model rank used alike is not summed over ``model``.

The step's collectives go through :class:`CountingMesh`: counted, and
between ranks that share one card exchanged on the card
(``device_exchange.py``), else through gloo.

A forward pass makes its collectives in program order and the autograd
engine runs one graph in one order, so the ranks' collectives pair up.
The scope is passed to the model functions explicitly (captured by a
layer's closure): under remat the recompute runs on the autograd
engine's thread, which sees no thread-local context.

Targets: inside a mesh whose ``model`` axis is above 1, attention blocks
with a dense MLP (global or local, softcaps, post-norms, qk-norm,
biases, tied or untied embeddings) whose head counts, ``d_ff`` and vocab
that axis divides; everything else raises ``NotImplementedError``
(ROADMAP.md queue 1, item 10d). With ``model`` 1 (data parallelism and
FSDP) every target trains.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.device_exchange import DeviceExchange
from repro_torch.models import param as pm

#: where the refusals of this module send the reader
ITEM_TP = "ROADMAP.md queue 1, item 10d"

#: leaf path -> the logical axes its use is split over besides ``batch``
#: (every leaf is used on the rank's rows): the norms between blocks
#: run on the rank's tokens, every attention leaf on its heads, the MLP
#: on its ffn columns, the embedding and the head on its vocab rows
USE_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    (r"(^|/)(ln1|ln2|ln1_post|ln2_post|ln_f)/scale$", ("act_seq",)),
    (r"(^|/)attn/[^/]+$", ("heads",)),
    (r"(^|/)ffn/(w_in|w_gate|w_out)$", ("ffn",)),
    (r"(^|/)embedding$", ("vocab",)),
    (r"(^|/)lm_head$", ("vocab",)),
)


def use_axes(path: str) -> Tuple[str, ...]:
    """The logical axes ``path``'s use is split over (:data:`USE_RULES`),
    ``batch`` first."""
    for pat, axes in USE_RULES:
        if re.search(pat, path):
            return ("batch",) + axes
    return ("batch",)


# ------------------------------------------------------------ collectives --
def _cat(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """[n, ...] parts -> one tensor, the parts concatenated along ``dim``."""
    return stacked.movedim(0, dim).flatten(dim, dim + 1)


def _split(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``t`` cut into ``n`` parts along ``dim``, stacked: [n, ...]."""
    return torch.stack(t.chunk(n, dim))


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axes``; backward: the gradient
    reduce-scattered back (``summed``: summed over the ranks) or, where
    every rank computed the same thing from the whole, cut to the rank's
    part."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, summed):
        ctx.meta = (mesh, axes, dim, summed)
        return _cat(mesh.all_gather(x, axes), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, summed = ctx.meta
        parts = _split(g, mesh.size(axes), dim)
        out = (mesh.reduce_scatter(parts, axes) if summed
               else parts[mesh.index(axes)].clone())
        return out, None, None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` over ``axes`` (the partial sums of a
    row-parallel product, the rank keeping its part); backward: the
    all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return mesh.reduce_scatter(_split(x, mesh.size(axes), dim), axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return _cat(mesh.all_gather(g, axes), dim), None, None, None


class _Sum(torch.autograd.Function):
    """SUM all-reduce over ``axes``; backward: the identity (every rank
    goes on with the same sum, so each owes its part the same
    gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce_(x.clone(), dist.ReduceOp.SUM, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FsdpGather(torch.autograd.Function):
    """Leaves of one dtype all-gathered over ``axis`` in one collective,
    each along its own dim; backward: each gradient reduce-scattered
    back to the rank's shard in one collective (``summed``) or cut to
    it."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, summed, *ts):
        n = mesh.size(axis)
        ctx.meta = (mesh, axis, dims, summed, [t.shape for t in ts])
        every = mesh.all_gather(torch.cat([t.reshape(-1) for t in ts]),
                                axis)
        outs, off = [], 0
        for t, d in zip(ts, dims):
            k = t.numel()
            outs.append(_cat(every[:, off:off + k].reshape(n, *t.shape), d))
            off += k
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis, dims, summed, shapes = ctx.meta
        n = mesh.size(axis)
        buf = torch.cat([_split(g, n, d).reshape(n, -1)
                         for g, d in zip(gs, dims)], 1)
        own = (mesh.reduce_scatter(buf, axis) if summed
               else buf[mesh.index(axis)])
        out, off = [], 0
        for shape in shapes:
            k = shape.numel()
            out.append(own[off:off + k].reshape(shape))
            off += k
        return (None, None, None, None) + tuple(out)


#: calls, bytes this rank sends and (``timed``) host seconds of the
#: training collectives: the sequence, vocab and batch ones and the FSDP
#: gathers and their reduce-scatters, and the gradient all-reduces
GATHERS = sh.PayloadCounter()
SCATTERS = sh.PayloadCounter()
REDUCES = sh.PayloadCounter()


def _count(counter, t):
    counter.bytes += t.numel() * t.element_size()
    return counter.timing(t.device)


class CountingMesh:
    """The train step's view of its :class:`~repro_torch.distributed.
    sharding.Mesh`: its collectives counted in :data:`GATHERS`,
    :data:`SCATTERS` and :data:`REDUCES`, and a CUDA payload of a group
    whose ranks share one card exchanged on the card
    (``device_exchange.py``) instead of through gloo's host path."""

    def __init__(self, mesh: sh.Mesh):
        self.mesh = mesh
        self.exchange = DeviceExchange(mesh)

    def __getattr__(self, name):
        return getattr(self.mesh, name)

    def _on_card(self, t, axis):
        return t.is_cuda and bool(self.mesh._live(axis))

    def _exchange(self, kind, fn, t, axis, *args):
        """``fn`` (the collective on the card, ``device_exchange.py``),
        counted in ``sharding.COLLECTIVES`` as the mesh counts its own;
        None where the exchange does not take it (a CPU or meta payload,
        a group across cards)."""
        if not self._on_card(t, axis):
            return None
        out = fn(t, *args, axis)
        if out is not None:
            sh.count_sent(kind, t, self.mesh.size(self.mesh._live(axis)))
        return out

    def all_gather(self, t, axis):
        with _count(GATHERS, t):
            out = self._exchange("all-gather", self.exchange.all_gather, t,
                                 axis)
            return self.mesh.all_gather(t, axis) if out is None else out

    def reduce_scatter(self, t, axis):
        with _count(SCATTERS, t):
            out = self._exchange("reduce-scatter",
                                 self.exchange.reduce_scatter, t, axis)
            return self.mesh.reduce_scatter(t, axis) if out is None else out

    def all_reduce_(self, t, op, axis):
        with _count(REDUCES, t):
            out = self._exchange("all-reduce", self.exchange.all_reduce_,
                                 t, axis, op)
            return self.mesh.all_reduce_(t, op, axis) if out is None else out


def reset_counters(timed: bool = False):
    for c in (GATHERS, SCATTERS, REDUCES):
        c.reset()
        c.timed = timed


# ------------------------------------------------------------------ plan ---
@dataclasses.dataclass
class TrainPlan:
    """What a rank of ``mesh`` holds and does in a train step of ``cfg``:
    every leaf's :class:`~repro_torch.distributed.sharding.LeafShard`
    (``leaves``, by path; ``shardings``, the tree) from the whole tree's
    shapes, the tensor-parallel axis (``tp_axis``, size ``m``, this
    rank's index ``r`` on it; None and 1 without one), the FSDP axis,
    and the rank's query and KV heads."""
    mesh: CountingMesh
    cfg: object
    shardings: object
    leaves: Dict[str, sh.LeafShard]
    tp_axis: Optional[str]
    m: int
    r: int
    fsdp_axis: Optional[str]
    hq: int            # query heads a rank
    q_lo: int          # its first query head
    hkv: int           # KV heads a rank
    kv_lo: int         # its first KV head

    def fsdp_dim(self, path: str) -> Optional[int]:
        """The dim of ``path`` stored over the FSDP axis, or None."""
        if self.fsdp_axis is None:
            return None
        for d, entry in enumerate(self.leaves[path].spec):
            if self.fsdp_axis in sh.entry_axes(entry):
                return d
        return None

    def _axes(self, logical: Sequence[str], run: sh.BatchRun):
        out = set()
        for name in logical:
            if name == "batch":
                out.update(run.axes)
                continue
            out.update(a for a in sh.entry_axes(sh.logical_to_pspec(
                (name,), self.mesh.mesh)[0]) if self.mesh.size(a) > 1)
        return out

    def grad_axes(self, run: sh.BatchRun) -> Dict[str, Tuple[str, ...]]:
        """Each leaf's all-reduce axes after the backward: the axes its use
        is split over (:func:`use_axes`; ``batch`` as ``run`` splits the
        rows) less those it is stored over (tensor-parallel axes, whose
        parts are the rank's own, and the FSDP axis, whose sum the
        gather's backward made), in mesh order."""
        out = {}
        for path, rec in self.leaves.items():
            ax = self._axes(use_axes(path), run) - set(rec.axes)
            out[path] = tuple(a for a in self.mesh.axis_names
                              if a in ax and self.mesh.size(a) > 1)
        return out

    def reduce_grads(self, grads: Dict[str, torch.Tensor],
                     run: sh.BatchRun) -> Dict[str, torch.Tensor]:
        """``grads`` ({path: this rank's gradient}) summed by
        :meth:`grad_axes`: the leaves of one set of axes and one dtype go
        through one all-reduce, in tree order."""
        table = self.grad_axes(run)
        groups: Dict[tuple, List[str]] = {}
        for path, g in grads.items():
            if table[path]:
                groups.setdefault((table[path], g.dtype), []).append(path)
        out = dict(grads)
        for (axes, _), paths in groups.items():
            buf = torch.cat([grads[p].reshape(-1) for p in paths])
            self.mesh.all_reduce_(buf, dist.ReduceOp.SUM, axes)
            off = 0
            for p in paths:
                k = grads[p].numel()
                out[p] = buf[off:off + k].view(grads[p].shape)
                off += k
        return out


def _tp_axis(mesh: sh.Mesh) -> Optional[str]:
    """The one mesh axis of size > 1 that ``heads``, ``ffn``, ``vocab``
    and ``act_seq`` map to, or None; any other mapping raises."""
    seen = set()
    for name in ("heads", "ffn", "vocab", "act_seq"):
        seen.add(tuple(a for a in sh.entry_axes(
            sh.logical_to_pspec((name,), mesh)[0]) if mesh.size(a) > 1))
    kv = [a for a in sh.entry_axes(sh.logical_to_pspec(("kv_heads",),
                                                       mesh)[0])
          if mesh.size(a) > 1]
    if len(seen) != 1 or len(next(iter(seen))) > 1 or kv:
        raise NotImplementedError(
            "training on the mesh maps heads, ffn, vocab and act_seq to one "
            f"axis and kv_heads to none, as LOGICAL_RULES do ({ITEM_TP})")
    axes = next(iter(seen))
    return axes[0] if axes else None


def check_tp(cfg, m: int):
    """Raise for a target tensor parallelism over ``m`` ranks does not
    cover (:data:`ITEM_TP`)."""
    if m == 1:
        return
    kinds = set(cfg.pattern_for_depth())
    what = None
    if cfg.is_encoder_decoder:
        what = "an encoder-decoder target"
    elif cfg.cross_attn_every:
        what = "a cross-attention target"
    elif cfg.moe is not None:
        what = "a MoE target"
    elif kinds - {"global", "local"}:
        what = f"{sorted(kinds - {'global', 'local'})} layers"
    elif cfg.num_heads % m:
        what = f"{cfg.num_heads} query heads"
    elif cfg.num_kv_heads % m and m % cfg.num_kv_heads:
        what = f"{cfg.num_kv_heads} KV heads"
    elif cfg.d_ff % m:
        what = f"d_ff {cfg.d_ff}"
    elif cfg.vocab_size % m:
        what = f"vocab {cfg.vocab_size}"
    if what is not None:
        raise NotImplementedError(
            f"tensor parallelism over a model axis of {m} covers attention "
            f"targets with a dense MLP whose heads, d_ff and vocab it "
            f"divides, not {what} ({ITEM_TP})")


def make_plan(cfg, mesh: sh.Mesh, whole) -> TrainPlan:
    """The :class:`TrainPlan` of ``cfg`` in ``mesh`` under the active rules
    and fsdp flag; ``whole``: a tree of the whole leaves' shapes (the
    params drawn on the meta device)."""
    tp_axis = _tp_axis(mesh)
    m = mesh.size(tp_axis) if tp_axis else 1
    check_tp(cfg, m)
    fsdp_axis = None
    if sh.fsdp_enabled():
        ax = [a for a in sh.entry_axes(sh.logical_to_pspec(
            ("embed_fsdp",), mesh)[0]) if mesh.size(a) > 1]
        if len(ax) > 1 or (ax and ax[0] == tp_axis):
            raise NotImplementedError(
                f"FSDP over {ax} beside tensor parallelism over {tp_axis} "
                f"({ITEM_TP})")
        fsdp_axis = ax[0] if ax else None
    shardings = sh.params_shardings(whole, mesh)
    r = mesh.index(tp_axis) if tp_axis else 0
    hq = cfg.num_heads // m
    hkv = max(cfg.num_kv_heads // m, 1)
    group = cfg.num_heads // cfg.num_kv_heads
    return TrainPlan(CountingMesh(mesh), cfg, shardings,
                     pm.flatten(shardings), tp_axis, m, r, fsdp_axis,
                     hq, r * hq, hkv, (r * hq) // group)


# ----------------------------------------------------------------- scope ---
@dataclasses.dataclass(frozen=True)
class Scope:
    """A train step's view of the mesh, handed to the model functions:
    its :class:`TrainPlan`, the rank's run of the batch rows, and the
    path ``prefix`` of the tree the model reads (``decoder`` of an
    encoder-decoder)."""
    plan: TrainPlan
    run: sh.BatchRun
    prefix: str = ""

    @property
    def m(self) -> int:
        return self.plan.m

    @property
    def mesh(self):
        return self.plan.mesh

    def _path(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    def within(self, prefix: str) -> "Scope":
        return dataclasses.replace(self, prefix=self._path(prefix))

    # FSDP ---------------------------------------------------------------
    def gather(self, tree, path: str):
        """``tree`` (a leaf or a subtree at ``path``) with its FSDP-sharded
        leaves whole over the FSDP axis, all-gathered in one collective a
        dtype; ``tree`` itself when none is."""
        plan = self.plan
        if plan.fsdp_axis is None:
            return tree
        base = self._path(path)
        flat = pm.flatten(tree)
        full = {k: (f"{base}/{k}" if k else base) for k in flat}
        for k, t in flat.items():
            want = plan.leaves[full[k]].local_shape
            if tuple(t.shape) != want:
                raise ValueError(f"{full[k]}: {tuple(t.shape)} is not this "
                                 f"rank's slice {want}")
        dims = {k: plan.fsdp_dim(full[k]) for k in flat}
        todo = [k for k in flat if dims[k] is not None]
        if not todo:
            return tree
        summed = plan.fsdp_axis in self.run.axes
        out = dict(flat)
        for dtype in sorted({flat[k].dtype for k in todo}, key=str):
            keys = [k for k in todo if flat[k].dtype == dtype]
            got = _FsdpGather.apply(plan.mesh, plan.fsdp_axis,
                                    tuple(dims[k] for k in keys), summed,
                                    *[flat[k] for k in keys])
            out.update(zip(keys, got))
        return out[""] if list(flat) == [""] else pm.unflatten_like(tree,
                                                                   out)

    # sequence and batch ---------------------------------------------------
    def seq_gather(self, x):
        """[B, T/m, ...] -> [B, T, ...] over the tensor-parallel axis."""
        if self.m == 1:
            return x
        return _Gather.apply(x, self.mesh, self.plan.tp_axis, 1, True)

    def seq_scatter(self, x):
        """Partial [B, T, ...] -> the rank's summed [B, T/m, ...]."""
        if self.m == 1:
            return x
        return _Scatter.apply(x, self.mesh, self.plan.tp_axis, 1)

    def rows_whole(self, x):
        """The rank's rows [n, ...] -> the batch's rows [b, ...], all-gathered
        over the batch axes (the MoE FFN, whose capacity JAX fits over the
        whole batch)."""
        if not self.run.split:
            return x
        return _Gather.apply(x, self.mesh, self.run.axes, 0, True)

    def rows_mine(self, x):
        return x[self.run.rows] if self.run.split else x

    def batch_sum(self, x):
        """SUM over the batch axes that split the rows (differentiable)."""
        if not self.run.split:
            return x
        return _Sum.apply(x, self.mesh, self.run.axes)

    # attention heads ------------------------------------------------------
    def head_slices(self, dh: int) -> Tuple[slice, slice]:
        """The columns of the rank's query heads (``wq``, ``bq``) and of the
        KV heads they read (``wk``, ``wv``, ``bk``, ``bv``)."""
        p = self.plan
        return (slice(p.q_lo * dh, (p.q_lo + p.hq) * dh),
                slice(p.kv_lo * dh, (p.kv_lo + p.hkv) * dh))

    # vocab ----------------------------------------------------------------
    def embed(self, w, tokens, dtype):
        """The embedding of ``tokens`` [B, T] at the rank's tokens
        [B, T/m, d]: with a tensor-parallel axis, a masked lookup over the
        rank's vocab rows reduce-scattered over it."""
        w = self.gather(w, "tok/embedding")
        if self.m == 1:
            return w[tokens].to(dtype)
        n = w.shape[0]
        loc = tokens.long() - self.plan.r * n
        ok = (loc >= 0) & (loc < n)
        x = w[loc.clamp(0, n - 1)] * ok[..., None].to(w.dtype)
        return self.seq_scatter(x.to(dtype))

    def token_nll(self, logits, labels, z_loss: float):
        """Per-token NLL (+ ``z_loss * lse^2``) from the rank's vocab
        columns of the logits [.., V/m]: the max, the sum of exponentials
        and the label's logit reduced over the tensor-parallel axis."""
        lf = logits.float()
        n = lf.shape[-1]
        mesh, ax = self.mesh, self.plan.tp_axis
        mx = lf.detach().amax(-1)
        mesh.all_reduce_(mx, dist.ReduceOp.MAX, ax)
        se = _Sum.apply(torch.exp(lf - mx[..., None]).sum(-1), mesh, ax)
        lse = torch.log(se) + mx
        loc = labels.long() - self.plan.r * n
        ok = (loc >= 0) & (loc < n)
        ll = torch.gather(lf, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        ll = _Sum.apply(torch.where(ok, ll, torch.zeros_like(ll)), mesh, ax)
        nll = lse - ll
        return nll + z_loss * torch.square(lse) if z_loss else nll


class _Ctx(threading.local):
    def __init__(self):
        self.scope: Optional[Scope] = None


_CTX = _Ctx()


@contextlib.contextmanager
def train_scope(scope: Optional[Scope]):
    """Make ``scope`` the model's view of the mesh while a train step
    computes its loss (read once a pass, on the caller's thread)."""
    old = _CTX.scope
    _CTX.scope = scope
    try:
        yield
    finally:
        _CTX.scope = old


@contextlib.contextmanager
def within(prefix: str):
    """Inside a train scope, the model reads the subtree at ``prefix``."""
    old = _CTX.scope
    _CTX.scope = None if old is None else old.within(prefix)
    try:
        yield
    finally:
        _CTX.scope = old


def active() -> Optional[Scope]:
    return _CTX.scope


def make_scope(plan: TrainPlan, rows: int, seq: int) -> Scope:
    """The step's :class:`Scope` for a batch of ``rows`` x ``seq`` tokens."""
    if plan.m > 1 and seq % plan.m:
        raise NotImplementedError(
            f"sequence parallelism over {plan.m} ranks needs a sequence it "
            f"divides, not {seq} ({ITEM_TP})")
    return Scope(plan, sh.batch_run(rows, plan.mesh.mesh))

"""Logical-axis rules, the mesh context and the parameter rules (twin of
``repro/distributed/sharding.py``).

Usage, inside every rank of a process group (``launch/mesh.py``)::

    mesh = make_mesh(data=D, model=P)
    with use_sharding(mesh, dict(LOGICAL_RULES, kv_seq="model")):
        ...   # batch rows split over "data", KV sequence over "model"

Outside a ``use_sharding`` context (or with ``mesh=None``) every reader
sees no mesh and the model code runs as on one device. Of the rules
``batch`` (:func:`batch_run`: the rank's run of a wave's rows),
``kv_seq`` (``distributed/spdecode.py``) and ``experts``
(``distributed/ep.py``) are read by decoding; training on the mesh
(``distributed/train_mesh.py``) reads ``heads``, ``ffn``, ``vocab``,
``act_seq`` and ``embed_fsdp``. :func:`logical_to_pspec` and
:func:`fit_spec` are JAX's, on plain tuples of axis names (an entry is
None, one axis name or a tuple of them).

Parameters are placed by path name (JAX's ``_PARAM_RULES``, as they are;
``param_logical_axes``, ``param_pspec``): a leaf's storage on a rank is
its slice of ``fit_spec(param_pspec(path, ndim), shape)`` by the rank's
mesh coordinates (:func:`params_shardings` gives each leaf's
:class:`LeafShard`; :func:`shard_tree` cuts a whole tree into the rank's
slices, :func:`gather_tree` puts the whole leaves back). The port's
paths (``layers/<i>/attn/wq``) have no scanned layer axis, so JAX's
prepended None for it drops out. ``use_sharding(..., fsdp=True)`` maps
``p_embed`` to ``embed_fsdp`` (FSDP).

``constrain`` has no twin: in JAX it is a layout hint with no SPMD
meaning of its own, which pjit turns into collectives; the port makes
those collectives explicitly at the same sites (``train_mesh.py``: the
sequence gather and reduce-scatter around attention and the MLP, the
vocab-parallel reductions, the FSDP gathers). :func:`constrain_params`
cuts a tree to the rank's storage, which is what the train step's
``constrain_params`` means under SPMD.

Rows over the batch axes (SPMD form of JAX's ``P(("pod", "data"))``): a
rank holds only its run of a wave's rows (:class:`BatchRun`), and while
it computes a subset of some batch's rows (:func:`row_subset`), its
random draws take the whole batch's numbers and keep its rows
(``models/param.py``) and expert parallelism fits its tokens as JAX
fits the whole batch's (``ep.py``).

``mesh_tag`` has no twin: in JAX it splits the jit caches between traces
made inside and outside a mesh, and the port has no jit cache to split.

Every collective of a :class:`Mesh` is counted by kind in
:data:`COLLECTIVES` (bytes a rank sends, by JAX's replica-group
factors). On a meta tensor a collective sends nothing and gives a result
of the right shape, so one rank's step traces on the meta device
(``launch/dryrun.py``); a mesh whose groups are
:class:`ShapeOnlyGroup` (``launch/mesh.py::make_production_mesh``
without a process group) takes meta tensors only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# logical axis -> mesh axis (or a tuple of mesh axes, or None = replicate);
# the JAX table as it is ("embed_fsdp" is read only under fsdp=True)
LOGICAL_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",
    "embed": None,
    "vocab": "model",
    "embed_fsdp": "data",
    "heads": "model",
    "kv_heads": None,
    "kv_seq": "model",
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "stage": "pod",
}


Axes = object      # one axis name, or a tuple of them


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a device mesh.

    axis_names / shape: the mesh's axes and their sizes (``devices.shape``
    of a JAX mesh); coords: this rank's index along each axis; groups: the
    process group of each axis through this rank (None for an axis of
    size 1, over which every collective is the identity); multi: the
    process groups over several axes through this rank, by axis tuple in
    mesh order (``make_mesh``: the batch group over ``("pod", "data")``).

    Every method that takes an axis takes one name or a tuple of names:
    the axes of size 1 are left out, and several axes count as one
    flattened axis, the first major (JAX's order in a ``PartitionSpec``
    entry); the tuple of every axis of size > 1 is the whole mesh.
    """
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Optional[object], ...]
    multi: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)

    def _live(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[self.axis_names.index(a)]
                     > 1)

    def size(self, axes: Axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[self.axis_names.index(a)] for a in axes)

    def index(self, axes: Axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in self.axis_names:
            if a in axes:
                j = self.axis_names.index(a)
                i = i * self.shape[j] + self.coords[j]
        return i

    def group(self, axes: Axes):
        live = self._live(axes)
        if not live:
            return None
        if len(live) == 1:
            return self.groups[self.axis_names.index(live[0])]
        if any(isinstance(g, ShapeOnlyGroup) for g in self.groups):
            return ShapeOnlyGroup(live)
        if live == self._live(self.axis_names):
            return dist.group.WORLD
        return self.multi[live]

    def _route(self, kind: str, t: torch.Tensor, axis: Axes):
        """(live axes, their group) of a collective of ``kind`` on ``t``,
        counted in :data:`COLLECTIVES`; the group is None where the
        collective is the identity (no live axis, or a mesh built without
        process groups) and :data:`_META` for a meta tensor, which has no
        data to send: the collective only gives a result of the right
        shape. A real tensor on a shape-only mesh raises."""
        live = self._live(axis)
        if not live:
            return live, None
        if t.device.type == "meta":
            count_sent(kind, t, self.size(live))
            return live, _META
        grp = self.group(live)
        if isinstance(grp, ShapeOnlyGroup):
            raise RuntimeError(
                "a shape-only mesh (launch/mesh.py::make_production_mesh "
                "without a process group) runs collectives on meta tensors "
                f"only, not on {t.device.type} ones")
        if grp is not None:
            count_sent(kind, t, self.size(live))
        return live, grp

    def all_reduce_(self, t: torch.Tensor, op, axis: Axes) -> torch.Tensor:
        """``t`` reduced over ``axis`` by ``op`` (a ``dist.ReduceOp``), in
        place. A CUDA tensor travels through a pinned host buffer: gloo
        reduces on the host either way, and the staging is explicit."""
        _, grp = self._route("all-reduce", t, axis)
        if grp is None or grp is _META:
            return t
        if t.device.type == "cpu":
            dist.all_reduce(t, op=op, group=grp)
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, op=op, group=grp)
        return t.copy_(host)

    def all_gather(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, stacked in rank order on a new
        leading axis (on ``t``'s device; staged through the host)."""
        live, grp = self._route("all-gather", t, axis)
        if grp is None:
            return t[None]
        n = self.size(live)
        if grp is _META:
            return t.new_empty((n,) + tuple(t.shape))
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=grp)
        return torch.stack(parts).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """``t`` holds a slot for each rank along ``axis`` on its leading
        axis (in rank order); returns this rank's slot summed over the
        ranks (staged through pinned host memory, on ``t``'s device)."""
        _, grp = self._route("reduce-scatter", t, axis)
        if grp is None:
            return t[0]
        if grp is _META:
            return t.new_empty(tuple(t.shape[1:]))
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t.detach())
        out = torch.empty_like(host[0])
        dist.reduce_scatter(out, list(host.unbind(0)), group=grp)
        return out.to(t.device)


#: the group :meth:`Mesh._route` gives a meta tensor
_META = object()


class ShapeOnlyGroup:
    """The process group of an axis of a mesh that no process group backs
    (``launch/mesh.py::make_production_mesh`` traced on one process): its
    collectives take meta tensors only."""

    def __init__(self, axes: Tuple[str, ...]):
        self.axes = axes

    def __repr__(self):
        return f"ShapeOnlyGroup({self.axes})"


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, object] = dict(LOGICAL_RULES)
        self.fsdp: bool = False
        # (rows of the whole batch, this rank's rows among them)
        self.rows: Optional[Tuple[int, Tuple[int, ...]]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh: Optional[Mesh],
                 rules: Optional[Dict[str, object]] = None,
                 fsdp: bool = False):
    """Make ``mesh`` and ``rules`` this thread's sharding context; with
    ``fsdp`` the parameters' embed dims go over ``embed_fsdp``."""
    old = (_CTX.mesh, _CTX.rules, _CTX.fsdp)
    _CTX.mesh = mesh
    _CTX.rules = dict(rules) if rules is not None else dict(LOGICAL_RULES)
    _CTX.fsdp = fsdp
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.fsdp = old


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def fsdp_enabled() -> bool:
    return _CTX.fsdp


def active_rules() -> Dict[str, object]:
    return _CTX.rules


def mesh_axis(logical: str, mesh: Optional[Mesh] = None) -> Optional[str]:
    """The mesh axis the active rules map ``logical`` to (the first of a
    tuple), or None without a mesh or when that axis is not in it.
    ``mesh``: this mesh instead of the active one."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    ax = _CTX.rules.get(logical)
    if isinstance(ax, (tuple, list)):
        ax = ax[0] if ax else None
    if ax is None or ax not in mesh.axis_names:
        return None
    return ax


def logical_to_pspec(logical: Sequence[Optional[str]],
                     mesh: Optional[Mesh] = None,
                     rules: Optional[Dict[str, object]] = None
                     ) -> Tuple[object, ...]:
    """Map a tuple of logical axis names to a partition spec for ``mesh``
    (JAX's ``logical_to_pspec``, a plain tuple for a ``PartitionSpec``):
    mesh axes absent from the mesh are dropped (``pod`` on a 2-D mesh),
    and so is an axis an earlier entry already took."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    avail = set(mesh.axis_names) if mesh is not None else set()
    out, used = [], set()
    for name in logical:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        keep = tuple(a for a in axes if a in avail and a not in used)
        used.update(keep)
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else keep)
    return tuple(out)


def fit_spec(spec: Sequence[object], shape: Sequence[int],
             mesh: Mesh) -> Tuple[object, ...]:
    """``spec`` with the mesh axes dropped where the dim is not divisible
    (JAX's ``fit_spec``: batch 1 on a data axis of 2 is replicated); of a
    tuple entry each axis is kept while the product so far divides."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep, prod = [], 1
        for a in axes:
            if shape[d] % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return tuple(out)


def batch_axes(n: int, mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """The batch axes that split a dim of ``n`` rows (or flattened
    tokens): the mesh axes of the ``batch`` rule (``pod``, then ``data``)
    that are in the mesh, each kept while it divides ``n`` (JAX's
    ``fit_spec(logical_to_pspec(("batch",)))``), first major."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    entry = fit_spec(logical_to_pspec(("batch",), mesh), (n,), mesh)[0]
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else entry)


@dataclasses.dataclass(frozen=True)
class BatchRun:
    """This rank's run of a wave's ``b`` rows: rows ``[lo, lo + n)``, the
    run of its flattened (pod, data) index over ``axes`` (the batch axes
    that split ``b``; every rank holds every row when none does)."""
    b: int
    lo: int
    n: int
    axes: Tuple[str, ...] = ()

    @property
    def split(self) -> bool:
        return self.n < self.b

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.lo + self.n)


def batch_run(b: int, mesh: Optional[Mesh] = None) -> BatchRun:
    """This rank's :class:`BatchRun` of ``b`` rows in ``mesh`` (default the
    active one; without a mesh, every row)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    axes = batch_axes(b, mesh)
    if not axes:
        return BatchRun(b, 0, b)
    n = b // mesh.size(axes)
    return BatchRun(b, mesh.index(axes) * n, n, axes)


def batch_shards(mesh: Optional[Mesh] = None) -> int:
    """The product of the mesh's batch axes (1 without a mesh): how many
    runs a wave's rows split into when they all divide it."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return 1
    axes = logical_to_pspec(("batch",), mesh)[0]
    if axes is None:
        return 1
    return mesh.size(axes)


@contextlib.contextmanager
def row_subset(total: int, keep: Sequence[int]):
    """While inside, this rank computes rows ``keep`` (positions, in
    order) of a batch of ``total`` rows that the batch group computes
    together: random draws take every row's numbers and keep these
    (``models/param.py``), expert parallelism fits its tokens over the
    whole batch as JAX does (``ep.py``)."""
    old = _CTX.rows
    _CTX.rows = (int(total), tuple(int(i) for i in keep))
    try:
        yield
    finally:
        _CTX.rows = old


def active_rows() -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(rows of the batch, this rank's positions among them) inside
    :func:`row_subset`, else None."""
    return _CTX.rows


class PayloadCounter:
    """Calls, bytes this rank sends and (``timed``: each timed on the host
    after a device synchronize) seconds of a kind of collective, counted
    at every call."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0
        self.timed = False
        self.merge_s = 0.0

    def reset(self):
        self.calls = self.bytes = 0
        self.merge_s = 0.0

    @contextlib.contextmanager
    def timing(self, device):
        """Count one call; with ``timed`` add its host seconds."""
        if self.timed and device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        self.calls += 1
        yield
        if self.timed:
            self.merge_s += time.perf_counter() - t0


#: the pool-write gathers of a batch-split wave (``core/state.py``): one
#: a cycle and one an install, the count exchange and the payload
WRITES = PayloadCounter()
#: the gathers of a batch-split cycle's per-row host results and of the
#: install anchors (``core/pipeline.py``, ``serving/engine.py``)
RESULTS = PayloadCounter()

#: every collective of a :class:`Mesh`, by kind (JAX's HLO names): calls
#: and the bytes this rank sends in a ring over the group's ``n`` ranks
#: (:func:`count_sent`), on real and meta tensors alike, so that a
#: shape-only trace (``roofline/trace_analysis.py``) and a real run
#: count the same
COLLECTIVES: Dict[str, PayloadCounter] = {
    k: PayloadCounter() for k in ("all-reduce", "all-gather",
                                  "reduce-scatter")}

#: bytes a rank sends a byte of the collective's operand, over ``n``
#: ranks: JAX's replica-group factors (``roofline/hlo_analysis.py``),
#: all-reduce 2(n-1)/n, all-gather and reduce-scatter (n-1)/n of the
#: whole buffer (an all-gather's result is n operands; a reduce-scatter's
#: operand is the whole buffer, where JAX's HLO reading applies the
#: factor to its result, one rank's slot)
_SENT = {"all-reduce": lambda n: 2.0 * (n - 1) / n,
         "all-gather": lambda n: float(n - 1),
         "reduce-scatter": lambda n: (n - 1) / n}


def count_sent(kind: str, t: torch.Tensor, n: int):
    """Count one collective of ``kind`` over ``n`` ranks on operand ``t``
    in :data:`COLLECTIVES`."""
    c = COLLECTIVES[kind]
    c.calls += 1
    c.bytes += _SENT[kind](n) * t.numel() * t.element_size()


def reset_collectives():
    for c in COLLECTIVES.values():
        c.reset()


def collective_counts() -> Dict[str, Dict[str, float]]:
    """{kind: {"calls", "bytes"}} of :data:`COLLECTIVES`."""
    return {k: {"calls": c.calls, "bytes": c.bytes}
            for k, c in COLLECTIVES.items()}


def gather_rows(t: torch.Tensor, run: BatchRun) -> torch.Tensor:
    """Every run's rows of ``t`` (leading axis: this rank's ``run.n``
    rows), all-gathered over the run's batch axes into the wave's ``b``
    rows; ``t`` itself when the rows are not split. Counted in
    :data:`RESULTS`."""
    if not run.split:
        return t
    with RESULTS.timing(t.device):
        RESULTS.bytes += t.numel() * t.element_size()
        return _CTX.mesh.all_gather(t, run.axes).flatten(0, 1)


# ---------------------------------------------------------------------------
# Parameter sharding by path name (JAX's table and naming convention):
#   embedding -> (vocab, embed*); lm_head -> (embed*, vocab)
#   attn/wq -> (embed*, heads); attn/wk, attn/wv -> (embed*, kv_heads)
#   attn/wo -> (heads, embed*); mlp w_in / w_gate -> (embed*, ffn)
#   w_out -> (ffn, embed*); moe stacks -> (experts, embed*, expert_ffn)
#   norms, biases and anything unnamed -> replicated
# embed* is "embed_fsdp" under fsdp=True (params only). A leaf of more
# dims than its rule gets None prepended (JAX's scanned layer axis, the
# optimizer's stacked periods).
# ---------------------------------------------------------------------------

_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # --- decoding state (caches) ---
    (r"(^|/)(k|v)$", ("batch", "kv_seq", "kv_heads_p", None)),
    (r"(^|/)(ck|cv)$", ("batch", None, "kv_heads_p", None)),
    (r"tm_s$", ("batch", "heads", None, None)),
    (r"(rg_h)$", ("batch", "ffn")),
    (r"(conv_buf)$", ("batch", None, "ffn")),
    (r"(tm_x_prev|cm_x_prev)$", ("batch", None)),
    (r"length$", ("batch",)),
    # --- RWKV time/channel mix (before generic wk/wv rules) ---
    (r"rwkv_tm/(wr|wk|wv|wg)$", ("p_embed", "heads")),
    (r"rwkv_tm/wo$", ("heads", "p_embed")),
    (r"rwkv_tm/w_lora_b$", (None, "heads")),
    (r"rwkv_cm/wk$", ("p_embed", "ffn")),
    (r"rwkv_cm/wv$", ("ffn", "p_embed")),
    (r"rwkv_cm/wr$", ("p_embed", "p_embed")),
    # --- RG-LRU ---
    (r"(w_branch)$", ("p_embed", "ffn")),
    (r"(wa|wx)$", ("p_embed", "ffn")),
    (r"conv_w$", (None, "ffn")),
    # --- embeddings / heads ---
    (r"embedding$", ("vocab", "p_embed")),
    (r"lm_head$", ("p_embed", "vocab")),
    (r"head$", ("p_embed", "vocab")),
    # --- attention / MLP ---
    (r"(wq|wqkv)$", ("p_embed", "heads")),
    (r"(wk|wv)$", ("p_embed", "kv_heads_p")),
    (r"wo$", ("heads", "p_embed")),
    (r"(w_in|w_gate|w_up)$", ("p_embed", "ffn")),
    (r"w_out$", ("ffn", "p_embed")),
    (r"moe_w_(in|gate)$", ("experts", "p_embed", "expert_ffn")),
    (r"moe_w_out$", ("experts", "expert_ffn", "p_embed")),
    (r"router$", ("p_embed", None)),
    (r"feat_proj$", ("p_embed", "p_embed")),
)

# parameter-only logical axes
_PARAM_AXES = {
    "p_embed": lambda: "embed_fsdp" if _CTX.fsdp else None,
    "kv_heads_p": lambda: "kv_heads",
}


def _resolve_param_axes(axes: Sequence[Optional[str]]
                        ) -> Tuple[Optional[str], ...]:
    return tuple(_PARAM_AXES[a]() if a in _PARAM_AXES else a for a in axes)


def param_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of a parameter or state leaf from its '/'-joined path
    and rank. Optimizer-state suffixes map onto the base parameter's
    axes: Adafactor row stats (/vr) drop the last axis, column stats (/vc)
    the second-to-last; int8 moments (/q) inherit, their scales (/s)
    replicate."""
    stat = None
    for suffix in ("/vr", "/vc", "/q", "/s"):
        if path.endswith(suffix):
            stat = suffix[1:]
            path = path[: -len(suffix)]
            break
    if stat == "s":
        return (None,) * ndim

    def base_axes(nd):
        for pat, axes in _PARAM_RULES:
            if re.search(pat, path):
                axes = _resolve_param_axes(axes)
                if nd == len(axes):
                    return axes
                if nd > len(axes):
                    return (None,) * (nd - len(axes)) + axes
                return axes[-nd:] if nd > 0 else ()
        return (None,) * nd

    if stat == "vr":
        return base_axes(ndim + 1)[:-1]
    if stat == "vc":
        ax = base_axes(ndim + 1)
        return ax[:-2] + ax[-1:]
    return base_axes(ndim)


def param_pspec(path: str, ndim: int,
                mesh: Optional[Mesh] = None) -> Tuple[object, ...]:
    return logical_to_pspec(param_logical_axes(path, ndim), mesh)


def tree_paths(tree) -> Dict[str, object]:
    """A tree flattened into {'/'.join(path): leaf} (dict keys sorted, list
    entries by index, as ``models.param.flatten``)."""
    from repro_torch.models import param as pm
    return pm.flatten(tree)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one partition-spec entry (None, a name or a
    tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry_index(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's flattened index over ``axes`` in their order, first
    major; their product)."""
    i, n = 0, 1
    for a in axes:
        j = mesh.axis_names.index(a)
        i = i * mesh.shape[j] + mesh.coords[j]
        n *= mesh.shape[j]
    return i, n


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Where a leaf lives on this rank: the whole leaf's ``shape``, the
    fitted partition ``spec`` and this rank's slice of it (``index``, one
    slice a dim)."""
    shape: Tuple[int, ...]
    spec: Tuple[object, ...]
    index: Tuple[slice, ...]

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index)

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the leaf is sharded over."""
        return tuple(a for e in self.spec for a in entry_axes(e))

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t``, as a copy of its own
        (a replicated leaf: ``t`` itself)."""
        if self.local_shape == self.shape:
            return t
        return t[self.index].clone()


def leaf_shard(path: str, shape: Sequence[int],
               mesh: Optional[Mesh] = None) -> LeafShard:
    """The :class:`LeafShard` of a leaf of whole ``shape`` at ``path``."""
    mesh = mesh if mesh is not None else _CTX.mesh
    shape = tuple(int(n) for n in shape)
    spec = fit_spec(param_pspec(path, len(shape), mesh), shape, mesh)
    index = []
    for n, entry in zip(shape, spec):
        i, parts = _entry_index(mesh, entry_axes(entry))
        step = n // parts
        index.append(slice(i * step, (i + 1) * step))
    return LeafShard(shape, spec, tuple(index))


def params_shardings(params, mesh: Optional[Mesh] = None):
    """A :class:`LeafShard` for every leaf of a tree of whole leaves
    (params, optimizer states; anything with a ``shape``), in the tree's
    structure (JAX's ``params_shardings``, whose NamedShardings become
    the rank's slices)."""
    from repro_torch.models import param as pm
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("params_shardings needs a mesh")
    flat = pm.flatten(params)
    return pm.unflatten_like(params, {
        k: leaf_shard(k, tuple(v.shape), mesh) for k, v in flat.items()})


def shard_tree(full, mesh: Optional[Mesh] = None):
    """This rank's slices of a tree of whole leaves: copies of the sharded
    leaves, the replicated ones as they are."""
    from repro_torch.models import param as pm
    recs = pm.flatten(params_shardings(full, mesh))
    return pm.unflatten_like(full, {k: recs[k].take(v)
                                    for k, v in pm.flatten(full).items()})


def gather_tree(sharded, shardings, mesh: Optional[Mesh] = None):
    """The whole leaves of a tree of this rank's slices (``shardings``:
    :func:`params_shardings` of the whole tree), all-gathered over each
    sharded dim's axes in turn; every rank gets every leaf. Collective:
    every rank of the mesh calls it on the same tree."""
    from repro_torch.models import param as pm
    mesh = mesh if mesh is not None else _CTX.mesh
    recs = pm.flatten(shardings)
    out = {}
    for k, t in pm.flatten(sharded).items():
        rec = recs[k]
        if tuple(t.shape) != rec.local_shape:
            raise ValueError(f"{k}: {tuple(t.shape)} is not this rank's "
                             f"slice {rec.local_shape} of {rec.shape}")
        for d, entry in enumerate(rec.spec):
            axes = entry_axes(entry)
            if axes:
                t = mesh.all_gather(t, axes).movedim(0, d).flatten(d, d + 1)
        out[k] = t
    return pm.unflatten_like(sharded, out)


def _gathered(t: torch.Tensor, d: int, every: torch.Tensor) -> torch.Tensor:
    """``every`` [n, *t.shape] (each rank's slice in rank order) joined
    along ``t``'s dim ``d``."""
    return every.movedim(0, d).flatten(d, d + 1).contiguous()


# ---------------------------------------------------------------------------
# Serving storage: a rank keeps its slice of every weight by the parameter
# rules and makes one subtree whole at its use (JAX's serving cells put the
# weights at ``params_shardings`` and GSPMD gathers what a layer reads).
# ---------------------------------------------------------------------------

#: the serving weight gathers (:meth:`ServeLayout.gather`): calls, bytes a
#: rank receives (the whole less its own slice) and, ``timed``, host seconds
WEIGHTS = PayloadCounter()

#: each mesh's exchange buffers on the card (``device_exchange.py``), made
#: at its first CUDA gather of serving storage
_EXCHANGES: Dict[Mesh, object] = {}


def card_all_gather(mesh: Mesh, t: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's ``t`` over ``axes``, stacked in rank order: a CUDA
    tensor of a group whose ranks share one card through CUDA IPC
    (``device_exchange.py``, counted in :data:`COLLECTIVES` as the mesh
    counts its own), anything else through :meth:`Mesh.all_gather`."""
    live = mesh._live(axes)
    if t.is_cuda and live:
        if mesh not in _EXCHANGES:
            from repro_torch.distributed.device_exchange import \
                DeviceExchange
            _EXCHANGES[mesh] = DeviceExchange(mesh)
        out = _EXCHANGES[mesh].all_gather(t, live)
        if out is not None:
            count_sent("all-gather", t, mesh.size(live))
            return out
    return mesh.all_gather(t, live)


class ServeLayout:
    """Where each leaf of a serving tree lives on this rank of ``mesh``: its
    :class:`LeafShard` by path (the tree's own paths). :meth:`gather` makes
    a subtree whole; ranks on one card exchange through CUDA IPC
    (``device_exchange.py``), others through the mesh's gloo collectives,
    each counted in :data:`COLLECTIVES` and :data:`WEIGHTS`."""

    def __init__(self, mesh: Mesh, leaves: Dict[str, LeafShard]):
        self.mesh = mesh
        self.leaves = leaves

    @property
    def cut(self) -> bool:
        """Whether any leaf is stored as a slice."""
        return any(r.local_shape != r.shape for r in self.leaves.values())

    def _all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        n = self.mesh.size(self.mesh._live(axes))
        with WEIGHTS.timing(t.device):
            WEIGHTS.bytes += (n - 1) * t.numel() * t.element_size()
            return card_all_gather(self.mesh, t, axes)

    def gather(self, sub, path: str):
        """``sub`` (a leaf or the subtree at ``path``) with every leaf
        whole: each sharded dim all-gathered in turn, the leaves of one
        dtype and axes in one collective. Collective: every rank of the
        mesh calls it at the same point. ``sub`` itself when no leaf of it
        is a slice."""
        from repro_torch.models import param as pm
        flat = pm.flatten(sub)
        todo = {}
        for k, t in flat.items():
            full = f"{path}/{k}" if k else path
            rec = self.leaves[full]
            if tuple(t.shape) != rec.local_shape:
                raise ValueError(f"{full}: {tuple(t.shape)} is not this "
                                 f"rank's slice {rec.local_shape}")
            dims = [(d, entry_axes(e)) for d, e in enumerate(rec.spec)
                    if rec.local_shape[d] != rec.shape[d]]
            if dims:
                todo[k] = dims
        if not todo:
            return sub
        out = dict(flat)
        while todo:
            groups: Dict[tuple, list] = {}
            for k, dims in todo.items():
                d, axes = dims[0]
                groups.setdefault((axes, out[k].dtype), []).append((k, d))
            for (axes, _), items in groups.items():
                ts = [out[k] for k, _ in items]
                every = self._all_gather(
                    torch.cat([t.reshape(-1) for t in ts]), axes)
                off = 0
                for (k, d), t in zip(items, ts):
                    m = t.numel()
                    out[k] = _gathered(t, d, every[:, off:off + m].reshape(
                        -1, *t.shape))
                    off += m
            todo = {k: dims[1:] for k, dims in todo.items() if len(dims) > 1}
        return out[""] if list(flat) == [""] else pm.unflatten_like(sub, out)


class Stored(dict):
    """A tree (a dict) of this rank's serving storage, its
    :class:`ServeLayout` as ``layout``: the model functions make each
    subtree whole at its use (:func:`whole`)."""

    layout: ServeLayout


def serve_layout(tree, mesh: Optional[Mesh] = None,
                 owned: Sequence[Tuple[str, Tuple[str, ...]]] = ()
                 ) -> ServeLayout:
    """The :class:`ServeLayout` of a tree of whole leaves in ``mesh``
    (default the active one) by the active rules (``embed_fsdp`` under
    ``fsdp``): JAX's ``params_shardings``. ``owned``: (path pattern, mesh
    axes) pairs: a leaf whose path the pattern matches is already the
    part of it this rank holds along those axes (a MoE's expert stacks
    under expert parallelism, ``ep.ep_shard_target``: the ranks along
    the experts axis hold different experts), so no dim of it is cut or
    gathered over them."""
    from repro_torch.models import param as pm
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("serve_layout needs a mesh")
    leaves = {}
    for k, v in pm.flatten(tree).items():
        shape = tuple(int(n) for n in v.shape)
        rec = leaf_shard(k, shape, mesh)
        mine = {a for pat, axes in owned if re.search(pat, k) for a in axes}
        if mine and any(mine & set(entry_axes(e)) for e in rec.spec):
            spec = tuple(None if mine & set(entry_axes(e)) else e
                         for e in rec.spec)
            rec = LeafShard(shape, spec, tuple(
                slice(0, n) if e is None else sl
                for n, e, sl in zip(shape, spec, rec.index)))
        leaves[k] = rec
    return ServeLayout(mesh, leaves)


def serve_storage(tree, mesh: Optional[Mesh] = None,
                  owned: Sequence[Tuple[str, Tuple[str, ...]]] = ()
                  ) -> "Stored":
    """This rank's storage of a serving tree of whole leaves (copies of
    its slices; the replicated leaves as they are), as a :class:`Stored`
    that carries its layout. A tree that is already :class:`Stored` is
    returned as it is."""
    from repro_torch.models import param as pm
    if isinstance(tree, Stored):
        return tree
    lay = serve_layout(tree, mesh, owned)
    out = Stored(pm.unflatten_like(tree, {
        k: lay.leaves[k].take(v) for k, v in pm.flatten(tree).items()}))
    out.layout = lay
    return out


def whole(tree, sub, path: str):
    """``sub``, the subtree at ``path`` of ``tree``, made whole when
    ``tree`` holds a rank's serving storage (:class:`Stored`); ``sub``
    itself otherwise."""
    lay = getattr(tree, "layout", None)
    return sub if lay is None else lay.gather(sub, path)


def constrain_params(params, shardings=None):
    """Each leaf as this rank's storage (JAX's ``constrain_params``, which
    constrains each leaf to its rule-derived sharding): a whole leaf is
    cut to the rank's slice, a leaf already of the slice's shape is kept.
    ``shardings``: the whole tree's :func:`params_shardings` (default: the
    leaves given are whole). The tree itself outside a mesh."""
    from repro_torch.models import param as pm
    if _CTX.mesh is None:
        return params
    if shardings is None:
        shardings = params_shardings(params)
    recs = pm.flatten(shardings)
    out = {}
    for k, t in pm.flatten(params).items():
        rec = recs[k]
        if tuple(t.shape) == rec.local_shape:
            out[k] = t
        elif tuple(t.shape) == rec.shape:
            out[k] = rec.take(t)
        else:
            raise ValueError(f"{k}: {tuple(t.shape)} is neither the whole "
                             f"leaf {rec.shape} nor this rank's slice "
                             f"{rec.local_shape}")
    return pm.unflatten_like(params, out)

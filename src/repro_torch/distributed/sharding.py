"""Logical-axis rules and the mesh context (twin, in part, of
``repro/distributed/sharding.py``).

Usage, inside every rank of a process group (``launch/mesh.py``)::

    mesh = make_mesh(data=D, model=P)
    with use_sharding(mesh, dict(LOGICAL_RULES, kv_seq="model")):
        ...   # batch rows split over "data", KV sequence over "model"

Outside a ``use_sharding`` context (or with ``mesh=None``) every reader
sees no mesh and the model code runs as on one device. Of the rules
``batch`` (:func:`batch_run`: the rank's run of a wave's rows),
``kv_seq`` (``distributed/spdecode.py``) and ``experts``
(``distributed/ep.py``) are read. :func:`logical_to_pspec` and
:func:`fit_spec` are JAX's, on plain tuples of axis names (an entry is
None, one axis name or a tuple of them). The parameter rules
(``param_pspec``, ``params_shardings``, ``constrain``) are ROADMAP.md
queue 1, item 10.

Rows over the batch axes (SPMD form of JAX's ``P(("pod", "data"))``): a
rank holds only its run of a wave's rows (:class:`BatchRun`), and while
it computes a subset of some batch's rows (:func:`row_subset`), its
random draws take the whole batch's numbers and keep its rows
(``models/param.py``) and expert parallelism fits its tokens as JAX
fits the whole batch's (``ep.py``).

``mesh_tag`` has no twin: in JAX it splits the jit caches between traces
made inside and outside a mesh, and the port has no jit cache to split.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# logical axis -> mesh axis (or a tuple of mesh axes, or None = replicate);
# the JAX table as it is, of which the port reads ``batch``, ``kv_seq``
# and ``experts``
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
        if live == self._live(self.axis_names):
            return dist.group.WORLD
        return self.multi[live]

    def all_reduce_(self, t: torch.Tensor, op, axis: Axes) -> torch.Tensor:
        """``t`` reduced over ``axis`` by ``op`` (a ``dist.ReduceOp``), in
        place. A CUDA tensor travels through a pinned host buffer: gloo
        reduces on the host either way, and the staging is explicit."""
        grp = self.group(axis)
        if grp is None:
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
        grp = self.group(axis)
        if grp is None:
            return t[None]
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.size(
            self._live(axis)))]
        dist.all_gather(parts, host, group=grp)
        return torch.stack(parts).to(t.device)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, object] = dict(LOGICAL_RULES)
        # (rows of the whole batch, this rank's rows among them)
        self.rows: Optional[Tuple[int, Tuple[int, ...]]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh: Optional[Mesh],
                 rules: Optional[Dict[str, object]] = None):
    """Make ``mesh`` and ``rules`` this thread's sharding context."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = dict(rules) if rules is not None else dict(LOGICAL_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


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

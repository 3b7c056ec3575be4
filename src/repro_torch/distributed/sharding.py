"""Logical-axis rules and the mesh context (twin, in part, of
``repro/distributed/sharding.py``).

Usage, inside every rank of a process group (``launch/mesh.py``)::

    mesh = make_mesh(data=1, model=P)
    with use_sharding(mesh, dict(LOGICAL_RULES, kv_seq="model")):
        ...   # the decode reads shard the KV sequence over "model"

Outside a ``use_sharding`` context (or with ``mesh=None``) every reader
sees no mesh and the model code runs as on one device. Of the rules
``kv_seq`` (``distributed/spdecode.py``) and ``experts``
(``distributed/ep.py``) are read; the batch fit of expert parallelism
lives in ``ep.py``, as in JAX. The parameter rules (``param_pspec``,
``params_shardings``, ``constrain``, ``fit_spec``) are ROADMAP.md queue
1, item 10, and a data axis above 1 is refused by the callers that
cannot split their rows over it yet (:func:`refuse_data_axis`, item 9a).

``mesh_tag`` has no twin: in JAX it splits the jit caches between traces
made inside and outside a mesh, and the port has no jit cache to split.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# logical axis -> mesh axis (or a tuple of mesh axes, or None = replicate);
# the JAX table as it is, of which the port reads ``kv_seq`` and ``experts``
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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a device mesh.

    axis_names / shape: the mesh's axes and their sizes (``devices.shape``
    of a JAX mesh); coords: this rank's index along each axis; groups: the
    process group of each axis through this rank (None for an axis of
    size 1, over which every collective is the identity).
    """
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Optional[object], ...]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]

    def all_reduce_(self, t: torch.Tensor, op, axis: str) -> torch.Tensor:
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

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, stacked in rank order on a new
        leading axis (on ``t``'s device; staged through the host)."""
        grp = self.group(axis)
        if grp is None:
            return t[None]
        host = t.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.size(axis))]
        dist.all_gather(parts, host, group=grp)
        return torch.stack(parts).to(t.device)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, object] = dict(LOGICAL_RULES)


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


def refuse_data_axis(what: str) -> None:
    """Raise ``NotImplementedError`` inside a mesh whose ``data`` axis is
    larger than 1: ``what`` cannot split its rows over that axis yet."""
    mesh = _CTX.mesh
    if mesh is not None and "data" in mesh.axis_names \
            and mesh.size("data") > 1:
        raise NotImplementedError(
            f"{what} inside a mesh with data={mesh.size('data')}: batch "
            "rows over a data axis are not ported for it (ROADMAP.md "
            "queue 1, item 9a: the engine's data axis, whose page pool is "
            "replicated over data)")

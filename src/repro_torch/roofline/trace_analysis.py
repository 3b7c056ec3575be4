"""One cell's per-rank counts from a shape-only trace (stands for
``repro/roofline/hlo_analysis.py``, which reads XLA's HLO text: the port
has no HLO, so it counts the same things while the step runs on the meta
device, ``launch/dryrun.py``).

:func:`trace_counts` runs ``fn(*args)`` on meta tensors and returns:

* ``flops``: the FLOPs of the rank's program by
  ``torch.utils.flop_counter.FlopCounterMode`` (products: 2 x result x
  contraction, as the HLO reading counts a ``dot``; the backward's and a
  remat recompute's products are counted where they run);
* the collectives by kind, ``all-reduce``, ``all-gather``,
  ``reduce-scatter`` (calls and bytes a rank sends, ``coll_bytes`` their
  sum), from ``sharding.COLLECTIVES``, which a real run feeds alike;
* ``temp_peak_bytes``: the high-water mark of the storage that the trace
  makes and holds at once, beside the arguments' (:class:`LiveBytes`);
* ``kernels``: the plain calls made for each kernel wrapper
  (``kernels/trace.py``): how often the traced path would launch each.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import trace as ktrace


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (a view
    and its base count once)."""
    seen = {}
    for tree in trees:
        for t in _tensors(tree):
            seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _tensors(tree):
    """The tensors in ``tree``: nested dicts, lists, tuples and
    dataclasses (a ``SpecBundle``, an ``EngineState``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class LiveBytes(TorchDispatchMode):
    """Every storage an op makes is counted while a tensor the trace made
    on it lives (the tensors' finalizers; autograd's saved tensors keep
    theirs alive); ``peak`` is the most held at once. Storages of the
    arguments (``exclude``) are not counted: they are the arguments'."""

    def __init__(self, *exclude):
        super().__init__()
        self.skip = {_key(t) for tree in exclude for t in _tensors(tree)}
        self.refs: Dict[int, int] = {}       # storage -> live tensors on it
        self.size: Dict[int, int] = {}
        self.seen = set()                    # ids of tracked tensors
        self.live = 0
        self.peak = 0

    def _drop(self, k: int, tid: int):
        self.seen.discard(tid)
        self.refs[k] -= 1
        if self.refs[k] == 0:
            del self.refs[k]
            self.live -= self.size.pop(k)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if not isinstance(t, torch.Tensor) or id(t) in self.seen:
                continue
            k = _key(t)
            if k in self.skip:
                continue
            if k not in self.refs:
                self.refs[k] = 0
                self.size[k] = t.untyped_storage().nbytes()
                self.live += self.size[k]
                self.peak = max(self.peak, self.live)
            self.refs[k] += 1
            self.seen.add(id(t))
            weakref.finalize(t, self._drop, k, id(t))
        return out


def trace_counts(fn, *args) -> Dict[str, object]:
    """Run ``fn(*args)`` (meta tensors, inside the active mesh) and count
    it; see the module docstring. The result of ``fn`` is dropped."""
    sh.reset_collectives()
    flops = FlopCounterMode(display=False)
    with ktrace.plain_on_meta() as traced:
        live = LiveBytes(*args)
        with flops, live:
            fn(*args)
        kernels = dict(traced)
    colls = sh.collective_counts()
    return {
        "flops": float(flops.get_total_flops()),
        "flops_by_op": {str(k): float(v) for k, v in
                        flops.get_flop_counts().get("Global", {}).items()},
        **{k: float(v["bytes"]) for k, v in colls.items()},
        "coll_calls": {k: v["calls"] for k, v in colls.items()},
        "coll_bytes": float(sum(v["bytes"] for v in colls.values())),
        "temp_peak_bytes": int(live.peak),
        "kernels": kernels,
    }


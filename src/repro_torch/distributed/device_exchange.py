"""Collectives among ranks that share one card, through CUDA IPC.

The mesh's collectives go through gloo, which stages a CUDA payload
through host memory (``sharding.Mesh``). When every rank of a group runs
on the same card (``launch/mesh.py`` puts each rank on device 0), a
payload need not leave the card: each rank keeps one exchange buffer a
group on the card, its peers map it once (its CUDA IPC handle is shared
with ``all_gather_object``), and a collective is

1. the rank copies its payload into its own buffer and synchronizes;
2. the group meets at a gloo barrier (a few bytes);
3. every rank reads what it needs from its peers' buffers with device
   copies (an all-gather takes every slot, a reduce-scatter sums its own
   slot of every buffer, an all-reduce sums every buffer), and
   synchronizes;
4. the group meets again, so that no buffer is written anew before its
   peers have read it.

A payload over ``ROUND_BYTES`` goes in rounds of that many bytes.

Before a rank leaves, :func:`close_all` drops every peer buffer it maps
and meets each group at a barrier, so that no rank's process ends while a
peer still maps its buffer.

Sums run in rank order on every rank, in fp32 for a half-precision
payload, so every rank gets the same bits. :class:`DeviceExchange`
decides per group, at the group's first CUDA collective, whether its
ranks share a card (the device UUIDs, exchanged once); a group across
cards, and every CPU payload, goes through the mesh's gloo collectives.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import weakref

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import reduce_tensor


#: the most payload a rank's buffer holds: a larger collective runs in
#: rounds of this many bytes, so the buffers stay small
ROUND_BYTES = 256 << 20


#: every exchange of this process, for :func:`close_all`
_LIVE: "weakref.WeakSet[DeviceExchange]" = weakref.WeakSet()


def _uuid(device: torch.device) -> str:
    return str(torch.cuda.get_device_properties(device).uuid)


def close_all():
    """:meth:`DeviceExchange.close` of every exchange of this process, in
    the order they were made (the same on every rank)."""
    for ex in sorted(_LIVE, key=lambda e: e.serial):
        ex.close()


class DeviceExchange:
    """A rank's exchange buffers on its card, one a group of ``mesh``
    (a ``sharding.Mesh``); see the module docstring."""

    _made = 0

    def __init__(self, mesh):
        self.mesh = mesh
        # live axes -> None (a group across cards) or [own, peers...]
        self._bufs: Dict[Tuple[str, ...], Optional[List[torch.Tensor]]] = {}
        DeviceExchange._made += 1
        self.serial = DeviceExchange._made
        _LIVE.add(self)

    def close(self):
        """Drop the peers' buffers this rank maps, then meet each group
        whose buffers it shared at a barrier: past it no peer maps this
        rank's buffer, so its process may end. Collective over those
        groups, in the order they were first used (the same on every
        rank). The exchange can be used again afterwards."""
        shared = [live for live, bufs in self._bufs.items() if bufs]
        devices = {bufs[0].device for bufs in self._bufs.values() if bufs}
        self._bufs.clear()
        for dev in devices:
            torch.cuda.synchronize(dev)
        for live in shared:
            self._meet(live)
        if devices:
            torch.cuda.ipc_collect()

    def _buffers(self, axes, device, nbytes) -> Optional[List[torch.Tensor]]:
        """The group's buffers (this rank's at its own index), grown to
        ``nbytes``, or None when its ranks do not share one card.
        Collective over the group at its first use and at each growth:
        every rank of the group asks for the same size at the same
        call."""
        live = self.mesh._live(axes)
        grp = self.mesh.group(live)
        if live not in self._bufs:
            ids = [None] * self.mesh.size(live)
            dist.all_gather_object(ids, _uuid(device), group=grp)
            self._bufs[live] = [] if len(set(ids)) == 1 else None
        bufs = self._bufs[live]
        if bufs is None:
            return None
        if not bufs or bufs[0].numel() < nbytes:
            own = torch.empty(nbytes, dtype=torch.uint8, device=device)
            shared = [None] * self.mesh.size(live)
            dist.all_gather_object(shared, reduce_tensor(own), group=grp)
            me = self.mesh.index(live)
            # this rank's buffer first, then every rank's in rank order
            # (its own among them)
            self._bufs[live] = [own] + [
                own if k == me else fn(*args)
                for k, (fn, args) in enumerate(shared)]
            bufs = self._bufs[live]
        return bufs

    def _meet(self, axes):
        dist.barrier(group=self.mesh.group(axes))

    def _rounds(self, axes, device, total, width, write, read) -> bool:
        """Exchange ``total`` units of ``width`` bytes in rounds of at most
        :data:`ROUND_BYTES`: each round ``write(own, a, b)`` fills this
        rank's buffer with units [a, b), the group meets, ``read(bufs, a,
        b)`` reads every rank's buffer (rank order), the group meets
        again. False for a group across cards (nothing done)."""
        step = max(1, ROUND_BYTES // width)
        bufs = self._buffers(axes, device, min(total, step) * width)
        if bufs is None:
            return False
        for a in range(0, total, step):
            b = min(a + step, total)
            write(bufs[0], a, b)
            torch.cuda.synchronize(device)
            self._meet(axes)
            read(bufs[1:], a, b)
            torch.cuda.synchronize(device)
            self._meet(axes)
        return True

    def all_gather(self, t, axes) -> Optional[torch.Tensor]:
        """Every rank's ``t`` stacked in rank order, or None (use gloo)."""
        n = self.mesh.size(axes)
        src = t.detach().reshape(-1)
        out = torch.empty((n, src.numel()), dtype=t.dtype, device=t.device)

        def write(own, a, b):
            _as(own, t.dtype, b - a).copy_(src[a:b])

        def read(bufs, a, b):
            for k, buf in enumerate(bufs):
                out[k, a:b].copy_(_as(buf, t.dtype, b - a))

        if not self._rounds(axes, t.device, src.numel(), t.element_size(),
                            write, read):
            return None
        return out.view((n,) + tuple(t.shape))

    def reduce_scatter(self, t, axes) -> Optional[torch.Tensor]:
        """This rank's slot of ``t`` [n, ...] summed over the ranks, or
        None (use gloo)."""
        n = t.shape[0]
        src = t.detach().reshape(n, -1)
        me = self.mesh.index(self.mesh._live(axes))
        out = torch.empty(src.shape[1], dtype=t.dtype, device=t.device)

        def write(own, a, b):
            _as(own, t.dtype, n * (b - a)).view(n, b - a).copy_(src[:, a:b])

        def read(bufs, a, b):
            out[a:b] = _fold([_as(buf, t.dtype, n * (b - a)).view(
                n, b - a)[me] for buf in bufs], "sum")

        if not self._rounds(axes, t.device, src.shape[1],
                            n * t.element_size(), write, read):
            return None
        return out.view(t.shape[1:])

    def all_reduce_(self, t, op, axes) -> Optional[torch.Tensor]:
        """``t`` reduced over the ranks by ``op`` (SUM or MAX), in place, or
        None (use gloo)."""
        kind = {dist.ReduceOp.SUM: "sum", dist.ReduceOp.MAX: "max"}[op]
        src = t.detach().reshape(-1)
        out = torch.empty_like(src)

        def write(own, a, b):
            _as(own, t.dtype, b - a).copy_(src[a:b])

        def read(bufs, a, b):
            out[a:b] = _fold([_as(buf, t.dtype, b - a) for buf in bufs],
                             kind)

        if not self._rounds(axes, t.device, src.numel(), t.element_size(),
                            write, read):
            return None
        return t.copy_(out.view(t.shape))


def _as(buf, dtype, count):
    """The front of the byte buffer ``buf`` as ``count`` elements of
    ``dtype``."""
    return buf[:count * torch.empty((), dtype=dtype).element_size()].view(
        dtype)


def _fold(parts, kind):
    """The parts summed (in fp32 for a half-precision payload) or
    maxed, in rank order."""
    wide = parts[0].dtype in (torch.bfloat16, torch.float16)
    acc = parts[0].float() if wide else parts[0].clone()
    for p in parts[1:]:
        if kind == "sum":
            acc += p.float() if wide else p
        else:
            torch.maximum(acc, p.float() if wide else p, out=acc)
    return acc.to(parts[0].dtype) if wide else acc

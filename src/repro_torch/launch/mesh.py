"""Mesh factories and the rank launcher (twin of ``repro/launch/mesh.py``).

A mesh in the port is SPMD over ``torch.distributed`` ranks, one process
per shard (``distributed/sharding.py``). :func:`run_ranks` starts ``n``
gloo ranks on this machine (``torch.multiprocessing.spawn``, rendezvous
through a ``FileStore`` in a temporary directory, so no TCP port is
taken), runs one function in each and returns what each returned; inside
a rank, :func:`make_mesh` builds that rank's :class:`Mesh` from the
initialised process group, with a process group for each of its axes.
Every rank on a card uses device 0: ranks time-share one card, and the
collectives go through gloo on the host. :func:`make_production_mesh`
gives the 16x16 and 2x16x16 meshes, shape-only for one rank without a
process group (the dry run).
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed import device_exchange
from repro_torch.distributed.sharding import Mesh, ShapeOnlyGroup

#: how long a rank waits in a collective or the rendezvous before it fails
RANK_TIMEOUT = datetime.timedelta(minutes=10)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The production mesh (JAX's ``make_production_mesh``): ``("data",
    "model")`` of (16, 16), or with ``multi_pod`` ``("pod", "data",
    "model")`` of (2, 16, 16). Over an initialised process group of 256
    (512) ranks it is :func:`make_mesh` there. Without one it is the
    shape-only mesh of rank ``rank`` (its row-major coordinates, as
    :func:`make_mesh` places it): every axis's group is a
    ``sharding.ShapeOnlyGroup``, whose collectives take meta tensors only
    (the multi-device dry run, ``launch/dryrun.py``, traces one rank of
    the mesh on the meta device)."""
    names, shape = ("data", "model"), (16, 16)
    if multi_pod:
        names, shape = ("pod",) + names, (2,) + shape
    if dist.is_initialized():
        return make_mesh(*shape[-2:], pod=2 if multi_pod else 1)
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not in a {shape} mesh")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = tuple(ShapeOnlyGroup((a,)) for a in names)
    multi = {("pod", "data"): ShapeOnlyGroup(("pod", "data"))} \
        if multi_pod else {}
    return Mesh(names, shape, coords, groups, multi)


def make_mesh(data: int, model: int, pod: int = 1) -> Mesh:
    """This rank's ``("data", "model")`` mesh over the initialised process
    group, or with ``pod`` > 1 its ``("pod", "data", "model")`` mesh (JAX's
    ``make_mesh``); the group's size must be the mesh's. Rank ``r`` sits
    at its row-major coordinates, ``r = (p * data + d) * model + m``.
    Every line of every axis gets a process group (an axis of size 1
    none), and every model index one batch group over ``("pod",
    "data")`` when both are above 1, all made in the same order on every
    rank (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(run it inside run_ranks)")
    names, shape = ("data", "model"), (data, model)
    if pod > 1:
        names, shape = ("pod",) + names, (pod,) + shape
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{world}")
    rank = dist.get_rank()
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))

    def build(axes):
        """One group per line over ``axes``; this rank's."""
        dims = [names.index(a) for a in axes]
        mine = None
        for other in np.ndindex(*[shape[i] for i in range(len(shape))
                                  if i not in dims]):
            ranks = []
            for along in np.ndindex(*[shape[i] for i in dims]):
                c, it_o, it_a = [], iter(other), iter(along)
                for i in range(len(shape)):
                    c.append(next(it_a) if i in dims else next(it_o))
                ranks.append(int(np.ravel_multi_index(c, shape)))
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    groups = tuple(build((a,)) if n > 1 else None
                   for a, n in zip(names, shape))
    multi = {}
    if pod > 1 and data > 1:
        multi[("pod", "data")] = build(("pod", "data"))
    return Mesh(names, shape, coords, groups, multi)


def run_ranks(fn, n: int, *args, threads=None, timeout=None):
    """``fn(rank, *args)`` in each of ``n`` spawned gloo ranks; returns
    the ``n`` results in rank order (each saved with ``torch.save``, so
    keep tensors on the CPU). A rank that raises fails the call: the
    others are stopped and the error is raised here. ``fn`` must be a
    module-level function; ``threads`` sets each rank's torch threads
    (default: this machine's cores shared out among the ranks);
    ``timeout`` (seconds, default :data:`RANK_TIMEOUT`) bounds each
    collective, so that ranks whose collectives do not pair up fail."""
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    wait = (RANK_TIMEOUT if timeout is None
            else datetime.timedelta(seconds=timeout))
    with tempfile.TemporaryDirectory(prefix="ranks_") as d:
        mp.spawn(_rank_main, args=(fn, n, d, args, threads, wait), nprocs=n,
                 join=True)
        return [torch.load(os.path.join(d, f"{r}.pt"), weights_only=False)
                for r in range(n)]


def _rank_main(rank, fn, n, d, args, threads, wait):
    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(d, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=wait)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(d, f"{rank}.pt"))
        # no rank leaves while a peer still maps its exchange buffers
        device_exchange.close_all()
    finally:
        dist.destroy_process_group()

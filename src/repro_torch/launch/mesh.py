"""Mesh factories and the rank launcher (twin of ``repro/launch/mesh.py``).

A mesh in the port is SPMD over ``torch.distributed`` ranks, one process
per shard (``distributed/sharding.py``). :func:`run_ranks` starts ``n``
gloo ranks on this machine (``torch.multiprocessing.spawn``, rendezvous
through a ``FileStore`` in a temporary directory, so no TCP port is
taken), runs one function in each and returns what each returned; inside
a rank, :func:`make_mesh` builds that rank's :class:`Mesh` from the
initialised process group, with a process group for each of its axes.
Every rank on a card uses device 0: ranks time-share one card, and the
collectives go through gloo on the host.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import Mesh

#: how long a rank waits in a collective or the rendezvous before it fails
RANK_TIMEOUT = datetime.timedelta(minutes=10)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 (or 2x16x16) production mesh: queued with the dry run."""
    raise NotImplementedError(
        "make_production_mesh: the production meshes (16x16, 2x16x16) "
        "come with the dry run (ROADMAP.md queue 1)")


def make_mesh(data: int, model: int, pod: int = 1) -> Mesh:
    """This rank's ``("data", "model")`` mesh over the initialised process
    group, whose size must be ``data * model``. Rank ``r`` sits at
    ``(r // model, r % model)``; each axis gets one process group for
    every row (``model``) or column (``data``) of the mesh, made in the
    same order on every rank (``dist.new_group`` is collective), and an
    axis of size 1 gets none. ``pod`` > 1 raises ``NotImplementedError``
    (it comes with pipeline parallelism, ROADMAP.md queue 1, item 10).
    Callers that cannot yet split rows over ``data`` (the serving engine,
    ``pipeline.generate``) refuse a data axis above 1 themselves."""
    if pod != 1:
        raise NotImplementedError(
            f"make_mesh(pod={pod}): the pod axis comes with pipeline "
            "parallelism (ROADMAP.md queue 1, item 10)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(run it inside run_ranks)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank()
    row, col = divmod(rank, model)
    data_group = model_group = None
    if data > 1:
        for c in range(model):
            g = dist.new_group([c + i * model for i in range(data)])
            if c == col:
                data_group = g
    if model > 1:
        for r in range(data):
            g = dist.new_group([r * model + j for j in range(model)])
            if r == row:
                model_group = g
    return Mesh(("data", "model"), (data, model), (row, col),
                (data_group, model_group))


def run_ranks(fn, n: int, *args, threads=None):
    """``fn(rank, *args)`` in each of ``n`` spawned gloo ranks; returns
    the ``n`` results in rank order (each saved with ``torch.save``, so
    keep tensors on the CPU). A rank that raises fails the call: the
    others are stopped and the error is raised here. ``fn`` must be a
    module-level function; ``threads`` sets each rank's torch threads
    (default: this machine's cores shared out among the ranks)."""
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n)
    with tempfile.TemporaryDirectory(prefix="ranks_") as d:
        mp.spawn(_rank_main, args=(fn, n, d, args, threads), nprocs=n,
                 join=True)
        return [torch.load(os.path.join(d, f"{r}.pt"), weights_only=False)
                for r in range(n)]


def _rank_main(rank, fn, n, d, args, threads):
    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(d, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=RANK_TIMEOUT)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(d, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()

"""The rank side of ``tests/test_torch_data.py`` (not a test module).

:func:`scenarios` runs in every rank of a ``launch.mesh.run_ranks`` spawn
and returns that rank's results as numpy and Python values. It imports
torch and the port only: the spawned ranks never load JAX.
"""
import dataclasses
import hashlib

import numpy as np
import torch
from _torch_data_inputs import GEN_NEW, PAGE, generate_prompts
from _torch_sharded_inputs import engine_requests

from repro_torch.core import pipeline as pl
from repro_torch.core.state import capture_pools
from repro_torch.distributed import device_exchange, ep
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import kvcache as kvc
from repro_torch.serving.engine import ServingEngine

RULES = dict(sh.LOGICAL_RULES, kv_seq="model")
IMPLS = ("gather", "kernel")
#: the rounds' bound of :func:`sync_rounds`: under a slot of the bf16
#: pool (8 + 2 x 2 x 5 x 2 bytes), so slots straddle rounds
SYNC_ROUND = 37


def _replica(eng):
    """sha256 of this rank's pool tensors (the wave's, or those kept
    between waves) and of the pool's refcounts."""
    pools = (capture_pools(eng.wave.state) if eng.wave is not None
             else eng._pools) or {}
    h = hashlib.sha256()
    for name in sorted(pools):
        for t in pools[name]:
            h.update(t.contiguous().view(torch.uint8).numpy())
    if eng.pool is not None:
        h.update(np.asarray(eng.pool.refcounts(), np.int64).tobytes())
    return h.hexdigest()


class _Recording:
    """A mesh whose all-gathers record the bytes each rank sends."""

    def __init__(self, mesh):
        self.mesh, self.sizes = mesh, []

    def all_gather(self, t, axes):
        self.sizes.append(t.numel() * t.element_size())
        return self.mesh.all_gather(t, axes)

    def index(self, axes):
        return self.mesh.index(axes)


def sync_rounds(mesh, rank, round_bytes):
    """Two pools (a [P, page, H, D] fp32 pool and a stacked [L, P, page,
    H, D] bf16 one) whose pages the batch ranks write apart (rank r the
    pages r, r + 2, ..., their values drawn from seed 10 + r), synced by
    ``sync_replicas_`` over the batch axes in one round and in rounds of
    ``round_bytes``: both replicas after each, and the bytes each
    all-gather of the rounds' exchange carried a rank."""
    g = torch.Generator().manual_seed(10 + rank)
    pools = [torch.zeros((6, PAGE, 2, 3)),
             torch.zeros((2, 6, PAGE, 2, 5), dtype=torch.bfloat16)]
    table = torch.arange(6, dtype=torch.int32)[None]
    pos = torch.arange(6 * PAGE)[None]
    mine = (pos // PAGE) % 2 == rank
    writes = [torch.randn((1, 6 * PAGE, 2, 3), generator=g),
              torch.randn((2, 1, 6 * PAGE, 2, 5), generator=g).to(
                  torch.bfloat16)]
    out = {}
    saved = device_exchange.ROUND_BYTES
    for name, rb in (("one", saved), ("rounds", round_bytes)):
        for pool in pools:
            pool.zero_()
        with kvc.log_pool_writes() as log:
            for pool, w in zip(pools, writes):
                kvc.pool_scatter_(pool, table, w, pos, mine)
        rec = _Recording(mesh)
        device_exchange.ROUND_BYTES = rb
        try:
            kvc.sync_replicas_(pools, log, rec, ("data",))
        finally:
            device_exchange.ROUND_BYTES = saved
        out[name] = {"pools": [p.float().numpy() for p in pools],
                     "gathers": rec.sizes}
    return out


def serve(bundle, batch=2, steps=False):
    """The two-phase workload through one engine: tokens, stats, the
    replica hash after every engine step (``steps``) and the run's
    pool-write and host-result gathers, and ``storage``: whether the
    engine keeps the rank's serving storage of the weights and the weight
    gathers (``sharding.WEIGHTS``) of its run."""
    sh.WEIGHTS.reset()
    eng = ServingEngine(bundle, batch_size=batch, seed=0,
                        cache_impl="paged", page_size=PAGE,
                        prefix_cache=True, pool_scope="engine", device="cpu")
    sh.WRITES.reset()
    sh.RESULTS.reset()
    hashes = []
    for part in engine_requests():
        for pr, n in part:
            eng.submit(pr, max_new=n)
        if not steps:
            stats = eng.run()
            continue
        while eng.queue or eng.wave is not None:
            if eng.wave is None and not eng.start_wave():
                break
            hashes.append(_replica(eng))
            while eng.wave is not None:
                more = eng.step()
                hashes.append(_replica(eng))
                if not more:
                    break
        stats = eng.run()
    eng.agree_across_ranks()
    return {"tokens": {r.uid: r.out.tolist() for r in eng.done},
            "stats": stats, "replicas": hashes,
            "writes": (sh.WRITES.calls, sh.WRITES.bytes),
            "results": sh.RESULTS.calls,
            "storage": {"cut": pl.at_storage(eng.bundle),
                        "gathers": (sh.WEIGHTS.calls, sh.WEIGHTS.bytes)}}


def _rank_bundle(bundle, mesh):
    return dataclasses.replace(bundle, target_params=ep.ep_shard_target(
        bundle.target_params, bundle.target_cfg, mesh))


def scenarios(rank, n, x):
    """Every scenario in this rank of an ``n``-rank spawn (2: the (2, 1)
    mesh; 4: (2, 2), then pod 2 x data 2). ``x``: "bundles" ({impl: the
    tiny SpecBundle}), "sampled" (its gather bundle at temperature 1),
    "moe" (the tiny MoE target's gather bundle)."""
    torch.manual_seed(0)
    res = {"rank": rank}
    prompts = generate_prompts()
    if n == 2:
        mesh = make_mesh(2, 1)
        with sh.use_sharding(mesh, RULES):
            res["run"] = sh.batch_run(2)
            res["engine"] = {impl: serve(x["bundles"][impl],
                                         steps=impl == "gather")
                             for impl in IMPLS}
            res["wave3"] = serve(x["bundles"]["gather"], batch=3)
            res["generate"] = pl.generate(x["bundles"]["gather"], prompts,
                                          GEN_NEW, device="cpu")["tokens"]
            res["sampled"] = pl.generate(x["sampled"], prompts, GEN_NEW,
                                         seed=5, device="cpu")["tokens"]
        res["sync"] = sync_rounds(mesh, rank, SYNC_ROUND)
        return res
    mesh = make_mesh(2, 2)
    with sh.use_sharding(mesh, RULES):
        res["run"] = sh.batch_run(2)
        res["engine"] = {impl: serve(x["bundles"][impl]) for impl in IMPLS}
        res["moe"] = serve(_rank_bundle(x["moe"], mesh))
    pod = make_mesh(2, 1, pod=2)
    with sh.use_sharding(pod, RULES):
        res["pod_run"] = sh.batch_run(4)
        res["generate"] = pl.generate(x["bundles"]["gather"], prompts,
                                      GEN_NEW, device="cpu")["tokens"]
    return res

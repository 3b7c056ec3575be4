"""Serving launcher: ``python -m repro_torch.launch.serve [--mode d2sd]``
(twin of ``repro/launch/serve.py``).

Serves synthetic requests through the port's D2SD
:class:`~repro_torch.serving.engine.ServingEngine` with random seeded
weights and prints acceptance and throughput statistics. ``--arch
paper-target`` is the small target of the empirical study with its
drafter by default; ``--full`` serves the full-width, full-depth target
with two 2-layer drafters at its widths, which needs the card's memory.
``--traffic`` replays an open-loop arrival trace through the overlapped
front-end instead of a fixed batch. Runs on ``--device cuda`` unless
``--device cpu`` is asked for.

``--mesh-model P`` (P > 1) serves with ONE engine spanning a ``(1, P)``
mesh: the launcher starts its P gloo ranks itself
(``launch/mesh.py::run_ranks``; on a card every rank uses device 0),
each builds the same weights from the same seeds, and with ``--cache-impl
paged`` each rank holds ``page_size // P`` slots of every page and the
decode reads merge across ranks (``--kv-seq-axis off`` keeps the mesh
and replicates the pool). A MoE target (``--arch grok-1-314b``) runs its
experts in parallel over the same axis (``distributed/ep.py``: each rank
keeps its share of every expert stack, ``ep_shard_target``), with the
kv_seq axis on or off. Every rank keeps its slice of every weight by
the parameter rules (heads, ffn and vocab over ``model``; FSDP over
``data`` too above 1e11 parameters) and gathers a layer's weights as the
layer starts (``pipeline.serve_storage``); a dense cache holds the
rank's run of the slots. ``--mesh-data N`` adds a data axis: the launcher
starts ``N * P`` ranks of a ``(N, P)`` mesh, a wave's rows split over
the data axis where N divides them, and the pool is replicated over it
(``serving/engine.py``). Rank 0 prints (with a mesh, ``batch_shards=N
kv_shards=P``); ``--traffic`` under a mesh needs ``--virtual-clock``,
since every rank must take the same admission decisions.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.config.base import SpecConfig
from repro_torch.config.registry import all_archs, get_config
from repro_torch.configs.paper_target import drafter_small
from repro_torch.core import pipeline as pl
from repro_torch.core.drafter import DrafterConfig, drafter_init
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine

MODES = ("d2sd", "dflash", "naive_k", "eagle", "dflash_second")


def build_bundle(args, device):
    """Random seeded target and drafters for ``args``: the arch's smoke
    target with the study's drafter, or with ``--full`` the full target
    with two 2-layer drafters at the target's widths."""
    tcfg = get_config(args.arch, smoke=not args.full)
    gamma = args.gamma or (16 if args.full else 8)
    if args.full:
        dcfg = DrafterConfig(d_model=tcfg.d_model, num_layers=2,
                             num_heads=tcfg.num_heads,
                             num_kv_heads=tcfg.num_kv_heads, d_ff=tcfg.d_ff,
                             vocab_size=tcfg.vocab_size,
                             target_feature_dim=lm.feature_dim(tcfg),
                             gamma=gamma)
    else:
        # the study's drafter, reading this target's features and vocab
        dcfg = dataclasses.replace(drafter_small(gamma=gamma),
                                   vocab_size=tcfg.vocab_size,
                                   target_feature_dim=lm.feature_dim(tcfg))
    dtype = args.dtype or tcfg.dtype
    tcfg = dataclasses.replace(tcfg, dtype=dtype, attn_impl=args.attn_impl)
    d1cfg = dataclasses.replace(dcfg, dtype=dtype, attn_impl=args.attn_impl,
                                causal=args.mode == "eagle")
    d2cfg = dataclasses.replace(dcfg, dtype=dtype, attn_impl=args.attn_impl)
    spec = SpecConfig(gamma=gamma, top_k_branches=args.k, mode=args.mode,
                      temperature=args.temperature)
    d1 = drafter_init(d1cfg, seed=1, device=device)
    d2 = d1 if args.mode == "dflash_second" else drafter_init(
        d2cfg, seed=2, device=device)
    return pl.SpecBundle(tcfg, d1cfg, d2cfg, spec,
                         lm.lm_init(tcfg, seed=0, device=device), d1, d2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-target",
                    choices=("paper-target",) + all_archs())
    ap.add_argument("--full", action="store_true",
                    help="the full-width, full-depth target (default: the "
                         "smoke target of the empirical study)")
    ap.add_argument("--mode", default="d2sd", choices=MODES)
    ap.add_argument("--gamma", type=int, default=None)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--task", default="math")
    ap.add_argument("--attn-impl", default="kernel",
                    choices=["gather", "kernel"],
                    help="cache read path of decode verify and the drafters: "
                         "the cascade kernels or the plain gather")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="weights and caches (default: the config's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    ap.add_argument("--cache-impl", default="dense",
                    choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache (needs --cache-impl paged)")
    ap.add_argument("--bucket-sizes", default=None,
                    help="comma-separated install-prefill length buckets, "
                         "'off' for exact lengths; default: pow-2 ladder")
    ap.add_argument("--pool-scope", default="engine",
                    choices=["engine", "wave"])
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--pool-headroom", type=float, default=1.0)
    ap.add_argument("--traffic", default=None, choices=["poisson", "bursty"],
                    help="replay a seeded open-loop arrival trace through "
                         "the async front-end; reports TTFT/TPOT")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument("--sync-baseline", action="store_true",
                    help="drive the trace with the synchronous baseline")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="replay in simulated time (1 s a decode cycle)")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data mesh axis size: ONE resident engine spans "
                         "the (data, model) mesh; batch rows shard over "
                         "this axis when divisible (default 1)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model mesh axis size: P ranks serve as one "
                         "engine; with --cache-impl paged each holds "
                         "page_size // P slots of every page (page_size "
                         "must be divisible by P) and the decode reads "
                         "merge by an LSE all-reduce (default 1: no mesh)")
    ap.add_argument("--kv-seq-axis", default="model",
                    choices=["model", "off"],
                    help="mesh axis backing the kv_seq logical axis; 'off' "
                         "replicates the KV pool inside the mesh")
    args = ap.parse_args(argv)
    if args.mesh_model < 1 or args.mesh_data < 1:
        ap.error("--mesh-data and --mesh-model must be positive")
    if args.mesh_data * args.mesh_model > 1 and args.traffic is not None \
            and not args.virtual_clock:
        ap.error("--traffic under a mesh needs --virtual-clock: every rank "
                 "must take the same admission decisions")
    if args.bucket_sizes is not None:
        if args.bucket_sizes.strip().lower() in ("off", "none"):
            args.bucket_sizes = None
        else:
            buckets = tuple(int(x) for x in args.bucket_sizes.split(",")
                            if x.strip())
            if not buckets or any(b <= 0 for b in buckets):
                ap.error(f"--bucket-sizes must be positive ints, got "
                         f"{args.bucket_sizes!r}")
            args.bucket_sizes = buckets
    else:
        args.bucket_sizes = "auto"
    return args


def main(argv=None):
    """Serve; returns the stats (rank 0's under a mesh)."""
    args = parse_args(argv)
    n = args.mesh_data * args.mesh_model
    if n > 1:
        from repro_torch.launch.mesh import run_ranks
        return run_ranks(_serve_rank, n, args)[0]
    return _serve(args)


def _serve_rank(rank, args):
    """One rank of a ``--mesh-data`` / ``--mesh-model`` run: the engine
    inside the mesh, a MoE target's expert stacks cut to this rank's part,
    then every weight to the rank's serving storage (FSDP too above 1e11
    parameters, as JAX's serving cells), whole a layer at a time."""
    from repro_torch.core.pipeline import serve_storage
    from repro_torch.distributed.ep import ep_shard_target
    from repro_torch.distributed.sharding import LOGICAL_RULES, use_sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import serve_fsdp
    rules = dict(LOGICAL_RULES,
                 kv_seq=None if args.kv_seq_axis == "off" else "model")
    mesh = make_mesh(args.mesh_data, args.mesh_model)
    with use_sharding(mesh, rules):
        bundle = build_bundle(args, resolve_device(args.device))
    with use_sharding(mesh, rules, fsdp=serve_fsdp(bundle.target_cfg)):
        bundle = serve_storage(dataclasses.replace(
            bundle, target_params=ep_shard_target(
                bundle.target_params, bundle.target_cfg, mesh)))
        with contextlib.redirect_stdout(None) if rank else \
                contextlib.nullcontext():
            return _serve(args, bundle)


def _serve(args, bundle=None):
    dev = resolve_device(args.device)
    if bundle is None:
        bundle = build_bundle(args, dev)
    kw = dict(batch_size=args.requests, cache_impl=args.cache_impl,
              page_size=args.page_size, prefix_cache=args.prefix_cache,
              bucket_sizes=args.bucket_sizes, pool_scope=args.pool_scope,
              pool_headroom=args.pool_headroom, device=dev)
    if args.traffic is not None:
        from repro_torch.serving.frontend import ReplayDriver
        from repro_torch.serving.metrics import (MetricsRecorder,
                                                 MonotonicClock, VirtualClock)
        from repro_torch.serving.traffic import make_trace
        clock = VirtualClock() if args.virtual_clock else MonotonicClock()
        rec = MetricsRecorder(clock)
        trace = make_trace(args.traffic, args.rate, args.duration,
                           seed=args.traffic_seed, max_new=args.max_new,
                           vocab=bundle.target_cfg.vocab_size,
                           tasks=(args.task,))
        pool_pages = args.pool_pages
        if args.cache_impl == "paged" and pool_pages is None:
            # the engine sizes its pool from the queue at the first wave,
            # which open-loop traffic may hold one request of; the whole
            # trace is known here
            g = bundle.spec.gamma
            per = max(-(-(a.prompt_len + a.max_new + 2 * g + 8)
                        // args.page_size) for a in trace)
            pool_pages = 2 * args.requests * per
        eng = ServingEngine(bundle, pool_pages=pool_pages, clock=clock,
                            recorder=rec, **kw)
        stats = ReplayDriver(eng, trace,
                             overlap=not args.sync_baseline).run()
        sla = stats["sla"]
        driver = "sync" if args.sync_baseline else "overlapped"
        print(f"mode={args.mode} traffic={args.traffic} rate={args.rate} "
              f"driver={driver} served {len(eng.done)}/{len(trace)} | "
              f"cycles={stats['engine_cycles']} "
              f"alpha={stats.get('alpha', 0):.2f}")
        print(f"  ttft p50={sla['ttft']['p50']:.2f}s "
              f"p99={sla['ttft']['p99']:.2f}s | "
              f"tpot p50={sla['tpot']['p50']:.3f}s "
              f"p99={sla['tpot']['p99']:.3f}s | "
              f"e2e p99={sla['e2e']['p99']:.2f}s | "
              f"queue max={sla['queue_depth']['max']}")
        return stats

    eng = ServingEngine(bundle, pool_pages=args.pool_pages, **kw)
    ds = SyntheticDataset(args.task, 1, 64, seed=11)
    for p in ds.prompts(args.requests, 32, offset=10 ** 7):
        eng.submit(np.asarray(p), max_new=args.max_new)
    stats = eng.run()
    prefix = ""
    if args.prefix_cache:
        prefix = (f" | prefix_hits={stats['prefix_hits']} "
                  f"saved={stats['prefill_tokens_saved']}tok "
                  f"cow={stats['cow_copies']}")
    mesh_note = ""
    if eng.batch_shards > 1:
        mesh_note = (f" | batch_shards={eng.batch_shards} "
                     f"kv_shards={stats['kv_shards']}")
    elif stats["kv_shards"] > 1:
        mesh_note = (f" | kv_shards={stats['kv_shards']} "
                     f"shard_slots={stats['pool_shard_slots']}")
    print(f"mode={args.mode} served {len(eng.done)} requests on {dev} | "
          f"alpha={stats.get('alpha', 0):.2f} | "
          f"{stats['tokens_per_s']:.1f} tok/s | "
          f"{stats['cycles']} cycles" + prefix + mesh_note)
    return stats


if __name__ == "__main__":
    main()

"""The rank side of ``tests/test_torch_ep.py`` (not a test module).

:func:`scenarios` runs in every rank of a ``launch.mesh.run_ranks`` spawn
and returns that rank's results as numpy. It imports torch and the port
only: the spawned ranks never load JAX.
"""
import dataclasses

import numpy as np
import torch
from _torch_ep_inputs import GRAD_CASES, PAGE
from _torch_sharded_inputs import engine_requests

from repro_torch.core import pipeline as pl
from repro_torch.distributed import collectives, ep
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models import param as pm
from repro_torch.serving.engine import ServingEngine

RULES = dict(sh.LOGICAL_RULES, kv_seq="model")
IMPLS = ("gather", "kernel")


def _np(t):
    return t.detach().float().numpy().copy()


def _layers(cases, mesh):
    """Every layer case inside ``mesh``: all of x (replicated, as JAX's
    global view) through ``moe_apply`` with this rank's params, and for
    the gradient cases the gradients of ``sum(y * w)``; with the run of
    the tokens this rank's experts computed (``ep.data_slice``)."""
    out = {}
    for name, (cfg, p, x, w) in cases.items():
        lp = ep.ep_local_params(p, cfg, mesh)
        rec = {"slice": ep.data_slice(x.shape[0] * x.shape[1], mesh)}
        if name in GRAD_CASES:
            lp = pm.tree_map(lambda v: v.clone().requires_grad_(), lp)
            xg = x.clone().requires_grad_()
            y = moe.moe_apply(lp, xg, cfg)
            (y * w).sum().backward()
            rec["grad"] = {"x": _np(xg.grad), **{
                k: _np(v.grad) for k, v in pm.flatten(lp).items()}}
        else:
            with torch.no_grad():
                y = moe.moe_apply(lp, x, cfg)
        rec["y"] = _np(y.reshape(-1, y.shape[-1]))
        out[name] = rec
    return out


def _rank_bundle(bundle, mesh):
    """``bundle`` with this rank's part of the target's expert stacks."""
    return dataclasses.replace(bundle, target_params=ep.ep_shard_target(
        bundle.target_params, bundle.target_cfg, mesh))


def _serve(bundle, mesh):
    """The two-phase workload through one engine, this rank's part of the
    expert stacks: tokens, stats, the EP all-reduces' calls and bytes."""
    eng = ServingEngine(_rank_bundle(bundle, mesh), batch_size=2, seed=0,
                        cache_impl="paged", page_size=PAGE,
                        prefix_cache=True, pool_scope="engine", device="cpu")
    ep.REDUCES.reset()
    for part in engine_requests():
        for pr, n in part:
            eng.submit(pr, max_new=n)
        stats = eng.run()
    eng.agree_across_ranks()
    return {"tokens": {r.uid: r.out.tolist() for r in eng.done},
            "stats": stats, "reduces": (ep.REDUCES.calls, ep.REDUCES.bytes)}


def _cgrad(steps, rank):
    """Two steps of ``compressed_grad_allreduce`` on this rank's row."""
    err = collectives.init_error_state({"g": torch.zeros(steps[0].shape[1])})
    out = []
    for g in steps:
        mean, err = collectives.compressed_grad_allreduce(
            {"g": torch.from_numpy(g[rank].copy())}, err, axis="data")
        out.append((_np(mean["g"]), _np(err["g"])))
    return out


def _raises(fn):
    """The type name of what ``fn()`` raised (None if nothing)."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the type is the result
        return type(e).__name__
    return None


def _refusals(bundle, cases, mesh):
    """In an experts mesh: a full expert stack raises, and so does the
    graph loop of a MoE target with the kv_seq axis off. In a data mesh:
    the engine builds and serves a request (None: nothing raised), and the
    graph loop with kv_seq and experts off (only the batch axes left)
    raises, naming ROADMAP.md item 9b."""
    cfg, p, x, _ = cases["e4_gated_skew"]
    got = {"full_stack": _raises(lambda: moe.moe_apply(p, x, cfg))}
    with sh.use_sharding(mesh, dict(RULES, kv_seq=None)):
        got["graph_loop"] = _raises(lambda: pl.generate_ondevice(
            bundle, np.zeros((1, 4), np.int32), 2, device="cpu"))
    m22 = make_mesh(2, mesh.size("model") // 2)

    def serve_one():
        eng = ServingEngine(_rank_bundle(bundle, m22), batch_size=2,
                            cache_impl="paged", page_size=PAGE, device="cpu")
        eng.submit(np.arange(3, 9, dtype=np.int32), max_new=3)
        eng.submit(np.arange(4, 11, dtype=np.int32), max_new=3)
        assert eng.run()["tokens"] == 6

    def graph_loop():
        try:
            pl.generate_ondevice(bundle, np.zeros((2, 4), np.int32), 2,
                                 device="cpu")
        except NotImplementedError as e:
            assert "9b" in str(e), e
            raise

    with sh.use_sharding(m22, RULES):
        got["engine_data"] = _raises(serve_one)
    with sh.use_sharding(m22, dict(RULES, kv_seq=None, experts=None)):
        got["generate_data"] = _raises(graph_loop)
    return got


def scenarios(rank, n, x):
    """Every scenario in this rank of an ``n``-rank spawn. ``x``: "cases"
    ({name: (port config, full params, x, w)} as torch), "bundles"
    ({impl: the MoE SpecBundle}), "nodrop" (its gather bundle at
    capacity E/k), "prompts", "cgrad" (two steps of [ranks, N])."""
    torch.manual_seed(0)
    res = {}
    mesh = make_mesh(1, n)
    with sh.use_sharding(mesh, RULES):
        res["layer"] = {f"1x{n}": _layers(x["cases"], mesh)}
        res["engine"] = {impl: _serve(x["bundles"][impl], mesh)
                         for impl in IMPLS}
        if n == 2:
            res["nodrop"] = _serve(x["nodrop"], mesh)
            res["generate"] = pl.generate(
                _rank_bundle(x["bundles"]["gather"], mesh), x["prompts"], 16,
                max_len=256, device="cpu")["tokens"]
        else:
            res["refusals"] = _refusals(x["bundles"]["gather"], x["cases"],
                                        mesh)
    if n == 4:
        m22 = make_mesh(2, 2)
        with sh.use_sharding(m22, RULES):
            res["layer"]["2x2"] = _layers(x["cases"], m22)
        with sh.use_sharding(make_mesh(4, 1), RULES):
            res["cgrad"] = _cgrad(x["cgrad"], rank)
    return res

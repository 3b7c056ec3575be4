"""JAX references for ``tests/test_torch_ep.py`` (not a test module).

Run as ``python _torch_ep_jax.py OUT PART`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` with ``src`` and
``tests`` on ``PYTHONPATH``: it builds the meshes ``(data 1, model 2)``,
``(1, 4)``, ``(2, 2)`` and ``(4,)`` over the host devices and runs the
JAX package's expert-parallel MoE (``moe_apply`` inside each mesh reaches
``distributed/ep.py::moe_apply_ep``), its gradients, a MoE target's
meshless engine, the engine at the capacity that drops nothing,
``generate`` and ``compressed_grad_allreduce`` (PART ``layers``), or the
MoE target's sharded serving engine on both read paths (PART
``engines``); the two parts run side by side. It writes the outputs to
``OUT/ref_PART.npz`` (arrays) and ``OUT/ref_PART.json`` (tokens and
stats). The test module imports its builders (:func:`layer_case`,
:func:`moe_bundle`, :func:`cgrad_inputs`) for the port's side.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from _torch_ep_inputs import (CGRAD_N, CGRAD_RANKS, GAMMA, GRAD_CASES,
                              LAYER_CASES, MESHES, PAGE, VOCAB,
                              layer_config_kw, layer_x, skew_params)
from _torch_sharded_inputs import engine_requests
from conftest import tiny_drafter, tiny_target
from jax.sharding import PartitionSpec as P

from repro.config.base import ModelConfig, MoEConfig, SpecConfig
from repro.core import drafter as dr
from repro.core import pipeline as pl
from repro.distributed import compat
from repro.distributed import sharding as sh
from repro.distributed.collectives import compressed_grad_allreduce
from repro.models import lm
from repro.models import moe as jmoe
from repro.serving.engine import ServingEngine

RULES = dict(sh.LOGICAL_RULES, kv_seq="model")
ENGINE_MESHES = (2, 4)
CF_NODROP = 2.0           # E / k of the engine's target: nothing drops


def mesh(data, model):
    return compat.make_mesh((data, model), ("data", "model"),
                            devices=jax.devices()[:data * model])


def layer_case(i, name):
    """Case ``i`` of ``LAYER_CASES``: (JAX config, numpy params from key
    10 + i, x in fp32, w)."""
    kw, mkw = layer_config_kw(name)
    cfg = ModelConfig(**kw, moe=MoEConfig(**mkw))
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(10 + i),
                                               cfg))
    x, w = layer_x(i, name)
    return cfg, skew_params(name, p), x, w


def moe_target_cfg(cf=1.25):
    """The tiny fp32 MoE target: 4 experts, top 2, capacity factor
    ``cf``, scatter dispatch."""
    return tiny_target(vocab=VOCAB, dtype="float32", moe=MoEConfig(
        4, top_k=2, capacity_factor=cf, dispatch="scatter"))


def moe_bundle(cf=1.25):
    """:func:`moe_target_cfg` and drafters, from JAX keys 0, 1, 2."""
    tcfg = moe_target_cfg(cf)
    dcfg = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    spec = SpecConfig(gamma=GAMMA, top_k_branches=2, mode="d2sd")
    return pl.SpecBundle(tcfg, dcfg, dcfg, spec,
                         lm.lm_init(jax.random.PRNGKey(0), tcfg),
                         dr.drafter_init(jax.random.PRNGKey(1), dcfg),
                         dr.drafter_init(jax.random.PRNGKey(2), dcfg))


def cgrad_inputs():
    """Two steps of local gradients [ranks, N]: the input of
    ``tests/test_distributed.py``'s compressed all-reduce at 4 ranks
    (keys 0 and 1)."""
    scale = jnp.logspace(-3, 0, CGRAD_N)[None]
    return [np.asarray(jax.random.normal(jax.random.PRNGKey(s),
                                         (CGRAD_RANKS, CGRAD_N)) * scale)
            for s in (0, 1)]


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _serve(bundle, impl, m=None):
    """The two-phase workload through JAX's engine (inside a (1, m) mesh
    when ``m``): tokens and stats."""
    bun = pl.with_attn_impl(bundle, impl)
    kw = dict(batch_size=2, seed=0, cache_impl="paged", page_size=PAGE,
              prefix_cache=True, pool_scope="engine")
    if m is None:
        eng = ServingEngine(bun, **kw)
    else:
        with sh.use_sharding(mesh(1, m), RULES):
            eng = ServingEngine(bun, **kw)
    for part in engine_requests():
        for pr, n in part:
            eng.submit(pr, max_new=n)
        stats = eng.run()
    return {"tokens": {str(r.uid): r.out.tolist() for r in eng.done},
            "stats": {k: (float(v) if isinstance(v, float) else int(v))
                      for k, v in stats.items()}}


def engines(res, meta):
    """The MoE target's sharded engine on both read paths."""
    bundle = moe_bundle()
    meta["engine"] = {f"{m}/{impl}": _serve(bundle, impl, m)
                      for m in ENGINE_MESHES for impl in ("gather", "pallas")}


def layers(res, meta):
    """Everything but the sharded engines."""
    # ---- one MoE layer inside each mesh, its gradient, and meshless ------
    cases = [layer_case(i, c[0]) for i, c in enumerate(LAYER_CASES)]
    cases = [(cfg, p, jnp.asarray(x).astype(cfg.dtype), w)
             for cfg, p, x, w in cases]
    for (name, *_), (cfg, p, x, _) in zip(LAYER_CASES, cases):
        res[f"layer/meshless/{name}"] = np.asarray(jax.jit(
            lambda p, x, c=cfg: jmoe.moe_apply(p, x, c))(p, x), np.float32)
    for dm, mm in MESHES:
        with sh.use_sharding(mesh(dm, mm), RULES):
            for (name, *_), (cfg, p, x, w) in zip(LAYER_CASES, cases):
                res[f"layer/{dm}x{mm}/{name}"] = np.asarray(jax.jit(
                    lambda p, x, c=cfg: jmoe.moe_apply(p, x, c))(p, x),
                    np.float32)
                if name not in GRAD_CASES:
                    continue
                gp, gx = jax.jit(jax.grad(
                    lambda p, x, c=cfg, w=w: jnp.sum(
                        jmoe.moe_apply(p, x, c) * w), argnums=(0, 1)))(p, x)
                res.update(_leaves(gp, f"grad/{dm}x{mm}/{name}"))
                res[f"grad/{dm}x{mm}/{name}/x"] = np.asarray(gx)

    # ---- the MoE target's meshless engine, and the engines at the
    # capacity that drops nothing -----------------------------------------
    bundle = moe_bundle()
    meta["meshless"] = _serve(bundle, "gather")
    nodrop = moe_bundle(CF_NODROP)
    meta["nodrop"] = {"2": _serve(nodrop, "gather", 2),
                      "meshless": _serve(nodrop, "gather")}

    # ---- generate on a dense cache inside a (1, 2) mesh ------------------
    prompts = np.random.default_rng(3).integers(3, VOCAB, (2, 12)).astype(
        np.int32)
    with sh.use_sharding(mesh(1, 2), RULES):
        res["generate"] = np.asarray(pl.generate(
            bundle, jnp.asarray(prompts), 16, max_len=256)["tokens"])

    # ---- compressed_grad_allreduce over data 4, two steps ----------------
    m4 = compat.make_mesh((CGRAD_RANKS,), ("data",),
                          devices=jax.devices()[:CGRAD_RANKS])

    def step(g, e):
        return compressed_grad_allreduce({"g": g}, {"g": e}, axis="data")

    f = jax.jit(compat.shard_map(step, mesh=m4,
                                 in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data")),
                                 check_vma=False))
    e = jnp.zeros((CGRAD_RANKS, CGRAD_N))
    for s, g in enumerate(cgrad_inputs()):
        mean, e2 = f(jnp.asarray(g), e)
        res[f"cgrad/{s}/mean"] = np.asarray(mean["g"])
        res[f"cgrad/{s}/err"] = np.asarray(e2["g"])
        e = e2["g"]


def main(out, part):
    assert jax.device_count() >= 4, jax.device_count()
    res, meta = {}, {}
    {"layers": layers, "engines": engines}[part](res, meta)
    out = Path(out)
    np.savez(out / f"ref_{part}.npz", **res)
    (out / f"ref_{part}.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    main(*sys.argv[1:])

"""JAX references for ``tests/test_torch_sharded.py`` (not a test module).

Run as ``python _torch_sharded_jax.py OUT`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` with ``src`` and
``tests`` on ``PYTHONPATH``: it builds the meshes ``(data 1, model 2)``
and ``(1, 4)`` over the host devices, runs the JAX package's
kv_seq-sharded functions on the inputs of ``_torch_sharded_inputs.py``
and writes the outputs to ``OUT/ref.npz`` (arrays) and ``OUT/ref.json``
(tokens and stats).
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from _torch_sharded_inputs import DENSE_CASES, GAMMA, PAGE, VOCAB, inputs
from conftest import tiny_drafter, tiny_target

from repro.config.base import SpecConfig
from repro.core import drafter as dr
from repro.core import pipeline as pl
from repro.distributed import compat
from repro.distributed import sharding as sh
from repro.distributed import spdecode as sp
from repro.models import lm
from repro.models.blocks import _attend_cache_plus_block
from repro.serving.engine import ServingEngine

MESHES = (2, 4)
RULES = dict(sh.LOGICAL_RULES, kv_seq="model")


def mesh(p):
    return compat.make_mesh((1, p), ("data", "model"),
                            devices=jax.devices()[:p])


def bundle():
    """The tiny fp32 target and drafters, from JAX keys 0, 1, 2."""
    tcfg = tiny_target(vocab=VOCAB, dtype="float32")
    dcfg = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    spec = SpecConfig(gamma=GAMMA, top_k_branches=2, mode="d2sd")
    return pl.SpecBundle(tcfg, dcfg, dcfg, spec,
                         lm.lm_init(jax.random.PRNGKey(0), tcfg),
                         dr.drafter_init(jax.random.PRNGKey(1), dcfg),
                         dr.drafter_init(jax.random.PRNGKey(2), dcfg))


def _jit_call(fn, arrays, **kw):
    """``fn(*arrays, **kw)`` compiled once (an eager shard_map call runs
    op by op, several times slower on the host)."""
    return np.asarray(jax.jit(lambda *a: fn(*a, **kw))(
        *(jnp.asarray(a) for a in arrays)))


def main(out):
    assert jax.device_count() >= 4, jax.device_count()
    res, meta = {}, {}
    bun = bundle()
    x = inputs(bun.d1_cfg.target_feature_dim)

    # ---- sharded_cache_attend: fp32 and bf16 merges -----------------------
    d = {k[6:]: v for k, v in x.items() if k.startswith("dense/")}
    for p in MESHES:
        with sh.use_sharding(mesh(p), RULES):
            for name, rolling, window, cap in DENSE_CASES:
                for md in ("float32", "bfloat16"):
                    res[f"dense/{p}/{name}/{md}"] = _jit_call(
                        lambda *a, **kw: sp.sharded_cache_attend(
                            *a[:5], blk_mask=a[5], **kw),
                        [d[k] for k in ("q", "ck", "cv", "bk", "bv", "mask")],
                        cache_len=d["cache_len"], q_abs=d["q_abs"],
                        window=window, attn_softcap=cap, rolling=rolling,
                        merge_dtype=jnp.dtype(md))
    # the reference quirk: JAX's default (bf16) merge against the
    # meshless read of the same input
    qk = {k[6:]: v for k, v in x.items() if k.startswith("quirk/")}
    one = jnp.ones((1, 1), bool)
    with sh.use_sharding(mesh(2), RULES):
        res["quirk/sharded"] = _jit_call(
            sp.sharded_cache_attend,
            [qk[k] for k in ("q", "k", "v", "bk", "bv")],
            cache_len=qk["cache_len"], q_abs=qk["q_abs"], window=None,
            attn_softcap=None, blk_mask=one, rolling=False)
    res["quirk/meshless"] = np.asarray(_attend_cache_plus_block(
        jnp.asarray(qk["q"]), jnp.concatenate([qk["k"], qk["bk"]], 1),
        jnp.concatenate([qk["v"], qk["bv"]], 1), cache_cap=2,
        cache_len=qk["cache_len"], q_abs=qk["q_abs"], window=None,
        extra_mask=one, attn_softcap=None, impl="dense", kv_chunk=64,
        rolling=False))

    # ---- sharded_paged_cache_attend: both read paths ----------------------
    g = {k[6:]: v for k, v in x.items() if k.startswith("paged/")}
    for p in MESHES:
        with sh.use_sharding(mesh(p), RULES):
            for impl in ("gather", "pallas"):
                res[f"paged/{p}/{impl}"] = _jit_call(
                    lambda *a, **kw: sp.sharded_paged_cache_attend(
                        *a[:6], blk_mask=a[6], **kw),
                    [g[k] for k in ("q", "pk", "pv", "table", "bk", "bv",
                                    "mask")],
                    cache_len=g["cache_len"], q_abs=g["q_abs"],
                    attn_softcap=None, page_size=PAGE, read_impl=impl)

    # ---- drafter_forward on a paged feature cache, meshless ---------------
    dcfg = bun.d1_cfg
    feats = x["drafter/feats"]
    cache = dr.init_feat_cache(dcfg, 2, PAGE * 6, dtype=jnp.float32,
                               cache_impl="paged", page_size=PAGE)
    pos = np.broadcast_to(np.arange(feats.shape[1])[None], feats.shape[:2])
    cache = dr.extend_feat_cache(bun.d1_params, dcfg, cache,
                                 jnp.asarray(feats), jnp.asarray(pos),
                                 jnp.asarray(x["drafter/n_new"]))
    blk = dr.dflash_block(jnp.asarray(x["drafter/anchor"]), GAMMA,
                          dcfg.mask_token)
    res["drafter"] = np.asarray(dr.drafter_forward(bun.d1_params, dcfg, blk,
                                                   cache))

    # ---- the engine: two phases, page 8, prefix cache, engine pool --------
    # (each mesh and read path traces its own cycle once, so the banked
    # decode_collective_bytes is this engine's own)
    meta["engine"] = {}
    for p in MESHES:
        for impl in ("gather", "pallas"):
            with sh.use_sharding(mesh(p), RULES):
                eng = ServingEngine(pl.with_attn_impl(bun, impl),
                                    batch_size=2, seed=0, cache_impl="paged",
                                    page_size=PAGE, prefix_cache=True,
                                    pool_scope="engine")
            for part in ("engine/phase1", "engine/phase2"):
                for pr, n in x[part]:
                    eng.submit(pr, max_new=n)
                stats = eng.run()
            meta["engine"][f"{p}/{impl}"] = {
                "tokens": {str(r.uid): r.out.tolist() for r in eng.done},
                "stats": {k: (float(v) if isinstance(v, float) else int(v))
                          for k, v in stats.items()}}

    # ---- generate on a dense cache inside a 2-rank mesh (bf16 merges) -----
    with sh.use_sharding(mesh(2), RULES):
        res["generate"] = np.asarray(pl.generate(
            bun, jnp.asarray(x["generate/prompts"]), 16,
            max_len=256)["tokens"])

    out = Path(out)
    np.savez(out / "ref.npz", **res)
    (out / "ref.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    main(sys.argv[1])

"""kv_seq-sharded decode and mesh-resident serving in the port
(``repro_torch/distributed/{sharding,spdecode}.py``,
``repro_torch/launch/mesh.py``, the sharded pools of
``models/kvcache.py`` and the engine over them) held to the JAX package.

The JAX references are made once per module, in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` as
``tests/test_sharded_serving.py`` runs its own, on the meshes ``(data 1,
model 2)`` and ``(1, 4)`` (``_torch_sharded_jax.py``). While it runs, the
port's side runs one spawn of P gloo ranks per mesh size
(``launch.mesh.run_ranks``), each rank running every scenario
(``_torch_sharded_ranks.py``). Inputs come from numpy seeds
(``_torch_sharded_inputs.py``); the target and drafters are the tiny fp32
ones of ``conftest.py``, weights converted from the JAX params.

Every parity case keeps each rank's keys at or below ``attend_chunked``'s
``kv_chunk`` (1024): past it the port's chunk padding differs from JAX's
on purpose (ROADMAP.md queue 3).
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from conftest import tiny_drafter, tiny_target

import _torch_sharded_ranks as ranks
from _torch_parity import port_bundle
from _torch_sharded_inputs import DENSE_CASES, GAMMA, PAGE, VOCAB, inputs
from repro.config.base import SpecConfig as JSpec
from repro.core import pipeline as jpl
from repro.core.drafter import drafter_init as jdrafter_init
from repro.models import lm as jlm
from repro.models.blocks import period_spec
from repro_torch.core import pipeline as tpl
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.attention import attend_cache_plus_block
from repro_torch.serving.engine import ServingEngine

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
MESHES = (2, 4)
IMPLS = ("gather", "kernel")
JAX_IMPL = {"gather": "gather", "kernel": "pallas"}
TIMING = ("wall_s", "warm_cycle_s", "tokens_per_s")
MESH_IMPLS = [(p, impl) for p in MESHES for impl in IMPLS]
TREE = 10      # the comb tree's nodes at gamma 4, K 2: the verify read's Tq


@functools.lru_cache(maxsize=None)
def _bundles():
    """The JAX bundle (keys 0, 1, 2, as ``_torch_sharded_jax.bundle``) and
    the port's on each read path."""
    tcfg = tiny_target(vocab=VOCAB, dtype="float32")
    dcfg = tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        target_cfg=tcfg)
    jb = jpl.SpecBundle(tcfg, dcfg, dcfg,
                        JSpec(gamma=GAMMA, top_k_branches=2, mode="d2sd"),
                        jlm.lm_init(jax.random.PRNGKey(0), tcfg),
                        jdrafter_init(jax.random.PRNGKey(1), dcfg),
                        jdrafter_init(jax.random.PRNGKey(2), dcfg))
    tb = port_bundle(jb)
    return jb, {impl: tpl.with_attn_impl(tb, impl) for impl in IMPLS}


def _serve_unsharded(bundle, x):
    eng = ServingEngine(bundle, batch_size=2, seed=0, cache_impl="paged",
                        page_size=PAGE, prefix_cache=True,
                        pool_scope="engine", device="cpu")
    for part in ("engine/phase1", "engine/phase2"):
        for pr, n in x[part]:
            eng.submit(pr, max_new=n)
        eng.run()
    return {"tokens": {r.uid: r.out.tolist() for r in eng.done},
            "pools": {k: (a.numpy(), b.numpy())
                      for k, (a, b) in eng._pools.items()},
            "refcounts": eng.pool.refcounts()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX references (subprocess) beside the port's spawns: {"x": inputs,
    "port": {P: [rank results]}, "unsharded": {impl: engine run},
    "ref": arrays, "meta": tokens and stats}."""
    out = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS)])
    env.pop("JAX_PLATFORMS", None)
    with open(out / "jax.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(TESTS / "_torch_sharded_jax.py"), str(out)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            jb, tb = _bundles()
            x = inputs(jb.d1_cfg.target_feature_dim)
            port = {p: run_ranks(ranks.scenarios, p, p, tb, x, threads=1)
                    for p in MESHES}
            unsharded = {impl: _serve_unsharded(tb[impl], x)
                         for impl in IMPLS}
        finally:
            rc = proc.wait(timeout=900)
    assert rc == 0, (out / "jax.log").read_text()[-3000:]
    return {"x": x, "port": port, "unsharded": unsharded,
            "ref": dict(np.load(out / "ref.npz")),
            "meta": json.loads((out / "ref.json").read_text())}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _same_on_every_rank(results, *keys):
    """The value at ``keys`` of each rank's results, checked equal on
    every rank (the merged reads are replicated bit for bit)."""
    vals = []
    for res in results:
        v = res
        for k in keys:
            v = v[k]
        vals.append(v)
    for v in vals[1:]:
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, vals[0])
        else:
            assert v == vals[0]
    return vals[0]


@pytest.mark.parametrize("p", MESHES)
def test_sharded_cache_attend_matches_jax(runs, p):
    """The dense read, rolling and not, with a window and softcap: merged
    in fp32 at 2e-5 of JAX's, in bf16 at 2e-5 for 2 ranks (one bf16 add,
    order-free) and JAX's own 2e-2 for 4 (the order of the adds differs);
    both against the port's unsharded ``attend_cache_plus_block``."""
    d = {k[6:]: torch.from_numpy(np.array(v))
         for k, v in runs["x"].items() if k.startswith("dense/")}
    s = d["ck"].shape[1]
    for name, rolling, window, cap in DENSE_CASES:
        meshless = attend_cache_plus_block(
            d["q"], torch.cat([d["ck"], d["bk"]], 1),
            torch.cat([d["cv"], d["bv"]], 1), cache_cap=s,
            cache_len=d["cache_len"], q_abs=d["q_abs"], window=window,
            extra_mask=d["mask"], attn_softcap=cap, impl="dense",
            kv_chunk=64, rolling=rolling).numpy()
        for md in ("float32", "bfloat16"):
            got = _same_on_every_rank(runs["port"][p], "dense",
                                      f"{name}/{md}")
            tol = 2e-5 if md == "float32" or p == 2 else 2e-2
            _close(got, runs["ref"][f"dense/{p}/{name}/{md}"], tol)
            _close(got, meshless, 2e-5 if md == "float32" else 2e-2)


@pytest.mark.parametrize("p,impl", MESH_IMPLS)
def test_sharded_paged_cache_attend_matches_jax(runs, p, impl):
    """The paged read on each rank's run of every page (a shuffled table
    with sentinel tails, ragged lengths), by the gather of the local run
    and by kernel #2's plain version with pos_stride / pos_offset,
    against JAX's gather and Pallas (interpret mode) reads at 2e-5."""
    got = _same_on_every_rank(runs["port"][p], "paged", impl)
    _close(got, runs["ref"][f"paged/{p}/{JAX_IMPL[impl]}"], 2e-5)


@pytest.mark.parametrize("p,impl", MESH_IMPLS)
def test_sharded_drafter_read_matches_jax(runs, p, impl):
    """``drafter_forward`` on a paged feature cache that each rank wrote
    its run of (``extend_feat_cache`` inside the mesh), through the same
    hook as the verify read, against JAX's meshless logits at 2e-4
    (``test_sharded_serving.py``'s tolerance); the payload counter counts
    one merge a drafter layer, of JAX's byte formula."""
    jb, _ = _bundles()
    res = [r["drafter"][impl] for r in runs["port"][p]]
    dcfg = jb.d1_cfg
    b, t = 2, GAMMA
    per_call = b * dcfg.num_heads * t * ((dcfg.head_dim + 1) * 4 + 4)
    for r in res:
        _close(r["logits"], runs["ref"]["drafter"], 2e-4)
        assert r["calls"] == dcfg.num_layers, r["calls"]
        assert r["bytes"] == dcfg.num_layers * per_call, r["bytes"]


def _stats_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k in TIMING:
            continue
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-12), k
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.mark.parametrize("p,impl", MESH_IMPLS)
def test_sharded_engine_matches_jax_engine(runs, p, impl):
    """The two-phase workload (system prompt, wave turnover, radix hits
    across it; page 8, prefix cache, engine pool) through the sharded
    engine: per-request tokens and the whole stats dict equal to JAX's
    sharded engine on the same mesh (timing keys left out;
    ``decode_collective_bytes`` by the counting rule below), the same on
    every rank, whose books agreed at every wave's end."""
    want = runs["meta"]["engine"][f"{p}/{JAX_IMPL[impl]}"]
    toks = _same_on_every_rank(runs["port"][p], "engine", impl, "tokens")
    assert {str(u): t for u, t in toks.items()} == want["tokens"]
    stats = runs["port"][p][0]["engine"][impl]["stats"]
    for r in runs["port"][p][1:]:
        _stats_equal(r["engine"][impl]["stats"], stats)
    # decode_collective_bytes: JAX logs each sharded read once per TRACE,
    # and its target scans its layers, so one verify read a position of
    # the scanned period counts for every layer; the port counts every
    # call (ROADMAP.md queue 3). The rest of the dict is equal.
    jb, _ = _bundles()
    period, _, tail = period_spec(jb.target_cfg)
    cfg = jb.target_cfg
    folded = cfg.num_layers - len(period) - len(tail)
    verify_call = 2 * cfg.num_heads * TREE * ((cfg.head_dim + 1) * 4 + 4)
    n_disp = stats["cycles"] // 2             # every wave holds two rows
    assert stats["decode_collective_bytes"] == (
        want["stats"]["decode_collective_bytes"]
        + n_disp * folded * verify_call)
    _stats_equal(stats, dict(want["stats"], decode_collective_bytes=stats[
        "decode_collective_bytes"]))
    assert stats["kv_shards"] == p
    assert stats["pool_shard_slots"] * p == stats["pool_pages"] * PAGE
    assert stats["decode_collective_bytes"] > 0
    assert stats["prefix_hit_tokens"] > 0
    assert toks == runs["unsharded"][impl]["tokens"]


@pytest.mark.parametrize("p,impl", MESH_IMPLS)
def test_gathered_pools_equal_unsharded_pools(runs, p, impl):
    """Every rank's pools, put back together along the in-page slot axis,
    equal the unsharded port engine's pools at every live page (the
    writes drop the slots of other ranks, and drop nothing else); the
    host refcounts are the unsharded engine's."""
    ref = runs["unsharded"][impl]
    live = [i for i, c in enumerate(ref["refcounts"]) if c > 0]
    assert live
    for r in runs["port"][p]:
        assert r["engine"][impl]["refcounts"] == ref["refcounts"]
    for name, (k_ref, v_ref) in ref["pools"].items():
        for j, want in enumerate((k_ref, v_ref)):
            got = np.concatenate([r["engine"][impl]["pools"][name][j]
                                  for r in runs["port"][p]], axis=-3)
            assert got.shape == want.shape, (name, got.shape, want.shape)
            _close(got[..., live, :, :, :], want[..., live, :, :, :], 1e-5)


@pytest.mark.parametrize("p,impl", MESH_IMPLS)
def test_engine_runs_at_rank_storage(runs, p, impl):
    """F1 in the sharded engine (ROADMAP.md item 10f): built inside the
    mesh, the engine of :func:`test_sharded_engine_matches_jax_engine`
    keeps the rank's serving storage of the bundle
    (``pipeline.serve_storage``), fewer weight bytes than the whole
    bundle, and gathers its weights a layer at a time in its run
    (``sharding.WEIGHTS``); so does the dense ``generate`` of
    :func:`test_generate_dense_mesh_matches_jax` on 2 ranks."""
    for r in runs["port"][p]:
        st = r["engine"][impl]["storage"]
        assert st["cut"] and st["bytes"] < st["whole"]
        calls, received = st["gathers"]
        assert calls > 0 and received > 0
        if p == 2:
            calls, received = r["generate_gathers"]
            assert calls > 0 and received > 0


@pytest.mark.parametrize("p", MESHES)
def test_rank_hash_check_catches_disagreement(runs, p):
    """One rank's spoiled committed token makes every rank's check raise."""
    assert all(r["hash_check_raises"] for r in runs["port"][p])


def test_generate_dense_mesh_matches_jax(runs):
    """``pipeline.generate`` on dense caches (capacity 256: 128 slots a
    rank, the dense hook's gate) inside a 2-rank mesh, target and both
    drafters merging in bf16: tokens equal JAX's on the same mesh."""
    got = _same_on_every_rank(runs["port"][2], "generate")
    np.testing.assert_array_equal(got, runs["ref"]["generate"])


def test_dense_merge_quirk_pinned(runs):
    """The reference quirk the port mirrors (ROADMAP.md queue 3): the
    dense hook merges a float32 model's reads in bfloat16, so on the
    smallest input both packages stray from their meshless reads by more
    than 1e-4, alike, and agree with each other."""
    q = {k[6:]: torch.from_numpy(np.array(v))
         for k, v in runs["x"].items() if k.startswith("quirk/")}
    meshless = attend_cache_plus_block(
        q["q"], torch.cat([q["k"], q["bk"]], 1),
        torch.cat([q["v"], q["bv"]], 1), cache_cap=2,
        cache_len=q["cache_len"], q_abs=q["q_abs"], window=None,
        extra_mask=torch.ones((1, 1), dtype=torch.bool), attn_softcap=None,
        impl="dense", kv_chunk=64, rolling=False).numpy()
    got = _same_on_every_rank(runs["port"][2], "quirk")
    ref = runs["ref"]
    _close(meshless, ref["quirk/meshless"], 1e-6)
    assert np.abs(got - meshless).max() > 1e-4
    assert np.abs(ref["quirk/sharded"] - ref["quirk/meshless"]).max() > 1e-4
    _close(got, ref["quirk/sharded"], 2e-5)


def test_mesh_refusals(runs):
    """The graph loop inside a ``make_mesh(data=2)`` mesh (naming
    ROADMAP.md item 9b), a page the axis does not divide and
    ``generate_ondevice`` inside a mesh each raise the documented
    error."""
    assert runs["port"][2][0]["refusals"] == {
        "make_mesh_data": "NotImplementedError",
        "page_not_divisible": "ValueError",
        "generate_ondevice": "NotImplementedError"}


def test_serve_launcher_mesh_model():
    """``launch/serve.py --mesh-model 2`` spawns its ranks and rank 0
    prints the summary with the mesh note."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh-model", "2", "--cache-impl", "paged", "--page-size", "16",
         "--prefix-cache", "--requests", "3", "--max-new", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if "served" in ln]
    assert len(lines) == 1 and "kv_shards=2" in lines[0], out.stdout


def test_cut_depth_init_draws_the_deep_inits_weights():
    """``chip_smoke.py``'s sharded ranks build the serving bundle at its
    cut depth straight from the seeds (``build_bundle(layers=)``), not
    from the full bundle: ``lm_init`` draws the embedding and head before
    the layers, in order, so a 6-layer init holds the first 6 layers of
    a deeper one, bit for bit (here at a narrow width)."""
    import dataclasses

    from repro_torch.configs import paper_target
    from repro_torch.models import lm as tlm

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    cfg = paper_target.smoke()
    deep = tlm.lm_init(dataclasses.replace(cfg, num_layers=8), seed=0,
                       device="cpu")
    cut = tlm.lm_init(dataclasses.replace(cfg, num_layers=6), seed=0,
                      device="cpu")
    deep["layers"] = deep["layers"][:6]
    got, want = dict(leaves(cut)), dict(leaves(deep))
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name

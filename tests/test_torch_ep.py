"""Expert parallelism in the port (``repro_torch/distributed/ep.py``, the
data axis's process groups of ``launch/mesh.py``,
``distributed/collectives.py``) held to the JAX package.

The JAX references are made once per module, in two subprocesses side
by side under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``_torch_ep_jax.py``: the sharded engines in one, the rest in the other)
on the meshes ``(data 1, model 2)``, ``(1, 4)``, ``(2, 2)`` and ``(4,)``.
While they run, the port's side runs one spawn of 2 gloo ranks and one of
4 (``launch.mesh.run_ranks``; the 4-rank spawn builds the ``(1, 4)``,
``(2, 2)`` and ``(4, 1)`` meshes in turn), each rank running every
scenario (``_torch_ep_ranks.py``). Inputs come from numpy seeds
(``_torch_ep_inputs.py``); weights are JAX's, converted and then cut to
each rank's part of the expert stacks (``ep_local_params``,
``ep_shard_target``).

The fault this file pins: inside a mesh whose ``experts`` axis is active,
JAX's ``moe_apply`` goes to ``moe_apply_ep``, whose capacity comes from a
rank's own token count (``max(8, int(t k / E cf) + 1)``) where the local
path's is ``max(ceil(T k / E cf), min(8, T))``; a port that ignored the
mesh served a MoE target with the meshless result
(``test_ep_engine_matches_jax_engine``).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ep_ranks as ranks
from _torch_ep_inputs import (GRAD_CASES, LAYER_CASES, MESHES, PAGE,
                              layer_config_kw)
from _torch_ep_jax import (CF_NODROP, cgrad_inputs, layer_case, moe_bundle,
                          moe_target_cfg)
from _torch_parity import port_bundle, port_model_cfg, t
from _torch_sharded_inputs import engine_requests
from repro.models.blocks import period_spec
from repro_torch.config.base import ModelConfig, MoEConfig
from repro_torch.core import pipeline as tpl
from repro_torch.distributed import ep
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import ServingEngine

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
IMPLS = ("gather", "kernel")
PARTS = ("layers", "engines")       # the JAX references' two subprocesses
JAX_IMPL = {"gather": "gather", "kernel": "pallas"}
ENGINE_MESH_IMPLS = [(p, impl) for p in (2, 4) for impl in IMPLS]
TIMING = ("wall_s", "warm_cycle_s", "tokens_per_s")
TREE = 10      # the comb tree's nodes at gamma 4, K 2: the verify read's Tq
LAYER_IDS = [f"{d}x{m}-{c[0]}" for d, m in MESHES for c in LAYER_CASES]
GRAD_IDS = [f"{d}x{m}-{c}" for d, m in MESHES for c in GRAD_CASES]


@functools.lru_cache(maxsize=None)
def _port_inputs():
    """The ranks' inputs (see ``_torch_ep_ranks.scenarios``) and the port's
    meshless engine runs."""
    cases = {}
    for i, (name, *_) in enumerate(LAYER_CASES):
        jcfg, p, x, w = layer_case(i, name)
        cases[name] = (port_model_cfg(jcfg), {
            k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else t(v)) for k, v in p.items()},
            t(x).to(getattr(torch, jcfg.dtype)), t(w))
    tb = port_bundle(moe_bundle())
    cfg = tb.target_cfg
    nodrop = dataclasses.replace(tb, target_cfg=dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=CF_NODROP)))
    return {"cases": cases,
            "bundles": {impl: tpl.with_attn_impl(tb, impl) for impl in IMPLS},
            "nodrop": nodrop,
            "prompts": np.random.default_rng(3).integers(
                3, 61, (2, 12)).astype(np.int32),
            "cgrad": cgrad_inputs()}


def _serve_meshless(bundle):
    eng = ServingEngine(bundle, batch_size=2, seed=0, cache_impl="paged",
                        page_size=PAGE, prefix_cache=True,
                        pool_scope="engine", device="cpu")
    for part in engine_requests():
        for pr, n in part:
            eng.submit(pr, max_new=n)
        eng.run()
    return {r.uid: r.out.tolist() for r in eng.done}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX references (two subprocesses) beside the port's spawns:
    {"port": {n: [rank results]}, "meshless": port engine tokens at cf
    1.25 and E/k, "ref": arrays, "meta": tokens and stats}."""
    out = tmp_path_factory.mktemp("ep_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS)])
    env.pop("JAX_PLATFORMS", None)
    procs = {}
    try:
        for part in PARTS:
            with open(out / f"jax_{part}.log", "w") as log:
                procs[part] = subprocess.Popen(
                    [sys.executable, str(TESTS / "_torch_ep_jax.py"),
                     str(out), part],
                    env=env, stdout=log, stderr=subprocess.STDOUT)
        x = _port_inputs()
        port = {n: run_ranks(ranks.scenarios, n, n, x, threads=1)
                for n in (2, 4)}
        meshless = {"engine": _serve_meshless(x["bundles"]["gather"]),
                    "nodrop": _serve_meshless(x["nodrop"])}
    finally:
        rcs = {part: proc.wait(timeout=900) for part, proc in procs.items()}
    ref, meta = {}, {}
    for part, rc in rcs.items():
        assert rc == 0, (out / f"jax_{part}.log").read_text()[-3000:]
        ref.update(np.load(out / f"ref_{part}.npz"))
        meta.update(json.loads((out / f"ref_{part}.json").read_text()))
    return {"port": port, "meshless": meshless, "ref": ref, "meta": meta}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rank_results(runs, mesh):
    d, m = mesh
    return runs["port"][d * m]


@pytest.mark.parametrize("mesh,case", [
    ((d, m), c[0]) for d, m in MESHES for c in LAYER_CASES], ids=LAYER_IDS)
def test_layer_matches_jax(runs, mesh, case):
    """``moe_apply`` inside the mesh (expert parallelism, this rank's part
    of the stacks, all of x) against JAX's: fp32 at 2e-5; bf16 (x, the
    experts' products and the combine in bfloat16, in JAX's order and
    rounding) within 2 bf16 ulps at the largest magnitude of JAX's output
    (the products' rounding differs by one), which a wrong slice, combine
    or all-reduce exceeds many times over. Every rank returns the same
    bits; under a data split each data rank ran its experts over its own
    run of the tokens (JAX's batch fit)."""
    d, m = mesh
    key = f"{d}x{m}"
    want = runs["ref"][f"layer/{key}/{case}"]
    want = want.reshape(-1, want.shape[-1])
    row = LAYER_CASES[[c[0] for c in LAYER_CASES].index(case)]
    results = _rank_results(runs, mesh)
    for r in results:
        rec = r["layer"][key][case]
        if row[9] == "bfloat16":
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            err = np.abs(rec["y"] - want).max() / ulp
            assert err <= 2, err
        else:
            _close(rec["y"], want, 2e-5)
        np.testing.assert_array_equal(rec["y"],
                                      results[0]["layer"][key][case]["y"])
    n = row[6] * row[7]
    split = d if n % d == 0 else 1
    assert sorted({tuple(r["layer"][key][case]["slice"]) for r in results}) \
        == [(i * n // split, (i + 1) * n // split) for i in range(split)]


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_skewed_layer_leaves_the_meshless_result(runs, mesh):
    """The fault's smallest form: on the skewed inputs (every token's
    first pick is expert 0, so the capacity binds), JAX's expert-parallel
    layer is not its meshless layer; the port returns the former."""
    key = f"{mesh[0]}x{mesh[1]}"
    for name in ("e4_gated_skew", "e4_plain_shared"):
        ep_out = runs["ref"][f"layer/{key}/{name}"]
        meshless = runs["ref"][f"layer/meshless/{name}"]
        assert np.abs(ep_out - meshless).max() > 0.1, name


@pytest.mark.parametrize("mesh,case", [((d, m), c) for d, m in MESHES
                                       for c in GRAD_CASES], ids=GRAD_IDS)
def test_grad_matches_jax(runs, mesh, case):
    """The port's autograd of ``sum(moe_apply(p, x) * w)`` on each rank
    against ``jax.grad`` inside the same mesh at 1e-5: the router's, the
    shared expert's and ``x``'s gradients whole and equal on every rank,
    each expert stack's gradient this rank's part of JAX's (at (2, 2)
    summed over the data ranks' runs, as JAX's)."""
    d, m = mesh
    key = f"{d}x{m}"
    cfg = _port_inputs()["cases"][case][0]
    ref = {k[len(f"grad/{key}/{case}/"):]: v for k, v in runs["ref"].items()
           if k.startswith(f"grad/{key}/{case}/")}
    results = _rank_results(runs, mesh)
    for rank, r in enumerate(results):
        got = r["layer"][key][case]["grad"]
        assert set(got) == set(ref), set(got) ^ set(ref)
        part = ep.expert_part(cfg, rank % m, m)
        for name, want in ref.items():
            if name in ("moe_w_in", "moe_w_gate", "moe_w_out"):
                want = ep.slice_stack(name, torch.from_numpy(want),
                                      part).numpy()
                np.testing.assert_array_equal(
                    got[name], results[rank % m]["layer"][key][case]["grad"][
                        name])
            else:
                np.testing.assert_array_equal(
                    got[name], results[0]["layer"][key][case]["grad"][name])
            _close(got[name], want, 1e-5)


def _stats_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k in TIMING:
            continue
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-12), k
        else:
            assert got[k] == w, (k, got[k], w)


def _tokens(results, key):
    """``key``'s tokens of every rank, checked equal, by request id."""
    toks = [r[key]["tokens"] if isinstance(key, str) else
            r[key[0]][key[1]]["tokens"] for r in results]
    for tk in toks[1:]:
        assert tk == toks[0]
    return {str(u): v for u, v in toks[0].items()}


@pytest.mark.parametrize("p,impl", ENGINE_MESH_IMPLS)
def test_ep_engine_matches_jax_engine(runs, p, impl):
    """The MoE target (4 experts, top 2, capacity factor 1.25) through the
    two-phase workload (page 8, prefix cache, engine pool) in a (1, P)
    mesh with kv_seq and experts on "model": per-request tokens and the
    stats dict equal to JAX's sharded engine (timing keys left out;
    ``decode_collective_bytes`` by the counting rule of ROADMAP.md queue
    3), the same on every rank, whose books agreed at the end. On this
    workload JAX's sharded tokens are not its meshless tokens (the
    requests below), so the case fails without expert parallelism; the
    port's meshless engine gives JAX's meshless tokens."""
    want = runs["meta"]["engine"][f"{p}/{JAX_IMPL[impl]}"]
    results = runs["port"][p]
    toks = _tokens(results, ("engine", impl))
    assert toks == want["tokens"]
    meshless = runs["meta"]["meshless"]["tokens"]
    differ = sorted(int(u) for u in want["tokens"]
                    if want["tokens"][u] != meshless[u])
    assert differ == [1, 5, 7], differ
    assert {str(u): v for u, v in runs["meshless"]["engine"].items()} \
        == meshless
    stats = results[0]["engine"][impl]["stats"]
    for r in results[1:]:
        _stats_equal(r["engine"][impl]["stats"], stats)
        assert r["engine"][impl]["reduces"] == \
            results[0]["engine"][impl]["reduces"]
    assert results[0]["engine"][impl]["reduces"][0] > 0
    # decode_collective_bytes: JAX logs each sharded read once per TRACE
    # over its scanned layers; the port counts every call
    cfg = moe_target_cfg()
    period, _, tail = period_spec(cfg)
    folded = cfg.num_layers - len(period) - len(tail)
    verify_call = 2 * cfg.num_heads * TREE * ((cfg.head_dim + 1) * 4 + 4)
    n_disp = stats["cycles"] // 2             # every wave holds two rows
    assert stats["decode_collective_bytes"] == (
        want["stats"]["decode_collective_bytes"]
        + n_disp * folded * verify_call)
    _stats_equal(stats, dict(want["stats"], decode_collective_bytes=stats[
        "decode_collective_bytes"]))
    assert stats["kv_shards"] == p


def test_nodrop_sharded_equals_meshless(runs):
    """At capacity factor E/k nothing can drop under either capacity
    rule: the sharded and the meshless engines give the same tokens, in
    both packages, and the port's are JAX's."""
    meta = runs["meta"]["nodrop"]
    assert meta["2"]["tokens"] == meta["meshless"]["tokens"]
    assert _tokens(runs["port"][2], "nodrop") == meta["2"]["tokens"]
    assert {str(u): v for u, v in runs["meshless"]["nodrop"].items()} \
        == meta["meshless"]["tokens"]


def test_generate_dense_mesh_matches_jax(runs):
    """``pipeline.generate`` on a dense cache (capacity 256) inside a
    2-rank mesh with the target's experts split: tokens equal JAX's on
    the same mesh, the same on both ranks."""
    got = [r["generate"] for r in runs["port"][2]]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], runs["ref"]["generate"])


def test_compressed_grad_allreduce_matches_jax(runs):
    """Two steps of ``compressed_grad_allreduce`` over data 4, the error
    state carried: each rank's mean and new error state equal JAX's
    (``shard_map`` over 4 host devices) at 1e-6; JAX's own bounds hold
    (relative error of the mean under 0.02, residual under max|g| /
    100)."""
    steps = _port_inputs()["cgrad"]
    for s, g in enumerate(steps):
        true_mean = g.mean(0)
        for rank, r in enumerate(runs["port"][4]):
            mean, err = r["cgrad"][s]
            _close(mean, runs["ref"][f"cgrad/{s}/mean"][rank], 1e-6)
            _close(err, runs["ref"][f"cgrad/{s}/err"][rank], 1e-6)
            assert np.abs(mean - true_mean).max() \
                / np.abs(true_mean).max() < 0.02
            assert np.abs(err).max() < np.abs(g).max() / 100


def test_refusals(runs):
    """Inside an experts mesh a full expert stack raises ``ValueError``
    (nothing slices it quietly) and a MoE target's graph loop
    ``NotImplementedError`` with the kv_seq axis off too (the EP
    all-reduce is a host-side collective); inside a data-2 mesh the
    engine serves (nothing raised) and the graph loop with only the batch
    axes raises ``NotImplementedError`` naming ROADMAP.md item 9b; and
    ``launch/serve.py --mesh-data 2`` serves its requests over two
    ranks."""
    from repro_torch.launch import serve
    for r in runs["port"][4]:
        assert r["refusals"] == {"full_stack": "ValueError",
                                 "graph_loop": "NotImplementedError",
                                 "engine_data": None,
                                 "generate_data": "NotImplementedError"}
    stats = serve.main(["--device", "cpu", "--mesh-data", "2",
                        "--requests", "2", "--max-new", "4"])
    assert stats["tokens"] == 8, stats


@pytest.mark.parametrize("kv_seq", ["model", "off"])
def test_serve_launcher_moe_mesh(kv_seq):
    """``launch/serve.py --arch grok-1-314b --mesh-model 2`` serves its
    smoke MoE target with each rank holding half of every expert stack
    (the meshless path could not run on them), the pool sharded (rank 0
    prints ``kv_shards=2``) or, with ``--kv-seq-axis off``, replicated."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "grok-1-314b", "--mesh-model", "2", "--cache-impl",
         "paged", "--prefix-cache", "--requests", "3", "--max-new", "8",
         "--kv-seq-axis", kv_seq],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if "served" in ln]
    assert len(lines) == 1, out.stdout
    assert ("kv_shards=2" in lines[0]) == (kv_seq == "model"), lines[0]


def _fake_mesh(m, rank):
    return sh.Mesh(("data", "model"), (1, m), (0, rank), (None, None))


@pytest.mark.parametrize("m", [2, 8], ids=["experts_split", "dff_split"])
def test_sliced_init_equals_ep_local_params(m):
    """``lm_init(expert_part=)`` draws every expert as the full build does
    and keeps this rank's part: equal, bit for bit, to
    ``ep_shard_target`` of the full build, in both regimes (4 experts
    over 2 ranks; over 8, each expert's d_ff in halves), in fp32 and in
    bf16 stacks."""
    base = ModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                       d_ff=64, vocab_size=97, max_seq_len=64, remat=False,
                       dtype="float32", moe=MoEConfig(
                           4, top_k=2, capacity_factor=1.25,
                           dispatch="scatter", num_shared_experts=1))
    for pd in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=pd)
        full = tlm.lm_init(cfg, seed=0, device="cpu")
        for rank in range(m):
            mesh = _fake_mesh(m, rank)
            want = ep.ep_shard_target(full, cfg, mesh)
            got = tlm.lm_init(cfg, seed=0, device="cpu",
                              expert_part=ep.mesh_expert_part(cfg, mesh))
            for lw, lg in zip(want["layers"], got["layers"]):
                for k, v in lw["ffn"].items():
                    if isinstance(v, dict):
                        for kk, vv in v.items():
                            assert torch.equal(lg["ffn"][k][kk], vv)
                    else:
                        assert lg["ffn"][k].shape == v.shape, k
                        assert torch.equal(lg["ffn"][k], v), k
                        assert lg["ffn"][k].is_contiguous()


def test_ep_available_and_capacity_rules():
    """``ep_available``'s two regimes and its refusals; EP's capacity
    from the rank's own token count with no ``min(8, T)``; JAX's batch
    fit of the tokens over a data axis."""
    def cfg(e, dff=128):
        return ModelConfig(d_model=64, d_ff=dff, moe=MoEConfig(
            e, top_k=1, capacity_factor=1.25, dispatch="scatter"))
    for m, e, dff, want in ((2, 4, 128, True), (4, 2, 128, True),
                            (4, 2, 127, False), (3, 4, 128, False),
                            (1, 4, 128, False)):
        with sh.use_sharding(_fake_mesh(m, 0)):
            assert ep.ep_available(cfg(e, dff)) == want, (m, e, dff)
        with sh.use_sharding(_fake_mesh(m, 0),
                             dict(sh.LOGICAL_RULES, experts=None)):
            assert not ep.ep_available(cfg(e, dff))
    assert not ep.ep_available(cfg(4))            # no mesh
    c = port_model_cfg(layer_case(0, "e4_gated_skew")[0])
    assert [ep.ep_capacity(n, c) for n in (1, 2, 16, 17, 304)] == [
        8, 8, 11, 11, 191]
    m22 = sh.Mesh(("data", "model"), (2, 2), (1, 0), (None, None))
    assert ep.data_slice(16, m22) == (8, 16)
    assert ep.data_slice(7, m22) == (0, 7)
    kw, mkw = layer_config_kw("e1_gated")
    assert ep.expert_part(ModelConfig(**kw, moe=MoEConfig(**mkw)), 3, 4) \
        == (0, 1, 96, 32)

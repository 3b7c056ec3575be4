"""The mesh's batch axes in the port (ROADMAP.md item 9a:
``repro_torch/distributed/sharding.py``'s ``logical_to_pspec``,
``fit_spec`` and ``batch_run``, ``launch/mesh.py``'s ``pod`` axis and
batch group, the pool replicated over the batch axes and its gathered
writes, ``generate`` and the engine with a wave's rows split over data)
held to the JAX package.

The JAX references are made once per module, in two subprocesses side
by side under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``_torch_data_jax.py``: the ``(data 2, model 1)`` mesh in one, ``(2,
2)`` and ``(pod 2, data 2, model 1)`` in the other). While they run, the
port's side runs one
spawn of 2 gloo ranks (the ``(2, 1)`` mesh) and one of 4 (``(2, 2)``,
then pod 2 x data 2), each rank running every scenario
(``_torch_data_ranks.py``, which imports no JAX). Inputs come from numpy
seeds (``_torch_data_inputs.py``, the engine's two-phase workload of
``_torch_sharded_inputs.py``); the targets and drafters are the tiny fp32
ones of ``conftest.py``, weights converted from the JAX params.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import _torch_data_ranks as ranks
from _torch_data_inputs import GEN_NEW, generate_prompts
from _torch_ep_jax import moe_bundle, moe_target_cfg
from _torch_parity import port_bundle
from _torch_sharded_inputs import engine_requests
from _torch_sharded_jax import bundle as jax_bundle
from repro.distributed import sharding as jsh
from repro.models.blocks import period_spec
from repro_torch.core import pipeline as tpl
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import run_ranks
from repro_torch.serving.engine import ServingEngine

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
IMPLS = ("gather", "kernel")
JAX_IMPL = {"gather": "gather", "kernel": "pallas"}
TIMING = ("wall_s", "warm_cycle_s", "tokens_per_s")
TREE = 10      # the comb tree's nodes at gamma 4, K 2: the verify read's Tq
#: mesh name -> (axis names, shape)
MESH_SHAPES = {"1x2": (("data", "model"), (1, 2)),
               "2x1": (("data", "model"), (2, 1)),
               "2x2": (("data", "model"), (2, 2)),
               "pod2x2": (("pod", "data", "model"), (2, 2, 1))}
SPAWN = {"2x1": 2, "2x2": 4, "pod2x2": 4}
PARTS = ("2x1", "2x2")      # the JAX references' two subprocesses
ENGINE_CASES = [(m, impl) for m in ("2x1", "2x2") for impl in IMPLS]
LOGICAL = [("batch",), ("batch", "seq", "embed"),
           ("batch", "kv_seq", "kv_heads", None), ("vocab", "embed_fsdp"),
           ("embed_fsdp", "ffn"), ("experts", None, "expert_ffn"),
           ("stage", "batch", "heads"), (None, "act_seq"),
           ("batch", "embed_fsdp")]
SHAPES = [(1, 12, 8, 4), (2, 12, 8, 4), (3, 12, 8, 4), (4, 6, 2, 4),
          (6, 9, 4, 4), (8, 16, 6, 4)]


def _fake_jax_mesh(name):
    """What JAX's ``logical_to_pspec`` and ``fit_spec`` read of a mesh:
    its axis names and its devices' shape."""
    names, shape = MESH_SHAPES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(name, coords=None):
    names, shape = MESH_SHAPES[name]
    coords = coords or (0,) * len(shape)
    return tsh.Mesh(names, shape, coords, (None,) * len(shape))


@functools.lru_cache(maxsize=None)
def _bundles():
    """The port's tiny bundles (JAX keys 0, 1, 2, converted)."""
    tb = port_bundle(jax_bundle())
    return {"bundles": {impl: tpl.with_attn_impl(tb, impl) for impl in IMPLS},
            "sampled": dataclasses.replace(tb, spec=dataclasses.replace(
                tb.spec, temperature=1.0)),
            "moe": tpl.with_attn_impl(port_bundle(moe_bundle()), "gather")}


def _serve_meshless(bundle):
    eng = ServingEngine(bundle, batch_size=2, seed=0, cache_impl="paged",
                        page_size=8, prefix_cache=True, pool_scope="engine",
                        device="cpu")
    for part in engine_requests():
        for pr, n in part:
            eng.submit(pr, max_new=n)
        eng.run()
    return {str(r.uid): r.out.tolist() for r in eng.done}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX references (subprocess) beside the port's spawns: {"port": {n:
    [rank results]}, "meshless": port tokens, "sampled": the meshless
    port's sampled tokens, "ref": arrays, "meta": tokens and stats}."""
    out = tmp_path_factory.mktemp("data_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS)])
    env.pop("JAX_PLATFORMS", None)
    procs = {}
    try:
        for part in PARTS:
            with open(out / f"jax_{part}.log", "w") as log:
                procs[part] = subprocess.Popen(
                    [sys.executable, str(TESTS / "_torch_data_jax.py"),
                     str(out), part],
                    env=env, stdout=log, stderr=subprocess.STDOUT)
        x = _bundles()
        port = {n: run_ranks(ranks.scenarios, n, n, x, threads=1)
                for n in (2, 4)}
        meshless = _serve_meshless(x["bundles"]["gather"])
        sampled = tpl.generate(x["sampled"], generate_prompts(), GEN_NEW,
                               seed=5, device="cpu")["tokens"]
    finally:
        rcs = {part: proc.wait(timeout=900) for part, proc in procs.items()}
    ref, meta = {}, {"engine": {}}
    for part, rc in rcs.items():
        assert rc == 0, (out / f"jax_{part}.log").read_text()[-3000:]
        ref.update(np.load(out / f"ref_{part}.npz"))
        m = json.loads((out / f"ref_{part}.json").read_text())
        meta["engine"].update(m.pop("engine"))
        meta.update(m)
    return {"port": port, "meshless": meshless, "sampled": sampled,
            "ref": ref, "meta": meta}


def _same(results, *keys):
    """The value at ``keys`` of each rank's results, checked equal on
    every rank."""
    vals = []
    for r in results:
        for k in keys:
            r = r[k]
        vals.append(r)
    for v in vals[1:]:
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, vals[0])
        else:
            assert v == vals[0]
    return vals[0]


def _rank_stats(results, *keys):
    """Rank 0's stats at ``keys``, checked equal on every rank but for
    the timing keys."""
    stats = [r for r in results]
    for k in keys + ("stats",):
        stats = [s[k] for s in stats]
    for s in stats[1:]:
        _stats_equal(s, stats[0])
    return stats[0]


def _stats_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k in TIMING:
            continue
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-12), k
        else:
            assert got[k] == w, (k, got[k], w)


def _payload_relation(stats, want, cfg, batch_shards):
    """``decode_collective_bytes``: JAX logs each sharded read once per
    TRACE, over its scanned layers and the whole batch; the port counts
    every call over this rank's rows. With every wave's two rows split,
    a rank's count is half of JAX's once the folded layers' reads are
    added back (the relation of ``test_torch_sharded.py``)."""
    period, _, tail = period_spec(cfg)
    folded = cfg.num_layers - len(period) - len(tail)
    verify_call = 2 * cfg.num_heads * TREE * ((cfg.head_dim + 1) * 4 + 4)
    n_disp = stats["cycles"] // 2             # every wave holds two rows
    full = want["stats"]["decode_collective_bytes"] \
        + n_disp * folded * verify_call
    assert full % batch_shards == 0
    assert stats["decode_collective_bytes"] == full // batch_shards
    _stats_equal(stats, dict(want["stats"], decode_collective_bytes=stats[
        "decode_collective_bytes"]))


@pytest.mark.parametrize("name", list(MESH_SHAPES))
def test_logical_to_pspec_and_fit_spec_match_jax(name):
    """JAX's ``logical_to_pspec`` and ``fit_spec`` (a mesh's axis names
    and devices' shape are all they read) against the port's twins on a
    table of logical tuples and shapes, under the default rules and with
    kv_seq over data; B from 1 to 8, so that the batch axes divide it,
    in part (pod but not data) or not at all. ``batch_run``'s runs tile
    the rows in the flattened (pod, data) order, first major."""
    jm, names_shape = _fake_jax_mesh(name), MESH_SHAPES[name]
    tm = _port_mesh(name)
    for rules in (tsh.LOGICAL_RULES, dict(tsh.LOGICAL_RULES, kv_seq="data")):
        for logical in LOGICAL:
            want = jsh.logical_to_pspec(logical, jm, dict(rules))
            got = tsh.logical_to_pspec(logical, tm, dict(rules))
            assert got == tuple(want), (logical, got, want)
            for shape in SHAPES:
                shape = shape[:len(logical)]
                assert tsh.fit_spec(got, shape, tm) == tuple(
                    jsh.fit_spec(want, shape, jm)), (logical, shape)
    names, shape = names_shape
    for b in range(1, 9):
        spans = []
        for coords in np.ndindex(*shape):
            run = tsh.batch_run(b, _port_mesh(name, coords))
            entry = tsh.fit_spec(tsh.logical_to_pspec(("batch",), tm),
                                 (b,), tm)[0]
            assert run.axes == ((entry,) if isinstance(entry, str)
                                else entry or ())
            spans.append((run.lo, run.n))
        n = b // tm.size(tsh.batch_axes(b, tm))
        assert {s for s in spans} == {(i * n, n) for i in range(b // n)}


@pytest.mark.parametrize("mesh,impl", ENGINE_CASES)
def test_engine_matches_jax_engine(runs, mesh, impl):
    """The two-phase workload (system prompt, wave turnover, radix hits
    across it; batch 2, page 8, prefix cache, engine pool) through the
    engine with each wave's two rows split over data 2: per-request
    tokens equal to JAX's engine on the same mesh and to the port's
    meshless engine (which ``test_torch_sharded.py`` and
    ``test_torch_serving.py`` hold to JAX's), the same on every rank;
    the stats dict
    equal to JAX's (timing keys left out; ``decode_collective_bytes`` by
    the relation of :func:`_payload_relation`); the pool-write gathers
    ran, one a cycle and one an install."""
    results = runs["port"][SPAWN[mesh]]
    for r in results:
        assert r["run"].split and r["run"].axes == ("data",)
    want = runs["meta"]["engine"][f"{mesh}/{JAX_IMPL[impl]}"]
    toks = {str(u): t for u, t in _same(results, "engine", impl,
                                        "tokens").items()}
    assert toks == want["tokens"]
    assert toks == runs["meshless"]
    stats = _rank_stats(results, "engine", impl)
    _payload_relation(stats, want, jax_bundle().target_cfg, 2)
    assert stats["kv_shards"] == MESH_SHAPES[mesh][1][1]
    assert stats["prefix_hit_tokens"] > 0 and stats["cow_copies"] >= 0
    for r in results:
        calls, sent = r["engine"][impl]["writes"]
        assert calls == stats["cycles"] // 2 + stats["install_calls"]
        assert sent > 0


@pytest.mark.parametrize("mesh,impl", ENGINE_CASES)
def test_engine_runs_at_rank_storage(runs, mesh, impl):
    """F1 in the data engines (ROADMAP.md item 10f): the engine of
    :func:`test_engine_matches_jax_engine` keeps the rank's serving
    storage of the bundle (``pipeline.serve_storage``). Where the model
    axis cuts a weight ((2, 2)) the rank stores its slices and gathers
    its weights a layer at a time (``sharding.WEIGHTS``); at model 1
    ((2, 1)) the rules cut nothing and nothing is gathered."""
    cut = MESH_SHAPES[mesh][1][1] > 1
    for r in runs["port"][SPAWN[mesh]]:
        st = r["engine"][impl]["storage"]
        calls, received = st["gathers"]
        assert st["cut"] == cut
        assert (calls > 0) == cut and (received > 0) == cut


def test_wave_of_three_rows_is_not_split(runs):
    """Batch 3 over data 2: a wave of three rows is not split (every rank
    runs every row, as JAX's fit replicates it), a wave of two is; the
    tokens equal JAX's engine's on the same mesh and on every rank."""
    want = runs["meta"]["wave3"]
    results = runs["port"][2]
    toks = {str(u): t for u, t in _same(results, "wave3", "tokens").items()}
    assert toks == want["tokens"]
    assert not tsh.batch_run(3, _port_mesh("2x1", (1, 0))).split
    assert tsh.batch_run(2, _port_mesh("2x1", (1, 0))) == tsh.BatchRun(
        2, 1, 1, ("data",))


@pytest.mark.parametrize("mesh", ["2x1", "pod2x2"])
def test_generate_dense_matches_jax(runs, mesh):
    """``pipeline.generate`` on a dense cache, four rows split over data 2
    (two a rank) or over pod 2 x data 2 (one a rank): tokens equal JAX's
    on the same mesh, the same on every rank, which held its run."""
    results = runs["port"][SPAWN[mesh]]
    got = _same(results, "generate")
    np.testing.assert_array_equal(got, runs["ref"][f"generate/{mesh}"])
    if mesh == "pod2x2":
        assert sorted((r["pod_run"].lo, r["pod_run"].n) for r in results) \
            == [(i, 1) for i in range(4)]
        assert results[0]["pod_run"].axes == ("pod", "data")


def test_moe_ep_engine_matches_jax_engine(runs):
    """The tiny MoE target (4 experts, top 2, capacity factor 1.25) with
    its experts split over model 2 and each wave's rows over data 2:
    expert parallelism fits each rank's tokens as JAX fits the whole
    batch's (``ep.row_runs``). Tokens and the stats dict equal JAX's
    engine on the same mesh, the same on every rank."""
    want = runs["meta"]["moe"]
    results = runs["port"][4]
    toks = {str(u): t for u, t in _same(results, "moe", "tokens").items()}
    assert toks == want["tokens"]
    _payload_relation(_rank_stats(results, "moe"), want,
                      moe_target_cfg(), 2)


def test_sampled_generate_equals_meshless(runs):
    """At temperature 1 each rank draws the whole batch's random numbers
    from the one generator and keeps its rows: ``generate`` over data 2
    gives the meshless port's tokens for the same seed."""
    got = _same(runs["port"][2], "sampled")
    np.testing.assert_array_equal(got, runs["sampled"])


def test_pool_replicas_equal_after_every_engine_step(runs):
    """The two batch ranks' pool replicas and refcounts, byte for byte
    (sha256), after every install and every cycle of the seeded
    two-phase run: the gathered writes reach every replica."""
    a, b = (r["engine"]["gather"]["replicas"] for r in runs["port"][2])
    assert len(a) >= 10 and a == b
    assert len(set(a)) > len(a) // 2          # the pools moved


def test_replica_sync_in_rounds_equals_one_gather(runs):
    """F2's pin (ROADMAP.md queue 3): ``kvcache.sync_replicas_`` with
    ``device_exchange.ROUND_BYTES`` set to 37 bytes (under one slot of the
    stacked bf16 pool, so slots straddle rounds) leaves each batch rank's
    replicas of two pools bit for bit equal to the one-round sync, and
    equal on both ranks with every rank's pages; no round carries more
    than 37 bytes a rank (the first gather is the slot counts, 8 bytes a
    pool), so a rank holds at most one round of its peers' writes. Before
    the rounds the one gather carried every rank's whole payload
    at once."""
    a, b = (r["sync"] for r in runs["port"][2])
    for rank in (a, b):
        for one, rounds in zip(rank["one"]["pools"], rank["rounds"]["pools"]):
            np.testing.assert_array_equal(one, rounds)
            assert np.count_nonzero(one) > 0
        counts, *payload = rank["rounds"]["gathers"]
        assert counts == 2 * 8
        assert len(payload) > 10 and max(payload) <= ranks.SYNC_ROUND
        assert len(rank["one"]["gathers"]) == 2
    for x, y in zip(a["rounds"]["pools"], b["rounds"]["pools"]):
        np.testing.assert_array_equal(x, y)


def test_serve_launcher_mesh_data_model():
    """``launch/serve.py --mesh-data 2 --mesh-model 2`` spawns its four
    ranks and rank 0 prints the summary with the mesh note."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh-data", "2", "--mesh-model", "2", "--cache-impl", "paged",
         "--page-size", "16", "--prefix-cache", "--requests", "4",
         "--max-new", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if "served" in ln]
    assert len(lines) == 1, out.stdout
    assert "batch_shards=2 kv_shards=2" in lines[0], lines[0]

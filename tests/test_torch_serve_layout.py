"""Serving at JAX's layouts on the mesh (ROADMAP.md faults F1 and F2, item
10f), the parts that need no process group: what a rank of a serving
mesh stores, and where its dense cache writes land.

A rank is simulated in this process by a mesh of its coordinates whose
groups are shape-only (``sharding.ShapeOnlyGroup``): cutting the weights,
allocating the state and writing a dense cache need no collective. Every
rank of the mesh is checked in turn.

* F1's pin (:func:`test_rank_stores_rules_slice_of_every_weight`,
  :func:`test_rank_state_is_rules_slice_of_every_leaf`): under a (2, 4)
  mesh a rank's serving weights (target and both drafters,
  ``pipeline.serve_storage``) and its engine state (``engine_init``, as
  the dry run's ``rank_args`` makes it) are the parameter rules' slice of
  every leaf (``sharding.leaf_shard``: JAX's ``params_shardings``).
* The dense cache's writes under a kv_seq axis: the prefill
  (``lm.forward(write_kv=True)``), the commit (``lm.commit_kv``) and the
  feature-cache extension (``drafter.extend_feat_cache``) leave each
  rank's run equal, bit for bit, to its slots of the meshless cache,
  rolling caches included.

F2's pin (the replica sync in rounds) needs ranks: it runs in the
spawns of ``tests/test_torch_data.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.config.base import ModelConfig, SpecConfig
from repro_torch.config.registry import get_config
from repro_torch.core import drafter as dr
from repro_torch.core import pipeline as pl
from repro_torch.core import state as state_lib
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import api, kvcache, lm
from repro_torch.models import param as pm

SERVE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=512, max_seq_len=64, dtype="float32")
RULES = dict(sh.LOGICAL_RULES, kv_seq="model")


def _mesh(rank, shape=(2, 4)):
    """Rank ``rank``'s view of a ("data", "model") mesh, shape-only."""
    names = ("data", "model")
    return sh.Mesh(names, shape,
                   tuple(int(c) for c in np.unravel_index(rank, shape)),
                   tuple(sh.ShapeOnlyGroup((a,)) for a in names))


def _drafter_cfg(cfg):
    """A drafter of the target's width reading its features."""
    return dr.DrafterConfig(d_model=64, num_layers=2, num_heads=4,
                            num_kv_heads=2, d_ff=192,
                            vocab_size=cfg.vocab_size,
                            target_feature_dim=lm.feature_dim(cfg), gamma=4)


@functools.lru_cache(maxsize=None)
def _bundle(name):
    """The target ``name`` ("dense": ``SERVE``; else a registry id's smoke
    config in fp32) and two drafters, random (CPU)."""
    cfg = (ModelConfig(**SERVE) if name == "dense" else dataclasses.replace(
        get_config(name, smoke=True), dtype="float32"))
    d_cfg = _drafter_cfg(cfg)
    return pl.SpecBundle(cfg, d_cfg, d_cfg,
                         SpecConfig(gamma=4, top_k_branches=2),
                         api.init_model(cfg, seed=0, device="cpu"),
                         dr.drafter_init(d_cfg, 1, "cpu"),
                         dr.drafter_init(d_cfg, 2, "cpu"))


@pytest.mark.parametrize("fsdp", [False, True])
def test_rank_stores_rules_slice_of_every_weight(fsdp):
    """Every rank of a (2, 4) mesh: each leaf of the target and both
    drafters it stores is its rules' slice of the whole leaf (values and
    shape), heads, ffn and vocab over ``model`` (and the embed dims over
    ``data`` under FSDP); the bundle's weight bytes a rank fall to at most
    0.45 of the whole under model 4 (the replicated norms, KV projections
    and the drafters' embeddings keep it above a quarter), 0.25 with FSDP
    over data 2 too."""
    bundle = _bundle("dense")
    trees = ("target_params", "d1_params", "d2_params")
    whole = sum(t.numel() * t.element_size() for name in trees
                for t in pm.flatten(getattr(bundle, name)).values())
    for r in range(8):
        mesh = _mesh(r)
        with sh.use_sharding(mesh, RULES, fsdp=fsdp):
            cut = pl.serve_storage(bundle)
            assert pl.at_storage(cut)
            stored = 0
            for name in trees:
                for path, t in pm.flatten(getattr(bundle, name)).items():
                    rec = sh.leaf_shard(path, t.shape, mesh)
                    got = pm.get_path(getattr(cut, name), path)
                    assert tuple(got.shape) == rec.local_shape, path
                    assert torch.equal(got, t[rec.index]), (r, path)
                    stored += got.numel() * got.element_size()
            leaves = cut.target_params.layout.leaves
            for path in ("layers/0/attn/wq", "layers/1/ffn/w_in",
                         "tok/embedding"):
                assert "model" in leaves[path].axes, path
            assert ("data" in leaves["layers/0/attn/wq"].axes) == fsdp
        assert stored <= (0.25 if fsdp else 0.45) * whole, (r, stored,
                                                             whole)


def test_rank_state_is_rules_slice_of_every_leaf():
    """Every rank of a (2, 4) mesh: the dense engine state of a wave of 4
    rows and 1088 slots (the dry run's ``engine_state_abstract``, as
    ``rank_args`` makes it) holds the rules' slice of every cache leaf
    (rows over ``data``, slots over ``model``: ``(batch, kv_seq,
    kv_heads_p, None)``) and of every length, each dense run placed at
    its rank's slots (``kvcache.slot_run``); a recurrent target's states
    hold their slice over ``model`` (``rg_h`` and ``conv_buf`` by
    ``ffn``); before this layout a rank held every slot of every
    cache and the whole of each state."""
    b, cap = 4, 1088
    for arch in ("dense", "recurrentgemma-2b"):
        bundle = _bundle(arch)
        whole = state_lib.engine_init(bundle, b, cap, cache_impl="dense",
                                      device="meta")
        for r in range(8):
            mesh = _mesh(r)
            with sh.use_sharding(mesh, RULES):
                est = steps.engine_state_abstract(bundle, b, cap,
                                                  run=sh.batch_run(b))
                for key in ("target", "d1_feat", "d2_feat"):
                    flat_w = pm.flatten(getattr(whole, key))
                    for path, t in pm.flatten(getattr(est, key)).items():
                        w = flat_w[path]
                        name = path.split("/")[-1]
                        rec = sh.leaf_shard(name, w.shape, mesh)
                        assert tuple(t.shape) == rec.local_shape, (
                            arch, r, key, path)
                        if name in ("k", "v"):
                            d = 1 if key == "target" else 2
                            run = kvcache.slot_run(t, d)
                            sl = rec.index[d]
                            assert (run.lo, run.n, run.cap) == (
                                sl.start, sl.stop - sl.start, w.shape[d])
                            assert not run.whole
                        elif name in ("rg_h", "conv_buf"):
                            assert t.state_slice.n < t.state_slice.size


def _cut_runs(fn, n, shape=(1, 4)):
    """``fn()`` in each rank of a (1, ``n``) kv_seq mesh: its results."""
    out = []
    for r in range(n):
        with sh.use_sharding(_mesh(r, shape), RULES):
            out.append(fn())
    return out


@pytest.mark.parametrize("arch", ["dense", "gemma2-2b"])
def test_dense_writes_keep_rank_slots(arch):
    """A prefill of 2 rows of 40 tokens (ragged: ``snap_at`` 40 and 33),
    then a commit of a 3-node path into a dense target cache of 64 slots,
    and a feature-cache extension: each rank of a (1, 4) kv_seq mesh
    stores its run of 16 slots, equal bit for bit to those slots of the
    meshless cache (the gemma2 smoke target's local layers roll over a
    window of 16, so their run is 4 slots of it, written at p % 16)."""
    bundle = _bundle(arch)
    cfg, params = bundle.target_cfg, bundle.target_params
    d_cfg, dp = bundle.d1_cfg, bundle.d1_params
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(3, cfg.vocab_size, (2, 40), generator=g)
    snap = torch.tensor([40, 33], dtype=torch.int32)
    path = torch.tensor([[0, 2, 5], [0, 1, 3]])
    n_commit = torch.tensor([3, 2])

    tree = torch.randint(3, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    kv_outs = []

    def run():
        st = lm.init_states(cfg, 2, 64, device="cpu")
        out = lm.forward(params, toks, cfg, states=st, write_kv=True,
                         snap_at=snap, want_features=True)
        if not kv_outs:
            # the verify pass reads the caches: meshless, its K/V reused
            kv_outs.extend(lm.forward(params, tree, cfg,
                                      states=out["states"])["kv_outs"])
        states = lm.commit_kv(out["states"], kv_outs, cfg, path, n_commit)
        feat = dr.init_feat_cache(d_cfg, 2, 64, torch.float32, "cpu")
        pos = torch.arange(40)[None].expand(2, -1)
        feat = dr.extend_feat_cache(dp, d_cfg, feat, out["features"], pos,
                                    snap)
        return states, feat

    ref_states, ref_feat = run()
    for r, (states, feat) in enumerate(_cut_runs(run, 4)):
        for i, (st, ref) in enumerate(zip(states["layers"],
                                          ref_states["layers"])):
            for name in ("k", "v"):
                t = st[name]
                run_ = kvcache.slot_run(t, 1)
                assert run_.n * 4 == run_.cap == ref[name].shape[1]
                assert torch.equal(t, ref[name][:, run_.lo:run_.lo + run_.n]
                                   ), (r, i, name)
        assert torch.equal(states["length"], ref_states["length"])
        for name in ("k", "v"):
            t = feat[name]
            lo = kvcache.slot_run(t, 2).lo
            assert torch.equal(t, ref_feat[name][:, :, lo:lo + t.shape[2]])


def test_state_max_len_reads_whole_capacity():
    """A dense state made inside a kv_seq mesh reports the wave's whole
    capacity (``EngineState.max_len``), not its run's, and a dense cache
    made outside the mesh is refused inside it rather than read as if
    whole."""
    bundle = _bundle("dense")
    with sh.use_sharding(_mesh(1, (1, 4)), RULES):
        est = state_lib.engine_init(bundle, 2, 64, device="cpu")
        assert est.max_len == 64
        assert est.d1_feat["k"].shape[2] == 16
    outside = state_lib.engine_init(bundle, 2, 64, device="cpu")
    with sh.use_sharding(_mesh(1, (1, 4)), RULES):
        with pytest.raises(RuntimeError, match="dense_cache"):
            _ = outside.max_len

"""The rank side of ``tests/test_torch_sharded.py`` (not a test module).

:func:`scenarios` runs in every rank of a ``launch.mesh.run_ranks`` spawn
and returns that rank's results as numpy. It imports torch and the port
only: the spawned ranks never load JAX.
"""
import numpy as np
import torch
from _torch_sharded_inputs import DENSE_CASES, GAMMA, PAGE

from repro_torch.core import drafter as dr
from repro_torch.core import pipeline as pl
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import spdecode as sp
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.trace_analysis import storage_bytes
from repro_torch.serving.engine import ServingEngine

RULES = dict(sh.LOGICAL_RULES, kv_seq="model")
IMPLS = ("gather", "kernel")


def _t(x):
    return torch.from_numpy(np.array(x))


def _run(a, r, n):
    """Rank ``r``'s run of the slots (axis 1) of a dense cache ``a`` of a
    kv_seq axis of ``n``."""
    s = a.shape[1] // n
    return _t(a)[:, r * s:(r + 1) * s].contiguous()


def _dense(x, r, n):
    """The dense hook on this rank's run of each cache."""
    out = {}
    ck, cv = _run(x["ck"], r, n), _run(x["cv"], r, n)
    for name, rolling, window, cap in DENSE_CASES:
        for md in (torch.float32, torch.bfloat16):
            o = sp.sharded_cache_attend(
                _t(x["q"]), ck, cv, _t(x["bk"]),
                _t(x["bv"]), cache_len=_t(x["cache_len"]),
                q_abs=_t(x["q_abs"]), window=window, attn_softcap=cap,
                blk_mask=_t(x["mask"]), rolling=rolling, merge_dtype=md)
            out[f"{name}/{str(md)[6:]}"] = o.numpy()
    return out


def _paged(x, r, loc):
    """Both read paths on this rank's run of every page of the pools."""
    pk = _t(x["pk"])[:, r * loc:(r + 1) * loc]
    pv = _t(x["pv"])[:, r * loc:(r + 1) * loc]
    return {impl: sp.sharded_paged_cache_attend(
        _t(x["q"]), pk, pv, _t(x["table"]), _t(x["bk"]), _t(x["bv"]),
        cache_len=_t(x["cache_len"]), q_abs=_t(x["q_abs"]),
        attn_softcap=None, blk_mask=_t(x["mask"]), page_size=PAGE,
        read_impl=impl).numpy() for impl in IMPLS}


def _drafter(bundle, x):
    """The feature cache written inside the mesh (each rank its run),
    then drafter_forward by both read paths: logits, merge calls and
    bytes a call."""
    dcfg, p = bundle.d1_cfg, bundle.d1_params
    cache = dr.init_feat_cache(dcfg, 2, PAGE * 6, torch.float32, "cpu",
                               cache_impl="paged", page_size=PAGE)
    feats = _t(x["feats"])
    pos = torch.arange(feats.shape[1])[None].expand(2, -1)
    cache = dr.extend_feat_cache(p, dcfg, cache, feats, pos, _t(x["n_new"]))
    blk = dr.dflash_block(_t(x["anchor"]).long(), GAMMA, dcfg.mask_token)
    out = {}
    for impl in IMPLS:
        cfg = pl.with_attn_impl(bundle, impl).d1_cfg
        sp.PAYLOAD.reset()
        logits = dr.drafter_forward(p, cfg, blk, cache)
        out[impl] = {"logits": logits.numpy(), "calls": sp.PAYLOAD.calls,
                     "bytes": sp.PAYLOAD.bytes}
    return out


def _weights(bundle):
    return storage_bytes(bundle.target_params, bundle.d1_params,
                         bundle.d2_params)


def _serve(bundle, phase1, phase2):
    """The two-phase workload through one engine: tokens, stats, this
    rank's pools at the end, the pool's refcounts, and ``storage``: the
    weight bytes the engine keeps beside the whole bundle's and the
    serving weight gathers (``sharding.WEIGHTS``) of its run."""
    sh.WEIGHTS.reset()
    eng = ServingEngine(bundle, batch_size=2, seed=0, cache_impl="paged",
                        page_size=PAGE, prefix_cache=True,
                        pool_scope="engine", device="cpu")
    for part in (phase1, phase2):
        for pr, n in part:
            eng.submit(pr, max_new=n)
        stats = eng.run()
    eng.agree_across_ranks()
    return eng, {"tokens": {r.uid: r.out.tolist() for r in eng.done},
                 "stats": stats,
                 "storage": {"cut": pl.at_storage(eng.bundle),
                             "bytes": _weights(eng.bundle),
                             "whole": _weights(bundle),
                             "gathers": (sh.WEIGHTS.calls, sh.WEIGHTS.bytes)},
                 "pools": {k: (a.numpy(), b.numpy())
                           for k, (a, b) in eng._pools.items()},
                 "refcounts": eng.pool.refcounts()}


def _catches_disagreement(eng, r):
    """Rank 1 spoils one committed token: every rank's check must raise."""
    if r == 1:
        eng.done[0].out = eng.done[0].out.copy()
        eng.done[0].out[0] += 1
    try:
        eng.agree_across_ranks()
    except RuntimeError:
        return True
    return False


def _quirk(x, r, n):
    """The dense hook's default merge (bfloat16) on the quirk's input."""
    return sp.sharded_cache_attend(
        _t(x["q"]), _run(x["k"], r, n), _run(x["v"], r, n), _t(x["bk"]),
        _t(x["bv"]),
        cache_len=_t(x["cache_len"]), q_abs=_t(x["q_abs"]), window=None,
        attn_softcap=None, blk_mask=torch.ones((1, 1), dtype=torch.bool),
        rolling=False).numpy()


def _graph_loop_in_data_mesh(bundle):
    """``make_mesh(data=2)`` builds its groups; the graph loop inside it
    (kv_seq off, so only the batch axis is there) refuses it, naming
    ROADMAP.md item 9b: its gathers are host collectives."""
    with sh.use_sharding(make_mesh(data=2, model=1),
                         dict(RULES, kv_seq=None)):
        try:
            pl.generate_ondevice(bundle, np.zeros((2, 4), np.int32), 2,
                                 device="cpu")
        except NotImplementedError as e:
            if "9b" not in str(e):
                raise AssertionError(f"the refusal names no item: {e}")
            raise


def _refusals(bundle):
    """Each refusal inside the mesh: (what, raised error's type name)."""
    got = {}
    cases = {
        "make_mesh_data": lambda: _graph_loop_in_data_mesh(bundle),
        "page_not_divisible": lambda: ServingEngine(
            bundle, batch_size=2, cache_impl="paged", page_size=9,
            device="cpu"),
        "generate_ondevice": lambda: pl.generate_ondevice(
            bundle, np.zeros((1, 4), np.int32), 2, device="cpu"),
    }
    for what, fn in cases.items():
        try:
            fn()
            got[what] = None
        except Exception as e:      # noqa: BLE001 - the type is the result
            got[what] = type(e).__name__
    return got


def scenarios(rank, n, bundles, x):
    """Every scenario in this rank of an ``n``-rank ``(1, n)`` mesh.
    ``bundles``: {"gather": SpecBundle, "kernel": SpecBundle}; ``x``: the
    inputs of ``_torch_sharded_inputs.inputs`` by key."""
    torch.manual_seed(0)
    mesh = make_mesh(1, n)
    res = {}

    def part(prefix):
        return {k[len(prefix) + 1:]: v for k, v in x.items()
                if k.startswith(prefix + "/")}

    with sh.use_sharding(mesh, RULES):
        res["dense"] = _dense(part("dense"), rank, n)
        res["paged"] = _paged(part("paged"), rank, PAGE // n)
        res["drafter"] = _drafter(bundles["gather"], part("drafter"))
        phase1, phase2 = x["engine/phase1"], x["engine/phase2"]
        res["engine"] = {}
        for impl in IMPLS:
            eng, res["engine"][impl] = _serve(bundles[impl], phase1, phase2)
        res["hash_check_raises"] = _catches_disagreement(eng, rank)
        if n == 2:
            sh.WEIGHTS.reset()
            g = pl.generate(bundles["gather"], x["generate/prompts"], 16,
                            max_len=256, device="cpu")
            res["generate"] = g["tokens"]
            res["generate_gathers"] = (sh.WEIGHTS.calls, sh.WEIGHTS.bytes)
            res["quirk"] = _quirk(part("quirk"), rank, n)
            res["refusals"] = _refusals(bundles["gather"])
    return res

"""Training on the mesh in the port (ROADMAP.md item 10a:
``repro_torch/distributed/sharding.py``'s parameter rules,
``distributed/train_mesh.py``'s tensor-, sequence- and FSDP-parallel
step, ``optim/optimizers.py`` on shards, ``checkpoint/checkpointer.py``'s
elastic restore and ``distributed/pipeline_parallel.py``) held to the JAX
package.

The JAX references run once per module in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``_torch_mesh_train_jax.py``: JAX's sharded step of
``tests/test_distributed.py:73`` on each case of
``_torch_mesh_train_inputs.CASES`` and ``pipeline_apply`` on (pod 4,
data 2)). While it runs, the port's side runs one spawn of 8 gloo ranks
((2, 4), then pod 4 x data 2) and one of 4 ((2, 2), then (4, 1)), each
rank running every scenario (``_torch_mesh_train_ranks.py``, which
imports no JAX). The weights are JAX's, converted.

Tolerances (fp32): losses and grad norms rtol 1e-6; every gradient leaf
within 1e-6 of JAX's sharded step's and the port's unsharded step's
(absolute: the leaves are at most about 0.1, and the sums run in other
orders); every leaf after two steps within 1e-5 (an element whose
gradient rounds near zero moves by lr times a sign that rounding may
flip; JAX's own test allows 1e-4); adamw8bit's int8 moments within one
quantum and every other moment leaf within 1e-5 of its leaf's largest
(``_close_moments``). The dry run's tiny cell: storage and collective
bytes exact; FLOPs within 2 % of JAX's HLO count less a named excess.
Its small serving cells: storage and collective bytes exact against the
ranks' real run, argument bytes exact against JAX's ``memory_analysis``
less the named leaves.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_train_ranks as ranks
from _torch_mesh_train_inputs import (CASES, CHUNK, M, MODEL, OPTIMIZERS,
                                      SERVE_B, SERVE_KINDS, S, UNEVEN, batch,
                                      hp, pipeline_inputs)
from _torch_parity import jax_lm_init, port_lm, port_model_cfg
from repro.config import registry as jreg
from repro.config.base import ModelConfig as JModelConfig
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import OptimizerConfig
from repro_torch.config.registry import get_config
from repro_torch.distributed import pipeline_parallel as pp
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import train_mesh as tm
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch import dryrun
from repro_torch.launch.steps import abstract_params, make_train_step
from repro_torch.models import api
from repro_torch.models import lm as tlm
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as topt

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL_LOSS = 1e-6      # relative
TOL_GRAD = 1e-6      # absolute
TOL_PARAM = 1e-5     # absolute, after two steps
TOL_MOMENT = 1e-5    # of a moment leaf's largest entry, after two steps
RANK_WAIT = 120      # s a collective may wait: ranks out of step fail fast
SPEC_KINDS = {"dense": None, "gemma2": "gemma2-2b", "moe": "grok-1-314b",
              "rglru": "recurrentgemma-2b", "rwkv": "rwkv6-1.6b"}
SPEC_MESHES = {"2x4": (("data", "model"), (2, 4)),
               "pod2x2x2": (("pod", "data", "model"), (2, 2, 2))}


def _jax_cfg():
    return JModelConfig(remat=False, **MODEL)


def _nest(flat):
    out = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def _port_flat(jflat, cfg):
    """A flat JAX-layout tree of numpy leaves as the port's flat tree."""
    return {k: v.numpy() for k, v in pm.flatten(convert.convert_tree(
        _nest(jflat), cfg, device="cpu")).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": {n: rank results}, "meshless": the port's unsharded runs,
    "ref": JAX's arrays, "full": the converted params, "ckpt": the
    directory the (2, 4) ranks saved into}."""
    out = tmp_path_factory.mktemp("mesh_train_ref")
    ckpt = tmp_path_factory.mktemp("mesh_train_ckpt")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS)])
    env.pop("JAX_PLATFORMS", None)
    with open(out / "jax.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(TESTS / "_torch_mesh_train_jax.py"),
             str(out)], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        cfg = ranks.model_cfg()
        full = port_lm(jax_lm_init(jax.random.PRNGKey(0), _jax_cfg()), cfg)
        port = {n: run_ranks(ranks.scenarios, n, n, full, str(ckpt),
                             threads=1, timeout=RANK_WAIT) for n in (8, 4)}
        meshless = {name: ranks.train(cfg, full, batch(uneven), None, False,
                                      hp=hp(name))
                    for name, (_, _, _, uneven) in CASES.items()}
        meshless["chunk"] = ranks.train(cfg, full, batch(True), None, False,
                                        chunk=CHUNK, steps=1)
        for arch in ranks.OTHER_KINDS:
            acfg = ranks.other_cfg(arch)
            meshless[arch] = ranks.train(
                acfg, api.init_model(acfg, seed=0, device="cpu"),
                ranks.other_batch(acfg), None, False, steps=1,
                hp=dict(ranks.HP, name="adamw"))
    finally:
        rc = proc.wait(timeout=900)
    assert rc == 0, (out / "jax.log").read_text()[-3000:]
    ref = dict(np.load(out / "ref.npz"))
    return {"port": port, "meshless": meshless, "ref": ref, "full": full,
            "ckpt": ckpt}


def _same_on_ranks(results, key):
    """The run ``key`` of every rank, their losses and grad norms equal
    (every rank computes the whole step's)."""
    runs_ = [r[key] for r in results]
    for r in runs_[1:]:
        assert r["loss"] == runs_[0]["loss"]
        assert r["losses"] == runs_[0]["losses"]
        assert r["grad_norms"] == runs_[0]["grad_norms"]
    return runs_[0]


def _close_trees(got, want, atol, what):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def _close_moments(got, want, what):
    """adamw8bit's int8 moments within one quantum (an element next to a
    rounding boundary may land on either side: its moment comes from
    gradients that agree to ``TOL_GRAD``), every other moment leaf (the
    int8 scales, Adafactor's row, column and vector statistics) within
    ``TOL_MOMENT`` of the largest of its leaf, the step counter
    exactly."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if k.endswith("/q"):
            assert np.abs(g.astype(np.int32) - w).max() <= 1, (what, k)
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_MOMENT * scale,
                                   err_msg=f"{what} {k}")


def _hold(run, want, atol_grad=TOL_GRAD, what=""):
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=TOL_LOSS)
    np.testing.assert_allclose(run["grad_norms"], want["grad_norms"],
                               rtol=TOL_LOSS)
    np.testing.assert_allclose(run["loss"], want["losses"][0], rtol=TOL_LOSS)
    _close_trees(run["grads"], want["grads"], atol_grad, f"{what} grad")
    if "params" in want:
        _close_trees(run["params"], want["params"], TOL_PARAM,
                     f"{what} param")
    if "opt" in want:
        _close_moments(run["opt"], want["opt"], what)


def _jax_run(ref, name, cfg):
    grads = {k[len(f"{name}/grad/"):]: v for k, v in ref.items()
             if k.startswith(f"{name}/grad/")}
    params = {k[len(f"{name}/param/"):]: v for k, v in ref.items()
              if k.startswith(f"{name}/param/")}
    out = {"losses": list(ref[f"{name}/loss"]),
           "grad_norms": list(ref[f"{name}/grad_norm"]),
           "grads": _port_flat(grads, cfg),
           "params": _port_flat(params, cfg)}
    opt = {k[len(f"{name}/opt/"):]: v for k, v in ref.items()
           if k.startswith(f"{name}/opt/")}
    if opt:
        out["opt"] = opt
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(runs, name):
    """JAX's sharded step (``test_distributed.py:73``'s model, 8 x 32
    tokens) on (2, 4) with FSDP, the same with uneven masks, and on (2,
    2) without FSDP, with AdamW; adamw8bit and Adafactor on (2, 4) with
    FSDP and on (2, 2) (ROADMAP.md item 10c): the port's ranks give the
    same loss and grad norm on every rank, and the loss and grad norm of
    both steps, every gradient leaf of step 1 (gathered from the ranks'
    shards), every leaf after step 2 and (adamw8bit, Adafactor) every
    moment leaf after step 2 (gathered into JAX's layout,
    ``optimizers.gather_state``) equal JAX's sharded step and the port's
    unsharded step; each rank's state cut back from the gathered one
    (``optimizers.shard_state``) is its own, bit for bit."""
    data, model, _, _ = CASES[name]
    run = _same_on_ranks(runs["port"][data * model], name)
    if "opt" in run:
        assert all(r[name]["state_round_trip"]
                   for r in runs["port"][data * model])
    cfg = ranks.model_cfg()
    _hold(run, _jax_run(runs["ref"], name, cfg), what=f"{name} vs JAX")
    _hold(run, runs["meshless"][name], what=f"{name} vs unsharded")


def test_uneven_masks_take_the_whole_batch_mean(runs):
    """Data rank 0 holds rows 0-3 (65 mask ones) and data rank 1 rows 4-7
    (108): the mean of the two ranks' own means is not the loss, which
    is the whole batch's masked mean (numerator and count summed apart);
    the port's sharded loss is that mean."""
    ones = [sum(UNEVEN[:4]), sum(UNEVEN[4:])]
    assert ones[0] != ones[1]
    cfg = ranks.model_cfg()
    full = runs["full"]
    bt = {k: torch.from_numpy(v) for k, v in batch(True).items()}
    halves = [float(tlm.loss_fn(full, {k: v[i * 4:(i + 1) * 4]
                                       for k, v in bt.items()}, cfg))
              for i in range(2)]
    whole = float(tlm.loss_fn(full, bt, cfg))
    # a hundred times the loss tolerance: averaging the ranks' means
    # would fail the hold below
    assert abs(np.mean(halves) - whole) > 100 * TOL_LOSS * whole, (halves,
                                                                   whole)
    run = _same_on_ranks(runs["port"][8], "2x4_fsdp_uneven")
    np.testing.assert_allclose(run["loss"], whole, rtol=TOL_LOSS)


def test_loss_seq_chunk_inside_the_mesh(runs):
    """On (2, 2) with uneven masks, the loss in ``loss_seq_chunk`` chunks
    of the gathered sequence (each rank at its vocab columns) equals the
    unchunked sharded loss and the unsharded chunked one, and so do the
    gradients and the grad norm."""
    res = runs["port"][4]
    chunked = _same_on_ranks(res, "2x2_chunk")
    whole = _same_on_ranks(res, "2x2_unchunked")
    _hold(chunked, whole, what="chunked vs unchunked")
    _hold(chunked, runs["meshless"]["chunk"], what="chunked vs unsharded")


@pytest.mark.parametrize("arch", ranks.OTHER_KINDS)
def test_other_kinds_train_under_data_parallelism(runs, arch):
    """Recurrent, RWKV, MoE, cross-attention and encoder-decoder targets
    (smoke configs, remat) on (data 4, model 1) with FSDP: two rows a
    rank, each layer's (and the encoder's) FSDP leaves gathered at use,
    the MoE FFN over the whole batch's gathered rows. Loss, grad norm,
    every gradient leaf and every leaf after a step equal the port's
    unsharded step (which ``test_torch_train.py`` and
    ``test_torch_archs.py`` hold to JAX)."""
    run = _same_on_ranks(runs["port"][4], arch)
    _hold(run, runs["meshless"][arch], what=arch)


def test_storage_and_gradient_table(runs):
    """On (2, 4) with FSDP each rank stores ``wq`` as [d/2, Hq Dh/4]
    (data, model), ``wk`` as [d/2, Hkv Dh] (data), the embedding as
    [V/4, d/2] (model, data); one query head a rank, reading KV head
    r // 2 of the two. The gradient table: ``wk`` summed over model (the
    ranks use it for different heads), the norms over data and model
    (different rows and tokens), ``wq``, ``w_in``, the embedding and the
    head over neither (each rank's part is its own; FSDP's data sum is
    the gather's reduce-scatter)."""
    d, v = MODEL["d_model"], MODEL["vocab_size"]
    for r in runs["port"][8]:
        st = r["storage"]
        loc = st["local"]
        assert loc["layers/0/attn/wq"] == (d // 2, 64 // 4)
        assert loc["layers/0/attn/wk"] == (d // 2, 2 * 16)
        assert loc["tok/embedding"] == (v // 4, d // 2)
        assert loc["lm_head"] == (d // 2, v // 4)
        assert loc["layers/1/ffn/w_out"] == (128 // 4, d // 2)
        assert loc["ln_f/scale"] == (d,)
        mi = r["rank"] % 4
        assert st["heads"] == (1, mi, 1, mi // 2)
        ax = st["grad_axes"]
        assert ax["layers/0/attn/wk"] == ("model",)
        assert ax["layers/0/ln1/scale"] == ("data", "model")
        assert ax["ln_f/scale"] == ("data", "model")
        for k in ("layers/0/attn/wq", "layers/0/attn/wo", "layers/0/ffn/w_in",
                  "layers/1/ffn/w_out", "tok/embedding", "lm_head"):
            assert ax[k] == (), k


def test_elastic_restore_from_2x4_onto_1x2(runs):
    """The (2, 4) ranks saved their slices (gathered, rank 0 writing);
    the whole leaves on disk equal the params bit for bit. Restored onto
    (data 1, model 2), each rank's leaves are exactly its slices by
    ``params_shardings`` on the new mesh, and the two ranks' slices put
    back together are the saved leaves, bit for bit."""
    full = pm.flatten(runs["full"])
    ck = Checkpointer(str(runs["ckpt"]))
    whole, _ = ck.restore(runs["full"])
    for k, t in pm.flatten(whole).items():
        assert torch.equal(t, full[k]), k
    got = []
    for m in range(2):
        mesh = tsh.Mesh(("data", "model"), (1, 2), (0, m), (None, None))
        with tsh.use_sharding(mesh, tsh.LOGICAL_RULES):
            tree, _ = ck.restore(runs["full"], mesh=mesh)
            recs = pm.flatten(tsh.params_shardings(runs["full"]))
        flat = pm.flatten(tree)
        for k, t in flat.items():
            assert tuple(t.shape) == recs[k].local_shape, k
            assert torch.equal(t, full[k][recs[k].index]), k
        got.append((flat, recs))
    assert got[0][0]["layers/0/attn/wq"].shape[1] == 32
    for k, t in full.items():
        spec = got[0][1][k].spec
        dims = [d for d, e in enumerate(spec) if e is not None]
        back = (torch.cat([got[0][0][k], got[1][0][k]], dims[0]) if dims
                else got[0][0][k])
        assert torch.equal(back, t), k


def test_pipeline_apply_matches_jax(runs):
    """``pipeline_apply`` on (pod 4, data 2) with ``test_distributed.py:
    174``'s shapes (S 4, M 6, microbatches of 3 x 16, a tanh stage):
    every rank returns JAX's outputs and sequential application's
    (1e-5), having called its stage M + S - 1 = 9 times; a rank handed
    only its own stage slice gives the same."""
    w, xs = pipeline_inputs()
    seq = xs
    for s in range(S):
        seq = np.tanh(seq @ w[s])
    for r in runs["port"][8]:
        y, calls = r["pipeline"]
        assert calls == M + S - 1
        np.testing.assert_allclose(y, runs["ref"]["pipeline"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y, seq, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["pipeline_own"], y)


def _fake_jax_mesh(name):
    names, shape = SPEC_MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(name):
    names, shape = SPEC_MESHES[name]
    return tsh.Mesh(names, shape, (0,) * len(shape), (None,) * len(shape))


def _jax_trees(kind):
    """JAX's params and its three optimizers' states as flat {path: shape}
    (shapes only)."""
    arch = SPEC_KINDS[kind]
    cfg = _jax_cfg() if arch is None else jreg.get_config(arch, smoke=True)
    params = jax.eval_shape(lambda k: jlm.lm_init(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    out = {"params": params}
    for name in ("adamw", "adamw8bit", "adafactor"):
        init = jopt.make_optimizer(JOptimizerConfig(name=name))[0]
        out[name] = jax.eval_shape(init, params)
    return cfg, {k: {p: tuple(v.shape) for p, v in jsh.tree_paths(t).items()}
                 for k, t in out.items()}


def _port_trees(cfg):
    params = abstract_params(cfg)
    out = {"params": params}
    for name in ("adamw", "adamw8bit", "adafactor"):
        out[name] = topt.make_optimizer(OptimizerConfig(name=name),
                                        cfg)[0](params)
    return {k: {p: tuple(v.shape) for p, v in tsh.tree_paths(t).items()}
            for k, t in out.items()}


@pytest.mark.parametrize("kind", list(SPEC_KINDS))
def test_param_specs_match_jax(kind):
    """For every leaf of JAX's params and of its AdamW, adamw8bit and
    Adafactor states (tiny dense, gemma2-like, MoE, RG-LRU and RWKV
    configs), on (2, 4) and (pod 2, data 2, model 2), with FSDP off and
    on: the port's ``param_logical_axes``, ``param_pspec`` and
    ``fit_spec`` equal JAX's on the same path and shape. The port's
    optimizer states have JAX's paths and shapes; its params (the period
    axis unstacked into ``layers/<i>``) get JAX's axes of their period
    leaf with the stacked axis's None dropped."""
    jcfg, jtrees = _jax_trees(kind)
    tcfg = port_model_cfg(jcfg)
    ttrees = _port_trees(tcfg)
    for name in ("adamw", "adamw8bit", "adafactor"):
        assert ttrees[name] == jtrees[name], name
    plen = len(tlm.period_spec(tcfg)[0])
    n_per = tlm.period_spec(tcfg)[1]
    for mname in SPEC_MESHES:
        jm, pmesh = _fake_jax_mesh(mname), _port_mesh(mname)
        for fsdp in (False, True):
            with jsh.use_sharding(jm, jsh.LOGICAL_RULES, fsdp=fsdp), \
                    tsh.use_sharding(pmesh, tsh.LOGICAL_RULES, fsdp=fsdp):
                for tree in jtrees.values():
                    for path, shape in tree.items():
                        nd = len(shape)
                        want = jsh.param_logical_axes(path, nd)
                        assert tsh.param_logical_axes(path, nd) == want, path
                        spec = jsh.param_pspec(path, nd, jm)
                        assert tsh.param_pspec(path, nd, pmesh) == tuple(
                            spec), path
                        assert tsh.fit_spec(tuple(spec), shape, pmesh) == \
                            tuple(jsh.fit_spec(spec, shape, jm)), path
                for path, shape in ttrees["params"].items():
                    parts = path.split("/")
                    jpath = path
                    if parts[0] == "layers":
                        i = int(parts[1])
                        head = (f"period/p{i % plen}" if i < plen * n_per
                                else f"tail{i - plen * n_per}")
                        jpath = "/".join([head] + parts[2:])
                    jshape = jtrees["params"][jpath]
                    stacked = jpath.startswith("period/")
                    want = jsh.param_logical_axes(jpath, len(jshape))
                    got = tsh.param_logical_axes(path, len(shape))
                    assert got == (want[1:] if stacked else want), path


def _view(data, model):
    return tsh.Mesh(("data", "model"), (data, model), (0, 0), (None, None))


REFUSALS = ["rwkv", "moe", "half_head", "pipeline_grad"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_name_their_item(case):
    """What this slice does not cover raises and names the ROADMAP item
    that will: an RWKV or MoE target, or 6 query heads (6 x 16 columns
    divide, heads do not: half a head a rank) on a model axis of 4
    (10d); a ``pipeline_apply`` that autograd would record (10e)."""
    if case == "pipeline_grad":
        mesh = tsh.Mesh(("pod", "data", "model"), (2, 1, 1), (0, 0, 0),
                        (None, None, None))
        w = torch.zeros((2, 4, 4), requires_grad=True)
        with tsh.use_sharding(mesh), pytest.raises(NotImplementedError,
                                                   match="item 10e"):
            pp.pipeline_apply(lambda p, x: x @ p["w"], {"w": w},
                              torch.zeros((3, 1, 4)))
        return
    if case == "half_head":
        cfg = dataclasses.replace(ranks.model_cfg(), num_heads=6,
                                  num_kv_heads=2, head_dim=16)
        assert (6 * 16) % 4 == 0
    else:
        arch = "rwkv6-1.6b" if case == "rwkv" else "grok-1-314b"
        cfg = get_config(arch, smoke=True)
    step, _ = make_train_step(cfg, device="cpu")
    with tsh.use_sharding(_view(1, 4), tsh.LOGICAL_RULES), \
            pytest.raises(NotImplementedError, match="item 10d"):
        step({}, {}, {"tokens": np.zeros((2, 8), np.int32)})
    # under data parallelism alone the plan is made
    with tsh.use_sharding(_view(4, 1), tsh.LOGICAL_RULES):
        assert tm.make_plan(cfg, _view(4, 1), abstract_params(cfg)).m == 1


def _shape_only_mesh(rank):
    names, shape = ("data", "model"), (2, 2)
    return tsh.Mesh(names, shape,
                    tuple(int(c) for c in np.unravel_index(rank, shape)),
                    tuple(tsh.ShapeOnlyGroup((a,)) for a in names))


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_shape_only_trace_matches_gloo_run(runs, opt):
    """The dry run's tiny cell (the (2, 2) FSDP train step, JAX's train
    rules, 8 x 32 tokens) traced on the meta device for each rank of a
    shape-only mesh (``launch/dryrun.py::trace_cell``) against the 4
    gloo ranks' real step on the CPU: every rank's storage bytes of the
    params and of the optimizer state, and the step's collectives by
    kind (calls and bytes sent), exactly equal; the flash kernels'
    stand-ins called 2 / 2 / 2 times (two layers, no remat)."""
    cfg = ranks.model_cfg()
    for r, res in enumerate(runs["port"][4]):
        real = res["dryrun"][opt]
        parts, counts = dryrun.trace_cell(ranks.dryrun_cell(cfg, opt),
                                          _shape_only_mesh(r))
        assert parts["params"] == real["storage"]["params"], r
        assert parts["opt_state"] == real["storage"]["opt_state"], r
        for kind, c in real["collectives"].items():
            assert counts[kind] == c["bytes"], (r, kind)
            assert counts["coll_calls"][kind] == c["calls"], (r, kind)
        assert counts["kernels"] == {"flash_fwd": 2, "flash_bwd_dq": 2,
                                     "flash_bwd_dkv": 2}


def test_trace_flops_match_jax_hlo(runs):
    """The tiny cell's per-rank FLOPs from the trace
    (``FlopCounterMode``) against JAX's ``analyze_hlo_text`` of the same
    step compiled over 4 host devices (``dryrun/flops``). The trace
    counts more by a known amount: the port's flash backward (the plain
    stand-ins of kernels #4 and #5, the kernels' arithmetic) forms the
    scores ``q k^T`` again in each of its two passes and ``do v^T`` in
    each, where XLA's autodiff of the reference attention keeps the
    forward's probabilities: 2 x 2 products of ``2 B_r Hq_r T^2 Dh``
    FLOPs a layer (B_r 4 rows and Hq_r 2 heads a rank, T 32, Dh 16).
    Less that excess, the counts agree within 2 %."""
    cfg = ranks.model_cfg()
    _, counts = dryrun.trace_cell(ranks.dryrun_cell(cfg, "adamw"),
                                  _shape_only_mesh(0))
    jax_flops = float(runs["ref"]["dryrun/flops"])
    b_r, hq_r, t, dh = 4, MODEL["num_heads"] // 2, 32, 16
    excess = MODEL["num_layers"] * 4 * 2 * b_r * hq_r * t * t * dh
    assert counts["flops"] > jax_flops
    np.testing.assert_allclose(counts["flops"] - excess, jax_flops,
                               rtol=0.02)


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_serving_cell_trace_matches_gloo_run(runs, kind):
    """The dry run's small serving cell (``_torch_mesh_train_ranks.
    serve_cell``: a bf16 target of two layers and its production drafters
    at the rank's storage, JAX's dense engine state, 4 rows of a 64-token
    prompt, the serving rules with kv_seq on ``model``) traced on the
    meta device for each rank of a shape-only (2, 2) mesh against the 4
    gloo ranks' real run of the same cell: every rank's argument bytes by
    part and the step's collectives by kind (calls and bytes sent, the
    weight gathers among them), exactly equal."""
    for r, res in enumerate(runs["port"][4]):
        real = res["serve"][kind]
        parts, counts = dryrun.trace_cell(ranks.serve_cell(kind),
                                          _shape_only_mesh(r))
        assert parts == real["parts"], r
        for k, c in real["collectives"].items():
            assert counts[k] == c["bytes"], (r, k)
            assert counts["coll_calls"][k] == c["calls"], (r, k)
        assert real["collectives"]["all-gather"]["calls"] > 0


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_serving_cell_argument_bytes_match_jax(runs, kind):
    """A rank's argument bytes of the small serving cell
    (``dryrun.trace_cell``, rank 0 of a shape-only (2, 2) mesh) against
    JAX's ``memory_analysis().argument_size_in_bytes`` of the same cell
    built as JAX's ``run_cell`` builds it (``serve/{kind}/
    argument_bytes``: every argument at ``params_shardings`` under the
    serving rules, 8 host devices, every argument kept), to the byte but
    for the leaves named here, each with its reason:

    * the key (decode): JAX's cell takes a ``[2]`` uint32 key, the port's
      greedy cell no generator (8 bytes);
    * ``anchor``: JAX's rules match no path of it, so each device holds
      the whole ``[B]`` int32; the port holds its run's ``B / 2`` rows in
      int64 (it indexes with them);
    * ``active``: likewise whole ``[B]`` bool in JAX, the run's rows in
      the port.

    The weights (the target's and both drafters' slices by the parameter
    rules, heads, ffn and vocab over ``model``), the dense caches (rows
    over ``data``, slots over ``model``), the lengths and the prompts
    agree exactly. The dry run itself compiles as ``run_cell`` does,
    dropping the arguments a step never reads (``serve/{kind}/
    pruned_bytes``: the prefill reads none of the drafters' weights but
    the feature projection's); the port counts what a rank holds."""
    parts, _ = dryrun.trace_cell(ranks.serve_cell(kind), _shape_only_mesh(0))
    b, n = SERVE_B, SERVE_B // 2
    named = {"key": 8 if kind == "decode" else 0,
             "anchor": 4 * b - 8 * n,
             "active": b - n}
    jax_bytes = int(runs["ref"][f"serve/{kind}/argument_bytes"])
    assert sum(parts.values()) + sum(named.values()) == jax_bytes
    assert int(runs["ref"][f"serve/{kind}/pruned_bytes"]) <= jax_bytes

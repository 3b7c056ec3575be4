"""The rank side of ``tests/test_torch_mesh_train.py`` (not a test
module).

:func:`scenarios` runs in every rank of a ``launch.mesh.run_ranks`` spawn
and returns that rank's results as numpy and Python values. It imports
torch and the port only: the spawned ranks never load JAX.
"""
import dataclasses

import torch
from _torch_mesh_train_inputs import (B, CASES, CHUNK, HP, MODEL,
                                      OPTIMIZERS, SERVE_B, SERVE_GAMMA,
                                      SERVE_K, SERVE_KINDS, SERVE_MODEL,
                                      SERVE_T, STEPS, T, batch, hp,
                                      pipeline_inputs)

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import ModelConfig, OptimizerConfig, ShapeSpec
from repro_torch.config.registry import get_config
from repro_torch.core.drafter import drafter_init
from repro_torch.distributed import pipeline_parallel as pp
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (build_cell, make_grad_fn,
                                      make_train_step, rank_args)
from repro_torch.models import api
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as opt_lib
from repro_torch.roofline.trace_analysis import storage_bytes

# the sharded int8 update works in chunks of its tile's rows: at this
# width, several chunks a leaf, as at full width
opt_lib._Q8_CHUNK = 1000

#: the targets of other kinds trained on (data 4, model 1) with FSDP
OTHER_KINDS = ("recurrentgemma-2b", "rwkv6-1.6b", "grok-1-314b",
               "llama-3.2-vision-11b", "whisper-medium")


def model_cfg(remat=False):
    return ModelConfig(remat=remat, **MODEL)


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in pm.flatten(tree).items()}


def _clone(tree):
    return pm.tree_map(lambda t: t.clone(), tree)


def train(cfg, full, bt, mesh, fsdp, chunk=None, steps=STEPS, hp=None):
    """Step 1's loss and whole gradient, then ``steps`` train steps from
    ``full``: (loss, grads, losses, grad norms, whole params after and,
    for adamw8bit or Adafactor, the optimizer state after), the whole
    trees gathered (the state in JAX's layout); ``mesh`` None:
    unsharded."""
    hp = OptimizerConfig(**(hp or HP))
    ctx = (sh.use_sharding(mesh, sh.LOGICAL_RULES, fsdp=fsdp)
           if mesh is not None else _null())
    with ctx:
        gf = make_grad_fn(cfg, loss_seq_chunk=chunk, device="cpu")
        plan = gf.plan()
        p = full if plan is None else sh.constrain_params(full,
                                                          plan.shardings)
        loss, grads, _ = gf(p, bt)
        step, init = make_train_step(cfg, loss_seq_chunk=chunk, hp=hp,
                                     device="cpu")
        params = _clone(full)
        state = init(params)
        losses, gnorms = [], []
        for _ in range(steps):
            params, state, m = step(params, state, bt)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        if plan is not None:
            grads = sh.gather_tree(grads, plan.shardings)
            params = sh.constrain_params(params, plan.shardings)
            whole = opt_lib.gather_state(state, params, cfg, plan.leaves)
            back = pm.flatten(opt_lib.shard_state(whole, params, cfg,
                                                  plan.leaves))
            # the rank's state cut back from the whole is its own
            round_trip = all(torch.equal(back[k], v) for k, v in
                             pm.flatten(state).items())
            state = whole
            params = sh.gather_tree(params, plan.shardings)
    out = {"loss": float(loss), "grads": _np(grads), "losses": losses,
           "grad_norms": gnorms, "params": _np(params)}
    if hp.name != "adamw":
        out["opt"] = _np(state)
        if plan is not None:
            out["state_round_trip"] = round_trip
    return out


def dryrun_cell(cfg, name):
    """The dry run's tiny cell: the (2, 2) FSDP train step of ``cfg`` on
    ``B`` x ``T`` tokens with optimizer ``name`` (JAX's train rules)."""
    return build_cell("tiny", "tiny", cfg=cfg,
                      shape=ShapeSpec("tiny", T, B, "train"),
                      hp=OptimizerConfig(**dict(HP, name=name)))


def real_counts(cfg, full, mesh, name):
    """One real step of :func:`dryrun_cell`: this rank's storage bytes
    (params, optimizer state) and the step's collectives by kind
    (``sharding.COLLECTIVES``)."""
    cell = dryrun_cell(cfg, name)
    with sh.use_sharding(mesh, cell.rules, fsdp=cell.fsdp):
        step, init = make_train_step(cfg, hp=OptimizerConfig(
            **dict(HP, name=name)), device="cpu")
        params = sh.constrain_params(_clone(full), step.plan().shardings)
        state = init(params)
        storage = {"params": storage_bytes(params),
                   "opt_state": storage_bytes(state)}
        sh.reset_collectives()
        step(params, state, batch(False))
        return {"storage": storage, "collectives": sh.collective_counts()}


def serve_cell(kind):
    """The dry run's small serving cell of ``kind`` ("decode" or
    "prefill"): the bf16 target of ``SERVE_MODEL`` and its two production
    drafters, ``SERVE_B`` rows, a ``SERVE_T``-token prompt (JAX's
    serving rules, the dense engine state)."""
    return build_cell("tiny", "tiny", cfg=ModelConfig(**SERVE_MODEL),
                      shape=ShapeSpec("tiny", SERVE_T, SERVE_B, kind),
                      gamma=SERVE_GAMMA, k_branches=SERVE_K)


def real_serve_counts(kind, mesh):
    """One real run of :func:`serve_cell` on this rank: the cell's meta
    arguments replaced by random weights (seed 0, in the cell's bf16) and
    zero prompts, cut as ``rank_args`` cuts them; the rank's argument
    bytes by part (``dryrun.trace_cell``'s parts) and the step's
    collectives by kind."""
    cell = serve_cell(kind)
    bundle = cell.args[0]
    bf16 = lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t  # noqa: E731
    cell.args = (dataclasses.replace(
        bundle,
        target_params=pm.tree_map(bf16, api.init_model(
            bundle.target_cfg, seed=0, device="cpu")),
        d1_params=pm.tree_map(bf16, drafter_init(bundle.d1_cfg, 0, "cpu")),
        d2_params=pm.tree_map(bf16, drafter_init(bundle.d2_cfg, 1, "cpu"))),
        ) + tuple(torch.zeros(a.shape, dtype=a.dtype)
                  if isinstance(a, torch.Tensor) else a
                  for a in cell.args[1:])
    with sh.use_sharding(mesh, cell.rules, fsdp=cell.fsdp), \
            torch.no_grad():
        args = rank_args(cell)
        parts = dryrun.arg_parts(cell, args)
        sh.reset_collectives()
        cell.fn(*args)
        return {"parts": parts, "collectives": sh.collective_counts()}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def other_cfg(arch):
    """``arch``'s smoke config in fp32 with remat."""
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", remat=True)


def other_batch(cfg):
    """A batch of ``B`` x 16 tokens for ``cfg`` (seed 3), its modality
    embeddings in fp32 (the model's dtype: no bf16 product whose
    rounding depends on how the rows are split)."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in api.make_batch(3, cfg, B, 16, device="cpu").items()}


def _storage(cfg, full, mesh, fsdp):
    """Every leaf's local shape and the plan's gradient-sum table and
    head counts in ``mesh``."""
    with sh.use_sharding(mesh, sh.LOGICAL_RULES, fsdp=fsdp):
        plan = make_grad_fn(cfg, device="cpu").plan()
        run = sh.batch_run(B)
        local = {k: tuple(v.shape) for k, v in pm.flatten(
            sh.constrain_params(full, plan.shardings)).items()}
        return {"local": local, "grad_axes": plan.grad_axes(run),
                "heads": (plan.hq, plan.q_lo, plan.hkv, plan.kv_lo)}


def scenarios(rank, n, full, ckpt_dir):
    """n 8: the (2, 4) step cases (remat on), the checkpoint saved from
    (2, 4), the pipeline on (pod 4, data 2); n 4: the (2, 2) cases, the
    dry run's cell's real step with each optimizer and its serving cells'
    real runs, the chunked loss, and the other kinds under data
    parallelism and FSDP on (4, 1)."""
    out = {"rank": rank}
    if n == 8:
        mesh = make_mesh(2, 4)
        for name, (data, model, fsdp, uneven) in CASES.items():
            if data * model == 8:
                out[name] = train(model_cfg(remat=True), full, batch(uneven),
                                  mesh, fsdp, hp=hp(name))
        out["storage"] = _storage(model_cfg(), full, mesh, True)
        with sh.use_sharding(mesh, sh.LOGICAL_RULES):
            shards = sh.params_shardings(full)
            Checkpointer(ckpt_dir).save(1, sh.shard_tree(full), shardings=shards)
        pod = make_mesh(2, 1, pod=4)
        w, xs = pipeline_inputs()
        with sh.use_sharding(pod, sh.LOGICAL_RULES), torch.no_grad():
            pp.STAGE_CALLS["n"] = 0
            y = pp.pipeline_apply(
                lambda p, x: torch.tanh(x @ p["w"]),
                {"w": torch.from_numpy(w)}, torch.from_numpy(xs))
            out["pipeline"] = (y.numpy(), pp.STAGE_CALLS["n"])
            # the rank's own stage slice, as JAX's shard_map hands it
            i = pod.index("pod")
            y1 = pp.pipeline_apply(
                lambda p, x: torch.tanh(x @ p["w"]),
                {"w": torch.from_numpy(w[i:i + 1])}, torch.from_numpy(xs))
            out["pipeline_own"] = y1.numpy()
        return out
    mesh = make_mesh(2, 2)
    cfg = model_cfg()
    for name, (data, model, fsdp, uneven) in CASES.items():
        if data * model == 4:
            out[name] = train(cfg, full, batch(uneven), mesh, fsdp,
                              hp=hp(name))
    out["dryrun"] = {o: real_counts(cfg, full, mesh, o) for o in OPTIMIZERS}
    out["serve"] = {k: real_serve_counts(k, mesh) for k in SERVE_KINDS}
    out["2x2_chunk"] = train(cfg, full, batch(True), mesh, False,
                             chunk=CHUNK, steps=1)
    out["2x2_unchunked"] = train(cfg, full, batch(True), mesh, False,
                                 steps=1)
    dp = make_mesh(4, 1)
    for arch in OTHER_KINDS:
        acfg = other_cfg(arch)
        aparams = api.init_model(acfg, seed=0, device="cpu")
        abatch = other_batch(acfg)
        out[arch] = train(acfg, aparams, abatch, dp, True, steps=1,
                          hp=dict(HP, name="adamw"))
    return out

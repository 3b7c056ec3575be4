"""JAX references for ``tests/test_torch_mesh_train.py`` (not a test
module).

Run as ``python _torch_mesh_train_jax.py OUT`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` with ``src`` and
``tests`` on ``PYTHONPATH``: for each case of
``_torch_mesh_train_inputs.CASES`` it runs JAX's sharded train step
(``tests/test_distributed.py:73``'s: ``constrain_params``, then
``value_and_grad`` of ``lm.loss_fn`` and the AdamW update, jitted with
the parameter shardings) for ``STEPS`` steps inside the case's mesh,
and ``pipeline_apply`` on the (pod 4, data 2) mesh. It writes
``OUT/ref.npz``: ``{case}/loss``, ``{case}/grad_norm`` (a step each),
``{case}/grad/<path>`` (step 1), ``{case}/param/<path>`` and, for an
adamw8bit or Adafactor case, ``{case}/opt/<path>`` (after the last
step), ``dryrun/flops`` (:func:`dryrun_flops`),
``serve/{kind}/argument_bytes`` and ``serve/{kind}/pruned_bytes``
(:func:`serve_cells`), ``pipeline``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from _torch_mesh_train_inputs import (CASES, MODEL, SERVE_B, SERVE_GAMMA,
                                      SERVE_K, SERVE_KINDS, SERVE_MODEL,
                                      SERVE_T, STEPS, batch, hp,
                                      pipeline_inputs)

from repro.config.base import ModelConfig, OptimizerConfig, SpecConfig
from repro.distributed import compat
from repro.distributed import sharding as sh
from repro.distributed.pipeline_parallel import pipeline_apply
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.optim import optimizers as opt_lib
from repro.roofline.hlo_analysis import analyze_hlo_text


def step_case(name, out):
    data, model, fsdp, uneven = CASES[name]
    cfg = ModelConfig(remat=False, **MODEL)
    params = lm.lm_init(jax.random.PRNGKey(0), cfg)
    opt_init, opt_update = opt_lib.make_optimizer(OptimizerConfig(**hp(name)))
    opt = opt_init(params)
    bt = {k: jnp.asarray(v) for k, v in batch(uneven).items()}

    def step(params, opt, batch):
        params = sh.constrain_params(params)
        loss, g = jax.value_and_grad(
            lambda p: lm.loss_fn(p, batch, cfg))(params)
        p2, o2, metrics = opt_update(g, opt, params)
        return p2, o2, loss, g, metrics["grad_norm"]

    mesh = make_mesh(data=data, model=model)
    with sh.use_sharding(mesh, sh.LOGICAL_RULES, fsdp=fsdp):
        shardings = (sh.params_shardings(params, mesh),
                     sh.params_shardings(opt, mesh))
        fn = jax.jit(step, in_shardings=shardings + (
            sh.params_shardings(bt, mesh),))
        losses, gnorms = [], []
        for i in range(STEPS):
            # the step's outputs back at the rule shardings (XLA may lay
            # an int8 moment out otherwise)
            params, opt = jax.device_put((params, opt), shardings)
            params, opt, loss, g, gn = fn(params, opt, bt)
            losses.append(float(loss))
            gnorms.append(float(gn))
            if i == 0:
                for k, v in sh.tree_paths(g).items():
                    out[f"{name}/grad/{k}"] = np.asarray(v)
    for k, v in sh.tree_paths(params).items():
        out[f"{name}/param/{k}"] = np.asarray(v)
    if hp(name)["name"] != "adamw":
        for k, v in sh.tree_paths(opt).items():
            out[f"{name}/opt/{k}"] = np.asarray(v)
    out[f"{name}/loss"] = np.asarray(losses)
    out[f"{name}/grad_norm"] = np.asarray(gnorms)


def dryrun_flops(out):
    """The per-device FLOPs of the (2, 2) FSDP AdamW step (the dry run's
    tiny cell, one step, no remat), from ``analyze_hlo_text`` of the
    compiled step: ``dryrun/flops``."""
    cfg = ModelConfig(remat=False, **MODEL)
    params = lm.lm_init(jax.random.PRNGKey(0), cfg)
    opt_init, opt_update = opt_lib.make_optimizer(OptimizerConfig(**hp("")))
    opt = opt_init(params)
    bt = {k: jnp.asarray(v) for k, v in batch(False).items()}
    rules = dict(sh.LOGICAL_RULES, act_seq="model", kv_seq=None)

    def step(params, opt, batch):
        params = sh.constrain_params(params)
        loss, g = jax.value_and_grad(
            lambda p: lm.loss_fn(p, batch, cfg))(params)
        p2, o2, _ = opt_update(g, opt, params)
        return p2, o2, loss

    mesh = make_mesh(data=2, model=2)
    with sh.use_sharding(mesh, rules, fsdp=True):
        fn = jax.jit(step, in_shardings=(sh.params_shardings(params, mesh),
                                         sh.params_shardings(opt, mesh),
                                         sh.params_shardings(bt, mesh)))
        text = fn.lower(params, opt, bt).compile().as_text()
    out["dryrun/flops"] = np.asarray(analyze_hlo_text(text)["flops"])


def serve_cells(out):
    """The per-device argument bytes of the dry run's small serving cells
    as JAX's ``run_cell`` builds them (``launch/dryrun.py:75``): the
    bundle (``make_bundle_abstract``), the dense engine state
    (``engine_state_abstract``), the prompts or the key, every argument
    at ``params_shardings`` under the cell's rules, on the (2, 2) mesh;
    ``memory_analysis().argument_size_in_bytes`` of the compiled step with
    every argument kept (``keep_unused``: ``serve/{kind}/argument_bytes``)
    and as ``run_cell`` compiles it (arguments the step never reads
    dropped: ``serve/{kind}/pruned_bytes``)."""
    cfg = ModelConfig(**SERVE_MODEL)
    bundle = steps_lib.make_bundle_abstract(
        cfg, SpecConfig(gamma=SERVE_GAMMA, top_k_branches=SERVE_K))
    est = steps_lib.engine_state_abstract(bundle, SERVE_B,
                                          steps_lib._cap_for(SERVE_T))
    mesh = make_mesh(data=2, model=2)
    for kind in SERVE_KINDS:
        rules = dict(sh.LOGICAL_RULES, kv_seq="model",
                     act_seq=None if kind == "decode" else "model")
        if kind == "decode":
            fn = steps_lib.make_serve_step()
            args = (bundle, est, jax.ShapeDtypeStruct((2,), jnp.uint32))
        else:
            fn = steps_lib.make_prefill_step(cfg)
            args = (bundle, est,
                    jax.ShapeDtypeStruct((SERVE_B, SERVE_T), jnp.int32))
        with sh.use_sharding(mesh, rules, fsdp=False):
            ins = sh.params_shardings(args, mesh)
            for key, keep in (("argument_bytes", True),
                              ("pruned_bytes", False)):
                mem = jax.jit(fn, in_shardings=ins, keep_unused=keep).lower(
                    *args).compile().memory_analysis()
                out[f"serve/{kind}/{key}"] = np.asarray(
                    mem.argument_size_in_bytes)


def pipeline(out):
    w, xs = pipeline_inputs()
    mesh = compat.make_mesh((4, 2), ("pod", "data"))

    def stage(wi, x):
        return jnp.tanh(x @ wi["w"])

    with sh.use_sharding(mesh, sh.LOGICAL_RULES):
        out["pipeline"] = np.asarray(jax.jit(
            lambda w, xs: pipeline_apply(stage, {"w": w}, xs))(
                jnp.asarray(w), jnp.asarray(xs)))


def main(out_dir):
    assert jax.device_count() >= 8, jax.device_count()
    out = {}
    for name in CASES:
        step_case(name, out)
    dryrun_flops(out)
    serve_cells(out)
    pipeline(out)
    np.savez(Path(out_dir) / "ref.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:])

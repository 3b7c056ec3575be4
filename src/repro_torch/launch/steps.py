"""Training step, optimizer choice, the production drafter's size, the
prefill and serve steps, and the abstract (meta-device) specs of every
(arch x shape) cell that the multi-device dry run traces
(``launch/dryrun.py``; twin of ``repro/launch/steps.py``).

The step is ``loss.backward()`` on ``models.api.train_loss`` with
``attn_impl="kernel"``: on the card every attention layer runs the CUDA
flash forward kernel (again under remat) and both flash backward
kernels. Then the optimizer updates params and moments in place.

Inside a mesh (``use_sharding``) the step is the SPMD form of JAX's
sharded step (``distributed/train_mesh.py``): it runs
``constrain_params`` first, as JAX does (the params become the rank's
storage by the parameter rules), takes its run of the global batch's
rows, computes the loss with the model's collectives, sums each
gradient by the plan's table, and updates the rank's shards.

The prefill step of a cross-attention target takes its context: an
encoder-decoder encodes the audio frames and prefills with the encoder's
output, a VLM prefills with the image embeddings (``ctx_len_for`` sizes
the engine's cross caches for them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config.base import (ModelConfig, OptimizerConfig,
                                     SpecConfig, shape_by_name)
from repro_torch.config.registry import get_config
from repro_torch.core import pipeline as pl
from repro_torch.core import state as state_lib
from repro_torch.core.drafter import DrafterConfig, drafter_init
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import train_mesh as tm
from repro_torch.models import api, encdec, lm
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as opt_lib


GAMMA_PROD = 16
K_PROD = 4


def production_drafter(tcfg: ModelConfig, gamma: int = GAMMA_PROD,
                       causal: bool = False) -> DrafterConfig:
    """The drafter served beside ``tcfg``: d = max(512, d_model / 4
    rounded down to 128), heads of 128, 2 KV heads when the heads are
    even (else 1), ff 3d, two layers, reading the target's features."""
    d = max(512, (tcfg.d_model // 4) // 128 * 128)
    heads = max(4, d // 128)
    kv = 2 if heads % 2 == 0 else 1          # must divide heads
    return DrafterConfig(
        d_model=d, num_layers=2, num_heads=heads,
        num_kv_heads=kv, d_ff=3 * d,
        vocab_size=tcfg.vocab_size, target_feature_dim=lm.feature_dim(tcfg),
        gamma=gamma, causal=causal)


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    # factored moments for the giant MoEs; int8 moments for mid-size; plain
    # AdamW for small models
    n = cfg.param_count()
    if n > 1e11:
        return OptimizerConfig(name="adafactor")
    if n > 3e9:
        return OptimizerConfig(name="adamw8bit")
    return OptimizerConfig(name="adamw")


def _cap_for(seq_len: int) -> int:
    return seq_len + 1024


# ---------------------------------------------------------------- specs ----
def _cast(tree, dtype):
    """``tree`` with its floating leaves in ``dtype`` (None: as they are)."""
    if dtype is None:
        return tree
    return pm.tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                       else t, tree)


def abstract_params(cfg: ModelConfig, dtype=None):
    """``cfg``'s params drawn on the meta device: the whole leaves' shapes
    and dtypes, no values (JAX's ``abstract_params``); ``dtype``: the
    floating leaves in it."""
    return _cast(api.init_model(cfg, device="meta"), dtype)


def abstract_tree(fn, *args):
    """What ``fn`` returns on meta ``args`` (JAX's ``eval_shape``): the
    same code run on the meta device, shapes and dtypes only."""
    with torch.no_grad():
        return fn(*args)


def _sds_tree(tree):
    """Meta stand-ins of a tree's leaves (JAX's ``ShapeDtypeStruct``s)."""
    return pm.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), tree)


def make_bundle_abstract(cfg: ModelConfig, spec: SpecConfig,
                         serve_dtype=torch.bfloat16):
    """The served bundle on meta: ``cfg``'s params and the two production
    drafters' (:func:`production_drafter`), floating leaves in
    ``serve_dtype``."""
    d1_cfg = production_drafter(cfg, spec.gamma)
    d2_cfg = production_drafter(cfg, spec.gamma)
    tp = abstract_params(cfg, serve_dtype)
    dp1 = _cast(drafter_init(d1_cfg, device="meta"), serve_dtype)
    dp2 = _cast(drafter_init(d2_cfg, device="meta"), serve_dtype)
    return pl.SpecBundle(cfg, d1_cfg, d2_cfg, spec, tp, dp1, dp2)


def make_grad_fn(cfg: ModelConfig, loss_seq_chunk: Optional[int] = None,
                 attn_impl: str = "kernel", device="cuda"):
    """``grad_fn(params, batch) -> (loss, grads, plan)``: the loss and the
    gradient tree of the train step (``plan`` None outside a mesh).
    Inside a mesh ``params`` must be the rank's storage
    (``sharding.constrain_params``); the batch is the whole batch, of
    which the rank runs its rows, and each gradient is this rank's shard
    of the whole gradient, summed by the plan's table."""
    dev = resolve_device(device)
    plans = {}

    def plan():
        mesh = sh.active_mesh()
        if mesh is None:
            return None
        key = (id(mesh), sh.fsdp_enabled(),
               tuple(sorted((k, str(v)) for k, v in sh.active_rules()
                            .items())))
        if key not in plans:
            plans[key] = tm.make_plan(cfg, mesh, abstract_params(cfg))
        return plans[key]

    def grad_fn(params, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        pl_ = plan()
        scope = None
        if pl_ is not None:
            b, t = batch["tokens"].shape[:2]
            scope = tm.make_scope(pl_, b, t)
            batch = {k: scope.rows_mine(v) for k, v in batch.items()}
        flat = pm.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        try:
            with tm.train_scope(scope):
                loss = api.train_loss(params, batch, cfg,
                                      attn_impl=attn_impl,
                                      loss_seq_chunk=loss_seq_chunk)
                grads = torch.autograd.grad(loss, list(flat.values()))
        finally:
            for p in flat.values():
                p.requires_grad_(False)
        grads = dict(zip(flat, grads))
        if pl_ is not None:
            grads = pl_.reduce_grads(grads, scope.run)
        return loss.detach(), pm.unflatten_like(params, grads), pl_

    grad_fn.plan = plan
    return grad_fn


def make_train_step(cfg: ModelConfig, loss_seq_chunk: Optional[int] = None,
                    hp: Optional[OptimizerConfig] = None,
                    attn_impl: str = "kernel", device="cuda"):
    """(train_step, opt_init). ``train_step(params, opt_state, batch)``
    returns ``(params, opt_state, {"loss", "lr", "grad_norm"})``, with
    params and moments updated in place; the batch may be numpy (it is
    moved to ``device``). ``loss_seq_chunk``: the cross entropy over
    sequence chunks of that length (``lm.loss_fn``), so the [B,S,V]
    logits and their gradient never exist whole. ``hp`` defaults to
    :func:`optimizer_for`.

    Inside a mesh both take whole params or the rank's storage and cut
    them to the storage (``constrain_params``; the returned params are
    the storage), the batch is the whole batch, and the loss and grad
    norm are the whole step's, the same on every rank."""
    hp = hp if hp is not None else optimizer_for(cfg)
    opt_init, opt_update = opt_lib.make_optimizer(hp, cfg)
    grad_fn = make_grad_fn(cfg, loss_seq_chunk, attn_impl, device)

    def constrain(params):
        pl_ = grad_fn.plan()
        if pl_ is None:
            return params, None
        return sh.constrain_params(params, pl_.shardings), pl_

    def init(params):
        params, pl_ = constrain(params)
        return opt_init(params, None if pl_ is None else pl_.leaves)

    def train_step(params, opt_state, batch):
        params, pl_ = constrain(params)
        loss, grads, _ = grad_fn(params, batch)
        new_p, new_o, metrics = opt_update(
            grads, opt_state, params,
            shards=None if pl_ is None else pl_.leaves)
        return new_p, new_o, {"loss": loss, **metrics}

    train_step.plan = grad_fn.plan
    return train_step, init


def ctx_len_for(cfg: ModelConfig) -> int:
    """Length of the context a target's cross caches hold (0: none)."""
    if cfg.is_encoder_decoder:
        return cfg.enc_max_len
    if cfg.cross_attn_every:
        return max(cfg.num_vision_tokens, 1)
    return 0


def engine_state_abstract(bundle, batch: int, max_len: int,
                          run: Optional[sh.BatchRun] = None,
                          device="meta"):
    """The engine state of a wave of ``batch`` rows on meta (or zeroed on
    ``device``): JAX's dense ``engine_init`` (the cross caches sized by
    :func:`ctx_len_for`).
    Inside a mesh it is what a rank holds by JAX's state rules: ``run``
    (this rank's run of the rows) sets its rows, a kv_seq axis its run of
    every dense cache's slots (``kvcache.dense_cache``), the model axis
    its slice of each recurrent state (``kvcache.state_leaf``)."""
    return state_lib.engine_init(bundle, batch, max_len,
                                 ctx_len=ctx_len_for(bundle.target_cfg),
                                 cache_impl="dense", device=device, run=run)


def serve_fsdp(cfg: ModelConfig) -> bool:
    """Whether a serving cell stores its weights FSDP over ``data`` too:
    only the giant MoEs, whose weights do not fit a model-axis shard."""
    return cfg.param_count() > 1e11


def make_prefill_step(cfg: ModelConfig):
    """The prefill of ``cfg``'s family: ``step(enc_params, bundle, state,
    prompts, audio_feats)`` for an encoder-decoder, ``step(bundle, state,
    prompts, image_embeds)`` for a VLM, else ``step(bundle, state,
    prompts)``; each returns the prefilled ``EngineState``."""
    if cfg.is_encoder_decoder:
        def step(enc_params, bundle, est, prompts, audio_feats):
            ctx = encdec.encode(enc_params, _run_rows(est, audio_feats),
                                cfg)
            return state_lib.prefill(bundle, est, _run_rows(est, prompts),
                                     ctx=ctx)
        return step
    if cfg.cross_attn_every:
        def step(bundle, est, prompts, image_embeds):
            return state_lib.prefill(bundle, est, _run_rows(est, prompts),
                                     ctx=_run_rows(est, image_embeds))
        return step

    def step(bundle, est, prompts):
        return state_lib.prefill(bundle, est, _run_rows(est, prompts))
    return step


def _run_rows(est, x):
    """The rows of ``x`` (a whole batch's prompts or context) that the
    state ``est`` holds: its run of a batch-split wave, else all."""
    run = est.run
    return x if run is None or not run.split else x[run.rows]


def make_serve_step():
    """``serve_step(bundle, state, gen)``: one decode cycle, no stats."""
    def serve_step(bundle, est, gen):
        return pl.decode_cycle(bundle, est, gen, collect_stats=False)
    return serve_step


# ----------------------------------------------------------- cell specs ----
@dataclasses.dataclass
class CellSpec:
    """Everything needed to trace one (arch x shape) cell: the step, its
    whole abstract arguments (meta tensors; a serving cell's engine state
    is made for the rank, :func:`rank_args`), the logical rules, FSDP,
    the kind, and (``opt_init``, ``cfg``, ``shape``) what the rank's
    arguments are made from."""
    fn: Any
    args: Tuple[Any, ...]
    rules: Dict[str, Any]
    fsdp: bool
    kind: str
    cfg: Any = None
    shape: Any = None
    opt_init: Any = None


def build_cell(arch: str, shape_name: str,
               gamma: int = GAMMA_PROD, k_branches: int = K_PROD,
               loss_seq_chunk: Optional[int] = None,
               remat_policy: Optional[str] = None,
               cfg: Optional[ModelConfig] = None, shape=None,
               hp: Optional[OptimizerConfig] = None) -> Optional[CellSpec]:
    """JAX's ``build_cell``: None when the cell is skipped (``long_500k``
    on a target that is not subquadratic). The rules per kind are JAX's:
    train ``act_seq`` on ``model``, ``kv_seq`` None, FSDP on; prefill
    ``act_seq`` and ``kv_seq`` on ``model``; decode ``act_seq`` None,
    ``kv_seq`` on ``model``; serving FSDP only above 1e11 parameters.
    The train step runs the flash kernels; a serving cell's bundle reads
    its caches through the cascade kernels (``attn_impl="kernel"``).
    ``cfg`` and ``shape`` (a ``ShapeSpec``) stand in for the registry's
    config and the named shape, ``hp`` for :func:`optimizer_for`'s
    choice (a small cell)."""
    cfg = get_config(arch) if cfg is None else cfg
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    shape = shape_by_name(shape_name) if shape is None else shape
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return None

    rules = dict(sh.LOGICAL_RULES)
    if shape.kind == "train":
        rules["act_seq"] = "model"
        rules["kv_seq"] = None
        hp = optimizer_for(cfg) if hp is None else hp
        step, opt_init = make_train_step(cfg, loss_seq_chunk, hp=hp,
                                         device="meta")
        params = abstract_params(cfg)
        opt_state = opt_lib.make_optimizer(hp, cfg)[0](params)
        batch = api.batch_specs(cfg, shape.global_batch, shape.seq_len)
        return CellSpec(step, (params, opt_state, batch), rules, True,
                        "train", cfg, shape, opt_init)

    cfg = dataclasses.replace(cfg, attn_impl="kernel")
    spec_c = SpecConfig(gamma=gamma, top_k_branches=k_branches)
    bundle = make_bundle_abstract(cfg, spec_c)
    # serving: TP-sharded weights replicated across data, except the giant
    # MoEs whose weights don't fit a single model-axis shard
    fsdp = serve_fsdp(cfg)
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")  # noqa: E731

    if shape.kind == "prefill":
        rules["act_seq"] = "model"
        rules["kv_seq"] = "model"
        prompts = meta((shape.global_batch, shape.seq_len), torch.int32)
        step = make_prefill_step(cfg)
        if cfg.is_encoder_decoder:
            enc = abstract_params(cfg, torch.bfloat16)["encoder"]
            audio = meta((shape.global_batch, cfg.enc_max_len, cfg.d_model),
                         torch.bfloat16)
            bundle_dec = dataclasses.replace(
                bundle, target_params=bundle.target_params["decoder"])
            args = (enc, bundle_dec, None, prompts, audio)
        elif cfg.cross_attn_every:
            img = meta((shape.global_batch, max(cfg.num_vision_tokens, 1),
                        cfg.d_model), torch.bfloat16)
            args = (bundle, None, prompts, img)
        else:
            args = (bundle, None, prompts)
        return CellSpec(step, args, rules, fsdp, "prefill", cfg, shape)

    # decode
    rules["act_seq"] = None
    rules["kv_seq"] = "model"
    if cfg.is_encoder_decoder:
        bundle = dataclasses.replace(
            bundle, target_params=bundle.target_params["decoder"])
    return CellSpec(make_serve_step(), (bundle, None, None), rules,
                    fsdp, "decode", cfg, shape)


def rank_args(cell: CellSpec):
    """The arguments one rank of the active mesh passes to ``cell.fn``, as
    JAX's ``in_shardings`` (``params_shardings`` of every argument) cut
    the whole ones. A train cell: the params cut to the rank's storage
    and its optimizer state made from them (the rank's moments), the
    whole batch (the step takes the rank's rows). A serving cell: the
    bundle at the rank's storage (``pipeline.serve_storage``; a MoE
    target's expert stacks first cut to its expert-parallel part,
    ``ep.ep_shard_target``), an encoder's params likewise; the engine
    state (the first ``None`` in ``cell.args``) made as the rank holds it
    (:func:`engine_state_abstract`: its rows, its run of the dense
    caches' slots, its slice of each recurrent state; on the bundle's
    device, so a cell of real weights gives a real run); every other
    argument (the prompts, the context; a decode cell's generator stays
    None: greedy) at its rule's slice, which leaves them whole, as JAX's
    rules match no bare argument."""
    if cell.kind == "train":
        params, _, batch = cell.args
        pl_ = cell.fn.plan()
        params = sh.constrain_params(params, pl_.shardings)
        return params, cell.opt_init(params), batch
    from repro_torch.distributed import ep
    b = cell.shape.global_batch
    args = list(cell.args)
    at = next(i for i, a in enumerate(args) if isinstance(a, pl.SpecBundle))
    bundle = args[at]
    bundle = dataclasses.replace(bundle, target_params=ep.ep_shard_target(
        bundle.target_params, bundle.target_cfg, sh.active_mesh()))
    args[at] = pl.serve_storage(bundle)
    st = args.index(None)
    dev = next(iter(pm.flatten(bundle.target_params).values())).device
    args[st] = engine_state_abstract(bundle, b, _cap_for(cell.shape.seq_len),
                                     run=sh.batch_run(b), device=dev)
    for i, a in enumerate(args):
        if i in (at, st) or a is None:
            continue
        if isinstance(a, torch.Tensor):
            args[i] = sh.leaf_shard(str(i), a.shape).take(a)
        else:
            args[i] = sh.serve_storage(a)
    return tuple(args)

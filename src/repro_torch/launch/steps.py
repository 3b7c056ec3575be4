"""Training step, optimizer choice, the production drafter's size and the
prefill and serve steps (twin of ``repro/launch/steps.py`` but its
``build_cell`` and the rest of its abstract specs, which only the
multi-device dry run uses: ROADMAP.md queue 1, item 10b).

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

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig, OptimizerConfig
from repro_torch.core import pipeline as pl
from repro_torch.core import state as state_lib
from repro_torch.core.drafter import DrafterConfig
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


def abstract_params(cfg: ModelConfig):
    """``cfg``'s params drawn on the meta device: the whole leaves' shapes
    and dtypes, no values (JAX's ``abstract_params``)."""
    return api.init_model(cfg, device="meta")


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
        return opt_init(constrain(params)[0])

    def train_step(params, opt_state, batch):
        params, pl_ = constrain(params)
        loss, grads, _ = grad_fn(params, batch)
        new_p, new_o, metrics = opt_update(
            grads, opt_state, params,
            shard_axes=None if pl_ is None else pl_.norm_axes)
        return new_p, new_o, {"loss": loss, **metrics}

    return train_step, init


def ctx_len_for(cfg: ModelConfig) -> int:
    """Length of the context a target's cross caches hold (0: none)."""
    if cfg.is_encoder_decoder:
        return cfg.enc_max_len
    if cfg.cross_attn_every:
        return max(cfg.num_vision_tokens, 1)
    return 0


def make_prefill_step(cfg: ModelConfig):
    """The prefill of ``cfg``'s family: ``step(enc_params, bundle, state,
    prompts, audio_feats)`` for an encoder-decoder, ``step(bundle, state,
    prompts, image_embeds)`` for a VLM, else ``step(bundle, state,
    prompts)``; each returns the prefilled ``EngineState``."""
    if cfg.is_encoder_decoder:
        def step(enc_params, bundle, est, prompts, audio_feats):
            ctx = encdec.encode(enc_params, audio_feats, cfg)
            return state_lib.prefill(bundle, est, prompts, ctx=ctx)
        return step
    if cfg.cross_attn_every:
        def step(bundle, est, prompts, image_embeds):
            return state_lib.prefill(bundle, est, prompts, ctx=image_embeds)
        return step

    def step(bundle, est, prompts):
        return state_lib.prefill(bundle, est, prompts)
    return step


def make_serve_step():
    """``serve_step(bundle, state, gen)``: one decode cycle, no stats."""
    def serve_step(bundle, est, gen):
        return pl.decode_cycle(bundle, est, gen, collect_stats=False)
    return serve_step

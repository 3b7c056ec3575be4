"""The port's training path held to the JAX package: the loss and its
gradients through the flash op (``attn_impl="kernel"``, the plain torch
versions on CPU tensors) against ``jax.value_and_grad`` of ``lm.loss_fn``
with ``attn_impl="pallas"`` (Pallas interpret mode); three steps of each
optimizer; the synthetic data stream; checkpoint/restart; the launcher.

Weights go across through ``repro_torch.convert`` (params and grads alike,
the period axis unstacked); inputs are the synthetic task batches, which
are numpy. Everything is float32. Tolerances: loss rtol 1e-5 and grads
atol 2e-6 + rtol 1e-4 (the two sides differ in summation order only);
params after three steps atol 1e-5, 1 % of one step; int8 moments within
one quantum. The port's optimizer moments are laid out as JAX's (stacked
over periods), so they are compared leaf for leaf, with no conversion.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_target

from _torch_parity import jax_lm_init, np_tree, port_lm, port_model_cfg
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.data.synthetic import SyntheticDataset as JDataset
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config.base import OptimizerConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as opt_lib
from repro_torch.training.trainer import (InjectedFailure, StragglerMonitor,
                                          train)

SEQ = 256          # two 128-key blocks: the flash kernels' 2 x 2 tiles

CONFIGS = {
    # paper_target.smoke()-like: GQA 4/2 with qk_norm
    "qwen": dict(num_layers=2, qk_norm=True, rope_theta=1e6),
    # gemma2-style local/global hybrid with both softcaps and post-norm
    "gemma": dict(num_layers=2, layer_pattern=("local", "global"),
                  sliding_window=64, attn_softcap=50.0, logit_softcap=30.0,
                  use_post_norm=True, mlp_act="gelu"),
}


def _jcfg(name):
    return tiny_target(dtype="float32", vocab=128, max_seq_len=512,
                       **CONFIGS[name])


def _batch(seq=SEQ, batch=2, seed=0):
    return JDataset("mixture", batch, seq, seed=seed).next_batch()


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(name, chunk):
    jcfg = _jcfg(name)
    params = jax_lm_init(jax.random.PRNGKey(3), jcfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(
        p, b, jcfg, attn_impl="pallas", loss_seq_chunk=chunk)))
    loss, grads = fn(params, batch)
    return params, float(loss), np_tree(grads)


def _port_loss_grads(params, batch, cfg, **kw):
    leaves = list(pm.flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    loss = tlm.loss_fn(params, batch, cfg, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip(pm.flatten(params), grads))


@pytest.mark.parametrize("name,remat,chunk", [
    ("qwen", False, None), ("qwen", True, None), ("qwen", True, 128),
    ("gemma", False, None), ("gemma", True, None)])
def test_loss_and_grads_match_jax_pallas(name, remat, chunk):
    jparams, jloss, jgrads = _jax_loss_grads(name, chunk)
    tcfg = port_model_cfg(_jcfg(name), remat=remat)
    params = port_lm(jparams, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, grads = _port_loss_grads(params, batch, tcfg, attn_impl="kernel",
                                   loss_seq_chunk=chunk)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = pm.flatten(convert.convert_tree(jgrads, tcfg, device="cpu"))
    assert set(want) == set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), atol=2e-6,
                                   rtol=1e-4, err_msg=path)


def test_remat_recomputes_the_flash_forward():
    """Under remat each layer's forward runs again in the backward, so the
    flash forward runs twice per layer; the gradients agree (to the last
    bits: the CPU GEMMs of a recompute need not round alike)."""
    from repro_torch.kernels import flash_attention as tfa
    jparams, _, _ = _jax_loss_grads("qwen", None)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    calls, grads = {}, {}
    orig = tfa.flash_attention_fwd_plain

    def counting(*a, **k):
        calls[remat] += 1
        return orig(*a, **k)

    tfa.flash_attention_fwd_plain = counting
    try:
        for remat in (False, True):
            calls[remat] = 0
            tcfg = port_model_cfg(_jcfg("qwen"), remat=remat)
            _, grads[remat] = _port_loss_grads(
                port_lm(jparams, tcfg), batch, tcfg, attn_impl="kernel")
    finally:
        tfa.flash_attention_fwd_plain = orig
    assert calls == {False: 2, True: 4}
    for path, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][path], rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------------------------ optimizers --
OPT_CFGS = {
    # one period: each stacked JAX leaf holds one layer
    "one_period": dict(num_layers=2, layer_pattern=("global", "global")),
    # two periods of (local, global) and a tail layer: an int8 block of the
    # stacked [2, 16] q_norm scales spans both layers, Adafactor factors the
    # stacked 1-D leaves and clips its update over the whole stack
    "periods": dict(num_layers=5, layer_pattern=("local", "global"),
                    sliding_window=16),
}


def _jflat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in kp)] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("name,layout", [
    pytest.param("adamw", "one_period", id="adamw"),
    pytest.param("adamw8bit", "one_period", id="adamw8bit"),
    pytest.param("adafactor", "one_period", id="adafactor"),
    pytest.param("adamw", "periods", id="adamw-periods"),
    pytest.param("adamw8bit", "periods", id="adamw8bit-periods"),
    pytest.param("adafactor", "periods", id="adafactor-periods")])
def test_three_optimizer_steps_match_jax(name, layout):
    jcfg = tiny_target(dtype="float32", vocab=128, qk_norm=True,
                       **OPT_CFGS[layout])
    tcfg = port_model_cfg(jcfg)
    hp = dict(name=name, lr=1e-3, total_steps=12, warmup_steps=2)
    if layout == "periods":
        # no clipping: the global norm's summation order differs, and its
        # last bit, through an int8 rounding boundary, moves a step by far
        # more than the tolerance
        hp["grad_clip"] = 1e9
    jinit, jupdate = jopt.make_optimizer(JOptimizerConfig(**hp))

    @jax.jit
    def jstep(p, o, b):
        loss, g = jax.value_and_grad(lambda p_: jlm.loss_fn(p_, b, jcfg))(p)
        p2, o2, m = jupdate(g, o, p)
        return p2, o2, loss, g

    jparams = jax_lm_init(jax.random.PRNGKey(5), jcfg)
    params = port_lm(jparams, tcfg)
    jstate = jinit(jparams)
    step, opt_init = make_train_step(tcfg, hp=OptimizerConfig(**hp),
                                     attn_impl="auto", device="cpu")
    opt_update = opt_lib.make_optimizer(OptimizerConfig(**hp), tcfg)[1]
    state = opt_init(params)
    jds, ds = JDataset("math", 4, 32, seed=0), SyntheticDataset(
        "math", 4, 32, seed=0)
    for _ in range(3):
        jparams, jstate, jloss, jgrads = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in
                              jds.next_batch().items()})
        batch = ds.next_batch()
        if layout == "one_period":
            params, state, metrics = step(params, state, batch)
            np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                                       rtol=1e-5)
        else:
            # the same grads on both sides (the deeper hybrid's own grads
            # differ in summation order, which m / sqrt(v) and the int8
            # rounding amplify): this holds the optimizers alone
            params, state, _ = opt_update(
                convert.convert_tree(np_tree(jgrads), tcfg, device="cpu"),
                state, params)
    assert int(state["step"]) == int(jstate["step"]) == 3

    want = pm.flatten(convert.convert_tree(np_tree(jparams), tcfg,
                                           device="cpu"))
    for path, p in pm.flatten(params).items():
        # 1 % of a step of lr 1e-3: where m nearly cancels, m / sqrt(v)
        # amplifies last-bit differences of the grads
        np.testing.assert_allclose(p.numpy(), want[path].numpy(), atol=1e-5,
                                   err_msg=path)

    for key in ("m", "v"):
        if key not in jstate:
            continue
        jf = _jflat(jstate[key])
        tf = pm.flatten(state[key])
        assert set(tf) == set(jf)
        for path, t in tf.items():
            w = jf[path]
            assert tuple(t.shape) == w.shape, path
            if t.dtype == torch.int8:
                # within one quantum: round-half-even on both sides, but an
                # fp32 input one ulp apart can land across a .5 boundary
                assert np.abs(t.numpy().astype(int) - w.astype(int)).max() \
                    <= 1, path
            else:
                # grads' summation order, relative to the leaf's scale
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-4,
                                           atol=1e-4 * np.abs(w).max(),
                                           err_msg=path)


# ------------------------------------------------------------------ data --
def test_synthetic_data_matches_jax_bitwise():
    for task, kw in (("mixture", {}), ("code", dict(shard_id=1,
                                                     num_shards=2))):
        jds = JDataset(task, 3, 40, seed=4, **kw)
        ds = SyntheticDataset(task, 3, 40, seed=4, **kw)
        for _ in range(3):
            a, b = jds.next_batch(), ds.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        saved = ds.state_dict()
        assert saved == jds.state_dict()
        ahead = [ds.next_batch() for _ in range(2)]
        ds2 = SyntheticDataset(task, 3, 40, seed=0, **kw)
        ds2.load_state_dict(saved)
        for a in ahead:
            np.testing.assert_array_equal(a["tokens"],
                                          ds2.next_batch()["tokens"])
        np.testing.assert_array_equal(jds.prompts(2, 16), ds.prompts(2, 16))


# ------------------------------------------------------ checkpoint/fault --
def _tiny_port(seed=0):
    cfg = port_model_cfg(tiny_target(dtype="float32"))
    return cfg, tlm.lm_init(cfg, seed=seed, device="cpu")


def test_checkpoint_roundtrip_and_integrity(tmp_path):
    cfg, params = _tiny_port()
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"params": params}, extra={"step": 5})
    like = {"params": pm.tree_map(torch.zeros_like, params)}
    restored, extra = ck.restore(like)
    assert extra["step"] == 5
    src = pm.flatten(params)
    for path, t in pm.flatten(restored["params"]).items():
        torch.testing.assert_close(t, src[path], rtol=0, atol=0)
    manifest = (tmp_path / "step_00000005" / "manifest.json").read_text()
    assert "params/layers/0/attn/wq" in manifest
    shard = next((tmp_path / "step_00000005").glob("*.npz"))
    raw = bytearray(shard.read_bytes())
    raw[100] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupted"):
        ck.restore(like)


def test_failure_injection_and_exact_resume(tmp_path):
    """A run with an injected mid-training failure ends with EXACTLY the
    params of an uninterrupted run (checkpoint + data-state resume)."""
    hp = OptimizerConfig(lr=1e-3, total_steps=12, warmup_steps=2)

    def run(inject, ckdir):
        cfg, params = _tiny_port()
        tc = TrainConfig(batch_size=4, seq_len=32, optimizer=hp,
                         checkpoint_every=4, checkpoint_dir=ckdir,
                         log_every=1000)
        step, opt_init = make_train_step(cfg, hp=hp, device="cpu")
        state = {"params": params, "opt_state": opt_init(params), "step": 0}
        fired = {"done": False}

        def pre(step_i):
            if inject and step_i == 6 and not fired["done"]:
                fired["done"] = True
                raise InjectedFailure("simulated node loss")

        return train(step, state, SyntheticDataset("math", 4, 32, seed=0),
                     tc, hooks={"pre_step": pre}, log=lambda *a: None)

    o1 = run(False, str(tmp_path / "a"))
    o2 = run(True, str(tmp_path / "b"))
    assert o2["restarts"] == 1 and len(o1["metrics"]) == 12
    ref = pm.flatten(o1["state"]["params"])
    for path, t in pm.flatten(o2["state"]["params"]).items():
        torch.testing.assert_close(t, ref[path], rtol=0, atol=0)


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=3.0)
    for i in range(20):
        m.record(i, 0.1)
    assert m.record(20, 0.9)
    assert m.flagged == [20]


def test_launcher_trains_the_smoke_config(tmp_path):
    from repro_torch.launch import train as launch
    out = launch.main(["--steps", "3", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)], device="cpu")
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert out["restarts"] == 0


def test_api_rejects_encoder_decoder():
    """The serving entry point refuses an encoder-decoder target:
    ``launch/serve.py --arch whisper-medium`` builds whisper's decoder,
    whose cross layers would read no context (a request carries none),
    and ``ServingEngine`` raises (ROADMAP.md queue 3). Training takes it
    (the test below), and so does ``pipeline.generate(ctx=)``
    (``tests/test_torch_cross.py``)."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="cross-attention"):
        serve.main(["--arch", "whisper-medium", "--requests", "1",
                    "--max-new", "2", "--device", "cpu"])


def test_api_builds_and_trains_encoder_decoder():
    """``api.init_model`` and ``train_loss`` build and run whisper's smoke
    config (the encoder over the batch's audio frames, then the decoder
    cross-attending to it), and ``batch_specs`` gives ``make_batch``'s
    shapes and dtypes as meta tensors, for it and a decoder-only model."""
    from repro_torch.config.registry import get_config
    from repro_torch.models import api
    cfg = dataclasses.replace(get_config("whisper-medium", smoke=True),
                              dtype="float32")
    params = api.init_model(cfg, device="cpu")
    assert set(params) == {"encoder", "decoder"}
    assert len(params["encoder"]["layers"]) == cfg.enc_num_layers
    assert api.decoder_params(params, cfg) is params["decoder"]
    batch = api.make_batch(0, cfg, 2, 8, device="cpu")
    loss = api.train_loss(params, batch, cfg)
    assert loss.ndim == 0 and torch.isfinite(loss)
    for c in (cfg, _tiny_port()[0]):
        specs = api.batch_specs(c, 2, 8)
        real = api.make_batch(0, c, 2, 8, device="cpu")
        assert specs["tokens"].shape == (2, 8) and specs["mask"].is_meta
        assert {k: (v.shape, v.dtype) for k, v in specs.items()} == \
            {k: (v.shape, v.dtype) for k, v in real.items()}
    assert api.batch_specs(cfg, 2, 8)["audio_feats"].shape == (
        2, cfg.enc_max_len, cfg.d_model)

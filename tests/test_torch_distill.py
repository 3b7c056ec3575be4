"""Drafter distillation and the study, held to the JAX package: the
objectives of ``core/losses.py``, the three drafter losses and one AdamW
step of ``training/distill.py``, the law of the port's draws, greedy
rollouts, pretraining, ``production_drafter`` and ``run_study``.

JAX's and torch's random streams cannot match, so every comparison feeds
both sides the same draws (JAX's ``start`` and ``l``, or the rows, starts
and prefixes the port's step drew), and the draws themselves are held to
their law. Everything is float32. Tolerances: losses rtol 1e-5; grads
``TOL_GRAD`` of each leaf's largest magnitude (as
``test_torch_recurrent.py``); params after a step as
``test_torch_train.py`` holds a step: the mean difference within 1e-3 of
the mean move, the largest within two steps of the learning rate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_drafter, tiny_target

from _torch_parity import (jax_drafter_init, jax_lm_init, np_tree,
                           port_drafter, port_drafter_cfg, port_lm,
                           port_model_cfg)
from repro.config import registry as jreg
from repro.config.base import OptimizerConfig as JOptimizerConfig
from repro.core import drafter as jdr
from repro.core import losses as jlosses
from repro.launch import steps as jsteps
from repro.optim import optimizers as jopt
from repro.training import distill as jdistill
from repro_torch.config import registry as treg
from repro_torch.core import losses as tlosses
from repro_torch.launch import steps as tsteps
from repro_torch.models import param as pm
from repro_torch.optim import optimizers as topt
from repro_torch.training import distill as tdistill
from repro_torch.training import run_study

TOL_GRAD = 2e-4     # grads, relative to each leaf's largest magnitude
VOCAB, GAMMA, B, S = 61, 6, 3, 24


def _jdcfg(causal=False):
    return tiny_drafter(vocab=VOCAB, gamma=GAMMA, dtype="float32",
                        num_kv_heads=1, causal=causal)


@pytest.fixture(scope="module")
def data():
    """JAX drafter weights (plain and causal), rollout-like tokens [B, S]
    and teacher features [B, S, Fd], from seeds."""
    rng = np.random.default_rng(0)
    jd = _jdcfg()
    return {
        "params": jax_drafter_init(jax.random.PRNGKey(1), jd),
        "params_ar": jax_drafter_init(jax.random.PRNGKey(2),
                                      _jdcfg(causal=True)),
        "tokens": rng.integers(0, VOCAB, (B, S)).astype(np.int32),
        "feats": rng.standard_normal((B, S, jd.target_feature_dim)
                                     ).astype(np.float32),
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _close_scaled(got, want, tol, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
        err_msg=err_msg)


def _port_value_and_grad(params, fn):
    flat = pm.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    try:
        out = fn(params)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, list(flat.values()))
    finally:
        for p in flat.values():
            p.requires_grad_(False)
    return out, dict(zip(flat, grads))


def _hold_grads(grads, jgrads):
    want = pm.flatten(port_drafter(jgrads))
    assert set(grads) == set(want)
    for path, g in grads.items():
        _close_scaled(g.numpy(), want[path].numpy(), TOL_GRAD, path)


def _jcache(p, jd, feats, start):
    """JAX's ``_feat_cache_from``, composed as its ``loss_fn`` does."""
    b, s = feats.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    fk, fv = jdr.project_features(p, jd, feats, pos)
    return {"k": fk, "v": fv, "length": start}


# ------------------------------------------------------------ block_loss --
# (tau, prefix_len): DFlash (anchor, decayed), VP (Eq. 6 prefixes, decayed
# and uniform), the AR chain (-1: every slot)
BLOCK_CASES = {"dflash": (8.0, (0, 0, 0)), "vp": (4.0, (0, 2, 4)),
               "vp_uniform": (None, (1, 3, 0)), "ar": (None, (-1, -1, -1))}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_loss_matches_jax(data, case):
    """Loss, per-slot ``nll`` and ``weights``, and the drafter grads
    (through the feature projection too) against ``jax.value_and_grad``."""
    tau, plen = BLOCK_CASES[case]
    jd = _jdcfg(causal=case == "ar")
    params = data["params_ar" if case == "ar" else "params"]
    tokens, feats = data["tokens"], data["feats"]
    start = np.array([1, 7, 17], np.int32)
    plen = np.array(plen, np.int32)
    idx = start[:, None] + np.arange(GAMMA)
    labels = np.take_along_axis(tokens, idx, 1)
    slot = np.arange(GAMMA)[None]
    blocks = np.where(slot <= plen[:, None], labels, jd.mask_token
                      ).astype(np.int32)

    def jloss(p):
        return jlosses.block_loss(p, jd, blocks, labels,
                                  _jcache(p, jd, feats, start), plen, tau,
                                  positions=idx)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    td = port_drafter_cfg(jd)

    def tloss(p):
        cache = tdistill.feat_cache_from(p, td, _t(feats), _t(start))
        return tlosses.block_loss(p, td, _t(blocks), _t(labels), cache,
                                  _t(plen), tau, positions=_t(idx))

    (loss, aux), grads = _port_value_and_grad(port_drafter(params), tloss)
    _close(loss.item(), jl)
    _close(aux["nll"].detach(), jaux["nll"])
    np.testing.assert_array_equal(aux["weights"].numpy(), jaux["weights"])
    _hold_grads(grads, jg)


# ----------------------------------------------------------- batch makers --
def test_batch_makers_match_jax_on_its_draws(data):
    """``make_dflash_batch`` and ``make_vp_batch``: the port's window and
    block functions on JAX's ``start`` and ``l`` give JAX's blocks and
    labels; the port's own makers draw in range and build alike."""
    tokens = data["tokens"]
    mask = _jdcfg().mask_token
    jb, jl, js = jlosses.make_dflash_batch(jax.random.PRNGKey(3), tokens,
                                           GAMMA, mask)
    labels = tlosses.window(_t(tokens), _t(js), GAMMA)
    np.testing.assert_array_equal(labels.numpy(), jl)
    np.testing.assert_array_equal(
        tlosses.dflash_blocks(labels, mask).numpy(), jb)
    vb, vl, vs, vlen = jlosses.make_vp_batch(jax.random.PRNGKey(4), tokens,
                                             GAMMA, mask, 0.8)
    labels = tlosses.window(_t(tokens), _t(vs), GAMMA)
    np.testing.assert_array_equal(labels.numpy(), vl)
    np.testing.assert_array_equal(
        tlosses.prefix_blocks(labels, _t(vlen), mask).numpy(), vb)

    gen = pm.make_generator(0, torch.device("cpu"))
    for _ in range(20):
        b, lab, st = tlosses.make_dflash_batch(gen, _t(tokens), GAMMA, mask)
        assert st.min() >= 0 and st.max() < S - GAMMA
        assert torch.equal(lab, tlosses.window(_t(tokens), st, GAMMA))
        assert torch.equal(b, tlosses.dflash_blocks(lab, mask))
        b, lab, st, ln = tlosses.make_vp_batch(gen, _t(tokens), GAMMA, mask,
                                               0.8)
        assert st.min() >= 0 and st.max() < S - GAMMA
        assert ln.min() >= 0 and ln.max() <= GAMMA - 2
        assert torch.equal(b, tlosses.prefix_blocks(lab, ln, mask))


# ---------------------------------------------------------- drafter loss --
def _jax_drafter_loss(jd, mode, tokens, feats, start, l):
    """JAX's ``train_drafter.loss_fn`` body on given draws, composed from
    ``project_features`` and ``block_loss``."""
    b = tokens.shape[0]
    idx = start[:, None] + np.arange(GAMMA)

    def loss(p):
        cache = _jcache(p, jd, feats, start)
        if mode == "ar":
            blocks = np.take_along_axis(tokens, idx, 1)
            labels = np.take_along_axis(tokens, idx + 1, 1)
            return jlosses.block_loss(p, jd, blocks, labels, cache,
                                      prefix_len=jnp.full((b,), -1),
                                      tau=None, positions=idx)[0]
        labels = np.take_along_axis(tokens, idx, 1)
        if mode == "vp":
            slot = np.arange(GAMMA)[None]
            blocks = np.where(slot <= l[:, None], labels, jd.mask_token)
            return jlosses.block_loss(p, jd, blocks.astype(np.int32), labels,
                                      cache, prefix_len=l, tau=4.0,
                                      positions=idx)[0]
        blocks = np.full_like(labels, jd.mask_token)
        blocks[:, 0] = labels[:, 0]
        return jlosses.block_loss(p, jd, blocks, labels, cache,
                                  prefix_len=jnp.zeros((b,), jnp.int32),
                                  tau=8.0, positions=idx)[0]
    return loss


@pytest.mark.parametrize("mode", ["dflash", "vp", "ar"])
def test_drafter_loss_matches_jax(data, mode):
    """``distill.drafter_loss`` in each mode on one set of draws: the loss
    and every drafter grad against JAX's ``loss_fn`` composition."""
    jd = _jdcfg(causal=mode == "ar")
    params = data["params_ar" if mode == "ar" else "params"]
    start = np.array([0, 9, S - GAMMA - 2], np.int32)
    l = np.array([3, 0, 4], np.int32) if mode == "vp" else None
    jl, jg = jax.jit(jax.value_and_grad(_jax_drafter_loss(
        jd, mode, data["tokens"], data["feats"], start, l)))(params)
    td = port_drafter_cfg(jd)
    loss, grads = _port_value_and_grad(
        port_drafter(params), lambda p: tdistill.drafter_loss(
            p, td, _t(data["tokens"]).long(), _t(data["feats"]), _t(start),
            None if l is None else _t(l), mode=mode))
    _close(loss.item(), jl)
    _hold_grads(grads, jg)


# ------------------------------------------------------------ one step ----
def test_train_drafter_step_matches_jax_adamw(data, monkeypatch):
    """One ``train_drafter`` step (VP) from JAX's initial weights, on the
    rows, starts and prefixes the port drew: the teacher's features, the
    loss, the grad norm, the params and the AdamW moments
    (``make_optimizer(hp)`` with no config: a moment a leaf, JAX's
    layout) against JAX's teacher and step on the same draws."""
    jd = _jdcfg()
    td = port_drafter_cfg(jd)
    jtcfg = tiny_target(vocab=VOCAB, dtype="float32", num_layers=3)
    tcfg = port_model_cfg(jtcfg)
    jtp = jax_lm_init(jax.random.PRNGKey(6), jtcfg)
    rollouts = data["tokens"]
    jp0 = data["params"]
    seen = {}

    monkeypatch.setattr(tdistill, "drafter_init",
                        lambda dcfg, seed, device: port_drafter(jp0))
    real_teacher = tdistill.make_teacher_fn

    def teacher_fn(*a, **k):
        fn = real_teacher(*a, **k)

        def teacher(tokens):
            seen["tokens"], seen["feats"] = tokens, fn(tokens)
            return seen["feats"]
        return teacher

    monkeypatch.setattr(tdistill, "make_teacher_fn", teacher_fn)
    real_draw = tdistill.draw_windows

    def draw(*a, **k):
        seen["draws"] = real_draw(*a, **k)
        return seen["draws"]

    monkeypatch.setattr(tdistill, "draw_windows", draw)
    real_make = topt.make_optimizer

    def make(hp, cfg=None):
        init, update = real_make(hp, cfg)

        def upd(g, s, p):
            out = update(g, s, p)
            seen["metrics"], seen["state"] = out[2], out[1]
            return out
        return init, upd

    monkeypatch.setattr(topt, "make_optimizer", make)
    params, losses = tdistill.train_drafter(
        td, port_lm(jtp, tcfg), tcfg, rollouts, vp=True, steps=1, batch=B,
        device="cpu", log=lambda *_: None)

    tokens = seen["tokens"].numpy().astype(np.int32)
    start, l = (x.numpy().astype(np.int32) for x in seen["draws"])
    feats = jdistill.make_teacher_fn(jtp, jtcfg)(tokens)
    _close(seen["feats"], feats, atol=1e-5)
    assert start.min() >= 1 and start.max() < S - GAMMA
    hp = JOptimizerConfig(lr=1e-3, total_steps=1, warmup_steps=20)
    jinit, jupdate = jopt.make_optimizer(hp)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(_jax_drafter_loss(
            jd, "vp", tokens, feats, start, l))(p)
        p2, o2, m = jupdate(g, o, p)
        return p2, o2, loss, m

    jp, jo, jloss, jm = jstep(jp0, jinit(jp0))
    _close(losses[0], jloss)
    _close(float(seen["metrics"]["grad_norm"]), jm["grad_norm"], rtol=1e-4)
    got, want = pm.flatten(params), pm.flatten(port_drafter(jp))
    init = pm.flatten(port_drafter(jp0))
    diff = sum(float((got[k] - want[k]).abs().sum()) for k in got)
    move = sum(float((want[k] - init[k]).abs().sum()) for k in got)
    worst = max(float((got[k] - want[k]).abs().max()) for k in got)
    assert diff <= 1e-3 * move, (diff, move)
    assert worst <= 2 * float(seen["metrics"]["lr"]), worst
    for key in ("m", "v"):
        tm = pm.flatten(seen["state"][key])
        jm_ = pm.flatten(port_drafter(np_tree(jo[key])))
        assert set(tm) == set(jm_)
        for path, t in tm.items():
            w = jm_[path].numpy()
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)


# ---------------------------------------------------------------- draws ---
def test_draws_follow_their_law():
    """Eq. 6's prefix lengths: each frequency within 4 sigma of
    beta^j / sum; the starts of each mode fill their range exactly (AR
    [0, S-g-1), DFlash and VP [1, S-g)), as JAX draws them."""
    gen = pm.make_generator(5, torch.device("cpu"))
    n, beta, g = 40000, 0.8, 8
    l = tlosses.sample_prefix_geometric(gen, n, g, beta).numpy()
    p = beta ** np.arange(g - 1)
    p /= p.sum()
    counts = np.bincount(l, minlength=g - 1)
    assert counts.size == g - 1
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 4 * sigma), (counts, n * p)
    for mode, lo, hi in (("ar", 0, S - g - 1), ("dflash", 1, S - g),
                         ("vp", 1, S - g)):
        start, ln = tdistill.draw_windows(gen, mode, 4000, S, g, beta)
        assert (int(start.min()), int(start.max())) == (lo, hi - 1), mode
        assert (ln is not None) == (mode == "vp")


# -------------------------------------------------------------- rollouts --
def test_generate_rollouts_match_jax():
    """Greedy rollouts of a tiny target: the port's tokens, the prompt
    and the trailing token included, equal JAX's."""
    jcfg = tiny_target(vocab=VOCAB, dtype="float32", num_layers=2)
    jparams = jax_lm_init(jax.random.PRNGKey(4), jcfg)
    prompts = np.random.default_rng(1).integers(0, VOCAB, (3, 9)
                                                ).astype(np.int32)
    want = jdistill.generate_rollouts(jparams, jcfg, prompts, 12,
                                      log=lambda *_: None)
    got = tdistill.generate_rollouts(port_lm(jparams, port_model_cfg(jcfg)),
                                     port_model_cfg(jcfg), prompts, 12,
                                     device="cpu")
    assert got.shape == (3, 9 + 12 + 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- pretrain --
def test_pretrain_target_matches_jax(monkeypatch):
    """Three ``pretrain_target`` steps from JAX's seed-0 weights (carried
    across by patching ``lm_init``): every loss, and the params after the
    last step."""
    jcfg = tiny_target(vocab=VOCAB, dtype="float32", num_layers=2)
    tcfg = port_model_cfg(jcfg)
    jp0 = jax_lm_init(jax.random.PRNGKey(0), jcfg)
    kw = dict(steps=3, batch=2, seq_len=32, seed=0, log=lambda *_: None)
    jp, jm = jdistill.pretrain_target(jcfg, **kw)
    monkeypatch.setattr(tdistill.lm, "lm_init",
                        lambda cfg, seed, device: port_lm(jp0, tcfg))
    params, metrics = tdistill.pretrain_target(tcfg, device="cpu", **kw)
    _close([m["loss"] for m in metrics], [m["loss"] for m in jm])
    got = pm.flatten(params)
    want = pm.flatten(port_lm(jp, tcfg))
    init = pm.flatten(port_lm(jp0, tcfg))
    diff = sum(float((got[k] - want[k]).abs().sum()) for k in got)
    move = sum(float((want[k] - init[k]).abs().sum()) for k in got)
    assert diff <= 1e-3 * move, (diff, move)


# ---------------------------------------------------- production drafter --
@pytest.mark.parametrize("arch", jreg.all_archs() + ("paper-target",))
def test_production_drafter_matches_jax(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for gamma, causal in ((jsteps.GAMMA_PROD, False), (8, True)):
        want = dataclasses.asdict(jsteps.production_drafter(
            jcfg, gamma=gamma, causal=causal))
        got = dataclasses.asdict(tsteps.production_drafter(
            tcfg, gamma=gamma, causal=causal))
        assert got == want
    assert (tsteps.GAMMA_PROD, tsteps.K_PROD) == (jsteps.GAMMA_PROD,
                                                  jsteps.K_PROD)


# ----------------------------------------------------------------- study --
def test_run_study_saves_and_load_study_restores(tmp_path, monkeypatch):
    """``run_study.main`` at tiny flags into a temporary ``STUDY_DIR``:
    its record (losses of every stage, seconds, ``meta.json``), and
    ``load_study`` giving back exactly the params it saved."""
    saved = {}

    class Recording(run_study.Checkpointer):
        def save(self, step, tree, extra=None):
            saved.update({k: v.clone() for k, v in
                          pm.flatten(tree).items()})
            super().save(step, tree, extra=extra)

    monkeypatch.setattr(run_study, "STUDY_DIR", tmp_path)
    monkeypatch.setattr(run_study, "Checkpointer", Recording)
    rec = run_study.main(["--target-steps", "2", "--drafter-steps", "2",
                          "--rollouts-per-task", "1", "--rollout-new", "6",
                          "--gamma", "4", "--device", "cpu"])
    assert rec["rollouts"] == [3, 32 + 6 + 1]
    assert len(rec["target_losses"]) == 2
    assert {k: len(v) for k, v in rec["drafter_losses"].items()} == {
        "dflash": 2, "vp": 2, "ar": 2}
    assert set(rec["seconds"]) == {"pretrain", "rollouts", "dflash", "vp",
                                   "ar", "save"}
    tcfg, dcfg, dcfg_ar, params, meta = run_study.load_study("cpu")
    assert (dcfg.gamma, dcfg_ar.gamma, dcfg_ar.causal) == (4, 4, True)
    assert meta["gamma"] == 4 and meta["drafter_steps"] == 2
    flat = pm.flatten(params)
    assert set(flat) == set(saved)
    for k, v in flat.items():
        assert torch.equal(v, saved[k]), k

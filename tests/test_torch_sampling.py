"""Sampled decoding (temperature > 0) in the port.

* ``sampling_verify_core`` fed JAX's own random numbers (the uniforms of
  ``jax.random.split(key, D*C+1)`` and the bonus's Gumbel noise) gives
  JAX ``sampling_verify``'s best node, acceptance count, path, accepted
  nodes and bonus exactly, on chain, comb and third-level trees;
* lossless: one ``decode_cycle`` over 2000 copies of one prompt (each row
  its own draws) commits a first token distributed as the target's
  softmax at the temperature, for every mode (``test_lossless.py``'s
  check, batched: V 13, TV below max(0.06, 2.5 sqrt(V/4n));
  ``chip_smoke.py::first_token_tv``);
* the random stream: ``generate`` and the eager ``OnDeviceLoop`` of
  ``generate_ondevice`` consume one generator in the same order, so they
  are token-identical for one seed, and another seed draws other tokens.

float32, tiny shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from repro.core import tree as jtree
from repro.core import verify as jver
from repro_torch.core import pipeline as tpl
from repro_torch.core import tree as ttree
from repro_torch.core import verify as tver
from repro_torch.models import param as pm
from test_torch_modes import _third_inputs, bundle_for
from test_torch_pipeline import GAMMA, MAX_NEW, VOCAB, _chip_smoke, _prompts


# ------------------------------------------------- verify on JAX's draws --
def _verify_inputs(kind, seed):
    """(JAX tree, port tree, target logits, q, max_children): the tree's
    tokens made likely under the target at their parents, so paths run
    deep and every rule (accept, reject into the residual, the next
    sibling) is taken."""
    rng = np.random.default_rng(seed)
    anchor, trunk, branch, third, fork, fork3 = _third_inputs(seed, b=8)
    g, k = GAMMA, fork.shape[1]
    if kind == "chain":
        jt_ = jtree.chain_tree(jnp.asarray(anchor), jnp.asarray(trunk))
        tt_ = ttree.chain_tree(t(anchor), t(trunk))
        c = 1
    else:
        jt_ = jtree.comb_tree(*map(jnp.asarray, (anchor, trunk, branch,
                                                 fork)), g)
        tt_ = ttree.comb_tree(t(anchor), t(trunk), t(branch), t(fork), g)
        c = k + 1
        if kind == "third":
            jt_ = jtree.extend_third_level(jt_, jnp.asarray(third),
                                           jnp.asarray(fork),
                                           jnp.asarray(fork3), g)
            tt_ = ttree.extend_third_level(tt_, t(third), t(fork), t(fork3),
                                           g)
            c += 1
    tok = np.asarray(jt_.tokens)
    par = np.asarray(jt_.parent)
    valid = np.asarray(jt_.valid)
    b, n = tok.shape
    logits = rng.standard_normal((b, n, VOCAB)).astype(np.float32)
    qlog = rng.standard_normal((b, n, VOCAB)).astype(np.float32)
    rows, nodes = np.nonzero(valid & (par >= 0))
    boost = rng.random(rows.size) < 0.7
    logits[rows[boost], par[rows[boost], nodes[boost]],
           tok[rows[boost], nodes[boost]]] += 4.0
    qlog[rows, nodes, tok[rows, nodes]] += 2.0
    logits = np.where(valid[:, :, None], logits, -1e9).astype(np.float32)
    q = np.asarray(jax.nn.softmax(jnp.asarray(qlog), -1))
    return jt_, tt_, logits, q, c


@pytest.mark.parametrize("temp", [1.0, 0.7])
@pytest.mark.parametrize("kind", ["chain", "comb", "third"])
def test_sampling_verify_core_matches_jax_on_its_draws(kind, temp):
    jt_, tt_, logits, q, c = _verify_inputs(kind, {"chain": 30, "comb": 31,
                                                   "third": 32}[kind])
    key = jax.random.PRNGKey(5)
    want = jver.sampling_verify(jt_, jnp.asarray(logits), jnp.asarray(q),
                                key, max_children=c, temperature=temp)
    d = jt_.max_depth
    keys = jax.random.split(key, d * c + 1)
    b = logits.shape[0]
    u = np.stack([np.asarray(jax.random.uniform(keys[i], (b,)))
                  for i in range(d * c)])
    noise = np.asarray(jax.random.gumbel(keys[d * c], (b, VOCAB)))
    got = tver.sampling_verify_core(tt_, t(logits), t(q), t(u), t(noise),
                                    c, temp)
    for name in ("best", "n_acc", "path", "bonus", "accepted", "ok"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    n_acc = got["n_acc"].numpy()
    assert n_acc.max() >= 2 and (n_acc < d).any()
    if kind != "chain":                   # some path leaves the trunk
        assert (got["best"].numpy() >= GAMMA).any()


def test_sampling_verify_draws_on_the_generator():
    """The drawing wrapper: one [D*C, B] uniform draw, then the bonus's
    noise, on the generator passed; the same seed draws the same."""
    _, tt_, logits, q, c = _verify_inputs("comb", 33)
    outs = []
    for seed in (3, 3, 4):
        gen = pm.make_generator(seed, torch.device("cpu"))
        outs.append(tver.sampling_verify(tt_, t(logits), t(q), gen, c))
        u, noise = tver.sampling_draws(pm.make_generator(seed, gen.device),
                                       tt_, VOCAB, c)
        assert u.shape == (tt_.max_depth * c, tt_.b)
        assert noise.shape == (tt_.b, VOCAB)
        want = tver.sampling_verify_core(tt_, t(logits), t(q), u, noise, c)
        for name in ("path", "bonus"):
            assert torch.equal(outs[-1][name], want[name])
    assert torch.equal(outs[0]["bonus"], outs[1]["bonus"])
    assert not torch.equal(outs[0]["bonus"], outs[2]["bonus"])


# ------------------------------------------------------------ lossless ---
@pytest.mark.parametrize("mode,third,temp", [
    ("d2sd", False, 1.0), ("d2sd", True, 1.0), ("naive_k", False, 1.0),
    ("naive_k", False, 0.5), ("eagle", False, 1.0), ("dflash", False, 1.0)])
def test_sampling_is_lossless_distribution_batched(mode, third, temp):
    """``chip_smoke.py``'s check (the card runs it through the kernels) on
    the CPU: ``test_lossless.py``'s sampling model with the port's seeded
    weights."""
    smoke = _chip_smoke()
    assert (mode, third, temp) in smoke.LOSSLESS_MODES
    tv, bound = smoke.first_token_tv(
        smoke.lossless_bundle(mode, third, temp, device="cpu"),
        device="cpu")
    assert tv < bound, (tv, bound)


# ------------------------------------------------------ the random stream --
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("name", ["d2sd", "third_level", "naive_k", "eagle"])
def test_sampled_loops_draw_alike(name, cache_impl):
    """At temperature 1: ``generate`` and the eager on-device loop give
    the same tokens, cycles and alpha for one seed; another seed gives
    other tokens."""
    bundle = bundle_for(name, "kernel", temperature=1.0)
    kw = dict(cache_impl=cache_impl, page_size=8, device="cpu")
    host = tpl.generate(bundle, _prompts(), MAX_NEW, seed=5, **kw)
    loop = tpl.generate_ondevice(bundle, _prompts(), MAX_NEW, seed=5, **kw)
    other = tpl.generate(bundle, _prompts(), MAX_NEW, seed=6, **kw)
    np.testing.assert_array_equal(loop["tokens"], host["tokens"])
    assert (loop["n_cycles"], loop["alpha"]) == (host["n_cycles"],
                                                 host["alpha"])
    assert (other["tokens"] != host["tokens"]).any()
    toks = host["tokens"]
    assert toks.min() >= 0 and toks.max() < VOCAB

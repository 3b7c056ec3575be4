"""Every architecture of the JAX package's registry, in the port.

The registry resolves every id of JAX's ``ARCH_IDS`` and ``paper-target``
to configs equal field by field to JAX's (smoke and full), and raises
``KeyError`` where JAX's does (``paper-drafter``, an unknown id);
``param_count()`` of every full config equals JAX's and lies in the
bands of ``tests/test_arch_smoke.py``; and the mirror of
``tests/test_arch_smoke.py::test_arch_smoke`` over every id: the smoke
config's param tree has the shapes of JAX's (``jax.eval_shape`` of its
``init_model``), and one forward and backward of ``api.train_loss``
(fp32, weights drawn from a numpy seed in JAX's tree and carried across
by ``repro_torch.convert``, JAX's batch) gives JAX's loss within 1e-5
(relative) and its grads within ``TOL_GRAD`` of each leaf's largest
magnitude, finite, with a nonzero norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_tree, port_model_cfg, t
from repro.config import registry as jreg
from repro.models import api as japi
from repro_torch import convert
from repro_torch.config import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.models import param as pm

IDS = ("paper-target",) + jreg.ARCH_IDS
# grads, relative to a leaf's largest magnitude: the two packages differ
# only in summation order, and JAX's own fp32 grads lie up to 8.7e-5 of
# that from a float64 run of the same loss (rwkv6's ``u``, whose
# gradient passes a per-head group norm)
TOL_GRAD = 2e-4

# JAX's bands (tests/test_arch_smoke.py::test_arch_full_config_shape)
BANDS = {
    "qwen2.5-3b": (2e9, 5e9),
    "internlm2-20b": (15e9, 25e9),
    "gemma2-2b": (1.5e9, 4e9),
    "stablelm-3b": (2e9, 4.5e9),
    "recurrentgemma-2b": (2e9, 4.5e9),
    "kimi-k2-1t-a32b": (0.7e12, 1.4e12),
    "grok-1-314b": (2.4e11, 3.9e11),
    "llama-3.2-vision-11b": (8e9, 14e9),
    "whisper-medium": (2.4e8, 1.2e9),
    "rwkv6-1.6b": (1.2e9, 2.4e9),
}


def test_registry_resolves_every_jax_id():
    assert treg.all_archs() == jreg.all_archs()
    for bad in ("paper-drafter", "no-such-arch"):
        with pytest.raises(KeyError):
            jreg.get_config(bad)
        with pytest.raises(KeyError):
            treg.get_config(bad)


@pytest.mark.parametrize("arch", IDS)
def test_configs_and_param_count_match_jax(arch):
    for smoke in (False, True):
        jc = jreg.get_config(arch, smoke=smoke)
        tc = treg.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(tc) == dataclasses.asdict(
            port_model_cfg(jc))
        tblocks.check_supported(tc)
        assert tc.param_count() == jc.param_count()
    if arch in BANDS:
        lo, hi = BANDS[arch]
        assert lo < treg.get_config(arch).param_count() < hi


def _convert(tree, cfg):
    conv = (convert.convert_encdec if cfg.is_encoder_decoder
            else convert.convert_lm)
    return conv(np_tree(tree), cfg, device="cpu")


def _np_weights(tree, seed):
    """Weights in the shapes and dtypes of ``tree`` (JAX's, abstract),
    drawn from a numpy seed: the norms' gains (``scale``, ``ln_x``) 1 +
    N(0, 0.1^2), every other leaf N(0, 0.1^2). No JAX init is compiled."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        w = 0.1 * rng.standard_normal(leaf.shape)
        if getattr(path[-1], "key", None) in ("scale", "ln_x"):
            w += 1.0
        return jnp.asarray(w, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_arch_smoke(arch):
    jcfg = dataclasses.replace(jreg.get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = port_model_cfg(jcfg)
    jp = _np_weights(jax.eval_shape(lambda k: japi.init_model(k, jcfg),
                                    jax.random.PRNGKey(0)), 0)
    shapes = lambda tree: {k: tuple(v.shape)  # noqa: E731
                           for k, v in pm.flatten(tree).items()}
    assert shapes(tapi.init_model(tcfg, device="cpu")) == \
        shapes(_convert(jp, tcfg))
    jb = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
          else np.asarray(v)
          for k, v in japi.make_batch(jax.random.PRNGKey(1), jcfg, 2,
                                      16).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.train_loss(p, b, jcfg)))(jp, jb)
    tp = _convert(jp, tcfg)
    flat = pm.flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    tl = tapi.train_loss(tp, {k: t(v) for k, v in jb.items()}, tcfg)
    tg = dict(zip(flat, torch.autograd.grad(tl, list(flat.values()))))
    tl = float(tl.detach())
    assert np.isfinite(tl) and abs(tl - float(loss)) <= 1e-5 * abs(tl)
    ref = pm.flatten(_convert(grads, tcfg))
    assert set(ref) == set(tg)
    for path, g in tg.items():
        want = ref[path].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=TOL_GRAD * scale, err_msg=path)
    gn = torch.sqrt(sum(g.square().sum() for g in tg.values()))
    assert torch.isfinite(gn) and float(gn) > 0

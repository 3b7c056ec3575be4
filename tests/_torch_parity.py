"""Helpers for the tests that hold the PyTorch port (``repro_torch``) to
the JAX package: configs carried across field by field, params carried
across as numpy through ``repro_torch.convert``, arrays handed over as
numpy. Not a test module (no ``test_`` prefix)."""
import dataclasses

import jax
import numpy as np
import torch

from repro.core import drafter as jdr
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.config import base as tbase
from repro_torch.core import drafter as tdr

ATOL = 1e-5

# The port's CPU tests move tiny tensors, so torch runs them on one
# thread: pytest's workers, one a core, would otherwise each start a
# thread a core, and those threads spin against each other.
torch.set_num_threads(1)

# The JAX functions compiled once per config: the same values as the
# eager calls, in a fraction of the CPU time.
jax_lm_init = jax.jit(jlm.lm_init, static_argnums=1)
jax_drafter_init = jax.jit(jdr.drafter_init, static_argnums=1)
jax_lm_forward = jax.jit(jlm.forward, static_argnums=2, static_argnames=(
    "write_kv", "want_features", "remat", "attend_cache_on_write"))
jax_extend_feat_cache = jax.jit(jdr.extend_feat_cache, static_argnums=1)
jax_drafter_forward = jax.jit(jdr.drafter_forward, static_argnums=1)


def t(x):
    """numpy/JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def _fields(jcfg, **over):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    impl = kw.get("attn_impl")
    kw["attn_impl"] = "kernel" if impl == "pallas" else "gather"
    kw.update(over)
    return kw


def port_model_cfg(jcfg, **over):
    """The port's ModelConfig with the JAX config's values; the read path
    ``pallas`` maps to ``kernel``."""
    kw = _fields(jcfg, **over)
    kw["family"] = tbase.Family(jcfg.family.value)
    assert jcfg.moe is None
    return tbase.ModelConfig(**kw)


def port_drafter_cfg(jdcfg, **over):
    return tdr.DrafterConfig(**_fields(jdcfg, **over))


def port_lm(jparams, tcfg):
    return convert.convert_lm(np_tree(jparams), tcfg, device="cpu")


def port_drafter(jparams):
    return convert.convert_drafter(np_tree(jparams), device="cpu")


def close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)

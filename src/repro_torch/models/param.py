"""Parameter initializers (twin of ``repro/models/param.py``).

Params are plain nested dicts of tensors. Random values come from the
``torch.Generator`` the caller passes, made on the tensors' device, so a
full-width model is drawn on the card without a host round trip. The
stream differs from JAX's for the same seed: tests that compare the two
packages carry weights across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as sh


def trunc_normal(gen: torch.Generator, shape, dtype=torch.float32,
                 stddev=0.02):
    """Normal(0, stddev) truncated at two standard deviations."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, std=stddev, a=-2.0 * stddev,
                                b=2.0 * stddev, generator=gen)
    return t.to(dtype)


def dense_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32,
               scale=None):
    """[d_in, d_out] weight: ``dense(w, x)`` computes ``x @ w``."""
    stddev = scale if scale is not None else (1.0 / (d_in ** 0.5))
    return trunc_normal(gen, (d_in, d_out), dtype, stddev)


def zeros(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, device, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=device)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: an init run with
    it makes tensors of the right shapes and no values (JAX's
    ``jax.eval_shape`` of an init)."""

    @property
    def device(self):
        return torch.device("meta")


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    if torch.device(device).type == "meta":
        return _MetaGenerator()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# ------------------------------------------------------------ sampling ----
# The decode engine's random draws. Each is one fixed-shape ``torch.rand``
# on ``gen``: no host read and no data-dependent size, so a CUDA graph can
# capture it. A graph must register ``gen``
# (``CUDAGraph.register_generator_state``) for each replay to draw fresh
# numbers.
def uniform(gen: torch.Generator, shape, dim: int = 0) -> torch.Tensor:
    """Uniform [0, 1) float32 numbers of ``shape``, whose axis ``dim``
    runs over a batch's rows. Inside ``sharding.row_subset`` (a rank that
    computes some rows of a batch) the draw takes every row's numbers and
    keeps this rank's, so each row gets what a meshless run draws for
    it."""
    rows = sh.active_rows()
    if rows is None:
        return torch.rand(shape, generator=gen, device=gen.device)
    total, keep = rows
    assert shape[dim] == len(keep), (tuple(shape), dim, len(keep))
    full = list(shape)
    full[dim] = total
    u = torch.rand(full, generator=gen, device=gen.device)
    return u.index_select(dim, torch.tensor(keep, dtype=torch.long,
                                            device=gen.device))


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, float32: -log(-log(u)) with u uniform in
    [tiny, 1), as ``jax.random.gumbel`` draws it; axis 0 runs over rows
    (:func:`uniform`)."""
    u = uniform(gen, shape)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def categorical(gen: torch.Generator, logits) -> torch.Tensor:
    """One draw from softmax(logits) over the last axis for every leading
    index (Gumbel-max, as ``jax.random.categorical``). ``logits`` may be a
    broadcast view: each of its rows gets noise of its own."""
    return torch.argmax(logits.float() + gumbel(gen, logits.shape), dim=-1)


# ------------------------------------------------------------ trees -------
# Param trees are nested dicts (and the ``layers`` list) of tensors. These
# helpers walk them in a fixed order: dict keys sorted, as jax.tree does,
# list entries by index.
def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree, prefix: str = ""):
    """{"/"-joined path: leaf} in tree order."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def tree_map(fn, tree):
    """The tree's structure with ``fn(leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def get_path(tree, path: str):
    for k in path.split("/") if path else ():
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def unflatten_like(tree, flat):
    """``tree``'s structure with the leaves of ``flat`` ({path: leaf})."""
    return _build(tree, "", flat)


def _build(node, prefix, flat):
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle, which would keep ``flat`` (gathered
    # weights, say) alive until the garbage collector runs
    kids = _children(node)
    if kids is None:
        return flat[prefix]
    vals = {k: _build(v, f"{prefix}/{k}" if prefix else k, flat)
            for k, v in kids}
    if isinstance(node, dict):
        return {k: vals[str(k)] for k in node}
    return type(node)(vals[str(i)] for i in range(len(node)))

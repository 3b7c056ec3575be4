"""Parameter initializers (twin of ``repro/models/param.py``).

Params are plain nested dicts of tensors. Random values come from the
``torch.Generator`` the caller passes, made on the tensors' device, so a
full-width model is drawn on the card without a host round trip. The
stream differs from JAX's for the same seed: tests that compare the two
packages carry weights across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import torch


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


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen

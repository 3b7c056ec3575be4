"""Inputs of ``tests/test_torch_data.py`` (not a test module): numpy
only, drawn from numpy seeds, shared by the JAX references
(``_torch_data_jax.py``) and the port's ranks (``_torch_data_ranks.py``).
The engine's two-phase workload is ``_torch_sharded_inputs``'s."""
import numpy as np

VOCAB, PAGE = 61, 8
GEN_NEW = 16        # new tokens a row of the dense ``generate`` cases


def generate_prompts():
    """Four rows of 12 tokens: a row a batch rank at pod 2 x data 2."""
    return np.random.default_rng(4).integers(3, VOCAB, (4, 12)).astype(
        np.int32)

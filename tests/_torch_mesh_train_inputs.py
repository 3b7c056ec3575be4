"""Inputs of ``tests/test_torch_mesh_train.py`` (not a test module): the
step cases, their batches and the pipeline's arrays, from numpy seeds.
Imports numpy only, so both the JAX references and the port's ranks
load it."""
import numpy as np

#: the model of ``tests/test_distributed.py:73`` (its ModelConfig fields)
MODEL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=512, max_seq_len=64, dtype="float32")
HP = dict(lr=1e-3, total_steps=10)
B, T = 8, 32
STEPS = 2
#: step case -> (data, model, fsdp, uneven masks); JAX's sharded step
#: runs each, the port's ranks too (the (2, 4) cases with remat on)
CASES = {"2x4_fsdp": (2, 4, True, False),
         "2x4_fsdp_uneven": (2, 4, True, True),
         "2x2": (2, 2, False, False),
         "2x4_fsdp_adamw8bit": (2, 4, True, False),
         "2x2_adamw8bit": (2, 2, False, False),
         "2x4_fsdp_adafactor": (2, 4, True, False),
         "2x2_adafactor": (2, 2, False, False)}
#: the optimizers; a case's is the one its name ends in, else AdamW
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")


def optimizer(case: str) -> str:
    return next((o for o in OPTIMIZERS[1:] if case.endswith(o)), "adamw")


def hp(case: str) -> dict:
    """The case's optimizer hyperparameters (``OptimizerConfig`` fields)."""
    return dict(HP, name=optimizer(case))
#: loss_seq_chunk of the chunked case on the (2, 2) mesh
CHUNK = 8
#: each row's mask length in the uneven cases: data rank 0 holds rows
#: 0-3 (65 tokens), data rank 1 rows 4-7 (108)
UNEVEN = (32, 3, 20, 10, 32, 31, 13, 32)
#: the pipeline of ``tests/test_distributed.py:174``
S, M, MB, D = 4, 6, 3, 16


def batch(uneven: bool):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, MODEL["vocab_size"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    if uneven:
        for i, n in enumerate(UNEVEN):
            mask[i, n:] = 0.0
    return {"tokens": toks, "labels": np.roll(toks, -1, 1), "mask": mask}


def pipeline_inputs():
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, xs

#: the dry run's small serving cells (a decode and a prefill cell of a
#: dense bf16 target on the (2, 2) mesh): the model, the rows and prompt
#: length of the cell's shape, gamma and the branches of its spec
SERVE_MODEL = dict(MODEL, dtype="bfloat16")
SERVE_B, SERVE_T, SERVE_GAMMA, SERVE_K = 4, 64, 4, 2
SERVE_KINDS = ("decode", "prefill")

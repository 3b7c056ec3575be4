"""Inputs of ``tests/test_torch_ep.py`` (not a test module): numpy only,
drawn from numpy seeds, shared by the JAX references (``_torch_ep_jax.py``)
and the port's ranks (``_torch_ep_ranks.py``)."""
import numpy as np

VOCAB, GAMMA, PAGE = 61, 4, 8
D_MODEL, D_FF = 64, 128
# the meshes (data, model): the experts axis is "model"
MESHES = ((1, 2), (1, 4), (2, 2))
# one MoE layer: (name, experts, top_k, gated, shared experts, capacity
# factor, B, T, skewed, dtype). "skew" adds 1.0 to the router's column 0
# and 0.5 to x, so that every token picks expert 0 and the capacity binds.
# e2 at (1, 4) and e1 everywhere split each expert's d_ff over ranks
# (M % E == 0); e2_plain's 7 tokens do not divide over data 2, so each
# data rank computes all of them; e4_t1 has one token a data rank at
# (2, 2): capacity 8. The bf16 cases run x and the experts' products in
# bfloat16 (fp32 stacks cast, as both packages do), both regimes.
LAYER_CASES = (
    ("e4_gated_skew", 4, 2, True, 0, 1.25, 2, 8, True, "float32"),
    ("e4_plain_shared", 4, 2, False, 1, 1.25, 2, 8, True, "float32"),
    ("e4_t1", 4, 2, True, 0, 1.25, 2, 1, False, "float32"),
    ("e2_gated_shared", 2, 1, True, 1, 1.25, 2, 8, True, "float32"),
    ("e2_plain", 2, 1, False, 0, 1.25, 1, 7, False, "float32"),
    ("e1_gated", 1, 1, True, 0, 0.5, 2, 8, False, "float32"),
    ("e4_gated_skew_bf16", 4, 2, True, 1, 1.25, 2, 8, True, "bfloat16"),
    ("e2_gated_bf16", 2, 1, True, 0, 1.25, 2, 8, False, "bfloat16"),
)
# the gradient cases, inside (1, 2) and (1, 4): both regimes
GRAD_CASES = ("e4_gated_skew", "e4_plain_shared", "e2_gated_shared",
              "e1_gated")
CASE = {c[0]: c for c in LAYER_CASES}
# the compressed all-reduce: data 4, tests/test_distributed.py's input at
# 4 ranks (1000 values a rank: a padded last block)
CGRAD_RANKS, CGRAD_N = 4, 1000


def layer_config_kw(name):
    """ModelConfig fields of a layer case (both packages' configs take
    them; ``moe`` as MoEConfig fields)."""
    _, e, k, gated, shared, cf, _, _, _, dtype = CASE[name]
    return dict(num_layers=1, d_model=D_MODEL, num_heads=4, num_kv_heads=2,
                d_ff=D_FF, vocab_size=97, max_seq_len=64, remat=False,
                dtype=dtype, mlp_gated=gated), dict(
        num_experts=e, top_k=k, capacity_factor=cf, dispatch="scatter",
        num_shared_experts=shared)


def layer_x(i, name):
    """Case ``i``'s input [B, T, d] (fp32: the bf16 cases' x is its cast)
    and the weights of its gradient's sum (``sum(moe_apply(p, x) *
    w)``)."""
    _, _, _, _, _, _, b, t, skew, _ = CASE[name]
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal((b, t, D_MODEL)).astype(np.float32)
    w = rng.standard_normal((b, t, D_MODEL)).astype(np.float32)
    return (x + 0.5 if skew else x).astype(np.float32), w


def skew_params(name, p):
    """The case's params (numpy tree): the router's column 0 raised."""
    if CASE[name][8]:
        p = dict(p, router=p["router"].copy())
        p["router"][:, 0] += 1.0
    return p


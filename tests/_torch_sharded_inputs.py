"""Inputs of ``tests/test_torch_sharded.py`` (not a test module): numpy
only, drawn from numpy seeds, shared by the JAX references
(``_torch_sharded_jax.py``) and the port's ranks
(``_torch_sharded_ranks.py``)."""
import numpy as np

VOCAB, GAMMA, PAGE = 61, 4, 8
SENTINEL = int(np.iinfo(np.int32).max)        # kvcache.PAGE_SENTINEL
B, TQ, HQ, HKV, S, D = 2, 6, 4, 2, 64, 16
# sharded_cache_attend cases: (name, rolling, window, softcap)
DENSE_CASES = (("plain", False, None, None),
               ("rolling_window", True, 24, None),
               ("window_softcap", False, 20, 30.0))
# the smallest input on which a bfloat16 merge strays by more than 1e-4
# from the meshless read (ROADMAP.md queue 3, reference quirks): one row,
# one query, one head of width one, one key a rank at P = 2 and a block
# of one key, every score 0; each rank's payload acc = 0.3 travels as
# 0.30078125
QUIRK = dict(q=[[[[1.0]]]], k=[[[[0.0]], [[0.0]]]], v=[[[[0.3]], [[0.3]]]],
             bk=[[[[0.0]]]], bv=[[[[0.1]]]], cache_len=[2], q_abs=[[2]])


def engine_requests():
    """The two-phase workload of ``tests/test_sharded_serving.py``: a
    system prompt, a wave turnover, phase-2 prompts re-sending phase-1
    ones so the radix hits cross the turnover. ([(prompt, max_new)] x 2)"""
    rng = np.random.default_rng(0)
    sysp = rng.integers(3, VOCAB, size=11).astype(np.int32)
    phase1 = []
    for i in range(4):
        tail = rng.integers(3, VOCAB, size=3 + 2 * i).astype(np.int32)
        phase1.append((np.concatenate([sysp, tail]), 3 + (i % 3)))
    phase2 = [(p, n) for p, n in phase1[:2]]
    for i in range(2):
        phase2.append((rng.integers(3, VOCAB, size=6 + 5 * i)
                       .astype(np.int32), 4))
    return phase1, phase2


def _dense():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cache_len = np.array([50, 30], np.int32)
    return dict(q=f(B, TQ, HQ, D), ck=f(B, S, HKV, D), cv=f(B, S, HKV, D),
                bk=f(B, TQ, HKV, D), bv=f(B, TQ, HKV, D), cache_len=cache_len,
                q_abs=(cache_len[:, None] + np.arange(TQ)).astype(np.int32),
                mask=np.tril(np.ones((TQ, TQ), bool)))


def _paged():
    """A shuffled page table with sentinel tails and ragged lengths."""
    rng = np.random.default_rng(8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n_pages, mp = 13, 5
    lens = np.array([37, 12, 25], np.int32)
    table = np.full((3, mp), SENTINEL, np.int32)
    perm = rng.permutation(n_pages)
    at = 0
    for i, n in enumerate(lens):
        k = -(-int(n) // PAGE)
        table[i, :k] = perm[at:at + k]
        at += k
    return dict(q=f(3, TQ, HQ, D), pk=f(n_pages, PAGE, HKV, D),
                pv=f(n_pages, PAGE, HKV, D), table=table,
                bk=f(3, TQ, HKV, D), bv=f(3, TQ, HKV, D), cache_len=lens,
                q_abs=(lens[:, None] + np.arange(TQ)).astype(np.int32),
                mask=np.tril(np.ones((TQ, TQ), bool)))


def inputs(feature_dim):
    """Every input by key ("dense/q", "paged/table", "drafter/feats", ...;
    ``feature_dim``: the drafter's target feature width)."""
    x = {f"dense/{k}": v for k, v in _dense().items()}
    x.update({f"paged/{k}": v for k, v in _paged().items()})
    x.update({f"quirk/{k}": np.asarray(
        v, np.int32 if k in ("cache_len", "q_abs") else np.float32)
        for k, v in QUIRK.items()})
    rng = np.random.default_rng(0)
    x["drafter/feats"] = rng.standard_normal((2, 13, feature_dim)).astype(
        np.float32)
    x["drafter/n_new"] = np.array([13, 9], np.int32)   # ragged, straddling
    x["drafter/anchor"] = np.array([5, 7], np.int32)
    x["engine/phase1"], x["engine/phase2"] = engine_requests()
    x["generate/prompts"] = np.random.default_rng(3).integers(
        3, VOCAB, (2, 12)).astype(np.int32)
    return x

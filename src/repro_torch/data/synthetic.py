"""Synthetic task suites mirroring the paper's benchmark categories.

The paper evaluates on Math (GSM8K/MATH), Code (HumanEval/MBPP) and Chat
(MT-Bench/Alpaca). At CPU scale we mirror the *statistical structure* that
drives speculative-decoding behaviour: math/code have low-entropy, highly
structured continuations (high draft acceptance); chat is high-entropy
(diffuse boundary posterior) — exactly the gradient Table 3 shows.

  math: chained 2-3 digit additions  "12+34=46;46+7=53;..."
  code: bracket/keyword PCFG         "def f1(x): return (x+3)*f0(x) ..."
  chat: order-2 Markov babble with topic tokens (high entropy)

All generators are deterministic in (seed, index) and pure numpy.

This is the PyTorch port's own copy of ``repro/data/synthetic.py`` (the
port imports nothing of the JAX package); it yields the same numpy
batches for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

VOCAB = 512
PAD, BOS, EOS = 0, 1, 2
_CHARS = "0123456789+-*/=;()abcdefghijklmnopqrstuvwxyz_ :.,!?\n"
CHAR_TO_ID = {c: i + 3 for i, c in enumerate(_CHARS)}
ID_TO_CHAR = {i: c for c, i in CHAR_TO_ID.items()}


def encode(s: str) -> List[int]:
    return [CHAR_TO_ID.get(c, CHAR_TO_ID[" "]) for c in s]


def decode_ids(ids) -> str:
    return "".join(ID_TO_CHAR.get(int(i), "#") for i in ids)


def gen_math(rng: np.random.Generator, seq_len: int) -> np.ndarray:
    toks = [BOS]
    a = int(rng.integers(10, 99))
    while len(toks) < seq_len + 1:
        b = int(rng.integers(2, 99))
        c = a + b
        toks.extend(encode(f"{a}+{b}={c};"))
        a = c if c < 800 else int(rng.integers(10, 99))
    return np.array(toks[: seq_len + 1], np.int32)


def gen_code(rng: np.random.Generator, seq_len: int) -> np.ndarray:
    toks = [BOS]
    fn = 0
    while len(toks) < seq_len + 1:
        k = int(rng.integers(1, 9))
        op = "+-*"[int(rng.integers(0, 3))]
        body = f"def f{fn}(x): return (x{op}{k})*f{max(fn - 1, 0)}(x)\n"
        toks.extend(encode(body))
        fn += 1
    return np.array(toks[: seq_len + 1], np.int32)


_TOPICS = ["the cat", "a model", "my friend", "the sky", "this code",
           "a dream", "the city"]
_VERBS = ["likes", "sees", "wants", "finds", "breaks", "makes", "knows"]
_OBJS = ["the sun", "a book", "fast cars", "hot tea", "old songs",
         "new ideas", "the rain", "long walks"]


def gen_chat(rng: np.random.Generator, seq_len: int) -> np.ndarray:
    toks = [BOS]
    while len(toks) < seq_len + 1:
        s = (f"{_TOPICS[rng.integers(len(_TOPICS))]} "
             f"{_VERBS[rng.integers(len(_VERBS))]} "
             f"{_OBJS[rng.integers(len(_OBJS))]}")
        if rng.random() < 0.4:
            s += f" and {_OBJS[rng.integers(len(_OBJS))]}"
        toks.extend(encode(s + ". "))
    return np.array(toks[: seq_len + 1], np.int32)


GENERATORS = {"math": gen_math, "code": gen_code, "chat": gen_chat}
TASKS = tuple(GENERATORS)


@dataclasses.dataclass
class DataState:
    """Checkpointable iterator state (exact resume)."""
    seed: int
    step: int = 0


class SyntheticDataset:
    """Deterministic, shardable, checkpointable batch source."""

    def __init__(self, task: str, batch: int, seq_len: int, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 mixture: Optional[Dict[str, float]] = None):
        self.task = task
        self.batch = batch
        self.seq_len = seq_len
        self.state = DataState(seed=seed)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.mixture = mixture

    def _gen_one(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, idx]))
        if self.task == "mixture":
            names = list((self.mixture or
                          {t: 1 / len(TASKS) for t in TASKS}))
            probs = np.array([self.mixture[n] for n in names]) \
                if self.mixture else None
            t = rng.choice(names, p=probs)
            return GENERATORS[t](rng, self.seq_len)
        return GENERATORS[self.task](rng, self.seq_len)

    def next_batch(self) -> Dict[str, np.ndarray]:
        base = (self.state.step * self.num_shards + self.shard_id) \
            * self.batch
        seqs = np.stack([self._gen_one(base + i) for i in range(self.batch)])
        self.state.step += 1
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
            "mask": (seqs[:, 1:] != PAD).astype(np.float32),
        }

    def prompts(self, n: int, prompt_len: int, offset: int = 10 ** 6
                ) -> np.ndarray:
        out = np.stack([self._gen_one(offset + i)[: prompt_len]
                        for i in range(n)])
        return out.astype(np.int32)

    # --- checkpointing ---
    def state_dict(self) -> Dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def load_state_dict(self, d: Dict):
        self.state = DataState(seed=int(d["seed"]), step=int(d["step"]))

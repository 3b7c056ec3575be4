"""Open-loop traffic generation: seeded arrival processes over the task mix.

A closed-loop replayer (submit a batch, wait, submit the next) can never
observe queueing — the client politely waits for the server. Open-loop
traffic fires requests on a schedule that does NOT depend on server
progress, which is what exposes TTFT/TPOT tails and queue-depth growth
under load. Two arrival processes:

* **poisson** — i.i.d. exponential inter-arrival times at ``rate`` req/s.
  The memoryless baseline most serving papers quote.
* **bursty** — a 2-state Markov-modulated Poisson process (MMPP): the
  source dwells in a *calm* state (rate ``rate * calm_scale``) and a
  *burst* state (rate ``rate * burst_scale``), with exponential dwell
  times. Same mean arrival intensity knob as poisson, but arrivals clump —
  the adversarial case for wave-synchronous scheduling, because a clump
  lands while a wave is mid-flight and a retire-moment-only admitter
  leaves slots idle until the next wave.

Prompts come from the synthetic task mix (:mod:`repro_torch.data.synthetic` —
math/code/chat round-robin by default), re-ranged into the serving
vocabulary when the bench runs a tiny-vocab bundle. Everything is
deterministic in ``seed``: the same trace replays identically through the
synchronous engine and the overlapped front-end, which is what makes
per-request token-identity assertions possible.

This is the PyTorch port's own copy of ``repro/serving/traffic.py``,
over the port's copy of the synthetic generators: a seed gives the same
trace and the same prompts as the JAX module.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data import synthetic


@dataclasses.dataclass
class Arrival:
    """One open-loop request: submit ``prompt`` at absolute time ``t``."""
    t: float
    prompt: np.ndarray
    max_new: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


def _prompt(i: int, seed: int, prompt_len: int, vocab: Optional[int],
            tasks: Sequence[str]) -> np.ndarray:
    """Deterministic prompt #i: task round-robins through ``tasks``, the
    generator rng is keyed on (seed, i). ``vocab`` re-ranges generator
    output into [3, vocab) for tiny-vocab serving bundles (BOS/EOS/PAD
    stay reserved); None keeps the native synthetic vocabulary."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
    gen = synthetic.GENERATORS[tasks[i % len(tasks)]]
    toks = gen(rng, prompt_len)[:prompt_len].astype(np.int32)
    if vocab is not None:
        assert vocab > 3, f"vocab {vocab} leaves no room beyond specials"
        toks = np.where(toks < 3, toks, (toks - 3) % (vocab - 3) + 3)
    return toks.astype(np.int32)


def _materialize(times: List[float], seed: int, prompt_lens: Sequence[int],
                 max_new, vocab: Optional[int],
                 tasks: Sequence[str]) -> List[Arrival]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1 << 20]))
    news = ([int(max_new)] if isinstance(max_new, (int, np.integer))
            else [int(x) for x in max_new])
    out = []
    for i, t in enumerate(times):
        pl = int(prompt_lens[int(rng.integers(len(prompt_lens)))])
        mn = news[int(rng.integers(len(news)))]
        out.append(Arrival(t=float(t),
                           prompt=_prompt(i, seed, pl, vocab, tasks),
                           max_new=mn))
    return out


def poisson_trace(rate: float, duration: float, seed: int = 0,
                  prompt_lens: Sequence[int] = (12, 12, 20, 28),
                  max_new=16, vocab: Optional[int] = None,
                  tasks: Sequence[str] = synthetic.TASKS) -> List[Arrival]:
    """Poisson arrivals at ``rate`` req/s for ``duration`` seconds.
    ``prompt_lens`` / ``max_new`` may be sequences — each request samples
    uniformly from them (mixed decode budgets)."""
    assert rate > 0 and duration > 0
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    times, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            break
        times.append(t)
    return _materialize(times, seed, prompt_lens, max_new, vocab, tasks)


def bursty_trace(rate: float, duration: float, seed: int = 0,
                 calm_scale: float = 0.2, burst_scale: float = 4.0,
                 mean_dwell: float = 2.0,
                 prompt_lens: Sequence[int] = (12, 12, 20, 28),
                 max_new=16, vocab: Optional[int] = None,
                 tasks: Sequence[str] = synthetic.TASKS) -> List[Arrival]:
    """2-state MMPP: alternate calm (``rate * calm_scale``) and burst
    (``rate * burst_scale``) Poisson regimes with exponential dwell times
    of mean ``mean_dwell`` seconds, starting calm."""
    assert rate > 0 and duration > 0
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    rates = (rate * calm_scale, rate * burst_scale)
    times: List[float] = []
    t, state = 0.0, 0
    while t < duration:
        t_switch = t + float(rng.exponential(mean_dwell))
        r = rates[state]
        while True:
            t += float(rng.exponential(1.0 / r))
            if t >= t_switch or t >= duration:
                break
            times.append(t)
        t = min(t_switch, t)
        state ^= 1
    times = [x for x in times if x < duration]
    return _materialize(times, seed, prompt_lens, max_new, vocab, tasks)


TRACES = {"poisson": poisson_trace, "bursty": bursty_trace}


def make_trace(kind: str, rate: float, duration: float, seed: int = 0,
               **kw) -> List[Arrival]:
    """Build a named arrival trace (``poisson`` | ``bursty``)."""
    if kind not in TRACES:
        raise ValueError(f"unknown traffic kind {kind!r}; "
                         f"choose from {sorted(TRACES)}")
    return TRACES[kind](rate, duration, seed=seed, **kw)

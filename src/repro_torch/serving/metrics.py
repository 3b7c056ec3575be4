"""SLA metrics layer: clocks + per-request latency accounting.

This is the PyTorch port's own copy of ``repro/serving/metrics.py`` (the
port imports nothing of the JAX package); a replay under the same
:class:`VirtualClock` yields the same numbers through either engine.

Serving performance under load is a *latency distribution*, not a
throughput scalar — queueing collapse shows up in TTFT/TPOT tails long
before tokens/s moves. This module is the single timing source for both
serving drivers (the synchronous :meth:`ServingEngine.run` drain loop and
the overlapped :class:`~repro_torch.serving.frontend.ReplayDriver`), so
their numbers are directly comparable:

* **Clocks** — every engine timestamp goes through an injected
  :class:`Clock`. :class:`MonotonicClock` is the production default
  (monotonic wall time; ``tick`` is a no-op because real time passes by
  itself). :class:`VirtualClock` is a deterministic simulated clock: time
  only moves when someone calls :meth:`~VirtualClock.advance` /
  :meth:`~VirtualClock.wait_until`, or when the engine charges work via
  :meth:`~VirtualClock.tick` (one decode cycle = ``cycle_s``, one request
  install = ``install_s``). Benchmarks and tests replay traffic on a
  VirtualClock so latency numbers are exactly reproducible and
  independent of host speed; the same replay on a MonotonicClock measures
  real wall time with identical code paths.
* **Per-request lifecycle** — :class:`MetricsRecorder` timestamps the four
  request events (arrival, admission into a batch slot, first generated
  token, completion) and derives TTFT (first token − arrival), TPOT
  (steady-state seconds per generated token after the first), end-to-end
  latency, and queue wait. The serving engine emits the events itself
  (``submit`` / install / retire), so any driver on top of it gets
  per-request SLA metrics for free.
* **Queue-depth timeline** — drivers call :meth:`sample_queue_depth`
  once per scheduling iteration; the (t, depth) series is what exposes
  open-loop queueing collapse (depth growing without bound when the
  arrival rate exceeds service capacity).

Aggregation is nearest-rank percentiles (:func:`percentile`): exact order
statistics of the observed sample, so hand-built schedules in tests can
assert aggregate values to equality instead of approximately.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple


# ------------------------------------------------------------------ clocks --
class Clock:
    """Timing interface the serving stack is written against."""

    def now(self) -> float:
        raise NotImplementedError

    def wait_until(self, t: float) -> None:
        """Block (or jump, for virtual time) until ``now() >= t``."""
        raise NotImplementedError

    def tick(self, kind: str, n: int = 1) -> None:
        """Charge ``n`` units of simulated work (no-op on real clocks)."""


class MonotonicClock(Clock):
    """Real monotonic wall time, zeroed at construction.

    ``tick`` is a no-op: real work takes real time. This is the engine's
    default clock, replacing the old ad-hoc ``time.time()`` deltas (which
    were not monotonic-safe and unshareable with the async front-end).
    """

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic simulated clock for replays and tests.

    Time advances only through :meth:`advance` / :meth:`wait_until` (the
    open-loop driver jumping to the next arrival) and :meth:`tick` (the
    engine charging work): one decode cycle costs ``cycle_s`` and one
    request install costs ``install_s``. Unknown tick kinds default to
    ``0.0`` cost, so new instrumentation never breaks old replays.
    """

    def __init__(self, cycle_s: float = 1.0, install_s: float = 0.25):
        self._t = 0.0
        self.costs = {"cycle": float(cycle_s), "install": float(install_s)}

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0, f"time cannot run backwards ({dt})"
        self._t += dt

    def wait_until(self, t: float) -> None:
        if t > self._t:
            self._t = t

    def tick(self, kind: str, n: int = 1) -> None:
        self._t += self.costs.get(kind, 0.0) * n


# --------------------------------------------------------------- lifecycle --
@dataclasses.dataclass
class RequestTiming:
    """The four lifecycle timestamps of one request + derived SLA terms.

    ``t_first`` is the time the request's FIRST generated token exists —
    the prefill's anchor token, stamped when the install is dispatched.
    """
    uid: int
    t_arrival: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    n_tokens: int = 0

    @property
    def ttft(self) -> float:
        """Time to first token: arrival -> first generated token."""
        return self.t_first - self.t_arrival

    @property
    def tpot(self) -> float:
        """Time per output token AFTER the first (steady-state decode
        rate); 0.0 for single-token requests."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.t_done - self.t_first) / (self.n_tokens - 1)

    @property
    def e2e(self) -> float:
        """End-to-end latency: arrival -> last token."""
        return self.t_done - self.t_arrival

    @property
    def queue_wait(self) -> float:
        """Arrival -> admission into a batch slot (pure queueing delay)."""
        return self.t_admit - self.t_arrival

    @property
    def complete(self) -> bool:
        return self.t_done is not None


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (exact order statistic, no interpolation):
    the smallest observed value >= ``q`` percent of the sample. Exact on
    hand-built schedules, which is what the scheduler tests assert."""
    assert xs, "percentile of an empty sample"
    s = sorted(xs)
    rank = max(int(math.ceil(q / 100.0 * len(s))), 1)
    return float(s[min(rank, len(s)) - 1])


def summarize(xs: Sequence[float]) -> Dict[str, float]:
    """p50/p90/p99/mean/max of a sample (empty -> all zeros)."""
    if not xs:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    return {"p50": percentile(xs, 50), "p90": percentile(xs, 90),
            "p99": percentile(xs, 99),
            "mean": float(sum(xs) / len(xs)), "max": float(max(xs))}


class MetricsRecorder:
    """Collects per-request lifecycle events + a queue-depth timeline.

    Event methods stamp ``clock.now()`` unless an explicit time is given
    (open-loop drivers pass the trace's arrival time to ``on_arrival`` so
    TTFT counts from when the CLIENT sent the request, not from when the
    server's scheduling loop first looked at its queue).
    """

    def __init__(self, clock: Clock):
        self.clock = clock
        self.requests: Dict[int, RequestTiming] = {}
        self.queue_depth: List[Tuple[float, int]] = []

    def _req(self, uid: int) -> RequestTiming:
        if uid not in self.requests:
            self.requests[uid] = RequestTiming(uid)
        return self.requests[uid]

    def on_arrival(self, uid: int, t: Optional[float] = None) -> None:
        self._req(uid).t_arrival = self.clock.now() if t is None else t

    def on_admit(self, uid: int, t: Optional[float] = None) -> None:
        self._req(uid).t_admit = self.clock.now() if t is None else t

    def on_first_token(self, uid: int, t: Optional[float] = None) -> None:
        self._req(uid).t_first = self.clock.now() if t is None else t

    def on_done(self, uid: int, n_tokens: int,
                t: Optional[float] = None) -> None:
        r = self._req(uid)
        r.t_done = self.clock.now() if t is None else t
        r.n_tokens = int(n_tokens)

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depth.append((self.clock.now(), int(depth)))

    # ------------------------------------------------------- aggregation --
    def completed(self) -> List[RequestTiming]:
        return sorted((r for r in self.requests.values() if r.complete),
                      key=lambda r: r.uid)

    def per_request(self) -> List[Dict[str, float]]:
        """One flat record per completed request (bench JSON payload)."""
        return [{"uid": r.uid, "ttft": r.ttft, "tpot": r.tpot,
                 "e2e": r.e2e, "queue_wait": r.queue_wait,
                 "n_tokens": r.n_tokens} for r in self.completed()]

    def summary(self) -> Dict:
        """Aggregate SLA section: p50/p90/p99/mean/max per metric, plus
        the queue-depth timeline's mean/max."""
        done = self.completed()
        depths = [d for _, d in self.queue_depth]
        return {
            "n_requests": len(done),
            "ttft": summarize([r.ttft for r in done]),
            "tpot": summarize([r.tpot for r in done]),
            "e2e": summarize([r.e2e for r in done]),
            "queue_wait": summarize([r.queue_wait for r in done]),
            "queue_depth": {
                "samples": len(depths),
                "mean": (float(sum(depths) / len(depths))
                         if depths else 0.0),
                "max": max(depths) if depths else 0,
            },
        }

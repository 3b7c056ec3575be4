"""Async serving front-end: a clocked event loop with overlapped waves
(twin of ``repro/serving/frontend.py``).

The :class:`~repro_torch.serving.engine.ServingEngine` drain loop is a
batch replayer: everything is submitted up front and the host blocks on
every decode cycle. This module drives the same engine as an open-loop
server: requests arrive on a traffic trace's schedule
(:mod:`repro_torch.serving.traffic`), carry arrival timestamps, and are
admitted by a loop that overlaps host admission work with device decode.

The overlap rests on the engine's cycle API. ``dispatch_cycle`` enqueues
cycle N and returns (the decode cycle makes no host sync, so on a card
the call returns once its kernels are queued); the active-row mask was
taken before dispatch, so the cycle changes only rows that were serving
requests then. While the device decodes, the loop submits due arrivals
and calls ``admit_idle``: queued prompts are matched, their pages come
from free pool capacity, and same-bucket groups are installed by one
batched ``install_rows`` each, enqueued behind the cycle on the same
stream. The installs' anchor tokens are read back at the next retire
boundary (``complete_cycle``, the only blocking read), not inline.

Against the synchronous baseline (same pumping, no overlap window) the
win is structural: the sync engine refills a slot only when a retire
happens, so a slot that goes idle while the queue is momentarily empty
stays idle until the wave drains; the overlapped loop looks at idle slots
every cycle. Both drivers share the engine's injected clock and
:class:`~repro_torch.serving.metrics.MetricsRecorder`, so on a
:class:`~repro_torch.serving.metrics.VirtualClock` a replay is fully
deterministic and its numbers equal the JAX front-end's.

Mesh residency: nothing here is mesh-aware. An engine built inside
``use_sharding`` in every rank of a mesh (kv_seq-sharded pools, or a
wave's rows split over the batch axes: slot b lives on the rank whose
run holds it, and every rank keeps the whole wave's books) captures its
sharding context at construction and re-enters it around its own work,
so this loop drives it as it drives one on a single device, and
:meth:`ServingEngine.admit_idle` installs into every rank's books alike.
Every rank runs the loop and must take the same admission decisions, so
a mesh replay runs on a :class:`~repro_torch.serving.metrics.VirtualClock`
(the wall clock differs from rank to rank); the engine's end-of-wave
check raises if the ranks' books part.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.metrics import MetricsRecorder
from repro_torch.serving.traffic import Arrival


class ReplayDriver:
    """Replay an arrival trace through a :class:`ServingEngine`.

    overlap=True (the async front-end): dispatch cycle N, then — while it
    decodes — pump due arrivals, admit them into idle slots, and only then
    block on the cycle's results. overlap=False (the synchronous
    baseline): identical pumping and timing, but no mid-flight admission —
    slots refill only at retire moments, exactly the drain-loop behavior.

    The driver owns the *event loop*; all engine state, admission policy,
    and metrics emission stay in the engine. When the engine sits idle
    with nothing due, the loop jumps the injected clock to the next
    arrival (``clock.wait_until`` — a real sleep on a monotonic clock, an
    instant jump in virtual time).
    """

    def __init__(self, engine: ServingEngine, trace: Sequence[Arrival],
                 overlap: bool = True):
        assert engine.recorder is not None, \
            "replay drivers need an engine with a MetricsRecorder"
        self.engine = engine
        self.trace = sorted(trace, key=lambda a: a.t)
        self.overlap = overlap
        self.engine_cycles = 0      # decode cycles dispatched by this loop
        self._next = 0

    # ------------------------------------------------------------- loop ----
    def _pump(self) -> int:
        """Submit every trace arrival whose time has come."""
        eng, n = self.engine, 0
        while (self._next < len(self.trace)
               and self.trace[self._next].t <= eng.clock.now()):
            a = self.trace[self._next]
            eng.submit(a.prompt, a.max_new, t_arrival=a.t)
            self._next += 1
            n += 1
        return n

    @property
    def _drained(self) -> bool:
        eng = self.engine
        return (self._next >= len(self.trace) and not eng.queue
                and eng.wave is None)

    def run(self) -> Dict:
        """Drive the trace to completion; returns engine stats + ``sla``
        summary + this loop's dispatched ``engine_cycles``."""
        eng = self.engine
        rec: MetricsRecorder = eng.recorder
        while not self._drained:
            self._pump()
            if eng.wave is None:
                if eng.queue:
                    # start_wave batch-installs the initial set (and can
                    # even finish the wave outright for max_new<=1 bursts).
                    # Full-width waves: open-loop arrivals trickle in, so
                    # rows beyond the visible batch start idle and are
                    # claimed by refills (sync: at retires; overlapped:
                    # any cycle via admit_idle)
                    eng.start_wave(width=eng.batch_size)
                    continue
                # idle: jump/sleep to the next arrival
                eng.clock.wait_until(self.trace[self._next].t)
                continue
            handle = eng.dispatch_cycle()
            self.engine_cycles += 1
            # ---- overlap window: the device is decoding cycle N ----
            self._pump()            # arrivals due during this cycle
            # sampled between pump and admission, so depth(t) is exactly
            # #arrivals<=t - #admits<t (admissions below stamp t_admit at
            # or after this instant; tests reconstruct the timeline from
            # the recorder's events and assert equality)
            rec.sample_queue_depth(len(eng.queue))
            if self.overlap:
                eng.admit_idle()    # fill idle slots mid-flight
            # ---- retire boundary: the wave's only blocking read ----
            eng.complete_cycle(handle)
        stats = dict(eng.stats)
        stats["engine_cycles"] = self.engine_cycles
        stats["sla"] = rec.summary()
        return stats

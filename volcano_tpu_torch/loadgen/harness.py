"""The open-loop harness: sustain a rate, read the latency tail.

The port's copy of ``volcano_tpu/loadgen/harness.py``.
:func:`run_open_loop` interleaves submitting the due arrivals, one
scheduler cycle (``pump``), observing binds and departing expired gangs,
under one of two pacings:

* **wall clock** (``tick_s=None``): arrivals fall due at their wall
  offsets, and a slow scheduler accumulates backlog as a real client
  population would;
* **lockstep** (``tick_s=<seconds>``): virtual time advances a fixed tick
  an iteration whatever the wall time, so the sequence of (arrival batch,
  cycle) pairs is deterministic; latency is still the monotonic clock.

The report reads the generator's histogram (p50 / p99 / p999 first-seen ->
bind), and :func:`saturation_search` doubles the rate until p99 leaves its
band.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.loadgen.workload import LoadGen, LoadSpec


@dataclass
class SLOReport:
    """The percentile readout of one open-loop run."""

    qps: float
    duration_s: float
    submitted_pods: int
    bound_pods: int
    unbound_pods: int
    p50_ms: float
    p99_ms: float
    p999_ms: float
    max_ms: float
    backlog_peak: int
    departed_gangs: int
    cycles: int
    wall_s: float
    #: every submitted pod seen bound before the settle deadline
    sustained: bool

    def as_dict(self) -> Dict[str, object]:
        return {
            "qps": self.qps, "duration_s": self.duration_s,
            "submitted_pods": self.submitted_pods, "bound_pods": self.bound_pods,
            "unbound_pods": self.unbound_pods, "p50_ms": round(self.p50_ms, 2),
            "p99_ms": round(self.p99_ms, 2), "p999_ms": round(self.p999_ms, 2),
            "max_ms": round(self.max_ms, 2), "backlog_peak": self.backlog_peak,
            "departed_gangs": self.departed_gangs, "cycles": self.cycles,
            "wall_s": round(self.wall_s, 2), "sustained": self.sustained,
        }


def run_open_loop(store, spec: LoadSpec, pump: Callable[[], None], *,
                  settle_s: float = 30.0, tick_s: Optional[float] = None,
                  idle_sleep_s: float = 0.002,
                  on_tick: Optional[Callable[[LoadGen], None]] = None,
                  gen: Optional[LoadGen] = None) -> SLOReport:
    """One open-loop run; returns its :class:`SLOReport`.

    ``tick_s=None`` paces arrivals by the wall clock, a float runs lockstep
    virtual time.  ``settle_s`` bounds how long the harness keeps pumping
    after the arrival window for the tail to bind; pods still unbound then
    mark the run unsustained.  ``on_tick(gen)`` runs once an iteration,
    after the binds were observed."""
    gen = gen or LoadGen(store, spec)
    t0 = time.monotonic()
    vnow = 0.0
    cycles = 0
    backlog_peak = 0
    deadline = None
    while True:
        now = vnow if tick_s is not None else time.monotonic() - t0
        gen.submit_due(min(now, spec.duration_s))
        pump()
        cycles += 1
        gen.observe()
        gen.depart_due()
        if on_tick is not None:
            on_tick(gen)
        backlog_peak = max(backlog_peak, gen.pending_pods)
        if gen.all_submitted and now >= spec.duration_s:
            if gen.done:
                break
            if deadline is None:
                deadline = time.monotonic() + settle_s
            elif time.monotonic() > deadline:
                break  # unsustained: the tail never drained
        if tick_s is not None:
            vnow += tick_s
        elif idle_sleep_s:
            time.sleep(idle_sleep_s)
    return SLOReport(
        qps=spec.qps, duration_s=spec.duration_s,
        submitted_pods=gen.submitted_pods, bound_pods=gen.bound_pods,
        unbound_pods=gen.pending_pods, p50_ms=gen.quantile_ms(0.50),
        p99_ms=gen.quantile_ms(0.99), p999_ms=gen.quantile_ms(0.999),
        max_ms=(gen.hist.vmax * 1e3) if gen.hist.count else 0.0,
        backlog_peak=backlog_peak, departed_gangs=gen.departed_gangs,
        cycles=cycles, wall_s=time.monotonic() - t0, sustained=gen.done)


@dataclass
class SaturationResult:
    """A rate escalation's outcome: the last rate inside the band and the
    first that left it (None if none did)."""

    sustained_qps: Optional[float]
    breach_qps: Optional[float]
    band_p99_ms: float
    steps: List[SLOReport] = field(default_factory=list)

    def as_dict(self) -> Dict[str, object]:
        return {"sustained_qps": self.sustained_qps, "breach_qps": self.breach_qps,
                "band_p99_ms": self.band_p99_ms, "steps": [r.as_dict() for r in self.steps]}


def saturation_search(run_at: Callable[[float], SLOReport], base_qps: float,
                      band_p99_ms: float, max_doublings: int = 4) -> SaturationResult:
    """Double the rate (a fresh run each: ``run_at`` builds a fresh store
    and scheduler) until p99 leaves ``band_p99_ms`` or a run does not
    drain, or ``max_doublings`` steps stay inside the band."""
    out = SaturationResult(None, None, band_p99_ms)
    qps = base_qps
    for _ in range(max_doublings + 1):
        report = run_at(qps)
        out.steps.append(report)
        if report.p99_ms > band_p99_ms or not report.sustained:
            out.breach_qps = qps
            break
        out.sustained_qps = qps
        qps *= 2.0
    return out

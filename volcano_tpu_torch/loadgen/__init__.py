"""Seeded open-loop load generation against the port's store.

The port's copy of ``volcano_tpu/loadgen/``: a seeded open-loop arrival
process (Poisson inter-arrivals, gang-size / resource / queue mixes,
exponential dwell departures) that drives a store and a scheduler, and
measures pod first-seen -> bind latency into the bounded histograms of
``scheduler/metrics.py``.

* ``workload`` — ``LoadSpec`` (the distributions), ``build_schedule`` (the
  deterministic event list), ``LoadGen`` (submit, observe binds, depart).
* ``harness`` — ``run_open_loop`` (wall-clock or lockstep pacing), the
  ``SLOReport`` percentile readout, and ``saturation_search`` (raise the
  rate until p99 leaves its band).  The follower fan-out pass of the JAX
  harness waits for the replicated store (ROADMAP item 11b).
"""

from volcano_tpu_torch.loadgen.harness import (  # noqa: F401
    SLOReport,
    run_open_loop,
    saturation_search,
)
from volcano_tpu_torch.loadgen.workload import (  # noqa: F401
    Arrival,
    LoadGen,
    LoadSpec,
    build_schedule,
)

__all__ = [
    "Arrival", "LoadGen", "LoadSpec", "build_schedule",
    "SLOReport", "run_open_loop", "saturation_search",
]

"""DeltaEngine: micro build or full fallback, once a cycle.

The port's copy of ``volcano_tpu/scheduler/delta/engine.py``.  It owns the
``DirtySet`` installed as ``mirror.delta_hook``, the ``PodAggregates`` and
the ``AdmissionController``.  Each build:

1. A structural event since the last full build (``arm``, ``init``,
   ``resync``, ``node-add``, ``node-remove``, ``job-requeue``,
   ``job-remove``), more than :data:`DIRTY_STORM` dirty rows
   (``dirty-storm``), or a live non-shadow job whose queue has not
   resolved (``job-dropped``: the full sweep drops its pods from node
   usage) builds full, rebuilds the aggregates and records the reason.
2. Otherwise the dirty rows are diffed into the aggregates.  Pending
   dynamic or volume pods still build full (``dynamic``: the partition
   needs the full classifier), keeping the diffed aggregates, which stay
   exact.
3. Else the micro build: ``build_fast_snapshot(..., agg=...)`` gathers
   the aggregates in place of the O(P) sweeps.  With ``conf.delta_oracle``
   a full build runs beside it and must equal it bit for bit.
4. Admission and shedding run after either build; their exclusions go
   through ``patch_task_planes`` with the task bucket pinned, so a micro
   cycle launches the kernels at the shapes the cycle already had.

``rebuild_full`` is the contention fallback: a micro cycle that finds
reclaim or preempt work rebuilds full on the same mirror state (the victim
pool needs the full context) and re-applies the cached decision, charging
no tokens and shipping no conditions again.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.delta.admission import AdmissionController, Decision
from volcano_tpu_torch.scheduler.delta.dirty import DirtySet
from volcano_tpu_torch.scheduler.delta.incremental import (
    PodAggregates,
    assert_snapshot_equal,
    patch_task_planes,
)
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import build_fast_snapshot

#: dirty rows past which the per-row diff loses to one vectorized sweep
DIRTY_STORM = 2048


class DeltaEngine:
    """A FastCycle's delta state, for the scheduler's lifetime; it re-arms
    across mirror resyncs and restores."""

    def __init__(self, conf, store, now_fn=time.monotonic) -> None:
        self.conf = conf
        self.dirty = DirtySet()
        self.agg: Optional[PodAggregates] = None
        self.admission = AdmissionController(conf, store, now_fn=now_fn)
        self._decision: Optional[Decision] = None
        self._oracle = bool(conf.delta_oracle)
        #: the last build's mode, fallback reason and admission depths
        #: (the cycle row's fields)
        self.last = {"mode": "full", "fallback_reason": "arm",
                     "backlog_gangs": 0, "held_gangs": 0, "shed_gangs": 0}

    def arm(self, m) -> None:
        """Install the dirty hook on a new (or restored) mirror; a fresh
        install means events were missed, a structural ``arm``."""
        if m.delta_hook is not self.dirty:
            m.delta_hook = self.dirty
            self.dirty.structural("arm")

    def build(self, m, nodeaffinity_weight: float, dyn_batch) -> Tuple[Optional[object], dict]:
        R = m.p_resreq.shape[1]
        if self.agg is None or self.agg.R != R:
            self.agg = PodAggregates(R)
            self.dirty.structural("init")

        reason = None
        if self.dirty.structural_reasons:
            reason = self.dirty.structural_reasons[0]
        elif len(self.dirty.pods) > DIRTY_STORM:
            reason = "dirty-storm"
        elif bool((m.j_live & ~m.j_shadow & (m.j_queue < 0)).any()):
            # the full sweep drops the pods of queue-less jobs from node
            # usage; row-keyed aggregates cannot see that flip
            reason = "job-dropped"

        if reason is None:
            self.agg.apply(m, self.dirty.pods)
            self.dirty.pods.clear()
            if self.agg.n_dynvol_pending > 0:
                snap, aux = build_fast_snapshot(m, nodeaffinity_weight, dyn_batch=dyn_batch)
                mode, reason = "full", "dynamic"
            else:
                snap, aux = build_fast_snapshot(m, nodeaffinity_weight, dyn_batch=dyn_batch,
                                                agg=self.agg)
                mode = "micro"
                if self._oracle and snap is not None:
                    assert_snapshot_equal(
                        (snap, aux),
                        build_fast_snapshot(m, nodeaffinity_weight, dyn_batch=dyn_batch))
        else:
            snap, aux = build_fast_snapshot(m, nodeaffinity_weight, dyn_batch=dyn_batch)
            self.agg.rebuild(m)
            self.dirty.clear()
            mode = "full"

        if mode == "micro":
            metrics.register_delta_micro_cycle()
        else:
            metrics.register_delta_fallback(reason)

        if snap is None:
            self._decision = None
            self.last = {"mode": mode, "fallback_reason": reason or "",
                         "backlog_gangs": 0, "held_gangs": 0, "shed_gangs": 0}
            return snap, aux

        decision = self.admission.decide(m, aux)
        self._decision = decision
        if decision.newly_shed:
            metrics.register_delta_shed(decision.newly_shed)
        self._apply_decision(m, snap, aux, decision, nodeaffinity_weight)
        self.last = {"mode": mode, "fallback_reason": reason or "",
                     "backlog_gangs": decision.depth,
                     "held_gangs": len(decision.held_jobs),
                     "shed_gangs": len(decision.shed_jobs)}
        return snap, aux

    def rebuild_full(self, m, nodeaffinity_weight: float,
                     dyn_batch) -> Tuple[Optional[object], dict]:
        """The full build on the same mirror state, after a micro cycle found
        reclaim or preempt work; the cached decision re-applies (same state,
        same job numbering) without charging tokens.  The micro counter
        keeps its increment (it counts micro builds); the cycle row turns to
        mode "full", reason "contention"."""
        snap, aux = build_fast_snapshot(m, nodeaffinity_weight, dyn_batch=dyn_batch)
        self.agg.rebuild(m)
        self.dirty.clear()
        metrics.register_delta_fallback("contention")
        if snap is not None and self._decision is not None:
            self._apply_decision(m, snap, aux, self._decision, nodeaffinity_weight)
        self.last = dict(self.last, mode="full", fallback_reason="contention")
        return snap, aux

    @staticmethod
    def _apply_decision(m, snap, aux, decision: Decision, nodeaffinity_weight: float) -> None:
        # publish must not overwrite a shed gang's Backlogged condition
        aux["delta_shed_jobs"] = set(decision.shed_jobs)
        excluded = decision.excluded
        if not excluded:
            return
        pe_rows = aux["pe_rows"]
        keep = pe_rows[~np.isin(aux["pod_j"][pe_rows], np.fromiter(excluded, np.int64))]
        patch_task_planes(m, snap, aux, keep, nodeaffinity_weight)

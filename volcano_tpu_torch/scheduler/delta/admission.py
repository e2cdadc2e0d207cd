"""Token-bucket admission and backlog watermark shedding.

The port's copy of ``volcano_tpu/scheduler/delta/admission.py``.  Between
the snapshot build and the solve: of the gangs with pending tasks this
cycle, only the admitted ones reach the solve.

* **Token bucket** (``delta_admit_qps`` gangs/s, ``delta_burst`` deep): a
  gang pays one token the first cycle it is admitted and stays admitted
  until it places or leaves, so a steady backlog does not pay again.  The
  rest are held: kept out of the solve, otherwise untouched.
* **Shedding** (``delta_high_watermark``): above that many distinct pending
  gangs, the lowest-priority non-shadow gangs get a ``Backlogged``
  PodGroup condition and stay out of the solve (never dropped: their pods
  stay pending) until the depth falls to the low watermark (default
  high // 2), when the condition clears and they re-enter admission.
  Shedding is sticky: gangs already shed are shed first.

A decision is a function of (mirror, aux, clock); the engine keeps the
last :class:`Decision` so that the contention rebuild on the same state
re-applies it without charging tokens or shipping conditions again.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Set

import numpy as np

from volcano_tpu_torch.api.objects import PodGroupCondition

log = logging.getLogger(__name__)


class TokenBucket:
    """Gang admission tokens; ``now_fn`` is injectable for tests."""

    def __init__(self, rate: float, burst: int = 0, now_fn=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate)
        self._now = now_fn
        self.tokens = self.burst
        self._last = self._now()

    def take(self, n: float = 1.0) -> bool:
        now = self._now()
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class Decision:
    """One cycle's admission outcome, in the snapshot's job numbering."""

    __slots__ = ("depth", "held_jobs", "shed_jobs", "newly_shed")

    def __init__(self, depth: int, held_jobs: Set[int], shed_jobs: Set[int],
                 newly_shed: int) -> None:
        self.depth = depth
        self.held_jobs = held_jobs
        self.shed_jobs = shed_jobs
        self.newly_shed = newly_shed

    @property
    def excluded(self) -> Set[int]:
        return self.held_jobs | self.shed_jobs


class AdmissionController:
    """Admission state kept by PodGroup key across cycles (job rows are
    reused; keys are not)."""

    def __init__(self, conf, store, now_fn=time.monotonic) -> None:
        self.store = store
        self.rate = float(conf.delta_admit_qps or 0.0)
        self.high = int(conf.delta_high_watermark or 0)
        low = int(conf.delta_low_watermark or 0)
        self.low = low if low > 0 else self.high // 2
        self.bucket = (TokenBucket(self.rate, int(conf.delta_burst or 0), now_fn=now_fn)
                       if self.rate > 0 else None)
        #: keys holding a paid admission (kept until the gang leaves the backlog)
        self.admitted: Set[str] = set()
        #: keys carrying the Backlogged condition
        self.shed: Set[str] = set()

    def decide(self, m, aux) -> Decision:
        """This cycle's held and shed gangs; ships the Backlogged and the
        re-admit condition patches through ``store.bulk``.  Moves the token
        and shed state: the engine calls it at most once a cycle."""
        pe_rows, pod_j, job_rows = aux["pe_rows"], aux["pod_j"], aux["job_rows"]
        jidx = np.unique(pod_j[pe_rows]) if len(pe_rows) else np.zeros(0, np.int64)
        jidx = jidx[jidx >= 0]
        depth = int(jidx.size)

        keys: Dict[int, str] = {}
        prio: Dict[int, float] = {}
        shadow: Dict[int, bool] = {}
        for j in jidx.tolist():
            jrow = int(job_rows[j])
            keys[j] = m.jobs.row_key[jrow] or ""
            prio[j] = float(m.j_prio[jrow])
            shadow[j] = bool(m.j_shadow[jrow])
        backlog_keys = set(keys.values())

        # gangs that left the backlog release their admission; shed keys go
        # too (their condition clears on re-admission, or the group is gone)
        self.admitted &= backlog_keys
        self.shed &= backlog_keys

        # token-bucket admission: priority, then job order
        held_jobs: Set[int] = set()
        if self.bucket is not None:
            for j in sorted(jidx.tolist(), key=lambda j: (-prio[j], j)):
                k = keys[j]
                if k in self.admitted:
                    continue
                if self.bucket.take(1.0):
                    self.admitted.add(k)
                else:
                    held_jobs.add(j)
        else:
            self.admitted |= backlog_keys

        # watermark shedding
        ops: List[dict] = []
        shed_jobs: Set[int] = set()
        newly_shed = 0
        if self.high > 0 and depth > self.high:
            need = depth - self.high
            # lowest priority first; sticky: already-shed keys sort ahead
            cands = sorted((j for j in jidx.tolist() if not shadow[j]),
                           key=lambda j: (keys[j] not in self.shed, prio[j], -j))
            for j in cands[:need]:
                shed_jobs.add(j)
                k = keys[j]
                self.admitted.discard(k)
                if k not in self.shed:
                    self.shed.add(k)
                    newly_shed += 1
                    ops.append(self._backlog_op(k, True))
        elif self.shed and depth <= self.low:
            # recovered: every Backlogged condition clears, and the gangs
            # re-enter admission next cycle
            for k in sorted(self.shed):
                ops.append(self._backlog_op(k, False))
            self.shed.clear()

        # gangs shed in earlier cycles stay out until re-admitted
        for j in jidx.tolist():
            if keys[j] in self.shed:
                shed_jobs.add(j)
        held_jobs -= shed_jobs

        if ops:
            try:
                self.store.bulk(ops)
            except Exception as exc:  # noqa: BLE001 — a store outage; not retried, as in JAX
                log.warning("delta admission condition ship failed: %s", exc)
        return Decision(depth, held_jobs, shed_jobs, newly_shed)

    @staticmethod
    def _backlog_op(key: str, shed: bool) -> dict:
        conds = ([PodGroupCondition(kind="Backlogged", status="True", reason="AdmissionShed",
                                    message="shed above backlog high watermark")]
                 if shed else [])
        return {"op": "patch", "kind": "PodGroup", "key": key,
                "fields": {"status.conditions": conds}}

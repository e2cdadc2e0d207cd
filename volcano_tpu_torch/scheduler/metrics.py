"""Scheduler metrics with the reference's names.

The port's copy of ``volcano_tpu/scheduler/metrics.py``, cut to the
families the scheduler path records.  Collector names and semantics follow
KB/pkg/scheduler/metrics/metrics.go:38-121 (namespace ``volcano``).

Histograms are **bounded log-linear bucket histograms**: ``observe()`` folds
every sample into a fixed bucket universe, ``SUBBUCKETS`` linear
sub-buckets per decade between ``10^EMIN`` and ``10^EMAX``, so a series
that has seen 10^6 observations holds the same state as one that has seen
10^2.  A quantile is off by at most one sub-bucket width, ``9/SUBBUCKETS``
of the value.

``expose_text`` writes the Prometheus text format: ``# HELP`` / ``# TYPE``
per family, cumulative ``_bucket{le="..."}`` lines (the non-empty
boundaries and the mandatory ``le="+Inf"``), ``_sum`` / ``_count``, in a
byte-stable order (families alphabetical, series by sorted label tuple).

Cardinality guard: at most ``MAX_SERIES_PER_METRIC`` distinct label sets
per metric name.  Past the cap a new series is dropped (the observation is
discarded, never an error) and counted in
``volcano_metrics_dropped_series_total{metric=...}``.

Durations come from monotonic clocks (``time.perf_counter``).  The store
WAL's families are the apiserver's (``store/wal.py``, ``store/server.py``).
The digest audit's families are the scheduler's audit tick's
(``Scheduler._audit_tick``).  Families of the JAX module that wait for
other modules of the port: replication's and the process mesh's (ROADMAP
item 11b parts 3-4), the elastic autoscaler's (12).  ``volcano_jit_compiles_total`` keeps
its JAX name and counts the growth of the launch-shape registry
(``vtprof.py``); its HELP line says so.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

#: linear sub-buckets per decade; worst-case relative quantile error is
#: 9/SUBBUCKETS (one sub-bucket width)
SUBBUCKETS = 90
#: decade range: finite boundaries span [10^EMIN, 10^EMAX]
EMIN = -9
EMAX = 9
#: finite bucket universe (underflow + per-decade linear sub-buckets);
#: values >= 10^EMAX count only toward +Inf
MAX_BUCKETS = (EMAX - EMIN) * SUBBUCKETS + 2
#: label-cardinality cap per metric name
MAX_SERIES_PER_METRIC = 512

_LO = 10.0 ** EMIN
_HI = 10.0 ** EMAX
#: index of the +Inf-only overflow bucket
_OVERFLOW = (EMAX - EMIN) * SUBBUCKETS + 1

_DROPPED_SERIES = "volcano_metrics_dropped_series_total"


def _bucket_index(v: float) -> int:
    """The fixed log-linear bucket of ``v`` (0 = underflow, which also
    holds zero, negatives and NaN; ``_OVERFLOW`` = past the last finite
    boundary, reported only under ``le="+Inf"``)."""
    if not v > _LO:
        return 0
    if v >= _HI:
        return _OVERFLOW
    e = math.floor(math.log10(v))
    # log10 can land one decade off at exact powers
    if v < 10.0 ** e:
        e -= 1
    elif v >= 10.0 ** (e + 1):
        e += 1
    m = v / (10.0 ** e)
    # ceil minus one keeps an exact boundary value in its own (lower)
    # bucket: le is inclusive in the Prometheus contract
    sub = math.ceil((m - 1.0) * SUBBUCKETS / 9.0) - 1
    if sub < 0:
        sub = 0
    elif sub >= SUBBUCKETS:
        sub = SUBBUCKETS - 1
    return 1 + (e - EMIN) * SUBBUCKETS + sub


def _bucket_upper(idx: int) -> float:
    """The inclusive upper boundary (the ``le`` value) of a finite bucket."""
    if idx <= 0:
        return _LO
    e = EMIN + (idx - 1) // SUBBUCKETS
    sub = (idx - 1) % SUBBUCKETS
    return (10.0 ** e) * (1.0 + 9.0 * (sub + 1) / SUBBUCKETS)


class Histogram:
    """One bounded series: sparse bucket counts, count, sum, min and max."""

    __slots__ = ("buckets", "count", "sum", "vmin", "vmax")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        idx = _bucket_index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def cumulative(self) -> List[Tuple[float, int]]:
        """The non-empty finite boundaries as ``(le, cumulative_count)``,
        ascending, then the mandatory ``(+Inf, count)``."""
        out: List[Tuple[float, int]] = []
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if idx < _OVERFLOW:
                out.append((_bucket_upper(idx), cum))
        out.append((math.inf, self.count))
        return out

    def quantile(self, q: float) -> float:
        return HistogramSnapshot(self).quantile(q)


class HistogramSnapshot:
    """The read-side view ``get_histogram`` returns: the quantile readout,
    ``len`` and iteration over bucket-representative values."""

    __slots__ = ("count", "sum", "buckets", "vmin", "vmax")

    def __init__(self, hist: Optional[Histogram]):
        if hist is None:
            self.count = 0
            self.sum = 0.0
            self.buckets: List[Tuple[float, int]] = [(math.inf, 0)]
            self.vmin = math.inf
            self.vmax = -math.inf
        else:
            self.count = hist.count
            self.sum = hist.sum
            self.buckets = hist.cumulative()
            self.vmin = hist.vmin
            self.vmax = hist.vmax

    def quantile(self, q: float) -> float:
        """The value at quantile ``q`` in [0, 1]: the inclusive upper bound
        of the bucket that holds that rank (the overflow bucket reports the
        observed max); 0 for an empty series."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        for le, cum in self.buckets:
            if cum >= rank:
                if math.isinf(le):
                    return self.vmax
                return min(le, self.vmax)
        return self.vmax

    def __len__(self) -> int:
        return self.count

    def __iter__(self) -> Iterator[float]:
        """Bucket-representative values, each boundary repeated by its
        bucket's count, ascending."""
        prev = 0
        for le, cum in self.buckets:
            rep = self.vmax if math.isinf(le) else min(le, self.vmax)
            for _ in range(cum - prev):
                yield rep
            prev = cum

    def __bool__(self) -> bool:
        return self.count > 0


_mu = threading.Lock()
_histograms: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}
_counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
_gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
#: distinct label sets seen per metric name (the cardinality guard)
_series_counts: Dict[str, int] = {}


def _key(name: str, labels: Dict[str, str]):
    return (name, tuple(sorted(labels.items())))


def _admit(family: dict, key) -> bool:
    """The cardinality guard, under ``_mu``: a NEW series is admitted only
    below its name's cap; a refused one bumps the dropped counter."""
    if key in family:
        return True
    name = key[0]
    n = _series_counts.get(name, 0)
    if n >= MAX_SERIES_PER_METRIC:
        dk = (_DROPPED_SERIES, (("metric", name),))
        _counters[dk] = _counters.get(dk, 0.0) + 1.0
        return False
    _series_counts[name] = n + 1
    return True


def observe(name: str, value: float, **labels) -> None:
    key = _key(name, labels)
    with _mu:
        h = _histograms.get(key)
        if h is None:
            if not _admit(_histograms, key):
                return
            h = _histograms[key] = Histogram()
        h.observe(value)


def inc(name: str, value: float = 1.0, **labels) -> None:
    key = _key(name, labels)
    with _mu:
        if key not in _counters and not _admit(_counters, key):
            return
        _counters[key] = _counters.get(key, 0.0) + value


def set_gauge(name: str, value: float, **labels) -> None:
    key = _key(name, labels)
    with _mu:
        if key not in _gauges and not _admit(_gauges, key):
            return
        _gauges[key] = value


def reset() -> None:
    with _mu:
        _histograms.clear()
        _counters.clear()
        _gauges.clear()
        _series_counts.clear()


def get_histogram(name: str, **labels) -> HistogramSnapshot:
    with _mu:
        return HistogramSnapshot(_histograms.get(_key(name, labels)))


def get_counter(name: str, **labels) -> float:
    with _mu:
        return _counters.get(_key(name, labels), 0.0)


def quantile(name: str, q: float, **labels) -> float:
    """Percentile readout of a histogram series (p50 = 0.5, p99 = 0.99);
    0.0 for an empty series."""
    return get_histogram(name, **labels).quantile(q)


# -- the recording helpers the scheduler calls --------------------------------

def update_e2e_duration(start: float) -> None:
    observe("volcano_e2e_scheduling_latency_milliseconds", (time.perf_counter() - start) * 1e3)


def update_action_duration(action: str, start: float) -> None:
    observe("volcano_action_scheduling_latency_microseconds",
            (time.perf_counter() - start) * 1e6, action=action)


def update_plugin_duration(plugin: str, on_session: str, start: float) -> None:
    observe("volcano_plugin_scheduling_latency_microseconds",
            (time.perf_counter() - start) * 1e6, plugin=plugin, OnSession=on_session)


def update_task_schedule_duration(duration_s: float) -> None:
    observe("volcano_task_scheduling_latency_microseconds", duration_s * 1e6)


def update_pod_e2e_latency(ms: float) -> None:
    """Pod first seen on the bus (creation) to bind decision, in
    milliseconds (metrics.go's E2eSchedulingLatency family)."""
    observe("volcano_e2e_job_scheduling_latency_milliseconds", ms)


def register_schedule_attempt(succeeded: bool) -> None:
    inc("volcano_schedule_attempts_total", result="scheduled" if succeeded else "unschedulable")


def register_preemption_attempt() -> None:
    # the reference's name (metrics.go TotalPreemptionAttempts), kept
    # verbatim for scrape compatibility
    inc("volcano_total_preemption_attempts")


def update_preemption_victims(count: int) -> None:
    set_gauge("volcano_pod_preemption_victims", count)


def update_unschedule_task_count(job: str, count: int) -> None:
    set_gauge("volcano_unschedule_task_count", count, job_id=job)


def update_unschedule_job_count(count: int) -> None:
    set_gauge("volcano_unschedule_job_count", count)


def register_job_retry(job: str) -> None:
    # the reference's name (metrics.go JobRetryCounts); the per-job label is
    # fenced by the cardinality guard
    inc("volcano_job_retry_counts", job_id=job)


def register_residue_tasks(cls: str, count: int) -> None:
    """Tasks the fast cycle routed to the host residue class this cycle,
    labelled by why (``volume-shape``, ``volume-claim-cap``,
    ``intern-overflow``, ``best-effort``, ``contended-claims``,
    ``batch-wave``).  A monotone counter."""
    inc("volcano_residue_tasks_total", float(count), **{"class": cls})


# -- the critical-path profiler's series (volcano_tpu_torch/vtprof.py) ----------

def register_jit_compile(kernel: str, n: int = 1) -> None:
    """Growth of one kernel's launch-shape registry seen by the vtprof
    sentinel: a new launch shape, per-shape workspace or library build
    (the JAX series counts XLA compiles; the name is kept for the
    dashboards).  In steady state this series must stay flat."""
    inc("volcano_jit_compiles_total", float(n), kernel=kernel)


def register_kernel_dispatch(kernel: str, n: int = 1) -> None:
    inc("volcano_kernel_dispatch_total", float(n), kernel=kernel)


def observe_prof_segment(phase: str, segment: str, seconds: float) -> None:
    """One cycle's share of a (phase, segment) cell, segment one of host /
    dispatch / wait / transfer."""
    observe("volcano_prof_segment_seconds", seconds, phase=phase, segment=segment)


def observe_kernel_device_seconds(kernel: str, seconds: float) -> None:
    """One kernel's device seconds in one cycle: CUDA-event time of its
    launches on the card, wait + transfer on the CPU."""
    observe("volcano_kernel_device_seconds", seconds, kernel=kernel)


def update_device_bytes(component: str, nbytes: int) -> None:
    """Memory watermark gauge: bytes held per component (mirror / snapshot /
    device)."""
    set_gauge("volcano_device_bytes", float(nbytes), component=component)


def register_prof_anomaly(kind: str) -> None:
    inc("volcano_prof_anomalies_total", kind=kind)


# -- the state digest's audit (vtaudit.py) --------------------------------------

def register_audit_check(n: int = 1) -> None:
    """Digest verifies the mirror completed against a store checkpoint
    (a beacon, or the in-process store's table under its lock)."""
    inc("volcano_audit_digest_checks_total", float(n))


def register_audit_divergence(n: int = 1) -> None:
    """Digest mismatches: in steady state this series stays at zero; any
    advance is the steady-state-divergence anomaly."""
    inc("volcano_audit_divergence_total", float(n))


def observe_beacon_lag(seconds: float) -> None:
    """The age of the beacon a verify consumed (its wall-clock stamp to
    the verify)."""
    observe("volcano_audit_beacon_lag_seconds", seconds)


# -- incremental scheduling (scheduler/delta/) ----------------------------------

def register_delta_micro_cycle(n: int = 1) -> None:
    """Micro snapshot builds: the dirty-set diff in place of the O(P) pod
    sweeps.  A cycle that then rebuilds full for contention still counts:
    the series counts builds, not published cycles."""
    inc("volcano_delta_micro_cycles_total", float(n))


def register_delta_fallback(reason: str) -> None:
    """Full snapshot builds while delta is on, by reason: arm / init /
    resync / node-add / node-remove / job-remove / job-requeue /
    job-dropped / dynamic / dirty-storm / contention."""
    inc("volcano_delta_full_fallbacks_total", reason=reason)


def register_delta_shed(n: int = 1) -> None:
    """Gangs newly shed to the Backlogged condition above the high
    watermark (a monotone counter: re-admission does not decrement it; the
    live depth is the cycle row's ``shed_gangs``)."""
    inc("volcano_delta_shed_gangs_total", float(n))


# -- store WAL durability series (store/wal.py) --------------------------------

def register_wal_append(n: int = 1) -> None:
    """Records appended to the store's write-ahead log (one a mutation
    request or op; a whole decision segment is ONE record)."""
    inc("volcano_store_wal_appended_records_total", float(n))


def register_wal_fsync(n: int = 1) -> None:
    """Group-commit fsyncs of the WAL tail, the ACK barrier; the ratio to
    the appended records shows how well group commit amortizes."""
    inc("volcano_store_wal_fsync_total", float(n))


def observe_wal_fsync(seconds: float) -> None:
    """Duration of one group-commit fsync: the ACK barrier's tail."""
    observe("volcano_store_wal_fsync_seconds", seconds)


def register_wal_recovery(n: int) -> None:
    """Records replayed from the WAL tail during crash recovery."""
    inc("volcano_store_wal_recovery_replayed_records_total", float(n))


# -- exposition ---------------------------------------------------------------

#: HELP strings of the exposition (the fallback is generated); one line each
_HELP: Dict[str, str] = {
    "volcano_e2e_scheduling_latency_milliseconds":
        "End-to-end scheduling cycle latency in milliseconds",
    "volcano_e2e_job_scheduling_latency_milliseconds":
        "Pod first-seen to bind-decision latency in milliseconds",
    "volcano_action_scheduling_latency_microseconds":
        "Per-action scheduling latency in microseconds",
    "volcano_plugin_scheduling_latency_microseconds":
        "Per-plugin callback latency in microseconds",
    "volcano_task_scheduling_latency_microseconds":
        "Per-task scheduling latency in microseconds",
    "volcano_schedule_attempts_total":
        "Schedule attempts by result",
    "volcano_residue_tasks_total":
        "Tasks routed to the host residue path, by reason class",
    "volcano_audit_digest_checks_total":
        "Mirror-vs-store digest verification passes completed",
    "volcano_audit_divergence_total":
        "State digest mismatches detected (steady state: zero)",
    "volcano_audit_beacon_lag_seconds":
        "Age of the digest beacon consumed by a verification pass",
    "volcano_store_wal_appended_records_total":
        "Records appended to the store write-ahead log",
    "volcano_store_wal_fsync_total":
        "Group-commit fsyncs of the WAL tail (the ACK barrier)",
    "volcano_store_wal_fsync_seconds":
        "Duration of one group-commit WAL fsync in seconds",
    "volcano_store_wal_recovery_replayed_records_total":
        "WAL records replayed during crash recovery",
    "volcano_decision_drain_batch_seconds":
        "Wall seconds one async-applier batch took to reach the store",
    "volcano_jit_compiles_total":
        "New kernel launch shapes, workspaces and library builds per kernel "
        "(steady state must stay flat)",
    "volcano_kernel_dispatch_total":
        "Jitted kernel dispatches per kernel",
    "volcano_prof_segment_seconds":
        "Per-cycle critical-path share by phase and segment",
    "volcano_kernel_device_seconds":
        "Per-cycle device seconds per kernel (CUDA events on the card)",
    "volcano_device_bytes":
        "Bytes held per component (memory watermark)",
    "volcano_prof_anomalies_total":
        "vtprof sentinel trips (steady-state recompiles, leaks) by kind",
    "volcano_delta_micro_cycles_total":
        "Micro-cycle snapshot builds (dirty-set diff, no full sweep)",
    "volcano_delta_full_fallbacks_total":
        "Full snapshot builds under delta mode, by trigger reason",
    "volcano_delta_shed_gangs_total":
        "Gangs shed to the Backlogged condition by admission control",
    _DROPPED_SERIES:
        "Observations dropped by the per-metric label-cardinality cap",
}


def _help_line(name: str, mtype: str) -> str:
    return _HELP.get(name, f"volcano-tpu {mtype} {name}")


def _fmt(labels) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _num(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.10g}"


def _le(le: float) -> str:
    return "+Inf" if math.isinf(le) else _num(le)


def expose_text() -> str:
    """The Prometheus text exposition of every recorded series."""
    with _mu:
        counters = sorted(_counters.items())
        gauges = sorted(_gauges.items())
        hists = sorted((k, HistogramSnapshot(h)) for k, h in _histograms.items())
    families: Dict[str, Tuple[str, list]] = {}
    for (name, labels), value in counters:
        families.setdefault(name, ("counter", []))[1].append((labels, value))
    for (name, labels), value in gauges:
        families.setdefault(name, ("gauge", []))[1].append((labels, value))
    for (name, labels), snap in hists:
        families.setdefault(name, ("histogram", []))[1].append((labels, snap))
    lines: List[str] = []
    for name in sorted(families):
        mtype, series = families[name]
        lines.append(f"# HELP {name} {_help_line(name, mtype)}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in series:
            if mtype != "histogram":
                lines.append(f"{name}{_fmt(labels)} {_num(value)}")
                continue
            for le, cum in value.buckets:
                lines.append(f"{name}_bucket{_fmt(labels + (('le', _le(le)),))} {cum}")
            lines.append(f"{name}_sum{_fmt(labels)} {_num(value.sum)}")
            lines.append(f"{name}_count{_fmt(labels)} {value.count}")
    return "\n".join(lines) + "\n"

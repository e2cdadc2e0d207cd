"""The port's ``loadgen/`` and cycle rows against the JAX package's.

* ``build_schedule``: the same arrivals (times, names, queues, per-pod
  resources, dwell) as the JAX function for the same spec, every seed;
  ``LoadGen`` submits the same objects into the port's store as the JAX
  generator into the JAX store; a resubmit after a partial failure
  creates nothing twice.
* ``saturation_search`` on the synthetic latency curve of
  ``tests/test_loadgen.py``: the same rates tried, the same verdict.
* The time-series recorder (the cases of ``tests/test_loadgen.py``):
  unarmed, no rows and no stats; armed, the port's cycle rows carry the
  JAX rows' fields and values on the same store (wall times aside); arming
  adds no phase; the object cycle's binds are counted from the bind log's
  watermark.
* An open-loop run at 250 gangs/s in lockstep (virtual time) through the
  port's Scheduler under ``delta: on`` on the CPU: sustained, every pod
  bound, micro cycles taken.  Nothing is asserted against the wall clock.

Tolerance: exact (schedules, objects, decisions, row fields).
"""

import time

import pytest
import torch

from volcano_tpu import timeseries as jts
from volcano_tpu.api import Resource as JResource
from volcano_tpu.api.objects import Metadata as JMetadata
from volcano_tpu.api.objects import Node as JNode
from volcano_tpu.api.objects import Queue as JQueue
from volcano_tpu.loadgen import LoadGen as JLoadGen
from volcano_tpu.loadgen import LoadSpec as JLoadSpec
from volcano_tpu.loadgen import build_schedule as jax_build_schedule
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import metrics as jmetrics
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch import timeseries as tts
from volcano_tpu_torch.loadgen import (
    LoadGen,
    LoadSpec,
    SLOReport,
    build_schedule,
    run_open_loop,
    saturation_search,
)
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import metrics as tmetrics
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store

from test_loadgen import _cycle_workload, _mk_store
from test_torch_object import port_conf, port_store

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (jmetrics, tmetrics):
        mod.reset()
    for mod in (jts, tts):
        mod.disarm()
    yield
    for mod in (jts, tts):
        mod.disarm()
    for mod in (jmetrics, tmetrics):
        mod.reset()


SPECS = [
    dict(qps=80, duration_s=1.0, seed=5, dwell_s=2.0),
    dict(qps=60, duration_s=0.5, seed=9),
    dict(qps=250, duration_s=1.0, seed=3, cpu_millis=(100,), mem_mb=(64,),
         gang_sizes=((1, 6.0), (2, 3.0)), namespace="sat"),
    dict(qps=40, duration_s=2.0, seed=11, queues=("qa", "qb", "default"), dwell_s=0.4),
]


@pytest.mark.parametrize("kw", SPECS)
def test_schedule_equals_jax_per_seed(kw):
    got = build_schedule(LoadSpec(**kw))
    want = jax_build_schedule(JLoadSpec(**kw))
    assert [tuple(vars(a).values()) for a in got] == [tuple(vars(a).values()) for a in want]
    assert len(got) > 10
    assert got == build_schedule(LoadSpec(**kw))
    assert all(a.t <= b.t for a, b in zip(got, got[1:]))


def _objects(store):
    pods = sorted((p.meta.key, p.spec.resources.milli_cpu, p.spec.resources.memory,
                   dict(p.meta.annotations)) for p in store.list("Pod"))
    groups = sorted((g.meta.key, g.min_member, g.queue, g.status.phase.value)
                    for g in store.list("PodGroup"))
    return pods, groups


@pytest.mark.parametrize("kw", SPECS)
def test_generator_submits_the_jax_objects(kw):
    spec = LoadSpec(**kw)
    tstore, jstore = Store(), JStore()
    LoadGen(tstore, spec).submit_due(spec.duration_s)
    JLoadGen(jstore, JLoadSpec(**kw)).submit_due(spec.duration_s)
    assert _objects(tstore) == _objects(jstore)
    assert _objects(tstore)[0]


def test_resubmit_after_partial_failure_is_idempotent():
    spec = LoadSpec(qps=200, duration_s=0.05, seed=2)
    store = Store()
    gen = LoadGen(store, spec)
    arr = gen.due(1.0)[0]
    gen.submit(arr)
    n_pods = len(store.list("Pod"))
    gen._next -= 1  # the cursor as a failed submit leaves it
    del gen.gangs[arr.name]
    gen.submit(arr)
    assert len(store.list("Pod")) == n_pods
    with pytest.raises(ValueError, match="schedule order"):
        gen.submit(gen.schedule[-1])


def test_saturation_search_escalates_until_band_breach():
    calls = []

    def run_at(qps):
        calls.append(qps)
        # p99 grows with the rate and leaves the band at 40
        return SLOReport(qps=qps, duration_s=1.0, submitted_pods=10, bound_pods=10,
                         unbound_pods=0, p50_ms=qps, p99_ms=qps * 10, p999_ms=qps * 12,
                         max_ms=qps * 15, backlog_peak=0, departed_gangs=0, cycles=5,
                         wall_s=1.0, sustained=True)

    out = saturation_search(run_at, base_qps=10, band_p99_ms=350.0, max_doublings=4)
    assert calls == [10, 20, 40]
    assert (out.sustained_qps, out.breach_qps) == (20, 40)
    assert [r.qps for r in out.steps] == calls
    assert out.as_dict()["steps"][-1]["p99_ms"] == 400.0


def _pair(n_nodes=2):
    """The recorder cases' store and workload in both packages, with the
    default conf (tpu for JAX, cpu for the port)."""
    jstore = _mk_store(n_nodes=n_nodes)
    _cycle_workload(jstore)
    jc = jconf.default_conf("tpu")
    return (JScheduler(jstore, conf=jc), Scheduler(port_store(jstore), conf=port_conf(jc)))


_ROW_KEYS = ("path", "cycle", "binds", "backlog", "evictions", "residue_jobs")


def test_recorder_unarmed_records_nothing_armed_rows_equal_jax():
    jsched, tsched = _pair()
    tsched.run_once()
    assert tts.samples() == [] and tsched.fast_cycle.last_cycle_stats == {}
    jts.arm()
    rec = tts.arm()
    jsched, tsched = _pair()
    for _ in range(2):
        jsched.run_once()
        tsched.run_once()
    trows = [s for s in rec.samples() if s["kind"] == "cycle"]
    jrows = [s for s in jts.samples() if s["kind"] == "cycle"]
    assert len(trows) == len(jrows) == 2
    for tr, jr in zip(trows, jrows):
        assert {k: tr.get(k) for k in _ROW_KEYS} == {k: jr.get(k) for k in _ROW_KEYS}
        assert set(tr["phases"]) == set(jr["phases"])
        assert "mode" not in tr  # delta off: no engine fields
    first, second = trows
    assert first["path"] == "fast" and first["binds"] == 4 and first["backlog"] >= 4
    assert "drain" in first["phases"] and "publish" in first["phases"]
    assert second["cycle"] == first["cycle"] + 1 and second["binds"] == 0


def test_recorder_arming_leaves_phase_set_unchanged():
    def phases_with(armed):
        tts.disarm()
        if armed:
            tts.arm()
        _, tsched = _pair()
        tsched.run_once()
        tsched.run_once()
        return set(tsched.fast_cycle.phases)

    assert phases_with(armed=False) == phases_with(armed=True)


def test_object_cycle_binds_count_from_the_watermark():
    """Fast cycles append to the bind log too: an object cycle after them
    counts only its own binds."""
    rec = tts.arm()
    _, sched = _pair()
    sched.cache.bind_log.extend([("default/a", "n0"), ("default/b", "n0"), ("default/c", "n1")])
    sched.fast_cycle.last_cycle_stats = {"binds": 3, "backlog": 3, "evictions": 0,
                                         "residue_jobs": 0}
    sched._record_cycle(time.perf_counter(), "fast")
    sched.cache.bind_log.append(("default/d", "n1"))
    sched._record_cycle(time.perf_counter(), "object")
    rows = [s for s in rec.samples() if s["kind"] == "cycle"]
    assert [r["binds"] for r in rows] == [3, 1]


def test_lockstep_open_loop_250_gangs_per_second_through_delta():
    """tests/test_delta.py's saturation shape through the port's delta
    scheduler, lockstep: sustained, every pod bound, micro cycles taken,
    the latency samples in the reference series.  No wall-clock bound:
    the JAX twin of this case is the one that fails under load."""
    jstore = JStore()
    jstore.create("Queue", JQueue(meta=JMetadata(name="default", namespace=""), weight=1))
    for i in range(8):
        jstore.create("Node", JNode(meta=JMetadata(name=f"n{i}", namespace=""),
                                    allocatable=JResource(64000.0, 64.0 * (1 << 30),
                                                          max_task_num=500)))
    store = port_store(jstore)
    conf = tconf.full_conf("cpu")
    conf.delta, conf.delta_oracle = "on", True
    sched = Scheduler(store, conf=conf)
    spec = LoadSpec(qps=250, duration_s=1.0, seed=3, cpu_millis=(100,), mem_mb=(64,),
                    gang_sizes=((1, 6.0), (2, 3.0)), namespace="sat")
    report = run_open_loop(store, spec, sched.run_once, tick_s=0.05, settle_s=60.0)
    assert report.sustained, report.as_dict()
    assert report.bound_pods == report.submitted_pods > 200
    assert report.unbound_pods == 0 and report.p50_ms <= report.p99_ms <= report.p999_ms
    assert tmetrics.get_counter("volcano_delta_micro_cycles_total") > 0
    series = tmetrics.get_histogram("volcano_e2e_job_scheduling_latency_milliseconds")
    assert series.count == report.submitted_pods

"""The port's metrics registry against the JAX package's.

The same seeded sequence of ``observe`` / ``inc`` / ``set_gauge`` calls goes
into both registries (``volcano_tpu_torch/scheduler/metrics.py`` and
``volcano_tpu/scheduler/metrics.py``): the Prometheus text exposition must
be byte-equal, the quantiles equal and the cardinality guard must drop the
same series.  Then the same seeded clusters go through both Schedulers and
the scheduler's series (preemption attempts and victims, unschedulable
jobs and tasks, job retries, residue tasks) must be equal, durations by
their counts.
"""

import json
import math
import re

import numpy as np
import pytest
import torch

from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import metrics as jmetrics
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.metrics import MAX_BUCKETS, MAX_SERIES_PER_METRIC, SUBBUCKETS
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from test_torch_contention import preempt_spec, storm_spec
from test_torch_object import port_conf, port_store
from test_torch_residue import cfg5r_spec, jax_store

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


#: metric name -> the verb that records it (one type per family)
NAMES = {"volcano_a_seconds": "observe", "volcano_b_total": "inc", "volcano_c_gauge": "set_gauge",
         "volcano_action_scheduling_latency_microseconds": "observe",
         "volcano_job_retry_counts": "inc", "volcano_decision_drain_batch_seconds": "observe",
         "volcano_residue_tasks_total": "inc", "volcano_unschedule_job_count": "set_gauge"}


def _calls(seed, n=600):
    """A seeded call sequence: (verb, name, value, labels).  Values span the
    underflow bucket (zero, negatives, below 1e-9), exact decade
    boundaries, every decade and the +Inf-only overflow past 1e9."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        name = str(rng.choice(sorted(NAMES)))
        verb = NAMES[name]
        kind = int(rng.integers(0, 6))
        if kind == 0:
            value = float(rng.choice([0.0, -1.5, 1e-12, 1e-9]))
        elif kind == 1:
            value = float(10.0 ** int(rng.integers(-8, 9)))
        elif kind == 2:
            value = float(rng.choice([1e9, 3.7e12]))
        else:
            value = float(10.0 ** rng.uniform(-9, 9))
        labels = {}
        if rng.random() < 0.7:
            labels["job_id"] = f"default/j{int(rng.integers(0, 12))}"
        if rng.random() < 0.3:
            labels["action"] = str(rng.choice(["allocate", "preempt"]))
        out.append((verb, name, value, labels))
    return out


def _feed(mod, calls):
    for verb, name, value, labels in calls:
        getattr(mod, verb)(name, value, **labels)


@pytest.mark.parametrize("seed", range(4))
def test_exposition_is_byte_equal_to_jax(seed):
    calls = _calls(seed)
    _feed(metrics, calls)
    _feed(jmetrics, calls)
    text = metrics.expose_text()
    assert text == jmetrics.expose_text()
    assert "_bucket{" in text and 'le="+Inf"' in text


@pytest.mark.parametrize("seed", range(4))
def test_quantiles_equal_jax(seed):
    calls = [c for c in _calls(seed + 20) if c[0] == "observe"]
    _feed(metrics, calls)
    _feed(jmetrics, calls)
    series = {(name, tuple(sorted(labels.items()))) for _, name, _, labels in calls}
    assert series
    for name, labels in sorted(series):
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
            got = metrics.quantile(name, q, **dict(labels))
            want = jmetrics.quantile(name, q, **dict(labels))
            assert got == want, (name, labels, q)
        snap = metrics.get_histogram(name, **dict(labels))
        jsnap = jmetrics.get_histogram(name, **dict(labels))
        assert (snap.count, snap.buckets, list(snap)) == (jsnap.count, jsnap.buckets, list(jsnap))


def test_quantile_within_one_subbucket():
    h = metrics.Histogram()
    for i in range(1, 10001):
        h.observe(i / 1000.0)  # 1 ms .. 10 s uniform
    rel = 9.0 / SUBBUCKETS
    for q, exact in ((0.5, 5.0), (0.99, 9.9), (0.999, 9.99)):
        assert exact * (1 - 1e-9) <= h.quantile(q) <= exact * (1 + rel + 0.01)
    assert math.isinf(h.cumulative()[-1][0]) and h.cumulative()[-1][1] == 10000


def test_histogram_state_is_bounded_by_buckets():
    vals = [0.001 * (i % 97 + 1) for i in range(100)]
    small, big = metrics.Histogram(), metrics.Histogram()
    for v in vals:
        small.observe(v)
    for i in range(10 ** 5):
        big.observe(vals[i % 100])
    assert len(big.buckets) == len(small.buckets) <= MAX_BUCKETS
    assert big.count == 10 ** 5


@pytest.mark.parametrize("family", ["counter", "gauge", "histogram"])
def test_cardinality_guard_drops_the_same_series_as_jax(family):
    extra = 37
    for mod in (metrics, jmetrics):
        for i in range(MAX_SERIES_PER_METRIC + extra):
            job = f"default/job-{i:04d}"
            if family == "counter":
                mod.register_job_retry(job)
            elif family == "gauge":
                mod.update_unschedule_task_count(job, i)
            else:
                mod.observe("volcano_guarded_seconds", 0.1 * (i + 1), job=job)
        # an admitted series keeps counting after the cap
        mod.register_job_retry("default/job-0000")
    name = {"counter": "volcano_job_retry_counts", "gauge": "volcano_unschedule_task_count",
            "histogram": "volcano_guarded_seconds"}[family]
    assert metrics.get_counter("volcano_metrics_dropped_series_total", metric=name) == extra
    assert metrics.expose_text() == jmetrics.expose_text()
    want = 2 if family == "counter" else 1
    assert metrics.get_counter("volcano_job_retry_counts", job_id="default/job-0000") == want


def test_reset_and_empty_series():
    empty = metrics.get_histogram("volcano_never_observed_seconds")
    assert len(empty) == 0 and list(empty) == [] and not empty
    assert empty.quantile(0.99) == 0.0
    metrics.inc("volcano_x_total")
    metrics.reset()
    assert metrics.expose_text() == jmetrics.expose_text() == "\n"


# -- the scheduler's series ------------------------------------------------------

SCHEDULER_SERIES = ("volcano_total_preemption_attempts", "volcano_pod_preemption_victims",
                    "volcano_unschedule_job_count", "volcano_unschedule_task_count",
                    "volcano_job_retry_counts", "volcano_residue_tasks_total",
                    "volcano_schedule_attempts_total")
DURATIONS = ("volcano_e2e_scheduling_latency_milliseconds",
             "volcano_action_scheduling_latency_microseconds",
             "volcano_plugin_scheduling_latency_microseconds")
_LINE = re.compile(r"^([a-z0-9_]+)(\{[^}]*\})? (\S+)$")


def _series(text):
    """The scheduler's counters and gauges by value, its durations by
    their ``_count`` lines."""
    out = {}
    for line in text.splitlines():
        m = _LINE.match(line)
        if m is None:
            continue
        name, labels, value = m.groups()
        if name in SCHEDULER_SERIES:
            out[(name, labels)] = value
        elif name.endswith("_count") and name[:-len("_count")] in DURATIONS:
            out[(name, labels)] = value
    return out


def _unschedulable_spec():
    spec = {"queues": [{"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": {"cpu": "4", "memory": "8Gi", "pods": 10}}
                      for i in range(2)],
            "podgroups": [{"name": "big", "min_member": 3, "queue": "default",
                           "phase": "Inqueue"},
                          {"name": "ok", "min_member": 1, "queue": "default",
                           "phase": "Inqueue"}],
            "pods": [{"name": f"big-{t}", "group": "big",
                      "resources": {"cpu": "3", "memory": "1Gi"}} for t in range(3)]
            + [{"name": "ok-0", "group": "ok", "resources": {"cpu": "1", "memory": "1Gi"}}]}
    return spec


CASES = {
    "preempt": (preempt_spec, "auto", 2, False),
    "storm": (lambda: storm_spec(n_nodes=6, per_node=6, n_gangs=10), "auto", 2, False),
    "unschedulable": (_unschedulable_spec, "auto", 2, False),
    "residue": (lambda: cfg5r_spec(60, 30, 0.10, 12), "batch", 2, False),
    "object": (preempt_spec, "auto", 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_series_equal_jax(case):
    """The same seeded clusters through both Schedulers (the fast cycle, its
    object sub-cycle, and the object path with ``fast_path: off``): the
    scheduler's counters and gauges equal, durations equal in count."""
    build, solve_mode, cycles, object_path = CASES[case]
    spec = build()
    js = jax_store(spec)
    ts = port_store(js)
    jc = jconf.full_conf("tpu")
    jc.solve_mode = solve_mode
    jc.exact_topk = True
    if object_path:
        jc.fast_path = "off"
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=port_conf(jc))
    for _ in range(cycles):
        jsched.run_once()
        tsched.run_once()
    assert tsched.last_path == ("object" if object_path else "fast")
    got, want = _series(metrics.expose_text()), _series(jmetrics.expose_text())
    assert got == want
    assert any(k[0] == "volcano_action_scheduling_latency_microseconds_count" for k in got)
    if case in ("preempt", "storm", "object"):
        assert ("volcano_total_preemption_attempts", None) in got
    if case == "unschedulable":
        assert got[("volcano_unschedule_job_count", None)] == "1"
    if case == "residue":
        assert any(k[0] == "volcano_residue_tasks_total" for k in got)


def test_metrics_endpoint_serves_reference_series():
    """``/metrics`` of the port's MetricsServer after a cycle serves the
    reference's cycle and action series, as the JAX server does for the
    same store, ``/healthz`` answers ok, and ``/debug/digest`` serves the
    scheduler mirror's state digest view; a process without a mirror
    answers as the JAX one does."""
    import urllib.request

    from helpers import build_node, build_pod, build_podgroup, make_store
    from volcano_tpu.scheduler.metrics_server import MetricsServer as JMetricsServer
    from volcano_tpu_torch.scheduler.metrics_server import MetricsServer

    jstore = make_store(nodes=[build_node("n1")], podgroups=[build_podgroup("pg", min_member=1)],
                        pods=[build_pod("p0", group="pg")])
    store = port_store(jstore)
    jc = jconf.default_conf()
    JScheduler(jstore, conf=jc).run_once()
    sched = Scheduler(store, conf=port_conf(jc))
    sched.run_once()
    from volcano_tpu import vtaudit as jvtaudit

    jvtaudit.set_debug_source(None)  # an earlier test's JAX mirror
    bodies, digests = [], []
    for cls in (JMetricsServer, MetricsServer):
        srv = cls(port=0).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                bodies.append(r.read().decode())
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                assert r.read() == b"ok\n"
            with urllib.request.urlopen(base + "/debug/digest", timeout=10) as r:
                digests.append(json.loads(r.read()))
        finally:
            srv.stop()
    jdig, dig = digests
    assert dig["enabled"] and dig["source"] == "mirror", dig
    assert dig == json.loads(json.dumps(sched.fast_cycle.mirror._audit_debug()))
    assert {"Pod", "Node", "PodGroup", "Queue"} <= set(dig["digest"]["kinds"]), dig
    from volcano_tpu_torch import vtaudit

    vtaudit.set_debug_source(None)
    assert vtaudit.debug_payload() == jdig, jdig
    for body in bodies:
        assert "volcano_e2e_scheduling_latency_milliseconds" in body
        assert "volcano_action_scheduling_latency_microseconds" in body


def test_profiler_hook_traces_each_cycle(tmp_path, monkeypatch):
    """``VOLCANO_TPU_PROFILE`` wraps every cycle in a ``torch.profiler``
    trace in a directory of its own (``cycle-NNNNNN``; back-to-back cycles
    in one second do not clobber each other), as the JAX scheduler's JAX
    profiler hook does on the same store."""
    import os

    from volcano_tpu.api import Resource as JResource
    from volcano_tpu.api.objects import Metadata as JMetadata
    from volcano_tpu.api.objects import Node as JNode
    from volcano_tpu.api.objects import Queue as JQueue
    from volcano_tpu.store import Store as JStore
    from volcano_tpu_torch.scheduler.conf import full_conf

    jstore = JStore()
    jstore.create("Queue", JQueue(meta=JMetadata(name="default", namespace=""), weight=1))
    jstore.create("Node", JNode(meta=JMetadata(name="n0", namespace=""),
                                allocatable=JResource.from_resource_list(
                                    {"cpu": "4", "memory": "8Gi", "pods": 110})))
    store = port_store(jstore)
    dirs = {}
    for name, sched in (("jax", JScheduler(jstore, conf=jconf.full_conf("tpu"))),
                        ("torch", Scheduler(store, conf=full_conf("cpu")))):
        monkeypatch.setenv("VOLCANO_TPU_PROFILE", str(tmp_path / name))
        sched.run_once()
        sched.run_once()  # back to back, in the same wall-clock second
        dirs[name] = sorted(os.listdir(tmp_path / name))
        for d in dirs[name]:
            files = [f for _, _, fs in os.walk(tmp_path / name / d) for f in fs]
            assert files, d
    assert dirs["torch"] == dirs["jax"] == ["cycle-000000", "cycle-000001"]
    with open(tmp_path / "torch" / "cycle-000000" / "trace.json") as f:
        assert "traceEvents" in json.load(f)

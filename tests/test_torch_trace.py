"""The port's span runtime and flight recorder (``volcano_tpu_torch/trace.py``)
against the JAX package's (``volcano_tpu/trace.py``): the port counterparts
of the ``tests/test_trace.py`` cases that need no store server, daemon or
CLI.

Each case runs the same calls, or the same store through both schedulers
(the JAX store copied uid for uid into the port's with
``test_torch_object.port_store``), and holds both packages to one
contract: span ids, nesting, explicit joins and links and their
reconstruction; the bounded ring; arming from the environment; the header
round trip; the crash dump; a disarmed cycle touching no span runtime and
an armed one placing every pod alike; ``/debug/trace`` on the metrics
server; the statement spans of a preempt storm inside its action span; and
the first-seen-to-bind latency series recorded at the bind spans.
"""

import json
import urllib.request

import pytest
import torch

from volcano_tpu import trace as jtrace
from volcano_tpu.api.objects import Metadata as JMetadata
from volcano_tpu.api.objects import PriorityClass as JPriorityClass
from volcano_tpu.api.types import PodPhase as JPodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import metrics as jmetrics
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch import trace
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.metrics_server import MetricsServer
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from helpers import build_node, build_pod, build_podgroup, make_store
from test_torch_object import port_conf, port_store
from test_torch_vtprof import Pair

torch.set_num_threads(1)

MODS = (jtrace, trace)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    for mod in (metrics, jmetrics):
        mod.reset()
    yield
    for mod in (metrics, jmetrics):
        mod.reset()


@pytest.fixture
def armed():
    trs = tuple(mod.arm(mod.Tracer(ring=8192)) for mod in MODS)
    try:
        yield trs
    finally:
        for mod in MODS:
            mod.disarm()


def _shape(recs):
    """Records without their ids and clocks: name, attrs, and the parent's
    index among the records (or None)."""
    index = {r["span"]: i for i, r in enumerate(recs)}
    return [(r["name"], r["attrs"], index.get(r["parent"]), len(r["links"])) for r in recs]


# -- the span runtime ----------------------------------------------------------------


def test_span_nesting_and_ids(armed):
    for mod, tr in zip(MODS, armed):
        with mod.span("outer", kind="test") as outer:
            assert mod.current() == (outer.trace_id, outer.span_id)
            with mod.span("inner") as inner:
                assert inner.trace_id == outer.trace_id
                assert inner.parent_id == outer.span_id
        assert mod.current() == ("", "")
        recs = tr.records()
        assert [r["name"] for r in recs] == ["inner", "outer"]  # exit order
        assert recs[0]["parent"] == recs[1]["span"] and recs[1]["parent"] == ""
        assert recs[1]["attrs"] == {"kind": "test"}
    assert _shape(armed[1].records()) == _shape(armed[0].records())


def test_explicit_trace_join_and_link_reconstruction(armed):
    trees = []
    for mod, tr in zip(MODS, armed):
        with mod.span("gang.root") as root:
            gang = root.trace_id
        # a cycle in its own trace links the gang; its children stay in
        # the cycle's trace and reconstruct from the gang's id
        with mod.span("cycle") as cyc:
            cyc.link(gang)
            with mod.span("action", action="allocate"):
                pass
        with mod.span("bind", trace_id=gang):
            pass
        sel = mod.spans_for_trace(tr.records(), gang)
        assert sorted(r["name"] for r in sel) == ["action", "bind", "cycle", "gang.root"]
        tree = mod.render_tree(tr.records(), gang)
        assert tree.count("~linked") == 1
        trees.append([ln.split()[0] for ln in tree.splitlines()[1:]])
        assert mod.latest_trace(tr.records()) == gang
        assert mod.trace_ids(tr.records())[0] == gang
    assert trees[1] == trees[0]


def test_span_records_error_attr(armed):
    for mod, tr in zip(MODS, armed):
        with pytest.raises(ValueError):
            with mod.span("boom"):
                raise ValueError("x")
        (rec,) = tr.records()
        assert rec["attrs"]["error"] == "ValueError"
        assert mod.current() == ("", "")  # the context unwound


def test_ring_is_bounded():
    for mod in MODS:
        tr = mod.arm(mod.Tracer(ring=8))
        try:
            for i in range(20):
                with mod.span(f"s{i}"):
                    pass
            assert [r["name"] for r in tr.records()] == [f"s{i}" for i in range(12, 20)]
        finally:
            mod.disarm()


def test_env_parsing():
    for mod in MODS:
        assert mod.ENV_VAR == "VOLCANO_TPU_TRACE"
        for off in ("", "0", "off"):
            assert mod._tracer_from_env(off) is None
        assert mod._tracer_from_env("1").ring_size == mod.DEFAULT_RING == jtrace.DEFAULT_RING
        tr = mod._tracer_from_env('{"ring": 16, "dir": "/tmp/x"}')
        assert tr.ring_size == 16 and tr.dump_dir == "/tmp/x"


def test_header_roundtrip():
    for mod in MODS:
        assert mod.HEADER == jtrace.HEADER and mod.TRACE_ID_KEY == jtrace.TRACE_ID_KEY
        assert mod.parse_header(mod.format_header("t-1", "s-2")) == ("t-1", "s-2")
        assert mod.parse_header("") == ("", "")
        assert mod.parse_header("t-only") == ("t-only", "")


def test_crash_dump_artifact(tmp_path, armed):
    dumps = []
    for mod, tr in zip(MODS, armed):
        tr.dump_dir = str(tmp_path / mod.__name__)
        with mod.span("pre-crash"):
            pass
        path = mod.crash_dump("unit")
        assert path is not None
        with open(path) as f:
            dumps.append(json.load(f))
        mod.disarm()
        assert mod.crash_dump("disarmed") is None
    for data in dumps:
        assert data["reason"] == "unit"
        assert [s["name"] for s in data["spans"]] == ["pre-crash"]
    assert set(dumps[1]) <= set(dumps[0]) | {"timeseries", "anomalies", "profile"}


# -- the arming discipline -------------------------------------------------------------


def test_disarmed_cycles_touch_span_runtime_zero_times(monkeypatch):
    """Disarmed, a gang's whole cycle (snapshot, solve, bind) constructs no
    Span and records nothing, in both packages."""
    def explode(*a, **kw):
        raise AssertionError("span runtime touched while disarmed")

    for mod in MODS:
        assert mod.TRACER is None
        monkeypatch.setattr(mod, "Span", explode)
        monkeypatch.setattr(mod.Tracer, "record", explode)
    pair = Pair(full=True)
    pair.gang("quiet", 2)
    pair.cycle()
    pair.cycle()
    jp, tp = pair.placements()
    assert jp == tp and all(n for _, n in tp)


def test_armed_run_is_placement_neutral_and_phase_set_unchanged():
    """Armed and disarmed runs place every pod alike and the fast cycle's
    phase breakdown gains no phase from tracing; the port's equal JAX's."""
    known = {"drain", "snapshot", "enqueue", "reclaim", "solve", "backfill", "dyn_solve",
             "preempt", "publish", "publish_build", "publish_ship", "subcycle"}

    def run(arm):
        if arm:
            for mod in MODS:
                mod.arm(mod.Tracer())
        try:
            pair = Pair(full=True)
            for i in range(3):
                pair.gang(f"j{i}", 2, cpu=1000.0)
                pair.cycle()
            return pair.placements(), (set(pair.jsched.fast_cycle.phases or {}),
                                       set(pair.sched.fast_cycle.phases or {}))
        finally:
            for mod in MODS:
                mod.disarm()

    (base_j, base_t), (ph_j, ph_t) = run(False)
    (arm_j, arm_t), (aph_j, aph_t) = run(True)
    assert base_t == base_j and arm_t == base_t and arm_j == base_j
    assert aph_t == ph_t == ph_j == aph_j and aph_t <= known


def test_metrics_server_serves_debug_trace(armed):
    with trace.span("daemon.work"):
        pass
    srv = MetricsServer(port=0).start()
    try:
        payload = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/debug/trace", timeout=10))
        assert payload["armed"]
        assert any(s["name"] == "daemon.work" for s in payload["spans"])
        assert set(jtrace.debug_payload()) == set(payload)
    finally:
        srv.stop()


# -- the cycle's span tree ---------------------------------------------------------------


def test_statement_commit_span_in_preempt_storm(armed):
    """A preempt storm's Statement settlement records ``statement.commit``
    spans nested in the cycle's preempt action span, in both packages."""
    pg_low = build_podgroup("pg-low", min_member=1)
    pg_low.priority_class_name = "low-pri"
    pg_high = build_podgroup("pg-high", min_member=1)
    pg_high.priority_class_name = "high-pri"
    jstore = make_store(
        nodes=[build_node("n0", cpu="2", memory="4Gi")],
        podgroups=[pg_low, pg_high],
        pods=[build_pod("low-0", group="pg-low", cpu="1", phase=JPodPhase.RUNNING,
                        node_name="n0", priority=1),
              build_pod("low-1", group="pg-low", cpu="1", phase=JPodPhase.RUNNING,
                        node_name="n0", priority=1),
              build_pod("high-0", group="pg-high", cpu="1", priority=100)],
    )
    jstore.create("PriorityClass", JPriorityClass(JMetadata(name="low-pri", namespace=""),
                                                  value=1))
    jstore.create("PriorityClass", JPriorityClass(JMetadata(name="high-pri", namespace=""),
                                                  value=100))
    store = port_store(jstore)
    jc = jconf.default_conf()
    jc.actions = ["preempt"]
    JScheduler(jstore, conf=jc).run_once()
    Scheduler(store, conf=port_conf(jc)).run_once()
    shapes = []
    for tr in armed:
        recs = tr.records()
        commits = [r for r in recs if r["name"] == "statement.commit"]
        assert commits, [r["name"] for r in recs]
        assert commits[0]["attrs"]["ops"] >= 1
        parent = {r["span"]: r for r in recs}[commits[0]["parent"]]
        assert parent["name"] == "action" and parent["attrs"]["action"] == "preempt"
        # a declined fast-cycle attempt records its own span (completed:
        # False) where a package builds a fast cycle for this conf
        shapes.append(sorted((r["name"], r["attrs"].get("action", ""),
                              r["attrs"].get("plugin", ""), r["attrs"].get("ops", 0))
                             for r in recs if r["attrs"].get("completed", True)))
    assert shapes[1] == shapes[0]
    assert sorted(p.meta.key for p in store.list("Pod") if p.deleting) == \
        sorted(p.meta.key for p in jstore.list("Pod") if p.deleting)


def test_pod_e2e_latency_metric_exposition_and_monotonicity(armed):
    """The reference's first-seen-to-bind series, recorded at the bind
    decisions while the tracer is armed: the histogram's exposition lines
    and its monotone count and sum, equal in count to the JAX package's."""
    pair = Pair(full=True)
    pair.gang("m1", 2)
    pair.cycle()
    name = "volcano_e2e_job_scheduling_latency_milliseconds"
    snaps = [mod.get_histogram(name) for mod in (jmetrics, metrics)]
    assert len(snaps[1]) == len(snaps[0]) == 2 and all(v >= 0 for v in snaps[1])
    text = metrics.expose_text()
    assert f"{name}_count 2" in text and f"{name}_sum" in text
    assert f'{name}_bucket{{le="+Inf"}} 2' in text
    assert f"# TYPE {name} histogram" in text
    pair.gang("m2", 1)
    pair.cycle()
    snap2 = metrics.get_histogram(name)
    assert len(snap2) == len(jmetrics.get_histogram(name)) == 3
    assert snap2.sum >= snaps[1].sum
    before, after = dict(snaps[1].buckets), dict(snap2.buckets)
    assert all(after.get(le, 0) >= c for le, c in before.items())
    assert f"{name}_count 3" in metrics.expose_text()
    binds = [r for r in armed[1].records() if r["name"] == "scheduler.bind"]
    assert binds == []  # no gang carries a trace id: no bind span

"""The port's critical-path profiler (``volcano_tpu_torch/vtprof.py``)
against the JAX package's (``volcano_tpu/vtprof.py``): the port
counterparts of ``tests/test_vtprof.py``.

Each case runs the JAX case and the port's on the same store (the JAX
store built here and copied uid for uid with ``test_torch_object.port_store``)
or on the same sequence of profiler calls, and holds the two to the same
contract:

* the arming discipline: disarmed cycles construct no Profiler, and an
  armed run places every pod where a disarmed one does, with the fast
  cycle's phase set unchanged (and equal to the JAX run's);
* attribution: at least 95% of the sampled cycle wall in named segments,
  the per-kernel device totals equal to the per-phase device segments, the
  dispatch series and the memory watermark gauges exposed;
* the fetch boundary's wait / transfer annotations on the device span;
* the launch-shape sentinel (the port's counterpart of the compile
  sentinel): a steady trickle after the warmup handshake adds nothing to
  ``volcano_jit_compiles_total``, and a bucket-breaking gang adds exactly
  one for ``allocate_solve`` and trips exactly one anomaly, in both;
* the leak sentinel's three cases, the crash dump's sections,
  ``report_text``, ``/debug/prof`` on the metrics server, and the warmup
  handshake deferred behind a background prewarm.
"""

import json
import time
import urllib.request

import jax
import pytest
import torch

from volcano_tpu import timeseries as jtimeseries
from volcano_tpu import trace as jtrace
from volcano_tpu import vtprof as jvtprof
from volcano_tpu.api import POD_GROUP_KEY as J_POD_GROUP_KEY
from volcano_tpu.api import Resource as JResource
from volcano_tpu.api import objects as jobj
from volcano_tpu.api.types import PodGroupPhase as JPodGroupPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import metrics as jmetrics
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch import timeseries, trace, vtprof
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import kernels, metrics, victim_kernels
from volcano_tpu_torch.scheduler.metrics_server import MetricsServer
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from test_torch_object import port_store

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jit_caches():
    """Run this file from an empty JAX compile cache and leave one behind:
    its sentinel cases and the JAX package's own count compiles of the
    same bucket shapes, whichever file ran first in the process."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean():
    for mod in (metrics, jmetrics):
        mod.reset()
    for mod in (vtprof, jvtprof, timeseries, jtimeseries, trace, jtrace):
        mod.disarm()
    yield
    for mod in (vtprof, jvtprof, timeseries, jtimeseries, trace, jtrace):
        mod.disarm()
    for mod in (metrics, jmetrics):
        mod.reset()


def _jax_store(n_nodes=4, cpu=8000.0):
    store = JStore()
    store.create("Queue", jobj.Queue(meta=jobj.Metadata(name="default", namespace=""), weight=1))
    for i in range(n_nodes):
        store.create("Node", jobj.Node(
            meta=jobj.Metadata(name=f"n{i:03d}", namespace=""),
            allocatable=JResource(cpu, 16.0 * (1 << 30), max_task_num=200)))
    return store


def _jax_gang(store, name, n_pods, cpu=100.0):
    pg = jobj.PodGroup(meta=jobj.Metadata(name=name, namespace="default"),
                       min_member=n_pods, queue="default")
    pg.status.phase = JPodGroupPhase.INQUEUE  # default_conf has no enqueue
    store.create("PodGroup", pg)
    for t in range(n_pods):
        store.create("Pod", jobj.Pod(
            meta=jobj.Metadata(name=f"{name}-{t}", namespace="default",
                               annotations={J_POD_GROUP_KEY: name}),
            spec=jobj.PodSpec(image="x", resources=JResource(cpu, 1 << 20))))


class Pair:
    """One scenario on both packages: JAX objects are created in the JAX
    store and copied (uids kept) into the port's store, so both schedulers
    see the same store."""

    def __init__(self, n_nodes=4, full=False):
        self.jstore = _jax_store(n_nodes)
        self.store = port_store(self.jstore)
        self.jsched = JScheduler(self.jstore, conf=(jconf.full_conf if full else
                                                    jconf.default_conf)("tpu"))
        self.sched = Scheduler(self.store, conf=(tconf.full_conf if full else
                                                 tconf.default_conf)("cpu"))

    def _copy_new(self):
        have = {(k, o.meta.key) for k in ("PodGroup", "Pod", "Node") for o in self.store.list(k)}
        fresh = JStore()
        for kind in ("Node", "PodGroup", "Pod"):
            for o in self.jstore.list(kind):
                if (kind, o.meta.key) not in have:
                    fresh.create(kind, o)
        for kind in ("Node", "PodGroup", "Pod"):
            for o in port_store(fresh).list(kind):
                self.store.create(kind, o)

    def gang(self, name, n_pods, cpu=100.0):
        _jax_gang(self.jstore, name, n_pods, cpu)
        self._copy_new()

    def node(self, name):
        self.jstore.create("Node", jobj.Node(
            meta=jobj.Metadata(name=name, namespace=""),
            allocatable=JResource(8000.0, 16.0 * (1 << 30), max_task_num=200)))
        self._copy_new()

    def cycle(self):
        self.jsched.run_once()
        self.sched.run_once()

    def placements(self):
        return (sorted((p.meta.key, p.node_name) for p in self.jstore.list("Pod")),
                sorted((p.meta.key, p.node_name) for p in self.store.list("Pod")))


def _port_store_of(n_nodes=4):
    return port_store(_jax_store(n_nodes))


# -- the arming discipline -----------------------------------------------------


def test_disarmed_lifecycle_constructs_zero_profiler_objects(monkeypatch):
    """Disarmed, full fast cycles (through the fetch boundaries) construct
    no Profiler and record nothing, in both packages; the port's wrappers
    build no launch key and register no shape."""
    def explode(*a, **kw):
        raise AssertionError("profiler runtime touched while disarmed")

    for mod in (vtprof, jvtprof):
        assert mod.PROFILER is None
        monkeypatch.setattr(mod, "Profiler", explode)
    for mod in (kernels, victim_kernels):
        monkeypatch.setattr(mod, "_launch_key", explode)
    registry = vtprof.registry_cache_sizes()
    pair = Pair()
    pair.gang("quiet", 3)
    pair.cycle()
    pair.cycle()
    jp, tp = pair.placements()
    assert jp == tp
    assert sum(1 for _, n in tp if n) == 3
    assert vtprof.registry_cache_sizes() == registry


def test_armed_run_is_placement_neutral_and_phase_set_unchanged():
    """Armed and disarmed runs place every pod alike, and profiling adds no
    phase to the fast cycle's breakdown; the port's equal the JAX run's."""
    def run(arm):
        if arm:
            vtprof.arm()
            jvtprof.arm()
        try:
            pair = Pair()
            for i in range(3):
                pair.gang(f"j{i}", 2)
                pair.cycle()
            pair.cycle()
            return pair.placements(), (set(pair.jsched.fast_cycle.phases or {}),
                                       set(pair.sched.fast_cycle.phases or {}))
        finally:
            vtprof.disarm()
            jvtprof.disarm()

    (base_j, base_t), (ph_j, ph_t) = run(False)
    (arm_j, arm_t), (aph_j, aph_t) = run(True)
    assert base_t == base_j and arm_t == base_t and arm_j == base_j
    assert aph_t == ph_t == ph_j == aph_j


# -- attribution ---------------------------------------------------------------


def _attributed_run(mod, sched_cls, conf, store_of, gang):
    mod.disarm()
    prof = mod.arm()
    store = store_of()
    sched = sched_cls(store, conf=conf)
    for i in range(4):
        gang(store, f"g{i}")
        sched.run_once()
    payload = prof.payload()
    return payload, mod.attribution(payload)


def _check_attribution(payload, att):
    assert payload["cycles"], "no cycles sampled"
    assert att["coverage"] >= 0.95, att
    assert set(att["segments"]) == {"host", "dispatch", "wait", "transfer"}
    kernel_dev = sum(kc.get("dispatch_s", 0.0) + kc.get("wait_s", 0.0)
                     + kc.get("transfer_s", 0.0)
                     for cyc in payload["cycles"] for kc in cyc["kernels"].values())
    phase_dev = (att["segments"]["dispatch"] + att["segments"]["wait"]
                 + att["segments"]["transfer"])
    # per_phase rows are rounded to 1e-6 in the cycle records
    assert kernel_dev == pytest.approx(phase_dev, rel=1e-3, abs=1e-4)


def test_armed_profile_attributes_95pct_and_kernel_totals_consistent():
    """At least 95% of the sampled cycle wall in named segments (the best
    of two runs, as the JAX test takes), the two groupings of the device
    records equal, the dispatch counter and every watermark gauge exposed:
    in both packages on the same gangs."""
    def jgang(store, name):
        _jax_gang(store, name, 60, cpu=10.0)

    def tgang(store, name):
        fresh = JStore()
        _jax_gang(fresh, name, 60, cpu=10.0)
        for kind in ("PodGroup", "Pod"):
            for o in port_store(fresh).list(kind):
                store.create(kind, o)

    for mod, cls, conf, store_of, gang, mets in (
            (jvtprof, JScheduler, jconf.default_conf("tpu"), lambda: _jax_store(6), jgang,
             jmetrics),
            (vtprof, Scheduler, tconf.default_conf("cpu"), lambda: _port_store_of(6), tgang,
             metrics)):
        payload, att = _attributed_run(mod, cls, conf, store_of, gang)
        if att["coverage"] < 0.95:
            payload, att = _attributed_run(mod, cls, conf, store_of, gang)
        _check_attribution(payload, att)
        assert mets.get_counter("volcano_kernel_dispatch_total", kernel="allocate_solve") > 0
        text = mets.expose_text()
        for component in ("mirror", "snapshot", "solve_out", "device"):
            assert f'volcano_device_bytes{{component="{component}"}}' in text
        mod.disarm()


def test_fetch_boundary_annotates_trace_span():
    """The fetch boundary's wait / transfer split rides the device span as
    annotations when both layers are armed, in both packages."""
    trs = (trace.arm(), jtrace.arm())
    vtprof.arm()
    jvtprof.arm()
    pair = Pair()
    pair.gang("sp", 2)
    pair.cycle()
    for tr in trs:
        spans = [r for r in tr.records() if r["name"] == "device.allocate_solve"]
        assert spans, "no device span recorded"
        assert "wait_s" in spans[-1]["attrs"] and "transfer_s" in spans[-1]["attrs"]


# -- the launch-shape sentinel ---------------------------------------------------


def test_steady_state_trickle_never_grows_and_bucket_break_fires():
    """Twenty trickle cycles after the warmup handshake (1-3 pending tasks
    a cycle within the smallest task bucket, a node joining mid-stream
    inside the node bucket) add nothing to ``volcano_jit_compiles_total``;
    a 9-pod gang leaves the bucket and adds exactly one, for
    ``allocate_solve``, and trips exactly one steady-state-recompile
    anomaly: in the JAX package (an XLA compile) and in the port (a new
    launch shape)."""
    profs = (jvtprof.arm(), vtprof.arm())
    mets = (jmetrics, metrics)
    pair = Pair(n_nodes=10)
    # 40 jobs: the job bucket (64) holds the whole trickle
    for i in range(40):
        pair.gang(f"w{i:03d}", 1)
    pair.cycle()
    for i in range(2):  # the trickle's own shape, before the handshake
        pair.gang(f"t{i:03d}", 1)
        pair.cycle()
    for p in profs:
        p.warmup_handshake()
    pair.cycle()  # the first cycle without growth: steady
    before = [p.compiles_total for p in profs]
    counters = [m.get_counter("volcano_jit_compiles_total", kernel="allocate_solve")
                for m in mets]
    for p in profs:
        assert p.steady
    for i in range(20):
        pair.gang(f"k{i:03d}", 1 + (i % 3), cpu=10.0)
        if i == 10:
            pair.node("n-late")
        pair.cycle()
    for p, b, m, c in zip(profs, before, mets, counters):
        assert p.compiles_total == b, p._cache_seen
        assert m.get_counter("volcano_jit_compiles_total", kernel="allocate_solve") == c
        assert p.anomalies_snapshot() == []
    pair.gang("breaker", 9, cpu=10.0)
    pair.cycle()
    for p, b, m, c in zip(profs, before, mets, counters):
        assert p.compiles_total == b + 1
        assert m.get_counter("volcano_jit_compiles_total", kernel="allocate_solve") == c + 1
        (a,) = p.anomalies_snapshot()
        assert a["kind"] == "steady-state-recompile" and "allocate_solve" in a["kernels"]
    jp, tp = pair.placements()
    assert jp == tp and all(n for _, n in tp)


# -- the leak sentinel ---------------------------------------------------------------


def test_leak_sentinel_quiet_under_loadgen_churn():
    """An open-loop load with dwell departures holds the device watermark
    bounded: no leak trip over two windows of cycles (the port's loadgen
    against the JAX one, lockstep virtual time)."""
    from volcano_tpu.loadgen import LoadSpec as JLoadSpec
    from volcano_tpu.loadgen import run_open_loop as j_run_open_loop
    from volcano_tpu_torch.loadgen import LoadSpec, run_open_loop

    for mod, spec_cls, run, store_of, sched_of in (
            (jvtprof, JLoadSpec, j_run_open_loop, lambda: _jax_store(6),
             lambda s: JScheduler(s, conf=jconf.full_conf("tpu"))),
            (vtprof, LoadSpec, run_open_loop, lambda: _port_store_of(6),
             lambda s: Scheduler(s, conf=tconf.full_conf("cpu")))):
        prof = mod.arm()
        store = store_of()
        sched = sched_of(store)
        spec = spec_cls(qps=30, duration_s=2.0, seed=3, cpu_millis=(100,), mem_mb=(64,),
                        dwell_s=0.4)
        report = run(store, spec, sched.run_once, settle_s=20.0, tick_s=0.05)
        assert report.bound_pods == report.submitted_pods
        assert len(prof.payload()["cycles"]) >= 2 * mod.LEAK_WINDOW
        assert [a for a in prof.anomalies_snapshot() if a["kind"] == "device-bytes-leak"] == []
        mod.disarm()


def _leak_run(mod, monkeypatch, series, ring=None, cycles=3):
    it = iter(series)
    monkeypatch.setattr(mod, "_live_device_bytes", lambda: next(it))
    prof = mod.Profiler(**({"ring": ring} if ring else {}))
    for _ in range(cycles):
        prof.begin_cycle()
        prof.end_cycle(0.001, {}, "fast")
    return [a for a in prof.anomalies_snapshot() if a["kind"] == "device-bytes-leak"]


def test_leak_sentinel_trips_once_on_synthetic_ramp(monkeypatch):
    """A +64 MiB a cycle ramp trips the sentinel once, with the same trip
    record in both packages."""
    trips = [_leak_run(mod, monkeypatch, (i * (64 << 20) for i in range(1, 200)),
                       cycles=3 * mod.LEAK_WINDOW) for mod in (jvtprof, vtprof)]
    assert len(trips[1]) == 1 and trips[1][0]["recent_bytes"] > trips[1][0]["baseline_bytes"]
    assert trips[1] == trips[0]


def test_leak_sentinel_baseline_is_anchored_across_ring_wrap(monkeypatch):
    """The baseline is the first window's, captured once: a slow leak
    (+2 MiB a cycle on 256 MiB) still trips after the ring wraps, as in
    the JAX package."""
    trips = [_leak_run(mod, monkeypatch, ((256 << 20) + i * (2 << 20) for i in range(10_000)),
                       ring=4 * mod.LEAK_WINDOW, cycles=20 * mod.LEAK_WINDOW)
             for mod in (jvtprof, vtprof)]
    assert len(trips[1]) == 1 and trips[1][0]["baseline_bytes"] < (300 << 20)
    assert trips[1] == trips[0]


# -- the surfaces --------------------------------------------------------------------


def test_debug_prof_endpoint_on_the_metrics_server():
    """``/debug/prof`` serves the armed profile and the disarmed body."""
    prof = vtprof.arm()
    prof.begin_cycle()
    prof.record_fetch("allocate_solve", "solve", 0.01, 0.002)
    prof.end_cycle(0.05, {"solve": 0.04}, "fast")
    srv = MetricsServer(port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/debug/prof"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.load(r)
        assert body["armed"] is True and body["totals"]["allocate_solve"]["wait_s"] > 0
        vtprof.disarm()
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.load(r)
        assert body["armed"] is False and body["cycles"] == [] and body["totals"] == {}
    finally:
        srv.stop()


def test_crash_dump_carries_anomalies_and_profile(tmp_path):
    """The crash dump's ``anomalies`` and ``profile`` sections, with the
    same content in both packages."""
    dumps = []
    for tmod, pmod in ((jtrace, jvtprof), (trace, vtprof)):
        tmod.arm(tmod.Tracer(ring=64, dump_dir=str(tmp_path / tmod.__name__)))
        prof = pmod.arm()
        prof.begin_cycle()
        prof.end_cycle(0.01, {"solve": 0.01}, "fast")
        with prof._mu:
            prof.anomalies.append({"kind": "steady-state-recompile", "cycle": 7,
                                   "kernels": {"allocate_solve": 1}})
        with tmod.span("pre-crash"):
            pass
        with open(tmod.crash_dump("unit")) as f:
            dumps.append(json.load(f))
    for dump in dumps:
        assert dump["anomalies"][0]["kind"] == "steady-state-recompile"
        assert dump["profile"]["cycles"] == 1
        assert dump["profile"]["last_cycle"]["per_phase"]["solve"]
        assert [s["name"] for s in dump["spans"]] == ["pre-crash"]
    assert dumps[1]["anomalies"] == dumps[0]["anomalies"]
    assert dumps[1]["profile"]["last_cycle"]["per_phase"] == \
        dumps[0]["profile"]["last_cycle"]["per_phase"]


def test_report_text_renders_flame_rows_kernels_and_anomalies():
    """``report_text`` over the same calls: the same flame rows in both
    packages, the port's kernel rows with their device time beside them."""
    texts = []
    for mod in (jvtprof, vtprof):
        prof = mod.arm()
        prof.begin_cycle()
        if mod is vtprof:
            prof.note_dispatch("allocate_solve")
            prof.dispatch_end(time.perf_counter(), "allocate_solve", phase="solve")
        else:
            prof.dispatch_end(prof.dispatch_begin(lambda: None), "allocate_solve",
                              phase="solve")
        prof.record_fetch("allocate_solve", "solve", 0.02, 0.005)
        prof.note_bytes("snapshot", 3 << 20)
        prof.end_cycle(0.1, {"solve": 0.06, "publish": 0.03}, "fast")
        texts.append(mod.report_text(prof.payload()))
        mod.disarm()
        assert "no profile samples" in mod.report_text(mod.debug_payload())
    for text in texts:
        assert "vtprof: 1 cycle(s) sampled" in text
        assert "solve" in text and "publish" in text and "unattributed" in text
        assert "allocate_solve" in text and "dispatches=1" in text
        assert "snapshot=3.0MiB" in text and "anomalies: none" in text
    jrows = [ln for ln in texts[0].splitlines() if ln.startswith("  ") and "|" in ln]
    trows = [ln for ln in texts[1].splitlines() if ln.startswith("  ") and "|" in ln]
    assert [r.split()[0] for r in trows] == [r.split()[0] for r in jrows]
    assert "device=" in texts[1]


def test_cycle_rows_carry_the_device_host_split():
    """With the profiler and the recorder armed, each cycle row carries
    ``host_s`` / ``device_s`` / ``transfer_s`` and the anomaly events ride
    the ring as ``kind="anomaly"``, as in the JAX package."""
    recs = (jtimeseries.arm(), timeseries.arm())
    jvtprof.arm()
    vtprof.arm()
    pair = Pair()
    pair.gang("t0", 2)
    pair.cycle()
    for mod in (jtimeseries, timeseries):
        mod.record("anomaly", anomaly="steady-state-recompile", cycle=0,
                   kernels={"allocate_solve": 1})
    for rec in recs:
        rows = [s for s in rec.samples() if s["kind"] == "cycle"]
        assert rows and {"host_s", "device_s", "transfer_s"} <= set(rows[0])
        assert rows[0]["device_s"] >= 0 and rows[0]["host_s"] > 0
        assert [s["anomaly"] for s in rec.samples() if s["kind"] == "anomaly"] == \
            ["steady-state-recompile"]


def test_background_prewarm_defers_warmup_handshake():
    """With a background prewarm the handshake comes after the background
    warm finishes: its launches are warmup, never anomalies."""
    profs = (jvtprof.arm(), vtprof.arm())
    pair = Pair()
    pair.gang("w", 2)
    for sched in (pair.jsched, pair.sched):
        sched.prewarm(background=True)
        if sched.prewarm_background is not None:
            sched.prewarm_background.join()
    for p in profs:
        assert p._warmed
        assert p.anomalies_snapshot() == []


def test_registry_counts_workspaces_and_builds():
    """Armed, the launch-shape registry counts a new shape once per kernel
    and every workspace or build made for it, and the profiler counts each
    wrapper's dispatch; disarmed, neither call records anything."""
    dev = torch.device("cpu")
    assert vtprof.PROFILER is None
    before = vtprof.registry_cache_sizes()
    assert vtprof.launch_begin("unit_kernel", (("a", 3),), dev) is None
    vtprof.note_compile("unit_kernel")
    assert vtprof.registry_cache_sizes() == before
    prof = vtprof.arm()
    vtprof.launch_begin("unit_kernel", (("a", 3),), dev)
    vtprof.launch_begin("unit_kernel", (("a", 3),), dev)
    vtprof.note_compile("unit_kernel")
    after = vtprof.registry_cache_sizes()
    assert after["unit_kernel"] - before.get("unit_kernel", 0) == 2
    assert vtprof.launch_begin("unit_kernel", (("a", 4),), dev) is None  # no events on the CPU
    assert prof.totals["unit_kernel"]["dispatches"] == 3
    assert vtprof.registry_cache_sizes()["unit_kernel"] - after["unit_kernel"] == 1

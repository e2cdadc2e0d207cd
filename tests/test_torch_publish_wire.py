"""The port's publish wire against the JAX package's: the columnar decision
segment, the async applier, cluster Events.

Seeded clusters are built once in the JAX package and copied uid for uid
into the port's store (``tests/test_torch_object.py`` ``port_store``); the
JAX ``Scheduler`` and the port's ``Scheduler(..., backend="cpu")`` both run
under ``apply_mode: async`` with the columnar publish, each applier flushed
after every cycle.  After every cycle the pods' ``node_name`` and
``deleting``, the PodGroup statuses, ``bind_log``, ``evict_log``, the ops of
``err_log`` and the multiset of Events by (involved, reason, message, type,
count) must be equal: Event names come from a global uid counter, so they
are never compared.  The cases: config 5's shape at small scale, a
contention storm whose victims come back so that their second eviction
aggregates, an unschedulable gang (one Warning per condition transition)
and a residue cycle (the object sub-cycle, with the enqueue admissions
shipped synchronously before it).

In the port alone: the two publish modes (synchronous, async columnar) end
every cycle in the same store, the in-flight overlay
shows a pod bound before the applier lands it, a failed async bind lands
in ``err_log`` and is bound the next cycle, decisions dropped by
``abort_pending`` are published anew after ``reset_after_abort``, a
resubmitted segment creates no second Event, repeated evictions aggregate
into one Event, and ``DecisionSegment.to_wire()`` is the JAX dict.
Every applier is stopped by a fixture, so no thread outlives its test.
"""

import json
import threading
from collections import Counter

import pytest
import torch

from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store.segment import DecisionSegment as JSegment
from volcano_tpu_torch import events
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store
from volcano_tpu_torch.store.segment import DecisionSegment, event_name

from helpers import build_pod
from test_torch_contention import storm_spec
from test_torch_cycle import cfg5_shaped_spec
from test_torch_object import _convert, port_conf, port_store
from test_torch_residue import cfg5r_spec, jax_store

torch.set_num_threads(1)

FLUSH_S = 60.0


@pytest.fixture
def caches():
    """Collects the scheduler caches a test builds; stops every applier
    after it."""
    made = []
    yield made
    for cache in made:
        if cache.applier is not None:
            cache.applier.stop(flush=False)


def _pair(caches, spec, solve_mode="auto", apply_mode="async"):
    js = jax_store(spec)
    ts = port_store(js)
    jc = jconf.full_conf("tpu")
    jc.solve_mode = solve_mode
    jc.exact_topk = True
    jc.apply_mode = apply_mode
    tc = port_conf(jc)
    tc.apply_mode = apply_mode
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=tc)
    caches += [jsched.cache, tsched.cache]
    return (js, jsched), (ts, tsched)


class HeldApplier:
    """Holds every store write the applier thread makes until ``release``:
    the cycle runs with its whole write-back in flight, so that what the
    object sub-cycle's snapshot reads does not depend on how far the
    applier got (the JAX cache's overlay re-reads the pod, which a bind
    landing in between defeats)."""

    def __init__(self, monkeypatch, *stores):
        self.gate = threading.Event()
        for store in stores:
            for verb in ("apply_segment", "bulk"):
                monkeypatch.setattr(store, verb, self._held(getattr(store, verb)))

    def _held(self, fn):
        def held(*args, **kw):
            if threading.current_thread().name == "volcano-applier":
                assert self.gate.wait(FLUSH_S)
            return fn(*args, **kw)
        return held

    def release(self):
        self.gate.set()

    def hold(self):
        self.gate.clear()


def _flush(sched):
    if sched.cache.applier is not None:
        assert sched.cache.applier.flush(timeout=FLUSH_S)


def outcome(store, sched):
    pods = {p.meta.key: (p.node_name, p.deleting) for p in store.list("Pod")}
    groups = {g.meta.key: (g.status.phase.value, g.status.running, g.status.succeeded,
                           g.status.failed,
                           [(c.kind, c.status, c.reason, c.message) for c in g.status.conditions])
              for g in store.list("PodGroup")}
    evs = Counter((e.involved, e.reason, e.message, e.type, e.count)
                  for e in store.list("Event"))
    return {"pods": pods, "groups": groups, "binds": list(sched.cache.bind_log),
            "evicts": list(sched.cache.evict_log),
            "errs": [(op, key) for op, key, _ in sched.cache.err_log], "events": evs}


def _resurface(stores, evicted):
    """The evicted pods come back (a controller re-creates them in place),
    so the next cycle's storm evicts them again."""
    for store in stores:
        for key in evicted:
            if store.get("Pod", key) is not None and store.get("Pod", key).deleting:
                store.patch("Pod", key, {"deleting": False})


def _unschedulable_spec():
    """A three-task gang of 3-cpu pods on two 4-cpu nodes never fits; a
    one-pod job binds."""
    node = {"cpu": "4", "memory": "8Gi", "pods": 10}
    return {"queues": [{"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": node} for i in range(2)],
            "podgroups": [{"name": "big", "min_member": 3, "queue": "default", "phase": "Inqueue"},
                          {"name": "ok", "min_member": 1, "queue": "default", "phase": "Inqueue"}],
            "pods": [{"name": f"big-{t}", "group": "big",
                      "resources": {"cpu": "3", "memory": "1Gi"}} for t in range(3)]
            + [{"name": "ok-0", "group": "ok", "resources": {"cpu": "1", "memory": "1Gi"}}]}


def _grow_gang(cycle, js, ts):
    """Before cycle 2 a fourth pod joins the gang (the condition's message
    changes: a second Warning); before cycle 3 a node it fits on arrives."""
    from volcano_tpu.api import objects as jobj
    from volcano_tpu.api.resource import Resource as JResource

    if cycle == 2:
        jpod = build_pod("big-3", group="big", cpu="3", memory="1Gi")
        js.create("Pod", jpod)
        ts.create("Pod", _convert("Pod", jpod))
    elif cycle == 3:
        jnode = jobj.Node(meta=jobj.Metadata(name="n9", namespace=""),
                          allocatable=JResource.from_resource_list(
                              {"cpu": "16", "memory": "16Gi", "pods": 10}))
        js.create("Node", jnode)
        ts.create("Node", _convert("Node", jnode))


CASES = {
    # (spec, solve mode, cycles, resurface evicted pods, mutate before a cycle)
    "cfg5": (lambda: cfg5_shaped_spec(n_nodes=60, n_jobs=40, tasks_per_job=10, best_effort=15),
             "auto", 3, False, None),
    "storm": (lambda: storm_spec(n_nodes=6, per_node=6, n_gangs=10), "auto", 3, True, None),
    "unschedulable": (_unschedulable_spec, "auto", 4, False, _grow_gang),
    "residue": (lambda: cfg5r_spec(60, 30, 0.10, 12), "batch", 3, False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_columnar_equals_jax(case, caches, monkeypatch):
    build, solve_mode, cycles, resurface, mutate = CASES[case]
    (js, jsched), (ts, tsched) = _pair(caches, build(), solve_mode=solve_mode)
    held = HeldApplier(monkeypatch, js, ts)
    paths = []
    for cycle in range(cycles):
        if mutate is not None:
            mutate(cycle, js, ts)
        held.hold()
        n_binds = len(tsched.cache.bind_log)
        try:
            jsched.run_once()
            tsched.run_once()
            # the cycle published without waiting on a single store write
            assert tsched.cache.applier.pending > 0 or len(tsched.cache.bind_log) == n_binds
        finally:
            held.release()
        _flush(jsched)
        _flush(tsched)
        paths.append((tsched.last_path, set(tsched.fast_cycle.phases)))
        jo, to = outcome(js, jsched), outcome(ts, tsched)
        for key in ("pods", "groups", "binds", "evicts", "errs", "events"):
            assert to[key] == jo[key], f"cycle {cycle}: {key}"
        if resurface:
            _resurface((js, ts), [k for k, _ in tsched.cache.evict_log])
    evs = to["events"]
    n_sched = sum(n for (inv, reason, *_), n in evs.items() if reason == "Scheduled")
    assert n_sched == len(to["binds"])  # one Scheduled Event a bind
    assert all(path == "fast" for path, _ in paths)
    assert {"publish_build", "publish_ship"} <= paths[0][1]
    if case == "storm":
        counts = [c for (inv, reason, _, typ, c), n in evs.items() if reason == "Evict"]
        assert counts and max(counts) >= 2  # a repeated eviction aggregated
        assert sum(c * n for (_, r, _, _, c), n in evs.items() if r == "Evict") \
            == len(to["evicts"])
    if case == "unschedulable":
        warnings = [(m, c) for (inv, r, m, t, c), n in evs.items() if r == "Unschedulable"
                    for _ in range(n)]
        # cycle 0 and cycle 2 changed the condition; cycle 1 did not
        assert len(warnings) == 2 and all(c == 1 for _, c in warnings)
        assert to["pods"]["default/big-0"][0] == "n9"
    if case == "residue":
        assert "subcycle" in paths[0][1]


# -- the port alone -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["cfg5", "storm"])
def test_publish_modes_agree(case, caches):
    """The synchronous publish and the async columnar one end every cycle
    with the same store, logs and Event multiset."""
    build, solve_mode, cycles, resurface, _ = CASES[case]
    spec = build()
    runs = {}
    for apply_mode in ("sync", "async"):
        _, (ts, tsched) = _pair(caches, spec, solve_mode=solve_mode, apply_mode=apply_mode)
        assert (tsched.cache.applier is None) == (apply_mode == "sync")
        got = []
        for _ in range(cycles):
            tsched.run_once()
            _flush(tsched)
            got.append(outcome(ts, tsched))
            if resurface:
                _resurface((ts,), [k for k, _ in tsched.cache.evict_log])
        runs[apply_mode] = got
    assert runs["async"] == runs["sync"]
    last = runs["sync"][-1]
    assert (last["binds"] or last["evicts"]) and last["events"]


def _small_store(n_jobs=3):
    """Single-pod gangs on one node with room for all."""
    from volcano_tpu_torch import interop

    return interop.store_from_spec({
        "queues": [{"name": "default", "weight": 1}],
        "nodes": [{"name": "n0", "allocatable": {"cpu": "8", "memory": "8Gi", "pods": 10}}],
        "podgroups": [{"name": f"j{i}", "min_member": 1, "queue": "default",
                       "phase": "Inqueue"} for i in range(n_jobs)],
        "pods": [{"name": f"p{i}", "group": f"j{i}",
                  "resources": {"cpu": "1", "memory": "1Gi"}} for i in range(n_jobs)]})


def _async_sched(caches, store):
    conf = tconf.full_conf("cpu")
    conf.apply_mode = "async"
    sched = Scheduler(store, conf=conf)
    caches.append(sched.cache)
    return sched


def test_inflight_overlay_shows_a_pod_bound_before_the_flush(caches, monkeypatch):
    store = _small_store()
    sched = _async_sched(caches, store)
    gate = threading.Event()
    orig = store.apply_segment
    monkeypatch.setattr(store, "apply_segment", lambda seg: (gate.wait(FLUSH_S), orig(seg))[1])
    try:
        sched.run_once()
        assert len(sched.cache.bind_log) == 3
        assert all(not p.node_name for p in store.list("Pod"))  # nothing landed yet
        snap = sched.cache.snapshot()
        tasks = [t for j in snap.jobs.values() for t in j.tasks.values()]
        assert tasks and all(t.status == TaskStatus.BOUND and t.node_name == "n0"
                             for t in tasks)
        assert snap.nodes["n0"].idle.milli_cpu == 5000  # the node pays for them
        sched.run_once()  # the next cycle sees them bound: nothing placed twice
        assert len(sched.cache.bind_log) == 3
    finally:
        gate.set()
    _flush(sched)
    assert sched.cache.applier.inflight_view() == ({}, {})
    assert all(p.node_name == "n0" for p in store.list("Pod"))
    assert sorted(e.reason for e in store.list("Event")) == ["Scheduled"] * 3


def test_failed_async_bind_lands_in_err_log_and_binds_next_cycle(caches, monkeypatch):
    store = _small_store()
    sched = _async_sched(caches, store)
    orig = store.patch
    failed = []

    def flaky(kind, key, fields, when=None):
        if key == "default/p1" and "node_name" in fields and not failed:
            failed.append(key)
            raise RuntimeError("store outage")
        return orig(kind, key, fields, when=when)

    monkeypatch.setattr(store, "patch", flaky)
    sched.run_once()
    _flush(sched)
    assert [(op, key) for op, key, _ in sched.cache.err_log] == [("bind", "default/p1")]
    assert store.get("Pod", "default/p1").node_name == ""
    assert not events.events_for(store, "Pod", "default/p1")
    sched.run_once()
    _flush(sched)
    assert store.get("Pod", "default/p1").node_name == "n0"
    assert [e.reason for e in events.events_for(store, "Pod", "default/p1")] == ["Scheduled"]
    assert len(sched.cache.err_log) == 1


def test_abort_pending_drops_queued_decisions_and_the_next_cycle_republishes(caches,
                                                                             monkeypatch):
    """A deposed leader's queued segment is dropped with its overlay
    markers; after ``reset_after_abort`` the mirror matches the store again
    and the next cycle binds the pods anew."""
    store = _small_store()
    sched = _async_sched(caches, store)
    applier = sched.cache.applier
    held = HeldApplier(monkeypatch, store)
    held.hold()
    try:
        # a status op occupies the applier thread, so the cycle's segment
        # stays queued behind it
        applier.submit_ops([{"op": "patch", "kind": "PodGroup", "key": "default/j0",
                             "fields": {}}])
        for _ in range(1000):
            if applier.pending == 1 and not applier._q:
                break
            threading.Event().wait(0.005)
        sched.run_once()
        assert len(sched.cache.bind_log) == 3 and applier.inflight_binds
        assert applier.abort_pending() >= 1
        assert applier.inflight_view() == ({}, {})
        sched.fast_cycle.reset_after_abort()
    finally:
        held.release()
    _flush(sched)
    assert all(not p.node_name for p in store.list("Pod"))  # never applied
    assert not store.list("Event")
    sched.run_once()
    _flush(sched)
    assert all(p.node_name == "n0" for p in store.list("Pod"))
    assert sorted(e.reason for e in store.list("Event")) == ["Scheduled"] * 3


@pytest.mark.parametrize("verb", ["bind", "evict"])
def test_overlay_holds_when_the_write_lands_during_the_snapshot(verb, caches, monkeypatch):
    """The applier lands a decision between the snapshot's read of the pod
    and its overlay check: the task must still come out bound (or
    releasing), never as the state before the decision."""
    from volcano_tpu_torch.scheduler import cache as cache_mod

    store = _small_store(1)
    if verb == "evict":
        store.patch("Pod", "default/p0", {"node_name": "n0"})
    cache = SchedulerCache(store, async_apply=True)
    caches.append(cache)
    held = HeldApplier(monkeypatch, store)
    held.hold()
    orig = cache_mod.TaskInfo

    def landing(pod):
        task = orig(pod)
        if verb == "bind":
            pod.node_name = "n0"  # the bind lands right after the read
        else:
            pod.deleting = True
        return task

    try:
        if verb == "bind":
            cache.applier.submit_bind("default/p0", "n0")
        else:
            cache.applier.submit_evict("default/p0", "preempt")
        monkeypatch.setattr(cache_mod, "TaskInfo", landing)
        snap = cache.snapshot()
    finally:
        held.release()
    (task,) = [t for j in snap.jobs.values() for t in j.tasks.values()]
    if verb == "bind":
        assert (task.status, task.node_name) == (TaskStatus.BOUND, "n0")
    else:
        assert task.status == TaskStatus.RELEASING


def test_applier_under_concurrent_submitters_loses_no_decision(caches):
    """Eight threads publish binds through every submit verb while the main
    thread takes snapshots, with a short switch interval: a submitted bind
    is always either in the store or in the overlay, and after the flush
    every pod is bound once, with one Scheduled Event, and no marker or
    pending count is left."""
    import sys

    n_pods, n_threads = 240, 8
    from volcano_tpu_torch import interop

    store = interop.store_from_spec({
        "queues": [{"name": "default", "weight": 1}],
        "nodes": [{"name": f"n{i}", "allocatable": {"cpu": "64", "memory": "64Gi",
                                                     "pods": 110}} for i in range(4)],
        "podgroups": [{"name": "g", "min_member": 1, "queue": "default", "phase": "Inqueue"}],
        "pods": [{"name": f"p{i:03d}", "group": "g", "resources": {"cpu": "1", "memory": "1Gi"}}
                 for i in range(n_pods)]})
    cache = SchedulerCache(store, async_apply=True)
    caches.append(cache)
    want = {f"default/p{i:03d}": f"n{i % 4}" for i in range(n_pods)}
    done = []

    def submit(k):
        keys = sorted(want)[k::n_threads]
        for a in range(0, len(keys), 5):
            chunk = [(key, want[key]) for key in keys[a:a + 5]]
            if k % 3 == 0:
                for key, host in chunk:
                    cache.applier.submit_bind(key, host)
            elif k % 3 == 1:
                cache.bind_bulk(chunk)
            else:
                cache.publish_segment(_segment(chunk))
            done.extend(key for key, _ in chunk)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            before = set(done)
            snap = cache.snapshot()
            bound = {t.key for j in snap.jobs.values() for t in j.tasks.values()
                     if t.status == TaskStatus.BOUND}
            assert before <= bound
        for t in threads:
            t.join(FLUSH_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert cache.applier.flush(FLUSH_S)
    assert {p.meta.key: p.node_name for p in store.list("Pod")} == want
    assert cache.applier.inflight_view() == ({}, {}) and not cache.applier._pending
    assert sorted(e.involved[1] for e in store.list("Event")) == sorted(want)
    assert cache.err_log == []


def _segment(bind_pairs, evicts=()):
    table = sorted({h for _, h in bind_pairs})
    idx = {h: i for i, h in enumerate(table)}
    return DecisionSegment.build([k for k, _ in bind_pairs], [idx[h] for _, h in bind_pairs],
                                 table, list(evicts))


def test_resubmitted_segment_creates_no_second_event(caches):
    store = _small_store()
    seg = _segment([("default/p0", "n0"), ("default/ghost", "n0")],
                   evicts=[("default/p1", "preempt"), ("default/gone", "preempt")])
    res = store.apply_segment(seg)
    assert [row for row, _ in res["binds"]] == [1] and "NotFound" in res["binds"][0][1]
    assert [row for row, _ in res["evicts"]] == [1]
    assert set(res["timings"]) == {"binds_s", "evicts_s", "events_s"}
    # only the rows that landed got an Event, named from the segment's block
    names = sorted(e.meta.name for e in store.list("Event"))
    assert names == sorted([event_name(seg.ev_token, seg.ev_start),
                            event_name(seg.ev_token, seg.ev_start + 2)])
    rv = store.resource_version
    again = store.apply_segment(seg)
    assert again["binds"] == res["binds"] and again["evicts"] == res["evicts"]
    assert store.resource_version == rv  # no patch, no Event: idempotent
    # through the applier too
    cache = SchedulerCache(store, async_apply=True)
    caches.append(cache)
    cache.publish_segment(seg)
    assert cache.applier.flush(FLUSH_S)
    assert len(store.list("Event")) == 2
    assert not store._shadow["Event"]  # Events keep no shadow copy


def test_repeated_evictions_aggregate_into_one_event(caches):
    store = _small_store(1)
    cache = SchedulerCache(store, async_apply=True)
    caches.append(cache)
    for _ in range(2):
        cache.publish_segment(_segment([], evicts=[("default/p0", "too-hot")]))
        assert cache.applier.flush(FLUSH_S)
        store.patch("Pod", "default/p0", {"deleting": False})
    evs = events.events_for(store, "Pod", "default/p0")
    assert [(e.reason, e.message, e.count) for e in evs] == [("Evict", "Evicted for too-hot", 2)]
    assert cache.err_log == []
    assert cache.applier.drain_stats["evicts_s"] > 0 and cache.applier.drain_stats["pg_s"] > 0


def test_segment_wire_equals_jax():
    bind_keys = ["default/p0", "default/p1", "default/p2"]
    bind_nodes = [1, 0, 1]
    table = ["n0", "n1"]
    evicts = [("default/v0", "preempt"), ("default/v1", "reclaim"), ("default/v2", "preempt")]
    seg = DecisionSegment.build(bind_keys, bind_nodes, table, evicts)
    jseg = JSegment.build(bind_keys, bind_nodes, table, evicts)
    assert (seg.evict_keys, seg.evict_reasons, seg.reason_table) == \
        (jseg.evict_keys, jseg.evict_reasons, jseg.reason_table) == \
        ([k for k, _ in evicts], [0, 1, 0], ["preempt", "reclaim"])
    # the uid blocks differ (two counters): give the JAX one the port's
    jseg.ev_token, jseg.ev_start = seg.ev_token, seg.ev_start
    assert seg.to_wire() == jseg.to_wire()
    back = DecisionSegment.from_wire(json.loads(json.dumps(seg.to_wire())))
    assert back.to_wire() == seg.to_wire()
    assert back.bind_pairs() == jseg.bind_pairs() == list(zip(bind_keys, ["n1", "n0", "n1"]))
    assert back.evict_pairs() == evicts
    assert seg.ev_start + 6 <= DecisionSegment.build([], [], [], [("k", "r")]).ev_start
    assert DecisionSegment.build([], [], []).empty


def test_apply_mode_validation_and_close():
    with pytest.raises(ValueError):
        tconf.SchedulerConf(backend="cpu", apply_mode="Async")
    with pytest.raises(ValueError):
        tconf.SchedulerConf(backend="cpu", apply_mode=None)
    assert tconf.SchedulerConf(backend="cpu").apply_mode == "sync"
    conf = tconf.full_conf("cpu")
    conf.apply_mode = "async"
    sched = Scheduler(Store(), conf=conf)
    thread = sched.cache.applier._thread
    assert thread.is_alive()
    sched.close()
    assert not thread.is_alive()
    assert Scheduler(Store(), conf=tconf.full_conf("cpu")).cache.applier is None

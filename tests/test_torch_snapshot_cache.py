"""The port's object-path ``SnapshotCache`` against the JAX package's.

The counterparts of ``tests/test_snapshot_cache.py``: while the node epoch
(the nodes' names and resource versions) holds, a rebuilt snapshot reuses
the class planes and the node statics as the same numpy objects and the
cache's device tier does not copy them again; a relabel, a taint or a new
node rolls the epoch (and drops the old uploads), a bind does not.  The
stores are built once with the JAX test helpers and copied uid for uid
into the port's store (``tests/test_torch_object.py`` ``port_store``).

End to end, over four cycles with a relabel and a taint between them (the
object path: ``fast_path: off``, full conf, preempt and reclaim with
victims reaped): the port's Scheduler with its cache makes the JAX
Scheduler's binds, evictions in order and pipelines in order, cycle by
cycle (``run_pair``), and the port with its cache equals the port without
it, every tensor snapshot field and every decision.  Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import framework as jframework
from volcano_tpu.scheduler.snapshot import SnapshotCache as JSnapshotCache
from volcano_tpu.scheduler.snapshot import build_tensor_snapshot as jbuild
from volcano_tpu_torch import api as tapi
from volcano_tpu_torch.scheduler import tensor_backend as TB
from volcano_tpu_torch.scheduler.conf import full_conf
from volcano_tpu_torch.scheduler.framework import open_session
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.scheduler.snapshot import SnapshotCache, build_tensor_snapshot
from volcano_tpu_torch.scheduler.tensor_backend import DeviceUploads

from helpers import build_node, build_pod, build_podgroup, build_queue, make_store
from test_torch_object import _prio, _running, port_store, run_pair

torch.set_num_threads(1)

CPU = torch.device("cpu")
CACHED = ("class_node_mask", "class_node_score", "node_alloc", "node_max_tasks", "node_valid")


def zoned(n_nodes=6, pending=2, running=True):
    """Nodes in two zones, low-priority residents filling every node, and
    pending high-priority gangs pinned to a zone by a node selector."""
    def build():
        nodes = [build_node(f"n{i}", cpu="4", memory="8Gi", labels={"zone": f"z{i % 2}"})
                 for i in range(n_nodes)]
        pods, pgs = [], [build_podgroup("pg-low", min_member=1, queue="q0")]
        pgs[0].priority_class_name = "low"
        if running:
            pods += [_running(f"low-{i}-{k}", "pg-low", f"n{i}", cpu="1")
                     for i in range(n_nodes) for k in range(3)]
        for j in range(pending):
            pg = build_podgroup(f"pg-{j}", min_member=2, queue=f"q{j % 2}")
            pg.priority_class_name = "high"
            pgs.append(pg)
            for k in range(2):
                pod = build_pod(f"p{j}-{k}", group=f"pg-{j}", cpu="2", priority=100)
                pod.spec.node_selector = {"zone": f"z{j % 2}"}
                pods.append(pod)
        return _prio(make_store(nodes=nodes, queues=[build_queue("q0"), build_queue("q1", 2)],
                                podgroups=pgs, pods=pods))
    return build


def _port_session(store):
    sched = Scheduler(store, conf=full_conf("cpu"))
    return open_session(sched.cache, sched.conf.tiers)


def test_class_rows_and_node_static_reused_across_cycles():
    """Two builds over one store: the cached planes are the same objects,
    equal to the JAX build with its cache, and no class row is recomputed."""
    js = zoned()()
    ts = port_store(js)
    cache = SnapshotCache(DeviceUploads(CPU))
    s1 = build_tensor_snapshot(_port_session(ts), cache=cache)
    assert cache.stats["rows_built"] == 2
    s2 = build_tensor_snapshot(_port_session(ts), cache=cache)
    assert cache.stats == {"rows_built": 0, "rows_reused": 2, "assembled": 1}
    for name in CACHED:
        assert getattr(s2, name) is getattr(s1, name), name
    jcache = JSnapshotCache()
    jsess = jframework.open_session
    jconf_ = jconf.full_conf("tpu")
    from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler

    jsched = JScheduler(js, conf=jconf_)
    j1 = jbuild(jsess(jsched.cache, jconf_.tiers), cache=jcache)
    j2 = jbuild(jsess(jsched.cache, jconf_.tiers), cache=jcache)
    assert j2.class_node_mask is j1.class_node_mask
    for name in CACHED:
        np.testing.assert_array_equal(getattr(s2, name), getattr(j2, name), err_msg=name)


@pytest.mark.parametrize("mutation", ["relabel", "taint", "new-node"])
def test_node_mutation_rolls_epoch(mutation):
    ts = port_store(zoned()())
    cache = SnapshotCache(DeviceUploads(CPU))
    s1 = build_tensor_snapshot(_port_session(ts), cache=cache)
    d1 = cache.uploads(s1.class_node_mask)
    if mutation == "new-node":
        ts.create("Node", tapi.Node(meta=tapi.Metadata(name="n9", namespace=""),
                                    allocatable=tapi.Resource(4000.0, 8.0 * (1 << 30),
                                                              max_task_num=110),
                                    labels={"zone": "z0"}))
    else:
        node = ts.get("Node", "/n1")
        if mutation == "relabel":
            node.labels["zone"] = "z0"
        else:
            node.taints = [tapi.Taint("dedicated", "x", "NoSchedule")]
        ts.update("Node", node)
    s2 = build_tensor_snapshot(_port_session(ts), cache=cache)
    assert s2.class_node_mask is not s1.class_node_mask
    assert s2.node_alloc is not s1.node_alloc
    assert cache.stats["rows_built"] == 2
    # the old epoch's upload went with it
    assert cache.uploads(s1.class_node_mask) is not d1
    c = int(s2.task_class[np.nonzero(s2.task_valid)[0][0]])  # the z0 class
    if mutation == "relabel":
        assert bool(s2.class_node_mask[c, 1]) and not bool(s1.class_node_mask[c, 1])
    elif mutation == "taint":
        c1 = int(s2.task_class[np.nonzero(s2.task_valid)[0][2]])  # the z1 class
        assert bool(s1.class_node_mask[c1, 1]) and not bool(s2.class_node_mask[c1, 1])
    else:
        assert bool(s2.class_node_mask[c, 6]) and not bool(s1.class_node_mask[c, 6])


def test_bind_and_eviction_keep_the_epoch():
    """Pod placement changes no Node object: the epoch, the node statics and
    the class rows stay."""
    ts = port_store(zoned()())
    cache = SnapshotCache(DeviceUploads(CPU))
    s1 = build_tensor_snapshot(_port_session(ts), cache=cache)
    epoch = cache._epoch
    ts.patch("Pod", "default/p0-0", {"node_name": "n0"})
    ts.patch("Pod", "default/low-1-0", {"deleting": True})
    s2 = build_tensor_snapshot(_port_session(ts), cache=cache)
    assert cache._epoch == epoch
    assert s2.node_alloc is s1.node_alloc and s2.node_valid is s1.node_valid
    assert cache.stats["rows_built"] == 0


def test_uploads_memoize_by_identity():
    cache = SnapshotCache(DeviceUploads(CPU))
    arr = np.arange(16, dtype=np.float32)
    d1 = cache.uploads(arr)
    assert cache.uploads(arr) is d1
    assert cache.uploads(arr.copy()) is not d1
    torch.testing.assert_close(d1, torch.from_numpy(arr))


def _node_edits(cycle, jsched, tsched):
    """Between cycles: relabel n1 into zone z0 after cycle 1, taint n2
    after cycle 2, in both stores."""
    for store in (jsched.cache.store, tsched.cache.store):
        if cycle == 0:
            node = store.get("Node", "/n1")
            node.labels["zone"] = "z0"
            store.update("Node", node)
        elif cycle == 1:
            node = store.get("Node", "/n2")
            node.taints = node.taints + [_taint(store, "dedicated", "x", "NoSchedule")]
            store.update("Node", node)


def _taint(store, key, value, effect):
    """A taint of the store's own package."""
    if type(store).__module__.startswith("volcano_tpu_torch"):
        return tapi.Taint(key, value, effect)
    from volcano_tpu.api.objects import Taint

    return Taint(key, value, effect)


def _more_work(cycle, jsched, tsched):
    """After every cycle: a new pending gang for each zone, so that every
    cycle has pending and preempting work."""
    from test_torch_object import _convert

    for j in range(2):
        name = f"w{cycle}-{j}"
        pg = build_podgroup(name, min_member=1, queue=f"q{j}")
        pg.priority_class_name = "high"
        pod = build_pod(f"{name}-0", group=name, cpu="1", priority=100)
        pod.spec.node_selector = {"zone": f"z{j}"}
        for kind, obj in (("PodGroup", pg), ("Pod", pod)):
            jsched.cache.store.create(kind, obj)
            tsched.cache.store.create(kind, _convert(kind, obj))


def test_scheduler_with_cache_equals_jax_cycle_by_cycle(monkeypatch):
    """Four object cycles, a relabel after the first and a taint after the
    second, new gangs after each: the JAX run_pair outcomes every cycle,
    the cache reused in the quiet cycles and rolled after each node edit."""
    rolls = []
    orig = SnapshotCache.roll_epoch

    def spy(self, epoch, weight):
        rolls.append((epoch, weight) != (self._epoch, self._weight))
        orig(self, epoch, weight)

    monkeypatch.setattr(SnapshotCache, "roll_epoch", spy)
    per_cycle = []

    def each(cycle, jsched, tsched):
        assert tsched.snapshot_cache is not None and jsched.snapshot_cache is not None
        per_cycle.append(list(rolls))
        rolls.clear()
        _node_edits(cycle, jsched, tsched)
        _more_work(cycle, jsched, tsched)

    history, tsched = run_pair(monkeypatch, zoned(), jax_conf=jconf.full_conf("tpu"),
                               cycles=4, reap=True, each_cycle=each)
    assert sum(e for e, _, _ in history) > 0 and sum(p for _, p, _ in history) > 0
    assert sum(b for _, _, b in history) > 0
    # the first build of cycle 1 fills the cache; cycles 2 and 3 open on a
    # rolled epoch (relabel, taint); cycle 4 opens on the held one
    assert per_cycle[0][0] and per_cycle[1][0] and per_cycle[2][0]
    assert not any(per_cycle[3]), per_cycle[3]


def _snapshots(monkeypatch):
    """Every tensor snapshot the port's object sessions build, as field
    dicts, in build order."""
    built = []
    orig = TB.build_tensor_snapshot

    def record(ssn, **kw):
        snap = orig(ssn, **kw)
        built.append({f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)})
        return snap

    monkeypatch.setattr(TB, "build_tensor_snapshot", record)
    return built


def _equal_snapshot(a, b, where):
    assert a.keys() == b.keys()
    for k, x in a.items():
        y = b[k]
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{where}: {k}")
            assert x.dtype == y.dtype, f"{where}: {k}"
        else:
            assert x == y, f"{where}: {k}"


def test_port_with_cache_equals_port_without_it(monkeypatch):
    """Bit for bit: every snapshot field of every build and every decision,
    over four cycles with the node edits."""
    build = zoned(n_nodes=8, pending=3)
    js = build()
    runs = {}
    for cached in (True, False):
        store = port_store(js)
        conf = full_conf("cpu")
        conf.fast_path = "off"
        sched = Scheduler(store, conf=conf)
        if not cached:
            sched.snapshot_cache = None
        with monkeypatch.context() as mp:
            built = _snapshots(mp)
            per_cycle = []
            for cycle in range(4):
                sched.run_once()
                per_cycle.append((list(sched.cache.bind_log), list(sched.cache.evict_log)))
                for key, _ in sched.cache.evict_log:
                    if store.get("Pod", key) is not None:
                        store.delete("Pod", key)
                if cycle == 0:
                    node = store.get("Node", "/n1")
                    node.labels["zone"] = "z0"
                    store.update("Node", node)
                elif cycle == 1:
                    node = store.get("Node", "/n2")
                    node.taints = [tapi.Taint("dedicated", "x", "NoSchedule")]
                    store.update("Node", node)
        runs[cached] = (built, per_cycle, sched.cache.bind_log, sched.cache.evict_log)
    (b1, c1, bl1, el1), (b2, c2, bl2, el2) = runs[True], runs[False]
    assert len(b1) == len(b2) and len(b1) >= 4
    for i, (x, y) in enumerate(zip(b1, b2)):
        _equal_snapshot(x, y, f"build {i}")
    assert c1 == c2 and bl1 == bl2 and el1 == el2
    assert el1, "the scenario must evict"

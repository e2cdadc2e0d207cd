"""PodDisruptionBudget shadow gangs in the port against the JAX package.

A budget groups its controller's plain pods into one shadow gang whose
minimum comes from the budget (reference setPDB).  Each scenario is built
once with the JAX package's objects and copied object by object, uids
kept, into the port's store (``tests/test_torch_object.py`` ``port_store``
plus the budgets); the JAX ``Scheduler`` (backend ``tpu``) and the port's
(backend ``cpu``) run the same conf cycle by cycle, on the fast path and
with ``fast_path: off``, and must give the same binds, pods, PodGroup
phases and conditions (tolerance: exact).  The port's snapshots and its
watch mirror's shadow rows are held to the JAX ones on the same store.
"""

import numpy as np
import pytest

from volcano_tpu.api.objects import Metadata as JMetadata
from volcano_tpu.api.objects import Pod as JPod
from volcano_tpu.api.objects import PodDisruptionBudget as JPDB
from volcano_tpu.api.objects import PodSpec as JPodSpec
from volcano_tpu.api.resource import Resource as JResource
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.fastpath import ArrayMirror as JMirror
from volcano_tpu.scheduler.fastpath import build_fast_snapshot as jax_build_fast_snapshot
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch import api as tapi
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler.fastpath import ArrayMirror, build_fast_snapshot
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store

from helpers import build_node, build_pod, build_queue, make_store
from test_fastpath import _with_plain_pods
from test_torch_object import KINDS, _convert, _meta, _outcome, port_conf

PDB = "PodDisruptionBudget"


def port_store(jstore) -> Store:
    """The JAX store's objects and budgets, uids kept, in the JAX store's
    resource-version order."""
    objs = sorted(((o.meta.resource_version, kind, o) for kind in KINDS + (PDB,)
                   for o in jstore.list(kind)), key=lambda x: x[0])
    store = Store()
    for _, kind, o in objs:
        if kind == PDB:
            store.create(PDB, tapi.PodDisruptionBudget(meta=_meta(o.meta),
                                                      min_available=o.min_available))
        else:
            store.create(kind, _convert(kind, o))
    return store


def _confs(conf_name, fast_path):
    jc = getattr(jconf, conf_name)("tpu")
    jc.fast_path = fast_path
    return jc, port_conf(jc)


def _paths(jsched, tsched):
    """The path each package's last cycle took ("fast" or "object")."""
    return jsched.last_path, tsched.last_path


def _track_paths(jsched):
    """Record the JAX scheduler's path per cycle (it keeps no flag)."""
    jsched.last_path = ""
    fc = jsched.fast_cycle
    if fc is None:
        jsched.last_path = "object"
        return
    orig = fc.try_run

    def spy():
        ok = orig()
        jsched.last_path = "fast" if ok else "object"
        return ok

    fc.try_run = spy


def run_cycles(jstore, conf_name, fast_path, cycles=2, between=None):
    """Both schedulers over ``cycles`` cycles on copies of one store;
    asserts equal outcomes and equal paths after every cycle.
    ``between(cycle, jstore, tstore)`` edits both stores after a cycle.
    Returns the per-cycle outcomes and paths."""
    tstore = port_store(jstore)
    jc, tc = _confs(conf_name, fast_path)
    jsched, tsched = JScheduler(jstore, conf=jc), Scheduler(tstore, conf=tc)
    _track_paths(jsched)
    history = []
    for cycle in range(cycles):
        jsched.run_once()
        tsched.run_once()
        jo, to = _outcome(jstore, jsched), _outcome(tstore, tsched)
        for key in ("binds", "evicts", "pods", "groups"):
            assert to[key] == jo[key], f"cycle {cycle}: {key}"
        assert _paths(jsched, tsched)[0] == tsched.last_path, f"cycle {cycle}: path"
        history.append((to, tsched.last_path))
        if between is not None:
            between(cycle, jstore, tstore)
    return history


CONFS = [(c, fp) for c in ("default_conf", "full_conf") for fp in ("auto", "off")]


def _rs_a_store(with_pdb):
    """tests/test_pdb.py::test_pdb_gangs_plain_pods: three 1-cpu pods of
    ReplicaSet rs-a on one 2-cpu node, optionally a budget of 3."""
    store = make_store(nodes=[build_node("n0", cpu="2", memory="4Gi")],
                       queues=[build_queue("default")], podgroups=[], pods=[])
    if with_pdb:
        store.create(PDB, JPDB(meta=JMetadata(name="budget", namespace="d",
                                              owner=("ReplicaSet", "rs-a")),
                               min_available=3))
    for i in range(3):
        store.create("Pod", JPod(
            meta=JMetadata(name=f"p{i}", namespace="d", owner=("ReplicaSet", "rs-a")),
            spec=JPodSpec(resources=JResource.from_resource_list(
                {"cpu": "1", "memory": "1Gi"}))))
    return store


@pytest.mark.parametrize("conf_name,fast_path", CONFS)
@pytest.mark.parametrize("with_pdb", [True, False])
def test_pdb_gangs_plain_pods(conf_name, fast_path, with_pdb):
    """The budget's gang of 3 cannot fit two cpus: nothing binds (the
    fault that bound d/p0 and d/p1 is gone); without it two pods bind."""
    history = run_cycles(_rs_a_store(with_pdb), conf_name, fast_path)
    binds = history[-1][0]["binds"]
    assert len(binds) == (0 if with_pdb else 2)
    if fast_path == "auto":
        assert all(path == "fast" for _, path in history)


@pytest.mark.parametrize("conf_name,fast_path", CONFS)
def test_plain_pods_with_pdb_equal_jax(conf_name, fast_path):
    """tests/test_fastpath.py::test_plain_pods_stay_on_fast_path: plain
    pods, an owner-shadow pair and its budget of 2 beside mixed PodGroups;
    the port binds what the JAX package binds, on the fast path too (under
    the JAX test's default conf the plain pod binds)."""
    history = run_cycles(_with_plain_pods(), conf_name, fast_path)
    if conf_name == "default_conf":
        assert "default/plain" in dict(history[0][0]["binds"])
        assert history[0][1] == ("fast" if fast_path == "auto" else "object")


def test_plain_pod_snapshot_parity_with_pdb():
    """tests/test_fastpath.py::test_plain_pod_snapshot_parity: the port's
    fast snapshot equals the JAX one field for field with plain pods, an
    owner-shadow gang and a budget (shadow rows last, budget minimum in
    job_min_available)."""
    jstore = _with_plain_pods()
    tstore = port_store(jstore)
    jm = JMirror(jstore, "volcano-tpu", "default")
    jm.drain()
    jsnap, _ = jax_build_fast_snapshot(jm)
    tm = ArrayMirror(tstore, "volcano-tpu", "default")
    tm.drain()
    assert tm.ineligible_reason() is None
    tsnap, _ = build_fast_snapshot(tm)
    assert tsnap.job_uids[-2:] == list(jsnap.job_uids[-2:])
    assert all(u.startswith("shadow/") for u in tsnap.job_uids[-2:])
    rs = tsnap.job_uids.index("shadow/default/rs-1")
    assert tsnap.job_min_available[rs] == 2
    for name in (
        "node_used", "node_idle", "node_task_count",
        "task_req", "task_job", "task_valid",
        "job_queue", "job_min_available", "job_priority", "job_ready_init",
        "job_alloc_init", "job_schedulable", "job_start", "job_ntasks",
        "queue_alloc_init", "queue_request", "queue_participates",
    ):
        np.testing.assert_array_equal(getattr(tsnap, name), getattr(jsnap, name),
                                      err_msg=name)


def test_object_snapshot_takes_the_budget():
    """The object path's ClusterInfo: the budget names the shadow gang and
    sets its minimum; deleting it reverts the gang to 1."""
    from volcano_tpu_torch.scheduler.cache import SchedulerCache

    tstore = port_store(_rs_a_store(True))
    job = SchedulerCache(tstore).snapshot().jobs["shadow/d/rs-a"]
    assert (job.name, job.min_available, len(job.tasks)) == ("budget", 3, 3)
    tstore.delete(PDB, "d/budget")
    job = SchedulerCache(tstore).snapshot().jobs["shadow/d/rs-a"]
    assert (job.name, job.min_available) == ("shadow/d/rs-a", 1)


def _rs_b_store():
    """tests/test_fastpath.py::test_pdb_gang_blocks_partial_placement_on_fast_path."""
    store = make_store(nodes=[build_node("n0", cpu="2", memory="4Gi")],
                       queues=[build_queue("default")], podgroups=[], pods=[])
    store.create(PDB, JPDB(meta=JMetadata(name="budget", namespace="default",
                                          owner=("ReplicaSet", "rs-b")),
                           min_available=3))
    for i in range(3):
        p = build_pod(f"g{i}", cpu="1", memory="1Gi")
        p.meta.owner = ("ReplicaSet", "rs-b")
        store.create("Pod", p)
    return store


@pytest.mark.parametrize("conf_name,fast_path", CONFS)
def test_pdb_gang_blocks_partial_placement_then_deletion(conf_name, fast_path):
    """The budget's gang publishes nothing; once the budget is deleted the
    gang reverts to MinMember 1 and two pods bind, cycle by cycle equal to
    the JAX package."""
    def delete_budget(cycle, jstore, tstore):
        if cycle == 0:
            jstore.delete(PDB, "default/budget")
            tstore.delete(PDB, "default/budget")

    history = run_cycles(_rs_b_store(), conf_name, fast_path, cycles=3,
                         between=delete_budget)
    assert [len(h[0]["binds"]) for h in history] == [0, 2, 2]
    if fast_path == "auto":
        assert all(path == "fast" for _, path in history)


def test_shadow_gang_rows_released_on_pod_churn():
    """tests/test_enqueue.py's PDB case on the port's mirror, beside the
    JAX mirror fed the same events: a plain pod's shadow row goes with its
    last member; a budget-backed row outlives its pods, its minimum kept,
    until the budget is deleted."""
    jstore = make_store(nodes=[build_node("n0")], queues=[build_queue("default")],
                        podgroups=[], pods=[])
    tstore = port_store(jstore)
    jm = JMirror(jstore, "volcano-tpu", "default")
    tm = ArrayMirror(tstore, "volcano-tpu", "default")

    def both(fn):
        fn(jstore, JPDB, JMetadata, build_pod)
        fn(tstore, tapi.PodDisruptionBudget, tapi.Metadata, _port_pod)
        jm.drain()
        tm.drain()
        for key in ("shadow/default/loose-0", "shadow/default/rs-z"):
            jrow, trow = jm.jobs.key_row.get(key), tm.jobs.key_row.get(key)
            assert (jrow is None) == (trow is None), key
            if trow is not None:
                assert (bool(tm.j_live[trow]), int(tm.j_min[trow]), bool(tm.j_pdb[trow])) == (
                    bool(jm.j_live[jrow]), int(jm.j_min[jrow]), bool(jm.j_pdb[jrow])), key
        return tm.jobs.key_row

    both(lambda s, B, M, P: None)

    def create(s, B, M, P):
        s.create(PDB, B(meta=M(name="budget", namespace="default",
                               owner=("ReplicaSet", "rs-z")), min_available=2))
        for i in range(3):
            p = P(f"loose-{i}", cpu="100m")
            if i > 0:
                p.meta.owner = ("ReplicaSet", "rs-z")
            s.create("Pod", p)

    rows = both(create)
    assert "shadow/default/loose-0" in rows and "shadow/default/rs-z" in rows
    rows = both(lambda s, B, M, P: [s.delete("Pod", f"default/loose-{i}") for i in range(3)])
    assert "shadow/default/loose-0" not in rows
    rs_row = rows["shadow/default/rs-z"]
    assert tm.j_live[rs_row] and tm.j_min[rs_row] == 2
    rows = both(lambda s, B, M, P: s.delete(PDB, "default/budget"))
    assert "shadow/default/rs-z" not in rows


def _port_pod(name, cpu):
    return tapi.Pod(meta=tapi.Metadata(name=name, namespace="default"),
                    spec=tapi.PodSpec(resources=tapi.Resource.from_resource_list(
                        {"cpu": cpu, "memory": "128Mi"})))


def test_store_from_spec_takes_budgets():
    """interop.store_from_spec builds the budget and the pods' owner."""
    store = interop.store_from_spec({
        "queues": [{"name": "default"}],
        "nodes": [{"name": "n0", "allocatable": {"cpu": "2", "memory": "4Gi", "pods": 110}}],
        "pdbs": [{"name": "budget", "namespace": "d", "owner": ("ReplicaSet", "rs-a"),
                  "min_available": 3}],
        "pods": [{"name": f"p{i}", "namespace": "d", "owner": ("ReplicaSet", "rs-a"),
                  "resources": {"cpu": "1", "memory": "1Gi"}} for i in range(3)],
    })
    pdb = store.get(PDB, "d/budget")
    assert pdb.meta.owner == ("ReplicaSet", "rs-a") and pdb.min_available == 3
    sched = Scheduler(store, conf=port_conf(jconf.default_conf("tpu")))
    sched.run_once()
    assert sched.last_path == "fast" and not sched.cache.bind_log

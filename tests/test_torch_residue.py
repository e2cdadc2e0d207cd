"""The port's object sub-cycle and residue engine against the JAX package's.

* Engine: ``residue.vector_allocate`` (through ``AllocateAction._execute_host``
  with a job filter) on seeded copies of ``tests/test_volume_parity.py``'s
  ``_mixed_residue_store`` (tainted and labelled nodes, residents with ports
  and labels, one releasing; pending jobs with host ports, pod
  (anti)affinity, selectors with tolerations, and a volume shape the count
  model cannot express): task statuses and nodes, fit-error histograms and
  store binds equal to the JAX engine's, and to the port's own per-task loop
  (tolerance: exact).
* ``SchedulerCache.cycle_overlay``: ``snapshot()`` folds the fast cycle's
  published binds into pending pods.
* The fast cycle with the sub-cycle, cycle by cycle against the JAX
  ``Scheduler`` on the same store (copied uid for uid): the dynamic-pod
  partition of ``tests/test_fastpath.py`` at seeds 0-3, its preempt case,
  config 5 with best-effort pods on dynamic gangs (cfg5r) at 1/100 scale
  and the cfg6 storm with host-port gangs (cfg6d) on 1/10 of its nodes.
  Binds, ordered evictions, pipelines, pods, PodGroup phases and
  conditions, residue reasons and the sub-cycle phases must be equal.
"""

import random

import pytest
import torch

from volcano_tpu.api import POD_GROUP_KEY as JAX_POD_GROUP_KEY
from volcano_tpu.api import objects as jobj
from volcano_tpu.api.resource import Resource as JResource
from volcano_tpu.api.types import PodGroupPhase as JPhase
from volcano_tpu.api.types import PodPhase as JPodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.actions.allocate import AllocateAction as JAllocate
from volcano_tpu.scheduler.cache import SchedulerCache as JCache
from volcano_tpu.scheduler.framework import open_session as jopen_session
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import residue
from volcano_tpu_torch.scheduler.actions.allocate import AllocateAction
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.scheduler.framework import open_session

from helpers import build_node, build_pod, build_podgroup, build_queue, make_store
from test_torch_object import port_store, run_pair, same_fast_cycle

torch.set_num_threads(1)


# -- the engine ------------------------------------------------------------------

def mixed_residue_store(seed=7, n_nodes=8, n_jobs=6):
    """``tests/test_volume_parity.py`` ``_mixed_residue_store`` with its seed
    and sizes as arguments (seed 7, 8 nodes, 6 jobs are its own)."""
    from volcano_tpu.api.objects import (
        Affinity, Metadata, PersistentVolume, PersistentVolumeClaim, StorageClass, Taint,
        Toleration,
    )

    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        n = build_node(f"n{i}", cpu=str(rng.choice([4, 8])), memory=f"{rng.choice([8, 16])}Gi",
                       labels={"zone": "a" if i % 2 else "b"})
        if i == 0:
            n.taints.append(Taint(key="dedicated", value="x"))
        nodes.append(n)
    store = make_store(nodes=nodes, queues=[build_queue("default"),
                                            build_queue("batch", weight=2)])
    store.create("PodGroup", build_podgroup("res", min_member=1))
    for i in range(5):
        p = build_pod(f"res-{i}", group="res", cpu="1", memory="1Gi",
                      labels=rng.choice([{"app": "web"}, {"app": "db"}, {}]))
        if i % 2 == 0:
            p.spec.host_ports = [8000 + i]
        p.node_name = f"n{rng.randrange(1, n_nodes)}"
        p.phase = JPodPhase.RUNNING
        if i == 4:
            p.deleting = True  # a releasing resident: the pipeline path exists
        store.create("Pod", p)
    store.create("StorageClass", StorageClass(meta=Metadata(name="mixed", namespace=""),
                                              provisioner=""))
    store.create("PV", PersistentVolume(meta=Metadata(name="mp0", namespace=""),
                                        capacity="20Gi", storage_class="mixed",
                                        node_affinity={"kubernetes.io/hostname": "n2"}))
    store.create("PV", PersistentVolume(meta=Metadata(name="mp1", namespace=""),
                                        capacity="20Gi", storage_class="mixed"))
    for j in range(n_jobs):
        kind = ["ports", "aff", "anti", "vol", "sel", "plain"][j % 6]
        n_tasks = rng.randint(1, 3)
        queue = "batch" if j % 3 == 0 else "default"
        store.create("PodGroup", build_podgroup(f"rj{j}", min_member=rng.randint(1, n_tasks),
                                                queue=queue))
        if kind == "vol":
            store.create("PVC", PersistentVolumeClaim(
                meta=Metadata(name=f"mc{j}", namespace="default"), size="5Gi",
                storage_class="mixed"))
        for t in range(n_tasks):
            p = build_pod(f"rj{j}-{t}", group=f"rj{j}", cpu="1", memory="1Gi",
                          labels=rng.choice([{"app": "web"}, {}]))
            if kind == "ports":
                p.spec.host_ports = [8000 + (t % 3)]
            elif kind == "aff":
                p.spec.affinity = Affinity(pod_affinity=[{"app": "web"}])
            elif kind == "anti":
                p.spec.affinity = Affinity(pod_anti_affinity=[{"app": "db"}])
            elif kind == "vol":
                p.volumes = [f"mc{j}"]
            elif kind == "sel":
                p.spec.node_selector = {"zone": "a"}
                p.spec.tolerations = [Toleration(key="dedicated", operator="Exists")]
            store.create("Pod", p)
    return store


def _pass_state(store, ssn):
    state, errors = {}, {}
    for job in ssn.jobs.values():
        for task in job.tasks.values():
            state[task.key] = (task.status.name, task.node_name)
        if job.fit_errors:
            errors[job.uid] = (dict(job.fit_errors), job.fit_total_nodes)
    binds = {p.meta.key: p.node_name for p in store.list("Pod") if p.node_name}
    return state, errors, binds


def jax_residue_pass(store):
    ssn = jopen_session(JCache(store), jconf.default_conf().tiers)
    stats = {}
    JAllocate()._execute_host(ssn, job_filter=lambda job: True, vectorized=True, stats=stats)
    return _pass_state(store, ssn), stats


def port_residue_pass(store, vectorized, tiers=None):
    ssn = open_session(SchedulerCache(store), tiers or tconf.default_conf("cpu").tiers)
    stats = {}
    AllocateAction()._execute_host(ssn, job_filter=lambda job: True, vectorized=vectorized,
                                   stats=stats)
    return _pass_state(store, ssn), stats


MIXED = [(7, 8, 6), (0, 8, 12), (1, 12, 18), (2, 6, 12), (3, 16, 24), (4, 4, 16)]


@pytest.mark.parametrize("seed,n_nodes,n_jobs", MIXED)
def test_engine_equals_jax_engine(seed, n_nodes, n_jobs):
    """Statuses, nodes, fit-error histograms (with their node totals) and
    store binds of one residue pass, exact."""
    js = mixed_residue_store(seed, n_nodes, n_jobs)
    ts = port_store(js)
    (jstate, jerr, jbinds), jstats = jax_residue_pass(js)
    (tstate, terr, tbinds), tstats = port_residue_pass(ts, vectorized=True)
    assert tstats["tasks"] == jstats["tasks"] > 0
    assert tstate == jstate
    assert terr == jerr
    assert tbinds == jbinds
    # the pass placed residue tasks (gang-ready ones dispatch to binds)
    assert any(k.startswith("default/rj") for k in tbinds)


@pytest.mark.parametrize("seed,n_nodes,n_jobs", MIXED)
def test_engine_bit_for_bit_equals_per_task_loop(seed, n_nodes, n_jobs):
    """The twin of the JAX package's
    test_vectorized_residue_bit_for_bit_equals_per_task_loop, on the port."""
    js = mixed_residue_store(seed, n_nodes, n_jobs)
    (vstate, verr, vbinds), stats = port_residue_pass(port_store(js), vectorized=True)
    (lstate, lerr, lbinds), loop_stats = port_residue_pass(port_store(js), vectorized=False)
    assert stats.get("tasks", 0) > 0 and not loop_stats  # the engine ran, the loop did not
    assert vstate == lstate
    assert verr == lerr
    assert vbinds == lbinds


def test_engine_declines_an_unknown_chain():
    """A predicate chain the engine does not model (the predicates plugin
    registered twice) keeps the per-task loop: vector_allocate returns False
    and the filtered pass still places as the loop does."""
    tiers = tconf.default_conf("cpu").tiers
    tiers = [tconf.Tier(plugins=list(t.plugins)) for t in tiers]
    tiers.append(tconf.Tier(plugins=[tconf.PluginOption("predicates")]))
    js = mixed_residue_store()
    ssn = open_session(SchedulerCache(port_store(js)), tiers)
    assert not residue.chain_known(ssn)
    assert residue.vector_allocate(ssn, lambda job: True) is False
    (state, _, _), stats = port_residue_pass(port_store(js), vectorized=True, tiers=tiers)
    (lstate, _, _), _ = port_residue_pass(port_store(js), vectorized=False, tiers=tiers)
    assert not stats and state == lstate


def test_cycle_overlay_folds_published_binds_into_the_snapshot():
    store = port_store(mixed_residue_store())
    cache = SchedulerCache(store)
    pending = sorted(p.meta.key for p in store.list("Pod") if not p.node_name)
    key = pending[0]
    cache.cycle_overlay = {key: "n3", "default/res-0": "n5"}
    cluster = cache.snapshot()
    task = next(t for j in cluster.jobs.values() for k, t in j.tasks.items() if t.key == key)
    assert task.status == TaskStatus.BOUND and task.node_name == "n3"
    assert key in {t.key for t in cluster.nodes["n3"].tasks.values()}
    # a pod the store already holds on a node keeps it
    res0 = next(t for j in cluster.jobs.values() for t in j.tasks.values()
                if t.key == "default/res-0")
    assert res0.node_name == store.get("Pod", "default/res-0").node_name
    cache.cycle_overlay = {}
    again = cache.snapshot()
    task = next(t for j in again.jobs.values() for t in j.tasks.values() if t.key == key)
    assert task.status == TaskStatus.PENDING and not task.node_name


# -- the fast cycle with its sub-cycle -------------------------------------------

def _dyn_store(seed):
    """``tests/test_fastpath.py`` ``_dyn_store``: mixed_store plus one
    host-port pod and a defined StorageClass."""
    from test_fastpath import mixed_store

    from volcano_tpu.api.objects import Metadata, StorageClass

    store = mixed_store(seed)
    p = build_pod("dyn-0", group="job0", cpu="500m")
    p.spec.host_ports = [8080]
    store.create("Pod", p)
    store.create("StorageClass", StorageClass(meta=Metadata(name="sc", namespace="")))
    return store


def _conf(name, solve_mode="auto"):
    jc = jconf.full_conf("tpu") if name == "full" else jconf.default_conf("tpu")
    jc.solve_mode = solve_mode
    jc.exact_topk = True
    return jc


@pytest.mark.parametrize("conf_name", ["default", "full"])
@pytest.mark.parametrize("seed", range(4))
def test_dynamic_pod_partition_equals_jax(seed, conf_name, monkeypatch):
    """The express jobs solve on the device, the host-port job in the
    dynamic pass; under the full conf a preempt with possible work goes to
    the object sub-cycle.  Two cycles, equal to the JAX Scheduler."""
    run_pair(monkeypatch, lambda: _dyn_store(seed), jax_conf=_conf(conf_name),
             fast_path="auto", cycles=2, each_cycle=same_fast_cycle)


def _preempt_store():
    """``tests/test_fastpath.py``'s preempt case: two running 1-cpu tasks
    fill n0; a priority-10 job of the same queue starves."""
    pods = []
    for t in range(2):
        p = build_pod(f"rich-{t}", group="rich", cpu="1", memory="1Gi")
        p.node_name = "n0"
        p.phase = JPodPhase.RUNNING
        pods.append(p)
    pods.append(build_pod("poor-0", group="poor", cpu="1", memory="1Gi", priority=10))
    return make_store(nodes=[build_node("n0", cpu="2", memory="4Gi")],
                      podgroups=[build_podgroup("rich", min_member=1, queue="default"),
                                 build_podgroup("poor", min_member=1, queue="default")],
                      pods=pods)


def _with_port(build):
    """The same store with a pending host-port job in the queue: the cycle
    holds a dynamic job, so its preempt runs in the object sub-cycle."""
    def wrapped():
        store = build()
        store.create("PodGroup", build_podgroup("ported", min_member=1, queue="default"))
        p = build_pod("ported-0", group="ported", cpu="3", memory="1Gi")
        p.spec.host_ports = [9000]
        store.create("Pod", p)
        return store
    return wrapped


@pytest.mark.parametrize("variant", ["fast-preempt", "object-preempt"])
def test_preempt_case_equals_jax(variant, monkeypatch):
    """Victims evicted and the preemptor pipelined as the JAX Scheduler
    does, by the fast preempt pass or, beside a dynamic job, by the object
    preempt in the sub-cycle."""
    build = _preempt_store if variant == "fast-preempt" else _with_port(_preempt_store)
    phases = []

    def check(cycle, jsched, tsched):
        same_fast_cycle(cycle, jsched, tsched)
        phases.append(set(tsched.fast_cycle.phases))

    history, sched = run_pair(monkeypatch, build, jax_conf=_conf("full"), fast_path="auto",
                              each_cycle=check)
    assert sched.last_path == "fast"
    assert history[0][0] >= 1  # evictions
    assert ("subcycle" in phases[0]) == (variant == "object-preempt")


def jax_store(spec):
    """The JAX package's Store for a plain description: queues, priority
    classes, nodes, PodGroups (phase, priority class) and pods (labels,
    host ports, pod (anti)affinity, priority, running on a node)."""
    store = JStore()
    for pc in spec.get("priority_classes", ()):
        store.create("PriorityClass", jobj.PriorityClass(
            meta=jobj.Metadata(name=pc["name"], namespace=""), value=pc["value"]))
    for q in spec["queues"]:
        store.create("Queue", jobj.Queue(meta=jobj.Metadata(name=q["name"], namespace=""),
                                         weight=q.get("weight", 1)))
    for n in spec["nodes"]:
        store.create("Node", jobj.Node(meta=jobj.Metadata(name=n["name"], namespace=""),
                                       allocatable=JResource.from_resource_list(n["allocatable"])))
    for g in spec["podgroups"]:
        pg = jobj.PodGroup(meta=jobj.Metadata(name=g["name"], namespace="default"),
                           min_member=g["min_member"], queue=g["queue"],
                           priority_class_name=g.get("priority_class_name", ""))
        pg.status.phase = JPhase(g.get("phase", "Pending"))
        store.create("PodGroup", pg)
    for p in spec["pods"]:
        aff = None
        if p.get("pod_affinity") or p.get("pod_anti_affinity"):
            aff = jobj.Affinity(pod_affinity=list(p.get("pod_affinity", ())),
                                pod_anti_affinity=list(p.get("pod_anti_affinity", ())))
        store.create("Pod", jobj.Pod(
            meta=jobj.Metadata(name=p["name"], namespace="default",
                               annotations={JAX_POD_GROUP_KEY: p["group"]},
                               labels=dict(p.get("labels", {}))),
            spec=jobj.PodSpec(resources=JResource.from_resource_list(p["resources"]),
                              affinity=aff, host_ports=list(p.get("host_ports", ())),
                              priority=p.get("priority", 0)),
            phase=JPodPhase(p.get("phase", "Pending")), node_name=p.get("node_name", "")))
    return store


def cfg5r_spec(n_nodes, n_jobs, dynamic_frac, n_best_effort, be_every=5, seed=0):
    """chip_smoke.py's cfg5r as one description, cut in scale only: config 5
    with ``dynamic_frac`` dynamic gangs (tests/test_torch_dynamic.py
    ``cfg5d_spec``: even ones with a host port, odd ones with
    anti-affinity to their own label), one best-effort pod on every
    ``be_every``-th dynamic gang (those gangs become "best-effort" residue)
    and the rest of the ``n_best_effort`` pods on the next express gangs."""
    from test_torch_dynamic import cfg5d_spec

    n_dyn = int(n_jobs * dynamic_frac)
    n_dyn_be = len(range(0, n_dyn, be_every))
    spec = cfg5d_spec(n_nodes, n_jobs, dynamic_frac, n_best_effort - n_dyn_be, seed=seed)
    for j in range(0, n_dyn, be_every):
        spec["pods"].append({"name": f"be{j:05d}", "group": f"pg{j:05d}", "resources": {}})
    return spec


def test_cfg5r_at_hundredth_scale_equals_jax(monkeypatch):
    """cfg5r at 1/100 scale (100 nodes, 50 gangs x 20, 5 dynamic, 20
    best-effort pods of which one sits on dynamic gang 0), both solves
    batched as at full scale: gang 0 is "best-effort" residue and places in
    the sub-cycle on the engine.  Three cycles equal to the JAX Scheduler;
    every pod bound in the first."""
    spec = cfg5r_spec(100, 50, 0.10, 20)
    jc = _conf("full", solve_mode="batch")
    got = []

    def check(cycle, jsched, tsched):
        same_fast_cycle(cycle, jsched, tsched)
        got.append((dict(tsched.fast_cycle.last_residue_reasons),
                    set(tsched.fast_cycle.phases)))

    _, sched = run_pair(monkeypatch, lambda: jax_store(spec), jax_conf=jc, fast_path="auto",
                        cycles=3, each_cycle=check)
    assert got[0][0] == {"default/pg00000": "best-effort"}
    assert {"subcycle", "residue_vec", "dyn_solve"} <= got[0][1]
    pods = sched.cache.store.list("Pod")
    assert all(p.node_name for p in pods), [p.meta.key for p in pods if not p.node_name][:5]


def cfg6d_spec(n_nodes, n_gangs=10, ported=(0, 5)):
    """chip_smoke.py's cfg6d as one description: the cfg6 contended store
    (tests/test_torch_contention.py ``cfg6_spec``: every node full on cpu
    with ten 800m / 1.2Gi residents of q0) stormed by ``n_gangs`` urgent
    gangs x 20 of 1500m / 2Gi, gangs in ``ported`` giving each task host
    port 30000 + g."""
    from test_torch_contention import cfg6_spec

    spec = cfg6_spec(n_nodes, n_gangs)
    for p in spec["pods"]:
        if p["name"].startswith("h"):
            g = int(p["group"][3:])
            if g in ported:
                p["host_ports"] = [30000 + g]
    return spec


#: per cycle (evictions, pipelines, binds) of the JAX package on cfg6d's
#: storm on 1,000 nodes, victims reaped between cycles: the object preempt
#: in the sub-cycle takes two 800m victims a 1500m preemptor, the storm
#: binds in the next cycle
CFG6D_TENTH_PATTERN = [(400, 200, 0), (0, 0, 200), (0, 0, 0)]


def test_cfg6d_storm_on_tenth_of_the_nodes_equals_jax(monkeypatch):
    """cfg6d's storm (10 urgent gangs x 20, gangs 0 and 5 with a host port)
    on 1,000 nodes and 10,000 residents: the dynamic gangs send the preempt
    to the object sub-cycle, where the pending dynamic jobs keep it on the
    host preemptor walk in both packages.  Three cycles with the victims
    reaped, equal to the JAX Scheduler cycle by cycle."""
    phases = []

    def check(cycle, jsched, tsched):
        same_fast_cycle(cycle, jsched, tsched)
        phases.append(set(tsched.fast_cycle.phases))

    history, _ = run_pair(monkeypatch, lambda: jax_store(cfg6d_spec(1000)),
                          jax_conf=_conf("full"), fast_path="auto", cycles=3, reap=True,
                          each_cycle=check)
    assert "subcycle" in phases[0] and "preempt" not in phases[0]
    assert history == CFG6D_TENTH_PATTERN

"""The port's object path against the JAX package's.

* ``victim_step`` (K7): the JAX function, jitted on the CPU, against the
  port's plain version on ``simargs.build_victim_sim`` inputs over the
  three modes and the veto flag sets: decisions and the output state equal
  (tolerance: exact; the float sums of these inputs are exact in float32).
* The scenarios of the JAX package's object-path tests (victim parity,
  preempt/reclaim, tensor parity, host allocate, fair share, predicates and
  node order, enqueue): each is built once with the JAX test helpers and
  copied object by object, uids included, into the port's store; the JAX
  ``Scheduler`` (backend ``tpu``) and the port's (backend ``cpu``) run the
  same actions and tiers with ``fast_path: off`` and must give the same
  binds, the same evictions in order, the same pipelines in order, and the
  same pods, PodGroup phases and conditions (tolerance: exact).
* Config 6r with a best-effort reclaimer at 1/20 scale, cycle by cycle
  against the JAX ``Scheduler`` with ``fast_path: auto``: every cycle takes
  the object path in both packages.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from volcano_tpu.api.objects import Metadata as JMetadata
from volcano_tpu.api.objects import PodGroup as JPodGroup
from volcano_tpu.api.objects import PriorityClass as JPriorityClass
from volcano_tpu.api.objects import Affinity as JAffinity
from volcano_tpu.api.objects import Taint as JTaint
from volcano_tpu.api.objects import Toleration as JToleration
from volcano_tpu.api.resource import Resource as JResource
from volcano_tpu.api.types import PodGroupPhase as JPhase
from volcano_tpu.api.types import PodPhase as JPodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import session as jsession
from volcano_tpu.scheduler import simargs as jsim
from volcano_tpu.scheduler import statement as jstatement
from volcano_tpu.scheduler import victim_kernels as jvk
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch import api as tapi
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import session as tsession
from volcano_tpu_torch.scheduler import statement as tstatement
from volcano_tpu_torch.scheduler import victim_kernels as tvk
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store

from helpers import build_node, build_pod, build_podgroup, build_queue, make_store

torch.set_num_threads(1)

PodPhase = JPodPhase


# -- K7: victim_step ----------------------------------------------------------

FLAG_SETS = [
    dict(use_gang=True, use_drf=True, use_prop=False, use_conformance=True,
         order_by_priority=True),
    dict(use_gang=False, use_drf=False, use_prop=True, use_conformance=False,
         order_by_priority=False),
    dict(use_gang=True, use_drf=True, use_prop=True, use_conformance=True,
         order_by_priority=False),
    dict(use_gang=False, use_drf=False, use_prop=False, use_conformance=False,
         order_by_priority=True),
]


@pytest.mark.parametrize("seed,mode", list(itertools.product(range(3),
                                                             ["queue", "job", "reclaim"])))
def test_victim_step_plain_equals_jax(seed, mode):
    """Tolerance: exact, decisions and every output state field."""
    c, s = jsim.build_victim_sim(12, 90, 9, n_queues=3, seed=seed)
    tc, ts = interop.victim_from_arrays(c, s)
    jc = jvk.VictimConsts(**{k: jnp.asarray(v) for k, v in c.items()})
    js = jvk.VictimState(**{k: jnp.asarray(v) for k, v in s.items()})
    rng = np.random.default_rng(100 + seed)
    V = tc.run_req.shape[0]
    for kw in FLAG_SETS:
        t_req = np.array([rng.choice([500, 1500, 3000]),
                          rng.choice([512, 2048]) * (1 << 20)], np.float32)
        if rng.random() < 0.2:
            t_req[:] = 0  # an empty request: the do-while takes one victim
        jt = int(rng.integers(0, 9))
        qt = int(c["job_queue"][jt])
        jout = jvk.victim_step(jc, js, jnp.asarray(t_req), 0, jt, qt, mode=mode, **kw)
        tout = tvk.victim_step(tc, ts, torch.from_numpy(t_req), 0, jt, qt, mode=mode, **kw)
        assigned, nstar, vmask, clean = tvk.unpack_step(tout.packed.numpy(), V)
        assert assigned == bool(jout[1]) and clean == bool(jout[4]), kw
        assert nstar == (int(jout[2]) if assigned else 0), kw
        np.testing.assert_array_equal(vmask, np.asarray(jout[3]), err_msg=str(kw))
        assert int(tout.packed[3]) == int(vmask.sum())
        for f in tvk.VictimState._fields:
            np.testing.assert_array_equal(getattr(tout.state, f).numpy(),
                                          np.asarray(getattr(jout[0], f)), err_msg=f)


def test_victim_step_leaves_its_input_state():
    c, s = jsim.build_victim_sim(8, 40, 6, seed=7)
    tc, ts = interop.victim_from_arrays(c, s)
    before = [x.clone() for x in ts]
    out = tvk.victim_step(tc, ts, torch.tensor([2000.0, float(1 << 30)]), 0, 0, 0,
                          mode="queue")
    assert bool(out.packed[0])
    for a, b in zip(before, ts):
        assert torch.equal(a, b)


def test_pack_step_round_trips():
    rng = np.random.default_rng(3)
    for V in (8, 32, 33, 100):
        vmask = rng.random(V) < 0.3
        packed = tvk.pack_step(True, 5, False, torch.from_numpy(vmask))
        assigned, nstar, got, clean = tvk.unpack_step(packed.numpy(), V)
        assert (assigned, nstar, clean) == (True, 5, False)
        np.testing.assert_array_equal(got, vmask)


# -- the JAX store and conf, copied into the port -------------------------------

def _meta(m):
    return tapi.Metadata(name=m.name, namespace=m.namespace, uid=m.uid,
                         labels=dict(m.labels), annotations=dict(m.annotations),
                         owner=m.owner)


def _res(r):
    return tapi.Resource(r.milli_cpu, r.memory, dict(r.scalars), r.max_task_num)


def _affinity(a):
    if a is None:
        return None
    return tapi.Affinity(node_terms=[list(t) for t in a.node_terms],
                         preferred_node_terms=[(w, list(t)) for w, t in a.preferred_node_terms],
                         pod_affinity=[dict(x) for x in a.pod_affinity],
                         pod_anti_affinity=[dict(x) for x in a.pod_anti_affinity])


def _convert(kind, o):
    if kind == "Queue":
        return tapi.Queue(meta=_meta(o.meta), weight=o.weight)
    if kind == "PriorityClass":
        return tapi.PriorityClass(meta=_meta(o.meta), value=o.value,
                                  global_default=o.global_default)
    if kind == "Node":
        return tapi.Node(meta=_meta(o.meta), allocatable=_res(o.allocatable),
                         labels=dict(o.labels),
                         taints=[tapi.Taint(t.key, t.value, t.effect) for t in o.taints],
                         unschedulable=o.unschedulable,
                         conditions=[tapi.NodeCondition(c.kind, c.status) for c in o.conditions])
    if kind == "PodGroup":
        pg = tapi.PodGroup(meta=_meta(o.meta), min_member=o.min_member, queue=o.queue,
                           priority_class_name=o.priority_class_name,
                           min_resources=_res(o.min_resources))
        pg.status.phase = tapi.PodGroupPhase(o.status.phase.value)
        pg.status.conditions = [tapi.PodGroupCondition(c.kind, c.status, c.reason, c.message)
                                for c in o.status.conditions]
        return pg
    if kind == "StorageClass":
        return tapi.StorageClass(meta=_meta(o.meta), provisioner=o.provisioner,
                                 volume_binding_mode=o.volume_binding_mode)
    if kind == "PV":
        return tapi.PersistentVolume(meta=_meta(o.meta), capacity=o.capacity,
                                     storage_class=o.storage_class,
                                     node_affinity=dict(o.node_affinity),
                                     claim_ref=o.claim_ref, provisioned=o.provisioned)
    if kind == "PVC":
        return tapi.PersistentVolumeClaim(meta=_meta(o.meta), size=o.size,
                                          storage_class=o.storage_class,
                                          volume_name=o.volume_name, phase=o.phase)
    assert kind == "Pod"
    sp = o.spec
    spec = tapi.PodSpec(
        resources=_res(sp.resources), init_resources=_res(sp.init_resources),
        node_selector=dict(sp.node_selector), affinity=_affinity(sp.affinity),
        tolerations=[tapi.Toleration(t.key, t.operator, t.value, t.effect)
                     for t in sp.tolerations],
        host_ports=list(sp.host_ports), priority_class=sp.priority_class,
        priority=sp.priority, scheduler_name=sp.scheduler_name)
    return tapi.Pod(meta=_meta(o.meta), spec=spec, phase=tapi.PodPhase(o.phase.value),
                    node_name=o.node_name, deleting=o.deleting, volumes=list(o.volumes))


KINDS = ("Queue", "PriorityClass", "Node", "StorageClass", "PV", "PVC", "PodGroup", "Pod")


def port_store(jstore) -> Store:
    """The JAX store's objects, uids included, created in the port's store
    in the JAX store's resource-version order."""
    objs = sorted(((o.meta.resource_version, kind, o) for kind in KINDS
                   for o in jstore.list(kind)), key=lambda x: x[0])
    store = Store()
    for _, kind, o in objs:
        store.create(kind, _convert(kind, o))
    return store


def port_conf(jc) -> tconf.SchedulerConf:
    tiers = [tconf.Tier(plugins=[
        tconf.PluginOption(**{k: getattr(o, k) for k in tconf.PluginOption.__dataclass_fields__})
        for o in t.plugins]) for t in jc.tiers]
    return tconf.SchedulerConf(actions=list(jc.actions), tiers=tiers, backend="cpu",
                               solve_mode=jc.solve_mode, fast_path=jc.fast_path)


class Pipes:
    """Pipelines as (pod key, node), in call order, per package."""

    def __init__(self, monkeypatch, *classes):
        self.log = []
        for cls in classes:
            orig = cls.pipeline

            def wrapped(self_, task, hostname, _orig=orig):
                self.log.append((task.key, hostname))
                return _orig(self_, task, hostname)

            monkeypatch.setattr(cls, "pipeline", wrapped)


def _outcome(store, sched):
    pods = {p.meta.key: (p.node_name, p.deleting) for p in store.list("Pod")}
    claims = {c.meta.key: c.phase for c in store.list("PVC")}
    groups = {g.meta.key: (g.status.phase.value, g.status.running,
                           [(c.kind, c.status, c.reason, c.message)
                            for c in g.status.conditions])
              for g in store.list("PodGroup")}
    return {"binds": list(sched.cache.bind_log), "evicts": list(sched.cache.evict_log),
            "pods": pods, "groups": groups, "claims": claims}


def run_pair(monkeypatch, build, actions=None, tiers=None, fast_path="off",
             cycles=1, reap=False, jax_conf=None, each_cycle=None):
    """Both schedulers over ``cycles`` cycles (``reap``: evicted pods are
    deleted between cycles); asserts equal outcomes after every cycle, calls
    ``each_cycle(cycle, jax_scheduler, port_scheduler)`` if given, and
    returns the per-cycle (evictions, pipelines, binds) and the port's
    scheduler."""
    jpipes = Pipes(monkeypatch, jsession.Session, jstatement.Statement)
    tpipes = Pipes(monkeypatch, tsession.Session, tstatement.Statement)
    jc = jax_conf or jconf.default_conf("tpu")
    jc.backend = "tpu"
    if actions is not None:
        jc.actions = list(actions)
    if tiers is not None:
        jc.tiers = tiers
    jc.fast_path = fast_path
    js = build()
    ts = port_store(js)
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=port_conf(jc))
    history = []
    for cycle in range(cycles):
        n0 = (len(tsched.cache.evict_log), len(tpipes.log), len(tsched.cache.bind_log))
        jsched.run_once()
        tsched.run_once()
        jo, to = _outcome(js, jsched), _outcome(ts, tsched)
        for key in ("binds", "evicts", "pods", "groups", "claims"):
            assert to[key] == jo[key], f"cycle {cycle}: {key}"
        assert tpipes.log == jpipes.log, f"cycle {cycle}: pipelines"
        if each_cycle is not None:
            each_cycle(cycle, jsched, tsched)
        history.append((len(tsched.cache.evict_log) - n0[0], len(tpipes.log) - n0[1],
                        len(tsched.cache.bind_log) - n0[2]))
        if reap:
            for key, _ in tsched.cache.evict_log:
                if ts.get("Pod", key) is not None:
                    ts.delete("Pod", key)
                    js.delete("Pod", key)
    return history, tsched


SUBCYCLE_PHASES = ("subcycle", "residue_vec", "preempt", "dyn_solve", "vol_solve")


def same_fast_cycle(cycle, jsched, tsched):
    """``run_pair``'s ``each_cycle`` for fast cycles: the same path, the
    same residue reasons, and the sub-cycle phases present in both or in
    neither."""
    jfc, tfc = jsched.fast_cycle, tsched.fast_cycle
    # a JAX fast cycle that finished has published
    assert (tsched.last_path == "fast") == ("publish" in jfc.phases), f"cycle {cycle}"
    assert tfc.last_residue_reasons == jfc.last_residue_reasons, f"cycle {cycle}"
    if tsched.last_path == "fast":
        for phase in SUBCYCLE_PHASES:
            assert (phase in tfc.phases) == (phase in jfc.phases), f"cycle {cycle}: {phase}"


# -- scenarios ------------------------------------------------------------------

def _prio(store, low="low", high="high", low_v=1, high_v=100):
    store.create("PriorityClass", JPriorityClass(JMetadata(name=low, namespace=""), value=low_v))
    store.create("PriorityClass", JPriorityClass(JMetadata(name=high, namespace=""),
                                                 value=high_v))
    return store


def _running(name, group, node, cpu="1", priority=1, **kw):
    return build_pod(name, group=group, cpu=cpu, phase=PodPhase.RUNNING, node_name=node,
                     priority=priority, **kw)


def _occupied(n_nodes, per_node=2):
    return [_running(f"low-{i}-{j}", "pg-low", f"n{i}") for i in range(n_nodes)
            for j in range(per_node)]


def preempt_simple(low_min=1, n_nodes=1, high_tasks=1, high_cpu="1"):
    def build():
        pg_low = build_podgroup("pg-low", min_member=low_min)
        pg_low.priority_class_name = "low"
        pg_high = build_podgroup("pg-high", min_member=high_tasks)
        pg_high.priority_class_name = "high"
        return _prio(make_store(
            nodes=[build_node(f"n{i}", cpu="2", memory="4Gi") for i in range(n_nodes)],
            podgroups=[pg_low, pg_high],
            pods=_occupied(n_nodes) + [build_pod(f"high-{k}", group="pg-high", cpu=high_cpu,
                                                 priority=100) for k in range(high_tasks)]))
    return build


def reclaim_two_queues(q1_min=1, n_nodes=2, per_node=2, node_cpu="2"):
    def build():
        pods = [_running(f"q1-{i}-{j}", "pg-q1", f"n{i}", priority=0)
                for i in range(n_nodes) for j in range(per_node)]
        return make_store(
            nodes=[build_node(f"n{i}", cpu=node_cpu, memory="8Gi") for i in range(n_nodes)],
            queues=[build_queue("q1"), build_queue("q2")],
            podgroups=[build_podgroup("pg-q1", min_member=q1_min, queue="q1"),
                       build_podgroup("pg-q2", min_member=1, queue="q2")],
            pods=pods + [build_pod("q2-0", group="pg-q2", cpu="1")])
    return build


def conformance_critical():
    store = preempt_simple(high_cpu="2")()
    pod = store.get("Pod", "default/low-0-0")
    pod.spec.priority_class = "system-cluster-critical"
    store.update("Pod", pod)
    return store


def same_tier_intersection():
    return make_store(
        nodes=[build_node("n0", cpu="4", memory="8Gi")],
        queues=[build_queue("q1"), build_queue("q2")],
        podgroups=[build_podgroup("pg-a", min_member=2, queue="q1"),
                   build_podgroup("pg-b", min_member=1, queue="q1"),
                   build_podgroup("pg-q2", min_member=1, queue="q2")],
        pods=[_running("a-0", "pg-a", "n0", priority=0), _running("a-1", "pg-a", "n0", priority=0),
              _running("b-0", "pg-b", "n0", priority=0), build_pod("q2-0", group="pg-q2", cpu="1")])


def best_effort_preemptor():
    store = preempt_simple()()
    for p in list(store.list("Pod")):
        if p.meta.name != "low-0-0" and p.meta.name != "high-0":
            store.delete("Pod", p.meta.key)
    store.delete("Pod", "default/high-0")
    store.create("Pod", build_pod("hi-be", group="pg-high", cpu="0", memory="0", priority=100))
    return store


def random_victims(seed):
    """test_victim_parity's random clusters: running jobs filling up to
    4-cpu nodes, pending high-priority gangs, one to two queues."""
    def build():
        rng = np.random.default_rng(seed)
        n_nodes = int(rng.integers(2, 5))
        n_queues = int(rng.integers(1, 3))
        queues = [build_queue(f"q{q}", weight=int(rng.integers(1, 4))) for q in range(n_queues)]
        nodes = [build_node(f"n{i}", cpu="4", memory="8Gi") for i in range(n_nodes)]
        pods, pgs = [], []
        free = {f"n{i}": 4 for i in range(n_nodes)}
        for j in range(int(rng.integers(1, 4))):
            pgs.append(build_podgroup(f"pg-run-{j}", min_member=1,
                                      queue=f"q{int(rng.integers(0, n_queues))}"))
            for k in range(int(rng.integers(1, 4))):
                node = f"n{int(rng.integers(0, n_nodes))}"
                cpu = int(rng.integers(1, 3))
                if free[node] < cpu:
                    continue
                free[node] -= cpu
                pods.append(_running(f"run-{j}-{k}", f"pg-run-{j}", node, cpu=str(cpu),
                                     priority=int(rng.integers(0, 3))))
        for j in range(int(rng.integers(1, 3))):
            pg = build_podgroup(f"pg-pend-{j}", min_member=int(rng.integers(1, 3)),
                                queue=f"q{int(rng.integers(0, n_queues))}")
            pg.priority_class_name = "high"
            pgs.append(pg)
            for k in range(int(rng.integers(1, 4))):
                pods.append(build_pod(f"pend-{j}-{k}", group=f"pg-pend-{j}",
                                      cpu=str(int(rng.integers(1, 3))), priority=100))
        return _prio(make_store(nodes=nodes, queues=queues, podgroups=pgs, pods=pods))
    return build


def random_allocate(seed):
    """test_tensor_parity's random clusters: gang, priority, drf,
    proportion and nodeorder together."""
    def build():
        import random

        rng = random.Random(seed)
        nodes = [build_node(f"n{i:03d}", cpu=str(rng.choice([2, 4, 8])),
                            memory=f"{rng.choice([4, 8, 16])}Gi") for i in range(6)]
        queues = [build_queue(f"q{i}", weight=rng.choice([1, 2, 3])) for i in range(2)]
        queues.append(build_queue("default"))
        pgs, pods = [], []
        for j in range(8):
            n_tasks = rng.randint(1, 5)
            pgs.append(build_podgroup(f"job{j:03d}", min_member=rng.randint(1, n_tasks),
                                      queue=f"q{rng.randrange(2)}"))
            for t in range(n_tasks):
                pods.append(build_pod(f"job{j:03d}-{t}", group=f"job{j:03d}",
                                      cpu=str(rng.choice(["250m", "500m", "1", "2"])),
                                      memory=f"{rng.choice([256, 512, 1024, 2048])}Mi",
                                      priority=rng.choice([0, 0, 5, 10])))
        return make_store(nodes=nodes, queues=queues, podgroups=pgs, pods=pods)
    return build


def gang_with_best_effort():
    return make_store(
        nodes=[build_node("n0", cpu="8", memory="16Gi")],
        podgroups=[build_podgroup("mixed", min_member=4), build_podgroup("other", min_member=1)],
        pods=[build_pod("mixed-0", group="mixed", cpu="1"),
              build_pod("mixed-1", group="mixed", cpu="1"),
              build_pod("mixed-be0", group="mixed", cpu=0, memory=0),
              build_pod("mixed-be1", group="mixed", cpu=0, memory=0),
              build_pod("other-0", group="other", cpu="1")])


def oversubscribed():
    import random

    rng = random.Random(99)
    pgs, pods = [], []
    for j in range(10):
        n_tasks = rng.randint(1, 4)
        pgs.append(build_podgroup(f"g{j}", min_member=n_tasks, queue=f"q{j % 2}"))
        pods += [build_pod(f"g{j}-{t}", group=f"g{j}", cpu="1", memory="1Gi")
                 for t in range(n_tasks)]
    return make_store(nodes=[build_node("n0", cpu="4", memory="8Gi"),
                             build_node("n1", cpu="2", memory="4Gi")],
                      queues=[build_queue("q0", 2), build_queue("q1", 1), build_queue("default")],
                      podgroups=pgs, pods=pods)


def one_gang(n_tasks, min_member, node_cpu="4", nodes=1, cpu="1"):
    def build():
        return make_store(
            nodes=[build_node(f"n{i}", cpu=node_cpu, memory="8Gi") for i in range(nodes)],
            podgroups=[build_podgroup("pg1", min_member=min_member)],
            pods=[build_pod(f"p{i}", group="pg1", cpu=cpu) for i in range(n_tasks)])
    return build


def higher_priority_wins():
    pg_low, pg_high = build_podgroup("pg-low", 2), build_podgroup("pg-high", 2)
    pg_low.priority_class_name, pg_high.priority_class_name = "low", "high"
    return _prio(make_store(
        nodes=[build_node("n1", cpu="2", memory="4Gi")], podgroups=[pg_low, pg_high],
        pods=[*[build_pod(f"low{i}", group="pg-low", cpu="1", priority=1) for i in range(2)],
              *[build_pod(f"high{i}", group="pg-high", cpu="1", priority=10)
                for i in range(2)]]), high_v=10)


def best_effort_backfill():
    return make_store(nodes=[build_node("n1")], podgroups=[build_podgroup("pg1")],
                      pods=[build_pod("p0", group="pg1", cpu=0, memory=0)])


def drf_prefers_lower():
    return make_store(
        nodes=[build_node("n0", cpu="3", memory="6Gi")],
        podgroups=[build_podgroup("pg-a"), build_podgroup("pg-b")],
        pods=[_running("a-run-0", "pg-a", "n0", priority=0),
              _running("a-run-1", "pg-a", "n0", priority=0),
              build_pod("a-pend", group="pg-a", cpu="1"),
              build_pod("b-pend", group="pg-b", cpu="1")])


def two_queue_split(w1=1, w2=1, q1_tasks=4, memory="1Gi"):
    def build():
        return make_store(
            nodes=[build_node("n0", cpu="4", memory="8Gi")],
            queues=[build_queue("q1", weight=w1), build_queue("q2", weight=w2)],
            podgroups=[build_podgroup("pg-1", queue="q1"), build_podgroup("pg-2", queue="q2")],
            pods=[*[build_pod(f"q1-{i}", group="pg-1", cpu="1", memory=memory)
                    for i in range(q1_tasks)],
                  *[build_pod(f"q2-{i}", group="pg-2", cpu="1", memory=memory)
                    for i in range(4)]])
    return build


def drf_two_jobs():
    return make_store(
        nodes=[build_node("n0", cpu="4", memory="8Gi")],
        podgroups=[build_podgroup("pg-a"), build_podgroup("pg-b")],
        pods=[*[build_pod(f"a-{i}", group="pg-a", cpu="1") for i in range(4)],
              *[build_pod(f"b-{i}", group="pg-b", cpu="1") for i in range(4)]])


def with_pod_spec(nodes, n_pods, edit, running=()):
    """One gang's pods on the given nodes, each pod's spec edited by
    ``edit(i, spec)``; ``running``: (name, node, labels) residents."""
    def build():
        pods = [_running(n, "pg", node, labels=labels, priority=0) for n, node, labels in running]
        store = make_store(nodes=nodes(), podgroups=[build_podgroup("pg")],
                           pods=pods + [build_pod(f"p{i}", group="pg") for i in range(n_pods)])
        for i in range(n_pods):
            pod = store.get("Pod", f"default/p{i}")
            edit(i, pod.spec)
            store.update("Pod", pod)
        return store
    return build


def _set(**fields):
    def edit(_, spec):
        for k, v in fields.items():
            setattr(spec, k, v)
    return edit


def tainted():
    node = build_node("tainted")
    node.taints = [JTaint(key="dedicated", value="batch", effect="NoSchedule")]
    store = make_store(nodes=[node],
                       podgroups=[build_podgroup("pg-plain"), build_podgroup("pg-tol")],
                       pods=[build_pod("plain", group="pg-plain"),
                             build_pod("tolerant", group="pg-tol")])
    pod = store.get("Pod", "default/tolerant")
    pod.spec.tolerations = [JToleration(key="dedicated", operator="Equal", value="batch")]
    store.update("Pod", pod)
    return store


def filtered_nodes():
    cordoned, notready = build_node("cordoned"), build_node("notready")
    cordoned.unschedulable = True
    notready.conditions[0].status = "False"
    return make_store(nodes=[cordoned, notready, build_node("good")],
                      podgroups=[build_podgroup("pg")], pods=[build_pod("p0", group="pg")])


def enqueue_budget(min_cpus, running_cpu=8, queues=None):
    """test_enqueue's cluster: one 10-cpu node with ``running_cpu`` busy, and
    Pending groups of the given MinResources cpus (0: empty)."""
    def build():
        busy = JPodGroup(meta=JMetadata(name="busy", namespace="default"), min_member=1,
                         queue="qa" if queues else "default")
        busy.status.phase = JPhase.RUNNING
        pgs = [busy]
        for name, queue, cpu in min_cpus:
            pg = JPodGroup(meta=JMetadata(name=name, namespace="default"), min_member=1,
                           queue=queue, min_resources=JResource.from_resource_list(
                               {"cpu": str(cpu)} if cpu else {}))
            pg.status.phase = JPhase.PENDING
            pgs.append(pg)
        return make_store(
            nodes=[build_node("n0", cpu="10", memory="64Gi")],
            queues=[build_queue(q) for q in (queues or ["default"])], podgroups=pgs,
            pods=[_running(f"busy-{i}", "busy", "n0", priority=0) for i in range(running_cpu)])
    return build


def _tiers(*names):
    return [jconf.Tier(plugins=[jconf.PluginOption(n) for n in names])]


def _full(actions):
    c = jconf.full_conf("tpu")
    c.actions = list(actions)
    return c


def _labelled(*pairs):
    return lambda: [build_node(n, labels=labels) for n, labels in pairs]


def _two_nodes():
    return [build_node("n0"), build_node("n1")]


#: name -> (builder, kwargs of run_pair)
SCENARIOS = {
    # victim selection (test_victim_parity, test_preempt_reclaim)
    "preempt-simple": (preempt_simple(), dict(actions=["preempt"])),
    "preempt-gang-blocked": (preempt_simple(low_min=2), dict(actions=["preempt"])),
    "preempt-multi-node-gang": (preempt_simple(n_nodes=2, high_tasks=2, high_cpu="2"),
                                dict(actions=["preempt"])),
    "reclaim": (reclaim_two_queues(), dict(actions=["reclaim"])),
    "reclaim-victim-at-deserved": (reclaim_two_queues(n_nodes=1, node_cpu="4"),
                                   dict(actions=["reclaim"], tiers=_tiers("gang", "proportion"))),
    "reclaim-protects-gang": (reclaim_two_queues(q1_min=2, n_nodes=1),
                              dict(actions=["reclaim"])),
    "preempt-conformance": (conformance_critical, dict(jax_conf=_full(["preempt"]))),
    "reclaim-same-tier": (same_tier_intersection,
                          dict(actions=["reclaim"], tiers=_tiers("gang", "proportion"))),
    "preempt-best-effort": (best_effort_preemptor,
                            dict(actions=["enqueue", "allocate", "preempt"])),
    **{f"victims-random-{s}": (random_victims(s), dict(actions=(
        ["enqueue", "reclaim", "allocate", "backfill", "preempt"] if s % 2
        else ["reclaim", "preempt"]))) for s in range(8)},
    # the allocate solve (test_tensor_parity, test_allocate_host)
    **{f"allocate-random-{s}": (random_allocate(s), {}) for s in range(6)},
    "gang-with-best-effort": (gang_with_best_effort, {}),
    "oversubscribed": (oversubscribed, {}),
    "simple-job": (one_gang(3, 3, nodes=2), {}),
    "gang-insufficient": (one_gang(3, 3, node_cpu="2"), {}),
    "gang-partial": (one_gang(3, 2, node_cpu="2"), {}),
    "gang-unschedulable-condition": (one_gang(3, 3, node_cpu="1"), {}),
    "higher-priority-wins": (higher_priority_wins, {}),
    "invalid-gang": (one_gang(1, 5), {}),
    "best-effort-backfill": (best_effort_backfill, {}),
    # fair share (test_fair_share)
    "drf-prefers-lower": (drf_prefers_lower, dict(actions=["allocate"], tiers=_tiers("drf"))),
    "drf-share-updates": (drf_two_jobs, dict(actions=["allocate"], tiers=_tiers("drf"))),
    "proportion-overused": (two_queue_split(), dict(actions=["allocate"],
                                                    tiers=_tiers("gang", "proportion"))),
    "proportion-weighted": (two_queue_split(3, 1, memory="2Gi"),
                            dict(actions=["allocate"], tiers=_tiers("gang", "proportion"))),
    "proportion-capped": (two_queue_split(q1_tasks=1), dict(actions=["allocate"],
                                                             tiers=_tiers("gang", "proportion"))),
    # predicates and node order (test_predicates_nodeorder)
    "node-selector": (with_pod_spec(_labelled(("plain", {}), ("tpu", {"acc": "tpu"})), 1,
                                    _set(node_selector={"acc": "tpu"})), {}),
    "node-affinity": (with_pod_spec(
        _labelled(("n-east", {"zone": "east"}), ("n-west", {"zone": "west"})), 1,
        _set(affinity=JAffinity(node_terms=[[("zone", "In", ("west",))]]))), {}),
    "node-affinity-unsatisfiable": (with_pod_spec(
        _labelled(("n0", {"zone": "east"})), 1,
        _set(affinity=JAffinity(node_terms=[[("zone", "In", ("mars",))]]))), {}),
    "host-port-conflict": (with_pod_spec(_two_nodes, 3, _set(host_ports=[8080])), {}),
    "taints": (tainted, {}),
    "pod-affinity": (with_pod_spec(_two_nodes, 1,
                                   _set(affinity=JAffinity(pod_affinity=[{"role": "leader"}])),
                                   running=[("leader", "n1", {"role": "leader"})]), {}),
    "pod-anti-affinity": (with_pod_spec(_two_nodes, 1,
                                        _set(affinity=JAffinity(pod_anti_affinity=[{"app": "db"}])),
                                        running=[("a", "n0", {"app": "db"})]), {}),
    "unschedulable-and-notready": (filtered_nodes, {}),
    "max-task-num": (lambda: make_store(nodes=[build_node("n0", pods=2)],
                                        podgroups=[build_podgroup("pg")],
                                        pods=[build_pod(f"p{i}", group="pg") for i in range(3)]),
                     {}),
    "least-requested": (lambda: make_store(
        nodes=[build_node("n0", cpu="4", memory="8Gi"), build_node("n1", cpu="4", memory="8Gi")],
        podgroups=[build_podgroup("pg")],
        pods=[build_pod("p0", group="pg", cpu="2"), build_pod("p1", group="pg", cpu="2")]), {}),
    "preferred-node-affinity": (with_pod_spec(
        _labelled(("n-east", {"zone": "east"}), ("n-west", {"zone": "west"})), 1,
        _set(affinity=JAffinity(preferred_node_terms=[(50, [("zone", "In", ("east",))])]))), {}),
    # enqueue (test_enqueue)
    "enqueue-within-overcommit": (enqueue_budget([("fits", "default", 4)]),
                                  dict(jax_conf=_full(["enqueue"]))),
    "enqueue-beyond-overcommit": (enqueue_budget([("too-big", "default", 5)]),
                                  dict(jax_conf=_full(["enqueue"]))),
    "enqueue-consumes-budget": (enqueue_budget([("first", "default", 3),
                                                ("second", "default", 3)]),
                                dict(jax_conf=_full(["enqueue"]))),
    "enqueue-empty-min-resources": (enqueue_budget([("free", "default", 0)], running_cpu=10),
                                    dict(jax_conf=_full(["enqueue"]))),
    "enqueue-round-robin": (enqueue_budget([("ua", "qa", 0), ("ba", "qa", 3), ("bb", "qb", 3)],
                                           queues=["qa", "qb", "default"]),
                            dict(jax_conf=_full(["enqueue", "allocate"]))),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_object_path_scenario_equals_jax(name, monkeypatch):
    build, kw = SCENARIOS[name]
    run_pair(monkeypatch, build, **kw)


def _with_dynamic_job(build):
    """``build``'s store plus a two-task job with host ports: the object
    path's allocate places it on the host after the device pass."""
    def built():
        store = build()
        store.create("PodGroup", build_podgroup("dyn", min_member=2, queue="q0"))
        for t in range(2):
            pod = build_pod(f"dyn-{t}", group="dyn", cpu="500m")
            pod.spec.host_ports = [9000]
            store.create("Pod", pod)
        return store
    return built


@pytest.mark.parametrize("case", ["express", "with-dynamic-job"])
def test_bulk_apply_equals_jax(case, monkeypatch):
    """The bulk apply (above ``bulk_threshold`` placements, 5,000 by
    default; 2 here in both packages): binds, statuses and, with a dynamic
    job, the host pass after it over the nodes and shares it accounted."""
    for cls in (JScheduler, Scheduler):
        opened = cls._open_object_session

        def low_threshold(self, _opened=opened):
            ssn = _opened(self)
            ssn.tensor_backend.bulk_threshold = 2
            return ssn

        monkeypatch.setattr(cls, "_open_object_session", low_threshold)
    from volcano_tpu_torch.scheduler import tensor_actions

    bulk = tensor_actions._apply_bulk
    calls = []

    def counting(*a, **kw):
        calls.append(kw.get("account_nodes"))
        return bulk(*a, **kw)

    monkeypatch.setattr(tensor_actions, "_apply_bulk", counting)
    build = random_allocate(1)
    history, _ = run_pair(monkeypatch, build if case == "express" else _with_dynamic_job(build))
    assert history[0][2] > 2
    assert calls == [case != "express"]


def test_full_conf_cycles_equal_jax_with_reaping(monkeypatch):
    """Two cycles of the deployed five-action conf on a contended random
    cluster, the victims reaped between them."""
    history, sched = run_pair(monkeypatch, random_victims(5), jax_conf=_full(
        ["enqueue", "reclaim", "allocate", "backfill", "preempt"]), cycles=2, reap=True)
    assert sched.last_path == "object"


def _residue_case(case):
    """tests/test_torch_cycle.py's cluster_spec(2) with one job the JAX
    fast cycle leaves to its residue engine: 129 host ports, a best-effort
    pod beside pod anti-affinity, or two pending claims of one static
    class."""
    from test_torch_cycle import cluster_spec, jax_store_from_spec

    from volcano_tpu.api import POD_GROUP_KEY
    from volcano_tpu.api.objects import PersistentVolume, PersistentVolumeClaim, Pod, PodSpec
    from volcano_tpu.api.objects import StorageClass

    def pod(name, **kw):
        return Pod(meta=JMetadata(name=name, annotations={POD_GROUP_KEY: "job3"}),
                   spec=PodSpec(resources=JResource(500, 1 << 29), **kw))

    store = jax_store_from_spec(cluster_spec(2))
    if case == "port-overflow":
        store.create("Pod", pod("dyn", host_ports=list(range(20000, 20129))))
    elif case == "best-effort-dynamic":
        store.create("Pod", pod("anti", affinity=JAffinity(pod_anti_affinity=[{"a": "b"}])))
        be = pod("be")
        be.spec.resources = JResource()
        store.create("Pod", be)
    else:
        store.create("StorageClass", StorageClass(meta=JMetadata(name="local", namespace=""),
                                                  provisioner=""))
        for i in range(2):
            store.create("PV", PersistentVolume(meta=JMetadata(name=f"pv{i}", namespace=""),
                                                capacity="10Gi", storage_class="local"))
            store.create("PVC", PersistentVolumeClaim(meta=JMetadata(name=f"c{i}"), size="1Gi",
                                                      storage_class="local"))
        vol = pod("vol")
        vol.volumes = ["c0", "c1"]
        store.create("Pod", vol)
    return store


@pytest.mark.parametrize("case", ["port-overflow", "best-effort-dynamic", "volume"])
def test_residue_with_reclaim_work_takes_the_object_path(case, monkeypatch):
    """With a reclaim pass possible, the JAX fast cycle declines a cycle
    with residue jobs as a whole (its object path re-runs it from the
    store); the port does the same and equals it."""
    _, sched = run_pair(monkeypatch, lambda: _residue_case(case),
                        jax_conf=jconf.full_conf("tpu"), fast_path="auto")
    assert sched.last_path == "object"


# -- config 6r with a best-effort reclaimer at 1/20 scale -----------------------

def cfg6r_be_store(n_nodes=500, per_node=10, reclaim_gangs=10, gang_size=20):
    """chip_smoke's cfg6r store cut to ``n_nodes``: every node full on cpu
    with ``per_node`` 800m / 1.2Gi residents of q0 (jobs of 20); q1's
    ``reclaim_gangs`` gangs of 1500m / 2Gi tasks reclaiming; one
    empty-request pod with no selector in gang rec000."""
    pgs, pods = [], []
    n_run = n_nodes * per_node
    for j in range(n_run // 20):
        pg = build_podgroup(f"run{j:05d}", queue="q0")
        pg.status.phase = JPhase.RUNNING
        pgs.append(pg)
    for k in range(n_run):
        j = k // 20
        pods.append(_running(f"r{j:05d}-{k % 20}", f"run{j:05d}", f"n{k % n_nodes:05d}",
                             cpu="800m", memory=str(int(1.2 * (1 << 30))), priority=0))
    for j in range(reclaim_gangs):
        pgs.append(build_podgroup(f"rec{j:03d}", min_member=gang_size, queue="q1"))
        pods += [build_pod(f"rec{j:03d}-{t}", group=f"rec{j:03d}", cpu="1500m", memory="2Gi")
                 for t in range(gang_size)]
    # first in rec000's task order: its reclaim attempt is the host detour
    pods.append(build_pod("hbe000", group="rec000", cpu=0, memory=0))
    return make_store(
        nodes=[build_node(f"n{i:05d}", cpu="8", memory="16Gi") for i in range(n_nodes)],
        queues=[build_queue("q0"), build_queue("q1"), build_queue("default")],
        podgroups=pgs, pods=pods)


#: per cycle (evictions, pipelines, binds) of the JAX package on cfg6r-be at
#: 1/20 scale, victims reaped between cycles: the best-effort reclaimer
#: (host detour) takes one victim, nine gangs two each, one pipeline a gang;
#: chip_smoke.py checks this pattern at full scale
CFG6R_BE_PATTERN = [(19, 10, 0)] * 3


def test_cfg6r_best_effort_reclaimer_at_twentieth_scale_equals_jax(monkeypatch):
    from volcano_tpu_torch.scheduler import tensor_actions

    calls = {"jax": 0, "port": 0}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jvk, "victim_step", counting(jvk.victim_step, "jax"))
    monkeypatch.setattr(tensor_actions, "victim_step",
                        counting(tensor_actions.victim_step, "port"))
    history, sched = run_pair(monkeypatch, cfg6r_be_store, jax_conf=_full(
        ["enqueue", "reclaim", "allocate", "backfill", "preempt"]), fast_path="auto",
        cycles=3, reap=True)
    assert sched.last_path == "object"
    assert history == CFG6R_BE_PATTERN
    assert calls["port"] == calls["jax"] > 30

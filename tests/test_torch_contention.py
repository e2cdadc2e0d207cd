"""The port's reclaim and preempt passes against the JAX package's.

Each scenario of ``tests/test_fast_contention.py`` is written once as a
plain cluster description and instantiated in both packages
(``volcano_tpu_torch.interop.store_from_spec`` and the JAX twin below);
the port's ``Scheduler(store, full_conf("cpu"))`` must give the JAX
``Scheduler(store, full_conf("tpu"))``'s binds, its evictions in order,
its pipelined (pod, node) pairs in order, and its PodGroup phases.  A
cycle the fast passes decline runs on both object paths alike.
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
from volcano_tpu.scheduler import fast_victims as jfv
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import fast_victims as tfv
from volcano_tpu_torch.scheduler.scheduler import Scheduler

torch.set_num_threads(1)

PRIO = [{"name": "urgent", "value": 10}, {"name": "low", "value": 1}]
NODE = {"cpu": "4", "memory": "8Gi", "pods": 110}


def jax_store_from_spec(spec):
    store = JStore()
    for q in spec.get("queues", ()):
        store.create("Queue", jobj.Queue(meta=jobj.Metadata(name=q["name"], namespace=""),
                                         weight=q.get("weight", 1)))
    for n in spec.get("nodes", ()):
        store.create("Node", jobj.Node(meta=jobj.Metadata(name=n["name"], namespace=""),
                                       allocatable=JResource.from_resource_list(n["allocatable"])))
    for g in spec.get("podgroups", ()):
        pg = jobj.PodGroup(meta=jobj.Metadata(name=g["name"], namespace="default"),
                           min_member=g["min_member"], queue=g["queue"],
                           priority_class_name=g.get("priority_class_name", ""))
        pg.status.phase = JPhase(g.get("phase", "Pending"))
        store.create("PodGroup", pg)
    for p in spec.get("pods", ()):
        group = p.get("group", "")
        store.create("Pod", jobj.Pod(
            meta=jobj.Metadata(name=p["name"], namespace="default",
                               annotations={JAX_POD_GROUP_KEY: group} if group else {}),
            spec=jobj.PodSpec(resources=JResource.from_resource_list(p.get("resources", {})),
                              priority=p.get("priority", 0),
                              node_selector=dict(p.get("node_selector", {}))),
            phase=JPodPhase(p.get("phase", "Pending")),
            node_name=p.get("node_name", ""), deleting=p.get("deleting", False)))
    # priority classes last, as the JAX scenarios create them
    for pc in spec.get("priority_classes", ()):
        store.create("PriorityClass", jobj.PriorityClass(
            meta=jobj.Metadata(name=pc["name"], namespace=""), value=pc["value"]))
    return store


def _group(name, queue, min_member=1, pc="", phase="Inqueue"):
    return {"name": name, "min_member": min_member, "queue": queue,
            "priority_class_name": pc, "phase": phase}


def _pod(name, group, cpu="2", memory="2Gi", priority=0, node=None, **kw):
    p = {"name": name, "group": group, "resources": {"cpu": cpu, "memory": memory},
         "priority": priority, **kw}
    if node:
        p.update(node_name=node, phase="Running")
    return p


def preempt_spec():
    """Low-priority singleton gangs fill the cluster; an urgent two-task
    gang in the same queue starves: preempt must evict."""
    spec = {"priority_classes": PRIO, "queues": [{"name": "qa"}, {"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": NODE} for i in range(4)],
            "podgroups": [], "pods": []}
    for i in range(8):
        spec["podgroups"].append(_group(f"low{i}", "qa", pc="low"))
        spec["pods"].append(_pod(f"low{i}-0", f"low{i}", priority=1, node=f"n{i % 4}"))
    spec["podgroups"].append(_group("hi", "qa", 2, pc="urgent"))
    spec["pods"] += [_pod(f"hi-{t}", "hi", priority=10) for t in range(2)]
    return spec


def reclaim_spec():
    """qb's residents overuse its share while qa (weight 3) starves."""
    spec = {"priority_classes": PRIO,
            "queues": [{"name": "qa", "weight": 3}, {"name": "qb"}, {"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": NODE} for i in range(4)],
            "podgroups": [], "pods": []}
    for i in range(8):
        spec["podgroups"].append(_group(f"b{i}", "qb"))
        spec["pods"].append(_pod(f"b{i}-0", f"b{i}", node=f"n{i % 4}"))
    for j in range(2):
        spec["podgroups"].append(_group(f"a{j}", "qa"))
        spec["pods"].append(_pod(f"a{j}-0", f"a{j}"))
    return spec


def random_contended_spec(seed):
    rng = random.Random(seed)
    n_nodes = rng.choice([3, 5])
    spec = {"priority_classes": PRIO,
            "queues": [{"name": "qa", "weight": 2}, {"name": "qb"}, {"name": "default"}],
            "nodes": [{"name": f"n{i:02d}", "allocatable": NODE} for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    for i in range(2 * n_nodes):
        q = rng.choice(["qa", "qb"])
        spec["podgroups"].append(_group(f"run{i}", q, pc=rng.choice(["low", ""])))
        spec["pods"].append(_pod(f"run{i}-0", f"run{i}", priority=1, node=f"n{i % n_nodes:02d}"))
    for j in range(rng.randint(1, 3)):
        q = rng.choice(["qa", "qb"])
        n_tasks = rng.randint(1, 2)
        spec["podgroups"].append(_group(f"pend{j}", q, n_tasks, pc="urgent"))
        spec["pods"] += [_pod(f"pend{j}-{t}", f"pend{j}", priority=10) for t in range(n_tasks)]
    return spec


def storm_spec(n_nodes=12, per_node=8, n_gangs=24, gang_size=3):
    spec = {"priority_classes": PRIO, "queues": [{"name": "qa"}, {"name": "default"}],
            "nodes": [{"name": f"n{i:02d}", "allocatable": {
                "cpu": str(2 * per_node), "memory": "64Gi", "pods": 110}}
                for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    for i in range(n_nodes * per_node):
        spec["podgroups"].append(_group(f"low{i:03d}", "qa", pc="low"))
        spec["pods"].append(_pod(f"low{i:03d}-0", f"low{i:03d}", priority=1,
                                 node=f"n{i % n_nodes:02d}"))
    for g in range(n_gangs):
        spec["podgroups"].append(_group(f"hot{g:02d}", "qa", gang_size, pc="urgent"))
        spec["pods"] += [_pod(f"hot{g:02d}-{t}", f"hot{g:02d}", priority=10)
                         for t in range(gang_size)]
    return spec


def cross_queue_spec():
    spec = {"priority_classes": PRIO,
            "queues": [{"name": "qa"}, {"name": "qb"}, {"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": NODE} for i in range(4)],
            "podgroups": [], "pods": []}
    for i in range(4):
        spec["podgroups"].append(_group(f"a{i}", "qa", pc="low"))
        spec["pods"].append(_pod(f"a{i}-0", f"a{i}", priority=1, node=f"n{i}"))
        spec["podgroups"].append(_group(f"b{i}", "qb"))
        spec["pods"].append(_pod(f"b{i}-0", f"b{i}", priority=0, node=f"n{i}"))
    spec["podgroups"].append(_group("hi", "qa", 2, pc="urgent"))
    spec["pods"] += [_pod(f"hi-{t}", "hi", priority=10) for t in range(2)]
    return spec


class Recorder:
    """Pipelines as (pod key, node name), captured where each pass records
    them (the cycle does not publish pipelines)."""

    def __init__(self, monkeypatch, module):
        self.pipes = []
        orig = module.FastContention._append_records
        rec = self

        def wrapped(self_, evict_att, pipe_node, pipe_att, reason):
            n0 = len(self_.pipelines)
            orig(self_, evict_att, pipe_node, pipe_att, reason)
            snap = self_.snap
            rec.pipes += [(snap.task_uids[t], snap.node_names[n])
                          for t, n in self_.pipelines[n0:]]

        monkeypatch.setattr(module.FastContention, "_append_records", wrapped)


def _outcome(store, sched):
    pods = {p.meta.key: (p.node_name, p.deleting) for p in store.list("Pod")}
    phases = {g.meta.key: g.status.phase.value for g in store.list("PodGroup")}
    return {"binds": dict(sched.cache.bind_log), "evicts": list(sched.cache.evict_log),
            "pods": pods, "phases": phases}


def run_pair(spec, monkeypatch, actions=None, solve_mode="auto", cycles=1, reap=False,
             mesh="off"):
    """Both schedulers over ``cycles`` cycles, under the conf ``mesh`` (the
    JAX one with ``exactTopK``); with ``reap`` the evicted pods are deleted
    between cycles (the sim kubelet).  Asserts the port's outcome equals the
    JAX one after every cycle; returns the port's last outcome, its
    pipelines, and per cycle (evictions, pipelines, binds)."""
    jrec, trec = Recorder(monkeypatch, jfv), Recorder(monkeypatch, tfv)
    jc, tc = jconf.full_conf("tpu"), tconf.full_conf("cpu")
    for c in (jc, tc):
        c.solve_mode = solve_mode
        c.mesh = mesh
        if actions:
            c.actions = list(actions)
    if mesh != "off":
        jc.exact_topk = True
    js, ts = jax_store_from_spec(spec), interop.store_from_spec(spec)
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=tc)
    history = []
    for cycle in range(cycles):
        counts = (len(tsched.cache.evict_log), len(trec.pipes), len(tsched.cache.bind_log))
        jsched.run_once()
        tsched.run_once()
        assert jsched.fast_cycle.mirror is not None
        jo, to = _outcome(js, jsched), _outcome(ts, tsched)
        assert to["binds"] == jo["binds"], f"cycle {cycle}: binds"
        assert to["evicts"] == jo["evicts"], f"cycle {cycle}: evictions"
        assert trec.pipes == jrec.pipes, f"cycle {cycle}: pipelines"
        assert to["pods"] == jo["pods"], f"cycle {cycle}: pods"
        assert to["phases"] == jo["phases"], f"cycle {cycle}: phases"
        history.append((len(tsched.cache.evict_log) - counts[0], len(trec.pipes) - counts[1],
                        len(tsched.cache.bind_log) - counts[2]))
        if reap:
            for key, _ in tsched.cache.evict_log:
                if ts.get("Pod", key) is not None:
                    ts.delete("Pod", key)
                    js.delete("Pod", key)
    return to, trec.pipes, history


def test_preempt_equals_jax(monkeypatch):
    out, pipes, _ = run_pair(preempt_spec(), monkeypatch)
    assert out["evicts"] and all(r == "preempt" for _, r in out["evicts"])
    assert len(pipes) == 2


def test_reclaim_equals_jax(monkeypatch):
    out, pipes, _ = run_pair(reclaim_spec(), monkeypatch)
    assert out["evicts"] and all(r == "reclaim" for _, r in out["evicts"])
    assert pipes


@pytest.mark.parametrize("seed", range(8))
def test_random_contention_equals_jax(seed, monkeypatch):
    run_pair(random_contended_spec(seed), monkeypatch)


def test_best_effort_preemptor_equals_jax(monkeypatch):
    """Without backfill a pending best-effort task reaches preempt: the
    task arrays are re-packed with it, and it takes exactly one victim."""
    spec = preempt_spec()
    spec["pods"].append({"name": "hi-be", "group": "hi", "resources": {}})
    out, _, _ = run_pair(spec, monkeypatch, actions=["enqueue", "allocate", "preempt"])
    assert len(out["evicts"]) == 3


def test_best_effort_repack_keeps_binds_equal_jax(monkeypatch):
    """Spare capacity and a best-effort preemptor: the re-pack before
    preempt must not shift the binds the solve made."""
    spec = {"priority_classes": PRIO, "queues": [{"name": "qa"}, {"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": NODE} for i in range(2)],
            "podgroups": [_group("aaa", "qa"), _group("zzz", "qa", 2)],
            "pods": [_pod("aaa-0", "aaa", cpu="1", memory="1Gi", priority=5),
                     {"name": "aaa-be", "group": "aaa", "resources": {},
                      "node_selector": {"zone": "nowhere"}}]
            + [_pod(f"zzz-{t}", "zzz", cpu="1", memory="1Gi") for t in range(2)]}
    out, _, _ = run_pair(spec, monkeypatch)
    bound = {k for k, (n, _) in out["pods"].items() if n}
    assert bound == {"default/aaa-0", "default/zzz-0", "default/zzz-1"}


def test_two_cycle_convergence_equals_jax(monkeypatch):
    """After the kubelet reaps the victims, the next cycle binds the
    preemptors, in both packages alike."""
    out, _, _ = run_pair(preempt_spec(), monkeypatch, cycles=2, reap=True)
    assert out["pods"]["default/hi-0"][0] and out["pods"]["default/hi-1"][0]


def test_rounds_above_threshold_equal_jax(monkeypatch):
    """A storm wider than the threshold takes the batched rounds; every
    gang is served, one victim a task, and binds on the next cycle."""
    spec = storm_spec()
    assert 24 * 3 > tfv.CONTENTION_BATCH_THRESHOLD
    out, _, _ = run_pair(spec, monkeypatch, cycles=2, reap=True)
    assert len(out["evicts"]) == 24 * 3
    assert all(out["pods"][f"default/hot{g:02d}-{t}"][0] for g in range(24) for t in range(3))


def test_rounds_never_evict_cross_queue_equal_jax(monkeypatch):
    out, _, _ = run_pair(cross_queue_spec(), monkeypatch, solve_mode="batch")
    preempted = [k for k, r in out["evicts"] if r == "preempt"]
    assert preempted and all("/a" in k for k in preempted)


def cfg6_spec(n_nodes, n_gangs, gang_size=20, per_node=10, reclaim_gangs=0):
    """bench.py's contended store at a smaller node count: every node full
    on cpu with ``per_node`` 800m / 1.2Gi residents of q0 (jobs of 20), and
    either an urgent 1500m / 2Gi storm in q0 or, with ``reclaim_gangs``, a
    second queue's gangs reclaiming."""
    spec = {"priority_classes": [{"name": "urgent", "value": 100}],
            "queues": [{"name": "q0"}, {"name": "default"}],
            "nodes": [{"name": f"n{i:05d}", "allocatable": {
                "cpu": "8", "memory": "16Gi", "pods": 110}} for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    n_run = n_nodes * per_node
    for j in range(n_run // 20):
        spec["podgroups"].append(_group(f"run{j:05d}", "q0", phase="Running"))
    for k in range(n_run):
        j = k // 20
        spec["pods"].append(_pod(f"r{j:05d}-{k % 20}", f"run{j:05d}", cpu="800m",
                                 memory=str(int(1.2 * (1 << 30))), node=f"n{k % n_nodes:05d}"))
    if reclaim_gangs:
        spec["queues"].insert(1, {"name": "q1"})
        for j in range(reclaim_gangs):
            spec["podgroups"].append(_group(f"rec{j:03d}", "q1", gang_size))
            spec["pods"] += [_pod(f"c{j:03d}-{t}", f"rec{j:03d}", cpu="1500m", memory="2Gi")
                             for t in range(gang_size)]
    for j in range(n_gangs):
        spec["podgroups"].append(_group(f"hot{j:03d}", "q0", gang_size, pc="urgent"))
        spec["pods"] += [_pod(f"h{j:03d}-{t}", f"hot{j:03d}", cpu="1500m", memory="2Gi")
                         for t in range(gang_size)]
    return spec


#: per cycle (evictions, pipelines, binds) of the JAX package on the three
#: config-6 cells at 1/10 scale, victims reaped between cycles: the storm
#: takes two 800m victims a 1500m preemptor and binds in the next cycle;
#: reclaim pipelines one task a gang a cycle (reclaim.go pops each job
#: once), so no 20-task gang ever reaches the allocate gate whole
TENTH_PATTERN = {
    "cfg6": [(400, 200, 0), (0, 0, 200), (0, 0, 0)],
    "cfg6b": [(400, 200, 0), (0, 0, 200), (0, 0, 0)],
    "cfg6r": [(20, 10, 0), (20, 10, 0), (20, 10, 0)],
}


def tenth_scale_spec(cell):
    if cell == "cfg6r":
        return cfg6_spec(1000, 0, reclaim_gangs=10)
    spec = cfg6_spec(1000, 10)
    if cell == "cfg6b":
        # an empty-request pod no node admits: its gang takes the exact loop
        spec["pods"].append({"name": "hbe000", "group": "hot000", "resources": {},
                             "node_selector": {"zone": "nowhere"}})
    return spec


@pytest.mark.parametrize("cell", sorted(TENTH_PATTERN))
def test_cfg6_pattern_at_tenth_scale_equals_jax(cell, monkeypatch):
    """The config-6 cells at 1/10 scale (1,000 nodes, 10,000 residents;
    10 x 20 storm gangs through the batched rounds, or 10 x 20 reclaiming
    gangs), three cycles with the victims reaped between them.  The memory
    sums pass 2^24 ulps of the 1.2Gi requests here, so this is where the
    reference's float32 global cumulative sums and the port's float64
    segment sums could part: they must still decide alike, cycle by cycle."""
    _, _, history = run_pair(tenth_scale_spec(cell), monkeypatch, cycles=3, reap=True)
    assert history == TENTH_PATTERN[cell]


#: per cycle (evictions, pipelines, binds) of the JAX package on cfg6 at
#: 1/10 scale under solveMode: exact, victims reaped between cycles: the
#: preempt pass walks every storm task one attempt at a time (K9 in the
#: port) and the storm binds in the next cycle
TENTH_EXACT_PATTERN = [(400, 200, 0), (0, 0, 200), (0, 0, 0)]


def test_cfg6_exact_pattern_at_tenth_scale_equals_jax(monkeypatch):
    """cfg6 at 1/10 scale under solveMode: exact (1,000 nodes, 10 x 20
    storm gangs, every storm task through the preempt walk), three cycles
    with the victims reaped between them, equal to the JAX Scheduler cycle
    by cycle."""
    _, _, history = run_pair(tenth_scale_spec("cfg6"), monkeypatch, solve_mode="exact",
                             cycles=3, reap=True)
    assert history == TENTH_EXACT_PATTERN


def test_stranded_walk_raises_naming_the_object_path(monkeypatch):
    """clean=False: qa's reclaimer (2 cpu / 256Mi) walks n0 first, whose qb
    victim (1 cpu / 1Gi) is valid (not below the request in memory) but
    does not cover it; the reference's walk would strand that eviction.
    The fast cycle declines such a cycle as the JAX one does, and the port's
    object path replays the walk on the host: binds, evictions, pipelines,
    pods and PodGroups equal the JAX Scheduler's."""
    from test_torch_object import run_pair as run_object_pair

    spec = {"queues": [{"name": "qa", "weight": 3}, {"name": "qb"}, {"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": NODE} for i in range(2)],
            "podgroups": [_group("b0", "qb"), _group("b1", "qb"), _group("a0", "qa")],
            "pods": [_pod("b0-0", "b0", cpu="1", memory="1Gi", node="n0"),
                     _pod("b1-0", "b1", cpu="4", memory="1Gi", node="n1"),
                     _pod("a0-0", "a0", cpu="2", memory="256Mi")]}
    history, sched = run_object_pair(monkeypatch, lambda: jax_store_from_spec(spec),
                                     jax_conf=jconf.full_conf("tpu"), fast_path="auto")
    assert sched.last_path == "object"
    assert history[0][0] >= 1  # the stranded eviction happened, as in the reference

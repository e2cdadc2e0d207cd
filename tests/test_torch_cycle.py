"""The port's express cycle against the JAX package's.

One seeded cluster description (numpy) is instantiated in both packages
(``volcano_tpu_torch.interop.store_from_spec`` and a JAX twin below); the
port's ``build_fast_snapshot`` must equal the JAX one field for field, and
the port's ``Scheduler(..., backend="cpu").run_once()`` must give the same
{pod -> node} binds and PodGroup phases as the JAX ``Scheduler`` with
``backend: tpu`` and the same actions and tiers — on the exact path and on
the batch path (``solveMode: batch``; JAX with ``exactTopK``).  Also: the
port imports neither jax nor volcano_tpu, its default backend needs a
card, and clusters outside its slice raise.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from volcano_tpu.api import POD_GROUP_KEY as JAX_POD_GROUP_KEY
from volcano_tpu.api import objects as jobj
from volcano_tpu.api.resource import Resource as JResource
from volcano_tpu.api.types import PodGroupPhase as JPhase
from volcano_tpu.api.types import PodPhase as JPodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.fastpath import ArrayMirror as JMirror
from volcano_tpu.scheduler.fastpath import build_fast_snapshot as jax_build_fast_snapshot
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch import interop
from volcano_tpu_torch.api import POD_GROUP_KEY
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.fastpath import ArrayMirror, build_fast_snapshot
from volcano_tpu_torch.scheduler.scheduler import Scheduler

# the plain versions are many small ops: one intra-op thread each, so that
# parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parent.parent / "volcano_tpu_torch"
ACTIONS = ["enqueue", "allocate", "backfill"]


def cluster_spec(seed, n_nodes=8, n_jobs=10, running_jobs=3, best_effort=3,
                 max_tasks=6, tasks=(1, 5)):
    """Queues, nodes, PodGroups (some Pending, admitted by enqueue), pending
    pods, running pods (some being deleted, so nodes have releasing
    capacity), and a few best-effort pods, all from one seed."""
    rng = np.random.default_rng(seed)
    spec = {
        "queues": [{"name": "qa", "weight": 2}, {"name": "qb", "weight": 1},
                   {"name": "default", "weight": 1}],
        "nodes": [
            {"name": f"n{i:02d}", "allocatable": {
                "cpu": str(int(rng.choice([4, 8]))),
                "memory": f"{int(rng.choice([8, 16]))}Gi", "pods": max_tasks}}
            for i in range(n_nodes)
        ],
        "podgroups": [], "pods": [],
    }
    for j in range(n_jobs):
        n_tasks = int(rng.integers(tasks[0], tasks[1] + 1))
        running = j < running_jobs
        spec["podgroups"].append({
            "name": f"job{j}", "min_member": int(rng.integers(1, n_tasks + 1)),
            "queue": str(rng.choice(["qa", "qb"])),
            "phase": "Running" if running else str(rng.choice(["Pending", "Inqueue"])),
        })
        for t in range(n_tasks):
            pod = {"name": f"job{j}-{t}", "group": f"job{j}",
                   "resources": {"cpu": str(rng.choice(["500m", "1", "2"])),
                                 "memory": f"{int(rng.choice([512, 1024, 2048]))}Mi"},
                   "priority": int(rng.choice([0, 5]))}
            if running:
                # some running pods are being deleted: releasing capacity
                pod.update(node_name=f"n{t % n_nodes:02d}", phase="Running",
                           deleting=bool(rng.random() < 0.4))
            spec["pods"].append(pod)
        if j >= running_jobs and j < running_jobs + best_effort:
            spec["pods"].append({"name": f"be{j}", "group": f"job{j}", "resources": {}})
    return spec


def jax_store_from_spec(spec):
    """The JAX package's Store for the same description."""
    store = JStore()
    for q in spec["queues"]:
        store.create("Queue", jobj.Queue(meta=jobj.Metadata(name=q["name"], namespace=""),
                                         weight=q["weight"]))
    for n in spec["nodes"]:
        store.create("Node", jobj.Node(meta=jobj.Metadata(name=n["name"], namespace=""),
                                       allocatable=JResource.from_resource_list(n["allocatable"])))
    for g in spec["podgroups"]:
        pg = jobj.PodGroup(meta=jobj.Metadata(name=g["name"], namespace="default"),
                           min_member=g["min_member"], queue=g["queue"])
        pg.status.phase = JPhase(g["phase"])
        store.create("PodGroup", pg)
    for p in spec["pods"]:
        store.create("Pod", jobj.Pod(
            meta=jobj.Metadata(name=p["name"], namespace="default",
                               annotations={JAX_POD_GROUP_KEY: p["group"]}),
            spec=jobj.PodSpec(resources=JResource.from_resource_list(p["resources"]),
                              priority=p.get("priority", 0)),
            phase=JPodPhase(p.get("phase", "Pending")),
            node_name=p.get("node_name", ""), deleting=p.get("deleting", False)))
    return store


def _state(store):
    pods = {p.meta.key: p.node_name for p in store.list("Pod")}
    phases = {g.meta.key: g.status.phase.value for g in store.list("PodGroup")}
    return pods, phases


def _run_pair(spec, solve_mode="auto", cycles=1):
    jc = jconf.full_conf("tpu")
    jc.actions = list(ACTIONS)
    jc.solve_mode = solve_mode
    jc.exact_topk = True
    tc = tconf.full_conf("cpu")
    tc.solve_mode = solve_mode
    js, ts = jax_store_from_spec(spec), interop.store_from_spec(spec)
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=tc)
    for _ in range(cycles):
        jsched.run_once()
        tsched.run_once()
    assert jsched.fast_cycle.mirror is not None  # JAX ran its fast cycle
    return (js, jsched), (ts, tsched)


def test_conf_is_the_jax_full_conf_minus_contention():
    j, t = jconf.full_conf("tpu"), tconf.full_conf("cpu")
    assert t.actions == [a for a in j.actions if a not in ("reclaim", "preempt")]
    assert [[p.name for p in tier.plugins] for tier in t.tiers] == \
        [[p.name for p in tier.plugins] for tier in j.tiers]
    assert tconf.SchedulerConf().backend == "cuda"


@pytest.mark.parametrize("seed", range(4))
def test_fast_snapshot_equals_jax(seed):
    spec = cluster_spec(seed)
    jm = JMirror(jax_store_from_spec(spec), "volcano-tpu", "default")
    jm.drain()
    jsnap, _ = jax_build_fast_snapshot(jm)
    tm = ArrayMirror(interop.store_from_spec(spec), "volcano-tpu", "default")
    tm.drain()
    assert tm.ineligible_reason() is None
    tsnap, _ = build_fast_snapshot(tm)
    for name in ("dims", "node_names", "task_uids", "job_uids", "queue_names"):
        assert getattr(tsnap, name) == list(getattr(jsnap, name)), name
    for name in (
        "eps", "node_idle", "node_releasing", "node_used", "node_alloc",
        "node_max_tasks", "node_task_count", "node_valid", "task_req",
        "task_job", "task_class", "task_valid", "job_queue",
        "job_min_available", "job_priority", "job_creation", "job_ready_init",
        "job_alloc_init", "job_schedulable", "job_start", "job_ntasks",
        "queue_weight", "queue_alloc_init", "queue_request", "queue_valid",
        "queue_participates", "class_node_mask", "class_node_score", "total",
    ):
        np.testing.assert_array_equal(getattr(tsnap, name), getattr(jsnap, name), err_msg=name)


def test_snapshot_from_arrays_round_trip():
    spec = cluster_spec(7)
    jm = JMirror(jax_store_from_spec(spec), "volcano-tpu", "default")
    jm.drain()
    jsnap, _ = jax_build_fast_snapshot(jm)
    tsnap = interop.snapshot_from_arrays(vars(jsnap))
    np.testing.assert_array_equal(tsnap.task_req, jsnap.task_req)
    assert tsnap.node_names == jsnap.node_names
    assert tsnap.class_node_mask.shape == jsnap.class_node_mask.shape
    assert tsnap.task_req is not jsnap.task_req


@pytest.mark.parametrize("seed", range(5))
def test_exact_cycle_binds_and_phases_equal_jax(seed):
    (js, jsched), (ts, tsched) = _run_pair(cluster_spec(seed), cycles=2)
    jpods, jphases = _state(js)
    tpods, tphases = _state(ts)
    assert tpods == jpods
    assert tphases == jphases
    assert sorted(tsched.cache.bind_log) == sorted(jsched.cache.bind_log)
    assert any(tpods.values())
    assert set(tsched.fast_cycle.phases) == {
        "drain", "snapshot", "enqueue", "solve", "backfill", "publish"}


@pytest.mark.parametrize("seed", range(4))
def test_batch_cycle_binds_and_phases_equal_jax(seed):
    spec = cluster_spec(seed + 10, n_nodes=10, n_jobs=14, tasks=(2, 6))
    (js, jsched), (ts, tsched) = _run_pair(spec, solve_mode="batch", cycles=2)
    assert _state(ts) == _state(js)
    assert sorted(tsched.cache.bind_log) == sorted(jsched.cache.bind_log)


def cfg5_shaped_spec(n_nodes=300, n_jobs=210, tasks_per_job=20, best_effort=80):
    """bench.py's config-5 store at a smaller scale: 20-task gangs in two
    weighted queues, Pending PodGroups (enqueue admits them), best-effort
    pods on the first gangs.  4,200 pending tasks: above BATCH_THRESHOLD, so
    the "auto" solve mode picks the batched solve."""
    rng = np.random.default_rng(0)
    spec = {"queues": [{"name": "q0", "weight": 2}, {"name": "q1", "weight": 1},
                       {"name": "default", "weight": 1}],
            "nodes": [{"name": f"n{i:05d}", "allocatable": {
                "cpu": f"{int(rng.choice([8, 16, 32]))}",
                "memory": f"{int(rng.choice([16, 32, 64]))}Gi", "pods": 110}}
                for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    cpus = rng.choice([250, 500, 1000, 2000], n_jobs * tasks_per_job)
    mems = rng.choice([256, 512, 1024, 2048], n_jobs * tasks_per_job)
    for j in range(n_jobs):
        spec["podgroups"].append({"name": f"pg{j:05d}", "min_member": tasks_per_job,
                                  "queue": f"q{j % 2}", "phase": "Pending"})
        for t in range(tasks_per_job):
            k = j * tasks_per_job + t
            spec["pods"].append({"name": f"p{j:05d}-{t}", "group": f"pg{j:05d}",
                                 "resources": {"cpu": f"{cpus[k]}m", "memory": f"{mems[k]}Mi"}})
        if j < best_effort:
            spec["pods"].append({"name": f"be{j:05d}", "group": f"pg{j:05d}", "resources": {}})
    return spec


def test_cfg5_shaped_cycle_equal_jax():
    (js, jsched), (ts, tsched) = _run_pair(cfg5_shaped_spec())
    pods, phases = _state(ts)
    assert (pods, phases) == _state(js)
    assert all(pods.values())  # capacity covers demand, as in config 5


def with_accelerators(spec, seed):
    """A scalar resource on the nodes and on every third pod: R = 3."""
    rng = np.random.default_rng(seed)
    for n in spec["nodes"]:
        n["allocatable"]["accelerator"] = str(int(rng.integers(0, 3)))
    for p in spec["pods"][::3]:
        if p["resources"]:
            p["resources"]["accelerator"] = "1"
    return spec


@pytest.mark.parametrize("solve_mode", ["exact", "batch"])
def test_scalar_resource_cycle_equal_jax(solve_mode):
    spec = with_accelerators(cluster_spec(1), 1)
    (js, jsched), (ts, tsched) = _run_pair(spec, solve_mode=solve_mode)
    assert tsched.fast_cycle.mirror.dims == ["cpu", "memory", "accelerator"]
    assert _state(ts) == _state(js)


def test_incremental_cycle_sees_new_job():
    spec = cluster_spec(1, running_jobs=0)
    (js, jsched), (ts, tsched) = _run_pair(spec)
    late = {"podgroups": [{"name": "late", "min_member": 2, "queue": "qa", "phase": "Inqueue"}],
            "pods": [{"name": f"late-{t}", "group": "late",
                      "resources": {"cpu": "500m", "memory": "256Mi"}} for t in range(2)]}
    for store, build in ((js, jax_store_from_spec), (ts, interop.store_from_spec)):
        extra = build({"queues": [], "nodes": [], **late})
        for kind in ("PodGroup", "Pod"):
            for obj in extra.list(kind):
                store.create(kind, obj)
    jsched.run_once()
    tsched.run_once()
    assert _state(ts) == _state(js)


def test_unschedulable_condition_written():
    spec = {"queues": [{"name": "default", "weight": 1}],
            "nodes": [{"name": "n0", "allocatable": {"cpu": "1", "memory": "2Gi", "pods": 10}}],
            "podgroups": [{"name": "pg", "min_member": 1, "queue": "default", "phase": "Inqueue"}],
            "pods": [{"name": "p0", "group": "pg", "resources": {"cpu": "4", "memory": "1Gi"}}]}
    store = interop.store_from_spec(spec)
    sched = Scheduler(store, conf=tconf.full_conf("cpu"))
    sched.run_once()
    pg = store.get("PodGroup", "default/pg")
    cond = next(c for c in pg.status.conditions if c.kind == "Unschedulable")
    assert "insufficient cpu" in cond.message
    rv = store.resource_version
    sched.run_once()
    assert store.resource_version == rv  # steady state writes nothing


# -- hygiene -----------------------------------------------------------------

def test_port_imports_neither_jax_nor_volcano_tpu():
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "volcano_tpu"):
                    bad.append(f"{path.relative_to(PKG.parent)}:{node.lineno} {n}")
    assert not bad, bad


def test_default_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = interop.store_from_spec(cluster_spec(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(store)
    assert POD_GROUP_KEY == JAX_POD_GROUP_KEY


def _pod(name, **spec_kw):
    from volcano_tpu_torch.api import Metadata, Pod, PodSpec, Resource

    return Pod(meta=Metadata(name=name, annotations={POD_GROUP_KEY: "job3"}),
               spec=PodSpec(resources=Resource(500, 1 << 29), **spec_kw))


@pytest.mark.parametrize("case,match", [
    ("preempt", "contention slice"),
    ("plugin", "object path"),
    ("ports", "dynamic-predicate slice"),
    ("volume", "volume slice"),
])
def test_out_of_slice_clusters_raise(case, match):
    from volcano_tpu_torch.api import Affinity

    store = interop.store_from_spec(cluster_spec(2))
    conf = tconf.full_conf("cpu")
    if case == "preempt":
        conf.actions = ["enqueue", "allocate", "backfill", "preempt"]
    elif case == "plugin":
        conf.tiers[0].plugins.append(tconf.PluginOption("binpack"))
    elif case == "ports":
        store.create("Pod", _pod("dyn", host_ports=[8080]))
        store.create("Pod", _pod("anti", affinity=Affinity(pod_anti_affinity=[{"a": "b"}])))
    else:
        pod = _pod("vol")
        pod.volumes = ["claim"]
        store.create("Pod", pod)
    with pytest.raises(NotImplementedError, match=match):
        Scheduler(store, conf=conf).run_once()

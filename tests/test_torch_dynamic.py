"""The port's dynamic-predicate pass (host ports, pod (anti)affinity)
against the JAX package's.

* Kernels: ``allocate_solve`` and ``allocate_solve_batch`` with the
  ``portsel`` extension on ``build_sim_args`` clusters plus seeded
  ``build_portsel_args`` resident and task bitsets.  The port takes the
  bitsets packed (u32 words as int32), the JAX kernels unpacked (bool and
  float32).  Decision outputs must be equal; float state is held to
  rtol=1e-6, though bit-equality is expected (whole-unit requests, exact
  sums).  The batch solve runs JAX with exact_topk=True.
* The interpod score rounds once on the reference (a fused multiply-add):
  a two-node near tie built so that the fused and the unfused forms pick
  different nodes pins that.
* Snapshot: the port's ``build_fast_snapshot`` partition and
  ``build_dyn_solve_inputs`` equal the JAX ones field for field, and the
  mirror's per-node port and selector counts follow deletes and node
  rebirth as the JAX mirror's do.
* Slice: the port's ``Scheduler(..., backend="cpu").run_once()`` binds the
  same {pod -> node} and writes the same PodGroup phases as the JAX
  ``Scheduler`` with ``backend: tpu`` on seeded clusters with residents
  (ports, labels) and express / ports / affinity / anti-affinity / mixed
  jobs: on the exact path, the batch path, a cluster with only dynamic
  jobs, and over two cycles; and config 5's dynamic-gang pattern at 1/100
  of its scale, where both bind everything in the first cycle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.api import POD_GROUP_KEY as JAX_POD_GROUP_KEY
from volcano_tpu.api import objects as jobj
from volcano_tpu.api.resource import Resource as JResource
from volcano_tpu.api.types import PodGroupPhase as JPhase
from volcano_tpu.api.types import PodPhase as JPodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import kernels as JK
from volcano_tpu.scheduler.fastpath import ArrayMirror as JMirror
from volcano_tpu.scheduler.fastpath import build_fast_snapshot as jax_build_fast_snapshot
from volcano_tpu.scheduler.fastpath.snapshot_build import (
    build_dyn_solve_inputs as jax_build_dyn_solve_inputs,
)
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import kernels as TK
from volcano_tpu_torch.scheduler.fastpath import ArrayMirror, build_fast_snapshot
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import build_dyn_solve_inputs
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.scheduler.simargs import (
    PORTSEL_KEYS,
    add_releasing,
    build_portsel_args,
    build_sim_args,
)
from volcano_tpu_torch.scheduler.tensor_actions import torch_allocate_solve
from volcano_tpu_torch.scheduler.tensor_backend import TensorBackend

# the plain versions are many small ops: one intra-op thread each, so that
# parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

DECISIONS = ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps")
WF = ("queue_weight", "queue_request", "total", "eps", "queue_participates")
ACTIONS = ["enqueue", "allocate", "backfill"]


# -- kernels -------------------------------------------------------------------

def _unpack(words):
    return TK.unpack_bits(words).numpy()


def jax_portsel(p):
    """The JAX kernels' unpacked portsel tuple for packed inputs ``p``."""
    return (
        jnp.asarray(_unpack(p["node_ports"])), jnp.asarray(_unpack(p["task_ports"])),
        jnp.asarray(p["node_selcnt"].astype(np.float32)),
        jnp.asarray(_unpack(p["task_aff"]).astype(np.float32)),
        jnp.asarray(_unpack(p["task_anti"]).astype(np.float32)),
        jnp.asarray(_unpack(p["task_self"]).astype(np.float32)),
        jnp.float32(p["w_podaff"]),
    )


def torch_portsel(p):
    return tuple(p[k] if k == "w_podaff" else torch.from_numpy(p[k]) for k in PORTSEL_KEYS)


def _solve_both(a, p, batch, w=(1.0, 1.0), **kw):
    des = np.asarray(JK.water_fill(*[jnp.asarray(a[k]) for k in WF]))
    jargs = [jnp.asarray(des) if k == "queue_deserved" else jnp.asarray(a[k]) for k in TK._SOLVE_ARGS]
    targs = [torch.from_numpy(des) if k == "queue_deserved" else torch.from_numpy(a[k])
             for k in TK._SOLVE_ARGS]
    jw = (jnp.float32(w[0]), jnp.float32(w[1]))
    if batch:
        oj = JK.allocate_solve_batch(*jargs, *jw, portsel=jax_portsel(p), exact_topk=True, **kw)
        ot = TK.allocate_solve_batch(*targs, *w, portsel=torch_portsel(p), **kw)
    else:
        oj = JK.allocate_solve(*jargs, *jw, portsel=jax_portsel(p))
        ot = TK.allocate_solve(*targs, *w, portsel=torch_portsel(p))
    return oj, ot


def _assert_same(oj, ot):
    for i, name in enumerate(TK.SolveOut._fields):
        x, y = np.asarray(oj[i]), ot[i].numpy()
        if name in DECISIONS:
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-6, err_msg=name)


def portsel_case(seed, w_podaff):
    """14 nodes (4 of them busy, some releasing), 48 tasks in 12 jobs of
    three queues, pod caps, two predicate classes on odd seeds."""
    a = build_sim_args(14, 48, 12, n_queues=3, seed=seed, n_classes=1 + seed % 2, class_fill=0.8)
    if seed:
        add_releasing(a, seed)
    a["node_max_tasks"][:] = 4 + seed
    return a, build_portsel_args(14, 48, seed=seed, n_jobs=12, w_podaff=w_podaff)


VARIANTS = {"exact": (False, {}), "batch": (True, {}),
            "batch-small-chunks": (True, dict(m_chunk=4, p_chunk=3))}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("w_podaff", [1.0, 0.1])
@pytest.mark.parametrize("seed", range(4))
def test_portsel_solve_matches_jax(seed, w_podaff, variant):
    a, p = portsel_case(seed, w_podaff)
    batch, kw = VARIANTS[variant]
    oj, ot = _solve_both(a, p, batch, **kw)
    _assert_same(oj, ot)
    assert int((ot.task_kind > 0).sum()) > 0


def test_portsel_cases_exercise_the_extension():
    """The seeded cases hold ports, required, anti and self bits, and the
    extension changes the outcome: the same solve without portsel places
    tasks differently."""
    a, p = portsel_case(1, 1.0)
    for key in ("task_ports", "task_aff", "task_anti", "task_self", "node_ports"):
        assert p[key].any(), key
    assert (_unpack(p["task_anti"]) & _unpack(p["task_self"])).any()
    _, with_ps = _solve_both(a, p, batch=True)
    des = TK.water_fill(*[torch.from_numpy(a[k]) for k in WF])
    plain = TK.allocate_solve_batch(
        *[des if k == "queue_deserved" else torch.from_numpy(a[k]) for k in TK._SOLVE_ARGS],
        1.0, 1.0)
    assert not torch.equal(with_ps.task_node, plain.task_node)


def _jitter(j, n):
    """The batch solve's tie-break jitter bits for (job j, node n)."""
    h = ((((j * 2654435761) & 0xFFFFFFFF) ^ ((n * 40503) & 0xFFFFFFFF)) * 2246822519) & 0xFFFFFFFF
    return np.float32((h ^ (h >> 15)) & 0xFFFF)


def _near_tie_case(batch):
    """Two nodes, one task with a required selector matched 3 times on node
    0 and once on node 1, zero resource score weights, and class scores
    chosen so that node 1's score equals node 0's when ``s0 + 0.1 * 3``
    rounds once and exceeds it when the product rounds first, or the other
    way round (the batch solve's jitter included).  Returns the inputs and
    the node the fused form picks."""
    f32, w = np.float32, np.float32(0.1)
    jscale = f32(1e-4 / 65535.0)

    def fma(a, b, c):
        return f32(np.float64(a) * np.float64(b) + np.float64(c))

    def final(n, s):  # the batch solve adds the jitter with one more fma
        return fma(_jitter(0, n), jscale, s) if batch else s

    rng = np.random.default_rng(1)
    while True:
        s0 = f32(rng.uniform(0, 10))
        fused, unfused = final(0, fma(w, 3, s0)), final(0, f32(s0 + f32(w * f32(3))))
        if fused == unfused:
            continue
        hi = max(fused, unfused)
        s1 = f32(np.float64(hi) - np.float64(w) - (float(_jitter(0, 1)) * float(jscale) if batch else 0.0))
        for _ in range(64):
            v1 = final(1, f32(s1 + w))
            if v1 == hi:
                break
            s1 = np.nextafter(s1, f32(-np.inf) if v1 > hi else f32(np.inf))
        if final(1, f32(s1 + w)) == hi:
            break
    a = build_sim_args(2, 1, 1, n_queues=1)
    a["class_score"][0, :2] = (s0, s1)
    p = build_portsel_args(2, 1, n_jobs=1, w_podaff=0.1, resident_frac=0.0)
    for key in ("task_ports", "task_aff", "task_anti"):
        p[key][:] = 0
    p["task_aff"][0, 0] = 1 << 5
    p["node_selcnt"][0, 5], p["node_selcnt"][1, 5] = 3, 1
    return a, p, (0 if fused >= hi else 1)


@pytest.mark.parametrize("batch", [False, True])
def test_interpod_score_rounds_once_like_jax(batch):
    a, p, fused_pick = _near_tie_case(batch)
    oj, ot = _solve_both(a, p, batch, w=(0.0, 0.0))
    assert int(np.asarray(oj[0])[0]) == fused_pick  # the reference fuses
    _assert_same(oj, ot)


# -- clusters ------------------------------------------------------------------

LABELS = [{"app": "web"}, {"app": "db"}, {"tier": "gold"}, {}]


def dyn_spec(seed, n_nodes=6, jobs=(3, 6), kinds=("express", "ports", "aff", "anti", "mixed"),
             prefix="j"):
    """``tests/test_dynamic_solve.py``'s random store as one description:
    Running residents with labels and host ports, and pending jobs, each
    plain ("express"), with host ports, required or anti pod affinity, or
    mixed (only the first task has a port); best-effort pods on some
    express jobs."""
    rng = np.random.default_rng(seed)
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
    spec = {
        "queues": [{"name": "default", "weight": 1}, {"name": "qa", "weight": 2}],
        "nodes": [{"name": f"n{i:02d}", "allocatable": {
            "cpu": str(pick([4, 8])), "memory": f"{pick([8, 16])}Gi", "pods": 110}}
            for i in range(n_nodes)],
        "podgroups": [{"name": "res", "min_member": 1, "queue": "default", "phase": "Running"}],
        "pods": [],
    }
    for i in range(int(rng.integers(2, 7))):
        pod = {"name": f"res-{i}", "group": "res", "resources": {"cpu": "1", "memory": "1Gi"},
               "labels": pick(LABELS), "node_name": f"n{int(rng.integers(n_nodes)):02d}",
               "phase": "Running"}
        if rng.random() < 0.5:
            pod["host_ports"] = [pick([80, 8080, 9090])]
        spec["pods"].append(pod)
    more = extra_jobs(rng, jobs, kinds, prefix)
    spec["podgroups"] += more["podgroups"]
    spec["pods"] += more["pods"]
    return spec


def extra_jobs(rng, jobs, kinds, prefix):
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
    groups, pods = [], []
    for j in range(int(rng.integers(jobs[0], jobs[1] + 1))):
        n_tasks = int(rng.integers(1, 4))
        name = f"{prefix}{j}"
        kind = pick(kinds)
        groups.append({"name": name, "min_member": int(rng.integers(1, n_tasks + 1)),
                       "queue": pick(["default", "qa"]), "phase": pick(["Pending", "Inqueue"])})
        for t in range(n_tasks):
            pod = {"name": f"{name}-{t}", "group": name,
                   "resources": {"cpu": pick(["500m", "1", "2"]), "memory": "1Gi"},
                   "labels": pick(LABELS)}
            if kind == "ports" or (kind == "mixed" and t == 0):
                pod["host_ports"] = [pick([80, 8080, 9090])]
            elif kind == "aff":
                pod["pod_affinity"] = [pick([{"app": "web"}, {"tier": "gold"}])]
            elif kind == "anti":
                pod["pod_anti_affinity"] = [pick([{"app": "web"}, {"app": "db"}])]
            pods.append(pod)
        if kind == "express" and rng.random() < 0.5:
            pods.append({"name": f"{name}-be", "group": name, "resources": {}})
    return {"podgroups": groups, "pods": pods}


def jax_store_from_spec(spec, store=None):
    """The JAX package's Store for the same description (added to
    ``store`` when given)."""
    store = store if store is not None else JStore()
    for q in spec.get("queues", ()):
        store.create("Queue", jobj.Queue(meta=jobj.Metadata(name=q["name"], namespace=""),
                                         weight=q["weight"]))
    for n in spec.get("nodes", ()):
        store.create("Node", jobj.Node(meta=jobj.Metadata(name=n["name"], namespace=""),
                                       allocatable=JResource.from_resource_list(n["allocatable"])))
    for g in spec.get("podgroups", ()):
        pg = jobj.PodGroup(meta=jobj.Metadata(name=g["name"], namespace="default"),
                           min_member=g["min_member"], queue=g["queue"])
        pg.status.phase = JPhase(g["phase"])
        store.create("PodGroup", pg)
    for p in spec.get("pods", ()):
        aff = None
        if p.get("pod_affinity") or p.get("pod_anti_affinity"):
            aff = jobj.Affinity(pod_affinity=list(p.get("pod_affinity", ())),
                                pod_anti_affinity=list(p.get("pod_anti_affinity", ())))
        store.create("Pod", jobj.Pod(
            meta=jobj.Metadata(name=p["name"], namespace="default",
                               annotations={JAX_POD_GROUP_KEY: p["group"]},
                               labels=dict(p.get("labels", {}))),
            spec=jobj.PodSpec(resources=JResource.from_resource_list(p["resources"]),
                              affinity=aff, host_ports=list(p.get("host_ports", ()))),
            phase=JPodPhase(p.get("phase", "Pending")), node_name=p.get("node_name", "")))
    return store


def _state(store):
    return ({p.meta.key: p.node_name for p in store.list("Pod")},
            {g.meta.key: g.status.phase.value for g in store.list("PodGroup")})


def _schedulers(spec, solve_mode):
    jc = jconf.full_conf("tpu")
    jc.actions = list(ACTIONS)
    jc.solve_mode = solve_mode
    jc.exact_topk = True
    tc = tconf.full_conf("cpu")
    tc.actions = list(ACTIONS)
    tc.solve_mode = solve_mode
    js, ts = jax_store_from_spec(spec), interop.store_from_spec(spec)
    return (js, JScheduler(js, conf=jc)), (ts, Scheduler(ts, conf=tc))


def _run_and_compare(jpair, tpair):
    (js, jsched), (ts, tsched) = jpair, tpair
    jsched.run_once()
    tsched.run_once()
    assert not jsched.fast_cycle.last_residue_reasons
    assert _state(ts) == _state(js)
    assert sorted(tsched.cache.bind_log) == sorted(jsched.cache.bind_log)
    assert ("dyn_solve" in tsched.fast_cycle.phases) == ("dyn_solve" in jsched.fast_cycle.phases)
    return "dyn_solve" in tsched.fast_cycle.phases


@pytest.mark.parametrize("seed", range(5))
def test_dynamic_cycle_exact_equals_jax(seed):
    jpair, tpair = _schedulers(dyn_spec(seed), "auto")
    _run_and_compare(jpair, tpair)
    assert any(p for p in _state(tpair[0])[0].values())


@pytest.mark.parametrize("seed", range(3))
def test_dynamic_cycle_batch_equals_jax(seed):
    jpair, tpair = _schedulers(dyn_spec(seed + 20, n_nodes=8, jobs=(5, 8)), "batch")
    _run_and_compare(jpair, tpair)


@pytest.mark.parametrize("solve_mode", ["exact", "batch"])
def test_only_dynamic_jobs_equal_jax(solve_mode):
    """No express work pending: the express solve is skipped and the
    dynamic pass runs alone."""
    spec = dyn_spec(7, jobs=(4, 6), kinds=("ports", "aff", "anti", "mixed"))
    jpair, tpair = _schedulers(spec, solve_mode)
    _run_and_compare(jpair, tpair)
    assert "solve" in tpair[1].fast_cycle.phases


@pytest.mark.parametrize("seed", range(2))
def test_two_cycles_residents_constrain_equal_jax(seed):
    """Pods bound in cycle 1 become residents whose ports and labels
    constrain cycle 2's new dynamic jobs, through the mirror's per-node
    counts."""
    jpair, tpair = _schedulers(dyn_spec(seed + 40), "auto")
    _run_and_compare(jpair, tpair)
    rng = np.random.default_rng(seed + 400)
    more = extra_jobs(rng, (3, 5), ("ports", "anti", "aff", "mixed"), "late")
    jax_store_from_spec(more, jpair[0])
    extra = interop.store_from_spec(more)
    for kind in ("PodGroup", "Pod"):
        for obj in extra.list(kind):
            tpair[0].create(kind, obj)
    _run_and_compare(jpair, tpair)
    ports = tpair[1].fast_cycle.mirror.n_port_cnt
    assert ports.max() <= 1  # no node holds a host port twice


def cfg5d_spec(n_nodes, n_jobs, dynamic_frac, n_best_effort, seed=0):
    """Config 5 with dynamic gangs (bench.py config5_dynamic) as one
    description, cut in scale only: 20-task gangs in queues q0/q1 (plus
    default) on nodes of 8/16/32 cores and 16/32/64 Gi; the first
    ``dynamic_frac`` of the gangs are dynamic, even ones with host port
    20000 + j % 64 on every task, odd ones labelled grp=g{j % 48} with
    anti-affinity to that label; one best-effort pod on each of the next
    ``n_best_effort`` gangs."""
    rng = np.random.default_rng(seed)
    n_dyn = int(n_jobs * dynamic_frac)
    spec = {
        "queues": [{"name": "q0", "weight": 2}, {"name": "q1", "weight": 1},
                   {"name": "default", "weight": 1}],
        "nodes": [{"name": f"n{i:05d}", "allocatable": {
            "cpu": str(int(rng.choice([8, 16, 32]))),
            "memory": f"{int(rng.choice([16, 32, 64]))}Gi", "pods": 110}}
            for i in range(n_nodes)],
        "podgroups": [], "pods": [],
    }
    for j in range(n_jobs):
        name = f"pg{j:05d}"
        spec["podgroups"].append({"name": name, "min_member": 20, "queue": f"q{j % 2}",
                                  "phase": "Pending"})
        for t in range(20):
            pod = {"name": f"p{j:05d}-{t}", "group": name, "resources": {
                "cpu": f"{int(rng.choice([250, 500, 1000, 2000]))}m",
                "memory": f"{int(rng.choice([256, 512, 1024, 2048]))}Mi"}}
            if j < n_dyn and j % 2 == 0:
                pod["host_ports"] = [20000 + j % 64]
            elif j < n_dyn:
                pod["labels"] = {"grp": f"g{j % 48}"}
                pod["pod_anti_affinity"] = [{"grp": f"g{j % 48}"}]
            spec["pods"].append(pod)
        if n_dyn <= j < n_dyn + n_best_effort:
            spec["pods"].append({"name": f"be{j:05d}", "group": name, "resources": {}})
    return spec


def test_cfg5d_pattern_binds_in_one_cycle_like_jax():
    """Config 5 with 10% dynamic gangs at 1/100 of its scale (100 nodes,
    50 gangs x 20 tasks, 20 best-effort pods), both solves batched as at
    full scale: the JAX package binds every gang task and best-effort pod
    in its first cycle, and the port binds the same pods to the same
    nodes."""
    spec = cfg5d_spec(100, 50, 0.10, 20)
    jpair, tpair = _schedulers(spec, "batch")
    assert _run_and_compare(jpair, tpair)
    binds, phases = _state(jpair[0])
    assert all(binds.values()), [k for k, v in binds.items() if not v][:5]
    assert "Pending" not in phases.values()
    for store in (jpair[0], tpair[0]):
        on_node = {}
        for pod in store.list("Pod"):
            on_node.setdefault(pod.node_name, []).append(pod)
        for pods in on_node.values():
            ports = [port for pod in pods for port in pod.spec.host_ports]
            groups = [pod.meta.labels["grp"] for pod in pods if "grp" in pod.meta.labels]
            assert len(ports) == len(set(ports)) and len(groups) == len(set(groups))


# -- snapshot ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_dyn_snapshot_and_solve_inputs_equal_jax(seed):
    spec = dyn_spec(seed)
    jm = JMirror(jax_store_from_spec(spec), "volcano-tpu", "default")
    jm.drain()
    jsnap, jaux = jax_build_fast_snapshot(jm)
    tstore = interop.store_from_spec(spec)
    tsched = Scheduler(tstore, conf=tconf.full_conf("cpu"))
    tm = ArrayMirror(tstore, "volcano-tpu", "default")
    tm.drain()
    tsnap, taux = build_fast_snapshot(tm)
    for name in ("task_req", "task_job", "task_valid", "job_start", "job_ntasks",
                 "class_node_mask", "node_used", "job_schedulable"):
        np.testing.assert_array_equal(getattr(tsnap, name), getattr(jsnap, name), err_msg=name)
    for key in ("pe_rows", "dyn_job", "dyn_expr_job"):
        np.testing.assert_array_equal(taux[key], jaux[key], err_msg=key)
    assert taux["partition_unsafe"] == jaux["partition_unsafe"]
    assert taux["residue_keys"] == jaux["residue_keys"]
    np.testing.assert_array_equal(tm.n_port_cnt[: len(tm.n_live)], jm.n_port_cnt[: len(tm.n_live)])
    np.testing.assert_array_equal(tm.n_sel_cnt[: len(tm.n_live)], jm.n_sel_cnt[: len(tm.n_live)])

    # the same express outcome and backfill feed both dyn-input builders
    tsnap.job_schedulable[: taux["n_jobs"]] = True
    jsnap.job_schedulable[: jaux["n_jobs"]] = True
    backend = TensorBackend(tsched.conf.tiers, torch.device("cpu"), tsched.uploads)
    backend.snapshot = tsnap
    task_node, task_kind, _, ready = torch_allocate_solve(backend, tsnap)
    be_rows, be_nodes, _ = tsched.fast_cycle._backfill(tm, tsnap, taux, task_node, task_kind)
    dt = build_dyn_solve_inputs(tm, tsnap, taux, 1.0, task_node, task_kind, be_rows, be_nodes, ready)
    dj = jax_build_dyn_solve_inputs(jm, jsnap, jaux, 1.0, task_node, task_kind, be_rows,
                                    be_nodes, ready)
    assert (dt is None) == (dj is None)
    if dt is None:
        return
    assert dj.pop("volsel") is None and dt.pop("volsel") is None
    assert dt.keys() == dj.keys()
    for key in dt:
        assert dt[key].dtype == dj[key].dtype, key
        np.testing.assert_array_equal(dt[key], dj[key], err_msg=key)


def test_mirror_counts_follow_deletes_and_node_rebirth():
    """The per-node port and selector counts follow a resident's delete and
    a node deleted and re-created with its residents, as in the JAX
    mirror, and agree with a mirror built fresh from the final store."""
    spec = dyn_spec(5)
    js, ts = jax_store_from_spec(spec), interop.store_from_spec(spec)
    jm = JMirror(js, "volcano-tpu", "default")
    tm = ArrayMirror(ts, "volcano-tpu", "default")
    jm.drain()
    tm.drain()
    res = [p for p in spec["pods"] if p["name"].startswith("res")]
    gone = next(p for p in res if p.get("host_ports"))
    node = res[0]["node_name"]
    for store in (js, ts):
        store.delete("Pod", f"default/{gone['name']}")
        obj = store.get("Node", f"/{node}")
        store.delete("Node", f"/{node}")
        store.create("Node", obj)
    jm.drain()
    tm.drain()
    n = len(tm.n_live)
    np.testing.assert_array_equal(tm.n_port_cnt[:n], jm.n_port_cnt[:n])
    np.testing.assert_array_equal(tm.n_sel_cnt[:n], jm.n_sel_cnt[:n])
    fresh = ArrayMirror(ts, "volcano-tpu", "default")
    fresh.drain()
    for name in ts.list("Node"):
        key = name.meta.name
        np.testing.assert_array_equal(
            tm.n_port_cnt[tm.nodes.key_row[key]], fresh.n_port_cnt[fresh.nodes.key_row[key]])
        np.testing.assert_array_equal(
            tm.n_sel_cnt[tm.nodes.key_row[key]], fresh.n_sel_cnt[fresh.nodes.key_row[key]])
    assert tm.n_port_cnt.sum() == sum(len(p.get("host_ports", ())) for p in res) - 1

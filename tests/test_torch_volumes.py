"""The port's volume slice against the JAX package's.

* Kernel (K6): ``allocate_solve`` with the ``volsel`` extension, on
  ``build_sim_args`` clusters plus seeded ``build_volsel_args`` payloads
  (global and node-pinned pools, bound-PV node sets, an exhausted pool, two
  claims of one group on one task, jobs contending for one PV, releasing
  capacity), with and without ``portsel``.  The port takes the payload
  packed (``kernels.pack_volsel``), the JAX kernel unpacked.  Decision
  outputs must be equal; float state is held to rtol=1e-6, though
  bit-equality is expected (whole-unit requests, exact sums).
* Snapshot: the port's ``VolumePartition`` verdicts, its payload and the
  dynamic solve's inputs equal the JAX ones on the same store.
* Cycle: the device-path scenarios of ``tests/test_volume_parity.py`` on
  both packages through one description (``interop.store_from_spec`` and
  the JAX twin below): the binds, PodGroup phases, and PV / PVC states
  after each cycle equal the JAX fast cycle's.  Provisioned PVs are named
  by their claim's uid, which differs between the stores, so the states
  name them by their claim.
* Residue: the volume shapes the JAX cycle hands to its residue engine
  get the JAX cycle's reason class in the port too, and its object
  sub-cycle places them as the JAX one does, cycle by cycle.
* Config 5 with volume gangs (bench.py config5_volumes) at 1/100 of its
  scale, cycle by cycle against the JAX Scheduler.
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
from volcano_tpu.scheduler import tensor_actions as jax_tensor_actions
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
from volcano_tpu_torch.scheduler.fastpath import cycle as tcycle
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import build_dyn_solve_inputs
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.scheduler.simargs import (
    PORTSEL_KEYS,
    VOLSEL_KINDS,
    add_releasing,
    build_portsel_args,
    build_sim_args,
    build_volsel_args,
)
from volcano_tpu_torch.scheduler.tensor_actions import torch_allocate_solve
from volcano_tpu_torch.scheduler.tensor_backend import TensorBackend

# the plain versions are many small ops: one intra-op thread each, so that
# parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

DECISIONS = ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps")
WF = ("queue_weight", "queue_request", "total", "eps", "queue_participates")
VOLSEL_FIELDS = ("task_volmask_w", "task_claims", "claim_group", "group_cap", "group_global")


# -- kernel --------------------------------------------------------------------

def _unpack(words):
    return TK.unpack_bits(words).numpy()


def jax_portsel(p):
    return (
        jnp.asarray(_unpack(p["node_ports"])), jnp.asarray(_unpack(p["task_ports"])),
        jnp.asarray(p["node_selcnt"].astype(np.float32)),
        jnp.asarray(_unpack(p["task_aff"]).astype(np.float32)),
        jnp.asarray(_unpack(p["task_anti"]).astype(np.float32)),
        jnp.asarray(_unpack(p["task_self"]).astype(np.float32)),
        jnp.float32(p["w_podaff"]),
    )


def volsel_case(seed):
    """14 nodes (some busy, some releasing on seeds > 0), 48 tasks in 12
    jobs of three queues, pod caps, two predicate classes on odd seeds, and
    one job of each ``VOLSEL_KINDS`` kind (and four more)."""
    a = build_sim_args(14, 48, 12, n_queues=3, seed=seed, n_classes=1 + seed % 2, class_fill=0.8)
    if seed:
        add_releasing(a, seed, busy_frac=0.9)
    a["node_max_tasks"][:] = 4 + seed
    return a, build_volsel_args(14, 48, seed=seed, n_jobs=12)


def _solve_both(a, v, portsel=None):
    des = np.asarray(JK.water_fill(*[jnp.asarray(a[k]) for k in WF]))
    jargs = [jnp.asarray(des) if k == "queue_deserved" else jnp.asarray(a[k])
             for k in TK._SOLVE_ARGS]
    targs = [torch.from_numpy(des) if k == "queue_deserved" else torch.from_numpy(a[k])
             for k in TK._SOLVE_ARGS]
    jkw, tkw = {}, {}
    if portsel is not None:
        jkw["portsel"] = jax_portsel(portsel)
        tkw["portsel"] = tuple(portsel[k] if k == "w_podaff" else torch.from_numpy(portsel[k])
                               for k in PORTSEL_KEYS)
    oj = JK.allocate_solve(*jargs, jnp.float32(1.0), jnp.float32(1.0),
                           volsel=tuple(jnp.asarray(v[k]) for k in VOLSEL_FIELDS), **jkw)
    vt = interop.volsel_from_payload(v)
    before = [x.clone() for x in vt]
    ot = TK.allocate_solve(*targs, 1.0, 1.0, volsel=vt, **tkw)
    for x, y in zip(vt, before):
        assert torch.equal(x, y)  # the inputs are not modified
    return oj, ot


def _assert_same(oj, ot):
    for i, name in enumerate(TK.SolveOut._fields):
        x, y = np.asarray(oj[i]), ot[i].numpy()
        if name in DECISIONS:
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("with_portsel", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_volsel_solve_matches_jax(seed, with_portsel):
    a, v = volsel_case(seed)
    p = build_portsel_args(14, 48, seed=seed, n_jobs=12) if with_portsel else None
    oj, ot = _solve_both(a, v, p)
    _assert_same(oj, ot)
    assert isinstance(ot, TK.VolSolveOut)
    assert int((ot.task_kind > 0).sum()) > 0


def _replay_volume_state(a, v, out):
    """The final (claim_node, vol_cap) that the placements ``out`` imply
    under the reference's rule, replayed in placement order."""
    claims = v["task_claims"]
    claim_node = np.full(claims.shape[1], -1, np.int32)
    cap = v["group_cap"].astype(np.int64)
    kind, node, seq = (x.numpy() for x in (out.task_kind, out.task_node, out.task_seq))
    for t in np.argsort(np.where(seq >= 0, seq, np.iinfo(np.int32).max))[: int((seq >= 0).sum())]:
        if kind[t] != 1:
            continue  # a pipelined placement assumes nothing
        newly = claims[t] & (claim_node < 0)
        for c in np.nonzero(newly)[0]:
            g = v["claim_group"][c]
            if v["group_global"][g]:
                cap[g] -= 1
            else:
                cap[g, node[t]] -= 1
        claim_node[newly] = node[t]
    return claim_node, cap


@pytest.mark.parametrize("seed", range(4))
def test_volsel_final_state_follows_the_placements(seed):
    """The plain version's final claim_node and vol_cap are those its own
    placements imply (global rows drop everywhere, pinned ones at the
    taken node, pipelined placements assume nothing)."""
    a, v = volsel_case(seed)
    _, ot = _solve_both(a, v)
    claim_node, cap = _replay_volume_state(a, v, ot)
    np.testing.assert_array_equal(ot.claim_node.numpy(), claim_node)
    np.testing.assert_array_equal(ot.vol_cap.numpy(), cap)


def test_volsel_cases_exercise_the_extension():
    """Across the seeds: every kind of job, both pool kinds decremented, a
    task placed by releasing fit while carrying a claim (assuming nothing),
    a pinned count driven below zero by one task's two claims of its group
    (the segment sum), a job dropped because another took its PV, and the
    extension changing the outcome."""
    seen = set()
    for seed in range(4):
        a, v = volsel_case(seed)
        _, ot = _solve_both(a, v)
        kind, node = ot.task_kind.numpy(), ot.task_node.numpy()
        has_claim = v["task_claims"].any(axis=1)
        if ((kind == 2) & has_claim).any():
            seen.add("pipelined-claim")
        cap, cap0 = ot.vol_cap.numpy(), v["group_cap"]
        if (cap[1] < cap0[1]).all():
            seen.add("global-decrement")
        if (cap[0] < cap0[0]).any():
            seen.add("pinned-decrement")
        if (cap[0] < 0).any():
            seen.add("two-claims")
        tpj = 4
        pinned_jobs = [j for j in range(12) if VOLSEL_KINDS[j % 8] == "pinned"]
        if any(ot.dropped[j] for j in pinned_jobs):
            seen.add("contended")
        bound = [j for j in range(12) if VOLSEL_KINDS[j % 8] == "bound"]
        for j in bound:
            rows = np.arange(j * tpj, (j + 1) * tpj)
            allowed = _unpack(v["task_volmask_w"][rows[:1]])[0]
            placed = rows[kind[rows] > 0]
            assert allowed[node[placed]].all()
            seen.add("bound")
        des = TK.water_fill(*[torch.from_numpy(a[k]) for k in WF])
        plain = TK.allocate_solve(
            *[des if k == "queue_deserved" else torch.from_numpy(a[k]) for k in TK._SOLVE_ARGS],
            1.0, 1.0)
        if not torch.equal(plain.task_node, ot.task_node):
            seen.add("changes-outcome")
    assert seen == {"pipelined-claim", "global-decrement", "pinned-decrement", "two-claims",
                    "contended", "bound", "changes-outcome"}, seen


def test_batch_solve_refuses_volsel():
    a, v = volsel_case(0)
    des = TK.water_fill(*[torch.from_numpy(a[k]) for k in WF])
    args = [des if k == "queue_deserved" else torch.from_numpy(a[k]) for k in TK._SOLVE_ARGS]
    with pytest.raises(TypeError, match="exact solve"):
        TK.allocate_solve_batch(*args, 1.0, 1.0, volsel=interop.volsel_from_payload(v))


# -- clusters ------------------------------------------------------------------

def jax_store_from_spec(spec):
    """The JAX package's Store for the same description."""
    store = JStore()
    for q in spec.get("queues", ()):
        store.create("Queue", jobj.Queue(meta=jobj.Metadata(name=q["name"], namespace=""),
                                         weight=q.get("weight", 1)))
    for n in spec.get("nodes", ()):
        store.create("Node", jobj.Node(meta=jobj.Metadata(name=n["name"], namespace=""),
                                       allocatable=JResource.from_resource_list(n["allocatable"]),
                                       labels=dict(n.get("labels", {}))))
    for sc in spec.get("storage_classes", ()):
        kw = {"provisioner": sc["provisioner"]} if "provisioner" in sc else {}
        store.create("StorageClass", jobj.StorageClass(
            meta=jobj.Metadata(name=sc["name"], namespace=""), **kw))
    for pv in spec.get("pvs", ()):
        store.create("PV", jobj.PersistentVolume(
            meta=jobj.Metadata(name=pv["name"], namespace=""), capacity=pv.get("capacity", ""),
            storage_class=pv.get("storage_class", ""),
            node_affinity=dict(pv.get("node_affinity", {})), claim_ref=pv.get("claim_ref", "")))
    for c in spec.get("pvcs", ()):
        store.create("PVC", jobj.PersistentVolumeClaim(
            meta=jobj.Metadata(name=c["name"], namespace="default"), size=c.get("size", ""),
            storage_class=c.get("storage_class", ""), volume_name=c.get("volume_name", ""),
            phase=c.get("phase", "Pending")))
    for g in spec.get("podgroups", ()):
        pg = jobj.PodGroup(meta=jobj.Metadata(name=g["name"], namespace="default"),
                           min_member=g["min_member"], queue=g.get("queue", "default"))
        pg.status.phase = JPhase(g.get("phase", "Pending"))
        store.create("PodGroup", pg)
    for p in spec.get("pods", ()):
        aff = None
        if p.get("pod_anti_affinity"):
            aff = jobj.Affinity(pod_anti_affinity=list(p["pod_anti_affinity"]))
        pod = jobj.Pod(
            meta=jobj.Metadata(name=p["name"], namespace="default",
                               annotations={JAX_POD_GROUP_KEY: p["group"]},
                               labels=dict(p.get("labels", {}))),
            spec=jobj.PodSpec(resources=JResource.from_resource_list(p["resources"]),
                              affinity=aff),
            phase=JPodPhase(p.get("phase", "Pending")), node_name=p.get("node_name", ""))
        pod.volumes = list(p.get("volumes", ()))
        store.create("Pod", pod)
    return store


def _volume_state(store):
    """PVs (a provisioned one named by its claim) and PVCs (the volume they
    bound, named the same way)."""
    provisioned = {pv.meta.name: f"provisioned-for:{pv.claim_ref}"
                   for pv in store.list("PV") if pv.provisioned}
    pvs = {provisioned.get(pv.meta.name, pv.meta.name): (pv.claim_ref, pv.storage_class,
                                                         pv.phase)
           for pv in store.list("PV")}
    pvcs = {c.meta.key: (c.phase, provisioned.get(c.volume_name, c.volume_name))
            for c in store.list("PVC")}
    return pvs, pvcs


def _state(store):
    return ({p.meta.key: p.node_name for p in store.list("Pod")},
            {g.meta.key: g.status.phase.value for g in store.list("PodGroup")},
            _volume_state(store))


def _confs(actions=("allocate", "backfill"), solve_mode="auto"):
    jc = jconf.full_conf("tpu")
    jc.actions = list(actions)
    jc.solve_mode = solve_mode
    jc.exact_topk = True
    tc = tconf.full_conf("cpu")
    tc.actions = list(actions)
    tc.solve_mode = solve_mode
    return jc, tc


def _pair(spec, **kw):
    jc, tc = _confs(**kw)
    js, ts = jax_store_from_spec(spec), interop.store_from_spec(spec)
    return (js, JScheduler(js, conf=jc)), (ts, Scheduler(ts, conf=tc))


def _cycle_both(jpair, tpair):
    (js, jsched), (ts, tsched) = jpair, tpair
    jsched.run_once()
    tsched.run_once()
    assert jsched.fast_cycle.mirror is not None  # JAX ran its fast cycle
    assert not jsched.fast_cycle.last_residue_reasons
    assert "subcycle" not in jsched.fast_cycle.phases
    assert _state(ts) == _state(js)
    jp, tp = jsched.fast_cycle.phases, tsched.fast_cycle.phases
    for phase in ("vol_solve", "dyn_solve"):
        assert (phase in tp) == (phase in jp), phase
    return _state(ts)


def base_spec(n_nodes, zones=False):
    nodes = []
    for i in range(n_nodes):
        n = {"name": f"n{i}", "allocatable": {"cpu": "8", "memory": "16Gi", "pods": 110}}
        if zones:
            n["labels"] = {"zone": "a" if i < 2 else "b"}
        nodes.append(n)
    return {"queues": [{"name": "default", "weight": 1}], "nodes": nodes,
            "storage_classes": [], "pvs": [], "pvcs": [], "podgroups": [], "pods": []}


def add_job(spec, name, n_tasks, volumes=(), min_member=None, cpu="1"):
    spec["podgroups"].append({"name": name, "min_member": min_member or n_tasks,
                              "phase": "Inqueue"})
    for t in range(n_tasks):
        spec["pods"].append({"name": f"{name}-{t}", "group": name,
                             "resources": {"cpu": cpu, "memory": "1Gi"},
                             "volumes": list(volumes)})


def add_pool(spec, class_name, pins, capacity="20Gi", prefix="pool"):
    spec["storage_classes"].append({"name": class_name, "provisioner": ""})
    for i, pin in enumerate(pins):
        spec["pvs"].append({"name": f"{prefix}{i}", "capacity": capacity,
                            "storage_class": class_name,
                            "node_affinity": {"kubernetes.io/hostname": pin} if pin else {}})


def add_claim(spec, name, class_name, size="5Gi"):
    spec["pvcs"].append({"name": name, "size": size, "storage_class": class_name})


def bound_claim_spec():
    spec = base_spec(4)
    spec["pvs"].append({"name": "disk2", "capacity": "20Gi", "storage_class": "net",
                        "node_affinity": {"kubernetes.io/hostname": "n2"},
                        "claim_ref": "default/reused"})
    spec["pvcs"].append({"name": "reused", "size": "5Gi", "storage_class": "net",
                         "volume_name": "disk2", "phase": "Bound"})
    add_job(spec, "pinned", 2, ["reused"])
    add_job(spec, "plain", 2)
    return spec


def zone_spec():
    spec = base_spec(6, zones=True)
    spec["pvs"].append({"name": "zoned", "capacity": "20Gi", "storage_class": "net",
                        "node_affinity": {"zone": "a"}, "claim_ref": "default/zc"})
    spec["pvcs"].append({"name": "zc", "size": "5Gi", "storage_class": "net",
                         "volume_name": "zoned", "phase": "Bound"})
    add_job(spec, "zj", 3, ["zc"])
    return spec


def exhaustion_spec(network_pool):
    spec = base_spec(5)
    add_pool(spec, "local", [None, None] if network_pool else ["n1", "n3"])
    for j in range(3):
        add_claim(spec, f"c{j}", "local")
        add_job(spec, f"vj{j}", 1, [f"c{j}"])
    return spec


def shared_claim_spec():
    spec = base_spec(4)
    add_pool(spec, "local", ["n2"])
    add_claim(spec, "shared", "local")
    add_job(spec, "team", 3, ["shared"])
    return spec


def dynamic_class_spec():
    """A claim of a class with no StorageClass object and no PV (dynamic,
    provisioned at bind), a claim-less volume, and a claim of a dynamic
    StorageClass: all three jobs stay express."""
    spec = base_spec(3)
    spec["storage_classes"].append({"name": "fast"})
    add_claim(spec, "dyn", "standard", size="10Gi")
    add_claim(spec, "dyn2", "fast", size="1Gi")
    add_job(spec, "dj", 2, ["dyn"])
    add_job(spec, "scratch", 2, ["scratch"])
    add_job(spec, "fastj", 1, ["dyn2"])
    return spec


@pytest.mark.parametrize("case", ["bound-pvc", "zone", "shared-claim"])
def test_device_volume_scenarios_equal_jax(case):
    spec = {"bound-pvc": bound_claim_spec, "zone": zone_spec,
            "shared-claim": shared_claim_spec}[case]()
    jpair, tpair = _pair(spec)
    binds, _, (pvs, pvcs) = _cycle_both(jpair, tpair)
    assert "vol_solve" in tpair[1].fast_cycle.phases
    assert "dyn_solve" in tpair[1].fast_cycle.phases
    if case == "bound-pvc":
        assert {binds[f"default/pinned-{t}"] for t in range(2)} == {"n2"}
    elif case == "zone":
        assert {binds[f"default/zj-{t}"] for t in range(3)} <= {"n0", "n1"}
    else:
        assert {binds[f"default/team-{t}"] for t in range(3)} == {"n2"}
        assert pvs["pool0"][0] == "default/shared" and pvcs["default/shared"] == ("Bound", "pool0")


@pytest.mark.parametrize("network_pool", [False, True])
def test_attach_capacity_exhaustion_equals_jax(network_pool):
    jpair, tpair = _pair(exhaustion_spec(network_pool))
    binds, _, (pvs, pvcs) = _cycle_both(jpair, tpair)
    assert sum(1 for v in binds.values() if v) == 2  # a pool of 2 serves 2 gangs
    assert sorted(v[0] for v in pvs.values()) == ["default/c0", "default/c1"]
    assert pvcs["default/c2"] == ("Pending", "")


def test_dynamic_class_and_claimless_volumes_stay_express_and_provision():
    jpair, tpair = _pair(dynamic_class_spec())
    binds, _, (pvs, pvcs) = _cycle_both(jpair, tpair)
    assert all(binds.values())
    assert "dyn_solve" not in tpair[1].fast_cycle.phases
    assert "vol_solve" in tpair[1].fast_cycle.phases
    for claim in ("default/dyn", "default/dyn2"):
        assert pvcs[claim] == ("Bound", f"provisioned-for:{claim}")
        assert pvs[f"provisioned-for:{claim}"][0] == claim


def test_claimless_volume_pod_binds_like_jax():
    """A pending pod naming a claim that has no PVC object (an
    emptyDir-style mount) is an ordinary express pod: it binds where the
    JAX cycle binds it, and nothing is provisioned."""
    spec = base_spec(3)
    add_job(spec, "plain", 2)
    spec["pods"].append({"name": "vol", "group": "plain", "resources": {"cpu": "500m",
                         "memory": "512Mi"}, "volumes": ["claim"]})
    jpair, tpair = _pair(spec)
    binds, _, (pvs, pvcs) = _cycle_both(jpair, tpair)
    assert binds["default/vol"] and not pvs and not pvcs
    assert "dyn_solve" not in tpair[1].fast_cycle.phases


def test_volume_binding_error_rebind_race_equals_jax(monkeypatch):
    """A concurrent writer takes the pool's PV between the dynamic solve and
    publish: the bind is dropped and recorded, the claim stays Pending, and
    once a PV returns a later cycle binds the pod, in both packages."""
    spec = base_spec(3)
    add_pool(spec, "local", ["n1"])
    add_claim(spec, "c0", "local")
    add_job(spec, "racer", 1, ["c0"])
    jpair, tpair = _pair(spec)

    def stealing(orig, store):
        stolen = []

        def run(backend, snap, dyn, n_pending=None):
            out = orig(backend, snap, dyn, n_pending)
            if not stolen:
                pv = store.get("PV", "/pool0")
                pv.claim_ref = "other/claim"
                store.update("PV", pv)
                stolen.append(True)
            return out
        return run

    monkeypatch.setattr(jax_tensor_actions, "jax_dynamic_solve",
                        stealing(jax_tensor_actions.jax_dynamic_solve, jpair[0]))
    monkeypatch.setattr(tcycle, "torch_dynamic_solve",
                        stealing(tcycle.torch_dynamic_solve, tpair[0]))
    binds, _, (_, pvcs) = _cycle_both(jpair, tpair)
    assert binds["default/racer-0"] == "" and pvcs["default/c0"] == ("Pending", "")
    for sched in (jpair[1], tpair[1]):
        assert [op for op, _, _ in sched.cache.err_log] == ["bind_volumes"]
    fresh = {"name": "fresh", "capacity": "20Gi", "storage_class": "local",
             "node_affinity": {"kubernetes.io/hostname": "n2"}}
    jax_pv = jax_store_from_spec({"pvs": [fresh]}).get("PV", "/fresh")
    jpair[0].create("PV", jax_pv)
    tpair[0].create("PV", interop.store_from_spec({"pvs": [fresh]}).get("PV", "/fresh"))
    _cycle_both(jpair, tpair)
    binds, _, _ = _cycle_both(jpair, tpair)
    assert binds["default/racer-0"] == "n2"


def test_no_vol_solve_phase_on_volume_free_cycles():
    spec = base_spec(3)
    add_job(spec, "pg", 2)
    jpair, tpair = _pair(spec)
    binds, _, _ = _cycle_both(jpair, tpair)
    assert all(binds.values())
    for phase in ("vol_solve", "dyn_solve"):
        assert phase not in tpair[1].fast_cycle.phases


# -- snapshot ------------------------------------------------------------------

def mixed_volume_spec():
    """Every device verdict at once: bound pins, a zone set, a pinned and a
    network pool with shared and contending claims, a dynamic class and a
    claim-less volume, beside plain and anti-affinity jobs."""
    spec = base_spec(8, zones=True)
    spec["pods"].append({"name": "res", "group": "run", "resources": {"cpu": "1",
                         "memory": "1Gi"}, "labels": {"app": "web"}, "node_name": "n3",
                         "phase": "Running"})
    spec["podgroups"].append({"name": "run", "min_member": 1, "phase": "Running"})
    spec["pvs"] += [
        {"name": "pin5", "capacity": "20Gi", "storage_class": "net",
         "node_affinity": {"kubernetes.io/hostname": "n5"}, "claim_ref": "default/b5"},
        {"name": "zoned", "capacity": "20Gi", "storage_class": "net",
         "node_affinity": {"zone": "a"}, "claim_ref": "default/bz"},
    ]
    spec["pvcs"] += [
        {"name": "b5", "size": "5Gi", "storage_class": "net", "volume_name": "pin5",
         "phase": "Bound"},
        {"name": "bz", "size": "5Gi", "storage_class": "net", "volume_name": "zoned",
         "phase": "Bound"},
    ]
    add_pool(spec, "local", ["n1", "n4", "n4"], prefix="loc")
    add_pool(spec, "shared", [None, None], prefix="net")
    for c, cls in (("l0", "local"), ("l1", "local"), ("l2", "local"), ("g0", "shared"),
                   ("g1", "shared"), ("g2", "shared")):
        add_claim(spec, c, cls)
    add_claim(spec, "dyn", "standard")
    add_job(spec, "pin", 2, ["b5"])
    add_job(spec, "zone", 2, ["bz"])
    add_job(spec, "loc0", 2, ["l0"])
    add_job(spec, "loc1", 1, ["l1", "b5"])
    add_job(spec, "loc2", 2, ["l2"])
    add_job(spec, "net0", 2, ["g0"])
    add_job(spec, "net1", 1, ["g1"])
    add_job(spec, "net2", 1, ["g2"])
    add_job(spec, "dyn", 2, ["dyn", "scratch"])
    add_job(spec, "plain", 3)
    spec["podgroups"].append({"name": "anti", "min_member": 1, "phase": "Inqueue"})
    spec["pods"].append({"name": "anti-0", "group": "anti", "resources": {"cpu": "1",
                         "memory": "1Gi"}, "pod_anti_affinity": [{"app": "web"}]})
    return spec


def test_volume_partition_and_dyn_inputs_equal_jax():
    spec = mixed_volume_spec()
    jm = JMirror(jax_store_from_spec(spec), "volcano-tpu", "default")
    jm.drain()
    jsnap, jaux = jax_build_fast_snapshot(jm, dyn_batch=("auto", 4096))
    tstore = interop.store_from_spec(spec)
    tm = ArrayMirror(tstore, "volcano-tpu", "default")
    tm.drain()
    tsnap, taux = build_fast_snapshot(tm, dyn_batch=("auto", 4096))
    for key in ("pe_rows", "dyn_job", "dyn_expr_job"):
        np.testing.assert_array_equal(taux[key], jaux[key], err_msg=key)
    assert taux["residue_reasons"] == jaux["residue_reasons"] == {}
    tvp, jvp = taux["volume_partition"], jaux["volume_partition"]
    assert tvp.claim_slots == jvp.claim_slots and tvp.slot_group == jvp.slot_group
    assert sorted(tvp.task_volumes) == sorted(jvp.task_volumes)
    verdicts = set()
    for row, tv in tvp.task_volumes.items():
        jv = jvp.task_volumes[row]
        assert (tv.verdict, tv.reason, tv.claim_ids, tv.groups) == \
            (jv.verdict, jv.reason, jv.claim_ids, jv.groups), row
        assert (tv.mask is None) == (jv.mask is None)
        if tv.mask is not None:
            np.testing.assert_array_equal(tv.mask, jv.mask)
        verdicts.add((tv.verdict, tv.mask is not None, bool(tv.claim_ids)))
    assert verdicts == {("free", False, False), ("device", True, False),
                        ("device", False, True), ("device", True, True)}
    np.testing.assert_array_equal(tvp.index.group_global, jvp.index.group_global)
    for tc, jc in zip(tvp.index.group_cap, jvp.index.group_cap):
        np.testing.assert_array_equal(tc, jc)

    # the same express outcome feeds both dyn-input builders
    tsched = Scheduler(tstore, conf=tconf.full_conf("cpu"))
    tsnap.job_schedulable[: taux["n_jobs"]] = True
    jsnap.job_schedulable[: jaux["n_jobs"]] = True
    backend = TensorBackend(tsched.conf.tiers, torch.device("cpu"), tsched.uploads)
    backend.snapshot = tsnap
    task_node, task_kind, _, ready = torch_allocate_solve(backend, tsnap)
    be_rows, be_nodes, _ = tsched.fast_cycle._backfill(tm, tsnap, taux, task_node, task_kind)
    dt = build_dyn_solve_inputs(tm, tsnap, taux, 1.0, task_node, task_kind, be_rows, be_nodes,
                                ready)
    dj = jax_build_dyn_solve_inputs(jm, jsnap, jaux, 1.0, task_node, task_kind, be_rows,
                                    be_nodes, ready)
    vt, vj = dt.pop("volsel"), dj.pop("volsel")
    assert vt.keys() == vj.keys() == set(VOLSEL_FIELDS)
    for key in VOLSEL_FIELDS:
        assert vt[key].dtype == vj[key].dtype, key
        np.testing.assert_array_equal(vt[key], vj[key], err_msg=key)
    assert dt.keys() == dj.keys()
    for key in dt:
        np.testing.assert_array_equal(dt[key], dj[key], err_msg=key)


def test_mixed_volume_cluster_cycles_equal_jax():
    jpair, tpair = _pair(mixed_volume_spec())
    for _ in range(2):
        _cycle_both(jpair, tpair)


# -- residue shapes ------------------------------------------------------------

def residue_spec(case):
    spec = base_spec(4)
    if case == "size-overflow":
        spec["storage_classes"].append({"name": "local", "provisioner": ""})
        spec["pvs"] += [
            {"name": "small", "capacity": "10Gi", "storage_class": "local",
             "node_affinity": {"kubernetes.io/hostname": "n1"}},
            {"name": "big", "capacity": "50Gi", "storage_class": "local",
             "node_affinity": {"kubernetes.io/hostname": "n2"}},
        ]
        add_claim(spec, "ca", "local")
        add_job(spec, "va", 1, ["ca"])
        add_claim(spec, "cb", "local", size="20Gi")
        add_job(spec, "vb", 1, ["cb"])
    elif case == "two-claims-one-class":
        add_pool(spec, "local", ["n1", "n2"])
        add_claim(spec, "c0", "local")
        add_claim(spec, "c1", "local")
        add_job(spec, "twin", 1, ["c0", "c1"])
    elif case == "claim-cap":
        add_pool(spec, "net", [None] * 70)
        for j in range(66):
            add_claim(spec, f"c{j}", "net")
            add_job(spec, f"j{j}", 1, [f"c{j}"], cpu="100m")
    elif case == "mixed-pool":
        add_pool(spec, "mixed", ["n2", None])
        add_claim(spec, "m0", "mixed")
        add_job(spec, "mj", 1, ["m0"])
        add_claim(spec, "m1", "mixed")
        add_job(spec, "mk", 1, ["m1"])
    elif case == "batch-wave":
        add_pool(spec, "local", ["n2"])
        add_claim(spec, "bc", "local")
        add_job(spec, "volj", 2, ["bc"])
        spec["podgroups"].append({"name": "wave", "min_member": 3, "phase": "Inqueue"})
        for t in range(3):
            spec["pods"].append({"name": f"w{t}", "group": "wave", "labels": {"app": "w"},
                                 "resources": {"cpu": "1", "memory": "1Gi"},
                                 "pod_anti_affinity": [{"app": "w"}]})
    return spec


RESIDUE_CASES = {
    # case: (solve mode, the JAX cycle's residue reasons)
    "size-overflow": ("auto", {"default/vb": "volume-shape", "default/va": "contended-claims"}),
    "two-claims-one-class": ("auto", {"default/twin": "volume-shape"}),
    "claim-cap": ("auto", {"default/j64": "volume-claim-cap",
                           "default/j65": "volume-claim-cap"}),
    "mixed-pool": ("auto", {"default/mj": "volume-shape", "default/mk": "volume-shape"}),
    "batch-wave": ("batch", {"default/volj": "batch-wave"}),
}


@pytest.mark.parametrize("case", list(RESIDUE_CASES))
def test_residue_volume_shapes_raise_where_jax_leaves_the_device(case, monkeypatch):
    """Volume shapes the count model cannot express: the JAX fast cycle
    gives them these residue reasons and places them in its object
    sub-cycle on the residue engine; the port does the same.  Two cycles on
    the JAX store copied uid for uid, equal cycle by cycle: binds,
    evictions, pipelines, pods, PodGroup phases and conditions, claims,
    residue reasons (tolerance: exact)."""
    from test_torch_object import run_pair, same_fast_cycle

    solve_mode, reasons = RESIDUE_CASES[case]
    spec = residue_spec(case)
    jc, _ = _confs(solve_mode=solve_mode)
    got = []

    def check(cycle, jsched, tsched):
        same_fast_cycle(cycle, jsched, tsched)
        got.append((dict(jsched.fast_cycle.last_residue_reasons),
                    set(tsched.fast_cycle.phases)))

    run_pair(monkeypatch, lambda: jax_store_from_spec(spec), jax_conf=jc,
             fast_path="auto", cycles=2, each_cycle=check)
    first, phases = got[0]
    if case == "claim-cap":
        # claims intern in mirror-row order: the last two overflow; their
        # pool's other claimants follow them through the contention closure
        assert {k: v for k, v in first.items() if v == "volume-claim-cap"} == reasons
        assert set(first.values()) == {"volume-claim-cap", "contended-claims"}
        reasons = first
    assert first == reasons
    assert {"subcycle", "residue_vec"} <= phases


# -- config 5 with volume gangs at 1/100 scale ---------------------------------

def cfg5v_spec(n_nodes, n_jobs, n_best_effort, volume_tasks, seed=0):
    """bench.py config5_volumes as one description, cut in scale only:
    20-task gangs in queues q0/q1 (plus default) on nodes of 8/16/32 cores
    and 16/32/64 Gi, one best-effort pod on each of the first
    ``n_best_effort`` gangs, and ``volume_tasks`` / 20 volume gangs of
    100m / 64Mi tasks: even ones mount a Bound claim whose 50Gi PV (class
    net) is pinned to node n{(v * 97) % n_nodes}, odd ones share one
    pending 5Gi claim of the static class volb, whose pool holds one 50Gi
    PV pinned the same way per odd gang."""
    rng = np.random.default_rng(seed)
    spec = {
        "queues": [{"name": "q0", "weight": 2}, {"name": "q1", "weight": 1},
                   {"name": "default", "weight": 1}],
        "nodes": [{"name": f"n{i:05d}", "allocatable": {
            "cpu": str(int(rng.choice([8, 16, 32]))),
            "memory": f"{int(rng.choice([16, 32, 64]))}Gi", "pods": 110}}
            for i in range(n_nodes)],
        "storage_classes": [], "pvs": [], "pvcs": [], "podgroups": [], "pods": [],
    }
    for j in range(n_jobs):
        name = f"pg{j:05d}"
        spec["podgroups"].append({"name": name, "min_member": 20, "queue": f"q{j % 2}"})
        for t in range(20):
            spec["pods"].append({"name": f"p{j:05d}-{t}", "group": name, "resources": {
                "cpu": f"{int(rng.choice([250, 500, 1000, 2000]))}m",
                "memory": f"{int(rng.choice([256, 512, 1024, 2048]))}Mi"}})
        if j < n_best_effort:
            spec["pods"].append({"name": f"be{j:05d}", "group": name, "resources": {}})
    n_vol = volume_tasks // 20
    if n_vol:
        spec["storage_classes"].append({"name": "volb", "provisioner": ""})
    for v in range(n_vol):
        pin = {"kubernetes.io/hostname": f"n{(v * 97) % n_nodes:05d}"}
        if v % 2 == 0:
            spec["pvs"].append({"name": f"vpv{v:04d}", "capacity": "50Gi",
                                "storage_class": "net", "node_affinity": pin,
                                "claim_ref": f"default/vc{v:04d}"})
            spec["pvcs"].append({"name": f"vc{v:04d}", "size": "5Gi", "storage_class": "net",
                                 "volume_name": f"vpv{v:04d}", "phase": "Bound"})
        else:
            spec["pvs"].append({"name": f"vpv{v:04d}", "capacity": "50Gi",
                                "storage_class": "volb", "node_affinity": pin})
            spec["pvcs"].append({"name": f"vc{v:04d}", "size": "5Gi", "storage_class": "volb"})
        spec["podgroups"].append({"name": f"vol{v:04d}", "min_member": 20,
                                  "queue": f"q{v % 2}"})
        for t in range(20):
            spec["pods"].append({"name": f"v{v:04d}-{t}", "group": f"vol{v:04d}",
                                 "resources": {"cpu": "100m", "memory": "64Mi"},
                                 "volumes": [f"vc{v:04d}"]})
    return spec


def _unbound_volume_gangs_fit_nowhere(spec, store, n_vol):
    """Every unbound volume gang lacks room on each node its claim allows:
    its PV's pin node (bound claim), every Available volb PV's node
    (static claim)."""
    free = {}
    for n in store.list("Node"):
        a = n.allocatable
        free[n.meta.name] = np.array([a.milli_cpu, a.memory, a.max_task_num], float)
    for p in store.list("Pod"):
        if p.node_name:
            free[p.node_name] -= (p.spec.resources.milli_cpu, p.spec.resources.memory, 1)
    pin = {pv["name"]: pv["node_affinity"]["kubernetes.io/hostname"] for pv in spec["pvs"]}
    open_nodes = [pin[pv.meta.name] for pv in store.list("PV")
                  if pv.storage_class == "volb" and not pv.claim_ref]
    unbound = []
    for v in range(n_vol):
        pods = [store.get("Pod", f"default/v{v:04d}-{t}") for t in range(20)]
        if pods[0].node_name:
            continue
        need = sum(np.array([p.spec.resources.milli_cpu, p.spec.resources.memory, 1.0])
                   for p in pods)
        cand = [pin[f"vpv{v:04d}"]] if v % 2 == 0 else open_nodes
        assert not any((free[n] >= need).all() for n in cand), v
        unbound.append(v)
    return unbound


@pytest.mark.parametrize("n_nodes,vol_bound", [(100, 12), (60, 11)])
def test_cfg5v_pattern_cycle_by_cycle_like_jax(n_nodes, vol_bound):
    """Config 5 with volume gangs at 1/100 of its scale (50 gangs x 20, 20
    best-effort pods, 12 volume gangs: 6 bound, 6 static) under the
    five-action conf, on 100 nodes and on 60 (where the express pass
    leaves one volume gang's allowed nodes without room for it): every
    cycle's binds, PodGroup phases and PV / PVC states equal the JAX
    Scheduler's.  Both bind every other pod in the first cycle, and
    ``vol_bound`` volume gangs, each bound-claim gang on its pin node, each
    static gang on the node of a PV that now holds its claim; the gangs
    left fit no node their claim allows, so later cycles bind nothing."""
    spec = cfg5v_spec(n_nodes, 50, 20, 240)
    jpair, tpair = _pair(spec, actions=tconf.full_conf("cpu").actions)
    for cycle in range(3):
        binds, phases, (pvs, pvcs) = _cycle_both(jpair, tpair)
        # the verdicts run while volume pods are pending
        assert ("vol_solve" in tpair[1].fast_cycle.phases) == (cycle == 0 or vol_bound < 12)
        assert all(node for key, node in binds.items() if not key.startswith("default/v"))
        unbound = _unbound_volume_gangs_fit_nowhere(spec, tpair[0], 12)
        assert 12 - len(unbound) == vol_bound, (cycle, unbound)
    for v in set(range(12)) - set(unbound):
        nodes = {binds[f"default/v{v:04d}-{t}"] for t in range(20)}
        if v % 2 == 0:
            assert nodes == {f"n{(v * 97) % n_nodes:05d}"}
        else:
            assert len(nodes) == 1
            pv = pvcs[f"default/vc{v:04d}"][1]
            assert pvs[pv][0] == f"default/vc{v:04d}"
            assert {spec_pv["node_affinity"]["kubernetes.io/hostname"]
                    for spec_pv in spec["pvs"] if spec_pv["name"] == pv} == nodes
    claimed = [c[0] for c in pvs.values() if c[0]]
    assert len(claimed) == len(set(claimed))
